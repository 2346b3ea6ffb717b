"""The port's initial parameters against the JAX package's initialisers.

The port (``detmatch_tpu_torch/models/init.py``) follows JAX's flax
initialisers in distribution, not draw for draw (``jax.random`` and
``torch.Generator`` share no stream). Each case builds one model in both
packages on the CPU from a seed (``key()``, below, through the
jitted JAX initialiser; ``torch.manual_seed(0)`` before the port's
``build_*``) and matches the tensors by name through ``convert.FROM_JAX``:
the tiny SSL detector of ``configs/tests/ssl_tiny.py`` (PV-RCNN and
Faster R-CNN), the six LiDAR zoo detectors at the widths of
``torch_port_zoo_fixture.py`` and CaDDN at those of
``test_torch_port_caddn.py``. For every parameter and buffer:

- a tensor that JAX makes constant (zero biases, the prior biases,
  batch-norm scales, offsets and statistics) is equal exactly;
- any other tensor has a sample std within 1 ± 4/√n of JAX's (n its
  elements) and a mean within four standard errors of JAX's. The ratio
  of two independent sample stds of n normal draws has a standard
  deviation of about 1/√n (each has 1/√(2n); truncated draws spread
  less), so the bound is four of those; the draws are seeded, so the
  test gives the same verdict on every run;
- where JAX's initialiser is truncated (LeCun-normal kernels, the
  He-normal sparse convs), no element lies past two truncated stds
  (``sqrt(scale / fan_in) / 0.8796``, fan-in from JAX's kernel);
- the same seed twice gives bit-equal tensors.

JAX's initialisers draw their bits from a key of ``HASH32``, a
counter-based hash (murmur3's finaliser) registered as a JAX PRNG
implementation, instead of threefry: flax's transforms of the bits
(uniform, erfinv, truncation, scaling) are JAX's own, and XLA compiles
the hash in about half threefry's time, which is most of this file's.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import linen as flax_nn  # noqa: E402
from jax import lax  # noqa: E402
from jax.extend.random import define_prng_impl  # noqa: E402

import torch_port_ssl_fixture as fx  # noqa: E402
import torch_port_zoo_fixture as zf  # noqa: E402
import test_torch_port_caddn as caddn_test  # noqa: E402
import test_torch_port_zoo_pillars as pillars_test  # noqa: E402
import test_torch_port_zoo_pointrcnn as pointrcnn_test  # noqa: E402
from detmatch_tpu.models.pvrcnn import caddn as jcaddn  # noqa: E402
from detmatch_tpu.models.pvrcnn import parta2 as jparta2  # noqa: E402
from detmatch_tpu.models.pvrcnn import pointpillars as jpillars  # noqa: E402
from detmatch_tpu.models.pvrcnn import second as jsecond  # noqa: E402
from detmatch_tpu.models.pvrcnn import voxelrcnn as jvoxelrcnn  # noqa: E402
from detmatch_tpu.ops import spconv as jspconv  # noqa: E402
from detmatch_tpu_torch.apis.build import (  # noqa: E402
    build_detector, build_ssl)
from detmatch_tpu_torch.convert import FROM_JAX, from_jax_ssl  # noqa: E402
from detmatch_tpu_torch.models import init as pinit  # noqa: E402

TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated to (-2, 2)
# JAX's N(0, 0.001) box regressors: not truncated
NORMAL_001 = {"conv_box", "reg_out", "fc_reg"}
SEED = 0
IOU_CFG = dict(zf.CFG, **zf.NMS)
# JAX's initialisers compiled without XLA's backend optimisations, which
# cuts their compile by a third to a half
FAST = dict(compiler_options={"xla_backend_optimization_level": 0})


def _mix(x):
    """murmur3's 32-bit finaliser."""
    x = (x ^ (x >> 16)) * jnp.uint32(0x85EBCA6B)
    x = (x ^ (x >> 13)) * jnp.uint32(0xC2B2AE35)
    return x ^ (x >> 16)


def _seed(seed):
    s = jnp.asarray(seed).astype(jnp.uint32)
    return jnp.stack([_mix(s ^ jnp.uint32(0x9E3779B9)),
                      _mix(s + jnp.uint32(0x7F4A7C15))])


def _split(key, shape):
    i = lax.iota(jnp.uint32, int(np.prod(shape))) * jnp.uint32(2)
    a = _mix(key[0] ^ _mix(i + jnp.uint32(1)))
    b = _mix((key[1] + _mix(i + jnp.uint32(2))) ^ a)
    return jnp.stack([a, b], -1).reshape(tuple(shape) + (2,))


def _fold_in(key, data):
    a = _mix(key[0] ^ _mix(jnp.asarray(data).astype(jnp.uint32)
                           + jnp.uint32(0x632BE5AB)))
    return jnp.stack([a, _mix(key[1] ^ a)])


def _bits(key, bit_width, shape):
    assert bit_width == 32, bit_width
    i = lax.iota(jnp.uint32, int(np.prod(shape)))
    return _mix(_mix(i ^ key[0]) + key[1]).reshape(shape)


HASH32 = define_prng_impl(key_shape=(2,), seed=_seed, split=_split,
                          random_bits=_bits, fold_in=_fold_in,
                          name="hash32", tag="h32")


def key():
    return jax.random.key(SEED, impl=HASH32)


def abstract(tree):
    return jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.result_type(x)), tree)


def lazy_init(jmodel, batch, **kw):
    """JAX's initialiser of ``jmodel`` from ``key()``, traced:
    one ``lazy_init`` (no forward is computed) and its arguments."""
    def init(key, b):
        return dict(jmodel.lazy_init(
            {"params": key, "sampling": key, "dropout": key}, abstract(b),
            **kw))
    args = (key(), batch)
    return jax.jit(init).lower(*args), args


def bounds(variables):
    """A tree of ``variables``' shape: each truncated kernel's bound
    (two truncated stds over its fan-in: every axis but the last in JAX's
    layout; scale 2 for the sparse convs' ``_w``), inf elsewhere."""
    def leaf(path, x):
        keys = [p.key for p in path]
        name = keys[-1]
        sparse = name.endswith("_w")
        if "params" not in keys[:-1] or not (name == "kernel" or sparse) or (
                len(keys) > 2 and keys[-2] in NORMAL_001):
            return np.full(x.shape, np.inf, np.float32)
        fan = int(np.prod(x.shape[:-1]))
        std = np.sqrt((2.0 if sparse else 1.0) / fan) / TRUNC_STD
        return np.full(x.shape, 2.0 * std, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def differences(port_sd, jax_sd, bound_sd):
    """Names of the port's tensors that break one of the module
    docstring's checks against JAX's, each with the reason."""
    assert set(port_sd) == set(jax_sd), set(port_sd) ^ set(jax_sd)
    bad = []
    for name, p in port_sd.items():
        p, j = _np(p), _np(jax_sd[name])
        assert p.shape == j.shape, (name, p.shape, j.shape)
        bound = _np(bound_sd.get(name, np.inf))
        if not np.all(np.abs(j) <= bound):
            bad.append((name, "JAX's own draw past the bound: fan-in?"))
        if not np.all(np.abs(p) <= bound):
            bad.append((name, f"past the truncation bound: max "
                              f"{np.abs(p).max():.4g} > "
                              f"{np.min(bound):.4g}"))
        if np.array_equal(p, j):
            continue
        if j.size == 1 or j.min() == j.max():
            bad.append((name, f"JAX's constant {j.flat[0]!r}, port's "
                              f"mean {p.mean():.4g} std {p.std():.4g}"))
            continue
        p, j = p.astype(np.float64), j.astype(np.float64)
        n = j.size
        ratio = p.std() / j.std()
        if abs(ratio - 1.0) > 4.0 / np.sqrt(n):
            bad.append((name, f"std ratio {ratio:.4f}, n {n}"))
        if abs(p.mean() - j.mean()) > 4.0 * np.sqrt(
                (p.var() + j.var()) / n):
            bad.append((name, f"mean {p.mean():.4g} against "
                              f"{j.mean():.4g}, n {n}"))
    return bad


def port_build(build):
    torch.manual_seed(SEED)
    return build()


# ---------------------------------------------------------------- cases
# Each case: JAX's traced initialiser (``program``) with its ``args``,
# ``convert`` (JAX's variables -> the port's state dict and the bounds'),
# and the port's ``build``.

def ssl_case():
    cfg = fx.load_cfg()
    jssl = fx.jax_ssl(cfg)
    vb = fx.j_voxelize_views(fx.jax_views(fx.views(0)), fx.jax_spec(cfg))
    lab = vb["lab"]["stu"]
    args = (key(), lab, lab["img"], lab["img_shape"])
    m = cfg["model"]

    def convert(state):
        bound = bounds(state["student"])
        return [from_jax_ssl(s, m["detector_3d"], m["detector_2d"])
                for s in (state, dict(student=bound, teacher=bound))]
    return dict(program=jax.jit(jssl.init_states).lower(*args), args=args,
                convert=convert, build=lambda: build_ssl(cfg, "cpu"))


def zoo_case(kind, jmodel, cfg, batch, scene=0):
    program, args = lazy_init(jmodel, batch(*zf.scene(scene)), train=True)

    def convert(v):
        return [FROM_JAX[kind](t["params"], t.get("batch_stats", {}), cfg)
                for t in (v, bounds(v))]
    return dict(program=program, args=args, convert=convert,
                build=lambda: build_detector(
                    {"model": {"detector_3d": dict(type=kind, **cfg)}},
                    "cpu"))


def voxels(pts, valid, gt):
    return zf.voxel_batches(pts, valid, gt)[0]


def pillars(pts, valid, gt):
    jv = zf.jax_voxelize(pts, valid, pillars_test.SPEC)
    return dict(pillars=jv, gt_boxes=jnp.asarray(gt))


def pillars_case():
    with pytest.MonkeyPatch.context() as mp:
        # the zoo test's scatter in the voxelizer's own Z (ROADMAP)
        mp.setattr(jspconv, "to_dense", pillars_test._fixed_to_dense)
        return zoo_case("PointPillar", jpillars.PointPillars(
            **pillars_test.CFG), pillars_test.CFG, pillars)


def caddn_case():
    cfg = caddn_test.CFG
    b = {k: jnp.asarray(x) for k, x in caddn_test.batch("64x64").items()}
    program, args = lazy_init(jcaddn.CaDDN(**cfg), b, train=True)

    def convert(v):
        return [FROM_JAX["CaDDN"](t["params"], t["batch_stats"], t["frozen"],
                                  cfg) for t in (v, bounds(v))]
    return dict(program=program, args=args, convert=convert,
                build=lambda: build_detector(
                    {"model": {"detector_mono": dict(cfg)}}, "cpu",
                    key="detector_mono"))


CASES = {
    "ssl_tiny": ssl_case,
    "SECOND": lambda: zoo_case("SECOND", jsecond.SECOND(**zf.CFG), zf.CFG,
                               voxels),
    "SECONDNetIoU": lambda: zoo_case(
        "SECONDNetIoU", jsecond.SECONDIoU(**IOU_CFG), IOU_CFG, voxels, 1),
    "PointPillar": pillars_case,
    "VoxelRCNN": lambda: zoo_case(
        "VoxelRCNN", jvoxelrcnn.VoxelRCNN(**IOU_CFG), IOU_CFG, voxels, 3),
    "PartA2Net": lambda: zoo_case(
        "PartA2Net", jparta2.PartA2(**IOU_CFG), IOU_CFG, voxels, 4),
    "PointRCNN": lambda: zoo_case(
        "PointRCNN", pointrcnn_test.TinyPointRCNN(**pointrcnn_test.NMS),
        pointrcnn_test.CFG, voxels, 5),
    "CaDDN": caddn_case,
}


@pytest.fixture(scope="module")
def jax_variables():
    """Every case's JAX variables: the programs traced one after another
    (the pillars' patch holds while its own traces), then compiled and
    run in a thread pool (XLA's compile of the initialisers' random
    draws is most of the time, and runs outside the GIL)."""
    cases = {name: make() for name, make in CASES.items()}

    def run(c):
        exe = c["program"].compile(**FAST)
        return jax.tree.map(np.asarray, exe(*c["args"]))
    with ThreadPoolExecutor(4) as pool:
        out = dict(zip(cases, pool.map(run, cases.values())))
    return {name: (cases[name], v) for name, v in out.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, jax_variables):
    c, v = jax_variables[request.param]
    jax_sd, bound_sd = c["convert"](v)
    return dict(c, name=request.param, jax=jax_sd, bound=bound_sd,
                port=port_build(c["build"]))


def test_initial_distributions_match_jax(case):
    """Every tensor of the port's seeded build against JAX's initial
    variables (the module docstring's checks)."""
    sd = case["port"].state_dict()
    bad = differences(sd, case["jax"], case["bound"])
    names = sorted({name for name, _ in bad})
    assert not bad, (f"{case['name']}: {len(names)} of {len(sd)} tensors "
                     f"differ from JAX's initialisers: {bad[:12]}")


def test_same_seed_gives_bit_equal_weights(case):
    """A second build from the same seed equals the first bit for bit
    (and, for the SSL detector, the teacher equals the student)."""
    again = port_build(case["build"]).state_dict()
    for name, t in case["port"].state_dict().items():
        assert torch.equal(t, again[name]), name
    if case["name"] == "ssl_tiny":
        for name, t in case["port"].student.state_dict().items():
            assert torch.equal(t, case["port"].teacher.state_dict()[name]), \
                name


@pytest.mark.parametrize("scale, flax_init, port_init", [
    (1.0, flax_nn.initializers.lecun_normal(), pinit.lecun_normal_),
    (2.0, flax_nn.initializers.he_normal(), pinit.he_normal_)])
def test_initialisers_match_flax(scale, flax_init, port_init):
    """``lecun_normal_`` / ``he_normal_`` against flax's own initialiser
    on a (288, 512) kernel: std, mean and truncation bound."""
    fan, cout = 288, 512
    j = np.asarray(flax_init(jax.random.PRNGKey(SEED), (fan, cout)))
    torch.manual_seed(SEED)
    p = port_init(torch.empty(cout, fan), fan).numpy().T
    bound = 2.0 * np.sqrt(scale / fan) / TRUNC_STD
    assert np.abs(j).max() <= bound and np.abs(p).max() <= bound
    assert differences({"w": torch.from_numpy(p)}, {"w": j}, {}) == []


def test_fan_in_follows_flax_layout():
    """flax's fan-in: receptive field x input channels; a transposed
    conv's input channels are dim 0 of PyTorch's weight."""
    nn = torch.nn
    assert pinit.fan_in(nn.Linear(7, 3)) == 7
    assert pinit.fan_in(nn.Conv1d(5, 3, 1)) == 5
    assert pinit.fan_in(nn.Conv2d(6, 4, 3)) == 54
    assert pinit.fan_in(nn.Conv3d(2, 8, 3)) == 54
    assert pinit.fan_in(nn.ConvTranspose2d(16, 32, 2, stride=2)) == 64
    assert pinit.fan_in(nn.Conv2d(8, 8, 3, groups=2)) == 36


def test_explicit_initialisers_win():
    """The detectors' explicit initialisers survive the defaults: the 2D
    and 3D prior biases, the N(0, 0.001) box regressors."""
    torch.manual_seed(SEED)
    m = build_ssl(fx.load_cfg(), "cpu").student
    prior = np.float32(-np.log((1 - 0.01) / 0.01))
    for bias in (m.det2d.rpn_head.rpn_cls.bias,
                 m.det2d.roi_head.bbox_head.fc_cls.bias,
                 m.det3d.dense_head.conv_cls.bias):
        assert torch.all(bias == torch.tensor(prior)), bias
    for w in (m.det2d.roi_head.bbox_head.fc_reg.weight,
              m.det3d.dense_head.conv_box.weight,
              m.det3d.roi_head.reg_layers[-1].weight):
        std = float(w.detach().std())
        assert 0.0005 < std < 0.002, std
