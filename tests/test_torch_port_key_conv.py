"""CPU parity of the port's key-compare sparse conv (kernel K5's plain
twins in ``detmatch_tpu_torch/ops/cuda/key_conv.py``) against the JAX
package's ``ops/pallas/onehot_key_conv.key_conv_batched`` and its custom
VJP, run in Pallas interpret mode as the JAX tests run it on the CPU, and
of ``VoxelBackbone8x(conv_impl="key")`` against the JAX backbone with
``conv_impl="pallas_key"``.

Tolerances: the forward and both gradients within 1e-5 of the reference's
largest magnitude (bf16 operands, exact products, fp32 sums in another
order); the backbone's features within 1e-4 (five levels of convs and
batch norms).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.models.pvrcnn.backbone3d import (  # noqa: E402
    VoxelBackbone8x as JBackbone)
from detmatch_tpu.ops import voxelize as jvox  # noqa: E402
from detmatch_tpu.ops.pallas import onehot_key_conv as jkey  # noqa: E402
from detmatch_tpu.utils import tiny as jtiny  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.backbone3d import (  # noqa: E402
    VoxelBackbone8x)
from detmatch_tpu_torch.ops import spconv, voxelize  # noqa: E402
from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN, key_conv  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

SHAPE = (6, 24, 20)
BAND = int(np.prod(SHAPE)) + 1
RTOL = 1e-5
BF16_GRAD_TOL = 2 ** -5  # four bf16 steps of the largest magnitude
LEVELS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "out")


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


def conv_case(kind):
    """B=3 sorted key tables with uneven counts (the last sample empty of
    every row but a few) in a grid dense enough that most taps match, and
    one conv geometry: (keys, nkeys)."""
    g = torch.Generator().manual_seed(1)
    n = 400
    keys = []
    for n_valid in (400, 230, 9):
        kk = torch.sort(torch.randperm(BAND - 1, generator=g)[:n_valid]
                        ).values.to(torch.int32)
        keys.append(torch.cat([kk, torch.full(
            (n - n_valid,), voxelize.INVALID_KEY, dtype=torch.int32)]))
    keys = torch.stack(keys)
    if kind == "subm":
        return keys, spconv.subm_neighbor_keys(keys, SHAPE)
    kernel, stride, pad = (((3, 3, 3), (2, 2, 2), (1, 1, 1))
                           if kind == "stride2"
                           else ((3, 1, 1), (2, 1, 1), (0, 0, 0)))
    shape_out = spconv.output_spatial_shape(SHAPE, kernel, stride, pad)
    out_keys, _ = spconv.downsample_keys_batched(keys, SHAPE, shape_out,
                                                 kernel, stride, pad, 300)
    return keys, spconv.sparse_neighbor_keys(out_keys, SHAPE, shape_out,
                                             kernel, stride, pad)


def conv_inputs(kind, c=8, co=16):
    keys, nkeys = conv_case(kind)
    b, m, k = nkeys.shape
    rng = np.random.RandomState(2)
    feats = rng.randn(b, keys.shape[1], c).astype(np.float32)
    w = (rng.randn(k, c, co) / np.sqrt(k * c)).astype(np.float32)
    dout = rng.randn(b, m, co).astype(np.float32)
    return keys, nkeys, feats, w, dout


@pytest.mark.parametrize("kind", ["subm", "stride2", "z3"])
def test_key_conv_matches_jax(kind):
    """Forward, dF and dW of the twin (through its autograd Function,
    whose backward is JAX's ``_vjp_bwd``) against JAX's key conv and
    ``jax.grad`` of its custom VJP."""
    keys, nkeys, feats, w, dout = conv_inputs(kind)
    jk, jn = jnp.asarray(keys.numpy()), jnp.asarray(nkeys.numpy())

    def loss(f, ww):
        out = jkey.key_conv_batched(f, jk, jn, ww, BAND)
        return jnp.sum(out * dout), out

    (_, jout), (jf, jw) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(w))
    f_t = torch.from_numpy(feats).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    out = KERNELS.key_conv_batched(f_t, keys, nkeys, w_t, BAND)
    pf, pw = torch.autograd.grad(out, (f_t, w_t), torch.from_numpy(dout))
    found = (spconv.lookup_batched(keys, nkeys.reshape(3, -1)) >= 0).sum()
    assert int(found) > nkeys.shape[1]  # more matches than output rows
    assert rel(out, jout) <= RTOL
    assert rel(pf, jf) <= RTOL
    assert rel(pw, jw) <= RTOL


def test_key_scatter_matches_jax_and_has_one_writer_per_slot():
    """On a conv's neighbour keys S of the twin equals JAX's
    ``_key_scatter_all_taps`` exactly, and a scatter-add over the same
    slots gives the same S: no slot has two writers, so the kernel's
    claim never sets its repeat flag on a model's conv and its one store
    a slot is S (repeated writers, which a conv cannot give, are summed:
    ``test_torch_port_k5k7.py`` and ``test_torch_port_conv_repeats.py``)."""
    keys, nkeys, _, _, dout = conv_inputs("stride2")
    b, n = keys.shape
    m, k = nkeys.shape[1:]
    off = (np.arange(b, dtype=np.int64) * BAND)[:, None]
    kn, nn = keys.numpy().astype(np.int64), nkeys.numpy().astype(np.int64)
    inv = voxelize.INVALID_KEY
    keys_f = np.where(kn == inv, inv, kn + off).reshape(-1)
    nk_f = np.where(nn == inv, inv, nn + off[:, :, None]).reshape(b * m, k)
    ref = jkey._key_scatter_all_taps(
        jnp.asarray(dout.reshape(b * m, -1)),
        jnp.asarray(keys_f.astype(np.int32)),
        jnp.asarray(nk_f.astype(np.int32)), b * n)
    s = key_conv.key_scatter_plain(torch.from_numpy(dout), keys, nkeys)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref))
    rb = spconv.rulebook_batched(keys, nkeys)
    bi, mi, ki = (rb >= 0).nonzero(as_tuple=True)
    added = torch.zeros_like(s).index_put_(
        (ki, bi * n + rb[bi, mi, ki].long()),
        key_conv._bf16(torch.from_numpy(dout)[bi, mi]), accumulate=True)
    assert torch.equal(added, s)
    assert int((s != 0).any(-1).sum()) == len(bi)


def test_key_conv_skips_dfeats_and_checks_the_band():
    keys, nkeys, feats, w, dout = conv_inputs("subm")
    w_t = torch.from_numpy(w).requires_grad_()
    out = PLAIN.key_conv_batched(torch.from_numpy(feats), keys, nkeys, w_t,
                                 BAND)
    (gw,) = torch.autograd.grad(out, (w_t,), torch.from_numpy(dout))
    s = key_conv.key_scatter_plain(torch.from_numpy(dout), keys, nkeys)
    df, dw = key_conv.key_conv_grads(s, torch.from_numpy(feats), w_t,
                                     need_dfeats=False)
    assert df is None and torch.equal(dw, gw)
    with pytest.raises(ValueError, match="2\\^31"):
        KERNELS.key_conv_batched(torch.from_numpy(feats), keys, nkeys, w_t,
                                 2 ** 30)


@pytest.fixture(scope="module")
def backbones():
    """The tiny JAX backbone with ``conv_impl="pallas_key"`` in train
    mode on a B=2 voxelized batch (its outputs, parameter gradients of a
    random linear loss, updated batch statistics) and the port's."""
    rng = np.random.RandomState(0)
    pts = np.stack([rng.rand(2, 400) * 15 + 0.5, rng.rand(2, 400) * 15 - 7.5,
                    rng.rand(2, 400) * 3.5 - 2.8, rng.rand(2, 400)],
                   -1).astype(np.float32)
    valid = np.ones((2, 400), bool)
    valid[1, 150:] = False
    vox = jax.vmap(lambda p, v: jvox.voxelize_mean(p, v, jtiny.TINY_SPEC))(
        jnp.asarray(pts), jnp.asarray(valid))
    cfg = jtiny.TINY_PV_CFG["backbone3d_cfg"]
    shape = (41, 32, 32)
    jbb = JBackbone(spatial_shape=shape, caps=(384, 384, 256, 256),
                    conv_impl="pallas_key", **cfg)
    var = jbb.init(jax.random.PRNGKey(0), vox["features"], vox["keys"],
                   train=False)
    srng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.5 + srng.rand(*x.shape) if p[-1].key == "var"
                      else 0.2 * srng.randn(*x.shape)).astype(np.float32),
        var["batch_stats"])
    cot = {name: srng.randn(2, n, c).astype(np.float32) for name, n, c in (
        ("x_conv1", 384, 8), ("x_conv2", 384, 16), ("x_conv3", 384, 16),
        ("x_conv4", 256, 16), ("out", 256, 32))}

    def loss(p):
        out, mut = jbb.apply({"params": p, "batch_stats": stats},
                             vox["features"], vox["keys"], train=True,
                             mutable=["batch_stats"])
        return sum(jnp.sum(out[n]["feats"] * cot[n]) for n in LEVELS), (
            out, mut["batch_stats"])

    (_, (out, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(
        var["params"])
    return dict(vox=jax.tree.map(np.asarray, vox), params=var["params"],
                stats=stats, out=jax.tree.map(np.asarray, out),
                new_stats=new_stats, grads=grads, cot=cot, shape=shape,
                cfg=cfg)


def _port_backbone(bb, params, stats):
    """The port's backbone with the JAX backbone's variables (pcdet names:
    ``conv2.0`` is JAX's ``conv2_down``, ``conv2.1`` its ``conv2_0``)."""
    model = VoxelBackbone8x(bb["shape"], caps=(384, 384, 256, 256),
                            conv_impl="key", **bb["cfg"])
    names = {"conv_input": "conv_input", "conv1.0": "conv1_0",
             "conv_out": "conv_out"}
    for lvl in (2, 3, 4):
        names[f"conv{lvl}.0"] = f"conv{lvl}_down"
        for j in (0, 1):
            names[f"conv{lvl}.{j + 1}"] = f"conv{lvl}_{j}"
    sd = model.state_dict()
    for ours, theirs in names.items():
        w = sd[ours + ".0.weight"]
        sd[ours + ".0.weight"] = torch.from_numpy(
            np.asarray(params[theirs + "_w"])).reshape(w.shape)
        for k, j in (("1.weight", "scale"), ("1.bias", "bias")):
            sd[f"{ours}.{k}"] = torch.from_numpy(
                np.asarray(params[theirs + "_bn"][j]))
        for k, j in (("1.running_mean", "mean"), ("1.running_var", "var")):
            sd[f"{ours}.{k}"] = torch.from_numpy(
                np.asarray(stats[theirs + "_bn"][j]))
    model.load_state_dict(sd)
    return model


def test_backbone_key_impl_matches_jax(backbones):
    """``VoxelBackbone8x(conv_impl="key")`` in train mode against the JAX
    backbone with ``conv_impl="pallas_key"``: every level's keys exactly,
    features within 1e-4 and the BN statistics after the update within
    1e-4; the key path launches no window conv. Weight gradients of the
    same linear loss: the last conv's within 1e-3 of the tensor's largest
    magnitude; the deeper ones within BF16_GRAD_TOL, since each conv's
    backward rounds its incoming gradient to bf16, and the ~1e-7 that
    separates the two frameworks' fp32 gradients flips some of those
    roundings by one bf16 step (2^-8 relative) on the way down."""
    bb = backbones
    model = _port_backbone(bb, bb["params"], bb["stats"]).train()
    calls = []

    def window(*a, **kw):
        calls.append(1)
        return PLAIN.window_key_conv_batched(*a, **kw)

    out = model(torch.from_numpy(bb["vox"]["features"]),
                torch.from_numpy(bb["vox"]["keys"]),
                PLAIN._replace(window_key_conv_batched=window))
    assert not calls and model.conv_impl == "key"
    loss = sum((out[n]["feats"] * torch.from_numpy(bb["cot"][n])).sum()
               for n in LEVELS)
    loss.backward()
    for n in LEVELS:
        np.testing.assert_array_equal(out[n]["keys"].numpy(),
                                      bb["out"][n]["keys"])
        assert rel(out[n]["feats"], bb["out"][n]["feats"]) <= 1e-4, n
    ref_g = _port_backbone(bb, jax.tree.map(np.asarray, bb["grads"]),
                           bb["stats"])
    ref_s = _port_backbone(bb, bb["params"],
                           jax.tree.map(np.asarray, bb["new_stats"]))
    got_sd, gs = model.state_dict(), ref_s.state_dict()
    ref_sd = ref_g.state_dict()
    for name, p in model.named_parameters():
        tol = 1e-3 if name.startswith("conv_out.") else BF16_GRAD_TOL
        assert rel(p.grad, ref_sd[name]) <= tol, name
    for k, v in gs.items():
        if k.endswith(("running_mean", "running_var")):
            assert rel(got_sd[k], v) <= 1e-4, k


def test_backbone_rejects_unknown_impl():
    with pytest.raises(ValueError, match="conv_impl"):
        VoxelBackbone8x((41, 32, 32), conv_impl="pallas_key")
