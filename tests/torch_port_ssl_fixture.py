"""Shared set-up of the SSL-iteration parity tests
(``test_torch_port_ssl_step.py``, ``test_torch_port_ssl_switches.py``):
the models of ``configs/tests/ssl_tiny.py`` in both packages with the
same weights, one collated batch, and stand-ins that hand the JAX
package's random draws to the port.

Weights: the JAX models' own initialisers (``SSLDetector.init_states``),
batch-norm running statistics randomized, and the class biases of the
PV-RCNN anchor head and the Faster R-CNN box head spread around zero so
that the teacher's 3D and 2D boxes pass the 0.1 score filters (the
initial rare-class prior puts every score near 0.01). They reach the port
through ``convert.from_jax_ssl``.

Random draws: ``jax.random`` and ``torch.Generator`` cannot share
numbers, so the port's samplers and dropout are replaced by stand-ins
that return JAX's: the RoI picks from the JAX package's own ``_pick`` on
the sampling key JAX used (as ``test_torch_port_train_step.py`` does),
the dropout masks that the JAX forward drew (recorded from
``jax.random.bernoulli`` while it was traced), and the 2D samplers'
uniforms from the keys ``FasterRCNN.loss`` splits, in the order the port
draws them.

Threads: ``one_torch_thread``, imported by every file of the port's CPU
parity tests against JAX, runs each such module's tests with one PyTorch
thread. The tests
run in several worker processes at once (``pytest -n``), and PyTorch's
default of one thread per core in each of them oversubscribes the cores;
the tiny models gain nothing from more threads. The few steps that cost
tens of seconds on one thread (the default RoI head's grid pooling, the
zoo's train passes) run inside ``port_threads`` (4 threads).
"""
import contextlib
import os
import sys
import types

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax.linen import stochastic  # noqa: E402

from detmatch_tpu.core import transforms as jtf  # noqa: E402
from detmatch_tpu.models.frcnn.faster_rcnn import (  # noqa: E402
    FasterRCNN as JFasterRCNN)
from detmatch_tpu.models.pvrcnn import roi_head as jroi  # noqa: E402
from detmatch_tpu.models.pvrcnn.pvrcnn import PVRCNN as JPVRCNN  # noqa: E402
from detmatch_tpu.ssl.detector import SSLConfig as JSSLConfig  # noqa: E402
from detmatch_tpu.ssl.detector import (  # noqa: E402
    SSLDetector as JSSLDetector)
from detmatch_tpu.train.ssl_step import (  # noqa: E402
    voxelize_views as j_voxelize_views)
from detmatch_tpu.ops import voxelize as jvox  # noqa: E402
from detmatch_tpu_torch.apis.build import (build_ssl,  # noqa: E402
                                           build_voxelizer)
from detmatch_tpu_torch.config import Config  # noqa: E402
from detmatch_tpu_torch.convert import from_jax_ssl  # noqa: E402
from detmatch_tpu_torch.models.frcnn import rpn as prpn  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn import roi_head as proi  # noqa: E402
from detmatch_tpu_torch.train.ssl_step import (  # noqa: E402
    to_device_views, voxelize_views)
from detmatch_tpu_torch.utils import tiny  # noqa: E402

CONFIG = os.path.join(ROOT, "configs", "tests", "ssl_tiny.py")
B = 1  # the config's batch_size


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch thread for the importing module's tests, restored
    after them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# threads for the port's heaviest CPU steps (a train step through the
# default RoI head's grid pooling, the zoo's two train passes): on an
# 8-core x86 host, 4 run the SSL student step of
# test_torch_port_ssl_step.py in 11 s instead of 30, every checked error
# as at one thread
PORT_THREADS = 4


@contextlib.contextmanager
def port_threads(n=PORT_THREADS):
    """``n`` PyTorch threads inside the block, then the module's one."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def load_cfg(**ssl_overrides):
    cfg = Config.fromfile(CONFIG)
    cfg["ssl"] = dict(cfg.get("ssl", {}), **ssl_overrides)
    return cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def views(seed):
    """The collated numpy batch: non-identity 3D augmentations, and image
    records of a resize from the 375 x 1242 original (flipped in the
    student's unlabeled view)."""
    rng = np.random.RandomState(seed)
    batch = tiny.tiny_ssl_batch(rng, b=B)
    sx, sy = 128.0 / 1242.0, 64.0 / 375.0
    for split in ("lab", "unlab"):
        for name, flip in (("tea", 0.0), ("stu", 1.0)):
            v = batch[split][name]
            v["aug2d"] = dict(
                scale=np.tile(np.array([[sx, sy, sx, sy]], np.float32),
                              (B, 1)),
                flip=np.full(B, flip, np.float32),
                img_w=np.full(B, 128.0, np.float32))
            v["aug3d"] = dict(
                flip_x=np.full(B, flip, np.float32),
                rot=(rng.rand(B) - 0.5).astype(np.float32),
                scale=np.ones(B, np.float32) if name == "tea" else
                (0.95 + 0.1 * rng.rand(B)).astype(np.float32),
                trans=(rng.randn(B, 3) * 0.2).astype(np.float32))
    return batch


def jax_views(batch):
    def view(v):
        out = {k: jnp.asarray(a) for k, a in v.items()
               if k not in ("aug3d", "aug2d")}
        out["aug3d"] = jtf.Aug3D(**_j(v["aug3d"]))
        out["aug2d"] = jtf.Aug2D(**_j(v["aug2d"]))
        return out
    return {s: {k: view(v) for k, v in d.items()} for s, d in batch.items()}


def jax_ssl(cfg):
    m = cfg["model"]
    return JSSLDetector(JPVRCNN(**m["detector_3d"]),
                        JFasterRCNN(**m["detector_2d"]),
                        JSSLConfig(**cfg["ssl"]))


def jax_spec(cfg):
    v = cfg["voxelizer"]
    return jvox.VoxelizerSpec(point_cloud_range=tuple(v["point_cloud_range"]),
                              voxel_size=tuple(v["voxel_size"]),
                              max_voxels=v["max_voxels"],
                              max_points=v["max_points"])


def make_state(jssl, vb, seed=0):
    """Student = teacher: the JAX initialisers, randomized BN statistics,
    spread class biases (see the module docstring)."""
    lab = vb["lab"]["stu"]
    # jitted: one program, not one per initializer and shape (the values
    # agree with the eager init's to the last float32 bit but for a few
    # small-scale kernels, within 5e-10)
    state = jax.jit(jssl.init_states)(jax.random.PRNGKey(seed), lab,
                                      lab["img"], lab["img_shape"])
    stu = _np(state["student"])
    rng = np.random.RandomState(seed + 1)

    def rand_stat(path, x):
        if path[-1].key == "var":
            return (0.5 + rng.rand(*x.shape)).astype(np.float32)
        return (0.2 * rng.randn(*x.shape)).astype(np.float32)

    stu["det3d"]["batch_stats"] = jax.tree_util.tree_map_with_path(
        rand_stat, stu["det3d"]["batch_stats"])
    dh = stu["det3d"]["params"]["dense_head"]["conv_cls"]
    dh["bias"] = (0.5 * rng.randn(*dh["bias"].shape)).astype(np.float32)
    fc = stu["det2d"]["params"]["bbox_head"]["fc_cls"]
    fc["bias"] = (0.5 * rng.randn(*fc["bias"].shape)).astype(np.float32)
    return dict(student=stu, teacher=jax.tree.map(np.copy, stu))


def shared_state(jssl, vb, name, tmp_path_factory, seed=0, wait_s=600):
    """:func:`make_state` once per test session for the modules that call
    it with the same ``name`` (the same model widths and batch shapes):
    the first computes it and leaves it under the session's temporary
    root, which every ``pytest -n`` worker shares; the others wait for
    that file and load it."""
    import pickle
    import time
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the session's root, above the workers' own
    path = base / f"jax_ssl_state_{name}_{seed}.pkl"
    try:
        fd = os.open(str(path) + ".lock", os.O_CREAT | os.O_EXCL)
    except FileExistsError:
        t0 = time.monotonic()
        while not path.exists() and time.monotonic() - t0 < wait_s:
            time.sleep(0.5)
        if path.exists():
            with open(path, "rb") as f:
                stu = pickle.load(f)
            return dict(student=stu, teacher=jax.tree.map(np.copy, stu))
        return make_state(jssl, vb, seed)
    os.close(fd)
    state = make_state(jssl, vb, seed)
    tmp = str(path) + f".{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(state["student"], f)  # the teacher is its copy
    os.replace(tmp, path)
    return state


def port_ssl(cfg, state):
    m = cfg["model"]
    model = build_ssl(cfg, device="cpu")
    model.load_state_dict(from_jax_ssl(state, m["detector_3d"],
                                       m["detector_2d"]))
    return model


def port_views(cfg, batch):
    return voxelize_views(to_device_views(batch, "cpu"), build_voxelizer(cfg))


class DropoutMasks:
    """Records the masks ``jax.random.bernoulli`` draws for flax's
    ``Dropout`` while a function is traced (``recording()``), and replays
    them, in order, to the port's RoI head (``replay``)."""

    def __init__(self):
        self.traced = []
        self.masks = []

    def recording(self):
        orig = stochastic.random

        def bernoulli(key, p, shape):
            mask = orig.bernoulli(key, p=p, shape=shape)
            self.traced.append(mask)
            return mask

        shim = types.SimpleNamespace(bernoulli=bernoulli)
        mp = pytest.MonkeyPatch()
        mp.setattr(stochastic, "random", shim)
        return mp

    def replay(self, monkeypatch):
        masks = iter(self.masks)

        def dropout(x, p, generator, row_groups=1):
            if p == 0.0:
                return x
            mask = torch.from_numpy(np.array(next(masks)))
            assert mask.shape == x.shape
            return torch.where(mask, x / (1.0 - p), 0.0)

        monkeypatch.setattr(proi, "dropout", dropout)


def roi_picks(key, b):
    """The port's ``roi_head._pick`` giving the JAX package's picks: per
    sample, the keys ``sample_rois_single`` splits from the sampling key,
    in the order the port draws (fg, fg with replacement, hard, easy)."""
    seq = []
    for k in jax.random.split(key, b):
        k_fg, k_hard, k_easy, k_fg2 = jax.random.split(k, 4)
        seq += [k_fg, k_fg2, k_hard, k_easy]
    keys = iter(seq)

    def pick(generator, cand_mask, n_slots, with_replacement):
        idx, avail = jroi._pick(next(keys), jnp.asarray(cand_mask.numpy()),
                                n_slots, with_replacement)
        return torch.from_numpy(np.array(idx)).long(), torch.tensor(
            int(avail))

    return pick


def frcnn_uniforms(rng_keys, b):
    """The port's ``rpn.sample_uniforms`` giving the uniforms of JAX's
    ``FasterRCNN.loss`` called once per key of ``rng_keys``: per call the
    RPN's images, then the RoI head's, each ``random_sample`` drawing two
    uniform vectors from the two halves of its key."""
    seq = []
    for key in rng_keys:
        k_rpn, k_rcnn = jax.random.split(key)
        seq += list(jax.random.split(k_rpn, b))
        seq += list(jax.random.split(k_rcnn, b))
    keys = iter(seq)

    def uniforms(generator, n, device):
        k1, k2 = jax.random.split(next(keys))
        return (torch.from_numpy(np.array(jax.random.uniform(k1, (n,)))),
                torch.from_numpy(np.array(jax.random.uniform(k2, (n,)))))

    return uniforms


def capture_sampling_key(monkeypatch, captured):
    """Record the key the JAX RoI sampling receives while traced."""
    assign = jroi.assign_roi_targets

    def spy(rng_key, proposals, gt_boxes, cfg=None):
        captured["key"] = rng_key
        return assign(rng_key, proposals, gt_boxes, cfg)

    monkeypatch.setattr(jroi, "assign_roi_targets", spy)


def hand_over_frcnn(monkeypatch, rng):
    """Port 2D samplers ← JAX ``student_losses_2d(rng)``'s draws."""
    monkeypatch.setattr(prpn, "sample_uniforms",
                        frcnn_uniforms(list(jax.random.split(rng)), B))


def pseudo_to_torch(pseudo):
    out = {k: to_torch(_np(v)) for k, v in pseudo.items() if k != "logs"}
    out["logs"] = {k: torch.tensor(float(v))
                   for k, v in pseudo.get("logs", {}).items()}
    return out


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else ref
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)
