"""CPU parity of the port's rulebook sparse-conv path against the JAX
package: ``spconv.rulebook_batched`` against the lookup of JAX's
``VoxelBackbone8x._rulebook``, the plain twin of kernel K7
(``ops/cuda/gather_conv.py``, through its ``autograd.Function``) against
JAX's ``spconv.gather_conv_batched`` and ``spconv_kernel.fused_gather_conv``
(on the CPU ``pallas_gather_conv`` refuses to run outside interpret mode,
so JAX falls back to its own XLA gather-GEMM, the oracle), and
``VoxelBackbone8x(conv_impl="rulebook")`` against the JAX backbone with
``conv_impl="xla"``.

Tolerances: rulebooks and keys exactly; the conv's forward, dF and dW
within 1e-5 of the reference's largest magnitude (fp32, sums in another
order); the backbone's features and BN statistics within 1e-4 (five
levels of convs and batch norms), its weight gradients within 1e-3.
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
from detmatch_tpu.ops import spconv as jspconv  # noqa: E402
from detmatch_tpu.ops import voxelize as jvox  # noqa: E402
from detmatch_tpu.ops.pallas import spconv_kernel as jkernel  # noqa: E402
from detmatch_tpu.utils import tiny as jtiny  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.backbone3d import (  # noqa: E402
    VoxelBackbone8x)
from detmatch_tpu_torch.ops import spconv, voxelize  # noqa: E402
from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN  # noqa: E402
from detmatch_tpu_torch.ops.cuda import gather_conv  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

SHAPE = (6, 24, 20)
RTOL = 1e-5
LEVELS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "out")
KINDS = ("subm", "stride2", "z3")


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


def conv_case(kind):
    """B=3 sorted key tables with uneven counts (400 / 230 / 9 valid
    rows) and one conv geometry: (keys, nkeys); the strided geometries'
    output tables are INVALID-padded."""
    g = torch.Generator().manual_seed(1)
    n = 400
    keys = []
    for n_valid in (400, 230, 9):
        kk = torch.sort(torch.randperm(int(np.prod(SHAPE)), generator=g)[
            :n_valid]).values.to(torch.int32)
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


@pytest.mark.parametrize("kind", KINDS)
def test_rulebook_matches_jax(kind):
    """The rulebook of JAX's backbone (``lookup_batched`` with the band of
    ``_rulebook``), exactly, the INVALID-padded output rows included."""
    keys, nkeys = conv_case(kind)
    b, m, k = nkeys.shape
    ref = jspconv.lookup_batched(
        jnp.asarray(keys.numpy()), jnp.asarray(nkeys.numpy()).reshape(
            b, m * k), band=int(np.prod(SHAPE)) + 2)
    rb = spconv.rulebook_batched(keys, nkeys)
    assert rb.dtype == torch.int32 and rb.shape == (b, m, k)
    np.testing.assert_array_equal(rb.numpy(),
                                  np.asarray(ref).reshape(b, m, k))
    assert int((rb >= 0).sum()) > m  # more matches than output rows
    padded = (nkeys == voxelize.INVALID_KEY).all(-1)
    assert bool((rb[padded] == -1).all())


def conv_inputs(kind, c=8, co=16):
    keys, nkeys = conv_case(kind)
    rb = spconv.rulebook_batched(keys, nkeys)
    b, m, k = rb.shape
    rng = np.random.RandomState(2)
    feats = rng.randn(b, keys.shape[1], c).astype(np.float32)
    w = (rng.randn(k, c, co) / np.sqrt(k * c)).astype(np.float32)
    dout = rng.randn(b, m, co).astype(np.float32)
    return rb, feats, w, dout


@pytest.mark.parametrize("kind", KINDS)
def test_gather_conv_matches_jax(kind):
    """Forward, dF and dW of the K7 twin (the wrapper on CPU tensors,
    through its ``autograd.Function``) against JAX's gather_conv_batched
    and ``jax.grad`` of it; the forward per sample against
    ``fused_gather_conv``."""
    rb, feats, w, dout = conv_inputs(kind)
    jrb = jnp.asarray(rb.numpy())

    def loss(f, ww):
        out = jspconv.gather_conv_batched(f, jrb, ww)
        return jnp.sum(out * dout), out

    (_, jout), (jf, jw) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(w))
    f_t = torch.from_numpy(feats).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    gather_conv.gather_conv_batched.launches = 0
    out = KERNELS.gather_conv_batched(f_t, rb, w_t)
    assert out.grad_fn.name().startswith("GatherConv")
    pf, pw = torch.autograd.grad(out, (f_t, w_t), torch.from_numpy(dout))
    assert gather_conv.gather_conv_batched.launches == 0
    assert rel(out, jout) <= RTOL
    assert rel(pf, jf) <= RTOL
    assert rel(pw, jw) <= RTOL
    for i in range(rb.shape[0]):
        fused = jkernel.fused_gather_conv(jnp.asarray(feats[i]), jrb[i],
                                          jnp.asarray(w))
        assert rel(out[i], fused) <= RTOL


def test_gather_conv_weight_gradient_alone():
    """With ``feats`` not requiring a gradient the backward skips dF and
    gives the same dW; the twin of ``PLAIN`` is the same function."""
    rb, feats, w, dout = conv_inputs("stride2")
    f = torch.from_numpy(feats)
    w_t = torch.from_numpy(w).requires_grad_()
    (gw,) = torch.autograd.grad(PLAIN.gather_conv_batched(f, rb, w_t),
                                (w_t,), torch.from_numpy(dout))
    df, dw = gather_conv.gather_conv_grads(torch.from_numpy(dout), f, rb,
                                           w_t.detach(), need_dfeats=False)
    assert df is None and torch.equal(dw, gw)
    ref = spconv.gather_conv_batched(f, rb, w_t.detach())
    assert torch.equal(KERNELS.gather_conv_batched(f, rb, w_t).detach(),
                       ref)


@pytest.fixture(scope="module")
def backbones():
    """The tiny JAX backbone with ``conv_impl="xla"`` on a B=3 voxelized
    batch with uneven valid counts: in eval mode (outputs) and in train
    mode (outputs, parameter gradients of a random linear loss, updated
    batch statistics)."""
    rng = np.random.RandomState(0)
    pts = np.stack([rng.rand(3, 400) * 15 + 0.5, rng.rand(3, 400) * 15 - 7.5,
                    rng.rand(3, 400) * 3.5 - 2.8, rng.rand(3, 400)],
                   -1).astype(np.float32)
    valid = np.ones((3, 400), bool)
    valid[1, 150:] = False
    valid[2, 30:] = False
    vox = jax.vmap(lambda p, v: jvox.voxelize_mean(p, v, jtiny.TINY_SPEC))(
        jnp.asarray(pts), jnp.asarray(valid))
    cfg = jtiny.TINY_PV_CFG["backbone3d_cfg"]
    shape = (41, 32, 32)
    caps = (384, 384, 256, 256)
    jbb = JBackbone(spatial_shape=shape, caps=caps, conv_impl="xla", **cfg)
    var = jbb.init(jax.random.PRNGKey(0), vox["features"], vox["keys"],
                   train=False)
    srng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.5 + srng.rand(*x.shape) if p[-1].key == "var"
                      else 0.2 * srng.randn(*x.shape)).astype(np.float32),
        var["batch_stats"])
    cot = {name: srng.randn(3, n, c).astype(np.float32) for name, n, c in (
        ("x_conv1", 384, 8), ("x_conv2", 384, 16), ("x_conv3", 384, 16),
        ("x_conv4", 256, 16), ("out", 256, 32))}
    out_eval = jax.jit(lambda v, f, k: jbb.apply(v, f, k, train=False))(
        {"params": var["params"], "batch_stats": stats}, vox["features"],
        vox["keys"])

    def loss(p):
        out, mut = jbb.apply({"params": p, "batch_stats": stats},
                             vox["features"], vox["keys"], train=True,
                             mutable=["batch_stats"])
        return sum(jnp.sum(out[n]["feats"] * cot[n]) for n in LEVELS), (
            out, mut["batch_stats"])

    (_, (out, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(var["params"])
    return dict(vox=jax.tree.map(np.asarray, vox), params=var["params"],
                stats=stats, out_eval=jax.tree.map(np.asarray, out_eval),
                out=jax.tree.map(np.asarray, out), new_stats=new_stats,
                grads=grads, cot=cot, shape=shape, caps=caps, cfg=cfg)


def _port_backbone(bb, params, stats):
    """The port's rulebook-path backbone with the JAX backbone's variables
    (pcdet names: ``conv2.0`` is JAX's ``conv2_down``, ``conv2.1`` its
    ``conv2_0``)."""
    model = VoxelBackbone8x(bb["shape"], caps=bb["caps"],
                            conv_impl="rulebook", **bb["cfg"])
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


def _run(model, bb):
    """Forward on the fixture's voxels through ``PLAIN`` with the rulebook
    conv recorded: (levels, the rulebooks handed to the 12 convs)."""
    rulebooks = []

    def conv(feats, rb, w):
        rulebooks.append(rb)
        return PLAIN.gather_conv_batched(feats, rb, w)

    out = model(torch.from_numpy(bb["vox"]["features"]),
                torch.from_numpy(bb["vox"]["keys"]),
                PLAIN._replace(gather_conv_batched=conv))
    return out, rulebooks


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_backbone_rulebook_impl_matches_jax(backbones, mode):
    """``VoxelBackbone8x(conv_impl="rulebook")`` against the JAX backbone
    with ``conv_impl="xla"``: every level's keys exactly, features within
    1e-4; 12 convs on 8 rulebooks (one per subm pair, shared by its two
    convs, and one per strided conv). In train mode also the BN
    statistics after the update within 1e-4 and the weight gradients of
    the same linear loss within 1e-3 of each tensor's largest
    magnitude."""
    bb = backbones
    model = _port_backbone(bb, bb["params"], bb["stats"])
    model.train(mode == "train")
    out, rulebooks = _run(model, bb)
    assert len(rulebooks) == 12
    assert len({id(rb) for rb in rulebooks}) == 8
    ref = bb["out"] if mode == "train" else bb["out_eval"]
    for n in LEVELS:
        np.testing.assert_array_equal(out[n]["keys"].numpy(), ref[n]["keys"])
        assert rel(out[n]["feats"], ref[n]["feats"]) <= 1e-4, n
    if mode == "eval":
        return
    loss = sum((out[n]["feats"] * torch.from_numpy(bb["cot"][n])).sum()
               for n in LEVELS)
    loss.backward()
    ref_g = _port_backbone(bb, jax.tree.map(np.asarray, bb["grads"]),
                           bb["stats"]).state_dict()
    for name, p in model.named_parameters():
        assert rel(p.grad, ref_g[name]) <= 1e-3, name
    ref_s = _port_backbone(bb, bb["params"],
                           jax.tree.map(np.asarray, bb["new_stats"]))
    got = model.state_dict()
    for k, v in ref_s.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert rel(got[k], v) <= 1e-4, k
