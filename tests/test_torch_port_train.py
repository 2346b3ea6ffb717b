"""CPU parity of the port's training building blocks against the JAX
package: train-mode masked batch norm, the sparse conv's gradient (the
plain path the CUDA backward is held against), the one-cycle rate,
dropout, the synthetic GT draw, the device default of ``build_detector``,
and ``train_pvrcnn`` end to end at the tiny size.

The whole training step against ``jax.value_and_grad`` is in
``test_torch_port_train_step.py``.
"""
import copy
import inspect
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu import benchmarks as jbench  # noqa: E402
from detmatch_tpu.models.layers import MaskedBatchNorm  # noqa: E402
from detmatch_tpu.ops import spconv as jspconv  # noqa: E402
from detmatch_tpu.train import optim as joptim  # noqa: E402
from detmatch_tpu.utils import tiny  # noqa: E402
from detmatch_tpu_torch.apis.build import build_detector  # noqa: E402
from detmatch_tpu_torch.apis.train_pretrain import (  # noqa: E402
    train_pvrcnn_batches)
from detmatch_tpu_torch.models.layers import dropout, masked_bn  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import PVRCNN  # noqa: E402
from detmatch_tpu_torch.ops import spconv, voxelize  # noqa: E402
from detmatch_tpu_torch.ops.cuda import window_key_conv  # noqa: E402
from detmatch_tpu_torch.train.optim import cyclic_lr  # noqa: E402
from detmatch_tpu_torch.utils import synth_kitti  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

CFG = dict(tiny.TINY_PV_CFG,
           bev_cfg=dict(tiny.TINY_PV_CFG["bev_cfg"], layer_nums=(5, 5)))
LOSS_KEYS = {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir",
             "point_loss_cls", "rcnn_loss_cls", "rcnn_loss_reg",
             "rcnn_loss_corner", "loss"}


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


@pytest.mark.parametrize("masked,eps", [(True, 1e-3), (True, 1e-5),
                                        (False, 1e-3)])
def test_masked_batch_norm_train_matches_jax(masked, eps):
    """Train-mode batch norm on a padded (B, N, C) buffer: outputs and
    both running statistics after the update within 1e-5 relative."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 50, 8) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(3, 50) < 0.6
    x[~mask] = 1e3  # padding must not move the statistics
    mask_j = jnp.asarray(mask) if masked else None
    scale = (1 + 0.1 * rng.randn(8)).astype(np.float32)
    bias = (0.1 * rng.randn(8)).astype(np.float32)
    mean0 = rng.randn(8).astype(np.float32)
    var0 = (0.5 + rng.rand(8)).astype(np.float32)
    y, mut = MaskedBatchNorm(eps=eps).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mask=mask_j, mutable=["batch_stats"])

    bn = torch.nn.BatchNorm1d(8, eps=eps, momentum=0.01).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean0), (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    got = masked_bn(bn, torch.from_numpy(x),
                    torch.from_numpy(mask) if masked else None)
    assert rel(got, y) <= 1e-5
    if masked:
        assert not got[torch.from_numpy(~mask)].any()
    assert rel(bn.running_mean, mut["batch_stats"]["mean"]) <= 1e-5
    assert rel(bn.running_var, mut["batch_stats"]["var"]) <= 1e-5


def _conv_case(kind):
    """B=3 sorted key tables with uneven counts and one conv geometry."""
    g = torch.Generator().manual_seed(1)
    shape = (41, 200, 176)
    n = 300
    keys = []
    for n_valid in (300, 170, 40):
        kk = torch.sort(torch.randperm(41 * 200 * 176, generator=g)[
            :n_valid]).values.to(torch.int32)
        keys.append(torch.cat([kk, torch.full(
            (n - n_valid,), voxelize.INVALID_KEY, dtype=torch.int32)]))
    keys = torch.stack(keys)
    if kind == "subm":
        return keys, spconv.subm_neighbor_keys(keys, shape), keys
    kernel, stride, pad = (((3, 3, 3), (2, 2, 2), (1, 1, 1))
                           if kind == "stride2"
                           else ((3, 1, 1), (2, 1, 1), (0, 0, 0)))
    shape_out = spconv.output_spatial_shape(shape, kernel, stride, pad)
    out_keys, _ = spconv.downsample_keys_batched(keys, shape, shape_out,
                                                 kernel, stride, pad, 250)
    return keys, spconv.sparse_neighbor_keys(
        out_keys, shape, shape_out, kernel, stride, pad), out_keys


@pytest.mark.parametrize("kind", ["subm", "stride2", "z3"])
def test_window_key_conv_gradient_matches_jax(kind):
    """dF and dW of the port's sparse conv (its plain twin on the CPU,
    differentiated by autograd) against ``jax.grad`` through the XLA
    rulebook path (``lookup_batched`` + ``gather_conv_batched``), within
    1e-5 relative."""
    keys, nkeys, out_keys = _conv_case(kind)
    b, m, k = nkeys.shape
    rng = np.random.RandomState(2)
    feats = rng.randn(b, keys.shape[1], 16).astype(np.float32)
    w = rng.randn(k, 16, 32).astype(np.float32)
    dout = rng.randn(b, m, 32).astype(np.float32)
    band = 41 * 200 * 176 + 1
    rb = jspconv.lookup_batched(jnp.asarray(keys.numpy()), jnp.asarray(
        nkeys.reshape(b, m * k).numpy()), band=band + 1).reshape(b, m, k)
    jf, jw = jax.grad(lambda f, ww: jnp.sum(
        jspconv.gather_conv_batched(f, rb, ww) * dout), (0, 1))(
        jnp.asarray(feats), jnp.asarray(w))
    f_t = torch.from_numpy(feats).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    out = window_key_conv.window_key_conv_batched(f_t, keys, nkeys, out_keys,
                                                  w_t, band)
    pf, pw = torch.autograd.grad(out, (f_t, w_t), torch.from_numpy(dout))
    assert (np.asarray(rb) >= 0).sum() > 0
    assert rel(pf, jf) <= 1e-5
    assert rel(pw, jw) <= 1e-5


def test_cyclic_lr_matches_jax():
    total = 7400
    jfn, pfn = joptim.cyclic_lr(0.001, total), cyclic_lr(0.001, total)
    for it in (0, 1, int(0.4 * total), int(0.7 * total), total - 1):
        ref = float(jfn(it))
        assert abs(pfn(it) - ref) <= 1e-6 * ref, it


def test_dropout_keeps_share_and_scales():
    x = torch.ones(400, 1000)
    p = 0.3
    a = dropout(x, p, torch.Generator().manual_seed(5))
    kept = a != 0
    assert abs(float(kept.float().mean()) - (1 - p)) <= 0.01
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / (1 - p)))
    b = dropout(x, p, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, p, torch.Generator().manual_seed(6)))
    assert dropout(x, 0.0, None) is x


def test_gt_boxes_equal_benchmark_draw():
    """``synth_kitti.gt_boxes`` consumes the same RandomState draws in the
    same order as the JAX benchmark's ``make_view(..., with_gt=True)``."""
    canvas = (4, 8)
    view = jbench.make_view(np.random.RandomState(3), 2, 64, canvas,
                            with_gt=True)
    rng = np.random.RandomState(3)
    synth_kitti.lidar_batch(rng, 2, 64, jbench.PCR)
    rng.randn(2, *canvas, 3)
    gt = synth_kitti.gt_boxes(rng, 2)
    np.testing.assert_array_equal(gt, np.asarray(view["gt_boxes"]))
    assert gt.shape == (2, 40, 8) and (gt[:, :20, 7] > 0).all()
    assert not gt[:, 20:].any()


def test_build_detector_defaults_to_the_card():
    """No ``device`` means the card; here, without one, that raises
    instead of falling back to the CPU."""
    assert inspect.signature(build_detector).parameters[
        "device"].default == "cuda"
    cfg = {"model": {"detector_3d": dict(CFG, type="PVRCNN")}}
    if torch.cuda.is_available():
        assert next(build_detector(cfg).parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build_detector(cfg)
    assert not build_detector(cfg, device="cpu").training


def test_train_pvrcnn_runs_on_cpu(tmp_path):
    """3 steps at the tiny config on 2 synthetic frames: finite losses,
    moving parameters, ``log.json`` with the JAX loop's keys, and the
    same seed giving the same losses twice."""
    spec = voxelize.VoxelizerSpec(*tiny.TINY_SPEC)
    model = PVRCNN(**CFG)

    def frames():
        rng = np.random.RandomState(0)
        while True:
            v = tiny.tiny_view(rng, b=2, p=256, with_gt=True)
            yield {k: np.asarray(v[k])
                   for k in ("points", "points_valid", "gt_boxes")}

    runs = []
    for i in range(2):
        m = copy.deepcopy(model)
        before = {n: p.detach().clone() for n, p in m.named_parameters()}
        m, opt, hist = train_pvrcnn_batches(m, spec, frames(),
                                            tmp_path / str(i), max_iters=3,
                                            log_interval=1, seed=0)
        assert isinstance(opt, torch.optim.AdamW) and m.training
        moved = [not torch.equal(p, before[n])
                 for n, p in m.named_parameters()]
        assert sum(moved) > 0.9 * len(moved)
        runs.append(hist)
        lines = (tmp_path / str(i) / "log.json").read_text().splitlines()
        assert len(lines) == 3
        for line in lines:
            entry = json.loads(line)
            assert set(entry) == LOSS_KEYS | {"iter", "mode", "time"}
            assert all(np.isfinite(entry[k]) for k in LOSS_KEYS)
    assert runs[0] == runs[1]
