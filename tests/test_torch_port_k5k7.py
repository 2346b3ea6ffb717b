"""The host-side plan of K7 (rulebook gather-GEMM, ``ops/cuda/gather_conv``,
on the gather-GEMM tile of ``ops/cuda/window_key_conv``) and of K5's
backward (``ops/cuda/key_conv``, S from the forward's rulebook), the
constants and entry points they mirror from ``csrc/gather_conv.cu``,
``csrc/key_conv.cu`` and ``csrc/gather_gemm.cuh``, and the plain twins
against the JAX package: the rulebook-keyed S twin against JAX's
``_key_scatter_all_taps`` (its Pallas kernel in interpret mode) on
submanifold, stride-2 and (3, 1, 1) convs, and K7's twin against JAX's
``pallas_gather_conv`` run in interpret mode at C = 3, Co = 5 (channels
the kernel pads). Runs on the CPU: the plans are plain Python and the
wrappers take the twins on CPU tensors.

Tolerances: S exactly on convs (one bf16-rounded row a slot, no sum),
within 1e-5 of the reference's largest magnitude where a rulebook
repeats a slot (fp32 sums in another order); K7's twin within 1e-5 (fp32,
sums in another order).
"""
import functools
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from detmatch_tpu.ops.pallas import onehot_key_conv as jkey  # noqa: E402
from detmatch_tpu.ops.pallas import spconv_kernel as jkernel  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.backbone3d import (  # noqa: E402
    SparseConv3d, VoxelBackbone8x)
from detmatch_tpu_torch.ops import spconv, voxelize  # noqa: E402
from detmatch_tpu_torch.ops.cuda import build, gather_conv  # noqa: E402
from detmatch_tpu_torch.ops.cuda import key_conv  # noqa: E402
from detmatch_tpu_torch.ops.cuda import window_key_conv as wkc  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

CSRC = ROOT / "detmatch_tpu_torch" / "csrc"
SHAPE = (6, 24, 20)
BAND = int(np.prod(SHAPE)) + 1


def _constant(path, name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         path.read_text()).group(1))


def _arity(name):
    """Parameters of the C entry point ``name`` in csrc/*.cu."""
    for src in CSRC.glob("*.cu"):
        hit = re.search(rf"DM_EXPORT int {name}\(([^)]*)\)", src.read_text())
        if hit:
            return hit.group(1).count(",") + 1
    raise AssertionError(f"{name} not found in csrc/")


def test_constants_match_the_sources():
    """K5, K6 and K7 take C and Co up to 128 with C * Co up to 16,384,
    as K1 does; K1's and K5's backward share the inverse map's fill."""
    gc = CSRC / "gather_conv.cu"
    for const, value, k1 in (
            ("kMaxTaps", gather_conv.MAX_TAPS, wkc.MAX_TAPS),
            ("kMaxCin", gather_conv.MAX_CIN, wkc.MAX_CIN),
            ("kMaxCout", gather_conv.MAX_COUT, wkc.MAX_COUT),
            ("kMaxW", gather_conv.MAX_W, wkc.MAX_W)):
        assert _constant(gc, const) == value == k1
        assert _constant(CSRC / "key_conv.cu", const) == value
        assert _constant(CSRC / "onehot_gather_conv.cu", const) == value
    assert (gather_conv.MAX_CIN, gather_conv.MAX_W) == (128, 16384)
    for src in ("key_conv.cu", "window_key_conv_bwd.cu"):
        hit = re.search(r"constexpr int32_t kUnclaimed = (0x[0-9a-f]+);",
                        (CSRC / src).read_text())
        assert int(hit.group(1), 16) == key_conv.UNCLAIMED, src
    assert _constant(CSRC / "gather_gemm.cuh", "kMaxSmem") == wkc.MAX_SMEM
    assert _constant(CSRC / "gather_gemm.cuh", "kMaxRows") == max(
        wkc.TILE_ROWS)


def test_entry_points_match_their_bindings():
    """K7 runs the tile in map mode (with the padding prologue), K1's
    forward the same prologue; K6's forward is its own bf16 tensor-core
    tile (the earlier per-block kernel is gone); K5's forward writes the
    rulebook for a backward that searches no key, and every C entry
    point has the arity ctypes declares."""
    gc = (CSRC / "gather_conv.cu").read_text()
    assert "launch_gather_gemm<false>(" in gc
    assert "launch_pad_operands<false>(" in gc
    assert "__global__" not in gc  # K7 only: the shared tile
    assert "launch_pad_operands<false>(" in (
        CSRC / "window_key_conv.cu").read_text()
    og = (CSRC / "onehot_gather_conv.cu").read_text()
    assert "dm_onehot_gather_conv_fwd" in og
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in og
    assert not any("gather_conv_kernel" in p.read_text()
                   for p in CSRC.glob("*.cu*"))
    kc = (CSRC / "key_conv.cu").read_text()
    assert "launch_pad_operands<true>(" in kc
    assert re.search(r"launch_gather_gemm<true>\([^;]*\bout, rb,", kc)
    assert "lower_bound" not in kc
    for name in ("dm_gather_conv_fwd", "dm_onehot_gather_conv_fwd",
                 "dm_key_conv_fwd", "dm_key_conv_bwd_scatter"):
        assert _arity(name) == len(build.SIGNATURES[name]), name


def _backbone_convs():
    """(K, C, Co, M cap) of the backbone's 12 convs at the default
    widths: the caps (24,000, 16,000, 10,000, 10,000) rows of x_conv2-4
    and out, 16,000 at the input and x_conv1."""
    net = VoxelBackbone8x((41, 1600, 1408))
    convs = [tuple(m.taps().shape) for _, m in net.named_modules()
             if isinstance(m, SparseConv3d)]
    caps = [16000, 16000, 24000, 24000, 24000, 16000, 16000, 16000, 10000,
            10000, 10000, 10000]
    return [(*c, m) for c, m in zip(convs, caps)]


CONVS = _backbone_convs()


def test_backbone_convs_include_the_3_tap_conv():
    assert len(CONVS) == 12
    assert (3, 64, 128, 10000) in CONVS


@pytest.mark.parametrize("k,c,co,m", CONVS)
def test_k7_tile_plan_at_backbone_shapes(k, c, co, m):
    """At the backbone's channel counts (multiples of 4) K7 needs no pad
    and takes K1's tile rows: a multiple of 32 up to 128 within 227 KB,
    128 only where three blocks share an SM, and at least one block per
    SM at the student's B=8."""
    feats = torch.zeros(8, 4, c)
    w = torch.zeros(k, c, co)
    assert not gather_conv.needs_pad(feats, w)
    rows = gather_conv.k7_tile_rows(k, c, co)
    assert rows == wkc.tile_rows(k, c, co)
    assert rows in wkc.TILE_ROWS
    assert wkc.tile_smem_bytes(rows, k, c, co) <= wkc.MAX_SMEM
    fits3 = 3 * (wkc.tile_smem_bytes(128, k, c, co) + 1024) <= wkc.SM_SMEM
    assert (rows == 128) == fits3
    assert m * 8 // rows >= 132


@pytest.mark.parametrize("c,co", [(1, 1), (3, 5), (6, 10), (13, 128),
                                  (64, 6), (63, 127), (4, 16)])
def test_k7_pads_channels_off_the_vector_width(c, co):
    """C or Co off the tile's 4-wide vectors: the wrapper pads both into
    (B, N, C4) and (K, C4, Co4) scratch (zero channels and weights), and
    the tile at those widths fits; at the limits C4 * Co4 stays within
    the 8,192 floats a weight tap may have."""
    feats, w = torch.zeros(2, 7, c), torch.zeros(27, c, co)
    assert gather_conv.needs_pad(feats, w) == bool(c % 4 or co % 4)
    (b, n, c4f), (k, c4, co4) = key_conv.rounded_shapes(2, 7, 27, c, co)
    assert (b, n, c4f, k) == (2, 7, c4, 27)
    assert c4 % 4 == 0 and co4 % 4 == 0
    assert 0 <= c4 - c < 4 and 0 <= co4 - co < 4
    assert c4 * co4 <= gather_conv.MAX_W
    rows = gather_conv.k7_tile_rows(27, c, co)
    assert rows == wkc.tile_rows(27, c4, co4)
    assert wkc.tile_smem_bytes(rows, 27, c4, co4) <= wkc.MAX_SMEM


def test_k7_pads_data_off_16_bytes():
    """A contiguous view that starts 4 bytes past 16 goes through the
    padded copy too (the tile's cp.async copies 16-byte vectors)."""
    buf = torch.zeros(2 * 7 * 16 + 1)
    assert buf.data_ptr() % 16 == 0  # PyTorch aligns its allocations
    w = torch.zeros(27, 16, 32)
    assert not gather_conv.needs_pad(buf[:-1].view(2, 7, 16), w)
    feats = buf[1:].view(2, 7, 16)
    assert feats.is_contiguous() and gather_conv.needs_pad(feats, w)
    assert gather_conv.needs_pad(buf[:-1].view(2, 7, 16),
                                 torch.zeros(27 * 16 * 32 + 2)[2:].view(
                                     27, 16, 32))


def conv_case(kind, c, co, seed=3):
    """B=3 sorted key tables with uneven counts (400 / 230 / 9 valid of
    400), one conv geometry (submanifold, stride 2, or (3, 1, 1) stride
    (2, 1, 1)), and seeded features, weights and cotangent: (keys, nkeys,
    feats, w, dout) with numpy float32 arrays."""
    g = torch.Generator().manual_seed(seed)
    n = 400
    keys = []
    for n_valid in (400, 230, 9):
        kk = torch.sort(torch.randperm(BAND - 1, generator=g)[:n_valid]
                        ).values.to(torch.int32)
        keys.append(torch.cat([kk, torch.full(
            (n - n_valid,), voxelize.INVALID_KEY, dtype=torch.int32)]))
    keys = torch.stack(keys)
    if kind == "subm":
        nkeys = spconv.subm_neighbor_keys(keys, SHAPE)
    else:
        kernel, stride, pad = (((3, 3, 3), (2, 2, 2), (1, 1, 1))
                               if kind == "stride2"
                               else ((3, 1, 1), (2, 1, 1), (0, 0, 0)))
        shape_out = spconv.output_spatial_shape(SHAPE, kernel, stride, pad)
        out_keys, _ = spconv.downsample_keys_batched(
            keys, SHAPE, shape_out, kernel, stride, pad, 300)
        nkeys = spconv.sparse_neighbor_keys(out_keys, SHAPE, shape_out,
                                            kernel, stride, pad)
    rng = np.random.RandomState(seed)
    b, m, k = nkeys.shape
    feats = rng.randn(b, n, c).astype(np.float32)
    w = (rng.randn(k, c, co) / np.sqrt(k * c)).astype(np.float32)
    dout = rng.randn(b, m, co).astype(np.float32)
    return keys, nkeys.contiguous(), feats, w, dout


def _jax_scatter(dout, keys, nkeys):
    """JAX's ``_key_scatter_all_taps`` (its Pallas kernel, interpret mode
    off the TPU) on the samples flattened into bands, as its key conv
    does: (K, B * N, Co)."""
    b, n = keys.shape
    m, k = nkeys.shape[1:]
    off = (np.arange(b, dtype=np.int64) * BAND)[:, None]
    kn, nn = keys.numpy().astype(np.int64), nkeys.numpy().astype(np.int64)
    inv = voxelize.INVALID_KEY
    keys_f = np.where(kn == inv, inv, kn + off).reshape(-1)
    nk_f = np.where(nn == inv, inv, nn + off[:, :, None]).reshape(b * m, k)
    return np.asarray(jkey._key_scatter_all_taps(
        jnp.asarray(dout.reshape(b * m, -1)),
        jnp.asarray(keys_f.astype(np.int32)),
        jnp.asarray(nk_f.astype(np.int32)), b * n))


@pytest.mark.parametrize("kind,co", [("subm", 16), ("stride2", 32),
                                     ("z3", 8)])
def test_rulebook_scatter_twin_matches_jax(kind, co):
    """S from the rulebook (the backward kernel's own signature) equals S
    from the keys and JAX's S exactly; rulebook entries outside [0, N)
    count as none, as in the kernel."""
    keys, nkeys, _, _, dout = conv_case(kind, 4, co)
    n = keys.shape[1]
    rb = spconv.rulebook_batched(keys, nkeys)
    assert (rb >= 0).sum() > nkeys.shape[1]
    dout_t = torch.from_numpy(dout)
    s = key_conv.key_scatter_from_rulebook_plain(dout_t, rb, n)
    assert s.shape == (nkeys.shape[-1], keys.numel(), co)
    assert torch.equal(s, key_conv.key_scatter_plain(dout_t, keys, nkeys))
    np.testing.assert_array_equal(s.numpy(), _jax_scatter(dout, keys, nkeys))
    off = torch.where(rb < 0, n + 5, rb)  # out of range, not -1
    assert torch.equal(key_conv.key_scatter_from_rulebook_plain(
        dout_t, off, n), s)


def test_rulebook_scatter_twin_sums_repeated_writers():
    """A rulebook that gives slots several writers (no conv does; the
    public op's neighbour keys may repeat): S from the rulebook sums every
    writer's bf16 row, from +0 in ascending b * M + m, bit for bit a loop
    in that order (the kernel's), and equals JAX's one-hot S
    (``_key_scatter_all_taps``) within 1e-5 of its largest magnitude,
    here with 200 two-writer slots a sample at tap 4 and one slot of 400
    at tap 22."""
    keys, nkeys, _, _, dout = conv_case("subm", 4, 8)
    nk = nkeys.clone()
    nk[:, 0::2, 4] = keys[:, 0::2]
    nk[:, 1::2, 4] = keys[:, 0::2]
    nk[:, :, 22] = keys[:, 3:4]
    b, n = keys.shape
    rb = spconv.rulebook_batched(keys, nk)
    d = torch.from_numpy(dout)
    s = key_conv.key_scatter_from_rulebook_plain(d, rb, n)
    want = torch.zeros_like(s)
    rows = key_conv._bf16(d)
    for bi, mi, ki in ((rb >= 0).nonzero().tolist()):  # ascending b, m
        want[ki, bi * n + rb[bi, mi, ki]] += rows[bi, mi]
    assert torch.equal(s, want)
    assert int((want != 0).any(-1).sum()) < int((rb >= 0).sum())
    ref = _jax_scatter(dout, keys, nk)
    assert float(np.abs(s.numpy() - ref).max()) <= 1e-5 * float(
        np.abs(ref).max())


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's ``pallas_gather_conv`` body, unjitted, with its
    ``pallas_call`` in interpret mode (off the TPU it refuses to compile,
    and ``fused_gather_conv`` falls back to XLA); nothing is cached."""
    monkeypatch.setattr(jkernel, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    return jkernel.pallas_gather_conv.__wrapped__


@pytest.mark.parametrize("kind", ["subm", "stride2", "z3"])
def test_k7_twin_matches_jax_pallas_kernel(pallas_interpret, kind):
    """K7's twin (the wrapper on CPU tensors) against the TPU kernel
    itself, per sample, at C = 3 and Co = 5 (the channels the card pads):
    within 1e-5 of the reference's largest magnitude."""
    keys, nkeys, feats, w, _ = conv_case(kind, 3, 5)
    rb = spconv.rulebook_batched(keys, nkeys)
    got = gather_conv.gather_conv_batched(torch.from_numpy(feats), rb,
                                          torch.from_numpy(w))
    assert gather_conv.gather_conv_batched.launches == 0
    want = np.stack([np.asarray(pallas_interpret(
        jnp.asarray(feats[i]), jnp.asarray(rb[i].numpy()), jnp.asarray(w),
        tile=64)) for i in range(rb.shape[0])])
    assert got.shape == want.shape == (3, nkeys.shape[1], 5)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
