"""The host-side plan of K1's kernels (``ops/cuda/window_key_conv``): the
gather-GEMM tile of every backbone conv and of every conv of Part-A2's
UNet, forward and input gradient, fits the H100's shared memory; the backward's pair chunks and workspace; and
the constants the wrapper mirrors from ``csrc/``. Runs on the CPU: the
plan is plain Python, and the kernels read it as launch arguments.
"""
import math
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from detmatch_tpu_torch.models.pvrcnn.backbone3d import (  # noqa: E402
    SparseConv3d, VoxelBackbone8x)
from detmatch_tpu_torch.models.pvrcnn.unet import UNetBackbone  # noqa: E402
from detmatch_tpu_torch.ops.cuda import window_key_conv as wkc  # noqa: E402

CSRC = ROOT / "detmatch_tpu_torch" / "csrc"


def _backbone_convs():
    """(name, K, C, Co) of the backbone's 12 convs at the default widths
    (the SSL and pretrain configs' own)."""
    net = VoxelBackbone8x((41, 1600, 1408))
    return [(name, *m.taps().shape) for name, m in net.named_modules()
            if isinstance(m, SparseConv3d)]


def _unet_convs():
    """("unet.<name>", K, C, Co) of the Part-A2 UNet's 28 convs at the
    default widths."""
    net = UNetBackbone((41, 1600, 1408))
    return [(f"unet.{name}", *m.taps().shape)
            for name, m in net.named_modules()
            if isinstance(m, SparseConv3d)]


CONVS = _backbone_convs()
UNET_CONVS = _unet_convs()


def test_backbone_has_twelve_convs():
    assert len(CONVS) == 12
    assert {(k, c, co) for _, k, c, co in CONVS} == {
        (27, 4, 16), (27, 16, 16), (27, 16, 32), (27, 32, 32), (27, 32, 64),
        (27, 64, 64), (3, 64, 128)}


def test_unet_has_twenty_eight_convs():
    """The encoder's 12, the UR blocks' 12 (their merge convs at 2C in),
    three inverse convs and conv5: C up to 128."""
    assert len(UNET_CONVS) == 28
    assert {(k, c, co) for _, k, c, co in UNET_CONVS} == {
        (27, 4, 16), (27, 16, 16), (27, 16, 32), (27, 32, 32), (27, 32, 64),
        (27, 64, 64), (3, 64, 128), (27, 128, 64), (27, 64, 32),
        (27, 32, 16)}


@pytest.mark.parametrize("name,k,c,co", CONVS + UNET_CONVS,
                         ids=[c[0] for c in CONVS + UNET_CONVS])
def test_tile_fits_shared_memory(name, k, c, co):
    """Forward (Cx = C, Cy = Co) and dF (Cx = Co, Cy = C) tiles: rows a
    multiple of 32 up to 128, at most 227 KB, and 128 rows only where
    three blocks share an SM's 228 KB; the byte count equals its parts."""
    for cx, cy in ((c, co), (co, c)):
        rows = wkc.tile_rows(k, cx, cy)
        assert rows in wkc.TILE_ROWS
        nbytes = wkc.tile_smem_bytes(rows, k, cx, cy)
        parts = (4 * rows * cy                     # accumulators
                 + 2 * 4 * (rows * cx + cx * cy)   # two stages
                 + 4 * rows * k + 4 * 64           # sources, tap tables
                 + 16 * math.ceil(k * rows / 16))  # per-tap row lists
        assert nbytes == parts <= wkc.MAX_SMEM
        if rows == 128:
            assert 3 * (nbytes + 1024) <= wkc.SM_SMEM
        else:
            assert 3 * (wkc.tile_smem_bytes(128, k, cx, cy) + 1024) > (
                wkc.SM_SMEM)
        assert c % 4 == 0 and co % 4 == 0  # the 16-byte copies


@pytest.mark.parametrize("rows,chunks", [
    (0, 1), (1, 1), (wkc.PAIR_CHUNK, 1), (wkc.PAIR_CHUNK + 1, 2),
    (8 * 24000, 94), (8 * 16000, 63), (4 * 10000, 20)])
def test_pair_chunks(rows, chunks):
    """dW partials per tap: a tap has at most one pair per output row, so
    ceil(rows / PAIR_CHUNK) chunks (at least one) hold its list."""
    assert wkc.dw_chunks(rows) == chunks


@pytest.mark.parametrize("need_dfeats", [True, False])
def test_backward_workspace(need_dfeats):
    """Counts and offsets per 256-row chunk and tap, 32 tap starts, the
    pair lists and, for dF only, the inverse map, its repeat flag and the
    repeat pass's row marks."""
    b, n, m, k = 8, 16000, 24000, 27
    n_rc = math.ceil(b * m / 256)
    want = 2 * k * n_rc + 32 + b * m * k + (b * n * k + 1 + b * n
                                            if need_dfeats else 0)
    assert wkc.bwd_workspace(b, n, m, k, need_dfeats) == want
    assert wkc.bwd_workspace(0, n, 0, k, need_dfeats) == 32 + need_dfeats


def _constant(path, name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         path.read_text()).group(1))


def test_constants_match_the_sources():
    """The limits and plan constants the wrapper mirrors: K1's channel
    limits (any C, Co up to 128, C * Co up to 16,384), the counting
    chunk, the shared memory and tile rows."""
    bwd = CSRC / "window_key_conv_bwd.cu"
    gemm = CSRC / "gather_gemm.cuh"
    for const, value in (("kMaxTaps", wkc.MAX_TAPS),
                         ("kMaxCin", wkc.MAX_CIN),
                         ("kMaxCout", wkc.MAX_COUT),
                         ("kMaxW", wkc.MAX_W)):
        assert _constant(bwd, const) == value, const
    assert (wkc.MAX_CIN, wkc.MAX_COUT, wkc.MAX_W) == (128, 128, 16384)
    assert _constant(bwd, "kPairChunk") == wkc.PAIR_CHUNK
    assert _constant(bwd, "kThreads") == wkc.COUNT_ROWS
    assert _constant(gemm, "kMaxSmem") == wkc.MAX_SMEM
    assert _constant(gemm, "kMaxRows") == max(wkc.TILE_ROWS)
    assert _constant(gemm, "kMaxTaps") == wkc.MAX_TAPS


@pytest.mark.parametrize("c,co", [(3, 5), (5, 16), (128, 128), (127, 128),
                                  (1, 1)])
def test_tiles_at_any_channel_count(c, co):
    """Any C and Co within the limits: the forward's and dF's tiles at the
    padded widths (C4, Co4) fit 227 KB (C = Co = 128 at 32 rows, ~185 KB),
    the padded weight tap stays within the limit, and the wrapper pads
    exactly where C or Co is off the 4-wide vectors."""
    c4, co4 = wkc.vec4(c), wkc.vec4(co)
    assert 0 <= c4 - c < 4 and 0 <= co4 - co < 4 and c4 % 4 == co4 % 4 == 0
    assert c4 * co4 <= wkc.MAX_W
    for cx, cy in ((c4, co4), (co4, c4)):
        rows = wkc.tile_rows(27, cx, cy)
        assert wkc.tile_smem_bytes(rows, 27, cx, cy) <= wkc.MAX_SMEM
    if (c, co) == (128, 128):
        assert wkc.tile_rows(27, 128, 128) == 32
        assert 180000 < wkc.tile_smem_bytes(32, 27, 128, 128) < 190000
    feats, w = torch.zeros(2, 7, c), torch.zeros(27, c, co)
    assert wkc.needs_pad(feats, w) == bool(c % 4 or co % 4)
