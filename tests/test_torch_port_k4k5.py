"""The host-side plans of K4 (JV assignment, ``ops/cuda/hungarian``) and of
K5's forward (key-compare conv, ``ops/cuda/key_conv``, on the gather-GEMM
tile of ``ops/cuda/window_key_conv``), the constants
they mirror from ``csrc/hungarian_jv.cu``, ``csrc/key_conv.cu`` and
``csrc/gather_gemm.cuh``, and the plain twins against the JAX package on
the edge cases the redesigned kernels must get right: K4 on ties between
-0.0 and +0.0, negative costs, every row valid and the longest augmenting
paths (JAX's XLA solver and its Pallas kernel in interpret mode); K5 at
C = 4 with Co = 16, C not a multiple of 4 and the 3-tap (3, 1, 1) conv
(JAX's Pallas key conv in interpret mode). Runs on the CPU: the plans are
plain Python and the wrappers take the twins on CPU tensors.
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.ops.pallas import hungarian as jpl  # noqa: E402
from detmatch_tpu.ops.pallas import onehot_key_conv as jkey  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.backbone3d import (  # noqa: E402
    SparseConv3d, VoxelBackbone8x)
from detmatch_tpu_torch.ops import spconv, voxelize  # noqa: E402
from detmatch_tpu_torch.ops.cuda import hungarian, key_conv  # noqa: E402
from detmatch_tpu_torch.ops.cuda import window_key_conv as wkc  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

CSRC = ROOT / "detmatch_tpu_torch" / "csrc"


def _constant(path, name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         path.read_text()).group(1))


def test_constants_match_the_sources():
    jv = CSRC / "hungarian_jv.cu"
    assert _constant(jv, "kMaxK") == hungarian.MAX_K
    assert _constant(jv, "kWarpMaxCols") == hungarian.WARP_MAX_COLS
    assert "return 4 * (k * 32 * cols + 3 * k);" in jv.read_text()
    kc = CSRC / "key_conv.cu"
    assert _constant(kc, "kMaxTaps") == wkc.MAX_TAPS
    assert _constant(kc, "kMaxCin") == wkc.MAX_CIN
    assert _constant(kc, "kMaxCout") == wkc.MAX_COUT
    assert _constant(kc, "kMaxW") == wkc.MAX_W
    text = kc.read_text()
    assert "const int c4 = (c + 3) / 4 * 4;" in text
    assert "const int co4 = (co + 3) / 4 * 4;" in text
    assert "launch_gather_gemm<true>(" in text
    assert _constant(CSRC / "gather_gemm.cuh", "kMaxSmem") == wkc.MAX_SMEM


@pytest.mark.parametrize("k,cols", [(1, 1), (10, 1), (32, 1), (33, 2),
                                    (100, 4), (128, 4), (129, 0),
                                    (1024, 0)])
def test_jv_plan(k, cols):
    """One warp a problem with ceil(K / 32) columns a lane up to K = 128
    (the valid rows' costs at a row stride of 32 * cols floats, then u,
    p and way), one thread a column above (u, p and way); the largest
    warp tile, 67,072 bytes, needs the dynamic shared memory opt-in."""
    plan = hungarian.jv_plan(k)
    assert plan.cols == cols
    if cols:
        assert 32 * (cols - 1) < k <= 32 * cols
        assert plan.smem == 4 * (k * 32 * cols + 3 * k)
        assert plan.smem <= hungarian.jv_plan(128).smem == 67072
    else:
        assert plan.smem == 12 * k


def test_jv_plan_refuses_sizes_outside_the_kernel():
    for k in (0, hungarian.MAX_K + 1):
        with pytest.raises(ValueError, match="K <= 1024"):
            hungarian.jv_plan(k)


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


@pytest.mark.parametrize("k,c,co,m", CONVS)
def test_key_conv_tile_plan_at_backbone_shapes(k, c, co, m):
    """K5's forward takes K1's tile at C and Co up to multiples of 4 (the
    backbone's are already): the rounded-weight scratch, rows a multiple
    of 32 up to 128 within 227 KB, 128 only where three blocks share an
    SM, and at least one block per SM at the student's B=8."""
    f_shape, shape = key_conv.rounded_shapes(8, m, k, c, co)
    assert f_shape == (8, m, c) and shape == (k, c, co)
    rows = wkc.tile_rows(*shape)
    assert rows in wkc.TILE_ROWS
    nbytes = wkc.tile_smem_bytes(rows, *shape)
    assert nbytes <= wkc.MAX_SMEM
    fits3 = 3 * (wkc.tile_smem_bytes(128, *shape) + 1024) <= wkc.SM_SMEM
    assert (rows == 128) == fits3
    assert m * 8 // rows >= 132


@pytest.mark.parametrize("c,co", [(1, 1), (3, 5), (6, 10), (13, 128),
                                  (64, 6), (64, 128)])
def test_key_conv_pads_channels_to_the_tile(c, co):
    """Channel counts off the tile's 4-wide vectors are padded up to them
    (zero channels and weights), and every size the wrapper takes gets a
    tile."""
    (b, n, c4f), (k, c4, co4) = key_conv.rounded_shapes(3, 7, 27, c, co)
    assert (b, n, c4f, k) == (3, 7, c4, 27)
    assert c4 % 4 == 0 and co4 % 4 == 0
    assert 0 <= c4 - c < 4 and 0 <= co4 - co < 4
    assert wkc.tile_smem_bytes(wkc.tile_rows(k, c4, co4), k, c4,
                               co4) <= wkc.MAX_SMEM


def _jv_cases():
    """name -> (cost (B, K, K) float32, row_valid (B, K) bool)."""
    rng = np.random.RandomState(7)
    cases = {}
    # integer costs times +-1: ties between -0.0 and +0.0 and between
    # equal integers everywhere; the second element half its rows
    mag = rng.randint(0, 3, size=(2, 32, 32)).astype(np.float32)
    cost = np.where(rng.rand(2, 32, 32) < 0.5, -mag, mag).astype(np.float32)
    assert (cost == 0).any() and np.signbit(cost[cost == 0]).any()
    rv = np.ones((2, 32), bool)
    rv[1, 16:] = False
    cases["signed_zeros"] = (cost, rv)
    # negative costs, every row of 128 valid, and 100 of 128
    cost = (-np.abs(rng.randn(2, 128, 128)) * 3).astype(np.float32)
    rv = np.ones((2, 128), bool)
    rv[1, 100:] = False
    cases["negative_all_rows"] = (cost, rv)
    # the longest augmenting paths: c[i, j] = i * j, K (K + 1) / 2 steps
    i = np.arange(32, dtype=np.float32)
    cases["chain"] = (np.broadcast_to(i[:, None] * i[None], (2, 32, 32))
                      .copy(), np.ones((2, 32), bool))
    return cases


JV_CASES = _jv_cases()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(JV_CASES))
def test_jv_twin_matches_jax_on_edge_cases(case, impl):
    cost, rv = JV_CASES[case]
    want = np.asarray(jpl.solve_masked_batched(jnp.asarray(cost),
                                               jnp.asarray(rv), impl=impl))
    got = hungarian.solve_masked_plain(torch.from_numpy(cost),
                                       torch.from_numpy(rv))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "chain":
        steps = hungarian.inner_steps(torch.from_numpy(cost),
                                      torch.from_numpy(rv))
        assert steps.tolist() == [32 * 33 // 2] * 2


SHAPE = (6, 24, 20)
BAND = int(np.prod(SHAPE)) + 1


def _key_case(kind, c, co):
    """B=2 sorted key tables (400 and 230 valid of 400) in SHAPE, the
    neighbour keys of a submanifold 3x3x3 or a (3, 1, 1) stride-(2, 1, 1)
    conv, and seeded features and weights."""
    g = torch.Generator().manual_seed(3)
    keys = []
    for n_valid in (400, 230):
        kk = torch.sort(torch.randperm(BAND - 1, generator=g)[:n_valid]
                        ).values.to(torch.int32)
        keys.append(torch.cat([kk, torch.full(
            (400 - n_valid,), voxelize.INVALID_KEY, dtype=torch.int32)]))
    keys = torch.stack(keys)
    if kind == "subm":
        nkeys = spconv.subm_neighbor_keys(keys, SHAPE)
    else:
        kernel, stride, pad = (3, 1, 1), (2, 1, 1), (0, 0, 0)
        shape_out = spconv.output_spatial_shape(SHAPE, kernel, stride, pad)
        out_keys, _ = spconv.downsample_keys_batched(
            keys, SHAPE, shape_out, kernel, stride, pad, 300)
        nkeys = spconv.sparse_neighbor_keys(out_keys, SHAPE, shape_out,
                                            kernel, stride, pad)
    rng = np.random.RandomState(4)
    k = nkeys.shape[-1]
    feats = rng.randn(2, 400, c).astype(np.float32)
    w = (rng.randn(k, c, co) / np.sqrt(k * c)).astype(np.float32)
    return keys, nkeys.contiguous(), feats, w


@pytest.mark.parametrize("kind,c,co", [("subm", 4, 16), ("subm", 6, 10),
                                       ("z3", 64, 128), ("z3", 3, 5)])
def test_key_conv_twin_matches_jax_on_edge_shapes(kind, c, co):
    """The forward's twin against JAX's Pallas key conv: conv_input's
    C = 4, Co = 16; C and Co off the 4-wide vectors; the 3-tap
    z-compressing conv at conv_out's 64 -> 128; within 1e-5 of the
    reference's largest magnitude (exact bf16 products, fp32 sums in
    another order)."""
    keys, nkeys, feats, w = _key_case(kind, c, co)
    want = np.asarray(jkey.key_conv_batched(
        jnp.asarray(feats), jnp.asarray(keys.numpy()),
        jnp.asarray(nkeys.numpy()), jnp.asarray(w), BAND))
    got = key_conv.key_conv_batched(torch.from_numpy(feats), keys, nkeys,
                                    torch.from_numpy(w), BAND)
    assert got.shape == want.shape == (2, nkeys.shape[1], co)
    assert (spconv.rulebook_batched(keys, nkeys) >= 0).any()
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
