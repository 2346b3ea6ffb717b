"""The port's CUDA kernels against their plain twins on the card, at edge
cases the main path does not reach (all-invalid rows, empty balls, empty
samples, the size limits, argument checks), the sparse conv's backward
kernel against autograd through its twin, the JV assignment kernel (K4)
at sizes and validity patterns the teacher phase does not give it, and
the key-compare conv (K5) forward and backward against their twins, the
rulebook gather-GEMM (K7) and K6's forward (bf16 tensor cores, bit-equal
over two launches), K6's backward scatter and K8's row gather (exactly,
at any width and alignment) and scatter-add against theirs. K1's and
K5's backward sum repeated writers of a slot as JAX does, and K1, K5 and
K7 take any C and Co up to 128. K5's backward, on the
rulebook its forward writes, is held to the twin exactly and to itself
over two launches at the 12 backbone shapes. K7 is held bit-equal to
K1's forward, at channel counts and alignments it pads for too.
K1's forward is held bit-equal to K7 (dense, sparse and pad-only tiles),
the rulebook it writes to the plain one, and its backward, which reads
that rulebook, to itself over two launches. K2 (ball query) and K3 (FPS)
give their twins' integers at the main path's shapes (the VSA and RoI-grid
calls at every group width, FPS at B = 1, 4, 8), around a cluster's
capacity, with ties across a cluster's CTAs and with clustered centers.

Needs a CUDA card: every test is marked ``cuda`` and skips without one.
This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from detmatch_tpu_torch.ops import cuda as cuda_ops  # noqa: E402
from detmatch_tpu_torch.ops import spconv, voxelize  # noqa: E402
from detmatch_tpu_torch.ops.cuda import ball_query, fps  # noqa: E402
from detmatch_tpu_torch.ops.cuda import gather_conv  # noqa: E402
from detmatch_tpu_torch.ops.cuda import hungarian, key_conv  # noqa: E402
from detmatch_tpu_torch.ops.cuda import onehot_gather  # noqa: E402
from detmatch_tpu_torch.ops.cuda import onehot_rows  # noqa: E402
from detmatch_tpu_torch.ops.cuda import window_key_conv  # noqa: E402
from detmatch_tpu_torch.utils.synth_kitti import (  # noqa: E402
    SSL_PCR, lidar_batch)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: see the README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(dev, b, n, seed):
    g = torch.Generator().manual_seed(seed)
    xyz = (torch.rand(b, n, 3, generator=g) * torch.tensor([40., 60., 3.])
           - torch.tensor([0., 30., 2.]))
    return xyz.to(dev)


@pytest.mark.parametrize("n,k", [(1000, 64), (fps.MAX_POINTS, 256),
                                 (3000, 2048)])
def test_fps_kernel_matches_twin(dev, n, k):
    """Odd sizes, the kernel's point limit, and more samples than valid
    points (selection repeats); one short row and one all-invalid row."""
    xyz = _cloud(dev, 3, n, 0)
    valid = torch.ones(3, n, dtype=torch.bool, device=dev)
    valid[1, n // 3:] = False
    valid[2] = False
    out = fps.fps_batched(xyz, valid, k)
    assert torch.equal(out, fps.fps_plain(xyz, valid, k))
    assert (out[2] == 0).all()


@pytest.mark.parametrize("radius,nsample", [(0.4, 16), (1.6, 4), (6.0, 32)])
def test_ball_query_kernel_matches_twin(dev, radius, nsample):
    """Overflowing balls, empty balls, invalid centers and points."""
    pts = _cloud(dev, 3, 5000, 1)
    pv = torch.ones(3, 5000, dtype=torch.bool, device=dev)
    pv[1, 2000:] = False
    pv[2, ::3] = False
    cen = pts[:, :700].clone()
    cen[:, :50] += 200.0  # far from every point
    cv = torch.ones(3, 700, dtype=torch.bool, device=dev)
    cv[:, 600:] = False
    ki, kc = ball_query.ball_query_batched(cen, cv, pts, pv, radius, nsample)
    pi, pc = ball_query.ball_query_plain(cen, cv, pts, pv, radius, nsample)
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    assert (kc[:, :50] == 0).all() and (kc[:, 600:] == 0).all()


def _lidar(dev, b, n, seed):
    """Synthetic KITTI frames (the main path's kind of cloud)."""
    pts, valid = lidar_batch(np.random.RandomState(seed), b, n, SSL_PCR)
    return (torch.from_numpy(pts[..., :3].copy()).to(dev),
            torch.from_numpy(valid).to(dev))


@pytest.mark.parametrize("b", [1, 4, 8])
@pytest.mark.parametrize("n", [16384, 18000])
def test_fps_kernel_at_main_path_shapes(dev, b, n):
    """2,048 samples of B frames, as the VSA draws them (plan: one
    cluster of ``fps_plan(b, n).cluster`` CTAs a frame)."""
    xyz, valid = _lidar(dev, b, n, b)
    out = fps.fps_batched(xyz, valid, 2048)
    assert torch.equal(out, fps.fps_plain(xyz, valid, 2048))


def _capacity_edges():
    plan = fps.fps_plan(1, 18000)
    threads = plan.cluster * fps.CTA_THREADS
    cap = threads * plan.per_thread
    return [cap - 1, cap, cap + 1, fps.MAX_POINTS - 1, fps.MAX_POINTS, 33,
            threads + 1]


@pytest.mark.parametrize("n", _capacity_edges())
def test_fps_kernel_around_a_clusters_capacity(dev, n):
    """N one less, equal to and one more than a cluster's capacity (lanes
    that own no point, a thread's last point half empty), the kernel's
    limit, and small N where whole CTAs own nothing; a row with fewer
    valid points than samples and an all-invalid row."""
    xyz = _cloud(dev, 3, n, n)
    valid = torch.ones(3, n, dtype=torch.bool, device=dev)
    valid[1, n // 2:] = False
    valid[1, :3] = False
    valid[2] = False
    k = min(300, n + 20)
    out = fps.fps_batched(xyz, valid, k)
    assert torch.equal(out, fps.fps_plain(xyz, valid, k))
    assert (out[2] == 0).all()


@pytest.mark.parametrize("pattern", ["duplicates", "all_equal", "grid"])
def test_fps_kernel_breaks_ties_across_ctas(dev, pattern):
    """Equal distances held by points in different CTAs of a cluster:
    duplicated coordinates far apart in the table, every point the same
    (all distances 0 after the first pick), and an integer grid (many
    exactly equal squared distances); 2,048 samples over 18,000 points,
    more samples than distinct points in the last two."""
    b, n = 2, 18000
    g = torch.Generator().manual_seed(7)
    if pattern == "duplicates":
        xyz = torch.rand(b, n, 3, generator=g) * 50
        src = torch.randint(0, n, (4000,), generator=g)
        dst = torch.randint(0, n, (4000,), generator=g)
        xyz[:, dst] = xyz[:, src]
    elif pattern == "all_equal":
        xyz = torch.full((b, n, 3), 1.5)
    else:
        xyz = torch.randint(0, 12, (b, n, 3), generator=g).float()
    xyz, valid = xyz.to(dev), torch.ones(b, n, dtype=torch.bool,
                                         device=dev)
    valid[1, ::5] = False
    out = fps.fps_batched(xyz, valid, 2048)
    assert torch.equal(out, fps.fps_plain(xyz, valid, 2048))


def _ball_edges(pts, pv, cen, cv):
    """Edge cases written into a table and its centers in place: a point
    at exactly d2 == r2 (0.5 m) from center 0, runs of equal y, and
    invalid rows sitting on centers 1-3."""
    cen[:, 0] = torch.tensor([20.0, 5.0, -1.0])
    pts[:, 0] = torch.tensor([20.5, 5.0, -1.0])
    pts[:, 1:400:3, 1] = 2.0
    n = pts.shape[1]
    pv[:, n - 40:] = False
    pts[:, n - 3:] = cen[:, 1:4]
    cv[:, -7:] = False


@pytest.mark.parametrize("radius,nsample", [(0.5, 16), (0.8, 16), (2.4, 32),
                                            (4.8, 5)])
def test_ball_query_kernel_at_vsa_shape(dev, radius, nsample):
    """B=8 frames of 18,000 points, 2,048 centers drawn from them (the
    VSA's raw-point call), with the edge cases of ``_ball_edges``:
    windows of hundreds of positions, nsample reached mid-step. Every G
    the kernel is built for gives the twin's integers."""
    pts, pv = _lidar(dev, 8, 18000, 11)
    cen = pts[:, :2048].clone()
    cv = pv[:, :2048].clone()
    _ball_edges(pts, pv, cen, cv)
    pi, pc = ball_query.ball_query_plain(cen, cv, pts, pv, radius, nsample)
    ki, kc = ball_query.ball_query_batched(cen, cv, pts, pv, radius, nsample)
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    table = ball_query.pack_table(*ball_query.sort_points_by_y(pts, pv))
    for group in ball_query.GROUP_LANES:
        gi, gc = ball_query.ball_query_launch(cen, cv, table, radius,
                                              nsample, group)
        assert torch.equal(gi, pi) and torch.equal(gc, pc), group
    if radius == 0.5:
        assert int(kc[0, 0]) >= 1 and bool((ki[:, 0] == 0).any())


@pytest.mark.parametrize("radius", [0.8, 6.0])
def test_ball_query_kernel_clustered_centers(dev, radius):
    """Runs of 50 nearby centers (overlapping windows, as on the RoI
    grid) in 700 a sample, so that blocks hold centers of two samples at
    every G; empty balls, invalid centers and points; windows of over a
    thousand positions at r = 6 m. Every G gives the twin's integers."""
    pts = _cloud(dev, 3, 5000, 5)
    pv = torch.ones(3, 5000, dtype=torch.bool, device=dev)
    pv[1, 2000:] = False
    pv[2, ::3] = False
    g = torch.Generator(device=dev).manual_seed(5)
    seeds = pts[:, torch.randint(0, 5000, (14,), generator=g, device=dev)]
    offs = torch.rand(3, 14, 50, 3, generator=g, device=dev) * 2 - 1
    cen = (seeds[:, :, None] + offs).reshape(3, 700, 3).contiguous()
    cen[:, 100:150] += 200.0  # far from every point
    cv = torch.ones(3, 700, dtype=torch.bool, device=dev)
    cv[:, 650:] = False
    pi, pc = ball_query.ball_query_plain(cen, cv, pts, pv, radius, 16)
    table = ball_query.pack_table(*ball_query.sort_points_by_y(pts, pv))
    for group in ball_query.GROUP_LANES:
        gi, gc = ball_query.ball_query_launch(cen, cv, table, radius, 16,
                                              group)
        assert torch.equal(gi, pi) and torch.equal(gc, pc), group
    assert (pc[:, 100:150] == 0).all() and (pc[:, :100] > 0).any()


@pytest.mark.parametrize("radius", [0.8, 1.6])
def test_ball_query_kernel_at_roi_grid_shape(dev, radius):
    """The student's RoI-grid call: B=8, 128 RoIs x 216 grid points =
    27,648 centers over 2,048 keypoints, with the edge cases of
    ``_ball_edges``, at every G the kernel is built for."""
    kp, kv = _lidar(dev, 8, 2048, 12)
    g = torch.Generator(device=dev).manual_seed(12)
    roi = kp[:, torch.randint(0, 2048, (128,), generator=g, device=dev)]
    offs = torch.rand(8, 128, 216, 3, generator=g, device=dev) * 3 - 1.5
    cen = (roi[:, :, None] + offs).reshape(8, 27648, 3).contiguous()
    cv = torch.ones(8, 27648, dtype=torch.bool, device=dev)
    _ball_edges(kp, kv, cen, cv)
    pi, pc = ball_query.ball_query_plain(cen, cv, kp, kv, radius, 16)
    ki, kc = ball_query.ball_query_batched(cen, cv, kp, kv, radius, 16)
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    table = ball_query.pack_table(*ball_query.sort_points_by_y(kp, kv))
    for group in ball_query.GROUP_LANES:
        gi, gc = ball_query.ball_query_launch(cen, cv, table, radius, 16,
                                              group)
        assert torch.equal(gi, pi) and torch.equal(gc, pc), group


@pytest.mark.parametrize("k,c,co", [(27, 4, 16), (27, 64, 64), (3, 64, 128)])
def test_window_key_conv_kernel_matches_twin(dev, k, c, co):
    """B=3 with uneven voxel counts (the flattened-table case the TPU
    kernel's window search gets wrong), all tap geometries' widths."""
    g = torch.Generator().manual_seed(2)
    shape = (41, 200, 176)
    keys = []
    for n_valid in (3000, 1200, 0):
        kk = torch.randperm(41 * 200 * 176, generator=g)[:n_valid]
        kk = torch.sort(kk).values.to(torch.int32)
        pad = torch.full((3000 - n_valid,), voxelize.INVALID_KEY,
                         dtype=torch.int32)
        keys.append(torch.cat([kk, pad]))
    keys = torch.stack(keys).to(dev)
    nk = spconv.subm_neighbor_keys(keys, shape)
    nk = nk[..., :k].contiguous() if k == 3 else nk
    feats = torch.randn(3, 3000, c, generator=g).to(dev)
    w = torch.randn(k, c, co, generator=g).to(dev)
    band = 41 * 200 * 176 + 1
    out = window_key_conv.window_key_conv_batched(feats, keys, nk, keys, w,
                                                  band)
    ref = window_key_conv.window_key_conv_plain(feats, keys, nk, keys, w,
                                                band)
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err
    assert not out[2].any()


def _dense_case(dev, c, co, b=2):
    """A solid 8 x 12 x 12 block of voxels per sample (every subm tap of an
    inner voxel matches), the second sample shifted, and 500 pad rows."""
    g = torch.Generator().manual_seed(5)
    shape = (41, 200, 176)
    z, y, x = torch.meshgrid(torch.arange(8), torch.arange(12),
                             torch.arange(12), indexing="ij")
    coords = torch.stack([z, y, x], -1).reshape(-1, 3).to(torch.int32)
    keys = []
    for i in range(b):
        kk = voxelize.linearize(coords + torch.tensor([i, 3 * i, 5 * i],
                                                      dtype=torch.int32),
                                shape)
        pad = torch.full((500,), voxelize.INVALID_KEY, dtype=torch.int32)
        keys.append(torch.cat([torch.sort(kk.to(torch.int32)).values, pad]))
    keys = torch.stack(keys).to(dev)
    nk = spconv.subm_neighbor_keys(keys, shape).contiguous()
    feats = torch.randn(b, keys.shape[1], c, generator=g).to(dev)
    w = torch.randn(27, c, co, generator=g).to(dev)
    return feats, keys, nk, w, 41 * 200 * 176 + 1


def _sparse_case(dev, k, c, co):
    """The B=3 uneven-count subm case of the twin test (3,000 / 1,200 /
    0 voxels), its first ``k`` taps."""
    g = torch.Generator().manual_seed(2)
    shape = (41, 200, 176)
    keys = []
    for n_valid in (3000, 1200, 0):
        kk = torch.randperm(41 * 200 * 176, generator=g)[:n_valid]
        kk = torch.sort(kk).values.to(torch.int32)
        pad = torch.full((3000 - n_valid,), voxelize.INVALID_KEY,
                         dtype=torch.int32)
        keys.append(torch.cat([kk, pad]))
    keys = torch.stack(keys).to(dev)
    nk = spconv.subm_neighbor_keys(keys, shape)[..., :k].contiguous()
    feats = torch.randn(3, 3000, c, generator=g).to(dev)
    w = torch.randn(k, c, co, generator=g).to(dev)
    return feats, keys, nk, w, 41 * 200 * 176 + 1


def _k1_case(dev, kind, k, c, co):
    """"dense": _dense_case; "sparse": _sparse_case, whose third sample
    has no voxel, so its 3,000 rows make whole tiles of pad rows."""
    if kind == "dense":
        return _dense_case(dev, c, co)
    return _sparse_case(dev, k, c, co)


@pytest.mark.parametrize("kind,k,c,co", [
    ("dense", 27, 4, 16), ("dense", 27, 64, 128), ("sparse", 27, 4, 16),
    ("sparse", 27, 64, 64), ("sparse", 3, 64, 128), ("sparse", 27, 16, 32)])
def test_window_key_conv_is_bit_equal_to_k7(dev, kind, k, c, co):
    """K1's forward skips the taps without an input row and keeps K7's
    order of the sums (taps, then channels, ascending, fmaf from +0), so
    it is bit-equal to K7 on the plain rulebook; the rulebook it writes
    for the backward is that rulebook, and writing it changes no bit."""
    feats, keys, nk, w, band = _k1_case(dev, kind, k, c, co)
    rb_plain = spconv.rulebook_batched(keys, nk)
    out, rb = window_key_conv.window_key_conv_fwd(feats, keys, nk, keys, w,
                                                  band, rulebook=True)
    again, none = window_key_conv.window_key_conv_fwd(feats, keys, nk, keys,
                                                      w, band)
    k7 = gather_conv.gather_conv_batched(feats, rb_plain, w)
    torch.cuda.synchronize()
    assert none is None
    assert torch.equal(rb, rb_plain)
    assert torch.equal(out, k7) and torch.equal(again, k7)
    if kind == "dense":  # inner voxels match all 27 taps
        assert int((rb_plain >= 0).all(-1).sum()) > 0
    else:  # the tiles of the empty sample: pad rows only, zeros out
        assert not (rb_plain[2] >= 0).any() and not out[2].any()


def _conv_case(dev, kind, c, co):
    """Keys, neighbour keys and output keys of one conv geometry at B=3
    with uneven voxel counts (3,000 / 1,200 / 0)."""
    g = torch.Generator().manual_seed(3)
    shape = (41, 200, 176)
    n = 3000
    keys = []
    for n_valid in (n, 1200, 0):
        kk = torch.randperm(41 * 200 * 176, generator=g)[:n_valid]
        kk = torch.sort(kk).values.to(torch.int32)
        pad = torch.full((n - n_valid,), voxelize.INVALID_KEY,
                         dtype=torch.int32)
        keys.append(torch.cat([kk, pad]))
    keys = torch.stack(keys).to(dev)
    if kind == "subm":
        nk, out_keys = spconv.subm_neighbor_keys(keys, shape), keys
    else:
        kernel, stride, pad = (((3, 3, 3), (2, 2, 2), (1, 1, 1))
                               if kind == "stride2"
                               else ((3, 1, 1), (2, 1, 1), (0, 0, 0)))
        shape_out = spconv.output_spatial_shape(shape, kernel, stride, pad)
        out_keys, _ = spconv.downsample_keys_batched(
            keys, shape, shape_out, kernel, stride, pad, 2500)
        nk = spconv.sparse_neighbor_keys(out_keys, shape, shape_out, kernel,
                                         stride, pad)
    feats = torch.randn(3, n, c, generator=g).to(dev)
    w = torch.randn(nk.shape[-1], c, co, generator=g).to(dev)
    dout = torch.randn(3, nk.shape[1], co, generator=g).to(dev)
    return feats, keys, nk.contiguous(), out_keys, w, dout, 41 * 200 * 176 + 1


def _grads(fn, feats, keys, nk, out_keys, w, dout, band, need_dfeats):
    feats = feats.clone().requires_grad_(need_dfeats)
    w = w.clone().requires_grad_(True)
    out = fn(feats, keys, nk, out_keys, w, band)
    wrt = (feats, w) if need_dfeats else (w,)
    return torch.autograd.grad(out, wrt, dout)


@pytest.mark.parametrize("kind,c,co,need_dfeats", [
    ("subm", 16, 16, True), ("subm", 64, 128, True),
    ("stride2", 32, 64, True), ("stride2", 64, 128, False),
    ("z3", 64, 128, True), ("z3", 4, 16, False)])
def test_window_key_conv_backward_matches_twin(dev, kind, c, co,
                                               need_dfeats):
    """dF and dW of the kernel path against autograd through the plain
    twin: submanifold, stride-2 and (3,1,1) convs, C * Co up to the
    8,192 limit, an empty sample, and the input gradient skipped."""
    case = _conv_case(dev, kind, c, co)
    window_key_conv.window_key_conv_bwd.launches = 0
    got = _grads(window_key_conv.window_key_conv_batched, *case,
                 need_dfeats)
    torch.cuda.synchronize()
    assert window_key_conv.window_key_conv_bwd.launches == 1
    ref = _grads(window_key_conv.window_key_conv_plain, *case, need_dfeats)
    for a, r in zip(got, ref):
        err = float((a - r).abs().max() / r.abs().max())
        assert err <= 1e-5, err
    if need_dfeats:
        assert not got[0][2].any()  # the empty sample


@pytest.mark.parametrize("kind,c,co,need_dfeats", [
    ("dense", 4, 16, True), ("dense", 64, 128, True), ("subm", 16, 16, True),
    ("stride2", 32, 64, True), ("z3", 64, 128, False)])
def test_window_key_conv_backward_reads_the_forward_rulebook(dev, kind, c,
                                                             co, need_dfeats):
    """The backward takes the rulebook the forward wrote (equal to the
    plain one), gives the same bits over two launches (fixed orders, no
    float atomics), and matches the twin's gradients within 1e-5."""
    if kind == "dense":
        feats, keys, nk, w, band = _dense_case(dev, c, co)
        out_keys = keys
        g = torch.Generator().manual_seed(6)
        dout = torch.randn(*nk.shape[:2], co, generator=g).to(dev)
    else:
        feats, keys, nk, out_keys, w, dout, band = _conv_case(dev, kind, c,
                                                              co)
    _, rb = window_key_conv.window_key_conv_fwd(feats, keys, nk, out_keys, w,
                                                band, rulebook=True)
    assert torch.equal(rb, spconv.rulebook_batched(keys, nk))
    first = window_key_conv.window_key_conv_bwd(dout, feats, rb, w,
                                                need_dfeats)
    second = window_key_conv.window_key_conv_bwd(dout, feats, rb, w,
                                                 need_dfeats)
    ref = _grads(window_key_conv.window_key_conv_plain, feats, keys, nk,
                 out_keys, w, dout, band, need_dfeats)
    torch.cuda.synchronize()
    got = [t for t in first if t is not None]
    assert len(got) == len(ref) == (2 if need_dfeats else 1)
    for a, a2 in zip(first, second):
        assert (a is None and a2 is None) or torch.equal(a, a2)
    for a, r in zip(got, ref):
        err = float((a - r).abs().max() / r.abs().max())
        assert err <= 1e-5, err


def test_wrappers_check_their_arguments(dev):
    xyz = _cloud(dev, 1, 100, 3)
    valid = torch.ones(1, 100, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        fps.fps_batched(xyz, valid.cpu(), 8)  # devices differ
    with pytest.raises(TypeError):
        fps.fps_batched(xyz.double(), valid, 8)
    with pytest.raises(ValueError):
        fps.fps_batched(_cloud(dev, 1, fps.MAX_POINTS + 1, 4),
                        torch.ones(1, fps.MAX_POINTS + 1, dtype=torch.bool,
                                   device=dev), 8)
    keys = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    nkeys = torch.zeros(1, 4, 27, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # C = 129 above the kernel's limit
        window_key_conv.window_key_conv_batched(
            torch.zeros(1, 4, 129, device=dev), keys, nkeys, keys,
            torch.zeros(27, 129, 8, device=dev), 100)
    with pytest.raises(ValueError):  # Co = 129 above it
        window_key_conv.window_key_conv_batched(
            torch.zeros(1, 4, 8, device=dev), keys, nkeys, keys,
            torch.zeros(27, 8, 129, device=dev), 100)
    # C = 6 (off the 4-wide vectors) and data 4 bytes off 16: padded
    shifted = torch.zeros(25, device=dev)[1:].view(1, 4, 6)
    out = window_key_conv.window_key_conv_batched(
        shifted, keys, nkeys, keys, torch.zeros(27, 6, 8, device=dev), 100)
    assert out.shape == (1, 4, 8) and not out.any()
    rb = torch.zeros(1, 4, 27, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # dout of the wrong shape
        window_key_conv.window_key_conv_bwd(
            torch.zeros(1, 3, 8, device=dev), torch.zeros(1, 4, 4,
                                                          device=dev),
            rb, torch.zeros(27, 4, 8, device=dev))
    with pytest.raises(TypeError):  # a rulebook that is not int32
        window_key_conv.window_key_conv_bwd(
            torch.zeros(1, 4, 8, device=dev), torch.zeros(1, 4, 4,
                                                          device=dev),
            rb.long(), torch.zeros(27, 4, 8, device=dev))


def _jv_problem(b, k, n_rows, n_cols, seed):
    """(B, K, K) costs with BIG-padded columns past ``n_cols`` and the
    first ``n_rows`` rows valid, per element; tie rows where K allows."""
    g = torch.Generator().manual_seed(seed)
    cost = torch.randn(b, k, k, generator=g) * 2
    if k > 4:
        cost[:, 3] = cost[:, 1]
    cols = torch.arange(k)
    cost = torch.where(cols[None, None, :] < torch.tensor(n_cols)[:, None,
                                                                  None],
                       cost, hungarian.BIG).contiguous()
    rv = cols[None, :] < torch.tensor(n_rows)[:, None]
    return cost, rv


@pytest.mark.parametrize("b,k,n_rows,n_cols", [
    (1, 1, [1], [1]),                       # K = 1
    (1, hungarian.MAX_K, [700], [1000]),    # the largest K, padded cols
    (1, 128, [128], [128]),                 # B = 1, full
    (3, 128, [0, 0, 0], [128, 5, 0]),       # every row invalid
    (4, 100, [100, 40, 1, 0], [100, 70, 3, 100]),  # K not a warp multiple
    (2, 33, [33, 20], [33, 33]),            # one column past a warp
])
def test_hungarian_kernel_matches_twin(dev, b, k, n_rows, n_cols):
    """Exact equality with the plain twin (run on the CPU: the same fp32
    operations, fewer launches)."""
    cost, rv = _jv_problem(b, k, n_rows, n_cols, seed=k)
    hungarian.solve_masked_batched.launches = 0
    got = hungarian.solve_masked_batched(cost.to(dev), rv.to(dev))
    torch.cuda.synchronize()
    assert hungarian.solve_masked_batched.launches == 1
    want = hungarian.solve_masked_plain(cost, rv)
    assert torch.equal(got.cpu(), want)
    matched = (want >= 0).sum(1)
    assert matched.tolist() == [min(r, c) for r, c in zip(n_rows, n_cols)]


def _jv_signed_zeros(b, k, seed):
    """Small integer costs times +-1, so that many entries are -0.0 or
    +0.0 and the argmin ties between zeros of either sign (and between
    equal integers); rows in order of validity as ``_jv_problem``."""
    g = torch.Generator().manual_seed(seed)
    mag = torch.randint(0, 3, (b, k, k), generator=g).float()
    sign = torch.where(torch.rand(b, k, k, generator=g) < 0.5, -1.0, 1.0)
    cost = (mag * sign).contiguous()
    assert bool((cost == 0).any() & torch.signbit(cost).any())
    return cost


@pytest.mark.parametrize("case", [
    "signed_zeros_k128", "signed_zeros_k33", "k32", "k33", "k129",
    "chain_k32", "chain_k128", "empty_beside_full"])
def test_hungarian_kernel_edge_cases(dev, case):
    """K4's warp design at one column a lane (K = 32), one past a warp
    (33) and four a lane (128), the block design past 128 (129): -0.0 /
    +0.0 ties (the order key must tie them so that the lower column
    wins), the longest augmenting paths (c[i, j] = i * j: K (K + 1) / 2
    inner steps), and problems with no valid row beside full ones. Exact
    equality with the twin (run on the CPU)."""
    k = int(case.rsplit("k", 1)[1]) if case[-1].isdigit() else 128
    if case.startswith("signed_zeros"):
        cost = _jv_signed_zeros(3, k, seed=k)
        rv = torch.ones(3, k, dtype=torch.bool)
        rv[1, k // 2:] = False
    elif case.startswith("chain"):
        i = torch.arange(k, dtype=torch.float32)
        cost = (i[:, None] * i[None]).expand(2, k, k).contiguous()
        rv = torch.ones(2, k, dtype=torch.bool)
        assert hungarian.inner_steps(cost, rv).tolist() == [
            k * (k + 1) // 2] * 2
    elif case == "empty_beside_full":
        cost, rv = _jv_problem(4, 128, [0, 128, 0, 128], [128] * 4, seed=3)
    else:
        cost, rv = _jv_problem(3, k, [k, k // 2, 1], [k, k, k // 3 + 1],
                               seed=k)
    k = cost.shape[-1]
    assert hungarian.jv_plan(k).cols == (0 if k > 128 else -(-k // 32))
    got = hungarian.solve_masked_batched(cost.to(dev), rv.to(dev))
    torch.cuda.synchronize()
    want = hungarian.solve_masked_plain(cost, rv)
    assert torch.equal(got.cpu(), want)
    assert (want[~rv.any(1)] == -1).all()


def test_hungarian_kernel_checks_its_arguments(dev):
    cost, rv = _jv_problem(2, 16, [16, 8], [16, 16], seed=0)
    cost, rv = cost.to(dev), rv.to(dev)
    k = hungarian.MAX_K + 1
    with pytest.raises(ValueError, match="K <= 1024"):
        hungarian.solve_masked_batched(
            torch.zeros(1, k, k, device=dev),
            torch.ones(1, k, dtype=torch.bool, device=dev))
    with pytest.raises(TypeError):
        hungarian.solve_masked_batched(cost.double(), rv)
    with pytest.raises(TypeError):
        hungarian.solve_masked_batched(cost, rv.int())
    with pytest.raises(ValueError):  # devices differ
        hungarian.solve_masked_batched(cost, rv.cpu())
    with pytest.raises(ValueError):  # not contiguous
        hungarian.solve_masked_batched(cost.transpose(1, 2), rv)
    with pytest.raises(ValueError):  # not square
        hungarian.solve_masked_batched(cost[:, :, :8].contiguous(), rv)


def _dense_conv_case(dev, kind, c, co, all_invalid=False):
    """B=3 (2,000 / 700 / 0 voxels) in a grid dense enough that most taps
    find a row; ``all_invalid`` makes every neighbour key INVALID_KEY."""
    g = torch.Generator().manual_seed(5)
    shape = (11, 40, 36)
    n = 2000
    keys = []
    for n_valid in (n, 700, 0):
        kk = torch.randperm(11 * 40 * 36, generator=g)[:n_valid]
        kk = torch.sort(kk).values.to(torch.int32)
        pad = torch.full((n - n_valid,), voxelize.INVALID_KEY,
                         dtype=torch.int32)
        keys.append(torch.cat([kk, pad]))
    keys = torch.stack(keys).to(dev)
    if kind == "subm":
        nk = spconv.subm_neighbor_keys(keys, shape)
    else:
        kernel, stride, pad = (((3, 3, 3), (2, 2, 2), (1, 1, 1))
                               if kind == "stride2"
                               else ((3, 1, 1), (2, 1, 1), (0, 0, 0)))
        shape_out = spconv.output_spatial_shape(shape, kernel, stride, pad)
        out_keys, _ = spconv.downsample_keys_batched(
            keys, shape, shape_out, kernel, stride, pad, 1800)
        nk = spconv.sparse_neighbor_keys(out_keys, shape, shape_out, kernel,
                                         stride, pad)
    if all_invalid:
        nk = torch.full_like(nk, voxelize.INVALID_KEY)
    feats = torch.randn(3, n, c, generator=g).to(dev)
    w = torch.randn(nk.shape[-1], c, co, generator=g).to(dev)
    dout = torch.randn(3, nk.shape[1], co, generator=g).to(dev)
    return feats, keys, nk.contiguous(), w, dout, 11 * 40 * 36 + 1


@pytest.mark.parametrize("kind,c,co,need_dfeats,all_invalid", [
    ("subm", 4, 16, False, False), ("subm", 16, 16, True, False),
    ("stride2", 64, 128, True, False), ("z3", 64, 128, True, False),
    ("stride2", 32, 64, False, False), ("subm", 16, 32, True, True)])
def test_key_conv_kernels_match_twins(dev, kind, c, co, need_dfeats,
                                      all_invalid):
    """K5: the forward within 1e-5 of the twin's largest magnitude, the
    rulebook it writes equal to the plain one (writing it changes no bit),
    S of the backward kernel on that rulebook equal to the twin's exactly,
    and dF / dW through
    the autograd Function within 1e-5; C * Co up to the 8,192 limit, an
    empty sample, all-INVALID neighbour keys, and the input gradient
    skipped (one backward launch either way)."""
    feats, keys, nk, w, dout, band = _dense_conv_case(dev, kind, c, co,
                                                      all_invalid)
    out = key_conv.key_conv_batched(feats, keys, nk, w, band)
    ref = key_conv.key_conv_plain(feats, keys, nk, w, band)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * max(scale, 1e-30)
    assert not out[2].any()
    if all_invalid:
        assert scale == 0.0
    again, rb = key_conv.key_conv_fwd(feats, keys, nk, w, rulebook=True)
    assert torch.equal(again, out)
    assert torch.equal(rb, spconv.rulebook_batched(keys, nk))
    s = key_conv.key_conv_bwd(dout, rb, keys.shape[1])
    assert torch.equal(s, key_conv.key_scatter_plain(dout, keys, nk))
    key_conv.key_conv_bwd.launches = 0
    got = _key_grads(key_conv.key_conv_batched, feats, keys, nk, w, dout,
                     band, need_dfeats)
    torch.cuda.synchronize()
    assert key_conv.key_conv_bwd.launches == 1
    want = _key_grads(key_conv.key_conv_plain, feats, keys, nk, w, dout,
                      band, need_dfeats)
    for a, r in zip(got, want):
        err = float((a - r).abs().max())
        assert err <= 1e-5 * max(float(r.abs().max()), 1e-30), err


# (N input rows, M output rows, K, C, Co) of the backbone's 12 convs at
# the voxel caps (16,000 input voxels; 24,000 / 16,000 / 10,000 rows at
# x_conv2 / 3 / 4 and out)
BACKBONE_CONVS = (
    (16000, 16000, 27, 4, 16), (16000, 16000, 27, 16, 16),
    (16000, 24000, 27, 16, 32), (24000, 24000, 27, 32, 32),
    (24000, 24000, 27, 32, 32), (24000, 16000, 27, 32, 64),
    (16000, 16000, 27, 64, 64), (16000, 16000, 27, 64, 64),
    (16000, 10000, 27, 64, 64), (10000, 10000, 27, 64, 64),
    (10000, 10000, 27, 64, 64), (10000, 10000, 3, 64, 128))


def _random_key_case(dev, b, n, m, k, c, co, seed):
    """B samples of sorted random keys (up to 10% INVALID_KEY pads) in a
    band of 4N, neighbour keys drawn from the band with a third INVALID:
    about 15% of rows x K taps find a row, as on the backbone."""
    g = torch.Generator().manual_seed(seed)
    band = 4 * n
    keys = []
    for _ in range(b):
        n_valid = n - int(torch.randint(0, n // 10 + 1, (1,), generator=g))
        kk = torch.sort(torch.randperm(band, generator=g)[:n_valid]).values
        keys.append(torch.cat([kk.to(torch.int32), torch.full(
            (n - n_valid,), voxelize.INVALID_KEY, dtype=torch.int32)]))
    nk = torch.randint(0, band, (b, m, k), generator=g, dtype=torch.int32)
    nk[torch.rand(b, m, k, generator=g) < 1 / 3] = voxelize.INVALID_KEY
    feats = torch.randn(b, n, c, generator=g)
    w = torch.randn(k, c, co, generator=g) / np.sqrt(k * c)
    return (feats.to(dev), torch.stack(keys).to(dev), nk.to(dev), w.to(dev),
            band + 1)


@pytest.mark.parametrize("n,m,k,c,co", BACKBONE_CONVS)
def test_key_conv_forward_at_backbone_shapes(dev, n, m, k, c, co):
    """K5's forward (the gather-GEMM tile, rows rounded to bf16) at the
    12 backbone convs' shapes, B=8, random keys at the caps: within 1e-5
    of the twin's largest magnitude, and bit-equal over two launches."""
    feats, keys, nk, w, band = _random_key_case(dev, 8, n, m, k, c, co,
                                                seed=m + c)
    out = key_conv.key_conv_batched(feats, keys, nk, w, band)
    again = key_conv.key_conv_batched(feats, keys, nk, w, band)
    ref = key_conv.key_conv_forward_plain(feats, keys, nk, w)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("c,co", [(3, 5), (6, 10), (4, 16), (13, 128),
                                  (64, 6), (64, 128)])
def test_key_conv_forward_channels_off_the_vector_width(dev, c, co):
    """C and Co that are not multiples of 4 (4-byte copies into rows
    padded with zero channels, zero-padded weights, scalar stores), C = 4
    with Co = 16 (conv_input) and the widest weight tap (64 x 128):
    within 1e-5 and bit-equal over two launches."""
    feats, keys, nk, w, band = _random_key_case(dev, 3, 3000, 2500, 27, c,
                                                co, seed=c * co)
    out = key_conv.key_conv_batched(feats, keys, nk, w, band)
    again = key_conv.key_conv_batched(feats, keys, nk, w, band)
    ref = key_conv.key_conv_forward_plain(feats, keys, nk, w)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("n,m,k,c,co", BACKBONE_CONVS)
def test_key_conv_backward_at_backbone_shapes(dev, n, m, k, c, co):
    """K5's backward at the 12 backbone convs' shapes, B=8, random keys
    at the caps, on the rulebook the forward wrote: S exactly the twin's
    (from the keys and from that rulebook) and bit-equal over two
    launches. Random neighbour keys repeat within a tap, which no conv
    does: kernel and twin both sum every writer there, from +0 in
    ascending output row (the kernel's flagged repeat pass)."""
    feats, keys, nk, w, band = _random_key_case(dev, 8, n, m, k, c, co,
                                                seed=m + c + 1)
    _, rb = key_conv.key_conv_fwd(feats, keys, nk, w, rulebook=True)
    dout = torch.randn(8, m, co, device=dev)
    s = key_conv.key_conv_bwd(dout, rb, n)
    again = key_conv.key_conv_bwd(dout, rb, n)
    torch.cuda.synchronize()
    assert torch.equal(s, again)
    assert torch.equal(s, key_conv.key_scatter_from_rulebook_plain(dout, rb,
                                                                   n))
    assert torch.equal(s, key_conv.key_scatter_plain(dout, keys, nk))


def _key_grads(fn, feats, keys, nk, w, dout, band, need_dfeats):
    feats = feats.clone().requires_grad_(need_dfeats)
    w = w.clone().requires_grad_(True)
    out = fn(feats, keys, nk, w, band)
    wrt = (feats, w) if need_dfeats else (w,)
    return torch.autograd.grad(out, wrt, dout)


def test_key_conv_wrappers_check_their_arguments(dev):
    """The size guard JAX's flattening needs (B * band < 2^31), the
    kernels' channel limits (C, Co up to 128), and the backward's Co
    limit; the backward takes Co off the 4-wide vectors."""
    feats, keys, nk, w, dout, band = _dense_conv_case(dev, "subm", 16, 16)
    with pytest.raises(ValueError, match="2\\^31"):
        key_conv.key_conv_batched(feats, keys, nk, w, 2 ** 30)
    with pytest.raises(ValueError):  # C = 129 above the kernel's limit
        key_conv.key_conv_batched(
            torch.zeros(3, 2000, 129, device=dev), keys, nk,
            torch.zeros(27, 129, 8, device=dev), band)
    rb = spconv.rulebook_batched(keys, nk)
    with pytest.raises(ValueError):  # Co = 129 above the kernel's limit
        key_conv.key_conv_bwd(torch.zeros(*dout.shape[:2], 129, device=dev),
                              rb, keys.shape[1])
    d6 = dout[..., :6].contiguous()
    assert torch.equal(key_conv.key_conv_bwd(d6, rb, keys.shape[1]),
                       key_conv.key_scatter_from_rulebook_plain(
                           d6, rb, keys.shape[1]))
    with pytest.raises(TypeError):
        key_conv.key_conv_bwd(dout.double(), rb, keys.shape[1])
    with pytest.raises(TypeError):  # the rulebook, not the keys' dtype
        key_conv.key_conv_bwd(dout, rb.long(), keys.shape[1])


def _close(a, r, tol):
    err = float((a - r).abs().max())
    assert err <= tol * max(float(r.abs().max()), 1e-30), err


@pytest.mark.parametrize("kind,c,co,need_dfeats,all_invalid", [
    ("subm", 4, 16, False, False), ("subm", 16, 16, True, False),
    ("stride2", 64, 128, True, False), ("z3", 64, 128, True, False),
    ("subm", 16, 32, True, True)])
def test_gather_conv_kernel_matches_twin(dev, kind, c, co, need_dfeats,
                                         all_invalid):
    """K7: the forward within 1e-5 of the twin's largest magnitude, one
    launch, and dF / dW through the autograd Function within 1e-5 of
    autograd through the plain gather-GEMM; C * Co up to the 8,192 limit,
    an empty sample and an all-absent rulebook."""
    feats, keys, nk, w, dout, _ = _dense_conv_case(dev, kind, c, co,
                                                   all_invalid)
    rb = spconv.rulebook_batched(keys, nk)
    gather_conv.gather_conv_batched.launches = 0
    out = gather_conv.gather_conv_batched(feats, rb, w)
    ref = spconv.gather_conv_batched(feats, rb, w)
    torch.cuda.synchronize()
    assert gather_conv.gather_conv_batched.launches == 1
    _close(out, ref, 1e-5)
    assert not out[2].any()
    got = _rb_grads(gather_conv.gather_conv_batched, feats, rb, w, dout,
                    need_dfeats)
    want = _rb_grads(spconv.gather_conv_batched, feats, rb, w, dout,
                     need_dfeats)
    for a, r in zip(got, want):
        _close(a, r, 1e-5)


def _padded(t, c4, co4):
    """(feats (B, N, C) or weights (K, C, Co)) with zero channels up to
    C4 (and zero output columns up to Co4 for weights)."""
    if co4 is None:
        return torch.nn.functional.pad(t, (0, c4 - t.shape[-1]))
    return torch.nn.functional.pad(t, (0, co4 - t.shape[-1],
                                       0, c4 - t.shape[-2]))


@pytest.mark.parametrize("kind,c,co,offset", [
    ("subm", 4, 16, 0), ("subm", 64, 64, 0), ("z3", 64, 128, 0),
    ("stride2", 16, 32, 1), ("subm", 3, 5, 0), ("stride2", 6, 10, 0),
    ("z3", 13, 128, 0), ("subm", 64, 6, 0)])
def test_gather_conv_is_bit_equal_to_k1(dev, kind, c, co, offset):
    """K7 (the gather-GEMM tile in map mode) gives K1's forward bits on
    the same rulebook: directly where C and Co are multiples of 4 and
    the data start on 16 bytes; where they do not (C or Co off the
    vector width, or features 4 bytes off), K7 pads and K1 runs on the
    zero-padded operands, and K7 keeps Co of its columns. Within 1e-5 of
    the twin, and the same bits on every launch."""
    feats, keys, nk, w, _, band = _dense_conv_case(dev, kind, c, co)
    if offset:  # a contiguous view 4 bytes past a 16-byte boundary
        buf = torch.empty(feats.numel() + offset, device=dev)
        buf[offset:] = feats.reshape(-1)
        feats = buf[offset:].view(feats.shape)
    rb = spconv.rulebook_batched(keys, nk)
    assert gather_conv.needs_pad(feats, w) == bool(c % 4 or co % 4
                                                   or offset)
    out = gather_conv.gather_conv_batched(feats, rb, w)
    again = gather_conv.gather_conv_batched(feats, rb, w)
    c4, co4 = -(-c // 4) * 4, -(-co // 4) * 4
    fp = _padded(feats, c4, None).contiguous()
    out_keys = torch.zeros(nk.shape[:2], dtype=torch.int32, device=dev)
    k1, _ = window_key_conv.window_key_conv_fwd(
        fp, keys, nk, out_keys, _padded(w, c4, co4).contiguous(), band)
    ref = spconv.gather_conv_batched(feats, rb, w)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out, k1[..., :co])
    _close(out, ref, 1e-5)


def _rb_grads(fn, feats, rb, w, dout, need_dfeats):
    feats = feats.clone().requires_grad_(need_dfeats)
    w = w.clone().requires_grad_(True)
    wrt = (feats, w) if need_dfeats else (w,)
    return torch.autograd.grad(fn(feats, rb, w), wrt, dout)


@pytest.mark.parametrize("kind,c,co", [("subm", 16, 16),
                                       ("stride2", 64, 128), ("z3", 32, 64)])
def test_onehot_gather_kernels_match_twins(dev, kind, c, co):
    """K6: the forward (the rulebook kernel with its bf16 flag) within 1e-5
    of the twin, S of the backward kernel equal to the twin's exactly on a
    spconv rulebook, which takes the direct path (one writer a slot), and
    dF / dW through the autograd Function within 1e-5; one launch of
    each."""
    feats, keys, nk, w, dout, _ = _dense_conv_case(dev, kind, c, co)
    rb = spconv.rulebook_batched(keys, nk)
    cuda_ops.reset_launch_counts()
    got = _rb_grads(onehot_gather.onehot_gather_conv_batched, feats, rb, w,
                    dout, True)
    torch.cuda.synchronize()
    assert onehot_gather.onehot_gather_conv.launches == 1
    assert onehot_gather.onehot_gather_scatter.launches == 1
    assert onehot_gather.onehot_gather_scatter.direct == 1
    assert onehot_gather.onehot_gather_scatter.sorted == 0
    b, m, k = rb.shape
    flat = torch.where(rb >= 0, rb + 2000 * torch.arange(
        b, device=dev, dtype=torch.int32)[:, None, None], -1).reshape(-1, k)
    out = onehot_gather.onehot_gather_conv(feats.reshape(-1, c), flat, w)
    ref = onehot_gather.onehot_gather_forward_plain(feats.reshape(-1, c),
                                                    flat, w)
    _close(out, ref, 1e-5)
    d = dout.reshape(-1, co)
    s = onehot_gather.onehot_gather_scatter(d, flat, b * 2000)
    assert torch.equal(s, onehot_gather.onehot_gather_scatter_plain(
        d, flat, b * 2000))
    want = _rb_grads(onehot_gather.onehot_gather_conv_plain,
                     feats.reshape(-1, c), flat, w, d, True)
    for a, r in zip(got, want):
        _close(a.reshape(r.shape), r, 1e-5)


def test_onehot_gather_scatter_sums_repeats_deterministically(dev):
    """A rulebook with repeated rows (up to ~60 writers per slot), -1 and
    out-of-range entries takes the sorted path: S equals the CPU twin's
    sum in the chunked order (``onehot_rows.segment_sum_plain``; slots of
    at most ``CHUNK`` writers, as all here, are sequential sums) bit for
    bit, and two launches give the same bits."""
    g = torch.Generator().manual_seed(7)
    rb = torch.randint(-1, 600, (30000, 27), generator=g, dtype=torch.int32)
    rb[::5, 4] = 700
    dout = torch.randn(30000, 24, generator=g)
    want = onehot_gather.onehot_gather_scatter_plain(dout, rb, 650)
    cuda_ops.reset_launch_counts()
    s1 = onehot_gather.onehot_gather_scatter(dout.to(dev), rb.to(dev), 650)
    s2 = onehot_gather.onehot_gather_scatter(dout.to(dev), rb.to(dev), 650)
    assert onehot_gather.onehot_gather_scatter.sorted == 2
    assert onehot_gather.onehot_gather_scatter.direct == 0
    assert torch.equal(s1, s2)
    assert torch.equal(s1.cpu(), want)


@pytest.mark.parametrize("co", [16, 24, 5])
def test_onehot_gather_scatter_switches_path_on_one_repeat(dev, co):
    """An injective spconv rulebook takes the direct path; the same
    rulebook with one (row, tap) pair copied onto another row's entry
    (one slot, two writers) takes the sorted path. Both equal the CPU
    twin bit for bit, and the repeated slot holds the two rounded rows
    summed in ascending m."""
    _, keys, nk, _, _, _ = _dense_conv_case(dev, "subm", 16, 16)
    rb = spconv.rulebook_batched(keys, nk)[0].contiguous()
    g = torch.Generator().manual_seed(9)
    dout = torch.randn(rb.shape[0], co, generator=g)
    hit = (rb[:, 13] >= 0).nonzero()[:, 0]
    m0, m1 = int(hit[0]), int(hit[-1])
    dup = rb.clone()
    dup[m1, 13] = rb[m0, 13]
    n = 2000
    for table, path in ((rb, "direct"), (dup, "sorted")):
        cuda_ops.reset_launch_counts()
        s = onehot_gather.onehot_gather_scatter(dout.to(dev), table, n)
        torch.cuda.synchronize()
        assert getattr(onehot_gather.onehot_gather_scatter, path) == 1
        assert onehot_gather.onehot_gather_scatter.launches == 1
        want = onehot_gather.onehot_gather_scatter_plain(dout, table.cpu(), n)
        assert torch.equal(s.cpu(), want)
    r = dout.to(torch.bfloat16).float()
    assert torch.equal(s[13, int(rb[m0, 13])].cpu(), r[m0] + r[m1])


@pytest.mark.parametrize("b,n,c,q", [(3, 2048, 128, 20000), (2, 50, 3, 90000),
                                     (1, 18000, 16, 4096)])
def test_onehot_rows_kernels_match_twins(dev, b, n, c, q):
    """K8: the gather equal to the twin bit for bit (-1 and indices at and
    beyond N give zero rows); the scatter-add equal to the CPU twin's sum
    in the chunked order (``onehot_rows.segment_sum_plain``) bit for bit
    with thousands of repeats per row, and the same on a second launch;
    one launch each through the autograd Function."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(b, n, c, generator=g)
    idx = torch.randint(-1, n + 3, (b, q), generator=g, dtype=torch.int32)
    dout = torch.randn(b, q, c, generator=g)
    xd, idd, dd = x.to(dev), idx.to(dev), dout.to(dev)
    onehot_rows.onehot_take_rows_batched.launches = 0
    onehot_rows.onehot_scatter_rows.launches = 0
    xg = xd.clone().requires_grad_()
    out = onehot_rows.onehot_take_rows_batched(xg, idd)
    (dx,) = torch.autograd.grad(out, (xg,), dd)
    torch.cuda.synchronize()
    assert onehot_rows.onehot_take_rows_batched.launches == 1
    assert onehot_rows.onehot_scatter_rows.launches == 1
    assert torch.equal(out, onehot_rows.take_rows_plain(xd, idd))
    want = onehot_rows.scatter_rows_plain(dout, idx, n)
    assert torch.equal(dx.cpu(), want)
    assert torch.equal(onehot_rows.onehot_scatter_rows(dd, idd, n), dx)
    assert torch.equal(onehot_rows.onehot_take_rows(xd[0], idd[0]), out[0])


def test_onehot_scatter_rows_hot_slot_at_roi_grid_shape(dev):
    """K8's scatter at the RoI-grid shape, (8, 442368) indices into an
    (8, 2048, 64) table, with ~340,000 repeats of index 0 in sample 0 (the
    empty balls' index) and ~147,000 in sample 3: the kernel equals the
    CPU twin's chunked sum bit for bit, and two launches give the same
    bits."""
    b, n, c, q = 8, 2048, 64, 442368
    g = torch.Generator().manual_seed(10)
    idx = torch.randint(-1, n, (b, q), generator=g, dtype=torch.int32)
    idx[0, torch.rand(q, generator=g) < 0.77] = 0
    idx[3, ::3] = 0
    dout = torch.randn(b, q, c, generator=g)
    assert int((idx[0] == 0).sum()) > 300000
    onehot_rows.onehot_scatter_rows.launches = 0
    d1 = onehot_rows.onehot_scatter_rows(dout.to(dev), idx.to(dev), n)
    d2 = onehot_rows.onehot_scatter_rows(dout.to(dev), idx.to(dev), n)
    torch.cuda.synchronize()
    assert onehot_rows.onehot_scatter_rows.launches == 2
    assert torch.equal(d1, d2)
    assert torch.equal(d1.cpu(), onehot_rows.scatter_rows_plain(dout, idx, n))


def test_onehot_wrappers_check_their_arguments(dev):
    """Types, shapes and the rulebook kernels' channel limits."""
    feats, keys, nk, w, dout, _ = _dense_conv_case(dev, "subm", 16, 16)
    rb = spconv.rulebook_batched(keys, nk)
    with pytest.raises(ValueError):  # C = 129 above the kernel's limit
        gather_conv.gather_conv_batched(
            torch.zeros(3, 2000, 129, device=dev), rb,
            torch.zeros(27, 129, 8, device=dev))
    with pytest.raises(ValueError):  # the same limit for K6's forward
        onehot_gather.onehot_gather_conv(
            torch.zeros(2000, 129, device=dev), rb[0],
            torch.zeros(27, 129, 8, device=dev))
    with pytest.raises(TypeError):
        gather_conv.gather_conv_batched(feats, rb.long(), w)
    with pytest.raises(ValueError):  # weights do not match K
        onehot_gather.onehot_gather_conv(feats[0], rb[0], w[:3].contiguous())
    with pytest.raises(ValueError):  # dout rows do not match the rulebook
        onehot_gather.onehot_gather_scatter(dout[0, :10], rb[0], 2000)
    with pytest.raises(ValueError):  # Co = 257 above the direct path's
        onehot_gather.onehot_gather_scatter(
            torch.zeros(rb.shape[1], 257, device=dev), rb[0], 2000)
    x = torch.zeros(2, 40, 8, device=dev)
    idx = torch.zeros(2, 9, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        onehot_rows.onehot_take_rows_batched(x, idx.long())
    with pytest.raises(ValueError):
        onehot_rows.onehot_take_rows_batched(x, idx[:1])
    with pytest.raises(ValueError):
        onehot_rows.onehot_scatter_rows(torch.zeros(2, 8, 8, device=dev),
                                        idx, 40)


def _repeat_case(dev, c, co, offset=0):
    """_dense_conv_case's submanifold case with neighbour keys that repeat
    within a tap (no conv has them; the public ops take them): tap 4 of
    rows 2j and 2j + 1 reads voxel 2j (two writers a slot) and tap 22 of
    every 8th row voxel 3 (one slot, 250 writers: dF's one fmaf chain
    over a slot of 2,000 writers at Co = 64 is ~1e-5 from the twin's
    order of sums); ``offset`` floats moves dout off 16 bytes."""
    feats, keys, nk, w, dout, band = _dense_conv_case(dev, "subm", c, co)
    nk = nk.clone()
    nk[:, 0::2, 4] = keys[:, 0::2]
    nk[:, 1::2, 4] = keys[:, 0::2]
    nk[:, ::8, 22] = keys[:, 3:4]
    if offset:
        buf = torch.empty(dout.numel() + offset, device=dev)
        buf[offset:] = dout.reshape(-1)
        dout = buf[offset:].view(dout.shape)
    return feats, keys, nk.contiguous(), w, dout, band


@pytest.mark.parametrize("c,co,offset", [(16, 16, 0), (5, 3, 0),
                                         (32, 64, 1)])
def test_backward_kernels_sum_repeated_writers(dev, c, co, offset):
    """K1's and K5's backward where a tap's neighbour keys repeat: the
    claim flags the slot and the repeat pass sums every writer, as JAX
    does. K1: dF and dW within 1e-5 of autograd through the twin, the
    same bits over two launches; K5: S exactly the twin's (from +0 in
    ascending output row, on the card and on the CPU) and the same bits
    over two launches, dF and dW through the autograd Function within
    1e-5; Co off the 4-wide vectors and dout off 16 bytes included."""
    feats, keys, nk, w, dout, band = _repeat_case(dev, c, co, offset)
    rb = spconv.rulebook_batched(keys, nk)
    n = keys.shape[1]
    _, rb_k1 = window_key_conv.window_key_conv_fwd(feats, keys, nk, keys, w,
                                                   band, rulebook=True)
    assert torch.equal(rb_k1, rb)
    first = window_key_conv.window_key_conv_bwd(dout, feats, rb, w)
    second = window_key_conv.window_key_conv_bwd(dout, feats, rb, w)
    want = _grads(window_key_conv.window_key_conv_plain, feats, keys, nk,
                  keys, w, dout, band, True)
    s1 = key_conv.key_conv_bwd(dout, rb, n)
    s2 = key_conv.key_conv_bwd(dout, rb, n)
    s_twin = key_conv.key_scatter_from_rulebook_plain(dout, rb, n)
    got5 = _key_grads(key_conv.key_conv_batched, feats, keys, nk, w, dout,
                      band, True)
    want5 = _key_grads(key_conv.key_conv_plain, feats, keys, nk, w, dout,
                       band, True)
    torch.cuda.synchronize()
    for a, a2, r in zip(first, second, want):
        assert torch.equal(a, a2)
        _close(a, r, 1e-5)
    assert torch.equal(s1, s2) and torch.equal(s1, s_twin)
    assert torch.equal(s1.cpu(), key_conv.key_scatter_from_rulebook_plain(
        dout.cpu(), rb.cpu(), n))
    assert int((rb[0, ::8, 22] == 3).sum()) == 250  # the hot slot
    for a, r in zip(got5, want5):
        _close(a, r, 1e-5)


@pytest.mark.parametrize("kind,c,co", [
    ("subm", 3, 5), ("stride2", 5, 16), ("subm", 128, 128),
    ("z3", 128, 128), ("stride2", 128, 64), ("subm", 1, 1)])
def test_sparse_convs_take_any_channel_count(dev, kind, c, co):
    """K1, K5 and K7 at C, Co off the 4-wide vectors and at 128 (UNet's
    ``_m`` convs; the 32-row tile, ~185 KB, and dW's 64-column groups),
    forward and gradients: within 1e-5 of their twins, K1's forward
    bit-equal to K7 on the same rulebook and K1's backward the same bits
    over two launches."""
    feats, keys, nk, w, dout, band = _dense_conv_case(dev, kind, c, co)
    rb = spconv.rulebook_batched(keys, nk)
    out_keys = torch.zeros(nk.shape[:2], dtype=torch.int32, device=dev)
    k1 = window_key_conv.window_key_conv_batched(feats, keys, nk, out_keys,
                                                 w, band)
    k7 = gather_conv.gather_conv_batched(feats, rb, w)
    torch.cuda.synchronize()
    assert torch.equal(k1, k7)
    _close(k1, spconv.gather_conv_batched(feats, rb, w), 1e-5)
    for got, want in (
            (_grads(window_key_conv.window_key_conv_batched, feats, keys, nk,
                    out_keys, w, dout, band, True),
             _grads(window_key_conv.window_key_conv_plain, feats, keys, nk,
                    out_keys, w, dout, band, True)),
            (_key_grads(key_conv.key_conv_batched, feats, keys, nk, w, dout,
                        band, True),
             _key_grads(key_conv.key_conv_plain, feats, keys, nk, w, dout,
                        band, True)),
            (_rb_grads(gather_conv.gather_conv_batched, feats, rb, w, dout,
                       True),
             _rb_grads(spconv.gather_conv_batched, feats, rb, w, dout,
                       True))):
        for a, r in zip(got, want):
            _close(a, r, 1e-5)
    _close(key_conv.key_conv_batched(feats, keys, nk, w, band),
           key_conv.key_conv_forward_plain(feats, keys, nk, w), 1e-5)
    again = [window_key_conv.window_key_conv_bwd(dout, feats, rb, w)
             for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*again))


@pytest.mark.parametrize("kind,c,co,all_invalid", [
    ("subm", 16, 16, False), ("stride2", 64, 128, False),
    ("z3", 128, 128, False), ("subm", 3, 5, False), ("stride2", 13, 20,
                                                     False),
    ("subm", 32, 32, True)])
def test_onehot_gather_forward_tensor_core_tile(dev, kind, c, co,
                                                all_invalid):
    """K6's forward (bf16 operands rounded once, mma.sync on the matched
    pairs' tile): within 1e-5 of the twin's largest magnitude, the same
    bits over two launches; C off the mma's 16-deep steps and Co off its
    8-wide tiles (zero pads), an all-absent rulebook (zeros) and entries
    at and beyond N (none)."""
    feats, keys, nk, w, _, _ = _dense_conv_case(dev, kind, c, co,
                                                all_invalid)
    rb = spconv.rulebook_batched(keys, nk)
    b, m, k = rb.shape
    flat = torch.where(rb >= 0, rb + 2000 * torch.arange(
        b, device=dev, dtype=torch.int32)[:, None, None], -1).reshape(-1, k)
    flat[::7, k // 2] = b * 2000 + 3  # beyond N: none
    f2 = feats.reshape(-1, c)
    cuda_ops.reset_launch_counts()
    out = onehot_gather.onehot_gather_conv(f2, flat, w)
    again = onehot_gather.onehot_gather_conv(f2, flat, w)
    ref = onehot_gather.onehot_gather_forward_plain(f2, flat, w)
    torch.cuda.synchronize()
    assert onehot_gather.onehot_gather_conv.launches == 2
    assert torch.equal(out, again)
    _close(out, ref, 1e-5)
    if all_invalid:
        assert not out.any()


@pytest.mark.parametrize("c", [1, 3, 4, 64, 128, 200])
@pytest.mark.parametrize("offset", [0, 1])
def test_onehot_take_rows_exact_at_any_width(dev, c, offset):
    """K8's gather (16-byte vectors where C and the data allow, one float
    a lane else): exactly the twin, with indices -1, N, N + 7 and far
    beyond giving zero rows, and the table ``offset`` floats off 16
    bytes."""
    g = torch.Generator().manual_seed(c + offset)
    b, n, q = 3, 700, 5000
    x = torch.randn(b, n, c, generator=g)
    idx = torch.randint(-1, n, (b, q), generator=g, dtype=torch.int32)
    idx[:, ::11] = n
    idx[:, 5::13] = n + 7
    idx[:, 7::17] = 2 ** 30
    buf = torch.empty(x.numel() + offset, device=dev)
    buf[offset:] = x.reshape(-1).to(dev)
    xd = buf[offset:].view(b, n, c)
    idd = idx.to(dev)
    onehot_rows.onehot_take_rows_batched.launches = 0
    out = onehot_rows.onehot_take_rows_batched(xd, idd)
    torch.cuda.synchronize()
    assert onehot_rows.onehot_take_rows_batched.launches == 1
    assert torch.equal(out, onehot_rows.take_rows_plain(xd, idd))
    assert torch.equal(out.cpu(), onehot_rows.take_rows_plain(x, idx))
    assert not out[idd >= n].any()


# ---- the LiDAR zoo's new kernel paths ----

ZOO_SPEC = voxelize.VoxelizerSpec(SSL_PCR, (0.05, 0.05, 0.1), 16000, 5)


@pytest.fixture(scope="module")
def unet_convs():
    """The 28 K1 calls of one Part-A2 UNet forward (B=2 synthetic frames
    of 18,000 points, ``split_0.py``'s voxelizer, pcdet's widths and
    caps), recorded on the twin: the encoder's 12, the UR blocks' 12
    (their merge convs at C = 128 -> 64) and the three inverse convs on
    the coarse key tables, and conv5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: see the README)")
    from detmatch_tpu_torch.models.pvrcnn.unet import UNetBackbone
    torch.backends.cuda.matmul.allow_tf32 = False
    pts, valid = lidar_batch(np.random.RandomState(14), 2, 18000, SSL_PCR)
    vox = voxelize.voxelize_mean(torch.from_numpy(pts).cuda(),
                                 torch.from_numpy(valid).cuda(), ZOO_SPEC)
    torch.manual_seed(14)
    net = UNetBackbone(ZOO_SPEC.spatial_shape).cuda().eval()
    calls = []

    def rec(*args):
        calls.append(tuple(a.detach() if torch.is_tensor(a) else a
                           for a in args))
        return window_key_conv.window_key_conv_plain(*args)

    ops = cuda_ops.PLAIN._replace(window_key_conv_batched=rec)
    with torch.no_grad():
        net(vox["features"], vox["keys"], ops)
    assert len(calls) == 28
    return calls


@pytest.mark.parametrize("i", range(28))
def test_window_key_conv_at_unet_shapes(unet_convs, i):
    """K1 forward and backward at each UNet conv's shapes and geometry
    (subm, stride 2, (3,1,1), inverse): within 1e-5 of the twin, the
    forward's rulebook equal to the plain one, forward and backward
    bit-equal over two launches."""
    feats, keys, nk, out_keys, w, band = unet_convs[i]
    out = window_key_conv.window_key_conv_batched(feats, keys, nk, out_keys,
                                                  w, band)
    again, rb = window_key_conv.window_key_conv_fwd(feats, keys, nk,
                                                    out_keys, w, band,
                                                    rulebook=True)
    ref = window_key_conv.window_key_conv_plain(feats, keys, nk, out_keys,
                                                w, band)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert torch.equal(rb, spconv.rulebook_batched(keys, nk))
    g = torch.Generator().manual_seed(i)
    dout = torch.randn(out.shape, generator=g).cuda()
    first = window_key_conv.window_key_conv_bwd(dout, feats, rb, w)
    second = window_key_conv.window_key_conv_bwd(dout, feats, rb, w)
    want = _grads(window_key_conv.window_key_conv_plain, feats, keys, nk,
                  out_keys, w, dout, band, True)
    torch.cuda.synchronize()
    for a, a2, r in zip(first, second, want):
        assert torch.equal(a, a2)
        assert float((a - r).abs().max() / r.abs().max()) <= 1e-5


def test_unet_shapes_reach_c128_and_the_inverse_geometry(unet_convs):
    """The recorded calls include the two 128-channel merge convs, and 7
    whose output rows are not the table's rows: the 4 strided convs and
    the 3 inverse convs."""
    shapes = [(c[0].shape[-1], c[4].shape[-1]) for c in unet_convs]
    assert shapes.count((128, 64)) == 2
    assert sum(c[3].data_ptr() != c[1].data_ptr() for c in unet_convs) == 7


@pytest.mark.parametrize("radius", [0.4, 0.8, 1.6])
def test_ball_query_on_voxel_centre_tables(dev, radius):
    """Voxel R-CNN's call: the RoI grid points (B=2, 128 RoIs x 216) over
    a level's voxel centres, the table's padded rows masked."""
    from detmatch_tpu_torch.models.pvrcnn.vsa import voxel_centers
    pts, valid = lidar_batch(np.random.RandomState(15), 2, 18000, SSL_PCR)
    vox = voxelize.voxelize_mean(torch.from_numpy(pts).to(dev),
                                 torch.from_numpy(valid).to(dev),
                                 voxelize.VoxelizerSpec(
                                     SSL_PCR, (0.2, 0.2, 0.4), 12000, 5))
    keys = vox["keys"]
    shape = voxelize.VoxelizerSpec(SSL_PCR, (0.2, 0.2, 0.4), 12000,
                                   5).spatial_shape
    mask = keys != voxelize.INVALID_KEY
    assert not mask.all()
    cen = voxel_centers(keys, shape, 1, (0.2, 0.2, 0.4), SSL_PCR)
    g = torch.Generator(device=dev).manual_seed(15)
    roi = cen[:, torch.randint(0, 5000, (128,), generator=g, device=dev)]
    grid = (roi[:, :, None] + torch.rand(2, 128, 216, 3, generator=g,
                                         device=dev) * 2 - 1).reshape(
        2, -1, 3).contiguous()
    gv = torch.ones(grid.shape[:2], dtype=torch.bool, device=dev)
    c_s, v_s, perm = ball_query.sort_points_by_y(cen, mask)
    table = ball_query.pack_table(c_s, v_s, perm)
    ki, kc = ball_query.ball_query_batched(grid, gv, c_s, v_s, radius, 16,
                                           point_perm=perm, table=table)
    pi, pc = ball_query.ball_query_plain(grid, gv, c_s, v_s, radius, 16,
                                         point_perm=perm)
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    assert (kc > 0).any() and (kc == 0).any()


def test_ball_query_group_all_512_slots_over_32_points(dev):
    """PointRCNN's group-all level: one center at the origin over each
    problem's 32 points, radius 100, 512 slots (the unused ones repeat
    the first hit); 256 problems, some with no valid point."""
    g = torch.Generator(device=dev).manual_seed(16)
    pts = torch.randn(256, 32, 3, generator=g, device=dev) * 2
    pv = torch.ones(256, 32, dtype=torch.bool, device=dev)
    pv[::7] = False
    pv[3, 20:] = False
    cen = torch.zeros(256, 1, 3, device=dev)
    cv = pv.any(1, keepdim=True)
    ki, kc = ball_query.ball_query_batched(cen, cv, pts, pv, 100.0, 512)
    pi, pc = ball_query.ball_query_plain(cen, cv, pts, pv, 100.0, 512)
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    assert kc.max() == 32 and kc[3] == 20 and (kc[::7] == 0).all()


def test_fps_16384_to_4096(dev):
    """PointRCNN's first level: B=2 frames of 16,384 points → 4,096."""
    xyz, valid = _lidar(dev, 2, 16384, 17)
    out = fps.fps_batched(xyz, valid, 4096)
    assert torch.equal(out, fps.fps_plain(xyz, valid, 4096))


@pytest.mark.parametrize("n,k", [(512, 128), (128, 32)])
def test_fps_on_roi_problems(dev, n, k):
    """PointRCNN's RoI head: 256 problems (B=2 x 128 RoIs) of 512 → 128
    and 128 → 32 points in a RoI's frame, every eighth one empty (no
    valid point: index 0 throughout)."""
    g = torch.Generator(device=dev).manual_seed(18 + n)
    xyz = torch.randn(256, n, 3, generator=g, device=dev)
    valid = torch.ones(256, n, dtype=torch.bool, device=dev)
    valid[::8] = False
    out = fps.fps_batched(xyz, valid, k)
    assert torch.equal(out, fps.fps_plain(xyz, valid, k))
    assert (out[::8] == 0).all()


# The CUDA ops' shape limits (README, "The CUDA ops' shape limits"): at
# each limit the kernel equals its twin; one past it the wrapper raises,
# with no fallback to the twin.

def _limit_rulebook(dev, c, co):
    feats, keys, nk, w, band = _dense_case(dev, c, co)
    return feats, keys, nk, w, band, spconv.rulebook_batched(keys, nk)


@pytest.mark.parametrize("op", ["K1", "K7"])
def test_sparse_conv_at_and_past_the_channel_limit(dev, op):
    """K1 (window keys) and K7 (rulebook): C = Co = 128, C * Co = 16,384
    (the widest model conv is the UNet's C = 128), within 1e-5 of the
    twin; C or Co = 129 raises."""
    feats, keys, nk, w, band, rb = _limit_rulebook(dev, 128, 128)
    cuda_ops.reset_launch_counts()
    if op == "K1":
        def run(f, wt):
            return window_key_conv.window_key_conv_batched(f, keys, nk, keys,
                                                           wt, band)
        ref = window_key_conv.window_key_conv_plain(feats, keys, nk, keys, w,
                                                    band)
    else:
        def run(f, wt):
            return gather_conv.gather_conv_fwd(f, rb, wt)
        ref = gather_conv.gather_conv_plain(feats, rb, w)
    out = run(feats, w)
    torch.cuda.synchronize()
    assert sum(cuda_ops.launch_counts().values()) == 1
    _close(out, ref, 1e-5)
    for c, co in ((129, 128), (128, 129)):
        with pytest.raises(ValueError, match="128"):
            run(torch.zeros(feats.shape[:2] + (c,), device=dev),
                torch.zeros(27, c, co, device=dev))


@pytest.mark.parametrize("co,past", [(255, 257), (1024, 1028)])
def test_onehot_gather_scatter_at_and_past_its_width(dev, co, past):
    """K6's S: Co up to 256 (255 the widest off the 4-wide vectors), up to
    1,024 where 4 divides Co, exactly the twin's; 257 and 1,028 raise
    (no model calls K6; its replay uses Co <= 64)."""
    _, keys, nk, _, _, rb = _limit_rulebook(dev, 4, 4)
    b, m, k = rb.shape
    n = keys.shape[1]
    flat = torch.where(rb >= 0, rb + n * torch.arange(
        b, device=dev, dtype=torch.int32)[:, None, None], -1).reshape(-1, k)
    g = torch.Generator().manual_seed(7)
    dout = torch.randn(b * m, co, generator=g).to(dev)
    s = onehot_gather.onehot_gather_scatter(dout, flat, b * n)
    assert torch.equal(s, onehot_gather.onehot_gather_scatter_plain(
        dout, flat, b * n))
    with pytest.raises(ValueError, match="Co in"):
        onehot_gather.onehot_gather_scatter(
            torch.zeros(b * m, past, device=dev), flat, b * n)


def test_fps_at_and_past_its_point_limit(dev):
    """K3: N = 49,152 (PointRCNN's 16,384 and the SSL clouds' 18,000 are
    the widest model calls) equals the twin; 49,153 raises."""
    n = fps.MAX_POINTS
    assert n == 49152
    xyz = _cloud(dev, 1, n, 11)
    valid = torch.ones(1, n, dtype=torch.bool, device=dev)
    assert torch.equal(fps.fps_batched(xyz, valid, 512),
                       fps.fps_plain(xyz, valid, 512))
    with pytest.raises(ValueError, match="49152"):
        fps.fps_batched(_cloud(dev, 1, n + 1, 12),
                        torch.ones(1, n + 1, dtype=torch.bool, device=dev),
                        512)


def test_hungarian_at_and_past_its_column_limit(dev):
    """K4: K = 1,024, every row valid (the model's calls take K = 128),
    exactly the twin's assignment; K = 1,025 raises."""
    k = hungarian.MAX_K
    cost, rv = _jv_problem(1, k, [k], [k], seed=13)
    got = hungarian.solve_masked_batched(cost.to(dev), rv.to(dev))
    assert torch.equal(got.cpu(), hungarian.solve_masked_plain(cost, rv))
    assert (got >= 0).all()
    with pytest.raises(ValueError, match="K <= 1024"):
        hungarian.solve_masked_batched(
            torch.zeros(1, k + 1, k + 1, device=dev),
            torch.ones(1, k + 1, dtype=torch.bool, device=dev))
