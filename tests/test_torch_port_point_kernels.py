"""The host-side plans of K2 (ball query, ``ops/cuda/ball_query``) and K3
(farthest-point sampling, ``ops/cuda/fps``), the constants they mirror
from ``csrc/ball_query.cu`` and ``csrc/fps.cu``, the packed table that K2
reads, and the plain twins against the JAX package on the edge cases
that the kernels' ballot scan and cluster exchange must get right. Runs
on the CPU: the plans are plain Python, the wrappers take the twins on
CPU tensors, and JAX runs its XLA formulation (``impl="xla"``)."""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.ops.pallas import ball_query as jbq  # noqa: E402
from detmatch_tpu.ops.pallas import fps as jfps  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.vsa import DEFAULT_SA_CFG  # noqa: E402
from detmatch_tpu_torch.ops.cuda import ball_query as bq  # noqa: E402
from detmatch_tpu_torch.ops.cuda import fps  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

CSRC = ROOT / "detmatch_tpu_torch" / "csrc"


def _constant(path, name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         path.read_text()).group(1))


def test_constants_match_the_sources():
    src = CSRC / "fps.cu"
    assert _constant(src, "kMaxCluster") == max(fps.CLUSTER_SIZES)
    assert _constant(src, "kThreads") == fps.CTA_THREADS
    assert _constant(src, "kMaxPerThread") == fps.MAX_PER_THREAD
    assert _constant(src, "kMaxPoints") == fps.MAX_POINTS
    assert _constant(src, "kMaxSlots") == fps.MAX_SLOTS
    assert tuple(int(c) for c in re.findall(
        r"cluster == (\d+)", src.read_text())) == fps.CLUSTER_SIZES
    cases = re.findall(r"case (\d+):", (CSRC / "ball_query.cu").read_text())
    assert tuple(int(c) for c in cases) == bq.GROUP_LANES


def _main_path_calls():
    """(site, M, N, r, nsample) of the main path's ball queries: the VSA
    over 2,048 keypoints (raw points of the 18,000-point frames, the
    voxel levels at their caps) and the RoI grid (216 points a RoI: 100
    RoIs at test time, 128 at training) over the keypoints."""
    tables = dict(raw_points=18000, x_conv1=16000, x_conv2=24000,
                  x_conv3=16000, x_conv4=10000)
    calls = [(site, 2048, tables[site], r, ns)
             for site, cfg in DEFAULT_SA_CFG.items()
             for r, ns in zip(cfg["radii"], cfg["nsamples"])]
    for m in (100 * 216, 128 * 216):
        calls += [("roi_grid", m, 2048, r, 16) for r in (0.8, 1.6)]
    return calls


@pytest.mark.parametrize("site,m,n,r,ns", _main_path_calls())
def test_group_lanes_on_the_main_path(site, m, n, r, ns):
    """Every main-path call gets a group the kernel is built for: 32
    lanes on the VSA's long windows, 8 on the RoI grid's short ones."""
    g = bq.group_lanes(m, n, r, ns)
    assert g in bq.GROUP_LANES
    assert g == (8 if site == "roi_grid" else 32)


@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [16384, 18000])
def test_fps_plan(b, n):
    """Clusters of 8 CTAs (at most 64 CTAs in all), the fewest points a
    thread that hold the frame, the candidates' slots within the
    kernel's, and a thread's points within its register budget."""
    plan = fps.fps_plan(b, n)
    assert plan.cluster == 8 and b * plan.cluster <= 64
    assert 1 <= plan.per_thread <= fps.MAX_PER_THREAD
    threads = plan.cluster * fps.CTA_THREADS
    assert threads * plan.per_thread >= n > threads * (plan.per_thread - 1)
    assert plan.cluster * fps.CTA_THREADS // 32 <= fps.MAX_SLOTS
    # xyz and the running distance of each point: 4 registers, under
    # half of a thread's 255; a CTA at 255 a thread within an SM's 65,536
    assert 4 * plan.per_thread <= 4 * fps.MAX_PER_THREAD < 255 // 2
    assert fps.CTA_THREADS * 255 <= 65536


def test_fps_capacity():
    """Frames beyond a cluster of 8 take a larger cluster, up to the
    kernel's capacity; more points raise."""
    assert fps.MAX_POINTS >= 18000
    assert fps.fps_plan(1, fps.MAX_POINTS) == (16, fps.MAX_PER_THREAD)
    assert fps.fps_plan(1, 8 * 128 * fps.MAX_PER_THREAD + 1).cluster == 16
    assert fps.fps_plan(16, 4096) == (4, 8)   # B x C <= 64 CTAs
    assert fps.fps_plan(16, 18000) == (8, 18)  # 4 cannot hold it
    with pytest.raises(ValueError, match="N <="):
        fps.fps_plan(1, fps.MAX_POINTS + 1)


def test_pack_table_matches_the_sort():
    """The packed records follow ``sort_points_by_y``'s order: x and z
    as sorted, y there or +inf on the invalid rows (last), and the
    permutation in the fourth word's bits."""
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.randn(2, 300, 4).astype(np.float32))
    pts[:, ::7, 1] = 0.25  # equal y values
    valid = torch.from_numpy(rng.rand(2, 300) > 0.2)
    pts_s, pv_s, perm = bq.sort_points_by_y(pts, valid)
    table = bq.pack_table(pts_s, pv_s, perm)
    assert table.shape == (2, 300, 4) and table.dtype == torch.float32
    assert torch.equal(table[..., 3].view(torch.int32), perm)
    assert torch.equal(table[..., 0], pts_s[..., 0])
    assert torch.equal(table[..., 2], pts_s[..., 2])
    assert torch.equal(table[..., 1][pv_s], pts_s[..., 1][pv_s])
    assert torch.isinf(table[..., 1][~pv_s]).all()
    assert torch.equal(pts_s, torch.gather(
        pts, 1, perm.long()[..., None].expand(-1, -1, 4)))
    y = table[..., 1]
    assert (y[:, 1:] >= y[:, :-1]).all()  # sorted, invalid rows last


def _edge_table():
    """B=2 tables for the ballot scan's edge cases, and centers."""
    rng = np.random.RandomState(1)
    n = 400
    pts = np.zeros((2, n, 3), np.float32)
    # a band of 300 points within r = 0.5 of y = 0 but 3-6 m away in x:
    # a window of ~10 steps of 32 lanes that few points pass
    pts[:, :300, 0] = rng.uniform(3.0, 6.0, (2, 300))
    pts[:, :300, 1] = rng.uniform(-0.5, 0.5, (2, 300))
    # 40 points within r of the origin center, on a few equal y values
    pts[:, 300:340, 0] = rng.uniform(-0.3, 0.3, (2, 40))
    pts[:, 300:340, 1] = rng.choice([-0.1, 0.0, 0.1], (2, 40))
    # a point exactly at d2 == r2 (0.5^2 = 0.25 in float32) of center 1
    pts[:, 340] = (10.5, 2.0, 0.0)
    # invalid rows at the origin, within r of center 0
    valid = np.ones((2, n), bool)
    valid[:, 360:] = False
    pts[:, 341:360] = rng.uniform(-20, 20, (2, 19, 3))
    centers = np.array([[0.0, 0.0, 0.0], [10.0, 2.0, 0.0], [4.5, 0.0, 0.0],
                        [0.0, 0.2, 0.0]], np.float32)
    centers = np.broadcast_to(centers, (2, 4, 3)).copy()
    cvalid = np.ones((2, 4), bool)
    cvalid[1, 3] = False
    return centers, cvalid, pts, valid


@pytest.mark.parametrize("nsample", [5, 16, 32, 64])
def test_ball_query_twin_edge_cases(nsample):
    """Against JAX: the exact-radius point is a hit, equal y values keep
    the stable order, a window spanning many steps, nsample reached in
    the middle of a step (5 of the origin's 40 hits), and invalid rows
    within r of a center are never hits."""
    centers, cvalid, pts, valid = _edge_table()
    r = 0.5
    ji, jc = jbq.ball_query_batched(
        jnp.asarray(centers), jnp.asarray(cvalid), jnp.asarray(pts),
        jnp.asarray(valid), r, nsample, impl="xla")
    ti, tc = bq.ball_query_batched(torch.from_numpy(centers),
                                   torch.from_numpy(cvalid),
                                   torch.from_numpy(pts),
                                   torch.from_numpy(valid), r, nsample)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (ti[:, 1, 0] == 340).all()  # d2 == r2 is inside
    d = pts[:, None] - centers[:, :, None]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[
        ..., 2]
    inside = ((d2 <= np.float32(0.25)) & valid[:, None] & cvalid[..., None])
    np.testing.assert_array_equal(tc.numpy(),
                                  np.minimum(inside.sum(-1), nsample))
    assert inside[:, 0].sum(-1).min() >= 40 and inside[:, 2].sum(-1).min() > 32
    for b in range(2):
        for c in range(4):  # the invalid rows at the origin are no hits
            assert (ti[b, c, :int(tc[b, c])] < 360).all()
    assert tc[1, 3] == 0 and (ti[1, 3] == ti[1, 3, 0]).all()


def test_fps_twin_edge_cases():
    """Against JAX: duplicate points far apart in the table (a tie the
    cluster exchange must break by index), and more samples than valid
    points (the distances reach 0 and the selection repeats)."""
    rng = np.random.RandomState(2)
    n = 600
    xyz = rng.uniform(-30, 30, (3, n, 3)).astype(np.float32)
    xyz[:, n - 5] = xyz[:, 3]      # duplicates far apart
    xyz[:, 450] = xyz[:, 17]
    xyz[:, 100] = (100.0, 0.0, 0.0)  # the farthest point, twice
    xyz[:, 500] = (100.0, 0.0, 0.0)
    valid = np.ones((3, n), bool)
    valid[1, 40:] = False           # 40 valid points, 64 samples
    valid[2, :] = False
    ref = np.asarray(jfps.fps_batched(jnp.asarray(xyz), jnp.asarray(valid),
                                      64, impl="xla"))
    out = fps.fps_batched(torch.from_numpy(xyz), torch.from_numpy(valid), 64)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 100 in ref[0] and 500 not in ref[0][:2]
    assert set(ref[1]) <= set(range(40)) and len(set(ref[1])) == 40
    assert (ref[2] == 0).all()
