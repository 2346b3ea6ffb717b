"""CPU parity of the port's ops (``detmatch_tpu_torch/ops``) against the
JAX package: voxelization, the sparse-conv key machinery, the plain
sparse conv, FPS and ball query — the plain PyTorch twins of the CUDA
kernels. Inputs come from numpy with fixed seeds; discrete outputs must
be exactly equal, continuous ones within the stated tolerance."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.ops import spconv as jspconv  # noqa: E402
from detmatch_tpu.ops import voxelize as jvox  # noqa: E402
from detmatch_tpu.ops.pallas import ball_query as jbq  # noqa: E402
from detmatch_tpu.ops.pallas import fps as jfps  # noqa: E402
from detmatch_tpu.ops.pallas import window_key_conv as jwkc  # noqa: E402
from detmatch_tpu.utils.synth_kitti import lidar_batch  # noqa: E402
from detmatch_tpu_torch.ops import spconv, voxelize  # noqa: E402
from detmatch_tpu_torch.ops.cuda import ball_query, fps  # noqa: E402
from detmatch_tpu_torch.ops.cuda import window_key_conv  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

PCR = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
VOXEL = (0.25, 0.25, 0.2)
CAP = 1024
CONV_RTOL = 1e-5  # fp32, different summation order


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """B=3 synthetic frames with uneven valid counts; voxelized by JAX."""
    rng = np.random.RandomState(0)
    pts, valid = lidar_batch(rng, 3, 2048, PCR)
    valid[1, 1500:] = False
    valid[2, 600:] = False
    spec = jvox.VoxelizerSpec(PCR, VOXEL, CAP, 5)
    vox = jax.vmap(lambda p, v: jvox.voxelize_mean(p, v, spec))(
        jnp.asarray(pts), jnp.asarray(valid))
    return dict(pts=pts, valid=valid, spec=spec,
                vox={k: np.asarray(v) for k, v in vox.items()})


def test_voxelize_mean_parity(scene):
    spec = voxelize.VoxelizerSpec(PCR, VOXEL, CAP, 5)
    assert spec.spatial_shape == scene["spec"].spatial_shape
    out = voxelize.voxelize_mean(_t(scene["pts"]), _t(scene["valid"]), spec)
    ref = scene["vox"]
    for k in ("coords", "keys", "num_voxels", "num_dropped_voxels"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(out["features"].numpy(), ref["features"],
                               rtol=0, atol=1e-6)
    # the cap binds on the full frame and not on the short one
    assert ref["num_dropped_voxels"][0] > 0
    assert ref["num_dropped_voxels"][2] == 0


GEOMETRIES = {
    "subm": None,
    "down_s2_p1": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    "down_s2_p011": ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    "zcompress": ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
}


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_spconv_key_machinery_parity(scene, geom):
    """Neighbour keys, downsampled key sets (with truncation at the cap)
    and the per-sample lookup, exactly."""
    shape = scene["spec"].spatial_shape
    jk = jnp.asarray(scene["vox"]["keys"])
    tk = _t(scene["vox"]["keys"])
    if GEOMETRIES[geom] is None:
        jn = jspconv.subm_neighbor_keys(jk, shape)
        tn = spconv.subm_neighbor_keys(tk, shape)
        jtable, ttable = jk, tk
    else:
        kernel, stride, pad = GEOMETRIES[geom]
        out_shape = jspconv.output_spatial_shape(shape, kernel, stride, pad)
        assert spconv.output_spatial_shape(shape, kernel, stride,
                                           pad) == out_shape
        cap = 600  # below the full frame's output count: truncation
        jo, jc = jspconv.downsample_keys_batched(jk, shape, out_shape,
                                                 kernel, stride, pad, cap)
        to, tc = spconv.downsample_keys_batched(tk, shape, out_shape,
                                                kernel, stride, pad, cap)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert int(np.asarray(jc).max()) == cap
        jn = jspconv.sparse_neighbor_keys(jo, shape, out_shape, kernel,
                                          stride, pad)
        tn = spconv.sparse_neighbor_keys(to, shape, out_shape, kernel,
                                         stride, pad)
        jtable, ttable = jk, tk
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    b, m, k = tn.shape
    band = int(np.prod(shape)) + 2
    jrb = jspconv.lookup_batched(jtable, jn.reshape(b, m * k), band=band)
    trb = spconv.lookup_batched(ttable, tn.reshape(b, m * k))
    np.testing.assert_array_equal(trb.numpy(), np.asarray(jrb))
    assert (trb >= 0).any()


@pytest.mark.parametrize("geom", ["subm", "down_s2_p1"])
def test_plain_sparse_conv_parity(scene, geom):
    """The K1 wrapper's CPU path against the XLA rulebook gather-GEMM
    (the JAX path off the TPU), B=3 with uneven padding."""
    rng = np.random.RandomState(1)
    shape = scene["spec"].spatial_shape
    jk = jnp.asarray(scene["vox"]["keys"])
    feats = rng.randn(3, CAP, 16).astype(np.float32)
    feats[scene["vox"]["keys"] == voxelize.INVALID_KEY] = 0.0
    if geom == "subm":
        jn, out_keys = jspconv.subm_neighbor_keys(jk, shape), jk
    else:
        kernel, stride, pad = GEOMETRIES[geom]
        out_shape = jspconv.output_spatial_shape(shape, kernel, stride, pad)
        out_keys, _ = jspconv.downsample_keys_batched(
            jk, shape, out_shape, kernel, stride, pad, 800)
        jn = jspconv.sparse_neighbor_keys(out_keys, shape, out_shape, kernel,
                                          stride, pad)
    w = rng.randn(27, 16, 32).astype(np.float32)
    b, m, k = jn.shape
    rb = jspconv.lookup_batched(jk, jn.reshape(b, m * k),
                                band=int(np.prod(shape)) + 2)
    ref = np.asarray(jspconv.gather_conv_batched(
        jnp.asarray(feats), rb.reshape(b, m, k), jnp.asarray(w)))
    out = window_key_conv.window_key_conv_batched(
        _t(feats), _t(scene["vox"]["keys"]), _t(jn), _t(out_keys), _t(w),
        int(np.prod(shape)) + 1)
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err <= CONV_RTOL, err


def test_plain_sparse_conv_band_guard():
    """B * band must stay below 2^31 (KITTI: band 92,364,801 → B <= 23)."""
    band = 41 * 1600 * 1408 + 1
    feats = torch.zeros(24, 4, 4)
    keys = torch.full((24, 4), voxelize.INVALID_KEY, dtype=torch.int32)
    nkeys = torch.full((24, 4, 27), voxelize.INVALID_KEY, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        window_key_conv.window_key_conv_batched(
            feats, keys, nkeys, keys, torch.zeros(27, 4, 8), band)
    out = window_key_conv.window_key_conv_batched(
        feats[:23], keys[:23], nkeys[:23], keys[:23], torch.zeros(27, 4, 8),
        band)
    assert out.shape == (23, 4, 8) and not out.any()


@pytest.fixture(scope="module")
def points():
    """B=3 clouds: one full, one short, one all-invalid."""
    rng = np.random.RandomState(2)
    pts, valid = lidar_batch(rng, 3, 1024, PCR)
    valid[1, 300:] = False
    valid[2] = False
    return pts[..., :3].copy(), valid


def test_plain_fps_parity(points):
    xyz, valid = points
    ref = np.asarray(jfps.fps_batched(jnp.asarray(xyz), jnp.asarray(valid),
                                      128, impl="xla"))
    out = fps.fps_batched(_t(xyz), _t(valid), 128)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[2] == 0).all()  # all-invalid row
    assert valid[1][out[1].numpy()].all()


@pytest.mark.parametrize("radius,nsample", [(0.4, 16), (0.8, 4), (2.4, 32)])
def test_plain_ball_query_parity(points, radius, nsample):
    """Against the JAX XLA path: overflowing balls (nsample 4), empty
    balls (centers far away) and invalid centers included."""
    xyz, valid = points
    rng = np.random.RandomState(3)
    kp = xyz[:, rng.randint(0, 300, 64)]
    kp[:, :8] += 100.0  # empty balls
    kv = np.ones((3, 64), bool)
    kv[:, 60:] = False  # invalid centers
    ji, jc = jbq.ball_query_batched(jnp.asarray(kp), jnp.asarray(kv),
                                    jnp.asarray(xyz), jnp.asarray(valid),
                                    radius, nsample, impl="xla")
    ti, tc = ball_query.ball_query_batched(_t(kp), _t(kv), _t(xyz),
                                           _t(valid), radius, nsample)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tc[:, :8] == 0).all() and (tc[0, 8:60] > 0).any()
    if nsample == 4:
        assert (tc == nsample).any()  # overflow capped
    # empty balls map sorted position 0 through the permutation
    _, _, perm = ball_query.sort_points_by_y(_t(xyz), _t(valid))
    assert (ti[:, :8] == perm[:, None, None, 0]).all()
    # the pre-sorted path gives the same indices
    pts_s, pv_s, perm = ball_query.sort_points_by_y(_t(xyz), _t(valid))
    ti2, tc2 = ball_query.ball_query_batched(_t(kp), _t(kv), pts_s, pv_s,
                                             radius, nsample,
                                             point_perm=perm)
    assert torch.equal(ti2, ti) and torch.equal(tc2, tc)


def test_pallas_interpret_tiny():
    """One tiny case through the JAX Pallas kernels in interpret mode, as
    the JAX package's own tests run them off the TPU. The window conv
    kernel rounds to bf16 (window_key_conv.py:103-111), so its tolerance
    is bf16's; B=1, where its flattened key table is sorted."""
    rng = np.random.RandomState(4)
    xyz = rng.uniform(-4, 4, (2, 200, 3)).astype(np.float32)
    valid = np.ones((2, 200), bool)
    valid[1, 150:] = False
    ref = np.asarray(jfps.fps_batched(jnp.asarray(xyz), jnp.asarray(valid),
                                      16, impl="pallas"))
    np.testing.assert_array_equal(
        fps.fps_batched(_t(xyz), _t(valid), 16).numpy(), ref)
    kp = xyz[:, :24].copy()
    kv = np.ones((2, 24), bool)
    ji, jc = jbq.ball_query_batched(jnp.asarray(kp), jnp.asarray(kv),
                                    jnp.asarray(xyz), jnp.asarray(valid),
                                    1.2, 8, impl="pallas")
    ti, tc = ball_query.ball_query_batched(_t(kp), _t(kv), _t(xyz),
                                           _t(valid), 1.2, 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    shape = (5, 16, 16)
    keys = np.sort(rng.choice(np.prod(shape), 150, replace=False)
                   ).astype(np.int32)[None]
    keys = np.concatenate(
        [keys, np.full((1, 10), voxelize.INVALID_KEY, np.int32)], 1)
    feats = rng.randn(1, 160, 8).astype(np.float32)
    feats[:, 150:] = 0
    w = (rng.randn(27, 8, 16) * 0.2).astype(np.float32)
    nk = jspconv.subm_neighbor_keys(jnp.asarray(keys), shape)
    band = int(np.prod(shape)) + 1
    ref = np.asarray(jwkc.window_key_conv_batched(
        jnp.asarray(feats), jnp.asarray(keys), nk, jnp.asarray(keys),
        jnp.asarray(w), band))
    out = window_key_conv.window_key_conv_batched(
        _t(feats), _t(keys), _t(nk), _t(keys), _t(w), band).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())
