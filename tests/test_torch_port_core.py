"""CPU parity of the port's box math (``detmatch_tpu_torch/core``) against
the JAX package: geometry, the residual decode, rotated IoU with
``quantize``, and NMS keeps. Inputs from numpy with fixed seeds."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.core import coders as jcoders  # noqa: E402
from detmatch_tpu.core import geometry as jgeo  # noqa: E402
from detmatch_tpu.core import iou as jiou  # noqa: E402
from detmatch_tpu.core import nms as jnms  # noqa: E402
from detmatch_tpu_torch.core import coders, geometry, iou, nms  # noqa: E402

ATOL = 1e-5  # fp32 trig / products in another operation order


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, n, spread=20.0):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_geometry_parity():
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, 64)
    vals = rng.uniform(-10, 10, 256).astype(np.float32)
    for offset, period in ((0.5, np.pi), (0.0, 2 * np.pi), (0.0, np.pi)):
        np.testing.assert_allclose(
            geometry.limit_period(_t(vals), offset, period).numpy(),
            np.asarray(jgeo.limit_period(jnp.asarray(vals), offset, period)),
            rtol=0, atol=ATOL)
    pts = rng.randn(8, 16, 5).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 8).astype(np.float32)
    np.testing.assert_allclose(
        geometry.rotate_points_z(_t(pts), _t(ang)).numpy(),
        np.asarray(jgeo.rotate_points_z(jnp.asarray(pts), jnp.asarray(ang))),
        rtol=0, atol=ATOL)
    for b in (boxes, jgeo.boxes_to_bev(boxes)):
        np.testing.assert_allclose(
            geometry.boxes_to_corners_bev(_t(b)).numpy(),
            np.asarray(jgeo.boxes_to_corners_bev(jnp.asarray(b))),
            rtol=0, atol=ATOL)
    np.testing.assert_array_equal(geometry.boxes_to_bev(_t(boxes)).numpy(),
                                  jgeo.boxes_to_bev(boxes))


def test_residual_decode_parity():
    rng = np.random.RandomState(1)
    anchors = _boxes(rng, 128)
    enc = (rng.randn(128, 7) * 0.3).astype(np.float32)
    ref = np.asarray(jcoders.ResidualCoder().decode(jnp.asarray(enc),
                                                    jnp.asarray(anchors)))
    out = coders.ResidualCoder().decode(_t(enc), _t(anchors)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=ATOL)


def test_rotated_iou_and_quantize_parity():
    """Random overlapping boxes plus degenerate cases: identical boxes,
    a box nested in another, shared edges, axis-aligned pairs."""
    rng = np.random.RandomState(2)
    b1 = jgeo.boxes_to_bev(_boxes(rng, 48, spread=3.0))
    b2 = jgeo.boxes_to_bev(_boxes(rng, 40, spread=3.0))
    special = np.asarray([[0, 0, 2, 2, 0], [0, 0, 2, 2, 0],
                          [0, 0, 1, 1, 0.3], [1, 0, 2, 2, 0],
                          [0, 0, 4, 1, np.pi / 2], [0, 0, 1, 4, 0]],
                         np.float32)
    b1 = np.concatenate([b1, special])
    b2 = np.concatenate([b2, special])
    ref = np.asarray(jiou.rotated_iou_bev(jnp.asarray(b1), jnp.asarray(b2)))
    out = iou.rotated_iou_bev(_t(b1), _t(b2)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    assert (ref > 0).mean() > 0.1
    np.testing.assert_allclose(np.diag(out[-6:, -6:]), 1.0, atol=1e-5)
    # quantize is exact on identical inputs
    np.testing.assert_array_equal(
        iou.quantize(_t(ref)).numpy(), np.asarray(jiou.quantize(
            jnp.asarray(ref))))


@pytest.mark.parametrize("thr,max_out,n_pad", [(0.1, 40, 0), (0.7, 16, 12),
                                               (0.5, 200, 30)])
def test_nms_bev_keeps_parity(thr, max_out, n_pad):
    """Same kept indices and validity as the JAX greedy NMS, with
    NEG_INF-padded scores and max_out above and below the keep count."""
    rng = np.random.RandomState(3)
    n = 120
    boxes = _boxes(rng, n, spread=6.0)
    scores = rng.rand(n).astype(np.float32)
    scores[n - n_pad:] = jnms.NEG_INF
    scores[10:14] = scores[3]  # ties resolve by index
    ri, rv = jnms.nms_bev(jnp.asarray(boxes), jnp.asarray(scores), thr,
                          max_out)
    ti, tv = nms.nms_bev(_t(boxes), _t(scores), thr, max_out)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    assert 0 < int(tv.sum()) <= max_out
    mat = nms.iou_matrix_bev(geometry.boxes_to_bev(_t(boxes)))
    ref = np.asarray(jnms.iou_matrix_bev(jgeo.boxes_to_bev(boxes)))
    np.testing.assert_allclose(mat.numpy(), ref, rtol=0, atol=ATOL)
