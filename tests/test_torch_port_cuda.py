"""The port's CUDA kernels against their plain twins on the card, at edge
cases the main path does not reach (all-invalid rows, empty balls, the
size limits, argument checks).

Needs a CUDA card: every test is marked ``cuda`` and skips without one.
This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from detmatch_tpu_torch.ops import spconv, voxelize  # noqa: E402
from detmatch_tpu_torch.ops.cuda import ball_query, fps  # noqa: E402
from detmatch_tpu_torch.ops.cuda import window_key_conv  # noqa: E402

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
    """Odd sizes, the 18,432-point limit, and more samples than valid
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
    with pytest.raises(ValueError):  # C = 65 above the kernel's limit
        window_key_conv.window_key_conv_batched(
            torch.zeros(1, 4, 65, device=dev), keys, nkeys, keys,
            torch.zeros(27, 65, 8, device=dev), 100)
