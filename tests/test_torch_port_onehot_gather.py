"""CPU parity of the port's one-hot rulebook conv (kernel K6's plain twins
in ``detmatch_tpu_torch/ops/cuda/onehot_gather.py``) against the JAX
package's ``ops/pallas/onehot_gather.py``, run in Pallas interpret mode as
that module runs on the CPU: ``onehot_gather_conv_batched`` and
``onehot_gather_conv``, the backward's ``_scatter_all_taps`` and
``jax.grad`` through the custom VJP.

Tolerances: the forward and both gradients within 1e-5 of the reference's
largest magnitude (bf16 operands, exact products, fp32 sums in another
order); S exactly on a spconv rulebook (one writer per slot), within 1e-6
on a rulebook with repeated rows (fp32 sums of several bf16 values in
another order), hot slots of more than ``CHUNK`` writers included. The
twin's own order (the stated chunked sum) against a numpy spelling of it
bit for bit.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.ops.pallas import onehot_gather as jog  # noqa: E402
from detmatch_tpu_torch.ops import spconv, voxelize  # noqa: E402
from detmatch_tpu_torch.ops.cuda import onehot_gather, onehot_rows  # noqa: E402,E501
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

SHAPE = (6, 24, 20)
N, C, CO = 300, 8, 16


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


def rulebook(kind):
    """(B=3, M, K) int32: a submanifold conv's rulebook over 300 / 170 / 7
    valid voxels (injective per tap, -1 for absent taps and padded rows),
    or a random one with repeated rows and -1 entries."""
    if kind == "repeats":
        rng = np.random.RandomState(3)
        rb = rng.randint(-1, N, (3, 200, 27)).astype(np.int32)
        rb[2, 100:] = -1
        return torch.from_numpy(rb)
    g = torch.Generator().manual_seed(1)
    keys = []
    for n_valid in (N, 170, 7):
        kk = torch.sort(torch.randperm(int(np.prod(SHAPE)), generator=g)[
            :n_valid]).values.to(torch.int32)
        keys.append(torch.cat([kk, torch.full(
            (N - n_valid,), voxelize.INVALID_KEY, dtype=torch.int32)]))
    keys = torch.stack(keys)
    return spconv.rulebook_batched(keys, spconv.subm_neighbor_keys(keys,
                                                                   SHAPE))


def inputs(kind):
    rb = rulebook(kind)
    b, m, k = rb.shape
    rng = np.random.RandomState(2)
    feats = rng.randn(b, N, C).astype(np.float32)
    w = (rng.randn(k, C, CO) / np.sqrt(k * C)).astype(np.float32)
    dout = rng.randn(b, m, CO).astype(np.float32)
    return rb, feats, w, dout


def flat_rulebook(rb):
    """JAX's flattening of a batched rulebook (``:190-192``)."""
    b, m, k = rb.shape
    base = (np.arange(b, dtype=np.int32) * N)[:, None, None]
    rbn = rb.numpy()
    return np.where(rbn >= 0, rbn + base, -1).reshape(b * m, k).astype(
        np.int32)


@pytest.mark.parametrize("kind", ["subm", "repeats"])
def test_onehot_gather_conv_matches_jax(kind):
    """Forward, dF and dW of the twin (the wrapper on CPU tensors, through
    its ``autograd.Function``, whose backward is JAX's ``_vjp_bwd``)
    against JAX's batched conv and ``jax.grad`` of its custom VJP; no
    launch is counted."""
    rb, feats, w, dout = inputs(kind)

    def loss(f, ww):
        out = jog.onehot_gather_conv_batched(f, jnp.asarray(rb.numpy()), ww)
        return jnp.sum(out * dout), out

    (_, jout), (jf, jw) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(w))
    f_t = torch.from_numpy(feats).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    onehot_gather.onehot_gather_conv.launches = 0
    out = onehot_gather.onehot_gather_conv_batched(f_t, rb, w_t)
    pf, pw = torch.autograd.grad(out, (f_t, w_t), torch.from_numpy(dout))
    assert onehot_gather.onehot_gather_conv.launches == 0
    assert rel(out, jout) <= 1e-5
    assert rel(pf, jf) <= 1e-5
    assert rel(pw, jw) <= 1e-5
    if kind == "repeats":  # rows whose taps are all -1
        assert not out[2, 100:].any()


@pytest.mark.parametrize("kind,tol", [("subm", 0.0), ("repeats", 1e-6)])
def test_onehot_gather_scatter_matches_jax(kind, tol):
    """S of the twin against JAX's ``_scatter_all_taps`` on the flattened
    rulebook: exactly where each (tap, row) slot has at most one writer,
    within 1e-6 where rows repeat."""
    rb, _, _, dout = inputs(kind)
    rbf = flat_rulebook(rb)
    d = dout.reshape(-1, CO)
    ref = jog._scatter_all_taps(jnp.asarray(d), jnp.asarray(rbf), 3 * N)
    s = onehot_gather.onehot_gather_scatter_plain(
        torch.from_numpy(d), torch.from_numpy(rbf), 3 * N)
    assert rel(s, ref) <= tol
    k = rbf.shape[1]
    slots = [t * 3 * N + r for t in range(k) for r in rbf[:, t] if r >= 0]
    repeated = len(slots) - len(set(slots))
    assert (repeated == 0) == (kind == "subm")


def test_single_sample_conv_drops_out_of_range_rows():
    """``onehot_gather_conv`` on one sample: entries at or beyond N match
    no row in JAX's one-hot (its table is zero-padded), and none here."""
    rb, feats, w, _ = inputs("repeats")
    rb0 = rb[0].clone()
    rb0[::7, 3] = N + 5
    rb0[::11, 0] = N
    ref = jog.onehot_gather_conv(jnp.asarray(feats[0]),
                                 jnp.asarray(rb0.numpy()), jnp.asarray(w))
    out = onehot_gather.onehot_gather_conv(torch.from_numpy(feats[0]), rb0,
                                           torch.from_numpy(w))
    assert rel(out, ref) <= 1e-5
    masked = torch.where(rb0 < N, rb0, -1)
    assert torch.equal(out, onehot_gather.onehot_gather_conv(
        torch.from_numpy(feats[0]), masked, torch.from_numpy(w)))


def two_level_sum(rows, keys, slots):
    """The segment sum's stated order, spelled out in numpy: each slot's
    rows in ascending pair order, cut into chunks of ``CHUNK``; each chunk
    summed in float32 from 0, then the chunk sums in order from 0."""
    chunk = onehot_rows.CHUNK
    out = np.zeros((slots, rows.shape[1]), np.float32)
    for s in range(slots):
        mine = rows[keys == s]
        total = np.zeros(rows.shape[1], np.float32)
        for a in range(0, len(mine), chunk):
            part = np.zeros(rows.shape[1], np.float32)
            for r in mine[a:a + chunk]:
                part = part + r
            total = total + part
        out[s] = total
    return out


def hot_rulebook(n=300, m=1300, k=3, seed=6):
    """(M, K) int32 rulebook over N rows: tap 0 sends 3 * CHUNK + 17 rows
    to row 4, tap 1 exactly CHUNK rows to row 6, tap 2 CHUNK + 1 rows to
    row 9; the rest random, with -1 and out-of-range entries."""
    chunk = onehot_rows.CHUNK
    rng = np.random.RandomState(seed)
    rb = rng.randint(-1, n + 3, (m, k)).astype(np.int32)
    for tap, row, count in ((0, 4, 3 * chunk + 17), (1, 6, chunk),
                            (2, 9, chunk + 1)):
        rb[rb[:, tap] == row, tap] = -1
        rb[rng.choice(m, count, replace=False), tap] = row
    return rb


def test_scatter_twin_sums_in_chunks():
    """S of the twin follows the stated two-level order bit for bit (pair
    m * K + k reads row m): slots of 3 * CHUNK + 17, CHUNK and CHUNK + 1
    writers, single writers, -1 and out-of-range entries; slots of at most
    CHUNK writers are sequential fp32 sums."""
    n = 300
    rb = hot_rulebook(n)
    m, k = rb.shape
    dout = np.random.RandomState(7).randn(m, CO).astype(np.float32)
    s = onehot_gather.onehot_gather_scatter_plain(
        torch.from_numpy(dout), torch.from_numpy(rb), n).numpy()
    rounded = torch.from_numpy(dout).to(torch.bfloat16).float().numpy()
    rows = np.repeat(rounded, k, axis=0)
    keys = np.where((rb >= 0) & (rb < n), rb + n * np.arange(k),
                    k * n).reshape(-1)
    want = two_level_sum(rows, keys, k * n)
    np.testing.assert_array_equal(s.reshape(k * n, CO), want)
    counts = np.bincount(keys, minlength=k * n + 1)[:-1]
    chunk = onehot_rows.CHUNK
    assert counts[4] == 3 * chunk + 17 and counts[n + 6] == chunk
    assert counts[2 * n + 9] == chunk + 1 and (counts == 1).any()
    for slot in np.flatnonzero(counts <= chunk):
        seq = np.zeros(CO, np.float32)
        for r in rows[keys == slot]:
            seq = seq + r
        np.testing.assert_array_equal(s.reshape(k * n, CO)[slot], seq)


def test_scatter_twin_with_hot_slot_matches_jax():
    """S of the twin with the hot slots of ``hot_rulebook`` within 1e-6 of
    JAX's ``_scatter_all_taps``."""
    n = 300
    rb = hot_rulebook(n)
    dout = np.random.RandomState(7).randn(rb.shape[0], CO).astype(np.float32)
    ref = jog._scatter_all_taps(jnp.asarray(dout), jnp.asarray(rb), n)
    s = onehot_gather.onehot_gather_scatter_plain(
        torch.from_numpy(dout), torch.from_numpy(rb), n)
    assert rel(s, ref) <= 1e-6
