"""CPU parity of the port's one-hot row gather (kernel K8's plain twins in
``detmatch_tpu_torch/ops/cuda/onehot_rows.py``) against the JAX package's
``ops/pallas/onehot_rows.py``, run in Pallas interpret mode as that module
runs on the CPU (as ``tests/test_extra_ops.py`` runs it):
``onehot_take_rows`` and ``onehot_take_rows_batched``, forward and
``jax.grad`` through their custom VJPs.

Tolerances: the forward exactly (bf16(x) at the one matching row, zero for
-1 and for indices at or beyond N); the backward within 1e-5 of the
reference's largest magnitude (fp32 sums of repeated bf16 rows in another
order), hot slots of more than ``CHUNK`` repeats included. The twin's own
order (the stated chunked sum) against a numpy spelling of it bit for
bit.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.ops.pallas import onehot_rows as jrows  # noqa: E402
from detmatch_tpu_torch.ops.cuda import onehot_rows  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


def case(b, n=40, c=8, q=300, seed=1):
    """(x (B, N, C), idx (B, Q) with many repeats, -1 entries and entries
    at N and beyond, dout (B, Q, C))."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n, (b, q)).astype(np.int32)
    idx[:, ::13] = -1
    idx[:, 5::17] = n
    idx[:, 7::19] = n + 600  # beyond JAX's zero-padded table
    dout = rng.randn(b, q, c).astype(np.float32)
    return x, idx, dout


@pytest.mark.parametrize("batched", [False, True])
def test_onehot_take_rows_matches_jax(batched):
    """Forward exactly, and the gradient of a linear loss within 1e-5;
    no launch is counted on CPU tensors."""
    x, idx, dout = case(3)
    if not batched:
        x, idx, dout = x[0], idx[0], dout[0]
    jfn = jrows.onehot_take_rows_batched if batched else jrows.onehot_take_rows
    fn = (onehot_rows.onehot_take_rows_batched if batched
          else onehot_rows.onehot_take_rows)

    def loss(xx):
        out = jfn(xx, jnp.asarray(idx))
        return jnp.vdot(out, dout), out

    (_, jout), jg = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    x_t = torch.from_numpy(x).requires_grad_()
    onehot_rows.onehot_take_rows_batched.launches = 0
    onehot_rows.onehot_scatter_rows.launches = 0
    out = fn(x_t, torch.from_numpy(idx))
    (g,) = torch.autograd.grad(out, (x_t,), torch.from_numpy(dout))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    assert rel(g, jg) <= 1e-5
    assert (onehot_rows.onehot_take_rows_batched.launches
            + onehot_rows.onehot_scatter_rows.launches) == 0
    bad = (idx < 0) | (idx >= x.shape[-2])
    assert bad.any() and not out.detach().numpy()[bad].any()


def test_scatter_rows_sums_repeats_in_order():
    """The twins: the gather is ``bf16(x)[idx]``; the scatter adds the
    bf16-rounded rows of repeated indices in ascending q order (the order
    the kernel sums in), so it equals a sequential fp32 sum exactly, and
    drops out-of-range indices."""
    x, idx, dout = case(2, n=10, q=200, seed=4)
    xt, it, dt = map(torch.from_numpy, (x, idx, dout))
    rounded = dt.to(torch.bfloat16).float()
    ref = torch.zeros(2, 10, x.shape[-1])
    for b in range(2):
        for q in range(200):
            if 0 <= idx[b, q] < 10:
                ref[b, idx[b, q]] += rounded[b, q]
    assert torch.equal(onehot_rows.scatter_rows_plain(dt, it, 10), ref)
    got = onehot_rows.take_rows_plain(xt, it)
    ok = (it >= 0) & (it < 10)
    want = xt.to(torch.bfloat16).float()[
        torch.arange(2)[:, None], torch.where(ok, it, 0).long()]
    assert torch.equal(got, torch.where(ok[..., None], want, 0.0))


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


def hot_case(n=12, c=8, seed=5):
    """(x (2, N, C), idx (2, Q), dout (2, Q, C)): in sample 0, index 3
    repeated 3 * CHUNK + 17 times, index 5 exactly CHUNK times, index 7
    CHUNK + 1 times, indices 0 and 1 once, and -1, N and N + 600 entries,
    shuffled; sample 1 random with out-of-range entries."""
    chunk = onehot_rows.CHUNK
    rng = np.random.RandomState(seed)
    row0 = np.concatenate([
        np.full(3 * chunk + 17, 3), np.full(chunk, 5), np.full(chunk + 1, 7),
        [0, 1], np.full(40, -1), np.full(30, n), np.full(20, n + 600)])
    rng.shuffle(row0)
    q = row0.size
    idx = np.stack([row0, rng.randint(-1, n + 2, q)]).astype(np.int32)
    x = rng.randn(2, n, c).astype(np.float32)
    dout = rng.randn(2, q, c).astype(np.float32)
    return x, idx, dout


def test_scatter_rows_twin_sums_in_chunks():
    """The scatter twin follows the stated two-level order bit for bit: a
    slot of 3 * CHUNK + 17 repeats, slots of exactly CHUNK and CHUNK + 1,
    single writers, empty slots and dropped entries; slots of at most
    CHUNK pairs equal the sequential fp32 sum exactly."""
    x, idx, dout = hot_case()
    n, c = x.shape[1], x.shape[2]
    got = onehot_rows.scatter_rows_plain(torch.from_numpy(dout),
                                         torch.from_numpy(idx), n).numpy()
    rounded = torch.from_numpy(dout).to(torch.bfloat16).float().numpy()
    keys = np.where((idx >= 0) & (idx < n), idx + n * np.arange(2)[:, None],
                    2 * n).reshape(-1)
    want = two_level_sum(rounded.reshape(-1, c), keys, 2 * n)
    np.testing.assert_array_equal(got.reshape(2 * n, c), want)
    counts = np.bincount(keys, minlength=2 * n + 1)[:-1]
    assert counts[3] == 3 * onehot_rows.CHUNK + 17 and counts[0] == 1
    for s in np.flatnonzero(counts <= onehot_rows.CHUNK):
        seq = np.zeros(c, np.float32)
        for r in rounded.reshape(-1, c)[keys == s]:
            seq = seq + r
        np.testing.assert_array_equal(got.reshape(2 * n, c)[s], seq)


def test_scatter_rows_twin_with_hot_slot_matches_jax():
    """The gradient of ``onehot_take_rows_batched`` with the hot slots of
    ``hot_case`` (Q = 1,450) within 1e-5 of JAX's Pallas module."""
    x, idx, dout = hot_case()

    def loss(xx):
        return jnp.vdot(jrows.onehot_take_rows_batched(xx, jnp.asarray(idx)),
                        dout)

    jg = jax.grad(loss)(jnp.asarray(x))
    x_t = torch.from_numpy(x).requires_grad_()
    out = onehot_rows.onehot_take_rows_batched(x_t, torch.from_numpy(idx))
    (g,) = torch.autograd.grad(out, (x_t,), torch.from_numpy(dout))
    assert rel(g, jg) <= 1e-5
