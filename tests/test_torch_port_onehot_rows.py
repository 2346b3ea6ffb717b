"""CPU parity of the port's one-hot row gather (kernel K8's plain twins in
``detmatch_tpu_torch/ops/cuda/onehot_rows.py``) against the JAX package's
``ops/pallas/onehot_rows.py``, run in Pallas interpret mode as that module
runs on the CPU (as ``tests/test_extra_ops.py`` runs it):
``onehot_take_rows`` and ``onehot_take_rows_batched``, forward and
``jax.grad`` through their custom VJPs.

Tolerances: the forward exactly (bf16(x) at the one matching row, zero for
-1 and for indices at or beyond N); the backward within 1e-5 of the
reference's largest magnitude (fp32 sums of repeated bf16 rows in another
order).
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
