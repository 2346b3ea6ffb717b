"""CPU parity of the port's JV assignment (``detmatch_tpu_torch/ops/cuda/
hungarian.py``, the plain twin of kernel K4, and ``core/hungarian.py``)
against the JAX package's solvers: the XLA ``_solve_masked`` and the
Pallas kernel in interpret mode (``solve_masked_batched(impl=...)``).

Every output here is discrete (matchings) or a gathered input value, so
every comparison is exact equality; the optimal total cost is held to
scipy's ``linear_sum_assignment`` within 1e-4 relative (a sum of float32
costs in another order).
"""
import os
import sys

import numpy as np
import pytest
import scipy.optimize

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.core import hungarian as jhung  # noqa: E402
from detmatch_tpu.ops.pallas import hungarian as jpl  # noqa: E402
from detmatch_tpu_torch.core import hungarian  # noqa: E402
from detmatch_tpu_torch.ops import cuda as cuda_ops  # noqa: E402
from detmatch_tpu_torch.ops.cuda.hungarian import (  # noqa: E402
    inner_steps, solve_masked_batched, solve_masked_plain)
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

BIG = jhung.BIG


def _t(a):
    return torch.from_numpy(np.array(a))


def small_case(seed):
    """``tests/test_hungarian_coders_losses.py``'s Pallas-vs-XLA input:
    B=3, K=10, an exact tie row, BIG-padded columns, 10/5/1 valid rows."""
    rng = np.random.RandomState(seed)
    b, k = 3, 10
    cost = (rng.randn(b, k, k) * 2).astype(np.float32)
    cost[0, 4] = cost[0, 2]
    rv = np.arange(k)[None, :] < np.array([k, 5, 1])[:, None]
    nc = np.array([k, 7, 4])
    cost = np.where(np.arange(k)[None, None, :] < nc[:, None, None], cost,
                    BIG).astype(np.float32)
    return cost, rv


def ssl_case(seed):
    """The SSL shape, B=4, K=128: a full element with tie rows and tied
    columns, one with 50 of 90 valid columns, one with a single valid row,
    one with no valid row."""
    rng = np.random.RandomState(seed)
    b, k = 4, 128
    cost = (rng.randn(b, k, k) * 2).astype(np.float32)
    cost[0, 7] = cost[0, 3]
    cost[0, :, 9] = cost[0, :, 8]
    rv = np.arange(k)[None, :] < np.array([k, 50, 1, 0])[:, None]
    nc = np.array([k, 90, 3, k])
    cost = np.where(np.arange(k)[None, None, :] < nc[:, None, None], cost,
                    BIG).astype(np.float32)
    return cost, rv


CASES = {"small0": lambda: small_case(0), "small1": lambda: small_case(1),
         "ssl": lambda: ssl_case(2)}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_jax_solvers(case, impl):
    cost, rv = CASES[case]()
    want = np.asarray(jpl.solve_masked_batched(jnp.asarray(cost),
                                               jnp.asarray(rv), impl=impl))
    got = solve_masked_plain(_t(cost), _t(rv))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_is_the_twin_and_counts_steps():
    cost, rv = ssl_case(3)
    cuda_ops.reset_launch_counts()
    p = solve_masked_batched(_t(cost), _t(rv))
    assert cuda_ops.launch_counts()["solve_masked_batched"] == 0
    assert torch.equal(p, solve_masked_plain(_t(cost), _t(rv)))
    steps = inner_steps(_t(cost), _t(rv))
    # one step per row at least; none for the element with no valid row
    assert steps[3] == 0 and steps[2] >= 1 and steps[0] >= 128


def _mixed(seed, b, k, both_orientations=True):
    """Random costs and valid counts; ``both_orientations=False`` gives
    ``tests/test_hungarian_coders_losses.py:55-63``'s inputs exactly,
    True forces one element of each orientation."""
    rng = np.random.RandomState(seed)
    cost = (rng.randn(b, k, k) * 3).astype(np.float32)
    nr = rng.randint(0, k + 1, size=b)
    nc = rng.randint(0, k + 1, size=b)
    if both_orientations:
        nr[0], nc[0] = k, max(1, k // 2)      # rows > cols: transposed
        nr[1], nc[1] = max(1, k // 3), k      # rows < cols
    rv = np.arange(k)[None, :] < nr[:, None]
    cv = np.arange(k)[None, :] < nc[:, None]
    return cost, rv, cv


@pytest.mark.parametrize("seed,b,k,both", [
    (0, 6, 12, False), (1, 6, 12, False), (2, 6, 12, False),
    (0, 6, 12, True), (3, 4, 128, True)])
def test_assign_batched_matches_jax(seed, b, k, both):
    """Both orientations in one batch; JAX picks the Pallas kernel or the
    XLA solver by backend, and both equal the twin (above)."""
    cost, rv, cv = _mixed(seed, b, k, both)
    want_c, want_m = jax.device_get(jhung.assign_batched(
        jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv)))
    got_c, got_m = hungarian.assign_batched(_t(cost), _t(rv), _t(cv))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_m.numpy(), want_m)


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_matches_jax_and_scipy(seed):
    cost, rv, cv = _mixed(seed, 2, 12)
    for i in range(2):
        want_c, want_m = jax.device_get(jhung.assign(
            jnp.asarray(cost[i]), jnp.asarray(rv[i]), jnp.asarray(cv[i])))
        got_c, got_m = hungarian.assign(_t(cost[i]), _t(rv[i]), _t(cv[i]))
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        np.testing.assert_array_equal(got_m.numpy(), want_m)
        sub = cost[i][np.ix_(rv[i], cv[i])]
        r, c = scipy.optimize.linear_sum_assignment(sub)
        want_total = float(sub[r, c].astype(np.float64).sum())
        got = got_c.numpy()
        assert (got >= 0).sum() == len(r)
        total = float(sum(cost[i][j, got[j]] for j in np.nonzero(got >= 0)[0]))
        assert abs(total - want_total) <= 1e-4 * max(1.0, abs(want_total))


def test_assign_batched_optimal_at_ssl_shape():
    """B=4, K=128 against scipy's optimum on each valid submatrix."""
    cost, rv, cv = _mixed(4, 4, 128)
    got_c, _ = hungarian.assign_batched(_t(cost), _t(rv), _t(cv))
    for i in range(4):
        sub = cost[i][np.ix_(rv[i], cv[i])].astype(np.float64)
        r, c = scipy.optimize.linear_sum_assignment(sub)
        g = got_c[i].numpy()
        rows = np.nonzero(g >= 0)[0]
        assert len(rows) == len(r)
        total = cost[i][rows, g[rows]].astype(np.float64).sum()
        assert abs(total - sub[r, c].sum()) <= 1e-4 * max(
            1.0, abs(sub[r, c].sum()))
