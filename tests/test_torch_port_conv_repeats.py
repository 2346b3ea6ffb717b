"""CPU parity of the port's sparse convs against the JAX package where
they are easiest to get wrong: neighbour keys that repeat within a tap
(several output rows of one tap read one input row; no conv of a model
has them, the public ops ``key_conv_batched`` and
``window_key_conv_batched`` take them, and JAX sums every such writer in
the backward), and channel counts off the kernels' 4-wide vectors or at
the 128 that UNet's ``_m`` convs need.

References: the key conv (K5) against JAX's ``key_conv_batched`` and its
custom VJP, its Pallas kernels in interpret mode as the JAX tests run
them off the TPU; the window conv (K1, fp32) against JAX's fp32 rulebook
conv (``spconv.gather_conv_batched`` on ``lookup_batched``'s rulebook,
differentiated by ``jax.grad``), which is what JAX's backbone runs for
it off the TPU (JAX's Pallas window kernel rounds its products to bf16,
so only its fp32 path can hold 1e-5; ``tests/test_window_conv.py`` holds
the two together); K7's twin against JAX's ``pallas_gather_conv``
(interpret mode) and, for its gradients, the same fp32 rulebook conv.

Tolerances: 1e-5 of each reference tensor's largest magnitude (fp32
sums in another order). ``tests/test_torch_port_k5k7.py`` holds the twin
of K5's S to its stated order bit for bit.
"""
import functools
import sys
import types
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from detmatch_tpu.ops import spconv as jspconv  # noqa: E402
from detmatch_tpu.ops.pallas import onehot_key_conv as jkey  # noqa: E402
from detmatch_tpu.ops.pallas import spconv_kernel as jkernel  # noqa: E402
from detmatch_tpu_torch.ops import spconv  # noqa: E402
from detmatch_tpu_torch.ops.cuda import KERNELS, gather_conv  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

SHAPE = (4, 10, 10)
BAND = int(np.prod(SHAPE)) + 1
RTOL = 1e-5


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


def make_case(c, co, n, repeats=False, seed=11):
    """B=2 samples of n sorted keys each (full tables: JAX's window kernel
    needs its flattened table sorted), their submanifold neighbour keys,
    and seeded features, weights and cotangent (numpy float32). With
    ``repeats``, tap 4 of rows 3j and 3j + 1 reads voxel 3j (two writers
    a slot) and tap 22 of every row reads the sample's 6th voxel (one
    slot, n writers)."""
    rng = np.random.RandomState(seed)
    keys = np.stack([np.sort(rng.choice(BAND - 1, n, replace=False))
                     for _ in range(2)]).astype(np.int32)
    nk = spconv.subm_neighbor_keys(torch.from_numpy(keys), SHAPE).numpy()
    nk = nk.copy()
    if repeats:
        nk[:, 0::3, 4] = keys[:, 0::3]
        nk[:, 1::3, 4] = keys[:, 0::3][:, :nk[:, 1::3].shape[1]]
        nk[:, :, 22] = keys[:, 5:6]
    k = nk.shape[-1]
    feats = rng.randn(2, n, c).astype(np.float32)
    w = (rng.randn(k, c, co) / np.sqrt(k * c)).astype(np.float32)
    dout = rng.randn(2, n, co).astype(np.float32)
    return keys, nk, feats, w, dout


def port_grads(fn, feats, w, dout, *extra):
    """fn(feats, *extra, w)'s output and (dF, dW) through the port's
    autograd."""
    f = torch.from_numpy(feats).requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    out = fn(f, *extra, ww)
    df, dw = torch.autograd.grad(out, (f, ww), torch.from_numpy(dout))
    return out, df, dw


def jax_grads(fn, feats, w, dout):
    """fn(f, w)'s output and (dF, dW) by ``jax.value_and_grad``."""
    def loss(f, ww):
        out = fn(f, ww)
        return jnp.sum(out * dout), out

    (_, out), (df, dw) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(w))
    return out, df, dw


def jax_rulebook(keys, nk):
    b, m, k = nk.shape
    return jspconv.lookup_batched(jnp.asarray(keys), jnp.asarray(
        nk.reshape(b, m * k)), band=BAND + 1).reshape(b, m, k)


def jax_fp32_conv(keys, nk):
    rb = jax_rulebook(keys, nk)
    return lambda f, w: jspconv.gather_conv_batched(f, rb, w)


def jax_key_conv(keys, nk):
    return lambda f, w: jkey.key_conv_batched(
        f, jnp.asarray(keys), jnp.asarray(nk), w, BAND)


def window(f, keys, nk, w):
    return KERNELS.window_key_conv_batched(f, keys, nk, keys, w, BAND)


def key(f, keys, nk, w):
    return KERNELS.key_conv_batched(f, keys, nk, w, BAND)


N = 48  # voxels a sample


@pytest.fixture(scope="module")
def refs():
    """get(c, co): the repeating case at C, Co (``make_case``) and JAX's
    key conv and fp32 rulebook conv on it (output, dF, dW), computed once
    a module for each channel pair."""
    cache = {}

    def get(c, co):
        if (c, co) not in cache:
            case = make_case(c, co, n=N, repeats=True, seed=c * co)
            keys, nk, feats, w, dout = case
            jargs = (feats, w, dout)
            cache[c, co] = dict(
                case=case, key=jax_grads(jax_key_conv(keys, nk), *jargs),
                fp32=jax_grads(jax_fp32_conv(keys, nk), *jargs))
        return cache[c, co]
    return get


@pytest.fixture(scope="module")
def repeats(refs):
    """The repeating case at C = 5, Co = 16: 15 slots a sample with two
    writers and one with N."""
    out = refs(5, 16)
    keys, nk = out["case"][:2]
    rb = spconv.rulebook_batched(torch.from_numpy(keys), torch.from_numpy(nk))
    slots = (torch.arange(27) * 2 * N + (torch.arange(2) * N)[:, None, None]
             + rb)[rb >= 0]
    counts = torch.bincount(slots)
    assert int(counts.max()) == N  # the hot slot
    assert int((counts == 2).sum()) >= 2 * 15
    return out


def test_key_conv_sums_repeated_writers_as_jax(repeats):
    """``key_conv_batched`` (the twins on the CPU: S summed over every
    writer of a slot, then JAX's _vjp_bwd einsums) against JAX's key conv
    on repeating neighbour keys: output, dF and dW within 1e-5."""
    keys, nk, feats, w, dout = repeats["case"]
    got = port_grads(key, feats, w, dout, torch.from_numpy(keys),
                     torch.from_numpy(nk))
    for name, a, r in zip(("out", "dF", "dW"), got, repeats["key"]):
        assert rel(a, r) <= RTOL, name


def test_window_conv_sums_repeated_writers_as_jax(repeats):
    """``window_key_conv_batched`` (its twin on the CPU) on repeating
    neighbour keys: output, dF and dW within 1e-5 of JAX's fp32 rulebook
    conv, which sums every writer of a slot (the hot slot has 64)."""
    keys, nk, feats, w, dout = repeats["case"]
    got = port_grads(window, feats, w, dout, torch.from_numpy(keys),
                     torch.from_numpy(nk))
    for name, a, r in zip(("out", "dF", "dW"), got, repeats["fp32"]):
        assert rel(a, r) <= RTOL, name


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's ``pallas_gather_conv`` body, unjitted, with its
    ``pallas_call`` in interpret mode (off the TPU it refuses to
    compile)."""
    monkeypatch.setattr(jkernel, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    return jkernel.pallas_gather_conv.__wrapped__


@pytest.mark.parametrize("c,co", [(3, 5), (5, 16), (128, 128)])
def test_convs_take_any_channel_count(refs, pallas_interpret, c, co):
    """K5's and K1's ops and K7's twin at C, Co off the 4-wide vectors and
    at 128, 128 (UNet's ``_m`` convs), with repeats: each output and its
    dF and dW within 1e-5 of JAX's (K5: JAX's key conv; K1 and K7's
    gradients: the fp32 rulebook conv; K7's output: JAX's Pallas
    ``pallas_gather_conv``)."""
    ref = refs(c, co)
    keys, nk, feats, w, dout = ref["case"]
    kt, nt = torch.from_numpy(keys), torch.from_numpy(nk)
    rb = spconv.rulebook_batched(kt, nt)
    for label, fn, extra, want in (
            ("K5", key, (kt, nt), ref["key"]),
            ("K1", window, (kt, nt), ref["fp32"]),
            ("K7", gather_conv.gather_conv_batched, (rb,), ref["fp32"])):
        got = port_grads(fn, feats, w, dout, *extra)
        for name, a, r in zip(("out", "dF", "dW"), got, want):
            assert rel(a, r) <= RTOL, (label, name)
    want = np.stack([np.asarray(pallas_interpret(
        jnp.asarray(feats[i]), jnp.asarray(rb[i].numpy()), jnp.asarray(w),
        tile=64)) for i in range(2)])
    k7 = gather_conv.gather_conv_batched(torch.from_numpy(feats), rb,
                                         torch.from_numpy(w))
    assert rel(k7, want) <= RTOL
    assert gather_conv.gather_conv_batched.launches == 0
