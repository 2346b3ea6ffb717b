"""Fold batch-norm statistics into the preceding convolutions of a
checkpoint (counterpart of ``tools/misc/fuse_conv_bn.py``), by JAX's
formula and on JAX's pairs, structure kept:

    weight' = weight * (gamma / sqrt(var + eps))     (per out channel)
    BN'     = identity carrying the shift: gamma 1, mean 0, var 1 - eps,
              beta = beta - mean * gamma / sqrt(var + eps)

so ``BN'(conv'(x)) == BN(conv(x))`` up to float32 rounding, and the model
loads the folded state dict unchanged. BN' still runs: with the
structure kept, the fold saves no kernel at inference (``chip_smoke.py``
times ``detect`` before and after it).

The pairs are those JAX folds, a conv without bias (a weight of three or
more dimensions) and its trainable batch norm (running statistics and
``num_batches_tracked``; a frozen one has none) — in the port's names:

* inside a BaseBEVBackbone's ``blocks.<i>`` / ``deblocks.<i>``
  sequences, each batch norm with the conv just before it (JAX's
  ``ConvBNReLU`` blocks; a deblock's transposed-conv weight keeps its
  out channels on axis 1);
* elsewhere, a module whose children hold exactly one such conv and one
  such batch norm, both named (JAX's sibling rule: CaDDN's ``collapse``
  and ``ddn.channel_reduce`` / ``channel_reduce_bn``, Part-A2's RoI
  convs). The 1 x 1 convs and linear layers of the point-wise MLPs sit
  in numbered sequences, JAX's ``Dense`` layers, and are not folded.

Usage:
    python -m detmatch_tpu_torch.tools.misc.fuse_conv_bn CKPT_DIR OUT_DIR
        [--eps 1e-5]

The newest ``ckpt_<n>`` under ``CKPT_DIR`` is read; its model state dicts
(``model``, or an SSL run's ``state``) are folded; the result goes to
``OUT_DIR/ckpt_<n>``.
"""
from __future__ import annotations

import argparse
import re

import torch

EPS = 1e-5
_BEV_SEQ = re.compile(r"(^|\.)(blocks|deblocks)\.\d+$")


def _batch_norms(sd):
    return {k[:-len(".running_mean")] for k in sd
            if k.endswith(".running_mean")
            and k[:-len("running_mean")] + "num_batches_tracked" in sd}


def _is_conv(sd, key, bns):
    w = sd.get(key + ".weight")
    return (key not in bns and w is not None and w.dim() >= 3
            and key + ".bias" not in sd)


def conv_bn_pairs(sd):
    """[(conv key, batch-norm key, out-channel axis)] of ``sd``'s pairs."""
    bns = _batch_norms(sd)
    children = {}
    for k in sd:
        parent, _, rest = k.rpartition(".")
        mod, _, child = parent.rpartition(".")
        children.setdefault(mod, set()).add(child)
    pairs = []
    for bn in sorted(bns):
        parent, _, name = bn.rpartition(".")
        if name.isdigit():
            conv = f"{parent}.{int(name) - 1}"
            if not (_BEV_SEQ.search(parent) and _is_conv(sd, conv, bns)):
                continue
            axis = 1 if parent.rsplit(".", 2)[-2] == "deblocks" else 0
        else:
            kids = {c for c in children.get(parent, ()) if not c.isdigit()}
            convs = [c for c in kids if _is_conv(sd, f"{parent}.{c}", bns)]
            n_bn = sum(f"{parent}.{c}" in bns for c in kids)
            if len(convs) != 1 or n_bn != 1:
                continue
            conv, axis = f"{parent}.{convs[0]}", 0
        if sd[conv + ".weight"].shape[axis] == sd[bn + ".weight"].shape[0]:
            pairs.append((conv, bn, axis))
    return pairs


def fuse_state_dict(sd, eps=EPS):
    """A copy of ``sd`` with every pair of :func:`conv_bn_pairs` folded;
    returns (state dict, number of pairs)."""
    out = type(sd)(sd)
    pairs = conv_bn_pairs(sd)
    for conv, bn, axis in pairs:
        w = sd[conv + ".weight"]
        # the square root correctly rounded, as JAX's numpy one (torch's
        # vectorized float32 sqrt is off by an ulp on some inputs)
        inv = sd[bn + ".weight"] / torch.sqrt(
            (sd[bn + ".running_var"] + eps).double()).float()
        shape = [1] * w.dim()
        shape[axis] = -1
        out[conv + ".weight"] = (w * inv.reshape(shape)).to(w.dtype)
        out[bn + ".bias"] = sd[bn + ".bias"] - sd[bn + ".running_mean"] * inv
        out[bn + ".weight"] = torch.ones_like(inv)
        out[bn + ".running_mean"] = torch.zeros_like(inv)
        out[bn + ".running_var"] = torch.full_like(inv, 1.0 - eps)
    return out, len(pairs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("out")
    ap.add_argument("--eps", type=float, default=EPS)
    args = ap.parse_args(argv)

    from ...train import checkpoints

    payload, step = checkpoints.restore_latest(args.ckpt)
    total = 0
    for key in ("model", "state"):
        if key in payload:
            payload[key], n = fuse_state_dict(payload[key], args.eps)
            total += n
    checkpoints.save(args.out, payload, step)
    print(f"fused {total} conv+BN pairs -> {args.out} (step {step})")
    return total


if __name__ == "__main__":
    main()
