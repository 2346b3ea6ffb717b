"""Checkpoints as torch state dicts (counterpart of
``detmatch_tpu/train/checkpoints.py``, which writes orbax trees).

The directory layout is the JAX package's, ``<path>/ckpt_<step>/`` with an
optional ``meta.json`` beside the payload, so the configs' ``load_from``
paths (``work_dirs/pretrain_*/ckpt``) serve both packages. The payload is
a dict of state dicts (``model`` for a pretraining run; ``state``,
``opt_state`` and ``rng`` for an SSL run), saved with every tensor on the
CPU. The reference's semantics (``ssl.py:102-127``,
``apis/ssl_train.py:157-166``):

* a pretraining checkpoint (one detector) loads into both the student and
  the teacher of an SSL detector;
* an SSL checkpoint restores student, teacher and both optimizers;
* ``load_from_with_optimizer`` ("bootstrapped resume") restores the model
  and the optimizers but restarts the iteration count at 0.

Checkpoints are read with ``torch.load(weights_only=True)``: tensors,
numbers, strings and containers only.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch

PAYLOAD = "state.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((k, _to_cpu(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save(path: str, payload: Dict[str, Any], step: int,
         meta: Optional[Dict[str, Any]] = None):
    """Write ``payload`` to ``<path>/ckpt_<step>/`` (replacing a
    checkpoint of that step); ``meta`` (classes, config text, versions,
    time: the reference's checkpoint meta, ``tools/train.py:210-220``)
    lands beside it as ``meta.json``. The payload file is written under a
    temporary name and renamed, so a reader never sees half of it."""
    step_dir = os.path.join(os.path.abspath(path), f"ckpt_{step}")
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, PAYLOAD + ".tmp")
    torch.save(_to_cpu(payload), tmp)
    os.replace(tmp, os.path.join(step_dir, PAYLOAD))
    if meta is not None:
        with open(os.path.join(step_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1, default=str)


def default_meta(classes=None, config_text=None, **extra):
    """Environment and version stamp for a checkpoint's meta."""
    from .. import __version__ as pkg_version
    meta = dict(time=time.strftime("%Y-%m-%d %H:%M:%S"),
                detmatch_tpu_torch=pkg_version, torch=torch.__version__,
                cuda=torch.version.cuda)
    if classes is not None:
        meta["CLASSES"] = list(classes)
    if config_text is not None:
        meta["config"] = config_text
    meta.update(extra)
    return meta


def restore(path: str, step: int):
    """The payload of ``<path>/ckpt_<step>/``, every tensor on the CPU
    (``load_state_dict`` copies it to the model's device)."""
    return torch.load(os.path.join(os.path.abspath(path), f"ckpt_{step}",
                                   PAYLOAD), map_location="cpu",
                      weights_only=True)


def latest_step(path: str) -> Optional[int]:
    """The largest ``<step>`` of the ``ckpt_<step>`` directories under
    ``path``; None if there is none."""
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("ckpt_"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def load_from_with_optimizer(path: str, step: Optional[int] = None):
    """Bootstrapped resume (reference ``apis/ssl_train.py:157-166``): the
    payload of an SSL checkpoint (model and optimizer state) with the
    iteration count reset, to continue SSL training under a new schedule.
    Returns (payload, start_iter=0)."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no ckpt_* under {path}")
    return restore(path, step), 0


def load_pretrained_into_ssl(ssl, state_dict, det_key):
    """Load one pretrained detector's state dict into both the student
    and the teacher branch ``det_key`` of an ``SSLDetector``
    (reference ``ssl.py:102-127``). ``load_state_dict`` copies into each
    branch's own tensors, so the teacher holds a real copy, never an
    alias of the student's weights."""
    ssl.student[det_key].load_state_dict(state_dict)
    ssl.teacher[det_key].load_state_dict(state_dict)
    return ssl
