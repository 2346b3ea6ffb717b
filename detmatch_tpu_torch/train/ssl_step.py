"""One DetMatch SSL iteration as four plain functions (counterpart of
``detmatch_tpu/train/ssl_step.py:make_ssl_train_fns_split``), run in this
order on one batch:

1. :func:`teacher_step` — the teacher phase, no gradients;
2. :func:`student_3d_step` — one autograd step of the student PV-RCNN
   (one concatenated labeled + unlabeled forward, or one forward each
   with ``concat_student_batch=False``; losses, backward, AdamW);
3. :func:`student_2d_step` — the same for the student Faster R-CNN (SGD);
4. :func:`ema_step` — the teacher's EMA of the updated student.

The two student branches run one after the other, each freeing its graph
before the next, as the JAX package's split step does. Also the data
side: bring a collated numpy batch to the device and voxelize every
view."""
from __future__ import annotations

import numpy as np
import torch

from ..core.transforms import Aug2D, Aug3D
from ..ops.voxelize import VoxelizerSpec, voxelize_mean
from ..ssl.detector import ema_decay_at, ema_update, ssl_weight_at


def to_device_views(batch, device):
    """``{split: {view_name: numpy view}}`` → the same of tensors on
    ``device``: images from (B, H, W, 3) to (B, 3, H, W), the ``aug3d`` /
    ``aug2d`` dicts to :class:`Aug3D` / :class:`Aug2D`."""
    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def view(v):
        out = {k: tensor(a) for k, a in v.items()
               if k not in ("aug3d", "aug2d")}
        out["img"] = out["img"].permute(0, 3, 1, 2).contiguous()
        out["aug3d"] = Aug3D(**{k: tensor(a) for k, a in v["aug3d"].items()})
        out["aug2d"] = Aug2D(**{k: tensor(a) for k, a in v["aug2d"].items()})
        return out

    return {split: {k: view(v) for k, v in views.items()}
            for split, views in batch.items()}


def voxelize_views(batch, spec: VoxelizerSpec):
    """Add voxel_features, voxel_keys and voxel_dropped (per-frame count
    of occupied voxels cut by the ``max_voxels`` cap) to every view of
    ``{split: {view_name: view}}``."""
    def add(view):
        vox = voxelize_mean(view["points"], view["points_valid"], spec)
        return dict(view, voxel_features=vox["features"],
                    voxel_keys=vox["keys"],
                    voxel_dropped=vox["num_dropped_voxels"])

    return {split: {k: add(v) for k, v in views.items()}
            for split, views in batch.items()}


def teacher_step(ssl, batch):
    """The teacher phase (``ssl.teacher_pseudo_labels``) without
    gradients; returns the detached pseudo-labels."""
    with torch.no_grad():
        return ssl.teacher_pseudo_labels(batch)


def _branch_step(loss_fn, opt, batch, pseudo, it, generator):
    opt.zero_grad()
    total, logs = loss_fn(batch, pseudo, it, generator)
    total.backward()
    opt.step()
    logs = {k: v.detach() for k, v in logs.items()}
    logs["loss"] = total.detach()
    logs["grad_skips"] = opt.skipped
    return logs


def student_3d_step(ssl, opt3d, batch, pseudo, it, generator):
    """One step of the student PV-RCNN (``student_losses_3d_concat``, or
    the two-pass ``student_losses_3d`` when the config's
    ``concat_student_batch`` is False, as JAX's ``ssl_step.py:157-158``
    chooses; backward, clip + AdamW); its batch-norm statistics move in
    the forward. Returns the branch's logs with ``loss``, ``grad_skips``,
    ``ssl.weight`` and ``ssl.ema_decay``."""
    loss_fn = (ssl.student_losses_3d_concat if ssl.cfg.concat_student_batch
               else ssl.student_losses_3d)
    logs = _branch_step(loss_fn, opt3d, batch, pseudo, it, generator)
    logs["ssl.weight"] = ssl_weight_at(it, ssl.cfg)
    logs["ssl.ema_decay"] = ema_decay_at(it, ssl.cfg)
    return logs


def student_2d_step(ssl, opt2d, batch, pseudo, it, generator):
    """One step of the student Faster R-CNN (``student_losses_2d``,
    backward, clip + SGD); returns its logs with ``loss`` and
    ``grad_skips``."""
    return _branch_step(ssl.student_losses_2d, opt2d, batch, pseudo, it,
                        generator)


def ema_step(ssl, it):
    """The teacher's EMA of the (updated) student at iteration ``it``."""
    ema_update(ssl.teacher, ssl.student, ema_decay_at(it, ssl.cfg),
               ssl.cfg.use_student_bn_stats_for_teacher)
