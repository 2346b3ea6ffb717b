"""DetMatch SSL training loop (counterpart of
``detmatch_tpu/apis/train_ssl.py:train_ssl``; reference
``apis/ssl_train.py`` + ``IterBasedSSLRunner``): per iteration one
labeled and one unlabeled batch, the teacher phase, one step of each
student branch and the teacher's EMA (``train/ssl_step.py``).

:func:`train_ssl` draws the batches from two datasets, starts from a
checkpoint (resume, bootstrapped resume or the pretrained detectors of
``load_from``), writes checkpoints and evaluates on a validation set;
:func:`train_ssl_batches` is the loop itself on an iterator of collated
batches, which the synthetic-batch callers use.

Under several processes (``parallel``) each process draws its own
batches (the loaders seeded per process, as JAX's), which together make
the global batch; the state starts from process 0's, every logged value
is the global batch's, and process 0 alone writes ``log.json``,
tensorboard, checkpoints and pictures and runs the evaluation (the others
wait at their next collective).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.loader import Loader
from ..ops.voxelize import VoxelizerSpec
from ..parallel import (broadcast_state, is_primary, process_count,
                        process_index, reduce_logs)
from ..train import checkpoints
from ..train.optim import detmatch_branch_optimizers
from ..train.ssl_step import (ema_step, student_2d_step, student_3d_step,
                              teacher_step, to_device_views, voxelize_views)
from ..train.tensorboard import TensorBoardSink
from ..utils import visualize as V
from ..utils.logging import JsonlLogger, MultiLogger, NullLogger

# iterations (after the start) whose span ``profile_dir`` traces, first
# and last included: JAX's window (``train_ssl.py:194-235``)
PROFILE_WINDOW = (12, 15)
# logged values equal on every process (the rest are each process's share
# of the global batch's value, summed over the processes)
REPLICATED_LOGS = ("grad_skips", "ssl.weight", "ssl.ema_decay")
# the per-process loaders' seed stride (JAX ``train_ssl.py:111``)
SEED_STRIDE = 9973


def ssl_optimizers(ssl, batch_size=4, lr_3d=None, lr_2d=None, lr_scale=1.0,
                   num_unlabeled=1, warmup_iters=500, step_intervals=None):
    """(AdamW over the student PV-RCNN, SGD over the student Faster
    R-CNN) at the recipe's rates (``split_0.py:824-827``): lr_3d =
    1e-3 / 2 * bs * (1 + U) * 10 and lr_2d = 2e-2 / 2 * bs * (1 + U) by
    default, then times ``lr_scale``; ``step_intervals`` ({"det3d": k,
    "det2d": k}) updates a branch every k-th step only."""
    if lr_3d is None:
        lr_3d = 1e-3 / 2 * batch_size * (1 + num_unlabeled) * 10
    if lr_2d is None:
        lr_2d = 2e-2 / 2 * batch_size * (1 + num_unlabeled)
    return detmatch_branch_optimizers(ssl, lr_3d * lr_scale,
                                      lr_2d * lr_scale, warmup_iters,
                                      step_intervals=step_intervals)


def dump_vis(work_dir, step, batch, pseudo):
    """The training loop's pictures (JAX ``_dump_vis``; the reference's
    Vis3D / Vis2D_Kitti consumers): the first unlabeled student sample's
    BEV with the 3D pseudo-labels, its image with the 2D pseudo-boxes
    and the matched-pair canvas, as ``<work_dir>/vis/iter<NNNNNN>_{bev,
    2d,pairs}.png`` (the image canvases BGR → RGB). ``batch`` is the
    device batch of :func:`ssl_iteration`, ``pseudo`` its teacher
    phase's output."""
    out_dir = os.path.join(work_dir, "vis")
    os.makedirs(out_dir, exist_ok=True)

    def first(tree):
        return {k: v[0].detach().cpu().numpy() for k, v in tree.items()
                if isinstance(v, torch.Tensor)}

    u = first(batch["unlab"]["stu"])
    pts = u["points"][u["points_valid"]]
    name = os.path.join(out_dir, f"iter{step:06d}_{{}}.png")
    m3, m2 = first(pseudo["m3d_stu"]), first(pseudo["m2d_stu"])
    V.write_png(name.format("bev"),
                V.bev_canvas(pts, [m3["boxes"][m3["valid"]]]))
    img = V.denormalize_caffe(np.transpose(u["img"], (1, 2, 0)))
    V.write_png_bgr(name.format("2d"), V.draw_boxes_2d(
        img, m2["boxes"], valid=m2["valid"]))
    pair = V.matched_pair_canvas(
        img, m3["boxes"], m2["boxes"], m3["valid"] & m2["valid"],
        u["lidar2img"], u["img_shape"], scores3d=m3["scores"],
        scores2d=m2["scores"])
    V.write_png_bgr(name.format("pairs"), pair)


def _iteration(ssl, opts, vox_spec, batch_np, it, generator):
    """:func:`ssl_iteration` that also returns its device batch and the
    teacher's pseudo-labels."""
    opt3d, opt2d = opts
    device = next(ssl.parameters()).device
    batch = voxelize_views(to_device_views(batch_np, device), vox_spec)
    pseudo = teacher_step(ssl, batch)
    branches = []
    if ssl.cfg.enable_3d:
        branches.append(student_3d_step(ssl, opt3d, batch, pseudo, it,
                                        generator))
    if ssl.cfg.enable_2d:
        branches.append(student_2d_step(ssl, opt2d, batch, pseudo, it,
                                        generator))
    ema_step(ssl, it)
    logs = dict(pseudo["logs"])
    for branch in branches:
        logs.update(branch)
    logs["loss"] = sum(branch["loss"] for branch in branches)
    logs["grad_skips"] = opt3d.skipped + opt2d.skipped
    logs["metrics.dropped_voxels"] = sum(
        v["voxel_dropped"].sum() for views in batch.values()
        for v in views.values())
    logs = reduce_logs(logs, REPLICATED_LOGS)
    return {k: float(v) for k, v in logs.items()}, batch, pseudo


def ssl_iteration(ssl, opts, vox_spec: VoxelizerSpec, batch_np, it,
                  generator):
    """One SSL iteration on a collated numpy batch (this process's rows of
    the global batch): the teacher phase, one step of each enabled
    student branch, the teacher's EMA. Returns the iteration's logs as
    floats, the global batch's values."""
    return _iteration(ssl, opts, vox_spec, batch_np, it, generator)[0]


def train_ssl_batches(ssl, vox_spec: VoxelizerSpec, batches, work_dir,
                      max_iters, batch_size=4, lr_3d=None, lr_2d=None,
                      lr_scale=1.0, num_unlabeled=1, warmup_iters=500,
                      log_interval=10, seed=0, start=None, after_iter=None,
                      profile_dir=None, vis_interval=None, tensorboard=False):
    """Train ``ssl`` up to iteration ``max_iters`` on the device it lives
    on.

    Args:
        ssl: an ``SSLDetector`` (``apis.build.build_ssl``); its student is
            put in train mode, its teacher stays in eval mode.
        batches: an iterator of collated numpy batches
            ``{"lab": {"stu", "tea"}, "unlab": {"stu", "tea"}}`` of views
            as ``data.collate.collate_ts`` or ``utils.synth_kitti.ssl_view``
            make them (the labeled student view with gt_boxes, gt_boxes2d,
            gt_labels2d, gt2d_valid): this process's rows of each global
            batch. The state starts from process 0's
            (``parallel.broadcast_state``).
        batch_size, num_unlabeled, lr_3d, lr_2d, lr_scale, warmup_iters:
            the optimizers' rates (:func:`ssl_optimizers`).
        work_dir: gets ``log.json``, one line per ``log_interval``
            iterations with the JAX loop's keys (``sup.3d.*``,
            ``sup.2d.*``, ``ssl.unlab.*``, ``metrics.*``, ``ssl.weight``,
            ``ssl.ema_decay``, ``grad_skips`` (both branches' skipped
            steps), ``loss``, ``iter``, ``mode``, ``time``), the global
            batch's values, written by process 0.
        seed: seeds the ``torch.Generator`` that every sampler and dropout
            mask draws from.
        start: ``(opts, generator, start_iter)`` to continue from instead
            of new optimizers, a generator seeded with ``seed`` and
            iteration 0 (:func:`train_ssl`'s resume).
        after_iter: called as ``after_iter(n, opts, generator, logger)``
            after the ``n``-th iteration (:func:`train_ssl`'s checkpoints
            and evaluation).
        profile_dir: a ``torch.profiler`` Chrome trace of the iterations
            ``start + PROFILE_WINDOW[0]`` to ``start + PROFILE_WINDOW[1]``
            (CPU, and CUDA on the card) to ``<profile_dir>/trace.json``.
        vis_interval: every ``vis_interval`` iterations :func:`dump_vis`
            (one process only, as JAX's).
        tensorboard: also log every line to ``<work_dir>/tb``
            (``train/tensorboard.py``).
    Returns:
        (ssl, (opt3d, opt2d), history): ``history`` holds this call's
        iterations' logs as floats.
    """
    os.makedirs(work_dir, exist_ok=True)
    primary = is_primary()
    logger = (JsonlLogger(os.path.join(work_dir, "log.json")) if primary
              else NullLogger())
    if tensorboard and primary:
        logger = MultiLogger(logger, TensorBoardSink(
            os.path.join(work_dir, "tb")))
    device = next(ssl.parameters()).device
    if start is None:
        opts = ssl_optimizers(ssl, batch_size, lr_3d, lr_2d, lr_scale,
                              num_unlabeled, warmup_iters)
        start = (opts, torch.Generator(device=device).manual_seed(seed), 0)
    opts, generator, start_iter = start
    broadcast_state(ssl, *opts, generator)
    ssl.train()
    history = []
    prof = None
    t0 = time.perf_counter()
    try:
        for it in range(start_iter, max_iters):
            if (profile_dir and primary
                    and it == start_iter + PROFILE_WINDOW[0]):
                prof = _start_profile(device)
            entry, batch, pseudo = _iteration(ssl, opts, vox_spec,
                                              next(batches), it, generator)
            if prof is not None and it == start_iter + PROFILE_WINDOW[1]:
                _stop_profile(prof, profile_dir)
                prof = None
            history.append(entry)
            if (it + 1) % log_interval == 0:
                logger.log(dict(entry, iter=it + 1, mode="train",
                                time=(time.perf_counter() - t0)
                                / log_interval))
                t0 = time.perf_counter()
            if (vis_interval and (it + 1) % vis_interval == 0
                    and process_count() == 1):
                dump_vis(work_dir, it + 1, batch, pseudo)
            del batch, pseudo
            if after_iter is not None:
                after_iter(it + 1, opts, generator, logger)
    finally:
        if prof is not None:
            _stop_profile(prof, profile_dir)
        logger.close()
    return ssl, opts, history


def _start_profile(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def ssl_checkpoint(ssl, opts, generator):
    """The payload of an SSL checkpoint: the detector's state dict
    (student and teacher), both optimizers' state, and the generator's
    state."""
    return dict(state=ssl.state_dict(),
                opt_state=dict(det3d=opts[0].state_dict(),
                               det2d=opts[1].state_dict()),
                rng=generator.get_state())


def restore_ssl_checkpoint(ssl, opts, generator, payload):
    """Load an :func:`ssl_checkpoint` payload into ``ssl``, ``opts`` and
    ``generator`` (a bootstrapped resume's payload may lack ``rng``)."""
    ssl.load_state_dict(payload["state"])
    opts[0].load_state_dict(payload["opt_state"]["det3d"])
    opts[1].load_state_dict(payload["opt_state"]["det2d"])
    if "rng" in payload:
        generator.set_state(payload["rng"])


def train_ssl(ssl, vox_spec: VoxelizerSpec, lab_dataset, unlab_dataset,
              collate_fn, work_dir, max_iters=5000, batch_size=4, lr_3d=None,
              lr_2d=None, lr_scale=1.0, num_unlabeled=1, log_interval=10,
              ckpt_interval=5000, seed=0, resume_from=None, warmup_iters=500,
              load_from=None, load_from_with_optimizer=None,
              val_dataset=None, val_collate_fn=None, eval_interval=None,
              profile_dir=None, vis_interval=None, tensorboard=False,
              ckpt_meta=None):
    """DetMatch SSL training from datasets (JAX's ``train_ssl``).

    Batches: ``batch_size`` labeled samples and ``batch_size *
    num_unlabeled`` unlabeled ones an iteration and a process (the
    reference's samples per GPU), from two ``Loader``s seeded with
    ``seed + r * 9973`` and one more on process ``r``, collated by
    ``collate_fn`` (``data.collate.collate_ts``). A resumed run restarts
    both loaders from their seeds, as the JAX loop does.

    Start, in this order of precedence (JAX's ``train_ssl.py:136-155``):
    ``resume_from`` (a checkpoint directory: the latest ``ckpt_<n>``'s
    detector, optimizers and generator, continuing at iteration n),
    ``load_from_with_optimizer`` (the same from another run, restarting
    at iteration 0), ``load_from`` (``{"det3d": path, "det2d": path}``:
    each pretraining run's latest checkpoint into both the student and
    the teacher).

    Every ``ckpt_interval`` iterations and at ``max_iters`` the state is
    saved to ``<work_dir>/ckpt/ckpt_<n>`` with ``meta.json``
    (``checkpoints.default_meta(**ckpt_meta)``); every ``eval_interval``
    iterations and at ``max_iters``, with a ``val_dataset``, ``eval_ssl``
    scores teacher and student (``val_collate_fn``, default
    ``collate_fn``) into a ``mode="val"`` line of ``log.json``. Both on
    process 0 only.

    The other arguments (``profile_dir``, ``vis_interval``,
    ``tensorboard`` among them) are :func:`train_ssl_batches`'s. Returns
    what it returns.
    """
    device = next(ssl.parameters()).device
    opts = ssl_optimizers(ssl, batch_size, lr_3d, lr_2d, lr_scale,
                          num_unlabeled, warmup_iters)
    generator = torch.Generator(device=device).manual_seed(seed)
    start_iter = 0
    if resume_from:
        payload, start_iter = checkpoints.restore_latest(resume_from)
        restore_ssl_checkpoint(ssl, opts, generator, payload)
    elif load_from_with_optimizer:
        payload, start_iter = checkpoints.load_from_with_optimizer(
            load_from_with_optimizer)
        restore_ssl_checkpoint(ssl, opts, generator, payload)
    elif load_from:
        for det_key, path in load_from.items():
            checkpoints.load_pretrained_into_ssl(
                ssl, checkpoints.restore_latest(path)[0]["model"], det_key)

    def after_iter(n, opts, generator, logger):
        if not is_primary():
            return
        last = n == max_iters
        if n % ckpt_interval == 0 or last:
            checkpoints.save(
                os.path.join(work_dir, "ckpt"),
                ssl_checkpoint(ssl, opts, generator), n,
                meta=checkpoints.default_meta(**(ckpt_meta or {}), iter=n))
        if eval_interval and val_dataset is not None and (
                n % eval_interval == 0 or last):
            from .evaluate import eval_ssl
            res = eval_ssl(ssl, val_dataset, val_collate_fn or collate_fn,
                           vox_spec)
            logger.log(dict(res, iter=n, mode="val"))

    proc_seed = seed + process_index() * SEED_STRIDE
    lab_loader = Loader(lab_dataset, batch_size, collate_fn, seed=proc_seed)
    unlab_loader = Loader(unlab_dataset, batch_size * num_unlabeled,
                          collate_fn, seed=proc_seed + 1)

    def batches():
        lab, unlab = iter(lab_loader), iter(unlab_loader)
        while True:
            yield dict(lab=next(lab), unlab=next(unlab))

    try:
        return train_ssl_batches(
            ssl, vox_spec, batches(), work_dir, max_iters,
            log_interval=log_interval, start=(opts, generator, start_iter),
            after_iter=after_iter, profile_dir=profile_dir,
            vis_interval=vis_interval, tensorboard=tensorboard)
    finally:
        lab_loader.stop()
        unlab_loader.stop()
