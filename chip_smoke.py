"""Drive the PyTorch port's PV-RCNN inference and training, the
DetMatch teacher phase, one whole DetMatch SSL iteration (fp32 and
bf16), the command-line tools, the demos and result tools, the LiDAR zoo
and CaDDN on a CUDA card, check its CUDA kernels against their plain
PyTorch twins, and time them.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases (any failure exits non-zero without printing the result line):
1. device — a CUDA card is required; prints its nvidia-smi name and
   power limit;
2. precision — TF32 off for matmuls and cuDNN convs;
3. build — compiles ``detmatch_tpu_torch/csrc/*.cu`` (timed);
4. kernels — every sparse-conv, FPS and ball-query call of the main path
   (B=4 synthetic KITTI frames of 16,384 points, 16,000-voxel cap, the
   first of them alone, and a B=3 batch with uneven valid counts), kernel
   against twin on the same inputs: integer outputs exactly equal, conv
   max relative error <= 1e-5; then, off the main path, K1, K5 and K7 with
   gradients on neighbour keys that repeat within a tap (every writer
   summed, as in JAX) and at C = 5 and 128 against their twins, K1's and
   K5's backward bit-equal over two launches, K5's S exactly its twin's;
5. end to end — full-width PV-RCNN from
   ``configs/detmatch/001/pretrain_pvrcnn/split_0.py`` with seeded random
   weights runs ``detect`` (all launch counters must move, outputs
   finite), then the kernel path is compared with the plain path on the
   card (B=4) and with the plain path on the CPU (B=1);
6. timing with CUDA events — B=1 latency, B=4 frames/s, each kernel
   against its twin; K3 (FPS) at B=1 and B=4 with its cluster size and
   µs a step;
7. training (``configs/.../pretrain_pvrcnn/split_0.py`` at full width,
   train mode, B=2 synthetic frames of 18,000 points with the JAX
   benchmark's 40-slot GT boxes): every kernel of one training step
   against its twin at training shapes (the sparse conv's backward
   kernel against autograd through the twin, max relative error
   <= 1e-5); one step on the kernel path against one on the plain path,
   both on the kernel path's proposals (losses and BN running statistics
   within 1e-4), and against one whose sparse convs take the kernel's
   forward values and the twin's autograd backward (gradients within
   1e-3 of each tensor's largest magnitude; see ``train_phases``);
   ``train_pvrcnn_batches`` for 5 steps with all four
   launch counters moving, and CUDA-event timings of the step, its split,
   the train proposal NMS and peak memory;
8. the DetMatch teacher phase (``configs/detmatch/001/detmatch/
   split_0.py`` at full width: B=4 unlabeled frames of 18,000 points,
   a 384 x 1280 canvas, Faster R-CNN R50-FPN, seeded random weights with
   randomized BN statistics): the JV assignment kernel against its twin
   on synthetic problems (mixed orientations, ties, padding, an
   all-invalid and a one-row element; K = 128, 100, 10) and every kernel
   call of the phase, all exactly; ``teacher_pseudo_labels`` with 12 / 12
   / 1 / 1 launches (K1 fwd, K2, K3, K4); kernel path against plain path
   on the same teacher boxes (pseudo-labels: validity exactly, boxes and
   scores within 1e-4) and on their own (99% of teacher boxes matched);
   Faster R-CNN on the card against the CPU at B=1 (pre-NMS boxes and
   scores within 1e-4 on the card's proposals); CUDA-event timings of
   the phase, its split and K4, and peak memory; K4's call: B, K, valid
   rows, inner steps per element, ms, device ms and µs a step;
9. one whole SSL iteration (``configs/detmatch/001/detmatch/split_0.py``
   at full width: B=4 labeled frames with the JAX benchmark's GT draw +
   B=4 unlabeled ones, the models' own seeded initialisers): every kernel
   call of the iteration against its twin (K1 forward and backward at the
   student's B=8, K2, K3, K4 on the fusion's and the consistency
   branch's own problems, exactly); K1's forward bit-equal to K7 on the
   plain rulebook on all 24 calls, with and without writing its
   rulebook, and that rulebook equal to the plain one; K1's backward
   (on the forward's rulebook) bit-equal over two launches on the 12
   student calls; the student 3D step on the kernel path
   against the plain paths on pinned teacher boxes, pinned proposals and
   clean 2D boxes made from the student's own (losses and BN statistics
   within 1e-4, gradients within 1e-3 with the kernel's forward values and
   the twin's backward; the consistency branch must pair boxes and a 2D
   pseudo-label must be kept); the four step functions with the EMA
   teacher equal to its formula; ``train_ssl_batches`` for 3 iterations with
   24 / 12 / 24 / 2 / 2 launches per iteration (K1 fwd, K1 bwd, K2, K3,
   K4); the same iteration with ``conv_impl="key"`` (K5 forward within
   1e-5 of its twin on its 24 calls and bit-equal over two launches on
   the 12 student calls, the rulebook it writes for the backward equal
   to the plain one; K5's backward on that rulebook: S exactly the
   twin's on the step's 12 shapes and bit-equal over two launches; its
   24 K2 and 2 K3 calls exactly, 24 / 12 / 0 launches of K5 fwd, K5 bwd,
   K1, losses within 1e-4 of the plain path); the same iteration on the
   rulebook path (``conv_impl="rulebook"``, JAX's ``"xla"``: every K7
   call within 1e-5 of its twin (and whether bit-equal to it), bit-equal
   over two launches on the 12 student calls, its K2 and K3 calls
   exactly, 24 / 0 / 0 / 0
   launches of K7, K1 fwd, K1 bwd, K5, losses and BN statistics within
   1e-4 of the plain path's and of the window path's, the five backbone
   levels within 1e-5 of the window path's on the same B=8 student
   input); the one-hot ops K6 and K8, which no model calls, replayed on
   that forward's operands (K6 on its 12 student rulebooks: forward
   within 1e-5 and bit-equal over two launches, S exactly and every call
   through the direct path, dF and
   dW equal given the same S; a rulebook with repeats through the sorted
   path, S equal to the CPU twin's; K8 on every ``pointnet.gather_rows``
   call: the gather exactly, the scatter-add within 1e-5 and, where a
   slot has more than ``CHUNK`` pairs, bit-equal over two launches), each
   timed against its twin and against the one PyTorch call that computes
   it (the table's and the rounded rows' preparation excluded), with the
   share of K8's stable sort and K6's path per call; CUDA-event timings
   of the iteration and its split on the window path (the key and
   rulebook paths': ``tools/port_probes/ssl_iteration_ab.py``), peak
   memory,
   and each kernel per iteration beside its bound; per student conv,
   K1's matched pairs, forward and backward ms beside their bounds and
   the backward's passes (profiler kernel times); per ball-query call
   (K2) its site, shapes, lanes a center, window, positions scanned and
   count, ms and device ms beside its bound; per FPS call (K3) its
   cluster size and µs a step, and K3's step floor (one point a thread,
   equal to its twin) at B=1 and B=8; per K4 call of the iteration (the
   fusion's, the consistency branch's, and the pinned comparison's) its
   B, K, valid rows, inner steps, ms, device ms and µs a step, and K4's
   step floor (the longest augmenting paths, c[i, j] = i * j, at K = 32
   and 128, equal to its twin); per key-path student conv (K5) its
   matched pairs, tile rows, ms and device ms beside its bound, and K5's
   backward: ms, device ms, its passes (profiler kernel times) and the
   library call (``new_zeros`` + ``index_put_`` of the rounded rows)
   beside its bound; per rulebook-path student conv (K7) its matched
   pairs, tile rows, ms and device ms beside its bound;
10. the tree (``cli_data``): a synthetic KITTI tree of 164 HDL-64 frames
   (64 beams x 1,000 rays, 375 x 1242 PNGs, labels through the
   calibration) and its ``ImageSets``, then ``tools.create_data`` (infos,
   reduced clouds cropped to the camera's view, at least 18,000 points a
   frame; the gt database) and ``tools.create_ssl_splits --fracs 0.01
   --num-splits 1`` (2 labeled, 158 unlabeled frames, 4 for validation;
   the split's gt database only of labeled frames), with each call's
   seconds; training from that tree (``tree_phases``), the README's
   recipe at ``split_0.py``'s widths: the loaders of ``split_0.py``'s
   data section at B = 4 + 4 (points (4, 18000, 4), every point slot
   filled, images (4, 384, 1280, 3), ObjectSample's boxes added to the
   labels; host ms a batch with 4 workers); ``train_pvrcnn`` and
   ``train_frcnn`` for 2 steps of B = 2 with a checkpoint a step (K1
   forward and backward, K2, K3 launched); ``train_ssl`` with
   ``load_from`` on both (student = teacher = checkpoint before the first
   step), 2 iterations with a checkpoint each and an evaluation at the
   second (K1-K4 launched); ``ckpt_2`` restored equal to the live state
   exactly, and one iteration on a pinned batch from it within 1e-4 of
   the same iteration from the live state (each loss, each tensor's
   largest magnitude); ms an iteration fed from the loaders against the
   same on a synthetic batch; ``eval_ssl`` on the 4 validation frames
   through the C matcher (built here; its failure fails the phase):
   finite APs, ms a frame of ``eval_pvrcnn`` and ``eval_frcnn``;
11. bf16 (``bf16_phases``): ``split_0.py``'s detectors with
   ``compute_dtype="bfloat16"`` beside the fp32 ones, the same seeded
   weights: the student 3D loss terms on pinned teacher boxes, proposals,
   clean 2D boxes and the consistency branch's surviving student boxes
   within 16 bf16 steps of fp32's
   (``tests/test_torch_port_bf16.py``), finite gradients; ms an SSL
   iteration in turns (fp32, bf16; a warm-up iteration and a timed one
   each) with its split, peak
   memory and 24 / 12 / 24 / 2 / 2 launches an iteration; one iteration
   of JAX's benchmark recipe (``detmatch_tpu/benchmarks.py:42-57``:
   train NMS 1,024 -> 128, caps (16000, 12000, 9000, 9000), bf16, 16,000
   voxels): ms and samples/s;
12. the command line (``cli_phases``) on that tree: ``tools.train`` on
   ``pretrain_pvrcnn/split_0.py`` and ``pretrain_frcnn/split_0.py`` (1
   step each) and ``detmatch/split_0.py`` (2 iterations from both, then
   ``--resume-from`` to 3, a checkpoint and the three ``vis/`` PNGs an
   iteration), pointed at the tree through ``--cfg-options``;
   ``tools.test`` on the SSL checkpoint in process (with
   ``--out-kitti``) and as ``python -m``:
   each call's seconds and launches (K1-K3 in pretrain_3d and test, K1-K4
   in SSL), the logs, checkpoints, PNG shapes and the eight
   ``{tea,stu}.{3d,2d}`` AP families; then on those checkpoints
   (``demo_phases``) ``demo.pcd_demo`` (pretraining) and
   ``demo.multi_modality_demo`` (SSL, teacher) on one validation frame,
   each with K1 fwd, K2 and K3 launched and its detections equal to
   ``detect`` / ``simple_test`` on the same frame (count and labels
   exactly, boxes and scores within 1e-5); ``tools.misc.fuse_conv_bn``
   on the pretraining checkpoint, ``detect`` at B=4 folded against
   unfolded (the outputs before the proposal NMS within 2e-3, the
   detections' share printed, both timed in turns);
   ``publish_model`` (optimizer state dropped, content hash),
   ``print_config``, ``visualize_results`` on ``tools.test``'s KITTI
   results and ``browse_dataset``;
13. the LiDAR zoo (``zoo_phases``): SECOND, SECOND-IoU, PointPillars,
   Voxel R-CNN, Part-A2 and PointRCNN through ``build_detector`` at
   JAX's default widths (pcdet's KITTI configs), on B=2 synthetic frames
   of 18,000 points with the JAX benchmark's GT draw (``split_0.py``'s
   voxelizer; pillars of 0.16 m, 12,000 of 32 points; 16,384 points a
   frame for PointRCNN): one training step on the kernel path with the
   model's own seeded initialisers (finite losses; K1 fwd / K1 bwd / K2 /
   K3 launches 12/12/0/0 SECOND and SECOND-IoU, 0 PointPillars,
   12/12/3/0 Voxel R-CNN, 28/28/0/0 Part-A2, 0/0/11/6 PointRCNN; every
   recorded K1, K2, K3 call against its twin), the same step on the
   plain paths on the kernel path's proposals with the same RoI picks
   and dropout masks (losses and BN statistics within 1e-4; gradients
   within 1e-3 with the sparse convs' kernel forward values and twin
   backward), one optimizer step (``train/optim.py``), ms a step in 2
   runs after a warm-up and peak memory, each kernel's ms against its
   twin and bound; then ``randomize_``'s weights in eval mode at B=1 and
   B=4: the dense outputs of the kernel path against the plain path
   within 1e-4, the two-stage models' detections on the kernel path's
   proposals against it (99% matched; unpinned, information: random
   weights tie the scores densely), launches, ms a detect call (forward +
   post-processing) in 2 runs;
14. CaDDN (``mono_phases``, ``configs/caddn/caddn_kitti.py`` at JAX's
   defaults: a 280 x 376 x 25 grid, 80 LID bins, a 384 x 1280 canvas;
   ``utils/synth_kitti.caddn_view``'s frames, 2D gt boxes projected from
   the 3D ones, depth maps from the projected points): a B=1 eval forward
   with ``randomize_``'s weights on the card against the CPU (depth
   logits within 1e-4, box and class predictions within 1e-3 of their
   largest magnitude; the post-processed detections' share printed),
   its ms and peak memory; three AdamW steps at B=2 on one batch from
   the model's own seeded initialisers (every loss term and gradient
   finite, the loss falling), ms a step after a warm-up and peak
   memory; ``demo.mono_demo`` on their checkpoint, its detections equal
   to the model's own post-processing of the same image;
15. data parallel (``dist_phases``, ``detmatch_tpu_torch/parallel``):
   two SSL iterations of ``train_ssl_batches`` at ``split_0.py``'s widths
   on a global batch of 4 + 4 frames, one process against two processes
   over gloo on the one card (2 + 2 frames each; process 1 starts from
   other weights, which ``broadcast_state`` replaces), the teacher's
   pseudo-labels and the student's proposals pinned to the one process's
   (``SSLPins``): logs within 1e-4, gradients and AdamW first moments
   within 1e-3 of each tensor's largest magnitude (or twice float32's
   spread between the two exact batch-norm formulas, where wider),
   running statistics within 1e-4, the rest of the state within twice
   the AdamW steps' rates, the two processes' states bit-equal, K1 fwd /
   bwd, K2, K3, K4 launched in each; each process's own teacher against
   the pins, its peak memory, and the flat gradient all-reduce's bytes
   and ms (gloo staged through the host); one process over NCCL against
   no process group (bit for bit, under deterministic algorithms), and
   NCCL refusing two processes on the one card;
16. the study tools of ``tools/misc`` (``study_phases``): the learning
   study (``learning_study.run_study``) with both arms for 24 iterations
   on a fresh tree of its 12 + 24 + 8 scenes, 4 recalibration passes and
   its three evaluations on the 8 val frames (every logged loss finite,
   every AP finite and in [0, 100], K1 fwd / bwd, K2, K3, K4 launched in
   each arm; ms an iteration, peak memory), then a rerun on the same
   tree (restored at 24, no iteration trained, the three evaluations
   returned from its cache unchanged); the data-parallel noise study
   (``dp_noise_study.study``) at the tiny width over 2 gloo processes on
   the card against one process (every integer and boolean output of
   the forward equal, every gradient leaf within JAX's ``1e-3 + 1e-2 *
   max|leaf|``) and against float64 on the plain paths;
17. the checkpoint importer (``import_phases``,
   ``tools/model_converters/import_torch_ckpt.py``): a seeded PV-RCNN and
   Faster R-CNN at ``split_0.py``'s widths saved as pcdet and mmdet
   checkpoints (with the extra keys such files carry), imported and
   loaded through ``train_ssl``'s ``load_from`` into an SSL detector on
   the card (student and teacher equal to the sources bit for bit); one
   ``detect`` frame and one teacher phase equal to the source models'
   exactly, K1 fwd, K2, K3 and K4 launched; seconds printed;
18. a JSON line of the kernels (per SSL iteration, with their bounds;
   K6 and K8 over the replayed calls, with 0 launches on the model
   path), then the result line.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs/detmatch/001/pretrain_pvrcnn/split_0.py"
SSL_CONFIG = ROOT / "configs/detmatch/001/detmatch/split_0.py"
SSL_B = 4  # the SSL config's batch_size
SEED = 0
NUM_POINTS = 16384  # the BENCH=infer shape (bench.py:62)
TRAIN_POINTS = 18000  # data.collate.max_points of the pretrain config
TRAIN_B = 2           # its batch_size
TRAIN_STEPS = 5
CONV_RTOL = 1e-5
E2E_RTOL = 1e-4
GRAD_TOL = 1e-3       # of each gradient tensor's largest magnitude
MATCH_SHARE = 0.99
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA datasheet): HBM3 bytes/s, fp32 FLOP/s outside
# the tensor cores (K1-K4 compute in fp32) and dense bf16 tensor-core
# FLOP/s (K5's operands are bf16)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

FWD_KERNELS = ("window_key_conv_batched", "fps_batched",
               "ball_query_batched")
TEACHER_KERNELS = FWD_KERNELS + ("solve_masked_batched",)
# K1 fwd, K3, K2, K4 launches per teacher phase at B=4
TEACHER_LAUNCHES = dict(window_key_conv_batched=12, fps_batched=1,
                        ball_query_batched=12, solve_masked_batched=1)
# the stages of teacher_pseudo_labels that chip_smoke times
STAGES = ("3D teacher", "2D teacher", "fusion matching", "K4")
# fp32 operations per (inner step, column) of the JV solve: two subtracts,
# a compare, a select, the argmin compare, one potential update
JV_OPS_PER_STEP_COL = 6
SSL_ITERS = 3
# launches per SSL iteration (teacher B=4 + student B=8): K1 fwd, K1 bwd,
# K2, K3, K4 on the window path; K5 fwd / bwd on the key path
SSL_LAUNCHES = dict(window_key_conv_batched=24, window_key_conv_bwd=12,
                    ball_query_batched=24, fps_batched=2,
                    solve_masked_batched=2)
# the one-hot ops no model calls (K6 fwd / bwd, K8 gather / scatter): no
# launch on any of the three sparse-conv paths
ONEHOT_KERNELS = ("onehot_gather_conv", "onehot_gather_scatter",
                  "onehot_take_rows_batched", "onehot_scatter_rows")
NO_ONEHOT = dict.fromkeys(ONEHOT_KERNELS, 0)
KEY_LAUNCHES = dict(key_conv_batched=24, key_conv_bwd=12,
                    window_key_conv_batched=0, window_key_conv_bwd=0,
                    **NO_ONEHOT)
RULEBOOK_LAUNCHES = dict(gather_conv_batched=24, window_key_conv_batched=0,
                         window_key_conv_bwd=0, key_conv_batched=0,
                         key_conv_bwd=0, **NO_ONEHOT)
# the ball query (K2) and FPS (K3), and their calls per SSL iteration
POINT_KERNELS = ("ball_query_batched", "fps_batched")
POINT_CALLS = SSL_LAUNCHES["ball_query_batched"] + SSL_LAUNCHES["fps_batched"]
LEVELS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "out")
# the stages of one SSL iteration that chip_smoke times
ITER_STAGES = ("data", "teacher", "3D fwd+loss", "3D bwd", "3D opt",
               "2D fwd+loss", "2D bwd", "2D opt", "EMA")
KERNEL_META = {
    "window_key_conv_batched": dict(
        source="detmatch_tpu_torch/csrc/window_key_conv.cu",
        replaces="detmatch_tpu/ops/pallas/window_key_conv.py:142"),
    "window_key_conv_bwd": dict(
        source="detmatch_tpu_torch/csrc/window_key_conv_bwd.cu",
        replaces="detmatch_tpu/ops/pallas/window_key_conv.py:260"),
    "fps_batched": dict(
        source="detmatch_tpu_torch/csrc/fps.cu",
        replaces="detmatch_tpu/ops/pallas/fps.py:94"),
    "ball_query_batched": dict(
        source="detmatch_tpu_torch/csrc/ball_query.cu",
        replaces="detmatch_tpu/ops/pallas/ball_query.py:152"),
    "solve_masked_batched": dict(
        source="detmatch_tpu_torch/csrc/hungarian_jv.cu",
        replaces="detmatch_tpu/ops/pallas/hungarian.py:168"),
    "key_conv_batched": dict(
        source="detmatch_tpu_torch/csrc/key_conv.cu",
        replaces="detmatch_tpu/ops/pallas/onehot_key_conv.py:84"),
    "key_conv_bwd": dict(
        source="detmatch_tpu_torch/csrc/key_conv.cu",
        replaces="detmatch_tpu/ops/pallas/onehot_key_conv.py:150"),
    "onehot_gather_conv": dict(
        source="detmatch_tpu_torch/csrc/onehot_gather_conv.cu",
        replaces="detmatch_tpu/ops/pallas/onehot_gather.py:68"),
    "onehot_gather_scatter": dict(
        source="detmatch_tpu_torch/csrc/onehot_gather.cu",
        replaces="detmatch_tpu/ops/pallas/onehot_gather.py:129"),
    "gather_conv_batched": dict(
        source="detmatch_tpu_torch/csrc/gather_conv.cu",
        replaces="detmatch_tpu/ops/pallas/spconv_kernel.py:52"),
    "onehot_take_rows_batched": dict(
        source="detmatch_tpu_torch/csrc/onehot_rows.cu",
        replaces="detmatch_tpu/ops/pallas/onehot_rows.py:149"),
    "onehot_scatter_rows": dict(
        source="detmatch_tpu_torch/csrc/segment_sum.cu",
        replaces="detmatch_tpu/ops/pallas/onehot_rows.py:201"),
}


T0 = time.perf_counter()


def phase(name):
    print(f"== {name} (t={time.perf_counter() - T0:.1f}s)", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a, b):
    if b.numel() == 0:
        return float("inf")
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def randomize_(model, seed):
    """Seeded random weights: fan-in scaled normal for conv/linear
    weights, BN affine near identity, BN running statistics randomized
    (var 0.5 + U[0,1), mean 0.2 N(0,1)) so BN is not the identity."""
    g = torch.Generator().manual_seed(seed)
    sd = model.state_dict()
    for k, v in sd.items():
        if not v.is_floating_point():
            continue
        if k.endswith("running_var"):
            new = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith("running_mean"):
            new = 0.2 * torch.randn(v.shape, generator=g)
        elif v.dim() == 1:
            base = 1.0 if k.endswith(".weight") else 0.0
            new = base + 0.1 * torch.randn(v.shape, generator=g)
        else:
            out = v.shape[-1] if v.dim() == 5 else v.shape[0]
            new = torch.randn(v.shape, generator=g) / np.sqrt(v.numel() / out)
        sd[k] = new.to(v.dtype)
    model.load_state_dict(sd)


def recording(base, calls):
    """An Ops whose functions log their arguments (detached; for the
    sparse conv also whether its input needed a gradient) and call
    ``base``."""
    from detmatch_tpu_torch.ops.cuda import Ops

    def wrap(name, fn):
        def rec(*args, **kwargs):
            calls.append((name, tuple(
                a.detach() if isinstance(a, torch.Tensor) else a
                for a in args), kwargs, args[0].requires_grad))
            return fn(*args, **kwargs)
        return rec

    return Ops(*(wrap(n, f) for n, f in zip(Ops._fields, base)))


def make_batch(spec, b, valid_counts=None):
    from detmatch_tpu_torch.ops.voxelize import voxelize_mean
    from detmatch_tpu_torch.utils.synth_kitti import lidar_batch
    rng = np.random.RandomState(SEED)
    pts, valid = lidar_batch(rng, b, NUM_POINTS, spec.point_cloud_range)
    if valid_counts is not None:
        for i, n in enumerate(valid_counts):
            valid[i, n:] = False
    points = torch.from_numpy(pts).to(DEVICE)
    points_valid = torch.from_numpy(valid).to(DEVICE)
    vox = voxelize_mean(points, points_valid, spec)
    return dict(points=points, points_valid=points_valid,
                voxel_features=vox["features"], voxel_keys=vox["keys"])


def make_train_model(cfg):
    """The config's PV-RCNN on the card, in train mode, with the model's
    own (pcdet) initialisers seeded from SEED: the state a pretraining run
    starts from (the classification prior bias, std-1e-3 box layers).
    Fully random heads (``randomize_``) put every anchor near p = 0.5; the
    nearly uniform focal-loss gradient then leaves the train-mode BN
    backward a difference of near-equal numbers, which turns 1e-7
    rounding into percent-level gradient noise."""
    from detmatch_tpu_torch.apis.build import build_detector
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = build_detector(cfg)  # the card: build_detector's default
    return model.train()


def make_train_frames(spec):
    """B=2 collated numpy training frames: 18,000-point synthetic scans and
    the JAX benchmark's 40-slot GT boxes (20 valid)."""
    from detmatch_tpu_torch.utils.synth_kitti import gt_boxes, lidar_batch
    rng = np.random.RandomState(SEED)
    pts, valid = lidar_batch(rng, TRAIN_B, TRAIN_POINTS,
                             spec.point_cloud_range)
    return dict(points=pts, points_valid=valid,
                gt_boxes=gt_boxes(rng, TRAIN_B))


def check_kernels(calls, label, stats):
    """Run each recorded main-path call through kernel and twin."""
    from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN
    kern = dict(zip(KERNELS._fields, KERNELS))
    plain = dict(zip(PLAIN._fields, PLAIN))
    ok = True
    for i, (name, args, kwargs, _) in enumerate(calls):
        k_out = kern[name](*args, **kwargs)
        p_out = plain[name](*args, **kwargs)
        torch.cuda.synchronize()
        st = stats.setdefault(name, dict(max_abs_err=0.0, cases=0))
        st["cases"] += 1
        if name in ("window_key_conv_batched", "key_conv_batched",
                    "gather_conv_batched"):
            err = rel_err(k_out, p_out)
            st["max_abs_err"] = max(st["max_abs_err"],
                                    float((k_out - p_out).abs().max()))
            good = err <= CONV_RTOL
            rb = args[1] if name == "gather_conv_batched" else args[2]
            desc = (f"rel_err={err:.3e} shape={tuple(k_out.shape)} "
                    f"taps={rb.shape[-1]}")
            if name == "gather_conv_batched":
                desc += f" bit-equal to the twin={torch.equal(k_out, p_out)}"
        else:
            k_out = k_out if isinstance(k_out, tuple) else (k_out,)
            p_out = p_out if isinstance(p_out, tuple) else (p_out,)
            good = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
            diff = max(int((a.long() - b.long()).abs().max())
                       for a, b in zip(k_out, p_out))
            st["max_abs_err"] = max(st["max_abs_err"], float(diff))
            extra = ""
            if name == "ball_query_batched":
                extra = (f" r={args[4]} ns={args[5]} "
                         f"mean_cnt={float(k_out[1].float().mean()):.2f}")
            desc = (f"exact={good} shape={tuple(k_out[0].shape)}{extra}")
        print(f"  {label} {name}[{i}] {desc} {'ok' if good else 'FAIL'}")
        ok &= good
    return ok


def check_k1_exact(calls, label):
    """On every recorded K1 forward call: the kernel, with and without
    writing its rulebook, bit-equal to K7 on the plain rulebook (the same
    order of sums; skipped taps change no bit), and the rulebook it
    writes equal to the plain one. Returns (all equal, calls checked)."""
    from detmatch_tpu_torch.ops import spconv
    from detmatch_tpu_torch.ops.cuda import KERNELS
    from detmatch_tpu_torch.ops.cuda.window_key_conv import (
        window_key_conv_fwd)
    ok, checked = True, 0
    for i, (name, args, _, _) in enumerate(calls):
        if name != "window_key_conv_batched":
            continue
        feats, keys, nkeys, _, w, _ = args
        rb_plain = spconv.rulebook_batched(keys, nkeys)
        out, rb = window_key_conv_fwd(*args, rulebook=True)
        bare, _ = window_key_conv_fwd(*args)
        k7 = KERNELS.gather_conv_batched(feats, rb_plain, w)
        torch.cuda.synchronize()
        same = torch.equal(out, k7) and torch.equal(bare, k7)
        rb_same = torch.equal(rb, rb_plain)
        pairs = int((rb_plain >= 0).sum())
        print(f"  {label} K1 fwd[{i}] bit-equal to K7={same} rulebook "
              f"equal={rb_same} (B, M, K)={tuple(nkeys.shape)} C={w.shape[1]}"
              f" Co={w.shape[2]} pairs {pairs} "
              f"({pairs / rb_plain.numel():.4f} of capacity x K) "
              f"{'ok' if same and rb_same else 'FAIL'}")
        ok &= same and rb_same
        checked += 1
    return ok, checked


# K1 backward's kernels (csrc/window_key_conv_bwd.cu) by their passes
K1_BWD_PASSES = (("Memset", "inv fill"), ("pair_count", "count"),
                 ("pair_scan", "scan"), ("pair_fill", "fill"),
                 ("dweight_partial", "dW"), ("dweight_reduce", "dW reduce"),
                 ("transpose_taps", "W^T"), ("gather_gemm", "dF"),
                 ("repeat_rows", "repeat pass"))


def kernel_passes(fn, passes, reps=1):
    """Device ms per call of each pass of ``fn`` (``passes``: (a piece of
    the kernel's or memset's name, label)), from the profiler's kernel
    times over ``reps`` calls; a pass the trace did not record is
    missing."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", None)
              or getattr(ev, "cuda_time_total", 0))
        for key, label in passes:
            if key in ev.key and us:
                out[label] = out.get(label, 0.0) + us / 1e3 / reps
    return out


def k1_breakdown(bwd_cases, card):
    """Per student conv of the SSL iteration (B=8): matched pairs and
    their share of capacity x K, K1 fwd (writing its rulebook, as the
    student's forward does) and K1 bwd ms (CUDA events) beside their
    bounds, and the backward's passes from the profiler's kernel times
    of one launch. Returns the sums (ms; the repeat pass's device ms)."""
    from detmatch_tpu_torch.ops.cuda.window_key_conv import (
        window_key_conv_bwd, window_key_conv_fwd)
    tot = dict(fwd=0.0, bwd=0.0, fwd_bound=0.0, bwd_bound=0.0, repeat=0.0)
    for j, (args, need, dout, rb) in enumerate(bwd_cases):
        feats, _, nkeys, _, w, _ = args
        pairs = int((rb >= 0).sum())
        fwd = cuda_ms(lambda: window_key_conv_fwd(*args, rulebook=True),
                      reps=5)
        bwd = cuda_ms(lambda: window_key_conv_bwd(dout, feats, rb, w,
                                                  need_dfeats=need), reps=5)
        fb, bb = {}, {}
        add_bound(fb, *work("window_key_conv_batched", args, {}))
        add_bound(bb, *work("window_key_conv_bwd", args, {}, need))
        passes = kernel_passes(lambda: window_key_conv_bwd(
            dout, feats, rb, w, need_dfeats=need), K1_BWD_PASSES)
        for k, v in (("fwd", fwd), ("bwd", bwd), ("fwd_bound", fb[
                "bound_ms"]), ("bwd_bound", bb["bound_ms"]),
                     ("repeat", passes.get("repeat pass", 0.0))):
            tot[k] += v
        print(f"  student conv {j}: (B, M, K)={tuple(nkeys.shape)} N="
              f"{feats.shape[1]} C={w.shape[1]} Co={w.shape[2]}: pairs "
              f"{pairs} ({pairs / rb.numel():.4f} of capacity x K); fwd "
              f"{fwd:.4f} ms (bound {fb['bound_ms']:.4f}, "
              f"{fb['bound_ms'] / fwd:.1%}); bwd {bwd:.4f} ms (bound "
              f"{bb['bound_ms']:.4f}, {bb['bound_ms'] / bwd:.1%}; dF "
              f"{need}); bwd passes (profiler, one launch): "
              + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
              + f" ms [{card}]")
    print(f"  student convs together: fwd {tot['fwd']:.3f} ms (bound "
          f"{tot['fwd_bound']:.4f}, {tot['fwd_bound'] / tot['fwd']:.1%}), "
          f"bwd {tot['bwd']:.3f} ms (bound {tot['bwd_bound']:.4f}, "
          f"{tot['bwd_bound'] / tot['bwd']:.1%}); the bwd's repeat pass "
          f"(no flag: returns at once) {1e3 * tot['repeat']:.1f} µs of "
          f"device time over the {len(bwd_cases)} (profiler) [{card}]")
    return tot


def k2_scan(args):
    """Means over a ball-query call's valid centers: the y-window (sorted
    table positions within r plus the kernel's slack of the center's y)
    and the positions a scan of it reads before it stops (the window, or
    up to the nsample-th hit)."""
    from detmatch_tpu_torch.ops import pointnet
    centers, cvalid, pts, pvalid, radius, ns = args[:6]
    r = float(np.float32(radius))
    cy = centers[..., 1].double()
    slack = 1e-3 * r + 1e-6 * (cy.abs() + 1.0)
    ykey = torch.where(pvalid, pts[..., 1], float("inf")).double()
    lo = torch.searchsorted(ykey, (cy - r - slack).contiguous())
    hi = torch.searchsorted(ykey, (cy + r + slack).contiguous(), right=True)
    idx, cnt = pointnet.ball_query(centers, cvalid, pts, pvalid,
                                   float(pointnet.radius_sq(radius)), ns)
    scanned = torch.where(cnt == ns, idx[..., -1].long() + 1, hi) - lo
    return (float((hi - lo)[cvalid].double().mean()),
            float(scanned[cvalid].double().mean()))


# the sites of one PV-RCNN pass's 12 ball queries, in call order: the VSA
# on the raw points and x_conv1..4 (two radii each), then the RoI grid
K2_SITES = (("raw points",) * 2 + tuple(f"x_conv{i // 2 + 1}"
                                       for i in range(8))
            + ("RoI grid",) * 2)


def kernel_device_ms(fn, key, reps=5):
    """Mean device time per call of the kernels whose name holds ``key``
    (the profiler's kernel times over ``reps`` calls of ``fn``; a trace
    that recorded none of them is taken again, up to three times)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum((getattr(ev, "device_time_total", None)
                  or getattr(ev, "cuda_time_total", 0))
                 for ev in prof.key_averages() if key in ev.key)
        if us:
            break
    return us / 1e3 / reps


def k2_breakdown(calls, card):
    """Per ball-query call (K2) of ``calls``: site, B, M, N (and valid
    points), r, nsample, the G lanes a center gets, mean window, positions
    scanned and count, ms (CUDA events over back-to-back wrapper calls,
    host time included) and the kernel's device ms (profiler) beside the
    bound and its share."""
    from detmatch_tpu_torch.ops.cuda import ball_query as bq
    total = dict(ms=0.0, dev=0.0, bound=0.0)
    k2 = [c for c in calls if c[0] == "ball_query_batched"]
    for j, (_, args, kwargs, _) in enumerate(k2):
        centers, cvalid, pts, pvalid, radius, ns = args
        b, m, n = centers.shape[0], centers.shape[1], pts.shape[1]
        window, scanned = k2_scan(args)
        out = bq.ball_query_batched(*args, **kwargs)
        ms = cuda_ms(lambda: bq.ball_query_batched(*args, **kwargs), reps=5)
        dev = kernel_device_ms(lambda: bq.ball_query_batched(*args, **kwargs),
                               "ball_query_kernel")
        t = {}
        add_bound(t, *work("ball_query_batched", args, kwargs, out=out))
        total["ms"] += ms
        total["dev"] += dev
        total["bound"] += t["bound_ms"]
        group = bq.group_lanes(m, n, radius, ns)
        print(f"  K2 {j}: {K2_SITES[j % 12]} B={b} M={m} N={n} (valid "
              f"{float(pvalid.sum(1).double().mean()):.0f}) r={radius} "
              f"ns={ns} G={group}: window {window:.1f}, scanned "
              f"{scanned:.1f}, count {float(out[1].double().mean()):.2f}; "
              f"{ms:.4f} ms, device {dev:.4f} ms (bound "
              f"{t['bound_ms']:.5f}, {t['bound_ms'] / ms:.1%}) [{card}]")
    print(f"  K2 over {len(k2)} calls: {total['ms']:.3f} ms, device "
          f"{total['dev']:.3f} ms (bound {total['bound']:.4f}, "
          f"{total['bound'] / total['ms']:.1%}) [{card}]")


def k3_line(label, xyz, valid, k, card):
    """One FPS call (K3): B, N, the plan (cluster size C, points a thread
    P) and the clusters the card holds at once, ms (CUDA events), µs per
    step and the share of its bound."""
    from detmatch_tpu_torch.ops.cuda import fps
    b, n = valid.shape
    plan = fps.fps_plan(b, n)
    ms = cuda_ms(lambda: fps.fps_batched(xyz, valid, k), reps=3)
    t = {}
    add_bound(t, *work("fps_batched", (xyz, valid, k), {}))
    print(f"  K3 {label}: B={b} N={n} (valid "
          f"{float(valid.sum(1).double().mean()):.0f}) samples={k} C="
          f"{plan.cluster} P={plan.per_thread} (active clusters "
          f"{fps.active_clusters(plan)}): {ms:.4f} ms, "
          f"{1e3 * ms / k:.3f} us/step (bound {t['bound_ms']:.5f}, "
          f"{t['bound_ms'] / ms:.1%}) [{card}]")


def k3_step_floor(b, k, card):
    """K3 at a minimal sweep: N = one point a thread of the plan for B
    frames of TRAIN_POINTS, k samples; µs per step."""
    from detmatch_tpu_torch.ops.cuda import fps
    from detmatch_tpu_torch.utils.synth_kitti import SSL_PCR, lidar_batch
    plan = fps.fps_plan(b, TRAIN_POINTS)._replace(per_thread=1)
    n = plan.cluster * fps.CTA_THREADS
    pts, valid = lidar_batch(np.random.RandomState(SEED), b, n, SSL_PCR)
    xyz = torch.from_numpy(pts[..., :3].copy()).to(DEVICE)
    v = torch.from_numpy(valid).to(DEVICE)
    out = fps.fps_launch(xyz, v, k, plan)
    ok = torch.equal(out, fps.fps_plain(xyz, v, k))
    ms = cuda_ms(lambda: fps.fps_launch(xyz, v, k, plan), reps=3)
    print(f"  K3 step floor B={b}: N={n} (one point a thread: C="
          f"{plan.cluster}), {k} samples, equal to the twin {ok}: "
          f"{ms:.4f} ms, {1e3 * ms / k:.3f} us/step [{card}]")
    return ok


def device_ms(fn, reps=20):
    """Mean device time per call: ``reps`` calls queued behind a spin
    kernel (``torch.cuda._sleep``, ~10 ms) so that the card runs them back
    to back whatever the host's time per call, bracketed by CUDA events.
    (The profiler drops kernel records late in a long run of this script:
    K1's backward passes print partly empty there.)"""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k4_line(label, cost, row_valid, card, plan=None, reps=20):
    """One K4 call: B, K, valid rows, inner steps per element, ms (CUDA
    events over back-to-back wrapper calls, host time included), device
    ms (:func:`device_ms`) and µs per step over the largest element's
    steps;
    ``plan`` the design the wrapper picks. Returns (ms, device ms)."""
    from detmatch_tpu_torch.ops.cuda import hungarian
    steps = hungarian.inner_steps(cost, row_valid)
    ms = cuda_ms(lambda: hungarian.solve_masked_batched(cost, row_valid),
                 reps=reps)
    dev = device_ms(lambda: hungarian.solve_masked_batched(cost, row_valid),
                    reps=reps)
    top = int(steps.max())
    step = f"{1e3 * dev / top:.4f} us/step" if top else "no inner step"
    print(f"  K4 {label}: B={cost.shape[0]} K={cost.shape[-1]} valid rows "
          f"{row_valid.sum(1).tolist()}, inner steps {steps.tolist()}"
          + (f", plan {plan}" if plan is not None else "")
          + f": {ms:.4f} ms, device {dev:.4f} ms, {step} [{card}]")
    return ms, dev


def k4_chain(k, b=1):
    """B copies of the K x K problem c[i, j] = i * j, every row valid:
    inserting row i walks an augmenting path through all i matched
    columns, K (K + 1) / 2 inner steps in all, the longest possible."""
    i = torch.arange(k, dtype=torch.float32, device=DEVICE)
    cost = (i[:, None] * i[None]).expand(b, k, k).contiguous()
    return cost, torch.ones(b, k, dtype=torch.bool, device=DEVICE)


def k4_step_floor(card, plan=None):
    """K4's step floor: µs per inner step on k4_chain at K = 32 (one
    column a lane of the warp design) and K = 128, equal to the twin.
    ``plan(k)`` the design the wrapper picks. Returns whether both are
    equal."""
    from detmatch_tpu_torch.ops.cuda import hungarian
    ok = True
    for k in (32, 128):
        cost, rv = k4_chain(k)
        same = torch.equal(hungarian.solve_masked_batched(cost, rv),
                           hungarian.solve_masked_plain(cost, rv))
        dev = device_ms(lambda: hungarian.solve_masked_batched(cost, rv),
                        reps=10)
        steps = k * (k + 1) // 2
        print(f"  K4 step floor K={k}: c[i, j] = i * j, {steps} inner steps"
              + (f", plan {plan(k)}" if plan is not None else "")
              + f", equal to the twin {same}: device {dev:.4f} ms, "
              f"{1e3 * dev / steps:.4f} us/step [{card}]")
        ok &= same
    return ok


def k5_breakdown(calls, card, rows=None, reps=10):
    """Per key-path student conv (B=8, ``calls`` the K5 argument tuples):
    matched pairs and their share of capacity x K, K5 fwd ms (CUDA
    events) and device ms (:func:`device_ms`), the bound and its share,
    and ``rows(k, c, co)``, the tile rows the wrapper picks. Returns the
    (ms, device ms) sums."""
    from detmatch_tpu_torch.ops.cuda import key_conv as kc
    tot = dict(ms=0.0, dev=0.0, bound=0.0)
    for j, args in enumerate(calls):
        feats, keys, nkeys, w, _ = args
        pairs = conv_pairs(args)
        ms = cuda_ms(lambda: kc.key_conv_batched(*args), reps=reps)
        dev = device_ms(lambda: kc.key_conv_batched(*args), reps=reps)
        t = {}
        add_bound(t, *work("key_conv_batched", args, {}), BF16_FLOP_PER_S)
        tot["ms"] += ms
        tot["dev"] += dev
        tot["bound"] += t["bound_ms"]
        k, c, co = w.shape
        print(f"  K5 student conv {j}: (B, M, K)={tuple(nkeys.shape)} N="
              f"{feats.shape[1]} C={c} Co={co}"
              + (f" rows {rows(k, c, co)}" if rows is not None else "")
              + f": pairs {pairs} ({pairs / nkeys.numel():.4f} of capacity "
              f"x K); {ms:.4f} ms, device {dev:.4f} ms (bound "
              f"{t['bound_ms']:.5f} by {t['bound_by']}, "
              f"{t['bound_ms'] / ms:.1%}) [{card}]")
    print(f"  K5 over {len(calls)} student convs: {tot['ms']:.3f} ms, device "
          f"{tot['dev']:.3f} ms (bound {tot['bound']:.4f}, "
          f"{tot['bound'] / tot['ms']:.1%}) [{card}]")
    return tot["ms"], tot["dev"]


# K5 backward's kernels (csrc/key_conv.cu) by their passes: the earlier
# design (a zero fill of S, then a key search and a scatter of the
# matched rows) and the current one (the inverse map from the forward's
# rulebook, then one pass that writes every row of S)
K5_BWD_PASSES = (("zero_kernel", "zero fill"),
                 ("key_scatter_kernel", "search + scatter"),
                 ("Memset", "inverse fill"), ("invert_rulebook", "inverse"),
                 ("write_s", "S write"), ("repeat_sums", "repeat pass"))


def k5_bwd_breakdown(cases, card, scatter, reps=10):
    """Per key-path student conv (B=8; ``cases`` the (dout, keys, nkeys,
    rb) of each, rb the forward's rulebook): ``scatter(dout, keys, nkeys,
    rb)``'s ms (CUDA events), device ms (:func:`device_ms`) and passes
    (profiler), the library call's ms (``new_zeros`` and ``index_put_``
    of the bf16-rounded dout rows at slots prepared outside the timing),
    and the bound and its share. Returns the sums (ms, dev, lib, bound)."""
    tot = dict(ms=0.0, dev=0.0, lib=0.0, bound=0.0, repeat=0.0)
    for j, (dout, keys, nkeys, rb) in enumerate(cases):
        b, n = keys.shape
        k, co = nkeys.shape[2], dout.shape[-1]
        ms = cuda_ms(lambda: scatter(dout, keys, nkeys, rb), reps=reps)
        dev = device_ms(lambda: scatter(dout, keys, nkeys, rb), reps=reps)
        passes = kernel_passes(lambda: scatter(dout, keys, nkeys, rb),
                               K5_BWD_PASSES, reps=3)
        bi, mi, ki = (rb >= 0).nonzero(as_tuple=True)
        slots = ki * (b * n) + bi * n + rb[bi, mi, ki].long()
        rounded = dout[bi, mi].to(torch.bfloat16).to(torch.float32)
        lib = cuda_ms(lambda: dout.new_zeros((k * b * n, co)).index_put_(
            (slots,), rounded), reps=reps)
        del bi, mi, ki, slots, rounded
        t = {}
        add_bound(t, *work("key_conv_bwd", (dout, rb, n), {}))
        for key, v in (("ms", ms), ("dev", dev), ("lib", lib),
                       ("bound", t["bound_ms"]),
                       ("repeat", passes.get("repeat pass", 0.0))):
            tot[key] += v
        pairs = int((rb >= 0).sum())
        print(f"  K5 bwd student conv {j}: (B, M, K)={tuple(nkeys.shape)} "
              f"N={n} Co={co}: pairs {pairs}, S {k * b * n * co * 4 / 1e6:.1f}"
              f" MB; {ms:.4f} ms, device {dev:.4f} ms (bound "
              f"{t['bound_ms']:.5f}, {t['bound_ms'] / ms:.1%}); passes "
              "(profiler): " + ", ".join(f"{key} {v:.4f}" for key, v in
                                          passes.items())
              + f" ms; library {lib:.4f} ms [{card}]")
    print(f"  K5 bwd over {len(cases)} student convs: {tot['ms']:.3f} ms, "
          f"device {tot['dev']:.3f} ms, library {tot['lib']:.3f} ms (bound "
          f"{tot['bound']:.4f}, {tot['bound'] / tot['ms']:.1%}); the repeat "
          f"pass (no flag: returns at once) {1e3 * tot['repeat']:.1f} µs of "
          f"device time over the {len(cases)} (profiler) [{card}]")
    return tot


def k7_breakdown(calls, card, rows=None, reps=10):
    """Per rulebook-path student conv (B=8, ``calls`` the K7 argument
    tuples (feats, rb, w)): matched pairs and their share of capacity x
    K, ``rows(k, c, co)``, the tile rows the wrapper picks, K7 ms (CUDA
    events) and device ms (:func:`device_ms`) beside the bound and its
    share. Returns the (ms, device ms) sums."""
    from detmatch_tpu_torch.ops.cuda import gather_conv as gc
    tot = dict(ms=0.0, dev=0.0, bound=0.0)
    for j, args in enumerate(calls):
        feats, rb, w = args
        pairs = int((rb >= 0).sum())
        ms = cuda_ms(lambda: gc.gather_conv_batched(*args), reps=reps)
        dev = device_ms(lambda: gc.gather_conv_batched(*args), reps=reps)
        t = {}
        add_bound(t, *work("gather_conv_batched", args, {}))
        tot["ms"] += ms
        tot["dev"] += dev
        tot["bound"] += t["bound_ms"]
        k, c, co = w.shape
        print(f"  K7 student conv {j}: (B, M, K)={tuple(rb.shape)} N="
              f"{feats.shape[1]} C={c} Co={co}"
              + (f" rows {rows(k, c, co)}" if rows is not None else "")
              + f": pairs {pairs} ({pairs / rb.numel():.4f} of capacity x "
              f"K); {ms:.4f} ms, device {dev:.4f} ms (bound "
              f"{t['bound_ms']:.5f} by {t['bound_by']}, "
              f"{t['bound_ms'] / ms:.1%}) [{card}]")
    print(f"  K7 over {len(calls)} student convs: {tot['ms']:.3f} ms, device "
          f"{tot['dev']:.3f} ms (bound {tot['bound']:.4f}, "
          f"{tot['bound'] / tot['ms']:.1%}) [{card}]")
    return tot["ms"], tot["dev"]


def k5_student_checks(kcalls, stats, g):
    """On the student's (B=8) K5 calls of ``kcalls``: the forward
    bit-equal over two launches, with its rulebook written (as the
    student's forward writes it) bit-equal again and that rulebook equal
    to the plain one; the backward on that rulebook, for a cotangent
    drawn from ``g``, S exactly the twin's and bit-equal over two
    launches. Returns (all held, the (dout, keys, nkeys, rb) of each)."""
    from detmatch_tpu_torch.ops import spconv
    from detmatch_tpu_torch.ops.cuda import key_conv as kc
    st = stats.setdefault("key_conv_bwd", dict(max_abs_err=0.0, cases=0))
    ok, key_bwd = True, []
    for i, (_, args, _, _) in enumerate(kcalls):
        if args[0].shape[0] != 2 * SSL_B:
            continue
        feats, keys, nkeys, w, band = args
        out = kc.key_conv_batched(*args)
        twice = torch.equal(out, kc.key_conv_batched(*args))
        out_rb, rb = kc.key_conv_fwd(feats, keys, nkeys, w, rulebook=True)
        rb_same = (torch.equal(out_rb, out) and torch.equal(
            rb, spconv.rulebook_batched(keys, nkeys)))
        ok &= twice and rb_same
        print(f"  key path key_conv_batched[{i}] two launches "
              f"bit-equal={twice}, with its rulebook written bit-equal "
              f"and that rulebook equal to the plain one={rb_same} "
              f"{'ok' if twice and rb_same else 'FAIL'}")
        dout = torch.randn(feats.shape[0], nkeys.shape[1], w.shape[-1],
                           generator=g, device=DEVICE)
        n = keys.shape[1]
        s_k = kc.key_conv_bwd(dout, rb, n)
        again = torch.equal(s_k, kc.key_conv_bwd(dout, rb, n))
        s_p = kc.key_scatter_plain(dout, keys, nkeys)
        torch.cuda.synchronize()
        exact = torch.equal(s_k, s_p)
        st["cases"] += 1
        st["max_abs_err"] = max(st["max_abs_err"],
                                float((s_k - s_p).abs().max()))
        ok &= exact and again
        print(f"  key path key_conv_bwd[{i}] S exact={exact}, two "
              f"launches bit-equal={again}, S {tuple(s_k.shape)} "
              f"nonzero rows {int(s_k.abs().amax(-1).gt(0).sum())} "
              f"{'ok' if exact and again else 'FAIL'}")
        key_bwd.append((dout, keys, nkeys, rb))
        del s_k, s_p, out, out_rb
    return ok, key_bwd


def compare_dense(out_k, out_p):
    """Keypoints exactly, and every output before the proposal NMS."""
    ok = torch.equal(out_k["keypoints"], out_p["keypoints"])
    print(f"  keypoints exactly equal: {ok}")
    pairs = [(f"backbone.{n}.feats", out_k["backbone"][n]["feats"],
              out_p["backbone"][n]["feats"]) for n in out_k["backbone"]]
    pairs += [(k, out_k[k], out_p[k]) for k in (
        "spatial_features", "bev_features", "batch_box_preds",
        "batch_cls_preds", "point_logits", "point_features")]
    for name, a, b in pairs:
        ok &= report(name, rel_err(a, b))
    return ok


def report(name, err):
    good = err <= E2E_RTOL
    print(f"  {name}: rel_err={err:.3e} {'ok' if good else 'FAIL'}")
    return good


def roi_share(out_k, out_p):
    """Share of proposal slots holding the same roi (within tolerance)."""
    roi_err = (out_k["rois"] - out_p["rois"]).abs().amax(-1)
    same = roi_err <= E2E_RTOL * out_p["rois"].abs().max()
    return same, float(same.float().mean())


def compare_paths(out_k, out_p):
    """Kernel path against plain path on the same card."""
    ok = compare_dense(out_k, out_p)
    same, share = roi_share(out_k, out_p)
    print(f"  rois matching within {E2E_RTOL:g}: {share:.4f} of slots")
    ok &= share >= MATCH_SHARE
    for k in ("rcnn_cls", "rcnn_reg"):
        ok &= report(f"{k} on matching rois",
                     rel_err(out_k[k][same], out_p[k][same]))
    return ok


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def match_share(det_k, det_p):
    """Share of valid detections with a counterpart on the other path
    (same label, box within 1e-3, score within 1e-4)."""
    matched = total = 0
    for b in range(det_k["boxes"].shape[0]):
        vk, vp = det_k["valid"][b], det_p["valid"][b]
        bk, bp = det_k["boxes"][b][vk], det_p["boxes"][b][vp]
        sk, sp = det_k["scores"][b][vk], det_p["scores"][b][vp]
        lk, lp = det_k["labels"][b][vk], det_p["labels"][b][vp]
        total += max(len(bk), len(bp))
        if len(bk) == 0 or len(bp) == 0:
            continue
        close = (((bk[:, None] - bp[None]).abs().amax(-1) <= 1e-3)
                 & ((sk[:, None] - sp[None]).abs() <= 1e-4)
                 & (lk[:, None] == lp[None]))
        matched += int(close.any(1).sum())
    return matched / max(total, 1), total


def run():
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase("precision")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off (matmul, cudnn)")

    sys.path.insert(0, str(ROOT))
    from detmatch_tpu_torch.apis.build import build_detector, build_voxelizer
    from detmatch_tpu_torch.apis.inference import detect
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN, build
    from detmatch_tpu_torch.ops.voxelize import INVALID_KEY

    phase("build")
    t0 = time.perf_counter()
    res = build.build()
    build.load_library()
    print(f"built={res.built} nvcc_s={res.seconds:.2f} "
          f"total_s={time.perf_counter() - t0:.2f} -> {res.path.name}")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    cfg = Config.fromfile(str(CONFIG))
    spec = build_voxelizer(cfg)
    model = build_detector(cfg, device=DEVICE)
    randomize_(model, SEED)
    batch4 = make_batch(spec, 4)
    batch3 = make_batch(spec, 3, valid_counts=(NUM_POINTS, 9000, 4000))
    for b, bt in ((4, batch4), (3, batch3)):
        n_vox = (bt["voxel_keys"] != INVALID_KEY).sum(1).tolist()
        print(f"voxels per frame B={b}: {n_vox}")

    phase("kernels against plain twins (main-path shapes)")
    stats = {}
    calls4, calls3, calls1 = [], [], []
    with torch.inference_mode():
        model.ops = recording(PLAIN, calls4)
        model(batch4)
        model.ops = recording(PLAIN, calls3)
        model(batch3)
        model.ops = recording(PLAIN, calls1)
        model({k: v[:1] for k, v in batch4.items()})
        model.ops = KERNELS
        ok = check_kernels(calls4, "B=4", stats)
        ok &= check_kernels(calls3, "B=3", stats)
        ok &= check_kernels(calls1, "B=1", stats)
    counts = {n: sum(c[0] == n for c in calls4) for n in FWD_KERNELS}
    print(f"calls per forward: {counts}")
    if not ok:
        raise AssertionError("a kernel disagrees with its plain twin")

    phase("kernels against plain twins (repeated writers, C = 5 and 128)")
    if not conv_edge_cases():
        raise AssertionError("a sparse conv disagrees with its twin on "
                             "repeated writers or at C = 5 / 128, or its "
                             "backward differs between two launches")

    phase("end to end (kernel path)")
    with torch.inference_mode():
        cuda_ops.reset_launch_counts()
        det_k = detect(model, batch4["points"], batch4["points_valid"], spec,
                       score_thresh=0.0)
        torch.cuda.synchronize()
        launches = cuda_ops.launch_counts()
    print(f"launches in detect(): {launches}")
    if not all(launches[n] > 0 for n in FWD_KERNELS):
        raise AssertionError("a kernel of the path was not launched")
    n_valid = det_k["valid"].sum(1).tolist()
    finite = all(bool(torch.isfinite(det_k[k]).all())
                 for k in ("boxes", "scores"))
    print(f"detections per frame: {n_valid} finite={finite} "
          f"boxes {tuple(det_k['boxes'].shape)}")
    if not finite or min(n_valid) == 0:
        raise AssertionError("non-finite or empty detections")

    phase("end to end (kernel path against plain path)")
    with torch.inference_mode():
        model.ops = KERNELS
        out_k = model(batch4)
        model.ops = PLAIN
        out_p = model(batch4)
        det_p = detect(model, batch4["points"], batch4["points_valid"], spec,
                       score_thresh=0.0)
        model.ops = KERNELS
    ok = compare_paths(out_k, out_p)
    share, total = match_share(det_k, det_p)
    print(f"  detections matched: {share:.4f} of {total}")
    if not ok or share < MATCH_SHARE:
        raise AssertionError("kernel path disagrees with the plain path")
    del out_k, out_p

    phase("end to end (kernel path on the card against plain path on "
          "the CPU, B=1)")
    batch1 = {k: v[:1] for k, v in batch4.items()}
    cpu_model = build_detector(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        out_k1 = to_cpu(model(batch1))
        out_c1 = cpu_model({k: v.cpu() for k, v in batch1.items()})
        # the RoI head on the card's own proposals: random weights give
        # densely tied proposal scores, and 1e-6 noise between devices
        # reorders them at the top-k / NMS cut
        rcnn_c1 = cpu_model.roi_head(
            out_k1["rois"], out_k1["keypoints"], out_k1["kp_valid"],
            out_k1["point_features"], out_k1["point_scores"])
    ok = compare_dense(out_k1, out_c1)
    for k, ref in zip(("rcnn_cls", "rcnn_reg"), rcnn_c1):
        ok &= report(f"{k} on the same rois", rel_err(out_k1[k], ref))
    _, share = roi_share(out_k1, out_c1)
    print(f"  proposal slots equal across devices: {share:.4f} "
          "(information: NMS order under 1e-6 score noise)")
    if not ok:
        raise AssertionError("kernel path disagrees with the CPU reference")
    del cpu_model, out_c1, out_k1

    phase(f"timing (CUDA events) on {card}")
    with torch.inference_mode():
        for path, ops in (("kernel", KERNELS), ("plain", PLAIN)):
            model.ops = ops
            for b, bt in ((1, batch1), (4, batch4)):
                ms = cuda_ms(lambda: detect(model, bt["points"],
                                            bt["points_valid"], spec,
                                            score_thresh=0.0), reps=2)
                print(f"  {path} path B={b}: {ms:.3f} ms/call "
                      f"({1000.0 * b / ms:.3f} frames/s) [{card}]")
        model.ops = KERNELS
        per_kernel = time_kernels(calls4, {})
        for name in FWD_KERNELS:
            print(f"  {name}: {describe(per_kernel[name])} per B=4 forward, "
                  f"{counts[name]} calls [{card}]")
        xyz, valid, k = next(c[1] for c in calls4 if c[0] == "fps_batched")
        for b in (1, 4):
            k3_line(f"detect B={b}", xyz[:b], valid[:b], k, card)
    del model, batch3, batch4, batch1

    train_phases(cfg, spec, card, stats)
    teacher_phases(card, stats)
    per = ssl_phases(card, stats)
    bf16_phases(card)
    tmp = tempfile.TemporaryDirectory(prefix="kitti_tree_")
    try:
        base = Path(tmp.name)
        (base / "kitti").mkdir()
        cli_data(base / "kitti")
        tree_phases(card, base / "kitti", base / "work")
        ckpts = cli_phases(card, base / "kitti", base / "cli")
        demo_phases(card, base / "kitti", base / "demo", ckpts)
    finally:
        tmp.cleanup()
    zoo_phases(card, stats)
    mono_phases(card)
    dist_phases(card)
    study_phases(card)
    import_phases(card)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=meta["source"],
             replaces=meta["replaces"], launches=per[name]["launches"],
             max_abs_err=stats[name]["max_abs_err"],
             ms=per[name]["ms"], plain_ms=per[name]["plain_ms"],
             bound_ms=per[name]["bound_ms"],
             bound_by=per[name]["bound_by"],
             library_ms=per[name].get("library_ms"),
             **({"replayed_calls": per[name]["replayed_calls"]}
                if "replayed_calls" in per[name] else {}))
        for name, meta in KERNEL_META.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def conv_edge_cases():
    """Off the main path, at a small dense shape (B=2, 2,000 and 700
    voxels): a submanifold conv whose neighbour keys repeat within a tap
    (two writers a slot at tap 4, one slot of 2,000 at tap 22) at C = Co
    = 16, and convs at C = 5 (Co = 3) and C = Co = 128, through K1, K5 and
    K7 and their twins: outputs and dF, dW within 1e-5 of each tensor's
    largest magnitude, K1's and K5's backward the same bits over two
    launches, K5's S exactly its twin's. Returns whether all held."""
    from detmatch_tpu_torch.ops import spconv, voxelize
    from detmatch_tpu_torch.ops.cuda import gather_conv as gc
    from detmatch_tpu_torch.ops.cuda import key_conv as kc
    from detmatch_tpu_torch.ops.cuda import window_key_conv as wkc

    g = torch.Generator().manual_seed(SEED)
    shape, n = (11, 40, 36), 2000
    band = int(np.prod(shape)) + 1
    keys = []
    for n_valid in (n, 700):
        kk = torch.sort(torch.randperm(band - 1, generator=g)[:n_valid]
                        ).values.to(torch.int32)
        keys.append(torch.cat([kk, torch.full(
            (n - n_valid,), voxelize.INVALID_KEY, dtype=torch.int32)]))
    keys = torch.stack(keys).to(DEVICE)
    base = spconv.subm_neighbor_keys(keys, shape)

    def grads(fn, feats, w, dout, *extra):
        f = feats.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        out = fn(f, *extra, ww)
        return (out, *torch.autograd.grad(out, (f, ww), dout))

    ok = True
    for label, c, co, repeat in (("repeats", 16, 16, True),
                                 ("C=5", 5, 3, False),
                                 ("C=128", 128, 128, False)):
        nk = base.clone()
        if repeat:
            nk[:, 0::2, 4] = keys[:, 0::2]
            nk[:, 1::2, 4] = keys[:, 0::2]
            nk[:, :, 22] = keys[:, 3:4]
        nk = nk.contiguous()
        feats = torch.randn(2, n, c, generator=g).to(DEVICE)
        w = (torch.randn(27, c, co, generator=g)
             / np.sqrt(27 * c)).to(DEVICE)
        dout = torch.randn(2, n, co, generator=g).to(DEVICE)
        rb = spconv.rulebook_batched(keys, nk)
        cases = (
            ("K1", lambda f, ww: wkc.window_key_conv_batched(
                f, keys, nk, keys, ww, band),
             lambda f, ww: wkc.window_key_conv_plain(f, keys, nk, keys, ww,
                                                     band)),
            ("K5", lambda f, ww: kc.key_conv_batched(f, keys, nk, ww, band),
             lambda f, ww: kc.key_conv_plain(f, keys, nk, ww, band)),
            ("K7", lambda f, ww: gc.gather_conv_batched(f, rb, ww),
             lambda f, ww: gc.gather_conv_plain(f, rb, ww)))
        for name, kern, plain in cases:
            got, want = grads(kern, feats, w, dout), grads(plain, feats, w,
                                                           dout)
            torch.cuda.synchronize()
            errs = [rel_err(a.detach(), r.detach())
                    for a, r in zip(got, want)]
            good = max(errs) <= CONV_RTOL
            ok &= good
            print(f"  {label} {name}: out, dF, dW rel_err "
                  + ", ".join(f"{e:.3e}" for e in errs)
                  + f" {'ok' if good else 'FAIL'}")
        _, rb_k = wkc.window_key_conv_fwd(feats, keys, nk, keys, w, band,
                                          rulebook=True)
        k1 = [wkc.window_key_conv_bwd(dout, feats, rb_k, w)
              for _ in range(2)]
        s = [kc.key_conv_bwd(dout, rb_k, n) for _ in range(2)]
        twin = kc.key_scatter_from_rulebook_plain(dout, rb, n)
        torch.cuda.synchronize()
        same = (torch.equal(rb_k, rb)
                and all(torch.equal(a, b) for a, b in zip(*k1))
                and torch.equal(s[0], s[1]) and torch.equal(s[0], twin))
        ok &= same
        print(f"  {label}: K1 bwd and K5 bwd the same bits over two "
              f"launches, K5's S exactly its twin's={same} "
              f"{'ok' if same else 'FAIL'}")
    return ok


def conv_pairs(args):
    """Matched (row, tap) pairs of a sparse-conv call: the plain twin's
    rulebook entries that find an input row."""
    from detmatch_tpu_torch.ops import spconv
    _, keys, nkeys = args[:3]
    return int((spconv.rulebook_batched(keys, nkeys) >= 0).sum())


def distinct_rows(idx, n):
    """Rows a gather must read: the distinct (sample, row) pairs that the
    (B, ...) indices reach, counting only rows in [0, n)."""
    ok = (idx >= 0) & (idx < n)
    base = torch.arange(idx.shape[0], device=idx.device) * n
    rows = idx.long() + base.view(-1, *[1] * (idx.dim() - 1))
    return int(torch.unique(rows[ok]).numel())


def work(name, args, kwargs, need_dfeats=True, out=None):
    """(bytes, flops) of one call: each input read once and each output
    written once, and the arithmetic these inputs need (for the ball
    query, ``out`` is its (idx, cnt); for K6's scatter and K8's, the
    input rows, ``args[2]`` the table's row count). A gather reads only
    the table rows it indexes."""
    if name in ("gather_conv_batched", "onehot_gather_conv"):
        feats, rb, w = args
        c, co = feats.shape[-1], w.shape[-1]
        if rb.dim() == 2:  # K6's single-sample form
            rows = distinct_rows(rb[None], feats.shape[0])
        else:
            rows = distinct_rows(rb, feats.shape[1])
        # one fma per (tap with an input row, c, co)
        return (4 * (rows * c + rb.numel() + w.numel()
                     + rb.numel() // rb.shape[-1] * co),
                2 * int((rb >= 0).sum()) * c * co)
    if name == "onehot_gather_scatter":
        dout, rb, n = args
        # reads dout and the rulebook, writes S (K, N, Co); one add a pair
        return (4 * (dout.numel() + rb.numel() + rb.shape[-1] * n
                     * dout.shape[-1]),
                int((rb >= 0).sum()) * dout.shape[-1])
    if name == "onehot_take_rows_batched":
        x, idx = args
        return 4 * (distinct_rows(idx, x.shape[1]) * x.shape[-1]
                    + idx.numel() * (1 + x.shape[-1])), 0
    if name == "onehot_scatter_rows":
        dout, idx, n = args
        ok = int(((idx >= 0) & (idx < n)).sum())
        return (4 * (dout.numel() + idx.numel()
                     + idx.shape[0] * n * dout.shape[-1]),
                ok * dout.shape[-1])
    if name == "key_conv_batched":
        feats, _, nkeys, w, _ = args
        b, n, c = feats.shape
        m, k = nkeys.shape[1], nkeys.shape[2]
        co = w.shape[-1]
        inputs = b * n * c + b * n + b * m * k + k * c * co
        # bf16 multiply-adds, one per (matched pair, c, co)
        return 4 * (inputs + b * m * co), 2 * conv_pairs(args) * c * co
    if name == "key_conv_bwd":
        dout, rb, n = args
        b, _, k = rb.shape
        # reads dout and the forward's rulebook; writes S (K, B * N, Co);
        # no arithmetic
        return 4 * (dout.numel() + rb.numel() + k * b * n
                    * dout.shape[-1]), 0
    if name in ("window_key_conv_batched", "window_key_conv_bwd"):
        feats, _, nkeys, _, w, _ = args
        b, n, c = feats.shape
        m, k = nkeys.shape[1], nkeys.shape[2]
        co = w.shape[-1]
        flops = 2 * conv_pairs(args) * c * co  # one fma per (pair, c, co)
        # feats, keys, nkeys and weights; the backward reads the forward's
        # rulebook (B, M, K) instead of the keys
        inputs = b * n * c + b * n + b * m * k + k * c * co
        if name == "window_key_conv_batched":
            return 4 * (inputs + b * m * co), flops
        # reads dout too; writes dW and, where wanted, dF
        out = k * c * co + (b * n * c if need_dfeats else 0)
        return (4 * (inputs - b * n + b * m * co + out),
                flops * (2 if need_dfeats else 1))
    if name == "solve_masked_batched":
        from detmatch_tpu_torch.ops.cuda.hungarian import inner_steps
        cost, row_valid = args
        steps = inner_steps(cost, row_valid)
        return (cost.numel() * 4 + row_valid.numel() + out.numel() * 4,
                JV_OPS_PER_STEP_COL * cost.shape[-1] * int(steps.sum()))
    if name == "fps_batched":
        xyz, valid, s = args
        # per step and valid point: 3 sub, 3 mul, 2 add, a min, a compare
        return (xyz.numel() * 4 + valid.numel() + xyz.shape[0] * s * 4,
                10 * s * int(valid.sum()))
    centers, cvalid, pts, _, _, ns = args
    idx, cnt = out
    # reads the centers and the packed table (16 bytes a point); per
    # neighbour found, one distance test: 3 sub, 3 mul, 2 add, compare
    return (centers.numel() * 4 + cvalid.numel() + pts.shape[0]
            * pts.shape[1] * 16 + (idx.numel() + cnt.numel()) * 4,
            9 * int(cnt.sum()))


def add_bound(entry, nbytes, flops, flop_rate=FP32_FLOP_PER_S):
    """Accumulate a call's bound: the larger of its bytes over the HBM
    rate and its flops over ``flop_rate`` (fp32 unless bf16)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / flop_rate * 1e3
    entry["bound_ms"] = entry.get("bound_ms", 0.0) + max(tb, tf)
    entry["bytes_ms"] = entry.get("bytes_ms", 0.0) + tb
    entry["ops_ms"] = entry.get("ops_ms", 0.0) + tf
    entry["bound_by"] = ("bytes" if entry["bytes_ms"] >= entry["ops_ms"]
                         else "operations")


def describe(t):
    return (f"{t['ms']:.3f} ms (plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']}, "
            f"{t['bound_ms'] / t['ms']:.1%} of it)")


def time_kernels(calls, bwd_cases):
    """Kernel and twin time (CUDA events) and bound of each kernel,
    summed over the recorded calls; ``bwd_cases`` adds the sparse conv's
    backward for each (args, need_dfeats, dout, the forward's rulebook)."""
    from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN
    from detmatch_tpu_torch.ops.cuda.window_key_conv import (
        window_key_conv_bwd, window_key_conv_fwd, window_key_conv_plain)
    kern = dict(zip(KERNELS._fields, KERNELS))
    plain = dict(zip(PLAIN._fields, PLAIN))
    per = {}
    for name, args, kwargs, _ in calls:
        t = per.setdefault(name, dict(ms=0.0, plain_ms=0.0))
        t["ms"] += cuda_ms(lambda: kern[name](*args, **kwargs), reps=5)
        t["plain_ms"] += cuda_ms(lambda: plain[name](*args, **kwargs),
                                 reps=2)
        add_bound(t, *work(name, args, kwargs, out=kern[name](*args,
                                                               **kwargs)),
                  BF16_FLOP_PER_S if name == "key_conv_batched"
                  else FP32_FLOP_PER_S)
    for args, need, dout, rb in bwd_cases:
        feats, keys, nkeys, out_keys, w, band = args
        t = per.setdefault("window_key_conv_bwd", dict(ms=0.0, plain_ms=0.0))
        t["ms"] += cuda_ms(lambda: window_key_conv_bwd(
            dout, feats, rb, w, need_dfeats=need), reps=5)
        with torch.enable_grad():
            f = feats.clone().requires_grad_(need)
            ww = w.clone().requires_grad_()
            out = window_key_conv_plain(f, keys, nkeys, out_keys, ww, band)
            wrt = (f, ww) if need else (ww,)
            t["plain_ms"] += cuda_ms(lambda: torch.autograd.grad(
                out, wrt, dout, retain_graph=True), reps=3)
        add_bound(t, *work("window_key_conv_bwd", args, {}, need))
    return per


def worst_grad(ma, mb):
    """Largest gradient difference of two models' parameters, over the
    tensor's largest magnitude, and the parameter it is in."""
    worst, worst_name = 0.0, ""
    for (n, pa), (_, pb) in zip(ma.named_parameters(), mb.named_parameters()):
        ga = pa.grad if pa.grad is not None else torch.zeros_like(pa)
        gb = pb.grad if pb.grad is not None else torch.zeros_like(pb)
        err = float((ga - gb).abs().max() / gb.abs().max().clamp(min=1e-12))
        if err > worst:
            worst, worst_name = err, n
    return worst, worst_name


def train_phases(cfg, spec, card, stats):
    """Training at full width on the card; returns, per kernel, the
    launches of the ``train_pvrcnn_batches`` run and the per-step times and
    bounds at training shapes."""
    import copy

    from detmatch_tpu_torch.apis.train_pretrain import (
        to_device_batch, train_pvrcnn_batches)
    from detmatch_tpu_torch.models.pvrcnn import pvrcnn as pvrcnn_mod
    from detmatch_tpu_torch.models.pvrcnn.backbone3d import SparseConv3d
    from detmatch_tpu_torch.models.pvrcnn.roi_head import proposal_layer
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN
    from detmatch_tpu_torch.ops.cuda.window_key_conv import (
        window_key_conv_bwd, window_key_conv_fwd, window_key_conv_plain)
    from detmatch_tpu_torch.ops.voxelize import INVALID_KEY
    from detmatch_tpu_torch.train.optim import (clip_grad_norm_,
                                                make_optimizer)

    phase("training: model and frames")
    model = make_train_model(cfg)
    frames = make_train_frames(spec)
    batch = to_device_batch(frames, spec, DEVICE)
    print(f"B={TRAIN_B} frames: valid points "
          f"{frames['points_valid'].sum(1).tolist()}, "
          "voxels "
          f"{(batch['voxel_keys'] != INVALID_KEY).sum(1).tolist()}, "
          f"gt boxes {(frames['gt_boxes'][..., 7] > 0).sum(1).tolist()}")

    def gen():
        return torch.Generator(DEVICE).manual_seed(SEED)

    phase("training: kernels against plain twins (training shapes)")
    calls = []
    probe = copy.deepcopy(model)
    probe.ops = recording(KERNELS, calls)
    out = probe(batch, train=True, generator=gen())
    box_preds = out["batch_box_preds"].detach()
    cls_preds = out["batch_cls_preds"].detach()
    n_fg = int(out["roi_targets"]["reg_valid_mask"].sum())
    del out, probe
    with torch.no_grad():
        ok = check_kernels(calls, "train B=2", stats)
    counts = {n: sum(c[0] == n for c in calls) for n in FWD_KERNELS}
    print(f"calls per training forward: {counts}; fg rois {n_fg}")
    g = gen()
    bwd_cases = []
    st = stats.setdefault("window_key_conv_bwd", dict(max_abs_err=0.0,
                                                      cases=0))
    for i, (name, args, _, need) in enumerate(calls):
        if name != "window_key_conv_batched":
            continue
        feats, keys, nkeys, out_keys, w, band = args
        dout = torch.randn(feats.shape[0], nkeys.shape[1], w.shape[-1],
                           generator=g, device=DEVICE)
        _, rb = window_key_conv_fwd(*args, rulebook=True)
        d_f, d_w = window_key_conv_bwd(dout, feats, rb, w)
        f = feats.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        p_f, p_w = torch.autograd.grad(window_key_conv_plain(
            f, keys, nkeys, out_keys, ww, band), (f, ww), dout)
        torch.cuda.synchronize()
        err_f, err_w = rel_err(d_f, p_f), rel_err(d_w, p_w)
        st["cases"] += 1
        st["max_abs_err"] = max(st["max_abs_err"],
                                float((d_f - p_f).abs().max()),
                                float((d_w - p_w).abs().max()))
        good = err_f <= CONV_RTOL and err_w <= CONV_RTOL
        ok &= good
        print(f"  train B=2 window_key_conv_bwd[{i}] dF rel_err={err_f:.3e} "
              f"dW rel_err={err_w:.3e} feats {tuple(feats.shape)} "
              f"out {tuple(dout.shape)} taps={nkeys.shape[-1]} "
              f"pairs={conv_pairs(args)} dF on the main path={need} "
              f"{'ok' if good else 'FAIL'}")
        bwd_cases.append((args, need, dout, rb))
    if not ok:
        raise AssertionError("a kernel disagrees with its plain twin at "
                             "training shapes")

    phase("training: one step, kernel path against plain paths")
    # Every path runs on the kernel path's proposals: the level-4 convs'
    # sums differ by ~1e-6 between the kernel and cuBLAS's split of the
    # twin's matmul, and the 211,200 anchor scores of an untrained model
    # are so densely tied that such noise reorders them at the NMS cut.
    # "plain" runs every op's twin. Its losses and BN statistics are held
    # to 1e-4, but not its gradients: the train-mode BN backward turns the
    # nearly uniform focal-loss gradient into a difference of near-equal
    # numbers, so its 1e-7 forward noise moves some BEV weight gradients by
    # ~1e-2 of their largest magnitude. "plain backward" takes the sparse
    # convs' forward values from the kernel, bit for bit, and their
    # gradients from autograd through the twin, with every other op's
    # twin: it holds the backward kernel's gradients, as the whole step
    # propagates them, to 1e-3 of each tensor's largest magnitude.
    def conv_plain_backward(feats, keys, nkeys, out_keys, w, band):
        twin = window_key_conv_plain(feats, keys, nkeys, out_keys, w, band)
        with torch.no_grad():
            kern = KERNELS.window_key_conv_batched(feats, keys, nkeys,
                                                   out_keys, w, band)
        return kern + (twin - twin.detach())  # kern's values, twin's grad

    res = {}
    own_layer = pvrcnn_mod.proposal_layer
    for path, ops in (
            ("kernel", KERNELS), ("plain", PLAIN),
            ("plain backward",
             PLAIN._replace(window_key_conv_batched=conv_plain_backward)),
            ("kernel again", KERNELS)):
        m = copy.deepcopy(model)
        m.ops = ops
        out = m(batch, train=True, generator=gen())
        losses = m.loss(out, batch)
        losses["loss"].backward()
        res[path] = (m, {k: float(v.detach()) for k, v in losses.items()})
        if path == "kernel":
            pinned = {k: v.detach() for k, v in out["proposals"].items()}
            pvrcnn_mod.proposal_layer = lambda *a, **kw: pinned
        elif path == "plain":
            own = own_layer(out["batch_box_preds"], out["batch_cls_preds"],
                            **m.train_nms)["rois"]
        del out, losses
    pvrcnn_mod.proposal_layer = own_layer
    same = (own - pinned["rois"]).abs().amax(-1) <= E2E_RTOL * pinned[
        "rois"].abs().max()
    print(f"  proposal slots the plain path's own NMS would share: "
          f"{float(same.float().mean()):.4f} (information)")
    mk, lk = res["kernel"]
    ok = True
    for path in ("plain", "plain backward"):
        mp, lp = res[path]
        for k in lp:
            ok &= report(f"{path}: loss {k} ({lk[k]:.6f})",
                         abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12))
        bufs_p = dict(mp.named_buffers())
        ok &= report(f"{path}: BN running statistics (worst)", max(
            rel_err(bk, bufs_p[n]) for n, bk in mk.named_buffers()
            if n.endswith(("running_mean", "running_var"))))
    for path, gated in (("plain backward", True), ("plain", False),
                        ("kernel again", False)):
        worst, worst_name = worst_grad(mk, res[path][0])
        good = worst <= GRAD_TOL
        ok &= good or not gated
        print(f"  {path}: gradients: worst {worst:.3e} of the tensor's "
              f"largest magnitude ({worst_name}) "
              + (("ok" if good else "FAIL") if gated else "(information)"))
    convs = [mod for mod in mk.backbone_3d.modules()
             if isinstance(mod, SparseConv3d)]
    zero = [i for i, c in enumerate(convs)
            if not bool(c.weight.grad.abs().max() > 0)]
    print(f"  backbone conv weights with a nonzero gradient on the kernel "
          f"path: {len(convs) - len(zero)} of {len(convs)}")
    if not ok or zero:
        raise AssertionError("kernel path disagrees with the plain path in "
                             "a training step")
    del res, mk, mp

    phase("training: train_pvrcnn_batches, kernel path")
    m = copy.deepcopy(model)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}

    def batches():
        while True:
            yield frames

    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    m, _, hist = train_pvrcnn_batches(m, spec, batches(), ROOT / "build" /
                                      "train_smoke", TRAIN_STEPS,
                                      log_interval=1, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_ops.launch_counts()
    expect = dict(counts, window_key_conv_bwd=counts[
        "window_key_conv_batched"])
    print(f"launches in train_pvrcnn_batches ({TRAIN_STEPS} steps): "
          f"{launches}; "
          f"per step expected {expect}")
    print(f"  {TRAIN_STEPS} steps in {wall:.3f} s wall; losses "
          + " ".join(f"{h['loss']:.4f}" for h in hist))
    moved = sum(not torch.equal(p, before[n])
                for n, p in m.named_parameters())
    finite = all(np.isfinite(v) for h in hist for v in h.values())
    print(f"  finite={finite}; parameters moved: {moved} of {len(before)}")
    if (any(launches[n] != TRAIN_STEPS * c for n, c in expect.items())
            or not finite or moved < 0.9 * len(before)):
        raise AssertionError("train_pvrcnn_batches: a kernel was not "
                             "launched as "
                             "expected, a loss is not finite, or the "
                             "parameters did not move")
    del m, before

    phase(f"training: timing (CUDA events) on {card}")
    for path, ops in (("kernel", KERNELS), ("plain", PLAIN)):
        m = copy.deepcopy(model)
        m.ops = ops
        params = list(m.parameters())
        opt, sched = make_optimizer(params, 0.001, 100)
        g = gen()
        split = []
        torch.cuda.synchronize()
        if path == "kernel":
            torch.cuda.reset_peak_memory_stats()
        for step in range(3):  # the first is a warm-up
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            out = m(batch, train=True, generator=g)
            losses = m.loss(out, batch)
            ev[1].record()
            opt.zero_grad(set_to_none=True)
            losses["loss"].backward()
            ev[2].record()
            clip_grad_norm_(params)
            opt.step()
            sched.step()
            ev[3].record()
            torch.cuda.synchronize()
            del out, losses
            if step:
                split.append([ev[i].elapsed_time(ev[i + 1])
                              for i in range(3)])
        fwd, bwd, upd = (float(np.mean(x)) for x in zip(*split))
        step_ms = fwd + bwd + upd
        peak = (f", peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
                " GiB" if path == "kernel" else "")
        print(f"  {path} path B={TRAIN_B}: {step_ms:.3f} ms/step "
              f"({1000.0 * TRAIN_B / step_ms:.3f} frames/s): forward+loss "
              f"{fwd:.3f}, backward {bwd:.3f}, clip+optimizer {upd:.3f} ms"
              f"{peak} [{card}]")
        del m, opt, sched, params
    with torch.no_grad():
        nms_ms = cuda_ms(lambda: proposal_layer(box_preds, cls_preds,
                                                **model.train_nms), reps=2)
    print(f"  proposal NMS {model.train_nms['nms_pre']} -> "
          f"{model.train_nms['nms_post']}, B={TRAIN_B}: {nms_ms:.3f} ms "
          f"[{card}]")
    with torch.no_grad():
        per = time_kernels(calls, bwd_cases)
    for name in expect:
        per[name]["launches"] = launches[name]
        print(f"  {name}: {describe(per[name])} per training step, "
              f"{expect[name]} calls [{card}]")
    return per


def jv_cases():
    """Synthetic assignment problems (name, cost, row_valid, col_valid):
    the SSL shape (B=4, K=128) with one element of each orientation,
    exact tie rows, tied columns, BIG-padded (invalid) columns, an
    element with no valid row and one with a single valid row; then
    K=100 and K=10, which are not multiples of a warp."""
    g = torch.Generator().manual_seed(SEED)
    out = []
    for k, nr, nc in ((128, (128, 40, 0, 1), (60, 128, 128, 90)),
                      (100, (100, 70, 1), (30, 100, 5)),
                      (10, (10, 4, 0), (7, 10, 10))):
        b = len(nr)
        cost = torch.randn(b, k, k, generator=g) * 2
        cost[:, 5] = cost[:, 2]
        cost[:, :, 7] = cost[:, :, 6]
        cols = torch.arange(k)
        rv = cols[None] < torch.tensor(nr)[:, None]
        cv = cols[None] < torch.tensor(nc)[:, None]
        out.append((f"B={b} K={k} rows {nr} cols {nc}", cost.to(DEVICE),
                    rv.to(DEVICE), cv.to(DEVICE)))
    return out


def check_jv_synthetic(stats):
    """K4 against its twin on the oriented problems ``assign_batched``
    hands the solver, and the assignments through either solver."""
    from detmatch_tpu_torch.core.hungarian import assign_batched
    from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN
    ok = True
    for name, cost, rv, cv in jv_cases():
        handed = []

        def capture(c, r):
            handed.append((c, r))
            return PLAIN.solve_masked_batched(c, r)

        c4r_p, m_p = assign_batched(cost, rv, cv, solve=capture)
        c4r_k, m_k = assign_batched(cost, rv, cv,
                                    solve=KERNELS.solve_masked_batched)
        good = check_kernels([("solve_masked_batched", handed[0], {}, False)],
                             f"synthetic {name}", stats)
        good &= torch.equal(c4r_k, c4r_p) and torch.equal(m_k, m_p)
        print(f"  synthetic {name}: matched per element "
              f"{(c4r_k >= 0).sum(1).tolist()}, assignment equal "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
    return ok


def aug_records(rng, b, canvas, ori_shape):
    """Augmentation records that are not the identity: BEV flips on
    alternate frames, a rotation, scale and shift in 3D; the canvas
    resize and horizontal flips on alternate frames in 2D."""
    from detmatch_tpu_torch.core.transforms import Aug2D, Aug3D
    sw, sh = canvas[1] / ori_shape[1], canvas[0] / ori_shape[0]
    flips = (np.arange(b) + rng.randint(2)) % 2

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=DEVICE)

    a3 = Aug3D(flip_x=t(flips), rot=t(rng.uniform(-0.7, 0.7, b)),
               scale=t(rng.uniform(0.95, 1.05, b)),
               trans=t(rng.normal(0.0, 0.2, (b, 3))))
    a2 = Aug2D(scale=t(np.tile([sw, sh, sw, sh], (b, 1))), flip=t(1 - flips),
               img_w=t(np.full(b, canvas[1])))
    return a3, a2


def matching_2d_boxes(t3, tea, stu, k2, score_thr):
    """A 2D teacher BoxSet of ``k2`` slots that the fusion matching pairs
    with the 3D one: the top ``k2`` of the 3D boxes that pass the score
    filter, reverse-augmented and projected as the matching projects
    them, jittered by 2% of their size in the first half of the slots and
    by 50% in the rest (pairs the cost threshold rejects), with a score of
    0.6-0.95 at the 3D box's top class; then put in the teacher's image
    frame."""
    from detmatch_tpu_torch.ssl import boxset, modules
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    f3 = boxset.topk(boxset.max_score_filter(modules.transform_3d(
        t3, tea["aug3d"], reverse=True), score_thr), k2)
    proj = modules.boxes_3d_to_2d(f3, stu["lidar2img"], None)
    wh = (proj["boxes"][..., 2:] - proj["boxes"][..., :2]).repeat(1, 1, 2)
    size = torch.where(torch.arange(k2, device=DEVICE) < k2 // 2, 0.02, 0.5)
    noise = torch.randn(wh.shape, generator=g, device=DEVICE)
    boxes = proj["boxes"] + noise * wh * size[None, :, None]
    boxes = torch.cat([torch.minimum(boxes[..., :2], boxes[..., 2:]),
                       torch.maximum(boxes[..., :2], boxes[..., 2:])], -1)
    top = torch.rand(f3["valid"].shape, generator=g, device=DEVICE)
    scores = torch.full_like(f3["scores"], 0.05).scatter_(
        -1, f3["scores"].argmax(-1, keepdim=True), 0.6 + 0.35 * top[..., None])
    valid = proj["valid"]
    return modules.transform_2d(
        dict(boxes=torch.where(valid[..., None], boxes, 0.0),
             scores=torch.where(valid[..., None], scores, 0.0), valid=valid),
        tea["aug2d"], reverse=False)


def boxset_share(bk, bp):
    """Share of valid boxes of a BoxSet with a counterpart in the other
    (box within 1e-3, score row within 1e-4, same top class)."""
    matched = total = 0
    for b in range(bk["valid"].shape[0]):
        vk, vp = bk["valid"][b], bp["valid"][b]
        xk, xp = bk["boxes"][b][vk], bp["boxes"][b][vp]
        sk, sp = bk["scores"][b][vk], bp["scores"][b][vp]
        total += max(len(xk), len(xp))
        if len(xk) == 0 or len(xp) == 0:
            continue
        close = (((xk[:, None] - xp[None]).abs().amax(-1) <= 1e-3)
                 & ((sk[:, None] - sp[None]).abs().amax(-1) <= 1e-4)
                 & (sk.argmax(-1)[:, None] == sp.argmax(-1)[None]))
        matched += int(close.any(1).sum())
    return matched / max(total, 1), total


def compare_boxsets(name, bk, bp):
    ok = torch.equal(bk["valid"], bp["valid"])
    print(f"  {name}: valid equal {ok}, valid per frame "
          f"{bk['valid'].sum(1).tolist()}")
    for k in ("boxes", "scores"):
        if bool(bk["valid"].any()):
            ok &= report(f"{name}.{k}", rel_err(bk[k], bp[k]))
    return ok


def timed_split(model, batch, reps):
    """Mean ms per ``teacher_pseudo_labels`` call of the whole phase and
    of its stages (3D teacher, 2D teacher, fusion matching, and K4 inside
    the fusion), from CUDA events recorded around each stage inside the
    same calls; the first call warms up."""
    from detmatch_tpu_torch.ops.cuda import KERNELS
    from detmatch_tpu_torch.ssl import modules
    events = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*args, **kwargs)
            ev[1].record()
            events.setdefault(name, []).append(ev)
            return out
        return run

    fusion = modules.fusion_hungarian_matching
    model._det3d_teacher_boxes = timed("3D teacher",
                                       model._det3d_teacher_boxes)
    model._det2d_teacher_boxes = timed("2D teacher",
                                       model._det2d_teacher_boxes)
    modules.fusion_hungarian_matching = timed("fusion matching", fusion)
    model.ops = KERNELS._replace(solve_masked_batched=timed(
        "K4", KERNELS.solve_masked_batched))
    whole = timed("teacher phase", model.teacher_pseudo_labels)
    try:
        for _ in range(reps + 1):
            whole(batch)
        torch.cuda.synchronize()
    finally:
        modules.fusion_hungarian_matching = fusion
        del model._det3d_teacher_boxes, model._det2d_teacher_boxes
        model.ops = KERNELS
    return {name: float(np.mean([a.elapsed_time(b) for a, b in evs[1:]]))
            for name, evs in events.items()}


def teacher_phases(card, stats):
    """The DetMatch teacher phase at full width on the card; returns K4's
    launches, per-phase time and bound."""
    import copy

    from detmatch_tpu_torch.apis.build import build_ssl, build_voxelizer
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.models.frcnn.roi_head2d import decode_rcnn
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN
    from detmatch_tpu_torch.ops.cuda.hungarian import inner_steps, jv_plan
    from detmatch_tpu_torch.ops.voxelize import INVALID_KEY
    from detmatch_tpu_torch.ssl import boxset, modules
    from detmatch_tpu_torch.train.ssl_step import (to_device_views,
                                                   voxelize_views)
    from detmatch_tpu_torch.utils.synth_kitti import ssl_view

    phase("teacher phase: K4 against its twin (synthetic problems)")
    if not check_jv_synthetic(stats):
        raise AssertionError("the JV kernel disagrees with its twin")

    phase("teacher phase: model and views")
    cfg = Config.fromfile(str(SSL_CONFIG))
    spec = build_voxelizer(cfg)
    model = build_ssl(cfg)  # the card: build_ssl's default
    randomize_(model.teacher["det3d"], SEED)
    randomize_(model.teacher["det2d"], SEED + 1)
    canvas = tuple(cfg["model"]["detector_2d"]["canvas"])
    points = cfg["data"]["collate"]["max_points"]
    rng = np.random.RandomState(SEED)
    batch = voxelize_views(to_device_views(dict(unlab=dict(
        tea=ssl_view(rng, SSL_B, points, canvas),
        stu=ssl_view(rng, SSL_B, points, canvas))), DEVICE), spec)
    tea, stu = batch["unlab"]["tea"], batch["unlab"]["stu"]
    for view in (tea, stu):
        view["aug3d"], view["aug2d"] = aug_records(
            rng, SSL_B, canvas, view["ori_shape"][0].tolist())
    print(f"B={SSL_B} teacher view: valid points "
          f"{tea['points_valid'].sum(1).tolist()}, voxels "
          f"{(tea['voxel_keys'] != INVALID_KEY).sum(1).tolist()}, image "
          f"{tuple(tea['img'].shape)}; Faster R-CNN stages "
          f"{cfg['model']['detector_2d'].get('backbone_cfg')}"
          " (None: the default (3, 4, 6, 3))")
    scfg = model.cfg

    phase("teacher phase: kernels against plain twins (teacher shapes)")
    calls = []
    with torch.inference_mode():
        model.ops = recording(PLAIN, calls)
        model.teacher_pseudo_labels(batch)
        model.ops = KERNELS
        ok = check_kernels(calls, "teacher B=4", stats)
    counts = {n: sum(c[0] == n for c in calls) for n in TEACHER_KERNELS}
    print(f"calls per teacher phase: {counts}")
    if not ok or counts != TEACHER_LAUNCHES:
        raise AssertionError("a kernel disagrees with its twin at teacher "
                             "shapes, or the calls are not 12/12/1/1")

    phase("teacher phase: teacher_pseudo_labels, kernel path")
    with torch.inference_mode():
        cuda_ops.reset_launch_counts()
        out_k = model.teacher_pseudo_labels(batch)
        torch.cuda.synchronize()
        launches = cuda_ops.launch_counts()
    print(f"launches in teacher_pseudo_labels(): {launches}")
    if any(launches[n] != c for n, c in TEACHER_LAUNCHES.items()):
        raise AssertionError("the teacher phase did not launch 12/12/1/1")
    finite = all(bool(torch.isfinite(out_k[k][f]).all())
                 for k in ("m3d_stu", "m2d_stu", "m2d_clean")
                 for f in ("boxes", "scores"))
    with torch.inference_mode():
        t3 = model._det3d_teacher_boxes(tea)
        t2 = model._det2d_teacher_boxes(tea, scfg.nms_2d_cfg)
        f3 = boxset.max_score_filter(modules.transform_3d(
            t3, tea["aug3d"], reverse=True), scfg.score_filter_3d)
        f2 = boxset.max_score_filter(modules.transform_2d(
            t2, tea["aug2d"], reverse=True), scfg.score_filter_2d)
        assigned, _, _ = modules.fusion_hungarian_matching(
            f3, f2, stu["lidar2img"], stu["ori_shape"], cost_thr=None)
    print(f"  teacher boxes per frame: 3D {t3['valid'].sum(1).tolist()}, "
          f"2D {t2['valid'].sum(1).tolist()}; into the match (score "
          f"filter, top 128): 3D "
          f"{f3['valid'].sum(1).clamp(max=128).tolist()}, 2D "
          f"{f2['valid'].sum(1).clamp(max=128).tolist()}; assigned "
          f"{assigned['valid'].sum(1).tolist()}; matched under cost_thr "
          f"{scfg.cost_thr}: {out_k['m3d_stu']['valid'].sum(1).tolist()}; "
          f"finite={finite}")
    if not finite or int(assigned["valid"].sum()) == 0:
        raise AssertionError("non-finite pseudo-labels or no assignment")

    phase("teacher phase: kernel path against plain path")
    with torch.inference_mode():
        # the same teacher boxes into both paths, the 2D ones made to
        # pair with the 3D ones under cost_thr: the pseudo-labels must
        # agree exactly in their discrete part
        t2_pin = matching_2d_boxes(t3, tea, stu, t2["valid"].shape[1],
                                   scfg.score_filter_3d)
        model._det3d_teacher_boxes = lambda view: t3
        model._det2d_teacher_boxes = lambda view, nms_cfg: t2_pin
        res = {}
        for path, ops in (("kernel", KERNELS), ("plain", PLAIN)):
            model.ops = ops
            res[path] = model.teacher_pseudo_labels(batch)
        del model._det3d_teacher_boxes, model._det2d_teacher_boxes
        model.ops = PLAIN
        t3_p = model._det3d_teacher_boxes(tea)
        model.ops = KERNELS
    kept = res["kernel"]["m3d_stu"]["valid"].sum(1)
    print(f"  pinned teacher boxes: 2D {t2_pin['valid'].sum(1).tolist()} "
          f"made from the 3D ones; pseudo-labels under cost_thr "
          f"{scfg.cost_thr}: {kept.tolist()}")
    if int(kept.sum()) == 0:
        raise AssertionError("no pseudo-label survived the cost threshold "
                             "on the pinned teacher boxes")
    ok = True
    for k in ("m3d_stu", "m2d_stu", "m2d_clean"):
        ok &= compare_boxsets(f"same teacher boxes: {k}", res["kernel"][k],
                              res["plain"][k])
    with torch.inference_mode():
        # and every pair the assignment makes, before the cost threshold
        (k3, k2, kc), (p3, p2, pc) = [modules.fusion_hungarian_matching(
            f3, f2, stu["lidar2img"], stu["ori_shape"], cost_thr=None,
            solve=solve) for solve in (KERNELS.solve_masked_batched,
                                       PLAIN.solve_masked_batched)]
    ok &= compare_boxsets("all assigned pairs: 3D", k3, p3)
    ok &= compare_boxsets("all assigned pairs: 2D", k2, p2)
    ok &= torch.equal(kc, pc)
    share, total = boxset_share(t3, t3_p)
    print(f"  3D teacher boxes of each path's own forward matched: "
          f"{share:.4f} of {total}")
    if not ok or share < MATCH_SHARE:
        raise AssertionError("kernel path disagrees with the plain path in "
                             "the teacher phase")
    del res, t3_p

    phase("teacher phase: Faster R-CNN on the card against the CPU, B=1")
    fr = model.teacher["det2d"]
    fr_cpu = copy.deepcopy(fr).cpu()
    img1, shape1 = tea["img"][:1], tea["img_shape"][:1]
    with torch.inference_mode():
        fwd_k = fr(img1, shape1)
        pre_k = fr.simple_test(img1, shape1, with_nms=False)
        fwd_c = fr_cpu(img1.cpu(), shape1.cpu())
        props = fwd_k["proposals"].cpu()
        cls_c, reg_c = fr_cpu.roi_forward(fwd_c["feats"], props)
        boxes_c, scores_c = decode_rcnn(props[0], cls_c[0], reg_c[0],
                                        fr.num_classes, shape1[0].cpu())
    ok = True
    for i, (a, b) in enumerate(zip(fwd_k["feats"], fwd_c["feats"])):
        ok &= report(f"FPN P{i + 2}", rel_err(a.cpu(), b))
    same = (fwd_k["proposals"].cpu() - fwd_c["proposals"]).abs().amax(-1) \
        <= E2E_RTOL * fwd_c["proposals"].abs().max()
    print(f"  proposal slots equal across devices: "
          f"{float(same.float().mean()):.4f} (information: NMS order under "
          "1e-6 score noise)")
    ok &= report("pre-NMS boxes on the card's proposals",
                 rel_err(pre_k["boxes"][0].cpu(), boxes_c))
    ok &= report("pre-NMS scores on the card's proposals",
                 rel_err(pre_k["scores"][0].cpu(), scores_c))
    if not ok:
        raise AssertionError("Faster R-CNN on the card disagrees with the "
                             "CPU")
    del fr_cpu, fwd_c, fwd_k, pre_k

    phase(f"teacher phase: timing (CUDA events) on {card}")
    jv_calls = [c for c in calls if c[0] == "solve_masked_batched"]
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        split = timed_split(model, batch, reps=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        model.ops = PLAIN
        plain_ms = cuda_ms(lambda: model.teacher_pseudo_labels(batch),
                           reps=1)
        model.ops = KERNELS
        per = time_kernels(jv_calls, {})["solve_masked_batched"]
    cost, row_valid = jv_calls[0][1]
    steps = inner_steps(cost, row_valid)
    k4_line("teacher phase", cost, row_valid, card,
            jv_plan(cost.shape[-1]))
    phase_ms = split.pop("teacher phase")
    print(f"  teacher phase B={SSL_B}: {phase_ms:.3f} ms/call "
          f"({1000.0 * SSL_B / phase_ms:.3f} frames/s), peak memory "
          f"{peak:.3f} GiB [{card}]")
    rest = phase_ms - sum(split[k] for k in STAGES if k != "K4")
    print("  split (events around each stage inside the same calls): "
          + ", ".join(f"{k} {split[k]:.3f} ms" for k in STAGES)
          + f" (K4 is inside the fusion matching), the rest {rest:.3f} ms "
          f"[{card}]")
    print(f"  plain path: {plain_ms:.3f} ms/call "
          f"({1000.0 * SSL_B / plain_ms:.3f} frames/s) [{card}]")
    print(f"  solve_masked_batched alone: {describe(per)} per teacher "
          f"phase, 1 call, K={cost.shape[-1]}, inner steps per element "
          f"{steps.tolist()} [{card}]")
    per["launches"] = launches["solve_masked_batched"]
    return {"solve_masked_batched": per}


def ssl_model(cfg, seed=SEED):
    """The SSL detector of ``cfg`` on DEVICE with the models' own
    initialisers seeded from ``seed`` (student = teacher, the state an SSL
    run starts from after pretraining), the class biases of the PV-RCNN
    anchor head and the Faster R-CNN box head spread around zero so that
    the teacher's boxes pass the 0.1 score filters."""
    from detmatch_tpu_torch.apis.build import build_ssl
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_ssl(cfg, device=DEVICE)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bias in (model.student["det3d"].dense_head.conv_cls.bias,
                     model.student["det2d"].roi_head.bbox_head.fc_cls.bias):
            bias.copy_(0.5 * torch.randn(bias.shape, generator=g))
    model.teacher.load_state_dict(model.student.state_dict())
    return model


def ssl_batch_np(cfg, rng):
    """One collated numpy SSL batch at full width: B=4 labeled frames
    (the JAX benchmark's GT draw) and B=4 unlabeled ones, each with a
    student and a teacher view."""
    from detmatch_tpu_torch.utils.synth_kitti import ssl_view
    canvas = tuple(cfg["model"]["detector_2d"]["canvas"])
    points = cfg["data"]["collate"]["max_points"]
    return dict(
        lab=dict(stu=ssl_view(rng, SSL_B, points, canvas, with_gt=True),
                 tea=ssl_view(rng, SSL_B, points, canvas)),
        unlab=dict(stu=ssl_view(rng, SSL_B, points, canvas),
                   tea=ssl_view(rng, SSL_B, points, canvas)))


def student_2d_pins(m, batch, pseudo, gen):
    """A clean-frame 2D BoxSet that the consistency branch pairs with the
    student's own boxes under cost_thr: the student's train forward (on
    ``pseudo``'s 3D labels), its boxes de-augmented, projected and 2D-NMS'd
    as the branch does, jittered by 2% of their size, with a 0.9 score at
    the box's top class. Returns (that set, the forward's proposals)."""
    from detmatch_tpu_torch.ssl import modules
    cat, bl = m._concat_student_batch(batch, pseudo)
    with torch.no_grad():
        out = m.student["det3d"](cat, train=True, generator=gen)
        sub = {k: out[k][bl:] for k in ("batch_box_preds_rcnn", "rcnn_cls",
                                        "roi_labels", "roi_scores_full")}
        u = batch["unlab"]["stu"]
        stu3d = modules.transform_3d(m._det3d_student_boxes(sub),
                                     u["aug3d"], reverse=True)
        proj = modules.nms_2d_boxset(
            modules.boxes_3d_to_2d(stu3d, u["lidar2img"], u["ori_shape"]),
            *m.cfg.proj_nms_2d_cfg)
        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        wh = (proj["boxes"][..., 2:] - proj["boxes"][..., :2]).repeat(1, 1, 2)
        boxes = proj["boxes"] + 0.02 * wh * torch.randn(
            wh.shape, generator=g, device=DEVICE)
        scores = torch.full_like(proj["scores"], 0.05).scatter_(
            -1, proj["scores"].argmax(-1, keepdim=True), 0.9)
        valid = proj["valid"]
        clean = dict(boxes=torch.where(valid[..., None], boxes, 0.0),
                     scores=torch.where(valid[..., None], scores, 0.0),
                     valid=valid)
    return clean, {k: v.detach() for k, v in out["proposals"].items()}


def grads_of(module):
    return {n: (p.grad.detach().clone() if p.grad is not None
                else torch.zeros_like(p)) for n, p in module.named_parameters()}


def worst_rel(ga, gb):
    """Largest difference over each tensor's largest magnitude, and where."""
    worst, where = 0.0, ""
    for n in gb:
        err = float((ga[n] - gb[n]).abs().max()
                    / gb[n].abs().max().clamp(min=1e-12))
        if err > worst:
            worst, where = err, n
    return worst, where


def iteration_split(m, batch_np, spec, opts, gen, reps):
    """Mean ms of one SSL iteration and of its stages (CUDA events
    inside the same iterations; the first iteration warms up)."""
    from detmatch_tpu_torch.train.ssl_step import (ema_step, teacher_step,
                                                   to_device_views,
                                                   voxelize_views)
    opt3d, opt2d = opts
    rows = []
    for it in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(10)]
        ev[0].record()
        batch = voxelize_views(to_device_views(batch_np, DEVICE), spec)
        ev[1].record()
        pseudo = teacher_step(m, batch)
        ev[2].record()
        for j, (loss_fn, opt) in enumerate((
                (m.student_losses_3d_concat, opt3d),
                (m.student_losses_2d, opt2d))):
            opt.zero_grad()
            total, _ = loss_fn(batch, pseudo, it, gen)
            ev[3 + 3 * j].record()
            total.backward()
            ev[4 + 3 * j].record()
            opt.step()
            ev[5 + 3 * j].record()
            del total
        ema_step(m, it)
        ev[9].record()
        torch.cuda.synchronize()
        if it:
            rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(9)])
    split = dict(zip(ITER_STAGES, (float(np.mean(c)) for c in zip(*rows))))
    split["iteration"] = sum(split[k] for k in ITER_STAGES)
    return split


def ssl_phases(card, stats):
    """One whole DetMatch SSL iteration at full width on the card (B=4
    labeled + 4 unlabeled frames); returns, per kernel, the launches of
    the main path's run and the per-iteration times and bounds."""
    import copy

    from detmatch_tpu_torch.apis.build import build_ssl, build_voxelizer
    from detmatch_tpu_torch.apis.train_ssl import train_ssl_batches
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.models.pvrcnn import pvrcnn as pvrcnn_mod
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN, gather_conv
    from detmatch_tpu_torch.ops.cuda import key_conv as kc
    from detmatch_tpu_torch.ops.cuda.hungarian import jv_plan
    from detmatch_tpu_torch.ops.cuda.window_key_conv import (
        tile_rows, window_key_conv_bwd, window_key_conv_fwd,
        window_key_conv_plain)
    from detmatch_tpu_torch.ops.voxelize import INVALID_KEY
    from detmatch_tpu_torch.ssl.detector import ema_decay_at
    from detmatch_tpu_torch.train.optim import detmatch_branch_optimizers
    from detmatch_tpu_torch.train.ssl_step import (ema_step, student_2d_step,
                                                   student_3d_step,
                                                   teacher_step,
                                                   to_device_views,
                                                   voxelize_views)

    def gen():
        return torch.Generator(DEVICE).manual_seed(SEED)

    phase("SSL iteration: model and views")
    cfg = Config.fromfile(str(SSL_CONFIG))
    spec = build_voxelizer(cfg)
    model = ssl_model(cfg)
    rng = np.random.RandomState(SEED)
    batch_np = ssl_batch_np(cfg, rng)
    batch = voxelize_views(to_device_views(batch_np, DEVICE), spec)
    canvas = tuple(cfg["model"]["detector_2d"]["canvas"])
    for view in (batch["unlab"]["tea"], batch["unlab"]["stu"]):
        view["aug3d"], view["aug2d"] = aug_records(
            rng, SSL_B, canvas, view["ori_shape"][0].tolist())
    lab, u = batch["lab"]["stu"], batch["unlab"]["stu"]
    print(f"B={SSL_B}+{SSL_B}: voxels lab "
          f"{(lab['voxel_keys'] != INVALID_KEY).sum(1).tolist()}, unlab "
          f"{(u['voxel_keys'] != INVALID_KEY).sum(1).tolist()}; gt boxes "
          f"{(lab['gt_boxes'][..., 7] > 0).sum(1).tolist()}; image "
          f"{tuple(lab['img'].shape)}")

    phase("SSL iteration: kernels against plain twins (SSL step shapes)")
    m = copy.deepcopy(model).train()
    calls = []
    m.ops = recording(KERNELS, calls)
    pseudo = teacher_step(m, batch)
    # with gradients on, so that the record says which convs need dF
    m.student_losses_3d_concat(batch, pseudo, 0, gen())
    del m
    with torch.no_grad():
        ok = check_kernels(calls, "SSL", stats)
        exact, n_exact = check_k1_exact(calls, "SSL")
    counts = {n: sum(c[0] == n for c in calls) for n in TEACHER_KERNELS}
    print(f"calls per SSL iteration (teacher + student forward): {counts}; "
          f"K1 fwd bit-equal to K7 with its rulebook equal to the plain one "
          f"on {n_exact} of them: {exact}")
    g = gen()
    bwd_cases = []
    st = stats.setdefault("window_key_conv_bwd", dict(max_abs_err=0.0,
                                                      cases=0))
    for i, (name, args, _, need) in enumerate(calls):
        if name != "window_key_conv_batched" or args[0].shape[0] != 2 * SSL_B:
            continue
        feats, keys, nkeys, out_keys, w, band = args
        dout = torch.randn(feats.shape[0], nkeys.shape[1], w.shape[-1],
                           generator=g, device=DEVICE)
        _, rb = window_key_conv_fwd(*args, rulebook=True)
        d_f, d_w = window_key_conv_bwd(dout, feats, rb, w)
        d_f2, d_w2 = window_key_conv_bwd(dout, feats, rb, w)
        f = feats.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        p_f, p_w = torch.autograd.grad(window_key_conv_plain(
            f, keys, nkeys, out_keys, ww, band), (f, ww), dout)
        torch.cuda.synchronize()
        err_f, err_w = rel_err(d_f, p_f), rel_err(d_w, p_w)
        same = torch.equal(d_f, d_f2) and torch.equal(d_w, d_w2)
        st["cases"] += 1
        st["max_abs_err"] = max(st["max_abs_err"],
                                float((d_f - p_f).abs().max()),
                                float((d_w - p_w).abs().max()))
        good = err_f <= CONV_RTOL and err_w <= CONV_RTOL and same
        ok &= good
        print(f"  SSL B={2 * SSL_B} window_key_conv_bwd[{i}] dF rel_err="
              f"{err_f:.3e} dW rel_err={err_w:.3e} two launches bit-equal="
              f"{same} out {tuple(dout.shape)} taps={nkeys.shape[-1]} dF on "
              f"the main path={need} {'ok' if good else 'FAIL'}")
        bwd_cases.append((args, need, dout, rb))
        del d_f, d_w, d_f2, d_w2, p_f, p_w
    expect_fwd = {n: SSL_LAUNCHES[n] for n in TEACHER_KERNELS}
    if (not ok or not exact or counts != expect_fwd or len(bwd_cases) != 12
            or n_exact != SSL_LAUNCHES["window_key_conv_batched"]):
        raise AssertionError("a kernel disagrees with its twin at SSL "
                             "shapes, K1 fwd is not bit-equal to K7 or its "
                             "rulebook to the plain one, K1 bwd differs "
                             f"between two launches, or the calls are not "
                             f"{expect_fwd}")

    phase("SSL iteration: kernel path against plain path (pinned)")
    # the teacher boxes pinned as in the teacher phase; the clean 2D boxes
    # made from the student's own projected boxes so that the consistency
    # branch pairs them; every path on the kernel path's proposals
    tea = batch["unlab"]["tea"]
    with torch.no_grad():
        t3 = model._det3d_teacher_boxes(tea)
        t2_pin = matching_2d_boxes(t3, tea, u, 100,
                                   model.cfg.score_filter_3d)
    model._det3d_teacher_boxes = lambda view: t3
    model._det2d_teacher_boxes = lambda view, nms_cfg: t2_pin
    res = {}
    for path, ops in (("kernel", KERNELS), ("plain", PLAIN)):
        model.ops = ops
        res[path] = teacher_step(model, batch)
    model.ops = KERNELS
    del model._det3d_teacher_boxes, model._det2d_teacher_boxes
    ok = True
    for k in ("m3d_stu", "m2d_stu", "m2d_clean"):
        ok &= compare_boxsets(f"pseudo-labels {k}", res["kernel"][k],
                              res["plain"][k])
    pseudo = res["kernel"]
    if not ok or int(pseudo["m3d_stu"]["valid"].sum()) == 0:
        raise AssertionError("the teacher phase on pinned boxes disagrees "
                             "or leaves no 3D pseudo-label")
    m = copy.deepcopy(model).train()
    clean, pinned = student_2d_pins(m, batch, pseudo, gen())
    del m
    from detmatch_tpu_torch.ssl import modules
    pseudo = dict(pseudo, m2d_clean=clean, m2d_stu=modules.transform_2d(
        clean, u["aug2d"], reverse=False))
    kept2d = (pseudo["m2d_stu"]["valid"]
              & (pseudo["m2d_stu"]["scores"].amax(-1)
                 > model.cfg.pseudo_score_thr_2d)).sum(1)
    print(f"  pinned: 3D pseudo-labels per frame "
          f"{pseudo['m3d_stu']['valid'].sum(1).tolist()}, clean 2D boxes "
          f"from the student's own {clean['valid'].sum(1).tolist()}, 2D "
          f"pseudo-labels kept {kept2d.tolist()}")

    def conv_plain_backward(feats, keys, nkeys, out_keys, w, band):
        twin = window_key_conv_plain(feats, keys, nkeys, out_keys, w, band)
        with torch.no_grad():
            kern = KERNELS.window_key_conv_batched(feats, keys, nkeys,
                                                   out_keys, w, band)
        return kern + (twin - twin.detach())  # kern's values, twin's grad

    own_layer = pvrcnn_mod.proposal_layer
    pvrcnn_mod.proposal_layer = lambda *a, **kw: pinned
    res = {}
    try:
        for path, ops in (
                ("kernel", KERNELS), ("plain", PLAIN),
                ("plain backward",
                 PLAIN._replace(window_key_conv_batched=conv_plain_backward)),
                ("kernel again", KERNELS)):
            m = copy.deepcopy(model).train()
            m.ops = ops
            k4 = []
            if path == "kernel":
                m.ops = recording(KERNELS, k4)  # to keep K4's two calls
            total, logs = m.student_losses_3d_concat(batch, pseudo, 0, gen())
            total.backward()
            bufs = {n: b.clone() for n, b in
                    m.student["det3d"].named_buffers()
                    if n.endswith(("running_mean", "running_var"))}
            res[path] = (dict({k: float(v.detach()) for k, v in
                               logs.items()}, loss=float(total.detach())),
                         grads_of(m.student["det3d"]), bufs)
            if path == "kernel":
                k4_calls = [c for c in k4 if c[0] == "solve_masked_batched"]
            del m, total, logs, k4
    finally:
        pvrcnn_mod.proposal_layer = own_layer
    lk, gk, bk = res["kernel"]
    n_match = lk["metrics.num_2D_to_3D_hung"]
    print(f"  consistency pairs per frame (metrics.num_2D_to_3D_hung): "
          f"{n_match}; losses " + ", ".join(
              f"{k.split('.')[-1]} {lk[k]:.4f}" for k in lk
              if "2D_to_3D" in k))
    ok = n_match > 0 and int(kept2d.sum()) > 0
    ok &= check_kernels(k4_calls, "consistency K4", stats)
    for path in ("plain", "plain backward"):
        lp, _, bp = res[path]
        for k in lp:
            ok &= report(f"{path}: loss {k} ({lk[k]:.6f})",
                         abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12))
        ok &= report(f"{path}: BN running statistics (worst)",
                     max(rel_err(bk[n], bp[n]) for n in bk))
    for path, gated in (("plain backward", True), ("plain", False),
                        ("kernel again", False)):
        worst, where = worst_rel(gk, res[path][1])
        good = worst <= GRAD_TOL
        ok &= good or not gated
        print(f"  {path}: gradients: worst {worst:.3e} of the tensor's "
              f"largest magnitude ({where}) "
              + (("ok" if good else "FAIL") if gated else "(information)"))
    if not ok:
        raise AssertionError("the SSL iteration disagrees between the kernel "
                             "and the plain paths, or the consistency branch "
                             "matched nothing, or no 2D pseudo-label was kept")
    window_losses, window_bufs = lk, bk
    del res

    phase("SSL iteration: the four steps on the card, EMA against formula")
    m = copy.deepcopy(model).train()
    opts = detmatch_branch_optimizers(m, 0.04, 0.16)
    l3 = student_3d_step(m, opts[0], batch, pseudo, 0, gen())
    l2 = student_2d_step(m, opts[1], batch, pseudo, 0, gen())
    before = {k: v.clone() for k, v in m.teacher.state_dict().items()}
    ema_step(m, 0)
    d = ema_decay_at(0, m.cfg).to(DEVICE)
    s_sd = m.student.state_dict()
    ema_ok = all(torch.equal(v, before[k] * d + s_sd[k] * (1.0 - d))
                 for k, v in m.teacher.state_dict().items()
                 if v.is_floating_point())
    finite = all(np.isfinite(float(v)) for v in (*l3.values(),
                                                 *l2.values()))
    print(f"  3D loss {float(l3['loss']):.4f}, 2D loss "
          f"{float(l2['loss']):.4f}, finite={finite}; teacher equal to "
          f"t * {float(d):.6f} + s * (1 - d): {ema_ok}")
    if not (ema_ok and finite):
        raise AssertionError("the EMA teacher is not the formula, or a loss "
                             "is not finite")
    del m, opts

    phase("SSL iteration: train_ssl_batches, kernel path")
    m = copy.deepcopy(model)
    before = {k: v.clone() for k, v in m.state_dict().items()}

    def batches():
        while True:
            yield batch_np

    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    m, _, hist = train_ssl_batches(m, spec, batches(),
                                   ROOT / "build" / "ssl_smoke", SSL_ITERS,
                                   log_interval=1, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_ops.launch_counts()
    print(f"launches in train_ssl_batches ({SSL_ITERS} iterations): "
          f"{launches}; per "
          f"iteration expected {dict(SSL_LAUNCHES, **NO_ONEHOT)}")
    print(f"  {SSL_ITERS} iterations in {wall:.3f} s wall; losses "
          + " ".join(f"{h['loss']:.4f}" for h in hist)
          + "; consistency pairs "
          + " ".join(f"{h['metrics.num_2D_to_3D_hung']:.2f}" for h in hist))
    sd = m.state_dict()
    moved = {half: sum(not torch.equal(v, before[k]) for k, v in sd.items()
                       if k.startswith(half) and v.is_floating_point())
             for half in ("student.", "teacher.")}
    finite = all(np.isfinite(v) for h in hist for v in h.values())
    print(f"  finite={finite}; tensors moved: {moved}")
    if (any(launches[n] != SSL_ITERS * c for n, c in SSL_LAUNCHES.items())
            or launches["key_conv_batched"]
            or any(launches[n] for n in ONEHOT_KERNELS) or not finite
            or min(moved.values()) == 0):
        raise AssertionError("train_ssl_batches: a kernel was not launched as "
                             "expected, a loss is not finite, or the student "
                             "or teacher did not move")
    ssl_launches = launches
    del m, before, sd

    phase("SSL iteration: key-compare conv (K5) path")
    cfg_key = copy.deepcopy(cfg)
    det3d = cfg_key["model"]["detector_3d"]
    det3d["backbone3d_cfg"] = dict(det3d.get("backbone3d_cfg") or {},
                                   conv_impl="key")
    key_model = build_ssl(cfg_key)
    key_model.load_state_dict(model.state_dict())
    m = copy.deepcopy(key_model).train()
    kcalls = []
    m.ops = recording(KERNELS, kcalls)
    with torch.no_grad():
        key_pseudo = teacher_step(m, batch)
        m.student_losses_3d_concat(batch, key_pseudo, 0, gen())
    del m
    point_calls = [c for c in kcalls if c[0] in POINT_KERNELS]
    kcalls = [c for c in kcalls if c[0] == "key_conv_batched"]
    ok = len(kcalls) == 24 and len(point_calls) == POINT_CALLS
    with torch.no_grad():
        ok &= check_kernels(kcalls, "key path", stats)
        ok &= check_kernels(point_calls, "key path", stats)
        good, key_bwd = k5_student_checks(kcalls, stats, gen())
        ok &= good
    if not ok or len(key_bwd) != 12:
        raise AssertionError("K5, K2 or K3 disagrees with its twin, K5 or "
                             "its backward differs between two launches, "
                             "K5's rulebook differs from the plain one, or "
                             "K5's calls are not 24 per iteration, or K2's "
                             "and K3's not 24 and 2")
    m = copy.deepcopy(key_model).train()
    opts = detmatch_branch_optimizers(m, 0.04, 0.16)
    cuda_ops.reset_launch_counts()
    kp = teacher_step(m, batch)
    student_3d_step(m, opts[0], batch, pseudo, 0, gen())
    student_2d_step(m, opts[1], batch, pseudo, 0, gen())
    ema_step(m, 0)
    torch.cuda.synchronize()
    key_launches = cuda_ops.launch_counts()
    print(f"launches in one key-path iteration: {key_launches}; expected "
          f"{KEY_LAUNCHES}")
    if any(key_launches[n] != c for n, c in KEY_LAUNCHES.items()):
        raise AssertionError("the key path did not launch 24 / 12 / 0, or "
                             "launched K6 or K8")
    del m, opts, kp
    pvrcnn_mod.proposal_layer = lambda *a, **kw: pinned
    res = {}
    try:
        for path, ops in (("kernel", KERNELS), ("plain", PLAIN)):
            m = copy.deepcopy(key_model).train()
            m.ops = ops
            with torch.no_grad():
                total, logs = m.student_losses_3d_concat(batch, pseudo, 0,
                                                         gen())
            res[path] = dict({k: float(v) for k, v in logs.items()},
                             loss=float(total))
            del m
    finally:
        pvrcnn_mod.proposal_layer = own_layer
    ok = True
    for k, v in res["plain"].items():
        ok &= report(f"key path, plain: loss {k} ({res['kernel'][k]:.6f})",
                     abs(res["kernel"][k] - v) / max(abs(v), 1e-12))
    diff = max(abs(res["kernel"][k] - window_losses[k])
               / max(abs(window_losses[k]), 1e-12) for k in window_losses)
    print(f"  key path (bf16 operands) against the fp32 window path, same "
          f"pins: worst relative loss difference {diff:.3e} (information)")
    if not ok:
        raise AssertionError("the key path's kernel and plain losses differ")

    rb_model, rb_calls, row_calls, rb_launches = rulebook_phase(
        cfg, model, batch, pseudo, pinned, (window_losses, window_bufs),
        stats)
    onehot_per = onehot_phase(card, stats, rb_calls, row_calls, ssl_launches)
    del row_calls

    phase(f"SSL iteration: timing (CUDA events) on {card}")
    with torch.no_grad():
        per = time_kernels(calls, bwd_cases)
        k1_breakdown(bwd_cases, card)
        k2_breakdown(calls, card)
        k3 = [c[1] for c in calls if c[0] == "fps_batched"]
        for j, args in enumerate(k3):
            k3_line(f"SSL {j}", *args, card)
        if not all([k3_step_floor(b, k3[0][2], card) for b in (1, 8)]):
            raise AssertionError("K3 at one point a thread disagrees with "
                                 "its twin")
        k4 = [c[1] for c in calls if c[0] == "solve_masked_batched"]
        for label, (cost, rv) in zip(("SSL fusion", "SSL consistency"), k4):
            k4_line(label, cost, rv, card, jv_plan(cost.shape[-1]))
        cost, rv = k4_calls[0][1]
        k4_line("pinned consistency", cost, rv, card, jv_plan(cost.shape[-1]))
        if not k4_step_floor(card, jv_plan):
            raise AssertionError("K4 on the long chains disagrees with its "
                                 "twin")
        k5_breakdown([c[1] for c in kcalls if c[1][0].shape[0] == 2 * SSL_B],
                     card, lambda k, c, co: tile_rows(*kc.rounded_shapes(
                         0, 0, k, c, co)[1]))
        k7_breakdown([c[1] for c in rb_calls
                      if c[1][0].shape[0] == 2 * SSL_B], card,
                     gather_conv.k7_tile_rows)
        per.update(time_kernels(rb_calls, []))
        key_per = time_kernels(kcalls, [])
        tot = k5_bwd_breakdown(key_bwd, card, lambda dout, keys, nkeys, rb:
                               kc.key_conv_bwd(dout, rb, keys.shape[1]))
        t = key_per.setdefault("key_conv_bwd", dict(
            ms=tot["ms"], plain_ms=0.0, library_ms=tot["lib"]))
        for dout, keys, nkeys, rb in key_bwd:
            t["plain_ms"] += cuda_ms(
                lambda: kc.key_scatter_plain(dout, keys, nkeys), reps=2)
            add_bound(t, *work("key_conv_bwd", (dout, rb, keys.shape[1]),
                               {}))
    per.update(key_per)
    jv = [(c[1][0].shape[-1], int((c[1][1]).sum())) for c in calls
          if c[0] == "solve_masked_batched"]
    del calls, bwd_cases, kcalls, key_bwd, k4_calls, rb_calls
    # the window path only: the key and rulebook paths' iterations are
    # gated above, and tools/port_probes/ssl_iteration_ab.py times them
    del key_model, rb_model
    m = copy.deepcopy(model).train()
    opts = detmatch_branch_optimizers(m, 0.04, 0.16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    split = iteration_split(m, batch_np, spec, opts, gen(), reps=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    it_ms = split.pop("iteration")
    print(f"  window path: {it_ms:.3f} ms/iteration = "
          f"{1000.0 / it_ms:.4f} iterations/s = "
          f"{1000.0 * 2 * SSL_B / it_ms:.4f} samples/s, peak memory "
          f"{peak:.3f} GiB ({resident:.3f} GiB resident before the "
          f"iteration: this script's models, batch and pins) [{card}]")
    print("    split: " + ", ".join(f"{k} {v:.3f} ms"
                                    for k, v in split.items())
          + f" [{card}]")
    del m, opts
    for name, c in SSL_LAUNCHES.items():
        per[name]["launches"] = ssl_launches[name]
        print(f"  {name}: {describe(per[name])} per SSL iteration, {c} calls "
              f"[{card}]")
    for name in ("key_conv_batched", "key_conv_bwd"):
        per[name]["launches"] = key_launches[name]
        print(f"  {name}: {describe(per[name])} per SSL iteration, "
              f"{KEY_LAUNCHES[name]} calls [{card}]")
    name = "gather_conv_batched"
    per[name]["launches"] = rb_launches[name]
    print(f"  {name}: {describe(per[name])} per SSL iteration, "
          f"{RULEBOOK_LAUNCHES[name]} calls [{card}]")
    print(f"  K5 against K1 per iteration: forward "
          f"{per['key_conv_batched']['ms']:.3f} vs "
          f"{per['window_key_conv_batched']['ms']:.3f} ms; backward kernel "
          f"(S only; dF and dW are fp32 matmuls outside it) "
          f"{per['key_conv_bwd']['ms']:.3f} vs "
          f"{per['window_key_conv_bwd']['ms']:.3f} ms [{card}]")
    print(f"  solve_masked_batched: {len(jv)} calls per iteration (K, valid "
          f"rows: fusion {jv[0]}, consistency {jv[-1]}), "
          f"{per['solve_masked_batched']['ms']:.3f} ms together [{card}]")
    per.update(onehot_per)
    return per


def rulebook_phase(cfg, model, batch, pseudo, pinned, window_ref, stats):
    """The SSL iteration with ``conv_impl="rulebook"`` (K7) on the card:
    every K7 call against its twin, one iteration's launches, the pinned
    3D step against the plain and the window paths, and the backbone's
    levels against the window path's. Returns (the rulebook-path model,
    its recorded conv calls, the ``gather_rows`` calls of its student
    forward, the iteration's launches)."""
    import copy

    from detmatch_tpu_torch.apis.build import build_ssl
    from detmatch_tpu_torch.models.pvrcnn import anchor_head
    from detmatch_tpu_torch.models.pvrcnn import pvrcnn as pvrcnn_mod
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.ops import pointnet
    from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN
    from detmatch_tpu_torch.train.optim import detmatch_branch_optimizers
    from detmatch_tpu_torch.train.ssl_step import (ema_step, student_2d_step,
                                                   student_3d_step,
                                                   teacher_step)

    def gen():
        return torch.Generator(DEVICE).manual_seed(SEED)

    phase("SSL iteration: rulebook path (K7)")
    cfg_rb = copy.deepcopy(cfg)
    det3d = cfg_rb["model"]["detector_3d"]
    det3d["backbone3d_cfg"] = dict(det3d.get("backbone3d_cfg") or {},
                                   conv_impl="rulebook")
    rb_model = build_ssl(cfg_rb)
    rb_model.load_state_dict(model.state_dict())
    m = copy.deepcopy(rb_model).train()
    calls, row_calls = [], []
    m.ops = recording(KERNELS, calls)
    own_gather = pointnet.gather_rows

    def record_gather(x, idx):
        row_calls.append((x.detach(), idx.detach()))
        return own_gather(x, idx)

    with torch.no_grad():
        rb_pseudo = teacher_step(m, batch)
        pointnet.gather_rows = anchor_head.gather_rows = record_gather
        try:
            m.student_losses_3d_concat(batch, rb_pseudo, 0, gen())
        finally:
            pointnet.gather_rows = anchor_head.gather_rows = own_gather
    del m, rb_pseudo
    point_calls = [c for c in calls if c[0] in POINT_KERNELS]
    calls = [c for c in calls if c[0] == "gather_conv_batched"]
    with torch.no_grad():
        ok = check_kernels(calls, "rulebook path", stats)
        ok &= check_kernels(point_calls, "rulebook path", stats)
    ok &= len(point_calls) == POINT_CALLS
    # one rulebook per indice key: each subm pair's two convs share theirs
    shared = len({c[1][1].data_ptr() for c in calls
                  if c[1][0].shape[0] == 2 * SSL_B})
    print(f"  K7 calls per iteration (teacher + student forward): "
          f"{len(calls)}; rulebooks of the student's 12 convs {shared}; "
          f"gather_rows calls of the student forward {len(row_calls)}")
    with torch.no_grad():
        for i, (_, args, _, _) in enumerate(calls):
            if args[0].shape[0] != 2 * SSL_B:
                continue
            twice = torch.equal(KERNELS.gather_conv_batched(*args),
                                KERNELS.gather_conv_batched(*args))
            ok &= twice
            print(f"  rulebook path gather_conv_batched[{i}] two launches "
                  f"bit-equal={twice} {'ok' if twice else 'FAIL'}")
    if not ok or len(calls) != 24 or shared != 8:
        raise AssertionError("K7, K2 or K3 disagrees with its twin, K7 "
                             "differs between two launches, or K7's "
                             "calls are not 24 per iteration on 8 student "
                             "rulebooks, or K2's and K3's not 24 and 2")

    m = copy.deepcopy(rb_model).train()
    opts = detmatch_branch_optimizers(m, 0.04, 0.16)
    cuda_ops.reset_launch_counts()
    teacher_step(m, batch)
    student_3d_step(m, opts[0], batch, pseudo, 0, gen())
    student_2d_step(m, opts[1], batch, pseudo, 0, gen())
    ema_step(m, 0)
    torch.cuda.synchronize()
    launches = cuda_ops.launch_counts()
    print(f"launches in one rulebook-path iteration: {launches}; expected "
          f"{RULEBOOK_LAUNCHES}")
    if any(launches[n] != c for n, c in RULEBOOK_LAUNCHES.items()):
        raise AssertionError("the rulebook path did not launch 24 / 0 / 0 / "
                             "0, or launched K6 or K8")
    del m, opts

    own_layer = pvrcnn_mod.proposal_layer
    pvrcnn_mod.proposal_layer = lambda *a, **kw: pinned
    res = {}
    try:
        for path, ops in (("kernel", KERNELS), ("plain", PLAIN)):
            m = copy.deepcopy(rb_model).train()
            m.ops = ops
            with torch.no_grad():
                total, logs = m.student_losses_3d_concat(batch, pseudo, 0,
                                                         gen())
            res[path] = (dict({k: float(v) for k, v in logs.items()},
                              loss=float(total)),
                         {n: b.clone() for n, b in
                          m.student["det3d"].named_buffers()
                          if n.endswith(("running_mean", "running_var"))})
            del m
    finally:
        pvrcnn_mod.proposal_layer = own_layer
    lk, bk = res["kernel"]
    ok = True
    for path, (lp, bp) in (("plain", res["plain"]), ("window", window_ref)):
        for k in lp:
            ok &= report(f"rulebook path against the {path} path: loss {k} "
                         f"({lk[k]:.6f})",
                         abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12))
        ok &= report(f"rulebook path against the {path} path: BN running "
                     "statistics (worst)",
                     max(rel_err(bk[n], bp[n]) for n in bp))

    lab, u = batch["lab"]["stu"], batch["unlab"]["stu"]
    feats, keys = (torch.cat([lab[k], u[k]], 0)
                   for k in ("voxel_features", "voxel_keys"))
    with torch.no_grad():
        lv = {label: copy.deepcopy(mdl.student["det3d"].backbone_3d).train()(
            feats, keys, KERNELS) for label, mdl in (("window", model),
                                                     ("rulebook", rb_model))}
    for n in LEVELS:
        same = torch.equal(lv["rulebook"][n]["keys"], lv["window"][n]["keys"])
        err = rel_err(lv["rulebook"][n]["feats"], lv["window"][n]["feats"])
        good = same and err <= CONV_RTOL
        ok &= good
        print(f"  backbone {n} (B={feats.shape[0]}): keys equal {same}, "
              f"features rel_err={err:.3e} against the window path "
              f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("the rulebook path disagrees with the plain or "
                             "the window path")
    return rb_model, calls, row_calls, launches


def onehot_phase(card, stats, rb_calls, row_calls, main_launches):
    """K6 on the rulebook path's 12 student (B=8) conv operands and K8 on
    its student forward's ``gather_rows`` operands, through their public
    entry points (forward, and the backward by ``torch.autograd.grad``),
    against their twins, timed; returns their per-kernel times, bounds,
    replay counts and launches on the main path (``main_launches``)."""
    from torch.nn import functional as F

    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.ops.cuda import onehot_gather as og
    from detmatch_tpu_torch.ops.cuda import onehot_rows as orows
    from detmatch_tpu_torch.ops.cuda.key_conv import key_conv_grads

    phase("K6 and K8 on the main path's operands")
    g = torch.Generator(DEVICE).manual_seed(SEED)
    convs = []
    for _, (feats, rb, w), _, _ in rb_calls:
        if feats.shape[0] != 2 * SSL_B:
            continue
        dout = torch.randn(*rb.shape[:2], w.shape[-1], generator=g,
                           device=DEVICE)
        convs.append((feats, rb, w, dout))
    rows = []
    for x, idx in row_calls:
        b = x.shape[0]
        idx = idx.reshape(b, -1).to(torch.int32)
        dout = torch.randn(b, idx.shape[1], x.shape[-1], generator=g,
                           device=DEVICE)
        rows.append((x.contiguous(), idx, dout))
    ok = len(convs) == 12 and len(rows) > 0
    flats, hot = [], 0
    cuda_ops.reset_launch_counts()
    for i, (feats, rb, w, dout) in enumerate(convs):
        b, n, c = feats.shape
        m, k, co = rb.shape[1], rb.shape[2], w.shape[-1]
        f = feats.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        out = og.onehot_gather_conv_batched(f, rb, ww)
        d_f, d_w = torch.autograd.grad(out, (f, ww), dout)
        with torch.no_grad():
            # the twins on the batch flattened as the entry point does
            base = (torch.arange(b, dtype=torch.int32, device=DEVICE)
                    * n)[:, None, None]
            flat = torch.where(rb >= 0, rb + base, -1).reshape(b * m, k)
            fl = (feats.reshape(b * n, c), flat, w, dout.reshape(b * m, co))
            flats.append(fl)
            # a second launch on the flattened operands: the same bits
            twice = torch.equal(og.onehot_gather_conv(*fl[:3]),
                                out.reshape(b * m, co))
            ref = og.onehot_gather_forward_plain(*fl[:3])
            direct = og.onehot_gather_scatter.direct
            s_k = og.onehot_gather_scatter(fl[3], flat, b * n)
            direct = og.onehot_gather_scatter.direct - direct
            s_p = og.onehot_gather_scatter_plain(fl[3], flat, b * n)
            p_f, p_w = key_conv_grads(s_p, fl[0][None], w)
        torch.cuda.synchronize()
        err = rel_err(out.reshape(b * m, co), ref)
        exact = torch.equal(s_k, s_p)
        same = (torch.equal(d_f.reshape(b * n, c), p_f[0])
                and torch.equal(d_w, p_w))
        good = (err <= CONV_RTOL and twice and exact and same
                and direct == 1)
        ok &= good
        for name, e in (
                ("onehot_gather_conv", (out.reshape(b * m, co) - ref).abs()
                 .max()),
                ("onehot_gather_scatter", (s_k - s_p).abs().max())):
            st = stats.setdefault(name, dict(max_abs_err=0.0, cases=0))
            st["cases"] += 1
            st["max_abs_err"] = max(st["max_abs_err"], float(e))
        print(f"  K6 student conv[{i}] feats {tuple(feats.shape)} rulebook "
              f"{tuple(rb.shape)} Co={co}: forward rel_err={err:.3e}, "
              f"two launches bit-equal={twice}, S "
              f"exact={exact} ({'direct' if direct else 'sorted'} path), "
              f"autograd dF and dW equal to the twin's S einsums={same} "
              f"{'ok' if good else 'FAIL'}")
        del out, d_f, d_w, ref, s_k, s_p, p_f, p_w, f, ww
    for i, (x, idx, dout) in enumerate(rows):
        n = x.shape[1]
        xg = x.clone().requires_grad_()
        out = orows.onehot_take_rows_batched(xg, idx)
        (dx,) = torch.autograd.grad(out, (xg,), dout)
        with torch.no_grad():
            ref_rows = orows.take_rows_plain(x, idx)
            ref = orows.scatter_rows_plain(dout, idx, n)
            ok_ = (idx >= 0) & (idx < n)
            base = (torch.arange(x.shape[0], device=DEVICE) * n)[:, None]
            most = int(torch.bincount((idx.long() + base)[ok_]).max()) \
                if ok_.any() else 0
            # a slot of several chunks: a second launch gives the same bits
            repeat = (torch.equal(orows.onehot_scatter_rows(dout, idx, n), dx)
                      if most > orows.CHUNK else None)
            hot += repeat is not None
        torch.cuda.synchronize()
        exact = torch.equal(out, ref_rows)
        err = rel_err(dx, ref)
        good = exact and err <= CONV_RTOL and repeat is not False
        ok &= good
        for name, e in (("onehot_take_rows_batched",
                         (out - ref_rows).abs().max()),
                        ("onehot_scatter_rows", (dx - ref).abs().max())):
            st = stats.setdefault(name, dict(max_abs_err=0.0, cases=0))
            st["cases"] += 1
            st["max_abs_err"] = max(st["max_abs_err"], float(e))
        print(f"  K8 gather_rows[{i}] table {tuple(x.shape)} idx "
              f"{tuple(idx.shape)} (most repeats of one index {most}): "
              f"gather exact={exact}, autograd scatter rel_err={err:.3e}"
              + ("" if repeat is None else
                 f", a second launch bit-equal={repeat}")
              + f" {'ok' if good else 'FAIL'}")
        del out, dx, ref_rows, ref, xg
    launches = cuda_ops.launch_counts()
    paths = dict(direct=og.onehot_gather_scatter.direct,
                 sorted=og.onehot_gather_scatter.sorted)
    # K6's forward and S once more each, for their bit-equality and exact
    # checks; the hot K8 calls' scatter once more for their second launch
    replayed = dict(onehot_gather_conv=len(convs),
                    onehot_gather_scatter=len(convs),
                    onehot_take_rows_batched=len(rows),
                    onehot_scatter_rows=len(rows))
    expect = dict(replayed, onehot_gather_conv=2 * len(convs),
                  onehot_gather_scatter=2 * len(convs),
                  onehot_scatter_rows=len(rows) + hot)
    print(f"  launches in the replay: "
          f"{ {n: launches[n] for n in ONEHOT_KERNELS} }; expected {expect}; "
          f"K6's S paths {paths}, expected all {2 * len(convs)} direct on "
          f"the {len(convs)} student rulebooks; {hot} K8 calls with a slot "
          f"of more than {orows.CHUNK} pairs")
    if (not ok or any(launches[n] != c for n, c in expect.items())
            or paths != dict(direct=2 * len(convs), sorted=0)):
        raise AssertionError("K6 or K8 disagrees with its twin on the main "
                             "path's operands, K6's forward differs between "
                             "two launches, a kernel was not launched as "
                             "counted, or K6's S left the direct path")

    # K6's sorted path: a rulebook with repeated rows (up to ~60 writers a
    # slot), -1 and out-of-range entries, against the CPU twin
    gc = torch.Generator().manual_seed(7)
    rb_rep = torch.randint(-1, 600, (30000, 27), generator=gc,
                           dtype=torch.int32)
    rb_rep[::5, 4] = 700
    d_rep = torch.randn(30000, 24, generator=gc)
    want = og.onehot_gather_scatter_plain(d_rep, rb_rep, 650)
    before = og.onehot_gather_scatter.sorted
    with torch.no_grad():
        got = og.onehot_gather_scatter(d_rep.to(DEVICE), rb_rep.to(DEVICE),
                                       650).cpu()
    sorted_path = og.onehot_gather_scatter.sorted - before == 1
    exact = torch.equal(got, want)
    st = stats["onehot_gather_scatter"]
    st["cases"] += 1
    st["max_abs_err"] = max(st["max_abs_err"],
                            float((got - want).abs().max()))
    print(f"  K6 S on a rulebook with repeats (30000, 27), N=650: sorted "
          f"path={sorted_path}, equal to the CPU twin={exact} "
          f"{'ok' if sorted_path and exact else 'FAIL'}")
    if not (sorted_path and exact):
        raise AssertionError("K6's sorted path disagrees with the CPU twin")

    phase(f"K6 and K8: timing (CUDA events) on {card}")
    per = {n: dict(ms=0.0, plain_ms=0.0, launches=main_launches[n],
                   replayed_calls=c) for n, c in replayed.items()}
    with torch.no_grad():
        for feats, flat, w, dout in flats:
            k = flat.shape[1]
            co, n_total = w.shape[-1], feats.shape[0]
            # the library call's inputs, prepared outside the timing: the
            # bf16-rounded cotangent row of each (row, tap) pair with an
            # input row, and its slot k * N + rb
            mi, ki = (flat >= 0).nonzero(as_tuple=True)
            slots = ki * n_total + flat[mi, ki].long()
            rounded = og._bf16(dout)[mi]
            for name, kern, plain, lib, args, rate in (
                    ("onehot_gather_conv", og.onehot_gather_conv,
                     og.onehot_gather_forward_plain, None, (feats, flat, w),
                     BF16_FLOP_PER_S),
                    ("onehot_gather_scatter", og.onehot_gather_scatter,
                     og.onehot_gather_scatter_plain,
                     lambda: dout.new_zeros((k * n_total, co))
                     .index_add_(0, slots, rounded),
                     (dout, flat, n_total), FP32_FLOP_PER_S)):
                t = per[name]
                sorted0 = og.onehot_gather_scatter.sorted
                ms = cuda_ms(lambda: kern(*args), reps=5)
                t["ms"] += ms
                t["plain_ms"] += cuda_ms(lambda: plain(*args), reps=2)
                if lib is not None:
                    lib_ms = cuda_ms(lib, reps=5)
                    t["library_ms"] = t.get("library_ms", 0.0) + lib_ms
                    path = ("direct" if og.onehot_gather_scatter.sorted
                            == sorted0 else "sorted")
                    print(f"    {name} rulebook {tuple(flat.shape)} N="
                          f"{n_total} Co={co} ({path} path): {ms:.3f} ms, "
                          f"library {lib_ms:.3f} ms")
                add_bound(t, *work(name, args, {}), rate)
            del mi, ki, slots, rounded
        for x, idx, dout in rows:
            b, n, c = x.shape
            # the library calls' inputs, prepared outside the timing: the
            # bf16-rounded table behind a zero row, the ids shifted by one
            # (0 for an out-of-range index); the rounded cotangent rows
            # with an index in range, and their flat slots
            ok_ = (idx >= 0) & (idx < n)
            base = (torch.arange(b, device=DEVICE) * n)[:, None]
            table = torch.cat([x.new_zeros(1, c),
                               orows._bf16(x).reshape(b * n, c)])
            ids = torch.where(ok_, idx.long() + base + 1, 0)
            slots = (idx.long() + base)[ok_]
            rounded = orows._bf16(dout)[ok_]
            for name, kern, plain, lib, args in (
                    ("onehot_take_rows_batched",
                     orows.onehot_take_rows_batched, orows.take_rows_plain,
                     lambda: F.embedding(ids, table), (x, idx)),
                    ("onehot_scatter_rows", orows.onehot_scatter_rows,
                     orows.scatter_rows_plain,
                     lambda: x.new_zeros(b * n, c).index_add_(
                         0, slots, rounded), (dout, idx, n))):
                t = per[name]
                ms, lib_ms = cuda_ms(lambda: kern(*args), reps=5), cuda_ms(
                    lib, reps=5)
                t["ms"] += ms
                t["plain_ms"] += cuda_ms(lambda: plain(*args), reps=2)
                t["library_ms"] = t.get("library_ms", 0.0) + lib_ms
                add_bound(t, *work(name, args, {}))
                share = ""
                if name == "onehot_scatter_rows":
                    keys = orows.slot_keys(name, idx, idx.shape[1], b, n)
                    sort_ms = cuda_ms(lambda: torch.sort(keys, stable=True),
                                      reps=5)
                    share = (f", its stable sort {sort_ms:.3f} ms = "
                             f"{sort_ms / ms:.1%} of it")
                print(f"    {name} table {tuple(x.shape)} idx "
                      f"{tuple(idx.shape)} (most repeats of one index "
                      f"{int(torch.bincount(slots, minlength=1).max())}): "
                      f"{ms:.3f} ms{share}, library {lib_ms:.3f} ms")
    for name in ONEHOT_KERNELS:
        lib = per[name].get("library_ms")
        print(f"  {name}: {describe(per[name])}"
              + (f", library {lib:.3f} ms" if lib is not None else "")
              + f" over {per[name]['replayed_calls']} replayed calls; "
              f"{per[name]['launches']} launches on the main path [{card}]")
    return per


# frames of the synthetic tree; the labeled split is create_ssl_splits'
# max(1, round(160 x 0.01)) = 2 frames, so that ObjectSample, which draws
# from the labeled frames' gt database, finds objects of another frame
TREE_TRAIN, TREE_LAB, TREE_VAL = 160, 2, 4
# 64 beams of 1,000 rays over the 90 degrees in front (every hit kept): the
# camera's view, which create_data crops the clouds to, keeps more than
# the 18,000 points a frame the loaders fill
TREE_POINTS, TREE_AZIMUTH = 64000, 1000
TREE_STEPS = 2
PRETRAIN_3D = ROOT / "configs/detmatch/001/pretrain_pvrcnn/split_0.py"
PRETRAIN_2D = ROOT / "configs/detmatch/001/pretrain_frcnn/split_0.py"
# two one-cycle steps start at the schedule's peak (10 x base_lr): a
# tenth of the recipe's rate keeps the two-step model's boxes finite
PRETRAIN_3D_LR = 1e-4
RESTORE_RTOL = 1e-4


def cli_data(root):
    """The synthetic KITTI tree and every file ``split_0.py`` reads, made
    as a user makes them: the frames (``utils/synth_kitti.
    write_kitti_tree``) and ``ImageSets``, then ``tools.create_data``
    (infos, reduced clouds, the gt database) and ``tools.create_ssl_splits
    --fracs 0.01 --num-splits 1`` (the labeled and unlabeled split infos
    and the labeled frames' gt database under ``ssl_splits/``)."""
    import pickle

    from detmatch_tpu_torch.tools import create_data, create_ssl_splits
    from detmatch_tpu_torch.utils.synth_kitti import write_kitti_tree

    phase("CLI: a synthetic KITTI tree, create_data, create_ssl_splits")
    t0 = time.perf_counter()
    ids = write_kitti_tree(str(root), TREE_TRAIN + TREE_VAL, seed=SEED,
                           num_points=TREE_POINTS, n_azimuth=TREE_AZIMUTH)
    (root / "ImageSets").mkdir()
    for name, sel in (("train", ids[:TREE_TRAIN]), ("val", ids[TREE_TRAIN:])):
        (root / "ImageSets" / f"{name}.txt").write_text("\n".join(sel) + "\n")
    print(f"  frames written in {time.perf_counter() - t0:.3f} s")
    for tool, argv in ((create_data, ["kitti", "--root", str(root)]),
                       (create_ssl_splits, ["--root", str(root), "--fracs",
                                            "0.01", "--num-splits", "1"])):
        t0 = time.perf_counter()
        tool.main(argv)
        print(f"  tools.{tool.__name__.rsplit('.', 1)[1]}: "
              f"{time.perf_counter() - t0:.3f} s")

    def load(rel):
        with open(root / rel, "rb") as f:
            return pickle.load(f)

    lab = load("ssl_splits/kitti_infos_train_proj_3d_lab_0.01_0.pkl")
    unlab = load("ssl_splits/kitti_infos_train_unlab_0.01_0.pkl")
    db_all = load("kitti_dbinfos_train.pkl")
    db_lab = load("ssl_splits/kitti_dbinfos_train_lab_0.01_0.pkl")
    lab_ids = {int(i["image"]["image_idx"]) for i in lab}
    frames_all = {int(e["image_idx"]) for v in db_all.values() for e in v}
    frames_lab = {int(e["image_idx"]) for v in db_lab.values() for e in v}
    n_full = [int((root / "training/velodyne" / f"{i}.bin").stat().st_size
                  // 16) for i in ids]
    n_red = [int((root / "training/velodyne_reduced" / f"{i}.bin").stat()
                 .st_size // 16) for i in ids]
    print(f"  {len(ids)} frames, points a frame {min(n_full)}-{max(n_full)}, "
          f"in the camera's view {min(n_red)}-{max(n_red)}; split "
          f"{len(lab)} labeled / {len(unlab)} unlabeled; gt database "
          f"{sum(len(v) for v in db_all.values())} objects of "
          f"{len(frames_all)} frames, split's "
          f"{ {k: len(v) for k, v in db_lab.items()} } of frames "
          f"{sorted(frames_lab)}")
    if (len(lab) != TREE_LAB or len(unlab) != TREE_TRAIN - TREE_LAB
            or len(load("kitti_infos_val.pkl")) != TREE_VAL
            or not frames_lab or not frames_lab <= lab_ids
            or len(frames_all) <= len(frames_lab)):
        raise AssertionError("the split files do not hold the frame counts "
                             "the tree implies, or the split's gt database "
                             "holds an unlabeled frame")
    if min(n_red) < 18000:
        raise AssertionError("a reduced frame has fewer points than the "
                             "18,000 cap")


def tree_data(cfg, key, root):
    """``cfg['data'][key]`` with the tree as its data root."""
    import copy

    def move(d):
        d = dict(d)
        if "data_root" in d:
            d["ann_file"] = str(root / d["ann_file"][len(d["data_root"]):])
            d["data_root"] = str(root)
        if "dataset" in d:
            d["dataset"] = move(d["dataset"])
        return d

    return move(copy.deepcopy(cfg["data"][key]))


def loader_ms(loader, n):
    """Host ms a batch of a warm loader: the first batch, then ``n``
    more timed."""
    it = iter(loader)
    first = next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    return first, 1000.0 * (time.perf_counter() - t0) / n


def tree_phases(card, root, work):
    """Pretraining → SSL (``load_from``, checkpoints, evaluation) →
    resume → KITTI AP from the synthetic KITTI tree at ``root`` that
    :func:`cli_data` made, at ``split_0.py``'s widths (see the module
    docstring, item 10); runs under ``work``."""
    from detmatch_tpu_torch import native
    from detmatch_tpu_torch.apis.build import (build_dataset, build_detector,
                                               build_ssl, build_voxelizer)
    from detmatch_tpu_torch.apis.evaluate import (eval_frcnn, eval_pvrcnn,
                                                  eval_ssl)
    from detmatch_tpu_torch.apis.train_pretrain import (train_frcnn,
                                                        train_pvrcnn)
    from detmatch_tpu_torch.apis.train_ssl import (restore_ssl_checkpoint,
                                                   ssl_iteration,
                                                   ssl_optimizers, train_ssl)
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.data.collate import collate_ts, collate_view
    from detmatch_tpu_torch.data.loader import Loader
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.train import checkpoints

    phase("tree: loaders at split_0's shapes")
    cfg = Config.fromfile(str(SSL_CONFIG))
    spec = build_voxelizer(cfg)
    ck = cfg["data"]["collate"]
    rng = np.random.RandomState(SEED)
    lab = build_dataset(tree_data(cfg, "train_lab", root), rng=rng)
    unlab = build_dataset(tree_data(cfg, "train_unlab", root), rng=rng)
    val = build_dataset(tree_data(cfg, "val", root), rng=rng)
    ts = lambda s: collate_ts(s, **ck)  # noqa: E731
    view = lambda s: collate_view(s, **ck)  # noqa: E731
    shapes = {}
    for name, ds in (("labeled", lab), ("unlabeled", unlab)):
        loader = Loader(ds, SSL_B, ts, seed=SEED, num_workers=4)
        try:
            batch, ms = loader_ms(loader, 3)
        finally:
            loader.stop()
        stu = batch["stu"]
        shapes[name] = batch
        print(f"  {name}: {ms:.3f} host ms a batch of {SSL_B} + "
              f"{SSL_B} views (4 workers); points "
              f"{stu['points'].shape}, slots filled "
              f"{stu['points_valid'].sum(1).tolist()}, img "
              f"{stu['img'].shape} [{card}]")
        canvas = tuple(cfg["model"]["detector_2d"]["canvas"])
        if (stu["points"].shape != (SSL_B, ck["max_points"], 4)
                or not stu["points_valid"].all()
                or stu["img"].shape != (SSL_B, *canvas, 3)):
            raise AssertionError(f"{name} batch off split_0's shapes")
    n_gt = (shapes["labeled"]["stu"]["gt_boxes"][..., 7] > 0).sum(1)
    before = [len(lab.dataset[i]["gt_bboxes_3d"]) for i in range(TREE_LAB)]
    after = [len(lab.shared(lab.dataset[i])["gt_bboxes_3d"])
             for i in range(TREE_LAB)]
    print(f"  gt boxes of the labeled frames {before} -> {after} after "
          f"ObjectSample; a collated labeled batch {n_gt.tolist()}")
    if sum(after) <= sum(before):
        raise AssertionError("ObjectSample added no boxes")

    phase("tree: train_pvrcnn and train_frcnn from the tree")
    pre = {}
    for key, path, fn in (("det3d", PRETRAIN_3D, train_pvrcnn),
                          ("det2d", PRETRAIN_2D, train_frcnn)):
        pcfg = Config.fromfile(str(path))
        ds = build_dataset(tree_data(pcfg, "train", root),
                           rng=np.random.RandomState(SEED))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            model = build_detector(pcfg, key="detector_" + key[3:])
        pck = pcfg["data"]["collate"]
        coll = lambda s: collate_view(s, **pck)  # noqa: E731
        args = (model, spec, ds) if key == "det3d" else (model, ds)
        kw = dict(base_lr=PRETRAIN_3D_LR) if key == "det3d" else {}
        cuda_ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, _, hist = fn(*args, coll, str(work / key), TREE_STEPS,
                        batch_size=TRAIN_B, log_interval=1,
                        ckpt_interval=1, seed=SEED, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda_ops.launch_counts()
        pre[key] = str(work / key / "ckpt")
        steps = sorted(int(d.name[5:]) for d in (work / key / "ckpt")
                       .iterdir())
        print(f"  {fn.__name__}: {TREE_STEPS} steps of B={TRAIN_B} in "
              f"{wall:.3f} s wall; losses "
              + " ".join(f"{h['loss']:.4f}" for h in hist)
              + f"; checkpoints {steps}; launches {launches}")
        finite = all(np.isfinite(v) for h in hist for v in h.values())
        need = (("window_key_conv_batched", "window_key_conv_bwd",
                 "ball_query_batched", "fps_batched") if key == "det3d"
                else ())
        if (not finite or steps != [1, 2]
                or not all(launches[n] > 0 for n in need)):
            raise AssertionError(f"{fn.__name__}: a loss is not finite, "
                                 "a checkpoint is missing or a kernel "
                                 "was not launched")
        del model

    phase("tree: train_ssl with load_from, checkpoints, evaluation")
    common = dict(batch_size=SSL_B, log_interval=1, seed=SEED,
                  load_from=pre, val_dataset=val, val_collate_fn=view)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 1)
        ssl = build_ssl(cfg)
    ssl, _, _ = train_ssl(ssl, spec, lab, unlab, ts, str(work / "ssl0"),
                          0, **common)
    same = True
    for key, path in pre.items():
        want = checkpoints.restore(path, TREE_STEPS)["model"]
        for half in (ssl.student, ssl.teacher):
            got = half[key].state_dict()
            same &= all(torch.equal(got[k].cpu(), v)
                        for k, v in want.items())
    print(f"  before the first step: student = teacher = checkpoint: "
          f"{same}")
    if not same:
        raise AssertionError("load_from did not put each checkpoint "
                             "into both branches")
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    ssl, opts, hist = train_ssl(ssl, spec, lab, unlab, ts,
                                str(work / "ssl"), TREE_STEPS,
                                ckpt_interval=1, eval_interval=TREE_STEPS,
                                **common)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_ops.launch_counts()
    lines = [json.loads(x) for x in (work / "ssl" / "log.json")
             .read_text().splitlines()]
    val_line = [x for x in lines if x["mode"] == "val"]
    print(f"  {TREE_STEPS} iterations (2 checkpoints, 1 evaluation) in "
          f"{wall:.3f} s wall; losses "
          + " ".join(f"{h['loss']:.4f}" for h in hist)
          + f"; launches {launches}")
    finite = all(np.isfinite(v) for h in hist for v in h.values())
    if (not finite or len(val_line) != 1 or not all(
            launches[n] > 0 for n in SSL_LAUNCHES)):
        raise AssertionError("train_ssl: a loss is not finite, the "
                             "evaluation did not run or a kernel of "
                             "K1-K4 was not launched")

    phase("tree: resume from ckpt_2")
    ckpt = str(work / "ssl" / "ckpt")
    payload = checkpoints.restore(ckpt, checkpoints.latest_step(ckpt))
    live_sd = ssl.state_dict()
    exact = all(torch.equal(payload["state"][k], v.cpu())
                for k, v in live_sd.items())
    for opt, key in zip(opts, ("det3d", "det2d")):
        ref = opt.state_dict()
        got = payload["opt_state"][key]
        exact &= got["count"] == ref["count"] == TREE_STEPS
        exact &= got["skipped"] == ref["skipped"]
        for k in ("mu", "nu", "trace"):
            exact &= all(torch.equal(a, b.cpu()) for a, b in
                         zip(got.get(k, ()), ref.get(k, ())))
    print(f"  restored ckpt_{checkpoints.latest_step(ckpt)} equals the "
          f"live state exactly: {exact}")
    if not exact:
        raise AssertionError("the checkpoint differs from the live state")
    del live_sd
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 2)
        restored = build_ssl(cfg)
    r_opts = ssl_optimizers(restored, SSL_B)
    r_gen = torch.Generator(DEVICE)
    restore_ssl_checkpoint(restored, r_opts, r_gen, payload)
    l_gen = torch.Generator(DEVICE)
    l_gen.set_state(payload["rng"])
    del payload
    pinned = dict(lab=ts([lab[i] for i in range(SSL_B)]),
                  unlab=ts([unlab[i] for i in range(SSL_B)]))
    outs = []
    for m, o, g in ((restored.train(), r_opts, r_gen),
                    (ssl, opts, l_gen)):
        outs.append(ssl_iteration(m, o, spec, pinned, TREE_STEPS, g))
    worst_loss = max(abs(outs[0][k] - outs[1][k])
                     / max(abs(outs[1][k]), 1e-12)
                     for k in outs[1] if "loss" in k)
    r_sd, l_sd = restored.state_dict(), ssl.state_dict()
    worst_t, where = 0.0, ""
    for k, v in l_sd.items():
        if v.is_floating_point() and v.numel():
            e = float((r_sd[k] - v).abs().max()
                      / v.abs().max().clamp(min=1e-12))
            if e > worst_t:
                worst_t, where = e, k
    print(f"  one iteration on a pinned batch, restored against live: "
          f"losses within {worst_loss:.3e}, tensors within "
          f"{worst_t:.3e} of their largest magnitude ({where})")
    if worst_loss > RESTORE_RTOL or worst_t > RESTORE_RTOL:
        raise AssertionError("the restored iteration differs from the "
                             "live one")
    del restored, r_opts, r_sd, l_sd

    phase(f"tree: SSL iteration fed from the loaders on {card}")
    lab_l = Loader(lab, SSL_B, ts, seed=SEED)
    unlab_l = Loader(unlab, SSL_B, ts, seed=SEED + 1)
    synth = ssl_batch_np(cfg, np.random.RandomState(SEED))
    try:
        li, ui = iter(lab_l), iter(unlab_l)
        rows = {"loader": [], "synthetic": []}
        for it in range(2):
            for name in ("loader", "synthetic"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                b = (dict(lab=next(li), unlab=next(ui))
                     if name == "loader" else synth)
                ssl_iteration(ssl, opts, spec, b, TREE_STEPS + 1 + it,
                              l_gen)
                torch.cuda.synchronize()
                if it:
                    rows[name].append(1000.0 * (time.perf_counter()
                                                - t0))
    finally:
        lab_l.stop()
        unlab_l.stop()
    for name, r in rows.items():
        print(f"  fed from {name}: "
              + " / ".join(f"{x:.3f}" for x in r)
              + f" ms an iteration (host clock, synchronized) [{card}]")
    del synth

    phase("tree: KITTI evaluation")
    lib_path = native.build()
    used = dict.fromkeys(("gather_tp_scores", "sweep_thresholds",
                          "sweep_thresholds_aos"), 0)
    wrapped = {n: getattr(native, n) for n in used}

    def counting(n):
        def call(*a, **k):
            used[n] += 1
            return wrapped[n](*a, **k)
        return call

    for n in used:
        setattr(native, n, counting(n))
    try:
        t0 = time.perf_counter()
        res = eval_ssl(ssl, val, view, spec)
        eval_s = time.perf_counter() - t0
        per_frame = {}
        for name, fn, args in (
                ("eval_pvrcnn", eval_pvrcnn,
                 (ssl.student["det3d"], val, view, spec)),
                ("eval_frcnn", eval_frcnn,
                 (ssl.student["det2d"], val, view))):
            fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            per_frame[name] = (1000.0 * (time.perf_counter() - t0)
                               / len(val))
    finally:
        for n, f in wrapped.items():
            setattr(native, n, f)
    keys = [k for k in res if k.endswith("_moderate") and "mAP" in k
            or k.endswith("num_dets")]
    for k in sorted(keys):
        print(f"  {k}: {res[k]:.4f}")
    print(f"  eval_ssl of {len(val)} frames in {eval_s:.3f} s; C "
          f"matcher {lib_path.name}, calls {used} (the sweeps run "
          "only where a detection matched)")
    for name, ms in per_frame.items():
        print(f"  {name}: {ms:.3f} ms a frame (B=2, {len(val)} frames, "
              f"host clock) [{card}]")
    shown = {k: round(v, 4) for k, v in val_line[0].items()
             if "mAP_3d_moderate" in k}
    print(f"  training log's val line: {shown}")
    if (not all(np.isfinite(v) for v in res.values())
            or not all(f"{b}.{d}.num_dets" in res for b in ("tea", "stu")
                       for d in ("3d", "2d"))
            or not used["gather_tp_scores"]):
        raise AssertionError("an AP is not finite, a branch is missing "
                             "or the C matcher was not used")
    del ssl, opts


# the bfloat16 phase: bfloat16 loss terms against float32 on the same
# pins (tests/test_torch_port_bf16.py:LOSS_BF16_RTOL, 16 bfloat16 steps)
BF16_LOSS_RTOL = 16 * 2.0 ** -8
# JAX's benchmark recipe (detmatch_tpu/benchmarks.py:42-57, production_cfg)
RECIPE_3D = dict(backbone_caps=(16000, 12000, 9000, 9000),
                 train_nms=dict(nms_pre=1024, nms_post=128, nms_thresh=0.8),
                 test_nms=dict(nms_pre=1024, nms_post=100, nms_thresh=0.7),
                 compute_dtype="bfloat16")
RECIPE_SAMPLES = 2 * SSL_B  # labeled + unlabeled frames an iteration


def bf16_phases(card):
    """``compute_dtype="bfloat16"`` on both detectors of ``split_0.py`` at
    full width, beside the float32 models with the same seeded weights
    (see the module docstring, item 11)."""
    import copy

    from detmatch_tpu_torch.apis.build import build_voxelizer
    from detmatch_tpu_torch.apis.train_ssl import ssl_iteration, ssl_optimizers
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.models.pvrcnn import pvrcnn as pvrcnn_mod
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.ssl import detector as det_mod
    from detmatch_tpu_torch.ssl import modules
    from detmatch_tpu_torch.train.ssl_step import (teacher_step,
                                                   to_device_views,
                                                   voxelize_views)

    def gen():
        return torch.Generator(DEVICE).manual_seed(SEED)

    phase("bf16: models, views and pins")
    cfg = Config.fromfile(str(SSL_CONFIG))
    cfg16 = copy.deepcopy(cfg)
    for key in ("detector_3d", "detector_2d"):
        cfg16["model"][key]["compute_dtype"] = "bfloat16"
    spec = build_voxelizer(cfg)
    models = {"fp32": ssl_model(cfg), "bf16": ssl_model(cfg16)}
    sd32, sd16 = (m.state_dict() for m in models.values())
    if not all(torch.equal(sd32[k], v) for k, v in sd16.items()):
        raise AssertionError("the bf16 model's weights differ from fp32's")
    del sd32, sd16
    rng = np.random.RandomState(SEED)
    batch_np = ssl_batch_np(cfg, rng)
    batch = voxelize_views(to_device_views(batch_np, DEVICE), spec)
    canvas = tuple(cfg["model"]["detector_2d"]["canvas"])
    for view in (batch["unlab"]["tea"], batch["unlab"]["stu"]):
        view["aug3d"], view["aug2d"] = aug_records(
            rng, SSL_B, canvas, view["ori_shape"][0].tolist())
    tea, u = batch["unlab"]["tea"], batch["unlab"]["stu"]
    m32 = models["fp32"]
    with torch.no_grad():
        t3 = m32._det3d_teacher_boxes(tea)
        t2_pin = matching_2d_boxes(t3, tea, u, 100, m32.cfg.score_filter_3d)
    m32._det3d_teacher_boxes = lambda view: t3
    m32._det2d_teacher_boxes = lambda view, nms_cfg: t2_pin
    pseudo = teacher_step(m32, batch)
    del m32._det3d_teacher_boxes, m32._det2d_teacher_boxes
    m = copy.deepcopy(m32).train()
    clean, pinned = student_2d_pins(m, batch, pseudo, gen())
    del m
    pseudo = dict(pseudo, m2d_clean=clean, m2d_stu=modules.transform_2d(
        clean, u["aug2d"], reverse=False))

    phase("bf16: the student 3D losses against fp32 (pinned)")
    # proposals pinned, and the consistency branch's selection of the
    # student's own boxes (its post-processing NMS) pinned to fp32's: the
    # bf16 run's boxes and scores at fp32's surviving RoIs
    own_layer, own_post = pvrcnn_mod.proposal_layer, det_mod.post_processing
    survivors = {}

    def recording_post(out, **kw):
        res = own_post(out, **kw)
        same = (res["boxes"][:, :, None] == out["batch_box_preds_rcnn"][
            :, None]).all(-1)
        survivors.update(sel=same.int().argmax(-1), valid=res["valid"])
        return res

    def pinned_post(out, **kw):
        sel, valid = survivors["sel"], survivors["valid"]

        def take(t):
            t = torch.stack([x[i] for x, i in zip(t, sel)])
            return torch.where(valid.view(valid.shape + (1,) * (
                t.dim() - 2)), t, torch.zeros((), dtype=t.dtype,
                                              device=t.device))

        return dict(boxes=take(out["batch_box_preds_rcnn"]),
                    scores=take(torch.sigmoid(out["rcnn_cls"][..., 0])),
                    labels=take(out["roi_labels"]),
                    sem_scores_full=take(torch.sigmoid(
                        out["roi_scores_full"])), valid=valid)

    pvrcnn_mod.proposal_layer = lambda *a, **kw: pinned
    losses = {}
    try:
        for name, model in models.items():
            det_mod.post_processing = (recording_post if name == "fp32"
                                       else pinned_post)
            m = copy.deepcopy(model).train()
            total, logs = m.student_losses_3d_concat(batch, pseudo, 0, gen())
            total.backward()
            finite = all(bool(torch.isfinite(p.grad).all())
                         for p in m.student["det3d"].parameters()
                         if p.grad is not None)
            losses[name] = dict({k: float(v.detach()) for k, v in
                                 logs.items()}, loss=float(total.detach()))
            print(f"  {name}: loss {losses[name]['loss']:.6f}, gradients "
                  f"finite: {finite}")
            if not finite:
                raise AssertionError(f"a {name} gradient is not finite")
            del m, total, logs
    finally:
        pvrcnn_mod.proposal_layer = own_layer
        det_mod.post_processing = own_post
    ok = True
    for k, want in losses["fp32"].items():
        err = abs(losses["bf16"][k] - want) / max(abs(want), 1e-3)
        good = np.isfinite(losses["bf16"][k]) and err <= BF16_LOSS_RTOL
        ok &= good
        print(f"  {k}: fp32 {want:.6f} bf16 {losses['bf16'][k]:.6f} "
              f"rel {err:.3e} ({err * 256:.2f} bf16 steps) "
              + ("ok" if good else "FAIL"))
    if not ok:
        raise AssertionError("a bf16 loss term is off its fp32 value by more "
                             "than the CPU tests' bound")

    phase(f"bf16: ms an SSL iteration, in turns, on {card}")
    opts = {name: ssl_optimizers(model, SSL_B)
            for name, model in models.items()}
    for turn, name in enumerate(("fp32", "bf16")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_ops.reset_launch_counts()
        split = iteration_split(models[name].train(), batch_np, spec,
                                opts[name], gen(), reps=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # two iterations: iteration_split's warm-up and the timed one
        launches = {k: cuda_ops.launch_counts()[k] for k in SSL_LAUNCHES}
        print(f"  {name}: {split['iteration']:.3f} ms an iteration "
              f"(B={SSL_B}+{SSL_B}); split " + ", ".join(
                  f"{k} {split[k]:.3f}" for k in ITER_STAGES)
              + f"; peak {peak:.3f} GiB; launches in 2 iterations "
              f"{launches} [{card}]")
        if launches != {k: 2 * v for k, v in SSL_LAUNCHES.items()}:
            raise AssertionError(f"{name}: the launches an iteration differ "
                                 f"from {SSL_LAUNCHES}")
    del models, opts, batch, pseudo, pinned, clean, t3, t2_pin

    phase(f"bf16: JAX's benchmark recipe, one SSL iteration, on {card}")
    cfg_r = copy.deepcopy(cfg16)
    cfg_r["model"]["detector_3d"].update(RECIPE_3D)
    cfg_r["voxelizer"]["max_voxels"] = 16000
    spec_r = build_voxelizer(cfg_r)
    model = ssl_model(cfg_r)
    opts_r = ssl_optimizers(model, SSL_B)
    cuda_ops.reset_launch_counts()
    logs = ssl_iteration(model.train(), opts_r, spec_r, batch_np, 0, gen())
    torch.cuda.synchronize()
    launches = {k: cuda_ops.launch_counts()[k] for k in SSL_LAUNCHES}
    if not all(np.isfinite(v) for v in logs.values()) \
            or launches != SSL_LAUNCHES:
        raise AssertionError("the recipe's iteration is not finite or its "
                             "launches differ")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    split = iteration_split(model, batch_np, spec_r, opts_r, gen(), reps=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = split["iteration"]
    print(f"  recipe (train NMS 1024 -> 128, caps "
          f"{RECIPE_3D['backbone_caps']}, bf16, 16,000 voxels): {ms:.3f} ms "
          f"an iteration, {1000.0 * RECIPE_SAMPLES / ms:.3f} samples/s "
          f"(B={SSL_B}+{SSL_B}); split " + ", ".join(
              f"{k} {split[k]:.3f}" for k in ITER_STAGES)
          + f"; peak {peak:.3f} GiB [{card}]")
    del model, opts_r


def tree_options(cfg_path, root):
    """``--cfg-options`` that point every data entry of a ``split_0.py``
    config at the tree ``root`` (``data_root`` and ``ann_file``)."""
    from detmatch_tpu_torch.config import Config
    data = Config.fromfile(str(cfg_path))["data"]
    opts = []
    for key, entry in data.items():
        prefix = f"data.{key}"
        if "dataset" in entry:
            entry, prefix = entry["dataset"], prefix + ".dataset"
        if "data_root" not in entry:
            continue
        rel = entry["ann_file"][len(entry["data_root"]):]
        opts += [f"{prefix}.data_root={root}",
                 f"{prefix}.ann_file={root / rel}"]
    return opts


AP_FAMILIES = tuple(f"{b}.{d}.{m}" for b in ("tea", "stu") for d in ("3d", "2d")
                    for m in ("mAP_", "num_dets"))


def cli_phases(card, root, work):
    """The command-line tools on the tree ``root`` that :func:`cli_data`
    made (see the module docstring, item 12)."""
    import contextlib
    import io

    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.tools import test as test_cli
    from detmatch_tpu_torch.tools import train as train_cli
    from detmatch_tpu_torch.utils.visualize import read_png

    def timed(label, fn, argv, need=()):
        cuda_ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda_ops.launch_counts().items() if v}
        print(f"  {label}: {time.perf_counter() - t0:.3f} s; launches "
              f"{launches} [{card}]")
        if not all(launches.get(n, 0) > 0 for n in need):
            raise AssertionError(f"{label}: a kernel of {need} was not "
                                 "launched")
        return out

    phase("CLI: tools.train pretrain_3d, pretrain_2d")
    pre = {}
    for key, path in (("pretrain_3d", PRETRAIN_3D), ("pretrain_2d",
                                                     PRETRAIN_2D)):
        opts = tree_options(path, root) + (
            [f"base_lr={PRETRAIN_3D_LR}"] if key == "pretrain_3d" else [])
        _, _, hist = timed(
            f"tools.train {path.relative_to(ROOT)} --max-iters 1",
            train_cli.main,
            [str(path), "--work-dir", str(work / key), "--max-iters", "1",
             "--cfg-options"] + opts,
            FWD_KERNELS + ("window_key_conv_bwd",)
            if key == "pretrain_3d" else ())
        pre[key] = work / key / "ckpt"
        if not (np.isfinite(hist[0]["loss"]) and (pre[key] / "ckpt_1")
                .is_dir()):
            raise AssertionError(f"{key}: a loss is not finite or ckpt_1 is "
                                 "missing")

    phase("CLI: tools.train ssl, then --resume-from")
    opts = tree_options(SSL_CONFIG, root) + [
        "load_from=" + repr({"det3d": str(pre["pretrain_3d"]),
                             "det2d": str(pre["pretrain_2d"])}),
        "log_interval=1", "ckpt_interval=1", "vis_interval=1",
        "evaluation=None"]
    ssl_work = work / "ssl"
    need = tuple(SSL_LAUNCHES)
    for iters, extra in ((2, []), (3, ["--resume-from",
                                       str(ssl_work / "ckpt")])):
        timed(" ".join([f"tools.train {SSL_CONFIG.relative_to(ROOT)} "
                        f"--max-iters {iters}"] + extra[:1]), train_cli.main,
              [str(SSL_CONFIG), "--work-dir", str(ssl_work), "--max-iters",
               str(iters)] + extra + ["--cfg-options"] + opts, need)
    lines = [json.loads(x) for x in (ssl_work / "log.json").read_text()
             .splitlines()]
    ckpts = sorted(d.name for d in (ssl_work / "ckpt").iterdir())
    canvas = tuple(Config.fromfile(str(SSL_CONFIG))["model"]["detector_2d"][
        "canvas"]) + (3,)
    shapes = {}
    for it in (1, 2, 3):
        for kind in ("bev", "2d", "pairs"):
            shapes[f"{it}_{kind}"] = read_png(
                ssl_work / "vis" / f"iter{it:06d}_{kind}.png").shape
    print(f"  log.json iterations {[x['iter'] for x in lines]}, losses "
          + " ".join(f"{x['loss']:.4f}" for x in lines)
          + f"; checkpoints {ckpts}; vis {sorted(set(shapes.values()))}")
    if ([x["iter"] for x in lines] != [1, 2, 3]
            or not all(np.isfinite(x["loss"]) for x in lines)
            or ckpts != ["ckpt_1", "ckpt_2", "ckpt_3"]
            or any(v != ((800, 704, 3) if k.endswith("bev") else canvas)
                   for k, v in shapes.items())):
        raise AssertionError("the SSL CLI's log, checkpoints or pictures "
                             "are off")

    phase("CLI: tools.test on the SSL checkpoint")
    argv = [str(SSL_CONFIG), str(ssl_work / "ckpt"), "--cfg-options"] + \
        tree_options(SSL_CONFIG, root)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = timed("tools.test (in process)", test_cli.main,
                    argv + ["--out-kitti", str(work / "results")],
                    FWD_KERNELS)
    printed = buf.getvalue()
    print("\n".join(x for x in printed.splitlines()
                    if x.startswith("  tools.test")))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "detmatch_tpu_torch.tools.test"]
                          + argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    print(f"  python -m detmatch_tpu_torch.tools.test: "
          f"{time.perf_counter() - t0:.3f} s, exit {proc.returncode} "
          f"[{card}]")
    found = [f for f in AP_FAMILIES if f in printed and f in proc.stdout]
    for k in sorted(res):
        if k.endswith(("mAP_3d_moderate", "mAP_bbox_moderate", "num_dets")):
            print(f"  {k}: {res[k]:.4f}")
    print(f"  AP families printed by both runs: {len(found)} of "
          f"{len(AP_FAMILIES)}")
    if (proc.returncode != 0 or len(found) != len(AP_FAMILIES)
            or not all(np.isfinite(v) for v in res.values())):
        print(proc.stderr[-4000:])
        raise AssertionError("tools.test failed, an AP family is missing or "
                             "an AP is not finite")
    return dict(pretrain_3d=pre["pretrain_3d"], ssl=ssl_work / "ckpt",
                results=work / "results")


# the LiDAR zoo (zoo_phases): each model at JAX's default widths, its
# registry name, its batch kind and its kernel launches a forward (K1
# forward, K2, K3; K1's backward launches as often as its forward in a
# training step)
ZOO = (("SECOND", "voxel", dict(window_key_conv_batched=12)),
       ("SECONDNetIoU", "voxel", dict(window_key_conv_batched=12)),
       ("PointPillar", "pillar", {}),
       ("VoxelRCNN", "voxel", dict(window_key_conv_batched=12,
                                   ball_query_batched=3)),
       ("PartA2Net", "voxel", dict(window_key_conv_batched=28)),
       ("PointRCNN", "point", dict(ball_query_batched=11, fps_batched=6)))
ZOO_KERNELS = ("window_key_conv_batched", "window_key_conv_bwd",
               "ball_query_batched", "fps_batched")
ZOO_EVAL_B = (1, 4)
ZOO_REPS = 2  # timed runs after the warm-up
# pcdet pointpillar.yaml: 0.16 m pillars over (0, -39.68) - (69.12, 39.68),
# 12,000 pillars of 32 points; pointrcnn.yaml: 16,384 points a frame
PILLAR_SPEC = dict(point_cloud_range=(0, -39.68, -3, 69.12, 39.68, 1),
                   voxel_size=(0.16, 0.16, 4.0), max_voxels=12000,
                   max_points=32)
POINTRCNN_POINTS = 16384


def zoo_frames(spec, b, rng):
    """B synthetic HDL-64 frames of 18,000 points (``make_train_frames``'s
    scans) with the JAX benchmark's GT draw."""
    from detmatch_tpu_torch.utils.synth_kitti import gt_boxes, lidar_batch
    pts, valid = lidar_batch(rng, b, TRAIN_POINTS, spec.point_cloud_range)
    return dict(points=pts, points_valid=valid, gt_boxes=gt_boxes(rng, b))


def zoo_batch(kind, frames, spec):
    """A zoo model's batch on the card: voxels of ``spec`` (the training
    phase's ``split_0.py`` voxelizer), pillars of ``PILLAR_SPEC``, or
    16,384 points sampled from each frame's valid points."""
    from detmatch_tpu_torch.apis.train_pretrain import to_device_batch
    from detmatch_tpu_torch.ops.voxelize import VoxelizerSpec, voxelize_mean
    if kind == "point":
        rng = np.random.RandomState(SEED)
        idx = np.stack([np.sort(rng.choice(np.flatnonzero(v),
                                           POINTRCNN_POINTS, replace=False))
                        for v in frames["points_valid"]])
        frames = dict(frames, points=np.take_along_axis(
            frames["points"], idx[..., None], 1), points_valid=np.ones(
                idx.shape, bool))
    batch = to_device_batch(frames, spec, DEVICE)
    if kind == "pillar":
        batch["pillars"] = voxelize_mean(batch["points"],
                                         batch["points_valid"],
                                         VoxelizerSpec(**PILLAR_SPEC))
    return batch


def zoo_post(model, out):
    from detmatch_tpu_torch.models.pvrcnn.pvrcnn import post_processing
    from detmatch_tpu_torch.models.pvrcnn.second import (
        second_post_processing)
    return (post_processing(out) if "rcnn_cls" in out
            else second_post_processing(out))


def zoo_spread(times):
    return (f"{float(np.mean(times)):.3f} ms (min {min(times):.3f}, max "
            f"{max(times):.3f}, {len(times)} runs)")


def zoo_model(name, seed, own_init):
    """The registry's ``name`` at its default widths on the card:
    ``randomize_``'s weights, or (``own_init``) the model's own seeded
    initialisers (see ``make_train_model``)."""
    from detmatch_tpu_torch.apis.build import build_detector
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_detector({"model": {"detector_3d": dict(type=name)}})
    if not own_init:
        randomize_(model, seed)
    return model


def zoo_phases(card, stats):
    """The LiDAR zoo at JAX's default widths: per model a B=2 training
    step (kernel path against the plain paths, every recorded K1 / K2 / K3
    call against its twin, the launch counts) and detections at B = 1 and
    4 (kernel path against plain path), with ms a step and a detect call,
    peak memory and the kernels' launches and ms; returns the per-model
    lines."""
    import copy

    from detmatch_tpu_torch.apis.build import build_voxelizer
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN
    from detmatch_tpu_torch.ops.cuda.window_key_conv import (
        window_key_conv_bwd, window_key_conv_fwd, window_key_conv_plain)
    from detmatch_tpu_torch.train.optim import (clip_grad_norm_,
                                                make_optimizer)

    spec = build_voxelizer(Config.fromfile(str(CONFIG)))
    rng = np.random.RandomState(SEED + 14)
    train_frames = zoo_frames(spec, TRAIN_B, rng)
    eval_frames = zoo_frames(spec, max(ZOO_EVAL_B), rng)

    def gen():
        return torch.Generator(DEVICE).manual_seed(SEED)

    def conv_plain_backward(feats, keys, nkeys, out_keys, w, band):
        twin = window_key_conv_plain(feats, keys, nkeys, out_keys, w, band)
        with torch.no_grad():
            kern = KERNELS.window_key_conv_batched(feats, keys, nkeys,
                                                   out_keys, w, band)
        return kern + (twin - twin.detach())  # kern's values, twin's grad

    summary = []
    for name, kind, per_fwd in ZOO:
        phase(f"zoo: {name}")
        expect = {k: per_fwd.get(k, 0) for k in ZOO_KERNELS}
        expect["window_key_conv_bwd"] = expect["window_key_conv_batched"]
        batch = zoo_batch(kind, train_frames, spec)
        model = zoo_model(name, SEED, own_init=True).train()
        module = sys.modules[type(model).__module__]

        # kernel path: one training step with the launch counters
        calls = []
        m = copy.deepcopy(model)
        m.ops = recording(KERNELS, calls)
        cuda_ops.reset_launch_counts()
        out = m(batch, train=True, generator=gen())
        losses = m.loss(out, batch)
        losses["loss"].backward()
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda_ops.launch_counts().items()
                    if k in ZOO_KERNELS}
        lk = {k: float(v.detach()) for k, v in losses.items()}
        res = {"kernel": m}
        pinned = ({k: v.detach() for k, v in out["proposals"].items()}
                  if "proposals" in out else None)
        del out, losses
        print(f"  train B={TRAIN_B} losses: "
              + " ".join(f"{k}={v:.5f}" for k, v in lk.items()))
        print(f"  launches in the step: {launches}; expected {expect}")
        ok = all(np.isfinite(v) for v in lk.values())
        ok &= launches == expect
        with torch.no_grad():
            ok &= check_kernels(calls, f"{name} train", stats)

        # plain paths on the kernel path's proposals, same RoI picks and
        # dropout masks (one generator seed)
        own_layer = getattr(module, "proposal_layer", None)
        if pinned is not None:
            module.proposal_layer = lambda *a, **kw: pinned
        try:
            for path, ops in (("plain", PLAIN), ("plain backward", PLAIN._replace(
                    window_key_conv_batched=conv_plain_backward))):
                mp = copy.deepcopy(model)
                mp.ops = ops
                out = mp(batch, train=True, generator=gen())
                losses = mp.loss(out, batch)
                losses["loss"].backward()
                lp = {k: float(v.detach()) for k, v in losses.items()}
                res[path] = mp
                del out, losses
                if path == "plain":
                    for k in lp:
                        ok &= report(f"plain: loss {k}", abs(lk[k] - lp[k])
                                     / max(abs(lp[k]), 1e-12))
                    bufs = dict(mp.named_buffers())
                    stat_err = max([rel_err(b, bufs[n]) for n, b in
                                    res["kernel"].named_buffers()
                                    if n.endswith(("running_mean",
                                                   "running_var"))]
                                   or [0.0])
                    ok &= report("plain: BN running statistics (worst)",
                                 stat_err)
        finally:
            if own_layer is not None:
                module.proposal_layer = own_layer
        for path, gated in (("plain backward", True), ("plain", False)):
            worst, worst_name = worst_grad(res["kernel"], res[path])
            good = worst <= GRAD_TOL
            ok &= good or not gated
            print(f"  {path}: gradients: worst {worst:.3e} of the tensor's "
                  f"largest magnitude ({worst_name}) "
                  + (("ok" if good else "FAIL") if gated else
                     "(information)"))
        del res, mp

        # one optimizer step (train/optim.py), then ms a step in turns
        m = copy.deepcopy(model)
        params = list(m.parameters())
        opt, sched = make_optimizer(params, 0.001, 100)
        g = gen()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for step in range(1 + ZOO_REPS):  # the first is a warm-up
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = m(batch, train=True, generator=g)
            losses = m.loss(out, batch)
            opt.zero_grad(set_to_none=True)
            losses["loss"].backward()
            clip_grad_norm_(params)
            opt.step()
            sched.step()
            e1.record()
            torch.cuda.synchronize()
            ok &= bool(torch.isfinite(losses["loss"]))
            del out, losses
            if step:
                times.append(e0.elapsed_time(e1))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        moved = all(torch.isfinite(p).all() for p in params)
        ok &= bool(moved)
        line = dict(model=name, train_ms=zoo_spread(times),
                    train_peak_gib=round(peak, 3))
        print(f"  train step B={TRAIN_B}: {line['train_ms']}, peak memory "
              f"{peak:.3f} GiB [{card}]")
        del m, opt, sched, params

        # kernel and twin time of the step's calls, and K1's backward
        bwd_cases = []
        for cname, args, _, need in calls:
            if cname != "window_key_conv_batched":
                continue
            feats, keys, nkeys = args[:3]
            dout = torch.randn(feats.shape[0], nkeys.shape[1],
                               args[4].shape[-1], generator=gen(),
                               device=DEVICE)
            _, rb = window_key_conv_fwd(*args, rulebook=True)
            bwd_cases.append((args, need, dout, rb))
        with torch.no_grad():
            per = time_kernels(calls, bwd_cases)
        kern_line = {}
        for k in ZOO_KERNELS:
            if k in per:
                kern_line[k] = dict(launches=launches[k],
                                    ms=round(per[k]["ms"], 3),
                                    plain_ms=round(per[k]["plain_ms"], 3),
                                    bound_ms=round(per[k]["bound_ms"], 4))
                print(f"  {k}: {describe(per[k])} per training step, "
                      f"{launches[k]} launches [{card}]")
        line["kernels"] = kern_line
        del calls, bwd_cases, batch

        # detections at B = 1 and 4, kernel path against plain path: the
        # dense outputs within 1e-4; the two-stage models' detections on
        # the kernel path's proposals (random weights tie the scores so
        # densely that 1e-6 noise reorders the NMS cuts: the unpinned
        # share is information)
        model = zoo_model(name, SEED, own_init=False).eval()
        ebatch = zoo_batch(kind, eval_frames, spec)
        for b in ZOO_EVAL_B:
            bb = {k: (v[:b] if torch.is_tensor(v) else
                      {kk: vv[:b] for kk, vv in v.items()})
                  for k, v in ebatch.items()}
            with torch.inference_mode():
                model.ops = KERNELS
                cuda_ops.reset_launch_counts()
                out_k = model(bb)
                det_k = zoo_post(model, out_k)
                torch.cuda.synchronize()
                ev_launch = {k: v for k, v in
                             cuda_ops.launch_counts().items()
                             if k in ZOO_KERNELS and v}
                model.ops = PLAIN
                out_p = model(bb)
                share, total = match_share(det_k, zoo_post(model, out_p))
                good = ev_launch == {k: v for k, v in per_fwd.items() if v}
                good &= total > 0 and all(bool(torch.isfinite(
                    det_k[k]).all()) for k in ("boxes", "scores"))
                for k in ("batch_box_preds", "batch_cls_preds",
                          "point_cls_logits", "point_box_reg"):
                    if k in out_k:
                        good &= report(f"B={b} {k}",
                                       rel_err(out_k[k], out_p[k]))
                pinned_share = None
                if "proposals" in out_k:
                    module.proposal_layer = lambda *a, **kw: out_k[
                        "proposals"]
                    try:
                        pinned_share, _ = match_share(
                            det_k, zoo_post(model, model(bb)))
                    finally:
                        module.proposal_layer = own_layer
                    good &= pinned_share >= MATCH_SHARE
                model.ops = KERNELS
                ms = [cuda_ms(lambda: zoo_post(model, model(bb)), reps=1,
                              warmup=int(i == 0)) for i in range(ZOO_REPS)]
            ok &= good
            line[f"detect_b{b}_ms"] = zoo_spread(ms)
            pinned = ("" if pinned_share is None else
                      f", {pinned_share:.4f} on the kernel path's proposals")
            print(f"  detect B={b}: {zoo_spread(ms)}; detections "
                  f"{det_k['valid'].sum(1).tolist()}; matched on the plain "
                  f"path {share:.4f} of {total} (information){pinned}; "
                  f"launches {ev_launch} {'ok' if good else 'FAIL'} "
                  f"[{card}]")
            del det_k, out_k, out_p
        del model, ebatch
        summary.append(line)
        print("  " + json.dumps(line))
        if not ok:
            raise AssertionError(f"zoo: {name} failed a gate")
    return summary


# ------------------------------------------------------------ CaDDN, demos

CADDN_CONFIG = ROOT / "configs/caddn/caddn_kitti.py"
CADDN_B, CADDN_STEPS, CADDN_LR = 2, 3, 1e-3
# B=1 eval, card against CPU: the depth logits (the DDN's convs, cuDNN
# against oneDNN) and the heads' box and class predictions, relative to
# each tensor's largest magnitude; the heads' is wider: the softmax of the
# depth logits and 30 BEV convs amplify the logits' float32 noise
# (tests/test_torch_port_caddn.py: 1e-6 in the logits moves the frustum
# by 1e-4)
CADDN_LOGIT_RTOL, CADDN_HEAD_RTOL = 1e-4, 1e-3
# a demo's detections against the API's on the same card and weights
DEMO_RTOL = 1e-5
# fuse_conv_bn: detect's dense outputs folded against unfolded
# (tests/test_torch_port_misc_tools.py:DENSE_TOL)
FUSE_RTOL = 2e-3


def caddn_tensors(view, b=None):
    return {k: torch.from_numpy(np.ascontiguousarray(v[:b])).to(DEVICE)
            for k, v in view.items()}


def same_detections(label, got, want):
    """A demo's kept detections (numpy dicts with ``boxes``) against the
    API's: the same count and labels, boxes and scores within DEMO_RTOL
    of their largest magnitude."""
    ok = len(got["boxes"]) == len(want["boxes"]) and all(
        np.array_equal(got[k], want[k]) for k in got if "label" in k)
    errs = {k: float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-12))
            for k in got if ok and "label" not in k and len(want[k])}
    ok &= all(e <= DEMO_RTOL for e in errs.values())
    print(f"  {label}: {len(got['boxes'])} detections (the API's "
          f"{len(want['boxes'])}), errors {errs} " + ("ok" if ok else "FAIL"))
    return ok


def mono_phases(card):
    """CaDDN at JAX's defaults (``configs/caddn/caddn_kitti.py``): a B=1
    eval forward on the card against the CPU, three AdamW steps at B=2 on
    one synthetic batch (``utils/synth_kitti.caddn_view``) and the
    monocular demo on their checkpoint."""
    from detmatch_tpu_torch.apis.build import build_detector
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.models.pvrcnn.second import (
        second_post_processing)
    from detmatch_tpu_torch.train.optim import clip_grad_norm_
    from detmatch_tpu_torch.utils.synth_kitti import caddn_view

    t_all = time.perf_counter()
    cfg = Config.fromfile(str(CADDN_CONFIG))
    view = caddn_view(np.random.RandomState(SEED), CADDN_B)
    grid = cfg["model"]["detector_mono"]["grid_size"]
    print(f"  grid {grid}, {int(np.prod(grid)):,} voxels; frustum "
          f"80 x 96 x 320 x 64 fp32 = "
          f"{80 * 96 * 320 * 64 * 4 / 2 ** 20:.1f} MiB and the sampled "
          f"grid {int(np.prod(grid)) * 64 * 4 / 2 ** 20:.1f} MiB a sample; "
          f"gt boxes a frame {(view['gt_boxes'][..., 7] > 0).sum(1)}, in "
          f"the image {view['gt_boxes2d'].any(-1).sum(1)}; depth-map cells "
          f"with a point {float((view['depth_maps'] > 0).mean()):.4f}")

    phase(f"CaDDN: B=1 eval forward, the card against the CPU, on {card}")
    model = build_detector(cfg, key="detector_mono")
    randomize_(model, SEED)
    b1 = caddn_tensors(view, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = model(b1)
        post = second_post_processing(out)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cpu = build_detector(cfg, device="cpu", key="detector_mono")
    cpu.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    with torch.inference_mode():
        out_c = cpu({k: v.cpu() for k, v in b1.items()})
        post_c = second_post_processing({k: out_c[k].to(DEVICE) for k in (
            "batch_box_preds", "batch_cls_preds")})
    cpu_s = time.perf_counter() - t0
    ok = True
    for name, tol in (("depth_logits", CADDN_LOGIT_RTOL),
                      ("batch_box_preds", CADDN_HEAD_RTOL),
                      ("batch_cls_preds", CADDN_HEAD_RTOL)):
        err = rel_err(out[name].cpu(), out_c[name])
        ok &= err <= tol
        print(f"  {name} {tuple(out[name].shape)}: rel_err={err:.3e} "
              f"(gate {tol:g}) {'ok' if err <= tol else 'FAIL'}")
    share, total = match_share(to_cpu(post), to_cpu(post_c))
    n_valid = int(post["valid"].sum())
    finite = all(bool(torch.isfinite(v).all()) for v in out["head_preds"]
                 .values())
    ms = cuda_ms(lambda: second_post_processing(model(b1)), reps=2)
    print(f"  detections {n_valid} (post-processed on the card: the CPU's "
          f"outputs matched {share:.4f} of {total}, information); finite "
          f"{finite}; CPU forward {cpu_s:.3f} s; eval B=1 {ms:.3f} ms "
          f"(forward + post-processing); peak {peak:.3f} GiB [{card}]")
    if not (ok and finite and n_valid > 0):
        raise AssertionError("CaDDN: the card's eval forward disagrees with "
                             "the CPU, or its detections are not finite")
    del model, cpu, out, out_c, post, post_c

    phase(f"CaDDN: B={CADDN_B} training, {CADDN_STEPS} AdamW steps on one "
          f"batch, on {card}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = build_detector(cfg, key="detector_mono").train()
    batch = caddn_tensors(view)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=CADDN_LR, betas=(0.95, 0.99),
                            weight_decay=0.01)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    terms, step_ms, finite = [], [], True
    for _ in range(CADDN_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        losses = model.loss(model(batch), batch)
        losses["loss"].backward()
        clip_grad_norm_(params)
        opt.step()
        ev[1].record()
        torch.cuda.synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
        terms.append({k: v.item() for k, v in losses.items()})
        finite &= all(bool(torch.isfinite(p.grad).all()) for p in params
                      if p.grad is not None)
        del losses
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, t in enumerate(terms):
        print(f"  step {i}: " + ", ".join(f"{k} {v:.6f}" for k, v in
                                         t.items())
              + f"; {step_ms[i]:.3f} ms")
    finite &= all(np.isfinite(v) for t in terms for v in t.values())
    falling = terms[-1]["loss"] < terms[0]["loss"]
    print(f"  {float(np.mean(step_ms[1:])):.3f} ms a step (B={CADDN_B}, "
          f"CUDA events, after a warm-up step); peak {peak:.3f} GiB; "
          f"finite {finite}; loss falling {falling} [{card}]")
    if not (finite and falling):
        raise AssertionError("CaDDN: a loss term or gradient is not finite, "
                             "or the loss did not fall")
    tmp = tempfile.TemporaryDirectory(prefix="caddn_")
    try:
        caddn_demo(card, model, batch, view, Path(tmp.name))
    finally:
        tmp.cleanup()
    print(f"  CaDDN phases {time.perf_counter() - t_all:.1f} s")


def caddn_demo(card, model, batch, view, work):
    """``demo.mono_demo`` on ``model``'s checkpoint and the first frame of
    ``view``, against the model's own post-processing of it."""
    from detmatch_tpu_torch.data.pipelines import load_bgr
    from detmatch_tpu_torch.demo import mono_demo
    from detmatch_tpu_torch.models.pvrcnn.second import (
        second_post_processing)
    from detmatch_tpu_torch.train import checkpoints
    from detmatch_tpu_torch.utils.synth_kitti import calib_text
    from detmatch_tpu_torch.utils.visualize import CAFFE_MEAN, write_png_bgr

    ckpt = work / "ckpt"
    checkpoints.save(str(ckpt), dict(model=model.state_dict()), CADDN_STEPS)

    phase(f"CaDDN: demo.mono_demo on that checkpoint, on {card}")
    img = np.clip(np.rint(view["images"][0] + CAFFE_MEAN), 0, 255)
    write_png_bgr(str(work / "img.png"), img.astype(np.uint8))
    (work / "calib.txt").write_text(calib_text())
    t0 = time.perf_counter()
    res = mono_demo.main([str(CADDN_CONFIG), str(ckpt), "--img",
                          str(work / "img.png"), "--calib",
                          str(work / "calib.txt"), "--out",
                          str(work / "mono.png"), "--score-thr", "0.0"])
    demo_s = time.perf_counter() - t0
    model.eval()
    own = dict(images=torch.from_numpy(
        (load_bgr(str(work / "img.png")) - CAFFE_MEAN)[None]).to(DEVICE),
        lidar2cam=batch["lidar2cam"][:1], cam2img=batch["cam2img"][:1])
    with torch.inference_mode():
        post = second_post_processing(model(own), score_thresh=0.0)
    keep = post["valid"][0]
    want = {k: post[k][0][keep].cpu().numpy() for k in ("boxes", "scores",
                                                        "labels")}
    ok = same_detections(f"mono_demo ({demo_s:.3f} s) against the phase's "
                         "post-processing", res, want)
    ok &= (work / "mono.png").stat().st_size > 0
    if not ok:
        raise AssertionError("mono_demo's detections differ from the "
                             "phase's own")


def demo_phases(card, root, work, ckpts):
    """The LiDAR demos on the tree's pretraining and SSL checkpoints
    (``cli_phases``), one validation frame each, against ``detect`` and
    ``simple_test``; then the result tools: ``fuse_conv_bn`` (detect at
    B=4 folded against unfolded, both timed), ``publish_model``,
    ``print_config``, ``visualize_results`` on ``tools.test``'s KITTI
    results and ``browse_dataset``."""
    from detmatch_tpu_torch.apis.build import (build_detector, build_ssl,
                                               build_voxelizer)
    from detmatch_tpu_torch.apis.inference import detect
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.data.pipelines import load_bgr
    from detmatch_tpu_torch.demo import (multi_modality_demo, pcd_demo,
                                         point_batch)
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.tools.misc import (browse_dataset, fuse_conv_bn,
                                               print_config,
                                               visualize_results)
    from detmatch_tpu_torch.tools.model_converters import publish_model
    from detmatch_tpu_torch.train import checkpoints
    from detmatch_tpu_torch.utils.visualize import read_png

    t_all = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    idx = (root / "ImageSets" / "val.txt").read_text().split()[0]
    sub = root / "training"
    frame = dict(pts=str(sub / "velodyne" / f"{idx}.bin"),
                 img=str(sub / "image_2" / f"{idx}.png"),
                 calib=str(sub / "calib" / f"{idx}.txt"))

    def launched(label, fn, argv):
        cuda_ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            out = fn(argv)
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda_ops.launch_counts().items() if v}
        print(f"  {label}: {time.perf_counter() - t0:.3f} s; launches "
              f"{launches} [{card}]")
        if not all(launches.get(n, 0) > 0 for n in FWD_KERNELS):
            raise AssertionError(f"{label}: a kernel of {FWD_KERNELS} was "
                                 "not launched")
        return out

    phase(f"demos: pcd_demo and multi_modality_demo on frame {idx}, on "
          f"{card}")
    res = launched("demo.pcd_demo (pretraining checkpoint)", pcd_demo.main, [
        str(PRETRAIN_3D), str(ckpts["pretrain_3d"]), "--pts", frame["pts"],
        "--calib", frame["calib"], "--out", str(work / "pcd.png"),
        "--score-thr", "0.0"])
    cfg3 = Config.fromfile(str(PRETRAIN_3D))
    model = build_detector(cfg3)
    model.load_state_dict(checkpoints.restore_latest(
        str(ckpts["pretrain_3d"]))[0]["model"])
    _, p, v = point_batch(frame["pts"], DEVICE)
    det = detect(model, p, v, build_voxelizer(cfg3))
    keep = det["valid"][0] & (det["scores"][0] > 0.0)
    ok = same_detections("pcd_demo against detect", res, {
        k: det[k][0][keep].cpu().numpy() for k in res})
    res = launched("demo.multi_modality_demo (SSL checkpoint, teacher)",
                   multi_modality_demo.main, [
                       str(SSL_CONFIG), str(ckpts["ssl"]), "--pts",
                       frame["pts"], "--img", frame["img"], "--calib",
                       frame["calib"], "--out", str(work / "mm.png"),
                       "--score-thr", "0.0"])
    cfg = Config.fromfile(str(SSL_CONFIG))
    ssl = build_ssl(cfg)
    ssl.load_state_dict(checkpoints.restore_latest(str(ckpts["ssl"]))[0][
        "state"])
    det = detect(ssl.teacher["det3d"], p, v, build_voxelizer(cfg))
    keep = det["valid"][0] & (det["scores"][0] > 0.0)
    canvas, shape, s = multi_modality_demo.caffe_canvas(
        load_bgr(frame["img"]), ssl.teacher["det2d"].canvas)
    with torch.inference_mode():
        r2 = ssl.teacher["det2d"].simple_test(
            torch.from_numpy(canvas).to(DEVICE),
            torch.from_numpy(shape).to(DEVICE), score_thr=0.0)
    k2 = r2["valid"][0] & (r2["scores"][0] > 0.0)
    ok &= same_detections("multi_modality_demo 3D against detect", {
        "boxes": res["boxes3d"], "scores": res["scores3d"]}, {
        "boxes": det["boxes"][0][keep].cpu().numpy(),
        "scores": det["scores"][0][keep].cpu().numpy()})
    ok &= same_detections("multi_modality_demo 2D against simple_test", {
        "boxes": res["boxes2d"], "scores": res["scores2d"],
        "labels": res["labels2d"]}, {
        "boxes": r2["boxes"][0][k2].cpu().numpy() / s,
        "scores": r2["scores"][0][k2].cpu().numpy(),
        "labels": r2["labels"][0][k2].cpu().numpy()})
    shapes = [read_png(str(work / f)).shape for f in ("pcd.png", "mm.png")]
    print(f"  pictures {shapes}")
    if not ok:
        raise AssertionError("a demo's detections differ from the API's")
    del ssl

    phase(f"tools: fuse_conv_bn, then detect at B=4 on {card}")
    fused_dir = work / "fused"
    with contextlib.redirect_stdout(sys.stderr):
        n_pairs = fuse_conv_bn.main([str(ckpts["pretrain_3d"]),
                                     str(fused_dir)])
    spec = build_voxelizer(cfg3)
    batch4 = make_batch(spec, 4)
    states = {"unfused": {k: t.clone() for k, t in
                          model.state_dict().items()},
              "fused": checkpoints.restore_latest(str(fused_dir))[0][
                  "model"]}
    outs, dets, times = {}, {}, {k: [] for k in states}
    with torch.inference_mode():
        for name in ("unfused", "fused", "fused", "unfused"):
            model.load_state_dict(states[name])
            if name not in outs:
                outs[name] = model(batch4)
                dets[name] = detect(model, batch4["points"],
                                    batch4["points_valid"], spec,
                                    score_thresh=0.0)
            times[name].append(cuda_ms(lambda: detect(
                model, batch4["points"], batch4["points_valid"], spec,
                score_thresh=0.0), reps=2))
    ok = True
    # the outputs before the proposal NMS (after it, 1e-4 noise in the
    # scores can pick other RoIs: the detections' share is information)
    for k in ("bev_features", "batch_cls_preds", "batch_box_preds",
              "point_logits"):
        err = rel_err(outs["fused"][k], outs["unfused"][k])
        ok &= err <= FUSE_RTOL
        print(f"  {k}: rel_err={err:.3e} (gate {FUSE_RTOL:g})")
    share, total = match_share(dets["fused"], dets["unfused"])
    print(f"  {n_pairs} conv + BN pairs folded; detections matched "
          f"{share:.4f} of {total} (information); detect B=4 unfused "
          + " / ".join(f"{x:.3f}" for x in times["unfused"])
          + " ms, fused " + " / ".join(f"{x:.3f}" for x in times["fused"])
          + f" ms (in turns) [{card}]")
    if not ok or n_pairs == 0:
        raise AssertionError("fuse_conv_bn: detect moved past its gate")
    del model, states, outs, dets, batch4

    phase("tools: publish_model, print_config, visualize_results, "
          "browse_dataset")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out, digest = publish_model.main([str(ckpts["ssl"]),
                                          str(work / "published")])
        text = print_config.main([str(SSL_CONFIG)])
        opts = tree_options(SSL_CONFIG, root)
        vis = visualize_results.main([
            str(SSL_CONFIG), "--results", str(ckpts["results"] / "tea.3d"),
            "--out-dir", str(work / "vis"), "--cfg-options"] + opts)
        browse = browse_dataset.main([
            str(SSL_CONFIG), "--out-dir", str(work / "browse"), "--n", "2",
            "--cfg-options"] + opts)
    kept, _ = checkpoints.restore_latest(out)
    vis_shapes = sorted({read_png(x).shape for x in vis})
    browse_shapes = sorted({read_png(x).shape for x in browse})
    print(f"  publish_model -> {Path(out).name} (kept {sorted(kept)}); "
          f"print_config {len(text.splitlines())} lines; visualize_results "
          f"{len(vis)} PNGs {vis_shapes}; browse_dataset {len(browse)} PNGs "
          f"{browse_shapes}; {time.perf_counter() - t0:.3f} s")
    if ("opt_state" in kept or not out.endswith(digest)
            or text != Config.fromfile(str(SSL_CONFIG)).dump()
            or len(vis) != 2 * TREE_VAL or len(browse) != 4):
        raise AssertionError("a result tool's output is off")
    print(f"  demo and tool phases {time.perf_counter() - t_all:.1f} s")


# ------------------------------------------------------------ data parallel

DIST_WORLD = 2
DIST_ITERS = 2
# the recipe's rates at 4 + 4 frames, its warmup's first two steps at
# 0.001 and 0.003 of them: each iteration starts from the one process's
# state (``dist_ssl_run``'s ``resume``), so that float32 noise on
# near-zero gradients, which AdamW's first steps turn into moves of a
# whole step either way, does not carry into the next iteration; and
# the moves stay well above float32's rounding of the weights, so that
# the state's gates see a wrong or missing step
DIST_LR = (0.04, 0.08)
DIST_WARMUP = 500
DIST_KERNELS = ("window_key_conv_batched", "window_key_conv_bwd",
                "ball_query_batched", "fps_batched", "solve_masked_batched")
DIST_LOG_RTOL = 1e-4
DIST_STAT_RTOL = 1e-4
# gradients and AdamW moments: each tensor's L2 difference over its norm.
# Not GRAD_TOL of its largest entry: at the SSL config's full width the
# order of the batch norms' sums alone (two processes' partial sums
# added) moves the 3D trunk's gradients by up to 7.1e-3 in L2 and 7.9e-3
# of their largest entry, one process against itself on the H100, and
# two processes against one by up to 1.4e-2 in L2 (a batch norm's bias,
# a sum over 10^4 rows); every planted fault of
# tools/port_probes/dist_faults.py moves some tensor by 1.2 or more but
# the finest: one positive keypoint too many in the 3D denominators
# moves the point head's and the VSA's gradients by 4.1e-2 (and
# point_loss_cls by 2.9e-2, past the logs' gate). 3e-2 catches it on
# the gradients too and stays 2.1x over the largest of float32's order
# noise seen on the H100 (1.4e-2; 6.4e-3 beside the planted fault)
DIST_GRAD_RTOL = 3e-2
# the move of the students' and the EMA teacher's weights over an
# iteration, L2 over the norm of one process's move (``step_err``):
# float32's order of sums reaches 2.2e-2 through AdamW's sign-like first
# steps; a skipped, local or wrong step or EMA 0.7 or more
DIST_STEP_RTOL = 0.1
# an AdamW first moment settles its weight's direction where it is more
# than this share of its tensor's largest from zero (``adam_sure``)
ADAM_SURE = 1e-2


def _rows(tree, groups=1):
    """This process's rows of a pinned global tensor tree (every tensor
    batch-first; ``groups`` as ``parallel.global_rows``), on DEVICE."""
    from detmatch_tpu_torch import parallel
    n = next(iter(tree.values())).shape[0] // parallel.process_count()
    idx, _ = parallel.global_rows(n, groups)
    return {k: v[idx].to(DEVICE) for k, v in tree.items()}


def _pick_rows(out, sel, valid):
    """The post-processing result of the student's boxes at the pinned
    survivors ``sel`` / ``valid`` (per frame), gradients kept."""
    def take(t):
        t = torch.stack([x[i] for x, i in zip(t, sel)])
        return torch.where(valid.view(valid.shape + (1,) * (t.dim() - 2)),
                           t, torch.zeros((), dtype=t.dtype, device=t.device))

    return dict(boxes=take(out["batch_box_preds_rcnn"]),
                scores=take(torch.sigmoid(out["rcnn_cls"][..., 0])),
                labels=take(out["roi_labels"]),
                sem_scores_full=take(torch.sigmoid(out["roi_scores_full"])),
                valid=valid)


class SSLPins:
    """The pins of a data-parallel SSL comparison, one entry an
    iteration: every decision of the student step that float32 noise
    between batch sizes could flip, taken from one process's run on the
    global batch and handed to each process for its rows.

    * The teacher phase: its 2D boxes made to pair with its 3D ones
      (:func:`matching_2d_boxes`), and the pseudo-labels with the clean
      2D set made from the student's own boxes (:func:`student_2d_pins`).
    * The student's proposals (``pvrcnn.proposal_layer``), the
      consistency branch's survivors of the student's post-processing
      NMS, its 2D NMS and its assignment (``core.hungarian.
      assign_batched``), and the Faster R-CNN's proposals
      (``frcnn.rpn.rpn_proposals``, one call a frame: the order of its
      sort of near-equal scores would change which anchors its NMS
      keeps).

    ``pins`` None: made from this (one) process's own state and recorded
    (``iters``); else handed back, each process taking its rows, with its
    own teacher phase run beside them (``own``) and the pinned functions
    run for their launches. ``install()`` routes ``train_ssl``'s teacher
    step and those functions through the pins; it returns the undo."""

    def __init__(self, pins=None):
        self.pins = pins
        self.iters, self.own = [], []
        self._pin = None     # the iteration's pins once its teacher ran
        self._nms = 0        # batched_nms_2d calls since then
        self._rpn = 0        # rpn_proposals calls since then
        self._in_rpn = False

    def install(self):
        from detmatch_tpu_torch.apis import train_ssl
        from detmatch_tpu_torch.core import hungarian, nms
        from detmatch_tpu_torch.models.frcnn import faster_rcnn
        from detmatch_tpu_torch.models.pvrcnn import pvrcnn as pvrcnn_mod
        from detmatch_tpu_torch.ssl import detector
        own = dict(teacher=(train_ssl, "teacher_step"),
                   props=(pvrcnn_mod, "proposal_layer"),
                   post=(detector, "post_processing"),
                   nms=(nms, "batched_nms_2d"),
                   rpn=(faster_rcnn, "rpn_proposals"),
                   assign=(hungarian, "assign_batched"))
        real = {k: getattr(m, a) for k, (m, a) in own.items()}

        def teacher_step(m, batch):
            self._pin, self._nms, self._rpn = None, 0, 0
            if self.pins is None:
                pin = self._record(real["teacher"], m, batch)
            else:
                pin = self._replay(real["teacher"], m, batch)
            self._pin = pin
            return pin["pseudo_local"]

        def proposal_layer(*a, **kw):
            if self._pin is None:
                return real["props"](*a, **kw)
            return self._pin["props_local"]

        def post_processing(out, **kw):
            res = real["post"](out, **kw)
            if self._pin is None:
                return res
            if self.pins is None:
                same = (res["boxes"][:, :, None]
                        == out["batch_box_preds_rcnn"][:, None]).all(-1)
                self._pin["post"] = dict(sel=same.int().argmax(-1),
                                         valid=res["valid"])
                return res
            p = _rows(self._pin["post"])
            return _pick_rows(out, p["sel"], p["valid"])

        def global_call(c):
            """The global frame of this process's c-th per-frame call
            (each model call's frames its rank-major share of a global
            part)."""
            from detmatch_tpu_torch import parallel
            b = self._pin["b"]
            return ((c // b) * b * parallel.process_count()
                    + parallel.process_index() * b + c % b)

        def batched_nms_2d(*a, **kw):
            idx, ok = real["nms"](*a, **kw)
            if self._pin is None or self._in_rpn:
                return idx, ok
            calls = self._pin.setdefault("nms", [])
            if self.pins is None:
                calls.append(dict(idx=idx, ok=ok))
                return idx, ok
            g = global_call(self._nms)
            self._nms += 1
            return (calls[g]["idx"].to(DEVICE), calls[g]["ok"].to(DEVICE))

        def rpn_proposals(*a, **kw):
            if self._pin is None:
                return real["rpn"](*a, **kw)
            calls = self._pin.setdefault("rpn", [])
            if self.pins is None:
                self._in_rpn = True  # its NMS is pinned with it
                try:
                    props, scores = real["rpn"](*a, **kw)
                finally:
                    self._in_rpn = False
                calls.append(dict(props=props, scores=scores))
                return props, scores
            g = global_call(self._rpn)
            self._rpn += 1
            return (calls[g]["props"].to(DEVICE),
                    calls[g]["scores"].to(DEVICE))

        def assign_batched(*a, **kw):
            col4row, mcost = real["assign"](*a, **kw)
            if self._pin is None:
                return col4row, mcost
            if self.pins is None:
                self._pin["assign"] = dict(col4row=col4row, mcost=mcost)
                return col4row, mcost
            p = _rows(self._pin["assign"])
            return p["col4row"], p["mcost"]

        patched = dict(teacher=teacher_step, props=proposal_layer,
                       post=post_processing, nms=batched_nms_2d,
                       rpn=rpn_proposals, assign=assign_batched)
        for k, (m, a) in own.items():
            setattr(m, a, patched[k])

        def undo():
            for k, (m, a) in own.items():
                setattr(m, a, real[k])
            self._pin = None
        return undo

    def _teacher(self, teacher, m, batch, t2):
        m._det2d_teacher_boxes = lambda view, nms_cfg: t2
        try:
            return teacher(m, batch)
        finally:
            del m._det2d_teacher_boxes

    def _record(self, teacher, m, batch):
        import copy

        from detmatch_tpu_torch.ssl import modules
        u, tea = batch["unlab"]["stu"], batch["unlab"]["tea"]
        with torch.no_grad():
            t2 = matching_2d_boxes(m._det3d_teacher_boxes(tea), tea, u, 100,
                                   m.cfg.score_filter_3d)
        pseudo = self._teacher(teacher, m, batch, t2)
        student = copy.deepcopy(m).train()
        clean, props = student_2d_pins(
            student, batch, pseudo, torch.Generator(DEVICE).manual_seed(SEED))
        del student
        pseudo = dict(pseudo, m2d_clean=clean, m2d_stu=modules.transform_2d(
            clean, u["aug2d"], reverse=False))
        pin = dict(t2=t2, pseudo=pseudo, props=props, props_local=props,
                   pseudo_local=pseudo, b=u["points"].shape[0])
        self.iters.append(pin)
        return pin

    def _replay(self, teacher, m, batch):
        from detmatch_tpu_torch.ssl import boxset
        pin = dict(self.pins[len(self.own)])
        own = self._teacher(teacher, m, batch, _rows(pin["t2"]))
        self.own.append(own)
        pseudo = {k: _rows(v) for k, v in pin["pseudo"].items()
                  if k != "logs"}
        # the fusion's matched count, as the teacher logs it: the share of
        # this process's frames
        pseudo["logs"] = {"metrics.num_tea_hung":
                          boxset.num_valid(pseudo["m3d_stu"])}
        b = batch["lab"]["stu"]["points"].shape[0]
        pin.update(pseudo_local=pseudo, props_local=_rows(pin["props"],
                                                          (b, b)), b=b)
        return pin


def pins_to_save(rec):
    """The recorded pins on the CPU, without the per-process views."""
    def cpu(tree):
        if isinstance(tree, list):
            return [cpu(v) for v in tree]
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree

    return [cpu({k: v for k, v in p.items()
                 if k not in ("props_local", "pseudo_local")})
            for p in rec.iters]


def _cpu_state(model):
    return {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}


def dist_ssl_run(cfg, batches, pins, work_dir, seed=SEED, resume=None):
    """DIST_ITERS iterations of ``train_ssl_batches`` through
    :class:`SSLPins` (``pins`` None: record them) from ``ssl_model(cfg,
    seed)``; ``batches``: this process's collated numpy batches.

    ``resume``: one process's ``after`` list: after each iteration but
    the last, the model and its optimizers take that iteration's state
    from it, so that every iteration starts where the one process's did
    (float32 noise does not compound through AdamW's first steps, which
    move each weight by the learning rate in the direction of its
    gradient's sign, a near-zero gradient's too).

    Returns the model, the pins object and the results: each
    iteration's logs and gradients; after each iteration the state and
    the AdamW first moments (with the optimizers' states where ``resume``
    is None: what another run resumes from); the state at the start of
    each iteration; the kernels' launches and the peak memory."""
    from detmatch_tpu_torch.apis.build import build_voxelizer
    from detmatch_tpu_torch.apis.train_ssl import train_ssl_batches
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    model = ssl_model(cfg, seed)
    starts = [_cpu_state(model)]
    rec = SSLPins(pins)
    undo = rec.install()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    grads, after = [], []

    def keep(n, opts, generator, logger):
        grads.append({k: p.grad.detach().cpu() for k, p in
                      model.student.named_parameters() if p.grad is not None})
        snap = dict(state=_cpu_state(model), mu=first_moments(model, opts))
        after.append(snap)
        if n == DIST_ITERS:
            return
        if resume is None:
            snap["opts"] = [{k: [t.cpu() for t in v] if isinstance(v, list)
                             else v for k, v in o.state_dict().items()}
                            for o in opts]
            starts.append(snap["state"])
        else:
            model.load_state_dict(resume[n - 1]["state"])
            for o, state in zip(opts, resume[n - 1]["opts"]):
                o.load_state_dict(state)
            starts.append(resume[n - 1]["state"])

    try:
        _, opts, hist = train_ssl_batches(
            model, build_voxelizer(cfg), iter(batches), work_dir,
            max_iters=DIST_ITERS, lr_3d=DIST_LR[0], lr_2d=DIST_LR[1],
            warmup_iters=DIST_WARMUP, log_interval=1, seed=SEED,
            after_iter=keep)
    finally:
        undo()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    res = dict(hist=hist, launches=cuda_ops.launch_counts(),
               peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if DEVICE == "cuda" else None),
               grads=grads, after=after, starts=starts)
    return model, rec, res


@contextlib.contextmanager
def several_process_bn():
    """One process taking every batch norm's statistics by the formula of
    a process group (``layers.global_moments``: two-pass sums, where the
    BEV's batch norms are otherwise torch's own), over its own rows: the
    one-process runs that two processes are held to compute their
    statistics as the processes do."""
    from detmatch_tpu_torch.models import layers
    count = layers.process_count
    layers.process_count = lambda: 2  # no group: the sums stay local
    try:
        yield
    finally:
        layers.process_count = count


def first_moments(model, opts):
    """The student PV-RCNN's AdamW first moments by parameter name (its
    optimizer holds them in the order of ``parameters()``), on the
    CPU."""
    names = [n for n, _ in model.student["det3d"].named_parameters()]
    return dict(zip(names, (t.cpu() for t in
                            opts[0].state_dict()["mu"])))


def rel_l2(a, b):
    """The L2 norm of ``a - b`` over ``b``'s."""
    norm = float(b.double().norm())
    diff = float((a.double() - b.double()).norm())
    return diff / norm if norm else (0.0 if diff == 0 else float("inf"))


def step_err(a, b, a_start, b_start, keep=None):
    """The move of ``a`` from ``a_start`` against the move of ``b`` from
    ``b_start``, over the entries where ``keep`` (all if None): the L2
    norm of their difference over the norm of ``b``'s move (where ``b``
    did not move, ``a`` must not either). An entry's difference counts
    past one float32 spacing of ``b``'s value only: a move below the
    rounding of its weight is not measured."""
    ulp = (torch.nextafter(b, torch.full_like(b, float("inf"))) - b).double()
    da, db = a.double() - a_start.double(), b.double() - b_start.double()
    diff = ((da - db).abs() - ulp).clamp(min=0)
    if keep is not None:
        diff, db = diff[keep], db[keep]
    diff, norm = float(diff.norm()), float(db.norm())
    return diff / norm if norm else (0.0 if diff == 0 else float("inf"))


def adam_sure(mu):
    """The entries of an AdamW first moment farther than ADAM_SURE of its
    largest from zero: AdamW's first steps move a weight by about a whole
    step in the direction of that sign, so a weight whose moment is
    within float32's noise of zero may move either way in two runs that
    are both right."""
    return mu.abs() > ADAM_SURE * mu.abs().max()


def dist_diffs(res, ref, starts=None):
    """Every compared value of the run ``res`` against one process's
    ``ref``, per iteration, as rows (kind, where, largest absolute
    difference, the error that its gate reads, information): a logged
    value's relative difference; a gradient's and an AdamW first
    moment's :func:`rel_l2`, with its largest difference over its
    tensor's largest entry (:func:`rel_err`) beside it; the move of each
    floating-point state entry over the iteration against ``ref``'s
    (:func:`step_err`; "parameters", "running stats": the students';
    "EMA teacher": the teacher's, which follows the student's), from
    ``starts`` (default ``res["starts"]``) and ``ref["starts"]``, on the
    PV-RCNN's weights over the entries that :func:`adam_sure` keeps; a
    counter's number of differing entries. A value missing on one side,
    or not a number, has an infinite error."""
    inf = float("inf")
    starts = res["starts"] if starts is None else starts
    rows = []

    def number(kind, where, x, y):
        d = abs(x - y)
        d = inf if d != d else d
        rows.append((kind, where, d, d / max(abs(y), 1e-12),
                     d / max(abs(y), 1e-12)))

    for it, (a, b) in enumerate(zip(res["hist"], ref["hist"])):
        for k in sorted(a.keys() | b.keys()):
            number("logs", f"iter {it + 1} {k}", a.get(k, inf),
                   b.get(k, inf))
    for it, (a, b) in enumerate(zip(res["grads"], ref["grads"])):
        for n in sorted(a.keys() | b.keys()):
            if n in a and n in b:
                rows.append(("grads", f"iter {it + 1} {n}",
                             float((a[n] - b[n]).abs().max()),
                             rel_l2(a[n], b[n]), rel_err(a[n], b[n])))
            else:
                rows.append(("grads", f"iter {it + 1} {n} (one side)", inf,
                             inf, inf))
    for it, (a, b) in enumerate(zip(res["after"], ref["after"])):
        for n, y in b["mu"].items():
            x = a["mu"][n]
            rows.append(("moments", f"iter {it + 1} det3d.{n}",
                         float((x - y).abs().max()), rel_l2(x, y),
                         rel_err(x, y)))
        for k, v in b["state"].items():
            x = a["state"][k]
            if not v.is_floating_point():
                n = float((x != v).sum())
                rows.append(("counters", f"iter {it + 1} {k}", n, n, n))
                continue
            kind = ("EMA teacher" if k.startswith("teacher.") else
                    "running stats" if k.endswith(("running_mean",
                                                   "running_var"))
                    else "parameters")
            absd = float((x.double() - v.double()).abs().max()) \
                if v.numel() else 0.0
            mu = b["mu"].get(k.split(".det3d.", 1)[-1]) \
                if ".det3d." in k else None
            err = step_err(x, v, starts[it][k], ref["starts"][it][k],
                           None if mu is None else adam_sure(mu))
            rows.append((kind, f"iter {it + 1} {k}", absd, err, err))
    return rows


DIST_GATES = {"logs": DIST_LOG_RTOL, "grads": DIST_GRAD_RTOL,
              "moments": DIST_GRAD_RTOL, "running stats": DIST_STAT_RTOL,
              "parameters": DIST_STEP_RTOL, "EMA teacher": DIST_STEP_RTOL,
              "counters": 0.0}


def dist_verdict(rows):
    """Rows (:func:`dist_diffs`) under their kinds' DIST_GATES, per kind:
    (the largest error, the gate, where, how many exceed the gate, the
    five largest as (error, where), the largest absolute difference and
    where, the largest of the rows' last column and where)."""
    seen = {}
    for row in rows:
        seen.setdefault(row[0], []).append(row)
    out = {}
    for kind, rs in seen.items():
        gate = DIST_GATES[kind]
        rs.sort(key=lambda r: -r[3])
        big = max(rs, key=lambda r: r[2])
        last = max(rs, key=lambda r: r[4])
        out[kind] = (rs[0][3], gate, rs[0][1], sum(r[3] > gate for r in rs),
                     [(r[3], r[1]) for r in rs[:5]], (big[2], big[1]),
                     (last[4], last[1]))
    return out


def print_verdict(who, verdict):
    """The lines of :func:`dist_verdict`; True if every value passed."""
    ok = True
    for kind, (err, gate, where, n, top, big, last) in sorted(
            verdict.items()):
        ok &= n == 0
        line = (f"  {who}: {kind}: largest {err:.3e} ({where}), gate "
                f"{gate:.1e}, {n} past it {'ok' if n == 0 else 'FAIL'}; "
                f"largest absolute difference {big[0]:.3e} ({big[1]})")
        if kind in ("grads", "moments"):
            line += (f"; largest over its tensor's largest entry "
                     f"{last[0]:.3e} ({last[1]}, information)")
        print(line)
        if n:
            print("    " + "; ".join(f"{e:.2e} {w}" for e, w in top))
    return ok


def pins_share(own, pins):
    """Share of the pinned 3D pseudo-labels of this process's rows that
    its own teacher phase gave (box within 1e-3, scores within 1e-4)."""
    shares = [boxset_share(o["m3d_stu"], _rows(p["pseudo"]["m3d_stu"]))
              for o, p in zip(own, pins)]
    matched = sum(s * n for s, n in shares)
    total = sum(n for _, n in shares)
    return matched / max(total, 1), total


def dist_rank_main(rank, work):
    """One process of the two-process comparison, as :func:`dist_spawn`
    starts it: joins the gloo group on the card and runs
    :func:`dist_rank` on the SSL config."""
    from detmatch_tpu_torch import parallel
    from detmatch_tpu_torch.config import Config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel.start_group(f"file://{work}/store", DIST_WORLD, rank,
                         backend="gloo")
    dist_rank(Config.fromfile(str(SSL_CONFIG)), Path(work))
    parallel.shutdown()
    return 0


def dist_rank(cfg, work):
    """In a process of a started group: train on its rows of the global
    batches with the pins of ``work/pins.pt``, compare with the
    one-process results of ``work/ref.pt`` (:func:`dist_diffs`, from the
    one process's start), check its state bit for bit against process
    0's, time the flat gradient all-reduce of each student branch, and
    write ``work/rank<r>.json``."""
    from detmatch_tpu_torch import parallel
    rank = parallel.process_index()
    batches = [parallel.local_shard(b) for b in dist_batches(cfg)]
    pins = torch.load(work / "pins.pt", weights_only=False)
    ref = torch.load(work / "ref.pt", weights_only=False)
    # process 1 starts from other weights: broadcast_state makes them 0's
    model, rec, res = dist_ssl_run(cfg, batches, pins, work / "run",
                                   seed=SEED + rank, resume=ref["after"])
    rows = dist_diffs(res, ref, ref["starts"])
    del ref
    # bit-equal to process 0: its state broadcast, compared here
    state = list(model.state_dict().values())
    theirs = [t.clone() for t in state]
    parallel.broadcast_state(*(_Holder(t) for t in theirs))
    same = all(torch.equal(a, b) for a, b in zip(state, theirs))
    differs = parallel.global_sum(torch.tensor([float(not same)],
                                               device=DEVICE))
    reduce_ms = {}
    for k in ("det3d", "det2d"):
        grads = [torch.randn_like(p) for p in model.student[k].parameters()
                 if p.requires_grad]
        times = []
        for _ in range(4):
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            parallel.all_reduce_flat(grads)
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        reduce_ms[k] = dict(ms=float(np.median(times[1:])),
                            bytes=sum(4 * g.numel() for g in grads))
    share, total = pins_share(rec.own, pins)
    out = dict(rank=rank, rows=rows, launches=res["launches"],
               peak_gib=res["peak_gib"], bit_equal=float(differs) == 0.0,
               reduce=reduce_ms, own_share=share, own_total=total)
    (work / f"rank{rank}.json").write_text(json.dumps(out))


class _Holder(torch.nn.Module):
    """A tensor as a module's buffer, for ``parallel.broadcast_state``."""

    def __init__(self, t):
        super().__init__()
        self.register_buffer("t", t, persistent=False)


def dist_batches(cfg):
    """The DIST_ITERS global SSL batches (SSL_B + SSL_B frames), made
    from SEED: every process makes them all and keeps its rows."""
    rng = np.random.RandomState(SEED + 7)
    return [ssl_batch_np(cfg, rng) for _ in range(DIST_ITERS)]


def dist_reference(cfg, work, card):
    """One process on the global batches under :func:`several_process_bn`,
    recording the pins: writes ``work/pins.pt`` and ``work/ref.pt``
    (what :func:`dist_rank` reads) and returns the results, the pins and
    the students' trainable bytes per branch."""
    t0 = time.perf_counter()
    with several_process_bn():
        model, rec, ref = dist_ssl_run(cfg, dist_batches(cfg), None,
                                       work / "one")
    per_frame = [p["pseudo"]["m3d_stu"]["valid"].sum(1).tolist()
                 for p in rec.iters]
    last = ref["hist"][-1]
    print(f"  {DIST_ITERS} iterations in {time.perf_counter() - t0:.1f} s; "
          f"pinned 3D pseudo-labels per frame {per_frame}; last logs: loss "
          f"{last['loss']:.4f}, metrics.num_tea_hung "
          f"{last['metrics.num_tea_hung']:.3f}, metrics.num_2D_to_3D_hung "
          f"{last['metrics.num_2D_to_3D_hung']:.3f}; peak "
          f"{gib(ref['peak_gib'])} [{card}]")
    print(f"  launches: {ref['launches']}")
    pins = pins_to_save(rec)
    torch.save(pins, work / "pins.pt")
    torch.save(ref, work / "ref.pt")
    nbytes = {k: sum(4 * p.numel() for p in model.student[k].parameters()
                     if p.requires_grad) for k in ("det3d", "det2d")}
    del model, rec
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return ref, pins, nbytes


def dist_spawn(work, prelude=""):
    """Run :func:`dist_rank_main` in DIST_WORLD processes on ``work``
    (``prelude``: Python source each runs first); raises if one fails,
    else returns their ``rank<r>.json`` in rank order."""
    logs = [open(work / f"rank{r}.log", "w+") for r in range(DIST_WORLD)]
    code = ("import sys; sys.path.insert(0, {root!r}); import chip_smoke\n"
            "{prelude}\nsys.exit(chip_smoke.dist_rank_main({r}, {work!r}))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(root=str(ROOT), r=r,
                                           work=str(work), prelude=prelude)],
        stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT))
        for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            print(text[-6000:])
            raise AssertionError(f"data-parallel process {r} failed")
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(DIST_WORLD)]


def dist_phases(card):
    """Data-parallel training on the card (``parallel``): two processes
    over gloo on the one card against one process on the same global
    batches (pinned, each iteration from the one process's state), one
    process over NCCL against no process group, and NCCL's refusal of
    two processes on one card; the seconds of each part."""
    import copy

    from detmatch_tpu_torch import parallel
    from detmatch_tpu_torch.config import Config
    phase("data parallel: one process on the global batch (4 + 4, pinned)")
    cfg = Config.fromfile(str(SSL_CONFIG))
    split = {}
    with tempfile.TemporaryDirectory(prefix="dist_") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        ref, pins, nbytes = dist_reference(cfg, work, card)
        split["one process"] = time.perf_counter() - t0
        del ref
        ok = True

        phase(f"data parallel: {DIST_WORLD} processes over gloo on one card "
              f"({SSL_B // DIST_WORLD} + {SSL_B // DIST_WORLD} frames each)")
        t0 = time.perf_counter()
        outs = dist_spawn(work)
        split[f"{DIST_WORLD} processes (start, build, {DIST_ITERS} "
              "iterations, checks)"] = time.perf_counter() - t0
        for out in outs:
            r = out["rank"]
            ok &= print_verdict(f"process {r}", dist_verdict(out["rows"]))
            launched = all(out["launches"][n] > 0 for n in DIST_KERNELS)
            ok &= launched and out["bit_equal"]
            print(f"  process {r}: state bit-equal to process 0 "
                  f"{out['bit_equal']}; launches {out['launches']} "
                  f"(K1 fwd / bwd, K2, K3, K4 each > 0: {launched}); peak "
                  f"{gib(out['peak_gib'])} [{card}]")
            print(f"  process {r}: its own teacher phase gave "
                  f"{out['own_share']:.4f} of {out['own_total']} pinned 3D "
                  "pseudo-labels (information: batch-size noise under NMS)")
            for k, v in out["reduce"].items():
                print(f"  process {r}: flat gradient all-reduce {k}: "
                      f"{v['bytes']} bytes in {v['ms']:.3f} ms (gloo staged "
                      f"through the host, no guide to NCCL over NVLink) "
                      f"[{card}]")
        total = sum(nbytes.values())
        print(f"  gradient bytes all-reduced an iteration: {total} "
              f"({total / 2 ** 20:.1f} MiB: PV-RCNN {nbytes['det3d']}, "
              f"Faster R-CNN {nbytes['det2d']})")
        if not ok:
            raise AssertionError("two processes differ from one process on "
                                 "the same global batch, from each other, "
                                 "or left a kernel unlaunched")

        phase("data parallel: one process over NCCL against no group; "
              "NCCL's refusal of two processes on one card")
        t0 = time.perf_counter()
        # the refusal's two processes run beside the NCCL process's runs
        code = ("import sys; sys.path.insert(0, {root!r}); "
                "from detmatch_tpu_torch import parallel; "
                "parallel.start_group('file://{work}/nccl_store', 2, {r}, "
                "backend='nccl')")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code.format(root=str(ROOT),
                                               work=str(work), r=r)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(ROOT)) for r in range(2)]
        from detmatch_tpu_torch.apis.build import build_voxelizer
        from detmatch_tpu_torch.apis.train_ssl import train_ssl_batches
        batch = dist_batches(cfg)[:1]
        base = ssl_model(cfg)
        start = _cpu_state(base)

        def one_iteration(nccl):
            if nccl:
                parallel.start_group(f"tcp://localhost:{_free_port()}", 1, 0,
                                     backend="nccl")
            m = copy.deepcopy(base)
            undo = SSLPins(pins[:1]).install()
            try:
                _, opts, hist = train_ssl_batches(
                    m, build_voxelizer(cfg), iter(batch), str(work / "b"),
                    max_iters=1, lr_3d=DIST_LR[0], lr_2d=DIST_LR[1],
                    warmup_iters=DIST_WARMUP, log_interval=1, seed=SEED)
            finally:
                undo()
            params = [p.detach().clone() for p in m.student.parameters()]
            flat = parallel.all_reduce_flat(params)
            run = dict(
                hist=hist, starts=[start], after=[dict(
                    state=_cpu_state(m), mu=first_moments(m, opts))],
                grads=[{n: p.grad.detach().cpu() for n, p in
                        m.student.named_parameters() if p.grad is not None}],
                flat=all(torch.equal(a, b) for a, b in zip(flat, params)),
                backend=torch.distributed.get_backend() if nccl else None)
            if nccl:
                parallel.shutdown()
            return run

        def bit_equal(a, b):
            return (a["hist"] == b["hist"] and all(
                torch.equal(x[n], y[n]) for x, y in (
                    (a["grads"][0], b["grads"][0]),
                    (a["after"][0]["state"], b["after"][0]["state"]))
                for n in y))

        torch.use_deterministic_algorithms(True, warn_only=True)
        # no NaN fill of new buffers: the runs stay the ordinary ones
        fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            none, nccl = one_iteration(False), one_iteration(True)
            same = bit_equal(nccl, none)
            # no group against itself only where the NCCL run differs
            reproducible = None if same else bit_equal(
                one_iteration(False), none)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill
        del base
        worst = dist_verdict(dist_diffs(nccl, none))
        print(f"  backend {nccl['backend']}, world 1: the flat all-reduce "
              f"returns its input bit for bit {nccl['flat']}; the iteration "
              f"(logs, gradients, state) bit-equal to no group {same}"
              + ("" if same else f"; no group twice bit-equal "
                 f"{reproducible}; largest error " + ", ".join(
                     f"{k} {w[0]:.3e}" for k, w in worst.items())))
        ok = nccl["flat"] and nccl["backend"] == "nccl" and (same or (
            not reproducible and all(w[3] == 0 for w in worst.values())))
        outs = [p.communicate(timeout=300)[0] for p in procs]
        refused = all(p.returncode != 0 and "share a CUDA device" in o
                      for p, o in zip(procs, outs))
        print(f"  two processes on {torch.cuda.device_count()} card(s) with "
              f"nccl: both refused with the message {refused}")
        split["one NCCL process against no group (2 runs, 3 if they "
              "differ), beside the refusal"] = time.perf_counter() - t0
        print("  the phase's seconds: " + "; ".join(
            f"{k} {v:.1f}" for k, v in split.items()))
        if not ok:
            raise AssertionError("one NCCL process differs from no process "
                                 "group")
        if not refused:
            print("\n".join(o[-2000:] for o in outs))
            raise AssertionError("NCCL took two processes on one card")


# ------------------------------------------------------------ studies

# the short learning study: a few dozen iterations an arm (inside the
# warm-up of max(50, iters // 10), so no "loss falls" gate), a few
# recalibration passes, the three evaluations on the 8 val frames
STUDY_ITERS = 24
STUDY_RECAL = 4
STUDY_ARMS = ("labonly", "ssl")
NOISE_WORLD = 2


def study_phases(card):
    """The two study tools of ``tools/misc`` at a small size: the
    learning study's both arms for STUDY_ITERS iterations (window path),
    its recalibration and its three evaluations on a fresh tree, then a
    rerun on the same tree; the data-parallel noise study at the tiny
    width over NOISE_WORLD gloo processes on the card."""
    from detmatch_tpu_torch.tools.misc import dp_noise_study
    from detmatch_tpu_torch.tools.misc import learning_study as ls
    from detmatch_tpu_torch.train import checkpoints
    phase(f"learning study, short: both arms for {STUDY_ITERS} iterations, "
          f"{STUDY_RECAL} recalibration passes, three evaluations on the "
          f"8 val frames, on {card}")
    with tempfile.TemporaryDirectory(prefix="study_") as tmp:
        root = tmp + "/"
        t0 = time.perf_counter()
        report, _ = ls.run_study(root, STUDY_ITERS, DEVICE, keep=True,
                                 recal_passes=STUDY_RECAL)
        first_s = time.perf_counter() - t0
        run = report["run"]
        losses = [x for arm in STUDY_ARMS
                  for _, x in report[f"curve_{arm}"]]
        finite = (len(losses) == len(STUDY_ARMS) * STUDY_ITERS
                  and bool(np.isfinite(losses).all()))
        aps = {f"{k}.{m}": v for k in ("ap_init", "ap_labonly", "ap_ssl")
               for m, v in report[k].items() if "mAP" in m}
        aps_ok = all(np.isfinite(v) and 0.0 <= v <= 100.0
                     for v in aps.values())
        launched = {arm: all(run[arm]["launches"][n] > 0
                             for n in ls.STUDY_KERNELS)
                    for arm in STUDY_ARMS}
        for arm in STUDY_ARMS:
            r = run[arm]
            print(f"  {arm}: {r['iterations_run']} iterations, "
                  f"{r['ms_per_iter_median']:.3f} ms an iteration (median "
                  f"of the logged ones after the first), training "
                  f"{r['train_s']:.1f} s, recalibration {r['recal_s']:.1f} "
                  f"s, evaluation {r['eval_s']:.1f} s, peak "
                  f"{gib(r['peak_gib'])}; launches {r['launches']} [{card}]")
        print(f"  every logged loss finite ({len(losses)}): {finite}; "
              f"run A's first / last quartile {report['loss_first_quartile']:.4f}"
              f" / {report['loss_last_quartile']:.4f} (information: the "
              "warm-up covers these iterations)")
        print(f"  every AP finite and in [0, 100] ({len(aps)}): {aps_ok}; 3D "
              f"mAP moderate {run['map_3d_moderate']}; num_dets "
              f"{run['num_dets']}; the check {run['learning_check']} "
              "(information at this length)")
        print(f"  K1 fwd, K1 bwd, K2, K3, K4 launched in each arm: {launched}")

        phase("learning study, short: the rerun on the same tree")
        t0 = time.perf_counter()
        again, _ = ls.run_study(root, STUDY_ITERS, DEVICE, keep=True,
                                recal_passes=STUDY_RECAL)
        second_s = time.perf_counter() - t0
        steps = {arm: checkpoints.latest_step(os.path.join(
            root, f"run_{arm}", "ckpt")) for arm in STUDY_ARMS}
        resumed = all(steps[a] == STUDY_ITERS
                      and again["run"][a]["iterations_run"] == 0
                      for a in STUDY_ARMS)
        cached = all(again[k] == report[k] for k in (
            "ap_init", "ap_labonly", "ap_ssl", "curve_labonly", "curve_ssl"))
        print(f"  restored at {steps} (max_iters {STUDY_ITERS}), no "
              f"iteration trained: {resumed}; the three evaluations "
              f"returned from evals.json unchanged: {cached}")
        print(f"  the study {first_s:.1f} s, its rerun {second_s:.1f} s "
              f"[{card}]")
    if not (finite and aps_ok and all(launched.values()) and resumed
            and cached):
        raise AssertionError("the short learning study failed a gate")

    phase(f"data-parallel noise study: the tiny PV-RCNN on 8 frames, one "
          f"process, {NOISE_WORLD} processes over gloo on one card, float64 "
          f"on the plain paths, on {card}")
    t0 = time.perf_counter()
    res = dp_noise_study.study(None, 8, 128, NOISE_WORLD, DEVICE,
                               log=lambda line: print("  " + line))
    eq = all(res["discrete_equal"].values())
    print(f"  discrete outputs equal ({len(res['discrete_equal'])}): {eq}; "
          f"every leaf within {dp_noise_study.ATOL:g} + "
          f"{dp_noise_study.RTOL:g} * max|leaf|: "
          f"{res['gN_within_jax_tolerance']}; g64 in float64: "
          f"{res['g64_float64']}; the largest L2 over the norm: g1 against "
          f"g{NOISE_WORLD} {res['max_l2_g1_gN']:.3e}, against g64 "
          f"{res['max_l2_g1_g64']:.3e}; {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    if not (eq and res["gN_within_jax_tolerance"] and res["g64_float64"]):
        raise AssertionError("the noise study's processes differ from one "
                             "process past JAX's tolerance")


IMPORT_B = 1  # frames of the import phase's detect and teacher phase


def import_phases(card):
    """The checkpoint importer (``tools/model_converters/
    import_torch_ckpt.py``): a seeded PV-RCNN and Faster R-CNN at
    ``split_0.py``'s widths saved as pcdet and mmdet save them (pcdet's
    ``model_state`` with ``global_step`` beside ``optimizer_state``,
    ``epoch``, ``it`` and ``version``; mmdet's ``state_dict`` with every
    batch norm's ``num_batches_tracked`` beside ``meta`` and
    ``optimizer``), each imported by the tool and loaded through
    ``train_ssl``'s ``load_from`` into an ``SSLDetector`` on the card:
    its student and teacher equal the sources bit for bit; one ``detect``
    frame of the student and one teacher phase equal the source models'
    exactly, with K1 fwd, K2, K3 and K4 launched; seconds printed."""
    from detmatch_tpu_torch.apis.build import (build_detector, build_ssl,
                                               build_voxelizer)
    from detmatch_tpu_torch.apis.inference import detect
    from detmatch_tpu_torch.apis.train_ssl import train_ssl
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.tools.model_converters import (
        import_torch_ckpt as imp)
    from detmatch_tpu_torch.train import checkpoints
    from detmatch_tpu_torch.train.ssl_step import (to_device_views,
                                                   voxelize_views)
    from detmatch_tpu_torch.utils.synth_kitti import ssl_view

    phase("import: pcdet and mmdet checkpoints through import_torch_ckpt "
          "and load_from")
    t_all = time.perf_counter()
    cfg = Config.fromfile(str(SSL_CONFIG))
    spec = build_voxelizer(cfg)
    src = {}
    for det, key, seed in (("det3d", "detector_3d", SEED + 11),
                           ("det2d", "detector_2d", SEED + 12)):
        src[det] = build_detector(cfg, device=DEVICE, key=key)
        randomize_(src[det], seed)
    sd3 = {k: v.cpu() for k, v in src["det3d"].state_dict().items()}
    sd2 = {k: v.cpu() for k, v in src["det2d"].state_dict().items()}
    bn2 = {k.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(0)
           for k in sd2 if k.startswith("backbone") and
           k.endswith("running_mean")}
    with tempfile.TemporaryDirectory(prefix="import_ckpt_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        torch.save(dict(epoch=80, it=7400, version="pcdet+0.3.0+0000000",
                        model_state=dict(sd3, global_step=torch.tensor(
                            [7400])),
                        optimizer_state=dict(state={}, param_groups=[])),
                   tmp / "pv_rcnn.pth")
        torch.save(dict(meta=dict(mmdet_version="2.14.0", epoch=12,
                                  CLASSES=("Car", "Pedestrian", "Cyclist")),
                        state_dict=dict(sd2, **bn2),
                        optimizer=dict(state={}, param_groups=[])),
                   tmp / "faster_rcnn_r50.pth")
        save_s = time.perf_counter() - t0
        out, times = {}, {}
        for det, kind, name in (("det3d", "pvrcnn", "pv_rcnn.pth"),
                                ("det2d", "frcnn", "faster_rcnn_r50.pth")):
            out[det] = str(tmp / f"imported_{kind}")
            t0 = time.perf_counter()
            _, dropped = imp.import_checkpoint(
                kind, str(tmp / name), out[det], str(SSL_CONFIG),
                log=lambda m: None)
            times[kind] = time.perf_counter() - t0
            print(f"  {kind}: dropped {len(dropped)} keys "
                  f"({', '.join(dropped[:2])}, ...)")
            want = {"global_step"} if kind == "pvrcnn" else set(bn2)
            if set(dropped) != want:
                raise AssertionError(f"{kind}: dropped {dropped}")
        t0 = time.perf_counter()
        ssl = build_ssl(cfg)  # the card
        ssl, _, hist = train_ssl(ssl, spec, [0], [0], lambda s: s,
                                 str(tmp / "ssl"), 0, batch_size=1,
                                 load_from=out)
        load_s = time.perf_counter() - t0
        ssl.eval()  # train_ssl leaves the student in train mode
        if hist:
            raise AssertionError("train_ssl ran an iteration")
        for det, want in (("det3d", sd3), ("det2d", sd2)):
            stored = checkpoints.restore_latest(out[det])[0]["model"]
            for half in ("student", "teacher"):
                got = getattr(ssl, half)[det].state_dict()
                if got.keys() != want.keys() or stored.keys() != want.keys():
                    raise AssertionError(f"{half}.{det}: other keys")
                bad = [k for k in want
                       if not torch.equal(got[k].cpu(), want[k])
                       or not torch.equal(stored[k], want[k])]
                if bad:
                    raise AssertionError(f"{half}.{det} differs: {bad[:4]}")
    print(f"  import: pvrcnn {times['pvrcnn']:.2f} s, frcnn "
          f"{times['frcnn']:.2f} s (writing the two .pth {save_s:.2f} s); "
          f"load_from into the SSL detector {load_s:.2f} s; student and "
          "teacher equal to the sources bit for bit")

    phase("import: detect and the teacher phase against the source models")
    ref = build_ssl(cfg)
    for half in (ref.student, ref.teacher):
        half["det3d"].load_state_dict(src["det3d"].state_dict())
        half["det2d"].load_state_dict(src["det2d"].state_dict())
    frame = make_batch(spec, IMPORT_B)
    rng = np.random.RandomState(SEED + 13)
    canvas = tuple(cfg["model"]["detector_2d"]["canvas"])
    points = cfg["data"]["collate"]["max_points"]
    views = voxelize_views(to_device_views(dict(unlab=dict(
        tea=ssl_view(rng, IMPORT_B, points, canvas),
        stu=ssl_view(rng, IMPORT_B, points, canvas))), DEVICE), spec)
    for view in views["unlab"].values():
        view["aug3d"], view["aug2d"] = aug_records(
            rng, IMPORT_B, canvas, view["ori_shape"][0].tolist())
    res = {}
    for name, det, m in (("imported", ssl.student["det3d"], ssl),
                         ("source", src["det3d"], ref)):
        with torch.inference_mode():
            cuda_ops.reset_launch_counts()
            t0 = time.perf_counter()
            d = detect(det, frame["points"], frame["points_valid"], spec,
                       score_thresh=0.0)
            pseudo = m.teacher_pseudo_labels(views)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = cuda_ops.launch_counts()
        res[name] = (d, pseudo)
        print(f"  {name}: detect + teacher phase {secs:.3f} s; launches "
              f"{ {k: v for k, v in launches.items() if v} } [{card}]")
        if not all(launches[n] > 0 for n in TEACHER_KERNELS):
            raise AssertionError(f"{name}: a kernel of {TEACHER_KERNELS} "
                                 "was not launched")
    (d_i, p_i), (d_s, p_s) = res["imported"], res["source"]
    pairs = [(f"detect.{k}", d_i[k], d_s[k]) for k in d_s
             if isinstance(d_s[k], torch.Tensor)]
    pairs += [(f"{s}.{k}", p_i[s][k], p_s[s][k])
              for s in ("m3d_stu", "m2d_stu", "m2d_clean") for k in p_s[s]]
    pairs.append(("num_tea_hung", p_i["logs"]["metrics.num_tea_hung"],
                  p_s["logs"]["metrics.num_tea_hung"]))
    bad = [n for n, a, b in pairs if not torch.equal(a, b)]
    n3d = d_i["valid"].sum(1).tolist()
    finite = all(bool(torch.isfinite(a).all()) for _, a, _ in pairs
                 if a.is_floating_point())
    print(f"  {len(pairs) - len(bad)} of {len(pairs)} outputs equal exactly "
          f"(detections a frame {n3d}, finite={finite}); phase "
          f"{time.perf_counter() - t_all:.1f} s [{card}]")
    if bad or not finite or min(n3d) == 0:
        raise AssertionError(f"the imported models differ from the sources "
                             f"on {bad[:6]} or give no finite detections")
    del ssl, ref, src


def gib(x):
    return "not measured" if x is None else f"{x:.2f} GiB"


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    try:
        run()
    except Exception:  # report the failing phase, never the result line
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
