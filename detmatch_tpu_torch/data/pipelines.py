"""Data pipeline transforms (host-side numpy, results-dict idiom;
counterpart of ``detmatch_tpu/data/pipelines.py``, equal to it sample for
sample under equal ``RandomState``s).

Mirrors the reference pipeline set used by the DetMatch configs
(``mmdet3d/datasets/pipelines/{loading,transforms_3d,torchvision_transforms,
formating}.py``; config ``split_0.py:556-728``): point/image/annotation
loading, GT-database ObjectSample, Resize (range mode, keep-ratio),
RandomFlip3D (synced 2D+3D), GlobalRotScaleTrans (recorded for SSL
replay/reversal), range filters, PointShuffle, UBTeacher photometric augs,
Normalize (caffe BGR), Pad.

Augmentations are RECORDED in the results dict (aug3d / aug2d records,
:mod:`detmatch_tpu_torch.core.transforms`) so the SSL modules can replay
or reverse them on the device — the reference's ``transformation_3d_flow`` /
img_metas mechanism.
"""
from __future__ import annotations

import copy

import numpy as np

from . import np_geometry as geometry


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


class LoadPoints:
    """LoadPointsFromFile (``loading.py:333``)."""

    def __init__(self, load_dim=4, use_dim=4):
        self.load_dim = load_dim
        self.use_dim = use_dim

    def __call__(self, results):
        pts = np.fromfile(results["pts_filename"], np.float32)
        pts = pts.reshape(-1, self.load_dim)[:, :self.use_dim]
        results["points"] = pts
        return results


class LoadImage:
    """LoadImageFromFile — BGR uint8→float32 (caffe convention)."""

    def __call__(self, results):
        from PIL import Image
        with Image.open(results["img_filename"]) as im:
            img = np.asarray(im.convert("RGB"), np.float32)
        results["img"] = img[:, :, ::-1].copy()  # RGB → BGR
        results["img_shape"] = np.array(img.shape[:2], np.int32)
        return results


class Resize:
    """Random-range keep-ratio resize (mmdet Resize, multiscale_mode='range',
    config ``split_0.py:571-575``: scales (640,192)-(2560,768))."""

    def __init__(self, img_scale=((640, 192), (2560, 768)), keep_ratio=True,
                 rng=None):
        self.scales = img_scale
        self.rng = rng or np.random

    def __call__(self, results):
        (w0, h0), (w1, h1) = self.scales
        long_edge = self.rng.randint(min(w0, w1), max(w0, w1) + 1)
        short_edge = self.rng.randint(min(h0, h1), max(h0, h1) + 1)
        h, w = results["img"].shape[:2]
        scale = min(long_edge / max(h, w), short_edge / min(h, w))
        new_w, new_h = int(w * scale + 0.5), int(h * scale + 0.5)
        import cv2
        results["img"] = cv2.resize(results["img"], (new_w, new_h),
                                    interpolation=cv2.INTER_LINEAR)
        w_scale = new_w / w
        h_scale = new_h / h
        results["img_shape"] = np.array([new_h, new_w], np.int32)
        results["scale_factor"] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        if "gt_bboxes" in results:
            results["gt_bboxes"] = (results["gt_bboxes"]
                                    * results["scale_factor"][None])
        return results


class RandomFlip3D:
    """Synced 2D horizontal + 3D BEV-horizontal flip
    (``transforms_3d.py:59``)."""

    def __init__(self, flip_ratio=0.5, rng=None):
        self.flip_ratio = flip_ratio
        self.rng = rng or np.random

    def __call__(self, results):
        flip = self.rng.rand() < self.flip_ratio
        results["flip"] = flip
        if flip:
            results["img"] = results["img"][:, ::-1].copy()
            h, w = results["img"].shape[:2]
            if "gt_bboxes" in results and len(results["gt_bboxes"]):
                b = results["gt_bboxes"].copy()
                b[:, [0, 2]] = w - results["gt_bboxes"][:, [2, 0]]
                results["gt_bboxes"] = b
            results["points"] = np.asarray(
                geometry.flip_points(results["points"], axis="x"))
            if "gt_bboxes_3d" in results and len(results["gt_bboxes_3d"]):
                results["gt_bboxes_3d"] = np.asarray(
                    geometry.flip_boxes(results["gt_bboxes_3d"], axis="x"))
        return results


class GlobalRotScaleTrans:
    """Recorded global rotation / scaling / translation
    (``transforms_3d.py:520``)."""

    def __init__(self, rot_range=(-0.78539816, 0.78539816),
                 scale_ratio_range=(0.95, 1.05),
                 translation_std=(0.0, 0.0, 0.0), rng=None):
        self.rot_range = rot_range
        self.scale_range = scale_ratio_range
        self.trans_std = np.asarray(translation_std, np.float32)
        self.rng = rng or np.random

    def __call__(self, results):
        rot = self.rng.uniform(*self.rot_range)
        scale = self.rng.uniform(*self.scale_range)
        trans = (self.rng.randn(3) * self.trans_std).astype(np.float32)
        results["pcd_rotation"] = np.float32(rot)
        results["pcd_scale_factor"] = np.float32(scale)
        results["pcd_trans"] = trans
        pts = results["points"]
        xyz = np.asarray(geometry.rotate_points_z(pts[:, :3],
                                                  np.float32(rot)))
        xyz = xyz * scale + trans[None]
        results["points"] = np.concatenate([xyz, pts[:, 3:]], axis=1)
        if "gt_bboxes_3d" in results and len(results["gt_bboxes_3d"]):
            b = results["gt_bboxes_3d"]
            center = np.asarray(geometry.rotate_points_z(
                b[:, :3], np.float32(rot))) * scale + trans[None]
            heading = b[:, 6:7] + rot
            results["gt_bboxes_3d"] = np.concatenate(
                [center, b[:, 3:6] * scale, heading], axis=1
            ).astype(np.float32)
        return results


class ObjectNoise:
    """Per-object noise: independent translation + yaw perturbation of
    each GT box (and the points inside it), first-non-colliding candidate
    kept (reference ``transforms_3d.py:368`` →
    ``data_augment_utils.noise_per_object_v3_``).

    Not used by any DetMatch config, but part of the reference's pipeline
    surface. Global scene rotation (``global_rot_range``) is only
    supported at its DetMatch-default disabled value [0, 0].
    """

    def __init__(self, translation_std=(0.25, 0.25, 0.25),
                 global_rot_range=(0.0, 0.0),
                 rot_range=(-0.15707963267, 0.15707963267),
                 num_try=100, rng=None):
        assert abs(global_rot_range[0] - global_rot_range[1]) < 1e-3, \
            "global rotation noise is not supported (disabled in every " \
            "reference config)"
        self.trans_std = np.asarray(translation_std, np.float32)
        self.rot_range = rot_range
        self.num_try = num_try
        self.rng = rng or np.random

    def __call__(self, results):
        boxes = results.get("gt_bboxes_3d")
        if boxes is None or not len(boxes):
            return results
        from .dbsampler import _bev_corners, _boxes_collide
        boxes = boxes.copy()
        pts = results["points"].copy()
        n = len(boxes)
        loc_noises = (self.rng.randn(n, self.num_try, 3)
                      * self.trans_std[None, None]).astype(np.float32)
        rot_noises = self.rng.uniform(
            self.rot_range[0], self.rot_range[1],
            size=(n, self.num_try)).astype(np.float32)
        in_box = np.asarray(geometry.points_in_boxes(
            pts[:, :3], boxes))  # (n_boxes, n_pts) bool, box-major
        # sequential greedy, like noise_per_object_v3_: each box takes the
        # first candidate that doesn't collide with the current scene
        for i in range(n):
            others = np.concatenate([boxes[:i], boxes[i + 1:]], axis=0)
            other_c = _bev_corners(others) if len(others) else None
            for j in range(self.num_try):
                cand = boxes[i].copy()
                cand[:3] += loc_noises[i, j]
                cand[6] += rot_noises[i, j]
                if other_c is not None and len(other_c):
                    if _boxes_collide(_bev_corners(cand[None]),
                                      other_c).any():
                        continue
                # accept: move the box and its interior points
                sel = in_box[i]
                if sel.any():
                    local = pts[sel, :3] - boxes[i, :3][None]
                    local = np.asarray(geometry.rotate_points_z(
                        local, np.float32(rot_noises[i, j])))
                    pts[sel, :3] = local + cand[:3][None]
                boxes[i] = cand
                break
        results["gt_bboxes_3d"] = boxes
        results["points"] = pts
        return results


class PointsRangeFilter:
    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, results):
        pts = results["points"]
        mask = np.asarray(geometry.mask_points_by_range(pts, self.pcr))
        results["points"] = pts[mask]
        return results


class ObjectRangeFilter:
    """Drop gt boxes whose BEV center is outside the range; heading wrapped
    (``transforms_3d.py:727``)."""

    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, results):
        if "gt_bboxes_3d" not in results or not len(results["gt_bboxes_3d"]):
            return results
        b = results["gt_bboxes_3d"]
        mask = np.asarray(geometry.in_range_bev(b, self.pcr))
        b = b[mask]
        b[:, 6] = np.asarray(geometry.limit_period(
            b[:, 6], offset=0.5, period=2 * np.pi))
        results["gt_bboxes_3d"] = b
        results["gt_labels_3d"] = results["gt_labels_3d"][mask]
        return results


class PointShuffle:
    def __init__(self, rng=None):
        self.rng = rng or np.random

    def __call__(self, results):
        perm = self.rng.permutation(len(results["points"]))
        results["points"] = results["points"][perm]
        return results


class Normalize:
    """Caffe image normalization (``split_0.py:551-553``: BGR mean
    subtraction, std 1)."""

    def __init__(self, mean=(103.530, 116.280, 123.675), std=(1., 1., 1.)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, results):
        results["img"] = (results["img"] - self.mean) / self.std
        return results


class PadToCanvas:
    """Pad image to a fixed (H, W) canvas (static-shape requirement; the
    reference pads to size_divisor=32 with dynamic shapes)."""

    def __init__(self, canvas=(384, 1280)):
        self.canvas = canvas

    def __call__(self, results):
        h, w = results["img"].shape[:2]
        ch, cw = self.canvas
        if h > ch or w > cw:
            # downscale content to fit (keeps aspect)
            import cv2
            s = min(ch / h, cw / w)
            nh, nw = int(h * s), int(w * s)
            results["img"] = cv2.resize(results["img"], (nw, nh))
            extra = np.array([nw / w, nh / h, nw / w, nh / h], np.float32)
            results["scale_factor"] = results.get(
                "scale_factor", np.ones(4, np.float32)) * extra
            if "gt_bboxes" in results and len(results["gt_bboxes"]):
                results["gt_bboxes"] = results["gt_bboxes"] * extra[None]
            results["img_shape"] = np.array([nh, nw], np.int32)
            h, w = nh, nw
        img = np.zeros((ch, cw, 3), np.float32)
        img[:h, :w] = results["img"]
        results["img"] = img
        return results


# ---------------------------------------------------------------------------
# UBTeacher-style photometric augs (reference torchvision_transforms.py —
# reimplemented in numpy/cv2, applied with probabilities per config
# split_0.py:586-626)
# ---------------------------------------------------------------------------

class PhotoMetricAugs:
    """ColorJitter(0.8) + RandomGrayscale(0.2) + GaussianBlur(0.5) +
    3x RandomErasing. Operates on the BGR float image BEFORE Normalize."""

    def __init__(self, jitter_p=0.8, brightness=0.4, contrast=0.4,
                 saturation=0.4, hue=0.1, grayscale_p=0.2, blur_p=0.5,
                 sigma=(0.1, 2.0),
                 erase=((0.7, (0.05, 0.2), (0.3, 3.3)),
                        (0.5, (0.02, 0.2), (0.1, 6.0)),
                        (0.3, (0.02, 0.2), (0.05, 8.0))),
                 rng=None):
        self.jitter_p = jitter_p
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue
        self.grayscale_p = grayscale_p
        self.blur_p = blur_p
        self.sigma = sigma
        self.erase = erase
        self.rng = rng or np.random

    def __call__(self, results):
        import cv2
        img = results["img"]  # BGR float [0,255]
        r = self.rng
        if r.rand() < self.jitter_p:
            img = img * r.uniform(1 - self.b, 1 + self.b)  # brightness
            mean = img.mean()
            img = (img - mean) * r.uniform(1 - self.c, 1 + self.c) + mean
            gray = img.mean(axis=2, keepdims=True)
            img = (img - gray) * r.uniform(1 - self.s, 1 + self.s) + gray
            if self.h > 0:
                hsv = cv2.cvtColor(
                    np.clip(img, 0, 255).astype(np.uint8),
                    cv2.COLOR_BGR2HSV).astype(np.float32)
                hsv[..., 0] = (hsv[..., 0]
                               + r.uniform(-self.h, self.h) * 180) % 180
                img = cv2.cvtColor(hsv.astype(np.uint8),
                                   cv2.COLOR_HSV2BGR).astype(np.float32)
        if r.rand() < self.grayscale_p:
            g = img.mean(axis=2, keepdims=True)
            img = np.repeat(g, 3, axis=2)
        if r.rand() < self.blur_p:
            sigma = r.uniform(*self.sigma)
            img = cv2.GaussianBlur(img, (0, 0), sigma)
        h, w = img.shape[:2]
        for p, scale, ratio in self.erase:
            if r.rand() < p:
                area = r.uniform(*scale) * h * w
                ar = np.exp(r.uniform(np.log(ratio[0]), np.log(ratio[1])))
                eh = int(np.sqrt(area / ar))
                ew = int(np.sqrt(area * ar))
                if eh < h and ew < w and eh > 0 and ew > 0:
                    y = r.randint(0, h - eh)
                    x = r.randint(0, w - ew)
                    img[y:y + eh, x:x + ew] = r.uniform(
                        0, 255, (eh, ew, 3))
        results["img"] = np.clip(img, 0, 255).astype(np.float32)
        return results


class MultiScaleFlipAug3D:
    """Test-time augmentation fan-out (reference
    ``datasets/pipelines/test_time_aug.py:10-119``): applies the wrapped
    transforms once per (img_scale x pts_scale x flip x pcd flips)
    combination and returns a LIST of results dicts. The DetMatch test
    pipeline uses a single scale and no flips, in which case this is a
    one-element wrapper.
    """

    def __init__(self, transforms, img_scale=(1280, 384),
                 pts_scale_ratio=1.0, flip=False,
                 flip_direction="horizontal", pcd_horizontal_flip=False,
                 pcd_vertical_flip=False):
        self.transforms = Compose(transforms)
        self.img_scales = (img_scale if isinstance(img_scale, list)
                           else [img_scale])
        self.pts_scale_ratios = (
            pts_scale_ratio if isinstance(pts_scale_ratio, list)
            else [float(pts_scale_ratio)])
        self.flip = flip
        self.flip_directions = (flip_direction
                                if isinstance(flip_direction, list)
                                else [flip_direction])
        self.pcd_horizontal_flip = pcd_horizontal_flip
        self.pcd_vertical_flip = pcd_vertical_flip

    def __call__(self, results):
        outs = []
        flip_args = [(False, False)]
        if self.flip:
            if self.pcd_horizontal_flip:
                flip_args.append((True, False))
            if self.pcd_vertical_flip:
                flip_args.append((False, True))
            if self.pcd_horizontal_flip and self.pcd_vertical_flip:
                flip_args.append((True, True))
        for scale in self.img_scales:
            for ratio in self.pts_scale_ratios:
                for hflip, vflip in flip_args:
                    r = copy.deepcopy(results)
                    r["tta_img_scale"] = scale
                    if ratio != 1.0:
                        pts = r["points"]
                        r["points"] = np.concatenate(
                            [pts[:, :3] * ratio, pts[:, 3:]], axis=1)
                    if hflip:
                        r["points"] = np.asarray(
                            geometry.flip_points(r["points"], axis="x"))
                    if vflip:
                        r["points"] = np.asarray(
                            geometry.flip_points(r["points"], axis="y"))
                    r["pcd_horizontal_flip"] = hflip
                    r["pcd_vertical_flip"] = vflip
                    r["pcd_scale_factor"] = np.float32(ratio)
                    out = self.transforms(r)
                    if out is not None:
                        outs.append(out)
        return outs


def build_aug_records(results):
    """Extract the recorded augs into batched-friendly numpy records."""
    rec3d = dict(
        flip_x=np.float32(1.0 if results.get("flip", False) else 0.0),
        rot=np.float32(results.get("pcd_rotation", 0.0)),
        scale=np.float32(results.get("pcd_scale_factor", 1.0)),
        trans=np.asarray(results.get("pcd_trans", np.zeros(3)), np.float32),
    )
    rec2d = dict(
        scale=np.asarray(results.get("scale_factor",
                                     np.ones(4)), np.float32),
        flip=np.float32(1.0 if results.get("flip", False) else 0.0),
        img_w=np.float32(results["img_shape"][1]),
    )
    return rec3d, rec2d


class TSDataset:
    """Teacher/student SSL dataset (reference
    ``teacher_student_ssl_dataset.py:12-35``): run the shared pipeline once,
    deepcopy, then separate student/teacher pipelines."""

    def __init__(self, dataset, shared_pipeline, student_pipeline,
                 teacher_pipeline):
        self.dataset = dataset
        self.shared = Compose(shared_pipeline)
        self.student = Compose(student_pipeline)
        self.teacher = Compose(teacher_pipeline)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        base = self.shared(self.dataset[index])
        stu = self.student(copy.deepcopy(base))
        tea = self.teacher(copy.deepcopy(base))
        return dict(stu=stu, tea=tea)
