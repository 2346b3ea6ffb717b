"""Builders: a config loaded with
``detmatch_tpu_torch.config.Config.fromfile`` → datasets and their
pipelines, detectors, the SSL detector and the voxelizer (counterpart of
``detmatch_tpu/apis/build.py``): PV-RCNN, Faster R-CNN and the LiDAR
zoo of JAX's registry (SECOND, SECOND-IoU, PointPillars, Part-A2, Voxel
R-CNN, PointRCNN); CaDDN is not ported.
Every model comes in eval mode on ``device``: the card unless the caller
asks for another device (the CPU tests pass ``device="cpu"``); there is
no fallback when no card is found. Datasets are host numpy."""
from __future__ import annotations

import inspect
from typing import Any, Dict, List

import numpy as np
import torch

from ..data import dbsampler, kitti, pipelines
from ..models.frcnn.faster_rcnn import FasterRCNN
from ..models.pvrcnn.parta2 import PartA2
from ..models.pvrcnn.pointpillars import PointPillars
from ..models.pvrcnn.pointrcnn import PointRCNN
from ..models.pvrcnn.pvrcnn import PVRCNN
from ..models.pvrcnn.second import SECOND, SECONDIoU
from ..models.pvrcnn.voxelrcnn import VoxelRCNN
from ..ops.voxelize import VoxelizerSpec
from ..ssl.detector import SSLConfig, SSLDetector

PIPELINE_REGISTRY = {
    "LoadPoints": pipelines.LoadPoints,
    "LoadImage": pipelines.LoadImage,
    "Resize": pipelines.Resize,
    "RandomFlip3D": pipelines.RandomFlip3D,
    "GlobalRotScaleTrans": pipelines.GlobalRotScaleTrans,
    "ObjectNoise": pipelines.ObjectNoise,
    "PointsRangeFilter": pipelines.PointsRangeFilter,
    "ObjectRangeFilter": pipelines.ObjectRangeFilter,
    "PointShuffle": pipelines.PointShuffle,
    "PhotoMetricAugs": pipelines.PhotoMetricAugs,
    "Normalize": pipelines.Normalize,
    "PadToCanvas": pipelines.PadToCanvas,
    "MultiScaleFlipAug3D": pipelines.MultiScaleFlipAug3D,
}


def build_pipeline(cfgs: List[Dict[str, Any]], root=None, rng=None):
    """The transforms of a pipeline config list; every random transform
    (and the gt-database sampler of ``ObjectSample``) draws from ``rng``
    (a ``np.random.RandomState``; numpy's global one if None)."""
    out = []
    rng = rng or np.random
    for cfg in cfgs:
        cfg = dict(cfg)
        t = cfg.pop("type")
        if t == "ObjectSample":
            sampler_cfg = dict(cfg.pop("db_sampler"))
            sampler = dbsampler.DataBaseSampler(
                root=sampler_cfg.pop("data_root", root),
                rng=rng, **sampler_cfg)
            out.append(dbsampler.ObjectSample(sampler, **cfg))
            continue
        cls = PIPELINE_REGISTRY[t]
        if "rng" in inspect.signature(cls.__init__).parameters:
            cfg["rng"] = rng
        out.append(cls(**cfg))
    return out


def build_dataset(cfg: Dict[str, Any], rng=None):
    """A ``KittiDataset`` (with its pipeline) or a ``TSDataset`` of the
    teacher-student pipelines, from a ``data`` entry of a config."""
    cfg = dict(cfg)
    t = cfg.pop("type", "KittiDataset")
    if t == "TSDataset":
        base = build_dataset(cfg.pop("dataset"), rng=rng)
        return pipelines.TSDataset(
            base,
            build_pipeline(cfg.pop("shared_pipeline"), root=base.root,
                           rng=rng),
            build_pipeline(cfg.pop("student_pipeline"), root=base.root,
                           rng=rng),
            build_pipeline(cfg.pop("teacher_pipeline"), root=base.root,
                           rng=rng))
    if t != "KittiDataset":
        raise NotImplementedError(f"dataset type {t!r} is not ported")
    pipe = cfg.pop("pipeline", None)
    root = cfg.pop("data_root")
    ds = kitti.KittiDataset(root, cfg.pop("ann_file"), **cfg)
    if pipe is not None:
        ds.pipeline = pipelines.Compose(
            build_pipeline(pipe, root=root, rng=rng))
    return ds


# JAX's registry names (``detmatch_tpu/apis/build.py:80-92``)
DETECTORS = {"PVRCNN": PVRCNN, "SECOND": SECOND, "SECONDNetIoU": SECONDIoU,
             "PointPillar": PointPillars, "PartA2Net": PartA2,
             "PointRCNN": PointRCNN, "VoxelRCNN": VoxelRCNN,
             "FasterRCNN": FasterRCNN}
# in JAX's registry, not ported yet (ROADMAP queue 1)
NOT_PORTED = {"CaDDN": "the camera-only CaDDN (ROADMAP queue 1, item 5)"}
DEFAULT_TYPE = {"detector_3d": "PVRCNN", "detector_2d": "FasterRCNN"}


COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(name):
    """A config's ``compute_dtype`` string → the models' torch dtype (JAX
    ``build.py:101-113``): "bfloat16" → ``torch.bfloat16``; None or
    "float32" → None (float32 throughout). A torch dtype passes through;
    anything else raises ValueError."""
    if isinstance(name, torch.dtype):
        return None if name == torch.float32 else name
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r}: expected one of "
                         f"{sorted(k for k in COMPUTE_DTYPES if k)} or None")
    return COMPUTE_DTYPES[name]


def _make(cfg: Dict[str, Any], key: str):
    det = dict(cfg["model"].get(key, {}))
    kind = det.pop("type", DEFAULT_TYPE[key])
    if kind in NOT_PORTED:
        raise NotImplementedError(f"detector type {kind!r} is not ported: "
                                  f"{NOT_PORTED[kind]}")
    if kind not in DETECTORS:
        raise KeyError(f"unknown detector type {kind!r}; expected one of "
                       f"{sorted(DETECTORS)}")
    if "compute_dtype" in det:
        det["compute_dtype"] = compute_dtype(det["compute_dtype"])
    return DETECTORS[kind](**det)


def build_detector(cfg: Dict[str, Any], device="cuda", key="detector_3d"):
    """The detector of ``cfg['model'][key]`` (``detector_3d``, a PV-RCNN
    by default or any 3D type of ``DETECTORS``, or ``detector_2d``, a
    Faster R-CNN), eval mode, on ``device``."""
    return _make(cfg, key).to(device).eval()


def build_models(cfg: Dict[str, Any], device="cuda"):
    """(PV-RCNN, Faster R-CNN) of ``cfg['model']``."""
    return (build_detector(cfg, device, "detector_3d"),
            build_detector(cfg, device, "detector_2d"))


def ssl_modules_to_config(modules: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The reference's SSL module graph (``lab_modules`` /
    ``unlab_modules`` entries) → :class:`SSLConfig` fields."""
    out: Dict[str, Any] = {}
    for m in modules or []:
        m = dict(m)
        t = m.pop("type")
        if t == "MaxScoreFilter":
            key = "score_filter_3d" if m.get("is_3d", True) \
                else "score_filter_2d"
            out[key] = m.get("score_thr", 0.1)
        elif t == "FusionHungarianMatching":
            out["fusion"] = True
            if "cost_thr" in m:
                out["cost_thr"] = m["cost_thr"]
        elif t == "HungarianConsistency":
            out["consistency"] = True
            out["consistency_weights"] = (m.get("cls_weight", 2.0),
                                          m.get("l1_weight", 20.0),
                                          m.get("iou_weight", 2.0))
        elif t == "HardPseudoLabel_2D":
            out["enable_2d"] = True
            out["pseudo_score_thr_2d"] = m.get("score_thr", 0.1)
            out["hard_pseudo_2d_weight"] = m.get("weight", 4.0)
        elif t == "Opd_HardPseudoLabel_3D":
            out["enable_3d"] = True
            out["pseudo_score_thr_3d"] = m.get("score_thr", 0.1)
        elif t in ("Opd_SimpleTest_3D", "Opd_Supervised_3D"):
            out["enable_3d"] = True
        elif t in ("SimpleTest_2D", "TwoStageSupervised_2D",
                   "BboxesNMS_2D", "BboxesTransform_2D",
                   "BboxesTransform_3D", "DetachBboxes", "Bboxes3DTo2D",
                   "AverageBboxes_2D", "NumPreds", "Vis3D", "Vis2D_Kitti"):
            pass  # structural steps the fused pipeline always has
        else:
            raise KeyError(f"unknown SSL module type: {t}")
    return out


def build_ssl(cfg: Dict[str, Any], device="cuda") -> SSLDetector:
    """The SSL detector of an SSL config (``model.detector_3d``,
    ``model.detector_2d``, ``ssl`` and the module lists), student and
    teacher, eval mode, on ``device``. Every key of ``ssl`` (among them
    ``concat_student_batch``) goes to :class:`SSLConfig`."""
    pv, fr = (_make(cfg, "detector_3d"), _make(cfg, "detector_2d"))
    kwargs = dict(cfg.get("ssl", {}))
    for key in ("lab_modules", "unlab_modules"):
        kwargs.update(ssl_modules_to_config(cfg["model"].get(key, [])))
    return SSLDetector(pv, fr, SSLConfig(**kwargs)).to(device).eval()


def build_voxelizer(cfg: Dict[str, Any]) -> VoxelizerSpec:
    """The :class:`VoxelizerSpec` of ``cfg['voxelizer']``."""
    v = cfg["voxelizer"]
    return VoxelizerSpec(point_cloud_range=tuple(v["point_cloud_range"]),
                         voxel_size=tuple(v["voxel_size"]),
                         max_voxels=v.get("max_voxels", 16000),
                         max_points=v.get("max_points", 5))
