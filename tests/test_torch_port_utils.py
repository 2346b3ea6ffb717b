"""CPU parity of the port's own config loader and synthetic frames
(``detmatch_tpu_torch/config``, ``detmatch_tpu_torch/utils/synth_kitti.py``)
with their JAX-package counterparts: the same file gives the same config,
and the same seed the same frames, exactly."""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

from detmatch_tpu.config import Config as JConfig  # noqa: E402
from detmatch_tpu.utils import synth_kitti as jsynth  # noqa: E402
from detmatch_tpu_torch.config import Config  # noqa: E402
from detmatch_tpu_torch.utils import synth_kitti  # noqa: E402

CONFIGS = (
    "configs/_base_/kitti_detmatch.py",
    "configs/detmatch/001/pretrain_pvrcnn/split_0.py",
    "configs/detmatch/002/pretrain_frcnn/split_1.py",
    "configs/detmatch/020/confthr_pvrcnn/split_2.py",
    "configs/detmatch/001/confthr_frcnn/split_0.py",
    "configs/detmatch/020/detmatch/split_1.py",
    "configs/tests/ssl_tiny.py",
)


@pytest.mark.parametrize("path", CONFIGS)
def test_config_fromfile_matches_reference(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    assert cfg == JConfig.fromfile(os.path.join(ROOT, path))
    assert isinstance(cfg.model, Config) or "model" not in cfg


def test_config_resolves_refs_and_placeholders():
    cfg = Config.fromfile(os.path.join(
        ROOT, "configs/detmatch/001/pretrain_pvrcnn/split_0.py"))
    assert cfg.data["train"]["pipeline"] == cfg.pretrain3d_pipeline
    assert cfg.data["train"]["ann_file"].endswith("lab_0.01_0.pkl")
    assert cfg.model.detector_3d.num_keypoints == 2048
    with pytest.raises(AttributeError):
        cfg.no_such_key


@pytest.mark.parametrize("b,num_points", [(1, 4096), (3, 16384)])
def test_lidar_batch_matches_reference(b, num_points):
    pcr = (0, -40, -3, 70.4, 40, 1)
    pts, valid = synth_kitti.lidar_batch(np.random.RandomState(7), b,
                                         num_points, pcr)
    jpts, jvalid = jsynth.lidar_batch(np.random.RandomState(7), b,
                                      num_points, pcr)
    assert pts.shape == (b, num_points, 4) and pts.dtype == np.float32
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.any(1).all()
