"""The port's checkpoint importer (``detmatch_tpu_torch/tools/
model_converters/import_torch_ckpt.py``) against the JAX tool
(``tools/model_converters/import_torch_ckpt.py``, loaded by path).

The checkpoints are fakes in the reference's formats, made from seeded
port models (batch-norm statistics randomized): a pcdet PV-RCNN
(``model_state`` with pcdet's ``global_step``, beside ``optimizer_state``,
``epoch``, ``it`` and ``version``) at the tiny widths with the BEV depth
``convert_pvrcnn`` expects, and mmdet Faster R-CNNs (``state_dict`` with
mmdet's ``num_batches_tracked`` of every batch norm, beside ``meta`` and
``optimizer``) at R50 and R101 depths.

* pcdet: the import equals the JAX route ``from_jax_pvrcnn(
  *convert_pvrcnn(sd))`` but for ``point_head.cls_layers.0``, whose BEV
  rows the JAX route permutes (its converter copies them as pcdet holds
  them, and ``from_jax_pvrcnn`` then permutes) while the import keeps
  pcdet's order, which the port's point head reads; and for the
  ``num_batches_tracked`` counters, which JAX does not hold;
* mmdet R50: the import equals ``from_jax_frcnn(*convert_frcnn(sd))``;
* mmdet R101 (blocks (3, 4, 23, 3), the depth from the config): the
  import loads every block, where JAX's ``convert_frcnn`` reads (3, 4,
  6, 3) blocks and its route raises ``KeyError`` on ``layer3_6``;
* a checkpoint that lacks a key of the model or holds one in another
  shape is refused, naming the key; the keys it drops are named;
* the written checkpoint is what ``train_ssl``'s ``load_from`` reads.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

from detmatch_tpu_torch.apis.build import build_ssl  # noqa: E402
from detmatch_tpu_torch.apis.train_ssl import train_ssl  # noqa: E402
from detmatch_tpu_torch.convert import (_hc_perm, from_jax_frcnn,  # noqa: E402
                                        from_jax_pvrcnn)
from detmatch_tpu_torch.models.frcnn.faster_rcnn import FasterRCNN  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.backbone3d import (  # noqa: E402
    level_shapes)
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import PVRCNN  # noqa: E402
from detmatch_tpu_torch.ops.voxelize import VoxelizerSpec  # noqa: E402
from detmatch_tpu_torch.tools.model_converters import (  # noqa: E402
    import_torch_ckpt as imp)
from detmatch_tpu_torch.train import checkpoints  # noqa: E402
from detmatch_tpu_torch.utils import tiny  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

JAX_TOOL = os.path.join(ROOT, "tools", "model_converters",
                        "import_torch_ckpt.py")
PV_CFG = dict(tiny.TINY_PV_CFG,
              bev_cfg=dict(tiny.TINY_PV_CFG["bev_cfg"], layer_nums=(5, 5)))
HC_Z = level_shapes((41, 32, 32))[-1][0]
HC_C = PV_CFG["backbone3d_cfg"]["out_channels"]
R50 = dict(tiny.TINY_FR_CFG, backbone_cfg=dict(stage_blocks=(3, 4, 6, 3)))
R101 = dict(tiny.TINY_FR_CFG, backbone_cfg=dict(stage_blocks=(3, 4, 23, 3)))


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_import_ckpt",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded(model, seed):
    """``model``'s state dict after its own seeded initialisers, with
    randomized batch-norm statistics."""
    rng = np.random.RandomState(seed)
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(torch.from_numpy(0.2 * rng.randn(*v.shape)))
        elif k.endswith("running_var"):
            v.copy_(torch.from_numpy(0.5 + rng.rand(*v.shape)))
    return {k: v.clone() for k, v in sd.items()}


def config(det3d=PV_CFG, det2d=R50):
    return dict(model=dict(detector_3d=det3d, detector_2d=det2d))


@pytest.fixture(scope="module")
def pcdet(tmp_path_factory):
    """A seeded PV-RCNN as pcdet saves it; (path, its model state)."""
    torch.manual_seed(0)
    sd = seeded(PVRCNN(**PV_CFG), 0)
    sd = {k: (torch.full_like(v, 7400) if k.endswith("num_batches_tracked")
              else v) for k, v in sd.items()}
    model_state = dict(sd, global_step=torch.tensor([7400]))
    path = tmp_path_factory.mktemp("pcdet") / "pv_rcnn_8369.pth"
    torch.save(dict(epoch=80, it=7400, model_state=model_state,
                    optimizer_state=dict(state={}, param_groups=[
                        dict(lr=0.01, betas=(0.9, 0.99))]),
                    version="pcdet+0.3.0+0000000"), path)
    return str(path), model_state


def mmdet_checkpoint(tmp_path_factory, blocks, seed, name):
    torch.manual_seed(seed)
    cfg = dict(tiny.TINY_FR_CFG, backbone_cfg=dict(stage_blocks=blocks))
    sd = seeded(FasterRCNN(**cfg), seed)
    extra = {k.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(0)
             for k in sd if k.startswith("backbone") and
             k.endswith("running_mean")}
    state_dict = dict(sd, **extra)
    path = tmp_path_factory.mktemp("mmdet") / f"{name}.pth"
    torch.save(dict(meta=dict(mmdet_version="2.14.0", epoch=12, iter=3000,
                              CLASSES=("Car", "Pedestrian", "Cyclist"),
                              config="model = dict(...)"),
                    state_dict=state_dict,
                    optimizer=dict(state={}, param_groups=[dict(lr=0.02)])),
               path)
    return str(path), state_dict


@pytest.fixture(scope="module")
def mmdet_r50(tmp_path_factory):
    return mmdet_checkpoint(tmp_path_factory, (3, 4, 6, 3), 1, "r50")


def numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def assert_state_equal(got, want, skip=()):
    assert set(got) == set(want)
    for k in want:
        if k not in skip:
            assert torch.equal(got[k], want[k]), k


def test_pcdet_import_equals_the_jax_route_but_its_faults(pcdet, tmp_path):
    path, model_state = pcdet
    logs = []
    got, dropped = imp.import_checkpoint("pvrcnn", path, str(tmp_path),
                                         config(), log=logs.append)
    assert dropped == ["global_step"]
    assert any("dropped global_step" in m for m in logs)
    params, stats = jax_tool().convert_pvrcnn(
        numpy_sd(model_state), hc_z=HC_Z, hc_c=HC_C,
        grid_size=PV_CFG["roi_head_cfg"]["grid_size"])
    want = from_jax_pvrcnn(params, stats, PV_CFG)
    counters = [k for k in want if k.endswith("num_batches_tracked")]
    head = "point_head.cls_layers.0.weight"
    assert_state_equal(got, want, skip=counters + [head])
    for k in counters:  # the checkpoint's own; JAX holds no counter
        assert int(got[k]) == 7400 and int(want[k]) == 0
    ours, theirs = got[head].numpy(), want[head].numpy()
    np.testing.assert_array_equal(ours, model_state[head].numpy())
    n = HC_Z * HC_C
    np.testing.assert_array_equal(theirs[:, _hc_perm(HC_Z, HC_C)],
                                  ours[:, :n])
    np.testing.assert_array_equal(theirs[:, n:], ours[:, n:])
    assert not np.array_equal(theirs, ours)


def test_mmdet_r50_import_equals_the_jax_route(mmdet_r50, tmp_path):
    path, state_dict = mmdet_r50
    got, dropped = imp.import_checkpoint("frcnn", path, str(tmp_path),
                                         config())
    assert dropped and all(k.endswith("num_batches_tracked")
                           for k in dropped)
    params, frozen = jax_tool().convert_frcnn(numpy_sd(state_dict))
    assert_state_equal(got, from_jax_frcnn(params, frozen, R50))


def test_mmdet_r101_takes_the_configs_depth(tmp_path_factory, tmp_path):
    """Through the command line, with the depth in a config file: every
    one of layer3's 23 blocks arrives; the JAX route stops at 6."""
    path, state_dict = mmdet_checkpoint(tmp_path_factory, (3, 4, 23, 3), 2,
                                        "r101")
    cfg_file = tmp_path / "r101.py"
    cfg_file.write_text(f"model = dict(detector_3d={PV_CFG!r}, "
                        f"detector_2d={R101!r})\n")
    out = tmp_path / "r101_ckpt"
    imp.main(["frcnn", path, str(out), "--config", str(cfg_file)])
    got = checkpoints.restore_latest(str(out))[0]["model"]
    assert "backbone.layer3.22.conv3.weight" in got
    assert_state_equal(got, {k: v for k, v in state_dict.items()
                             if not k.endswith("num_batches_tracked")})
    params, frozen = jax_tool().convert_frcnn(numpy_sd(state_dict))
    assert "layer3_5" in params["backbone"]
    assert "layer3_6" not in params["backbone"]
    with pytest.raises(KeyError, match="layer3_6"):
        from_jax_frcnn(params, frozen, R101)


@pytest.mark.parametrize("fault", ["missing", "misshapen"])
def test_refuses_missing_and_misshapen_keys(pcdet, tmp_path, fault):
    _, model_state = pcdet
    sd = dict(model_state)
    key = "roi_head.reg_layers.7.weight"
    if fault == "missing":
        del sd[key]
    else:
        sd[key] = sd[key][:, :-1]
    path = tmp_path / "bad.pth"
    torch.save(dict(model_state=sd), path)
    with pytest.raises(ValueError, match=f"{fault} {key}"):
        imp.import_checkpoint("pvrcnn", str(path), str(tmp_path / "out"),
                              config())
    assert not (tmp_path / "out").exists()


def test_reads_a_bare_state_dict_and_refuses_pickled_objects(mmdet_r50,
                                                              tmp_path):
    _, state_dict = mmdet_r50
    bare = tmp_path / "bare.pth"
    torch.save(state_dict, bare)
    assert imp.read_state_dict(str(bare)).keys() == state_dict.keys()
    odd = tmp_path / "odd.pth"
    torch.save(dict(state_dict=state_dict, meta=dict(
        rng=np.random.RandomState(0))), odd)
    with pytest.raises(ValueError, match="weights_only"):
        imp.read_state_dict(str(odd))


def test_load_from_reads_the_imported_checkpoints(pcdet, mmdet_r50,
                                                   tmp_path):
    """``train_ssl`` with ``load_from`` naming the two imports and no
    iteration: student and teacher of each branch equal the imported
    checkpoints."""
    out = {}
    for det, kind, (path, _) in (("det3d", "pvrcnn", pcdet),
                                 ("det2d", "frcnn", mmdet_r50)):
        out[det] = str(tmp_path / det)
        imp.import_checkpoint(kind, path, out[det], config())
    ssl = build_ssl(config(), device="cpu")
    ssl, _, hist = train_ssl(
        ssl, VoxelizerSpec(**tiny.TINY_SPEC), [0, 1], [0, 1], lambda s: s,
        str(tmp_path / "ssl"), 0, batch_size=1, load_from=out)
    assert hist == []
    for det, path in out.items():
        want = checkpoints.restore_latest(path)[0]["model"]
        for half in (ssl.student, ssl.teacher):
            assert_state_equal(half[det].state_dict(), want)
