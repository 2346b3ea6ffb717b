"""``train_frcnn`` of the port against the JAX package's, on the CPU: the
2D pretraining loop from a dataset, two steps, the same weights and the
same batches, losses within the 1e-4 that
``test_torch_port_frcnn_train.py`` states for one step.

The same batches: a one-frame tree with a pipeline that draws nothing
(LoadImage, LoadPoints, Normalize, PadToCanvas), so every batch of two is
that frame twice in both packages, however their loaders interleave. The
same weights: JAX's ``train_frcnn`` initialises from ``PRNGKey(seed)`` on
its first batch; the test runs that ``init`` itself and converts it
(``convert.from_jax_frcnn``). Both calls run the initialiser jitted
(the loop's own call would run it op by op, ~40 s of per-op compiles on
the CPU; jitted or not, it draws from the same key). The same draws:
JAX's step ``it`` samples from ``fold_in(PRNGKey(seed), it)``; the
port's samplers take those uniforms (``rpn.sample_uniforms`` replaced,
as the Faster R-CNN tests do).
"""
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from detmatch_tpu.apis.train_pretrain import (  # noqa: E402
    train_frcnn as j_train_frcnn)
from detmatch_tpu.apis.train_ssl import make_mesh  # noqa: E402
from detmatch_tpu.data import collate as jcollate  # noqa: E402
from detmatch_tpu.data import kitti as jkitti  # noqa: E402
from detmatch_tpu.data import pipelines as jpipe  # noqa: E402
from detmatch_tpu.models.frcnn.faster_rcnn import (  # noqa: E402
    FasterRCNN as JFasterRCNN)
from detmatch_tpu_torch.apis.build import build_dataset  # noqa: E402
from detmatch_tpu_torch.apis.train_pretrain import train_frcnn  # noqa: E402
from detmatch_tpu_torch.convert import from_jax_frcnn  # noqa: E402
from detmatch_tpu_torch.data.collate import collate_view  # noqa: E402
from detmatch_tpu_torch.models.frcnn import rpn as prpn  # noqa: E402
from detmatch_tpu_torch.models.frcnn.faster_rcnn import (  # noqa: E402
    FasterRCNN)
from detmatch_tpu_torch.utils import tiny  # noqa: E402
from kitti_fixture import make_kitti_random  # noqa: E402
from test_torch_port_frcnn_train import (LOSS_RTOL,  # noqa: E402
                                         frcnn_loss_keys, rel, uniforms_of)
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

CFG = tiny.TINY_FR_CFG
B = 2
STEPS = 2
SEED = 0
COLLATE = dict(max_points=256, max_gt=6)


def _dataset(jax_side, root, info):
    steps = [jpipe.LoadImage(), jpipe.LoadPoints(), jpipe.Normalize(),
             jpipe.PadToCanvas(canvas=tuple(CFG["canvas"]))]
    if jax_side:
        return jkitti.KittiDataset(root, info,
                                   pipeline=jpipe.Compose(steps))
    return build_dataset(dict(
        type="KittiDataset", data_root=root, ann_file=info,
        pipeline=[dict(type="LoadImage"), dict(type="LoadPoints"),
                  dict(type="Normalize"),
                  dict(type="PadToCanvas", canvas=CFG["canvas"])]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    root = str(tmp_path_factory.mktemp("one_frame"))
    work = tmp_path_factory.mktemp("work")
    split = make_kitti_random(root, 1, seed=3, x_range=(5.0, 9.0),
                              max_objects=3)
    info = os.path.join(root, "infos.pkl")
    with open(info, "wb") as f:
        pickle.dump(jkitti.create_infos(root, split), f)
    jds = _dataset(True, root, info)
    eager_init = JFasterRCNN.init

    def jit_init(module, rngs, img, shape, train):
        return jax.jit(lambda r, i, s: eager_init(module, r, i, s,
                                                  train=train))(rngs, img,
                                                                shape)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFasterRCNN, "init", jit_init)
        j_train_frcnn(JFasterRCNN(**CFG), jds,
                      lambda s: jcollate.collate_view(s, **COLLATE),
                      str(work / "jax"), STEPS, batch_size=B,
                      mesh=make_mesh(1), log_interval=1, seed=SEED)
        first = jcollate.collate_view([jds[0]] * B, **COLLATE)
        key = jax.random.PRNGKey(SEED)
        var = JFasterRCNN(**CFG).init({"params": key},
                                      jnp.asarray(first["img"]),
                                      jnp.asarray(first["img_shape"]),
                                      train=True)
    want = [json.loads(x) for x in (work / "jax" / "log.json")
            .read_text().splitlines()]
    model = FasterRCNN(**CFG)
    model.load_state_dict(from_jax_frcnn(jax.tree.map(np.asarray,
                                                      var["params"]),
                                         jax.tree.map(np.asarray,
                                                      var["frozen"]), CFG))
    keys = [k for it in range(STEPS)
            for k in frcnn_loss_keys(jax.random.fold_in(key, it), B)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prpn, "sample_uniforms", uniforms_of(keys))
        _, opt, hist = train_frcnn(
            model, _dataset(False, root, info),
            lambda s: collate_view(s, **COLLATE), str(work / "port"), STEPS,
            batch_size=B, log_interval=1, seed=SEED)
    return want, hist, opt, work


def test_train_frcnn_losses_match_jax(runs):
    """Both steps: each loss term within 1e-4 of JAX's, the gt boxes
    present (the 2D gt reached the loss) and the total their sum."""
    want, hist, _, _ = runs
    assert len(want) == len(hist) == STEPS
    for step, (w, h) in enumerate(zip(want, hist)):
        for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
                  "loss"):
            assert rel(np.float32(h[k]), np.float32(w[k])) <= LOSS_RTOL, (
                step, k, h[k], w[k])
        assert w["loss_bbox"] > 0 and w["loss_rpn_bbox"] > 0, w
        terms = sum(h[k] for k in ("loss_rpn_cls", "loss_rpn_bbox",
                                   "loss_cls", "loss_bbox"))
        assert abs(h["loss"] - terms) <= 1e-6 * abs(terms), (h, terms)


def test_train_frcnn_writes_the_jax_log_and_checkpoint(runs):
    """The port's ``log.json`` has JAX's keys; the default checkpoint is
    written at the last step; the optimizer took both steps."""
    want, _, opt, work = runs
    lines = [json.loads(x) for x in (work / "port" / "log.json")
             .read_text().splitlines()]
    assert [set(x) for x in lines] == [set(x) for x in want]
    assert (work / "port" / "ckpt" / f"ckpt_{STEPS}").is_dir()
    assert not (work / "port" / "ckpt" / "ckpt_1").exists()
    assert opt.count == STEPS and opt.skipped == 0
