"""The learning study's DetMatch arm, held to the JAX package where the
port's run went wrong (``PERF.md``; ``tools/port_probes/finite_probe.py``
checks the run on the card):

* the corner loss of the RoI head on a background RoI whose regression
  passes log(FLT_MAX) in a size channel: the signature of the study's
  non-finite steps on record (``PERF.md``: ``rcnn_loss_corner`` NaN in
  the labeled and the unlabeled group at once, ``rcnn_loss_reg`` and
  ``rcnn_loss_cls`` finite). JAX decodes every
  RoI and multiplies the foreground mask in afterwards, 0 * inf = NaN,
  and so did the port; the port now decodes the foreground RoIs only, as
  pcdet does. Its terms and gradients are finite there, and equal JAX's
  wherever JAX's are finite (seeded inputs, the spike added to one
  background RoI of each sample);
* the carry of the port's weights to JAX: ``convert.to_jax_pvrcnn``,
  ``to_jax_frcnn`` and ``to_jax_ssl`` are the exact inverses of the
  ``from_jax_*`` converters, both ways round (JAX's own variable trees,
  their structure from ``jax.eval_shape`` of JAX's initialiser, filled
  with seeded numbers; and seeded port models);
* the teacher phase at the study's widths (``learning_study.build_cfg``,
  its first unlabeled batch through both packages' data layers, the
  study's seed-0 weights carried to JAX by ``to_jax_ssl``): the 3D and
  2D sets before and after ``max_score_filter``, the fused 3D set's
  valid count and ``num_tea_hung`` equal JAX's. At the study's
  initialisation every 3D class score sits near 0.01, under the 0.1
  filter, in both packages, so fusion keeps nothing; with the class
  layers' weights spread (the 3D dense head's and the 2D box head's,
  seeded), scores pass the filter and the fused sets (at a cost threshold
  that rejects no pair) are compared whole.
  The random initialisation's RPN scores tie to 1e-6 across anchors, and
  float noise reorders such ties at the proposal NMS; the spread case
  breaks them, the initialisation case compares what ties cannot move.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_port_ssl_fixture as fx  # noqa: E402
from detmatch_tpu.ssl import boxset as jboxset  # noqa: E402
from detmatch_tpu_torch.apis import build as pbuild  # noqa: E402
from detmatch_tpu_torch.convert import (from_jax_frcnn,  # noqa: E402
                                        from_jax_pvrcnn, from_jax_ssl,
                                        to_jax_frcnn, to_jax_pvrcnn,
                                        to_jax_ssl)
from detmatch_tpu_torch.data import collate as pcollate  # noqa: E402
from detmatch_tpu_torch.data import loader as ploader  # noqa: E402
from detmatch_tpu_torch.ssl import boxset as pboxset  # noqa: E402
from detmatch_tpu_torch.ssl import modules  # noqa: E402
from detmatch_tpu_torch.tools.misc import learning_study as ls  # noqa: E402
from detmatch_tpu_torch.train.ssl_step import (  # noqa: E402
    to_device_views, voxelize_views)
from test_torch_port_learning_study import (SMALL_SPECS,  # noqa: E402
                                            assert_tree_equal,
                                            first_batches, jax_plain)
from torch_port_ssl_fixture import _np, one_torch_thread  # noqa: E402,F401

RTOL = 1e-4


# ---- the corner loss on a background RoI's overflowing regression ----

def corner_case(seed=0, b=2, n=16):
    """Seeded RoI-loss inputs of two samples (as numpy): RoIs (the last
    two of each sample invalid zero-box slots), their targets with a
    third of the RoIs foreground, regression outputs of the trained
    scale; and the same regression with one background RoI of each
    sample at 100 in its length channel (exp(100) overflows float32)."""
    rng = np.random.RandomState(seed)
    rois = np.concatenate([rng.uniform(0, 40, (b, n, 3)),
                           rng.uniform(1, 5, (b, n, 3)),
                           rng.uniform(-3, 3, (b, n, 1))], -1)
    rois[:, -2:] = 0.0
    fg = rng.rand(b, n) < 0.33
    fg[:, -2:] = False
    fg[:, 0] = True
    gt = rois + np.concatenate([rng.normal(0, 0.3, (b, n, 3)),
                                rng.normal(0, 0.2, (b, n, 3)),
                                rng.normal(0, 0.1, (b, n, 1))], -1)
    gt = np.concatenate([gt, np.ones((b, n, 1))], -1)
    ct = np.concatenate([rng.normal(0, 0.3, (b, n, 3)), gt[..., 3:6],
                         rng.normal(0, 0.1, (b, n, 1)), gt[..., 7:]], -1)
    labels = np.where(fg, 1.0, np.where(rng.rand(b, n) < 0.5, 0.0, 0.4))
    targets = dict(rois=rois, gt_of_rois_src=gt, gt_of_rois_ct=ct,
                   reg_valid_mask=fg, rcnn_cls_labels=labels)
    targets = {k: (v if v.dtype == bool else v.astype(np.float32))
               for k, v in targets.items()}
    cls = rng.normal(0, 1, (b, n, 1)).astype(np.float32)
    reg = rng.normal(0, 0.2, (b, n, 7)).astype(np.float32)
    spiked = reg.copy()
    for i in range(b):
        spiked[i, np.flatnonzero(~fg[i])[0], 3] = 100.0
    return cls, reg, spiked, targets


def jax_terms(cls, reg, targets):
    """JAX's per-sample RoI terms and the gradient of their sum w.r.t.
    the regression."""
    from detmatch_tpu.models.pvrcnn.roi_head import (
        roi_head_loss_terms as j_terms)
    t = {k: jnp.asarray(v) for k, v in targets.items()}

    def total(r):
        terms = j_terms(jnp.asarray(cls), r, t)
        return sum(jnp.sum(n) for n, _ in terms.values()), terms

    (_, terms), grad = jax.value_and_grad(total, has_aux=True)(
        jnp.asarray(reg))
    return ({k: (np.asarray(n), np.asarray(d)) for k, (n, d) in
             terms.items()}, np.asarray(grad))


def port_terms(cls, reg, targets):
    from detmatch_tpu_torch.models.pvrcnn.roi_head import roi_head_loss_terms
    r = torch.tensor(reg, requires_grad=True)
    terms = roi_head_loss_terms(torch.tensor(cls), r,
                                {k: torch.tensor(v) for k, v in
                                 targets.items()})
    sum(n.sum() for n, _ in terms.values()).backward()
    return ({k: (n.detach().numpy(), d.numpy()) for k, (n, d) in
             terms.items()}, r.grad.numpy())


def assert_terms_close(ours, theirs, keys, name):
    for k in keys:
        for a, b_ in zip(ours[k], theirs[k]):
            tol = RTOL * max(1.0, float(np.abs(b_).max()))
            np.testing.assert_allclose(a, b_, rtol=0, atol=tol,
                                       err_msg=f"{name}: {k}")


def test_background_regression_overflow_is_finite_and_equals_jax():
    cls, reg, spiked, targets = corner_case()
    keys = ("rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner")
    # finite inputs: the port equals JAX, terms and gradient
    ours, g_ours = port_terms(cls, reg, targets)
    theirs, g_theirs = jax_terms(cls, reg, targets)
    assert_terms_close(ours, theirs, keys, "finite")
    np.testing.assert_allclose(g_ours, g_theirs, rtol=0, atol=RTOL * max(
        1.0, float(np.abs(g_theirs).max())))
    # the spike: JAX's corner term is NaN in both samples (both groups of
    # the concatenated batch), its reg and cls terms finite, its gradient
    # NaN (the optimizer skips the step)
    spk_theirs, g_spk_theirs = jax_terms(cls, spiked, targets)
    assert np.isnan(spk_theirs["rcnn_loss_corner"][0]).all()
    assert all(np.isfinite(spk_theirs[k][0]).all()
               for k in ("rcnn_loss_cls", "rcnn_loss_reg"))
    assert not np.isfinite(g_spk_theirs).all()
    # the port: finite, and equal to JAX where JAX is finite (the corner
    # term, which the background RoI does not enter, to JAX's on the
    # unspiked regression)
    spk_ours, g_spk_ours = port_terms(cls, spiked, targets)
    assert all(np.isfinite(x).all() for v in spk_ours.values() for x in v)
    assert np.isfinite(g_spk_ours).all()
    assert_terms_close(spk_ours, spk_theirs, keys[:2], "spiked")
    assert_terms_close(spk_ours, theirs, keys[2:], "spiked corner")
    fg = targets["reg_valid_mask"]
    np.testing.assert_allclose(g_spk_ours[fg], g_theirs[fg], rtol=0,
                               atol=RTOL * max(1.0, float(np.abs(
                                   g_theirs).max())))


# ---- the carry of weights to JAX ----

def seeded_tree(tree, seed):
    """A JAX variable tree of ``tree``'s structure, shapes and dtypes
    (``ShapeDtypeStruct`` leaves) filled with seeded numbers."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: rng.randn(*s.shape).astype(s.dtype), tree)


@pytest.fixture(scope="module")
def jax_tree():
    """JAX's SSL state at the tiny widths (``configs/tests/ssl_tiny.py``)
    as ``init_states`` shapes it, with seeded leaves; and the config."""
    cfg = fx.load_cfg()
    jssl = fx.jax_ssl(cfg)
    vb = fx.j_voxelize_views(fx.jax_views(fx.views(0)), fx.jax_spec(cfg))
    lab = vb["lab"]["stu"]
    shapes = jax.eval_shape(jssl.init_states, jax.random.PRNGKey(0), lab,
                            lab["img"], lab["img_shape"])
    stu = seeded_tree(shapes["student"], 0)
    return cfg, dict(student=stu, teacher=seeded_tree(shapes["teacher"], 1))


def assert_jax_trees_equal(got, want, where=""):
    assert jax.tree.structure(got) == jax.tree.structure(want), where
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f"{where}{path}")


@pytest.mark.parametrize("part", ["pvrcnn", "frcnn", "ssl"])
def test_to_jax_inverts_from_jax(jax_tree, part):
    """JAX tree → ``from_jax_*`` → ``to_jax_*`` is the same tree, leaf for
    leaf; a seeded port model → ``to_jax_*`` → ``from_jax_*`` is the same
    state dict (``num_batches_tracked``, which JAX does not hold, aside)."""
    cfg, state = jax_tree
    m3, m2 = cfg["model"]["detector_3d"], cfg["model"]["detector_2d"]
    v3, v2 = state["student"]["det3d"], state["student"]["det2d"]
    if part == "pvrcnn":
        back = to_jax_pvrcnn(from_jax_pvrcnn(v3["params"], v3["batch_stats"],
                                             m3), m3)
        want = (v3["params"], v3["batch_stats"])
        model = pbuild.build_detector(cfg, "cpu", "detector_3d")
        sd_back = from_jax_pvrcnn(*to_jax_pvrcnn(model.state_dict(), m3),
                                  m3)
    elif part == "frcnn":
        back = to_jax_frcnn(from_jax_frcnn(v2["params"], v2["frozen"], m2),
                            m2)
        want = (v2["params"], v2["frozen"])
        model = pbuild.build_detector(cfg, "cpu", "detector_2d")
        sd_back = from_jax_frcnn(*to_jax_frcnn(model.state_dict(), m2), m2)
    else:
        back = to_jax_ssl(from_jax_ssl(state, m3, m2), m3, m2)
        want = state
        model = pbuild.build_ssl(cfg, "cpu")
        sd_back = from_jax_ssl(to_jax_ssl(model.state_dict(), m3, m2), m3,
                               m2)
    assert_jax_trees_equal(back, want, part)
    sd = model.state_dict()
    assert sd.keys() == sd_back.keys()
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd_back[k]), k


# ---- the teacher phase at the study's widths ----

@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """The study's config on a small tree of its splits, the first
    unlabeled batch through both packages' data layers (equal), and both
    packages' SSL detectors."""
    from test_torch_port_learning_study import jax_tool
    from detmatch_tpu.apis import build as jbuild
    from detmatch_tpu.data import collate as jcollate
    from detmatch_tpu.data import loader as jloader

    root = str(tmp_path_factory.mktemp("study")) + "/"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ls, "SPECS", SMALL_SPECS)
        paths = ls.make_data(root)
    wd = os.path.join(root, "run_ssl")
    cfg = ls.build_cfg(root, paths, 3000, 1.0, wd, seed=0)
    jcfg = jax_tool().build_cfg(root, paths, 3000, 1.0, wd, seed=0)

    class P:
        build_dataset = staticmethod(pbuild.build_dataset)
        Loader = ploader.Loader

    class J:
        build_dataset = staticmethod(jbuild.build_dataset)
        Loader = jloader.Loader

    ours = first_batches(P, cfg, pcollate.collate_view, pcollate.collate_ts)
    theirs = jax_plain(first_batches(J, jcfg, jcollate.collate_view,
                                     jcollate.collate_ts))
    assert_tree_equal(ours["train_unlab"], theirs["train_unlab"])
    ssl, vox = ls.build_models(cfg, seed=0, device="cpu")
    return dict(cfg=cfg, ssl=ssl, vox=vox, batch=ours["train_unlab"], jbatch=theirs["train_unlab"])


def spread(ssl, seed=0):
    """Seeded class-layer weights with a spread: the PV-RCNN dense head's
    ``conv_cls`` and the Faster R-CNN's ``fc_cls`` (teacher and
    student), so that scores pass the 0.1 filter."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for half in (ssl.student, ssl.teacher):
            for layer in (half["det3d"].dense_head.conv_cls,
                          half["det2d"].roi_head.bbox_head.fc_cls):
                w = torch.randn(layer.weight.shape, generator=g)
                layer.weight.copy_(w * 0.05)
                layer.bias.copy_(torch.randn(layer.bias.shape,
                                             generator=g) - 1.0)


def np_set(bs):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in bs.items()}


def top_scores(bs):
    """The largest class score a frame over the valid slots (-1 where
    none is valid)."""
    bs = np_set(bs)
    return np.where(bs["valid"], bs["scores"].max(-1), -1.0).max(-1)


def assert_set_close(ours, theirs, name, whole=True):
    """Equal valid counts a frame and largest scores a frame; with
    ``whole`` also equal validity, boxes and scores slot by slot."""
    ours, theirs = np_set(ours), np_set(theirs)
    np.testing.assert_array_equal(ours["valid"].sum(-1),
                                  theirs["valid"].sum(-1), err_msg=name)
    np.testing.assert_allclose(top_scores(ours), top_scores(theirs),
                               rtol=0, atol=RTOL, err_msg=name)
    if not whole:
        return
    np.testing.assert_array_equal(ours["valid"], theirs["valid"],
                                  err_msg=name)
    for k in ("boxes", "scores"):
        a = np.where(ours["valid"][..., None], ours[k], 0)
        b = np.where(theirs["valid"][..., None], theirs[k], 0)
        tol = RTOL * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{name}.{k}")


@pytest.mark.parametrize("weights", ["init", "spread"])
def test_teacher_phase_at_the_study_widths(study, weights):
    """The study's start (``init``): the 3D stage runs in both packages;
    its sets' valid counts (which float noise can move at the proposal
    NMS's ties) are compared by their largest scores, every later set
    whole. With spread class layers the ties reach the 3D stage's
    output slots too, so JAX is handed the port's 3D and 2D stages (as
    ``test_torch_port_ssl_teacher.py`` hands over the 2D one) and the
    filters and the fusion, at a cost threshold that rejects no pair,
    are compared whole."""
    from detmatch_tpu.ssl import modules as jmodules

    cfg, ssl = study["cfg"], study["ssl"]
    if weights == "spread":
        ssl = pbuild.build_ssl(cfg, "cpu")
        ssl.load_state_dict(study["ssl"].state_dict())
        spread(ssl)
    m, scfg = cfg["model"], ssl.cfg
    batch = voxelize_views(to_device_views({"unlab": study["batch"]}, "cpu"),
                           study["vox"])
    u_tea = batch["unlab"]["tea"]
    with torch.inference_mode():
        o3 = modules.transform_3d(ssl._det3d_teacher_boxes(u_tea),
                                  u_tea["aug3d"], reverse=True)
        o2 = modules.transform_2d(
            ssl._det2d_teacher_boxes(u_tea, scfg.nms_2d_cfg),
            u_tea["aug2d"], reverse=True)
    jssl = fx.jax_ssl(cfg)
    jb = fx.j_voxelize_views(fx.jax_views({"unlab": study["jbatch"]}),
                             fx.jax_spec(cfg))
    jt = jb["unlab"]["tea"]
    if weights == "init":
        tea = fx._j(to_jax_ssl(ssl.state_dict(), m["detector_3d"],
                               m["detector_2d"])["teacher"])
        j3d = jax.jit(jssl._det3d_teacher_boxes)(tea["det3d"], jt)
        j2d = jax.jit(lambda v, x: jssl._det2d_teacher_boxes(
            v, x, scfg.nms_2d_cfg))(tea["det2d"], jt)
    else:  # the port's stages, handed over
        with torch.inference_mode():
            j3d = {k: jnp.asarray(v.numpy()) for k, v in
                   ssl._det3d_teacher_boxes(u_tea).items()}
            j2d = {k: jnp.asarray(v.numpy()) for k, v in
                   ssl._det2d_teacher_boxes(u_tea, scfg.nms_2d_cfg).items()}
    t3 = jmodules.transform_3d(j3d, jt["aug3d"], reverse=True)
    t2 = jmodules.transform_2d(j2d, jt["aug2d"], reverse=True)
    tied = weights == "init"
    assert_set_close(o3, t3, "3d before the filter", whole=not tied)
    assert_set_close(o2, t2, "2d before the filter")
    for name, o, t, thr in (("3d", o3, t3, scfg.score_filter_3d),
                            ("2d", o2, t2, scfg.score_filter_2d)):
        assert_set_close(pboxset.max_score_filter(o, thr),
                         jboxset.max_score_filter(t, thr),
                         f"{name} after the filter")
    # the study's cost threshold at its initialisation; with the spread
    # weights one that rejects no pair, so that the fused sets are full
    hung = {}
    for cost_thr in (scfg.cost_thr,) if tied else (1e9,):
        ssl.cfg = dataclasses.replace(scfg, cost_thr=cost_thr)
        with torch.inference_mode():
            ours = ssl.teacher_pseudo_labels(batch)
        jssl = fx.jax_ssl(cfg)
        jssl.cfg = dataclasses.replace(jssl.cfg, cost_thr=cost_thr)
        jssl._det3d_teacher_boxes = lambda variables, view: j3d
        jssl._det2d_teacher_boxes = lambda variables, view, c: j2d
        theirs = _np(jax.jit(jssl.teacher_pseudo_labels)(
            dict(det3d={}, det2d={}), jb))
        for k in ("m3d_stu", "m2d_stu", "m2d_clean"):
            assert_set_close(ours[k], theirs[k], f"{k} at {cost_thr}")
        hung[cost_thr] = float(ours["logs"]["metrics.num_tea_hung"])
        assert hung[cost_thr] == float(
            theirs["logs"]["metrics.num_tea_hung"]), cost_thr
    ssl.cfg = scfg
    if tied:  # the study's start: every 3D class score under the filter
        assert top_scores(o3).max() < scfg.score_filter_3d
        assert hung[scfg.cost_thr] == 0
    else:
        assert pboxset.max_score_filter(o3, scfg.score_filter_3d)[
            "valid"].any()
        assert hung[1e9] > 0
