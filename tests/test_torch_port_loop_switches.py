"""CPU parity of the port's last loop and model switches against the JAX
package: ``post_processing(no_nms=True)``, the two-pass
``student_losses_3d`` (``concat_student_batch=False``),
``BranchOptimizer(step_interval=k)`` against optax's ``every_k_steps`` /
``hybrid_optimizer(step_intervals=...)``, the visualisation canvases
against JAX's cv2 drawings, ``MultiLogger`` and the tensorboard sink, and
``train_ssl_batches``' ``profile_dir``, ``vis_interval`` and
``tensorboard``.

Tolerances: ``no_nms`` copies exactly and its sigmoid scores within one
float32 step (ATen's and XLA's sigmoids differ in the last bit on ~0.4%
of inputs); the two-pass losses, gradients and batch-norm buffers to the
SSL step's tolerances (``test_torch_port_ssl_step.py``: losses and
buffers 1e-4 of their value or largest magnitude, gradients 1e-3 or
twice JAX's own spread for the ill-conditioned ones); the optimizer
steps within 1e-6 of each tensor's largest magnitude; canvases pixel for
pixel, the score text left out (its font differs by design).
"""
import json
import sys

import numpy as np
import pytest

import torch_port_ssl_fixture as fx
from torch_port_ssl_fixture import jax, one_torch_thread, rel, torch  # noqa: F401,E501

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from detmatch_tpu.models.pvrcnn.pvrcnn import (  # noqa: E402
    post_processing as j_post_processing)
from detmatch_tpu.models.pvrcnn import roi_head as jroi  # noqa: E402
from detmatch_tpu.ssl import modules as jmodules  # noqa: E402
from detmatch_tpu.train import optim as joptim  # noqa: E402
from detmatch_tpu.utils import visualize as jvis  # noqa: E402
from detmatch_tpu.utils.logging import (  # noqa: E402
    MultiLogger as JMultiLogger)
from detmatch_tpu_torch.apis import train_ssl as ptrain_ssl  # noqa: E402
from detmatch_tpu_torch.convert import from_jax_pvrcnn  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import (  # noqa: E402
    post_processing)
from detmatch_tpu_torch.train import optim as poptim  # noqa: E402
from detmatch_tpu_torch.train.ssl_step import student_3d_step  # noqa: E402
from detmatch_tpu_torch.train.tensorboard import (  # noqa: E402
    TensorBoardSink)
from detmatch_tpu_torch.utils import tiny  # noqa: E402
from detmatch_tpu_torch.utils import visualize as pvis  # noqa: E402
from detmatch_tpu_torch.utils.logging import (  # noqa: E402
    JsonlLogger, MultiLogger)
from test_torch_port_checkpoints import MICRO_ROI, micro_cfg  # noqa: E402
from test_torch_port_ssl_step import (LOSS_RTOL, STAT_RTOL,  # noqa: E402
                                      grad_tol)

OPT_RTOL = 1e-6
IT = 0
LR_3D, WARMUP = 0.01, 5


def test_post_processing_no_nms_matches_jax():
    rng = np.random.RandomState(0)
    b, n, c = 2, 40, 3
    out = dict(batch_box_preds_rcnn=rng.randn(b, n, 7).astype(np.float32),
               rcnn_cls=rng.randn(b, n, 1).astype(np.float32),
               roi_labels=rng.randint(1, 4, (b, n)).astype(np.int32),
               roi_scores_full=rng.randn(b, n, c).astype(np.float32))
    want = fx._np(j_post_processing(jax.tree.map(jnp.asarray, out),
                                    score_thresh=0.4, no_nms=True))
    got = post_processing({k: torch.from_numpy(v) for k, v in out.items()},
                          score_thresh=0.4, no_nms=True)
    assert set(got) == set(want)
    for k in ("boxes", "labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("scores", "sem_scores_full"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=np.finfo(np.float32).eps, err_msg=k)
    assert 0 < want["valid"].sum() < b * n


# ---------------------------------------------------------------- two-pass

def fake_pseudo(vb, rng):
    """Pseudo-labels in the teacher phase's format without running it:
    3D boxes in the student's frame (12 valid of 16) with class scores,
    and the clean 2D boxes as those boxes' projection (un-augmented) into
    the original image, so that the consistency branch pairs boxes."""
    u = vb["unlab"]["stu"]
    b, k = fx.B, 16
    boxes = np.concatenate([
        rng.uniform(2.0, 14.0, (b, k, 1)), rng.uniform(-5.0, 5.0, (b, k, 1)),
        np.full((b, k, 1), -1.0), np.tile([3.9, 1.6, 1.56], (b, k, 1)),
        rng.uniform(-np.pi, np.pi, (b, k, 1))], -1).astype(np.float32)
    m3d = dict(boxes=jnp.asarray(boxes),
               scores=jnp.asarray((0.15 + 0.8 * rng.rand(b, k, 3))
                                  .astype(np.float32)),
               valid=jnp.asarray(np.arange(k)[None].repeat(b, 0) < 12))
    orig = jmodules.transform_3d(m3d, u["aug3d"], reverse=True)
    m2d = jmodules.boxes_3d_to_2d(orig, u["lidar2img"], u["ori_shape"])
    return dict(m3d_stu=m3d, m2d_clean=m2d, m2d_stu=m2d)


@pytest.fixture(scope="module")
def two_pass():
    """JAX's ``student_losses_3d`` (losses, gradients, the batch-norm
    statistics after both passes) and the port's two-pass
    ``student_3d_step`` on the same weights, batch and pseudo-labels, the
    RoI picks and dropout masks of both passes handed over."""
    cfg = fx.load_cfg(cost_thr=50.0, concat_student_batch=False)
    # the tiny model's widths and the narrow RoI head (the JAX program of
    # two train passes compiles in about a minute), a one-block ResNet
    m = cfg["model"]
    m["detector_3d"].update(roi_head_cfg=MICRO_ROI, **{
        k: tiny.TINY_PV_CFG[k] for k in ("bev_cfg", "backbone3d_cfg")})
    m["detector_2d"]["backbone_cfg"] = dict(stage_blocks=(1, 1, 1, 1))
    batch = fx.views(1)
    vb = fx.j_voxelize_views(fx.jax_views(batch), fx.jax_spec(cfg))
    jssl = fx.jax_ssl(cfg)
    state = fx.make_state(jssl, vb)
    pseudo = fake_pseudo(vb, np.random.RandomState(2))
    masks, keys = fx.DropoutMasks(), []
    assign = jroi.assign_roi_targets

    def spy(rng_key, proposals, gt_boxes, cfg=None):
        keys.append(rng_key)
        return assign(rng_key, proposals, gt_boxes, cfg)

    def step3d(v, vbatch, pl, rng):
        def loss(p):
            total, aux = jssl.student_losses_3d(dict(v, params=p), vbatch,
                                                pl, IT, rng)
            return total, (aux, list(keys), list(masks.traced))
        return jax.value_and_grad(loss, has_aux=True)(v["params"])

    s3 = fx._j(state["student"]["det3d"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jroi, "assign_roi_targets", spy)
        rec = masks.recording()
        try:
            (total, (aux, drawn_keys, drawn)), grads = jax.jit(step3d)(
                s3, vb, pseudo, jax.random.PRNGKey(3))
        finally:
            rec.undo()
    masks.masks = [np.asarray(m) for m in drawn]
    # JAX against itself: the same step on weights moved by 1e-6 of
    # their value (the compiled program again)
    prng = np.random.RandomState(5)
    moved = dict(s3, params=jax.tree.map(
        lambda x: x * (1 + 1e-6 * prng.randn(*x.shape)).astype(np.float32),
        s3["params"]))
    keys.clear()
    masks.traced.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jroi, "assign_roi_targets", spy)
        rec = masks.recording()
        try:
            _, grads_moved = jax.jit(step3d)(moved, vb, pseudo,
                                             jax.random.PRNGKey(3))
        finally:
            rec.undo()

    model = fx.port_ssl(cfg, state)
    model.train()
    opt3d, _ = poptim.detmatch_branch_optimizers(model, LR_3D, 0.02, WARMUP)
    picks = [fx.roi_picks(key, fx.B) for key in drawn_keys]
    calls = iter(range(10 ** 6))

    def pick(*args):  # four draws a sample, the labeled pass first
        return picks[next(calls) // (4 * fx.B)](*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fx.proi, "_pick", pick)
        masks.replay(mp)
        logs = student_3d_step(model, opt3d, fx.port_views(cfg, batch),
                               fx.pseudo_to_torch(pseudo), IT,
                               torch.Generator())
    grads_port = {n: p.grad.clone() for n, p in
                  model.student["det3d"].named_parameters()
                  if p.grad is not None}
    return dict(cfg=cfg, state=state, total=float(total),
                logs=fx._np(aux["logs"]),
                stats=fx._np(aux["batch_stats"]["det3d"]),
                grads=fx._np(grads), grads_moved=fx._np(grads_moved),
                n_keys=len(drawn_keys), port=model,
                port_logs=logs, port_grads=grads_port)


def test_two_pass_losses_match_jax(two_pass):
    """Every term of both passes and of the consistency branch (nonzero:
    it pairs boxes), the total, and one RoI sampling per pass."""
    ours, want = two_pass["port_logs"], two_pass["logs"]
    assert two_pass["n_keys"] == 2
    assert set(want) <= set(ours), set(want) - set(ours)
    assert any(k.startswith("sup.3d.") for k in want)
    assert any(k.startswith("ssl.unlab.hard_pseudo_3d.") for k in want)
    for k in want:
        assert rel(ours[k], want[k]) <= LOSS_RTOL, (k, float(ours[k]),
                                                    float(want[k]))
    assert rel(ours["loss"], two_pass["total"]) <= LOSS_RTOL
    assert float(ours["metrics.num_2D_to_3D_hung"]) > 0
    assert float(ours["ssl.unlab.2D_to_3D_hung.l1_loss"]) > 0


def test_two_pass_gradients_match_jax(two_pass):
    """Each gradient within the SSL step's tolerance, or twice JAX's own
    spread: how far JAX's gradient moves when the weights move by 1e-6
    of their value. The labeled pass is one frame, whose train-mode batch
    norms leave the BEV's and the sparse backbone's gradients
    ill-conditioned in float32 (measured: the first BEV block's moves by
    up to 15%, the backbone's by up to 4%); most gradients hold to the
    step's tolerance itself."""
    zero = jax.tree.map(np.zeros_like,
                        two_pass["state"]["student"]["det3d"]["batch_stats"])
    cfg3 = two_pass["cfg"]["model"]["detector_3d"]
    want = from_jax_pvrcnn(two_pass["grads"], zero, cfg3)
    moved = from_jax_pvrcnn(two_pass["grads_moved"], zero, cfg3)
    got = two_pass["port_grads"]
    assert len(got) > 100
    plain = 0
    for name, g in got.items():
        err = rel(g, want[name])
        assert err <= max(grad_tol(name), 2 * rel(moved[name], want[name])), (
            name, err)
        plain += err <= grad_tol(name)
    assert plain >= 0.8 * len(got), (plain, len(got))


def test_two_pass_batch_norm_buffers_match_jax(two_pass):
    """The buffers moved twice, the second update from the first's
    result, as JAX threads the labeled pass's statistics into the
    unlabeled pass."""
    cfg3 = two_pass["cfg"]["model"]["detector_3d"]
    want = from_jax_pvrcnn(two_pass["state"]["student"]["det3d"]["params"],
                           two_pass["stats"], cfg3)
    start = from_jax_pvrcnn(two_pass["state"]["student"]["det3d"]["params"],
                            two_pass["state"]["student"]["det3d"][
                                "batch_stats"], cfg3)
    sd = two_pass["port"].student["det3d"].state_dict()
    n = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            assert rel(sd[k], v) <= STAT_RTOL, k
            n += not torch.equal(v, start[k])
    assert n > 20


# ----------------------------------------------------------- step_interval

def _optax_chain(kind, lr_fn):
    return (joptim.adamw(lr_fn) if kind == "adamw"
            else joptim.sgd_momentum(lr_fn))


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_step_interval_matches_every_k_steps(kind):
    """Four steps at interval 2 against optax's ``every_k_steps`` under
    the clip and against ``hybrid_optimizer(step_intervals=...)``: the
    update fires on calls 2 and 4 from those calls' gradients alone, and
    the other calls change nothing (parameters, moments, rate count)."""
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (5,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 3 for s in shapes]
             for _ in range(4)]
    lr_j = joptim.warmup_step_lr(0.05, warmup_iters=3)
    lr_p = poptim.warmup_step_lr(0.05, 3)
    tree = {f"p{i}": jnp.asarray(p) for i, p in enumerate(params)}
    txs = (optax.chain(optax.clip_by_global_norm(10.0),
                       joptim.every_k_steps(_optax_chain(kind, lr_j), 2)),
           joptim.hybrid_optimizer(
               lambda p: jax.tree.map(lambda _: "x", p),
               {"x": _optax_chain(kind, lr_j)}, clip_norm=10.0,
               step_intervals={"x": 2}))
    for tx in txs:
        p_j = dict(tree)
        state = tx.init(p_j)
        ts = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
        opt = poptim.BranchOptimizer(ts, kind, lr_p, step_interval=2)
        for call, g in enumerate(grads, 1):
            upd, state = tx.update({f"p{i}": jnp.asarray(x)
                                    for i, x in enumerate(g)}, state, p_j)
            p_j = optax.apply_updates(p_j, upd)
            before = [t.detach().clone() for t in ts]
            for t, x in zip(ts, g):
                t.grad = torch.from_numpy(x)
            opt.step()
            assert opt.calls == call and opt.count == call // 2
            moved = any(not torch.equal(a, t) for a, t in zip(before, ts))
            assert moved == (call % 2 == 0), call
            for i, t in enumerate(ts):
                assert rel(t, p_j[f"p{i}"]) <= OPT_RTOL, (kind, call, i)


def test_ssl_optimizers_take_step_intervals():
    cfg = fx.load_cfg()
    model = fx.build_ssl(cfg, device="cpu")
    opt3d, opt2d = ptrain_ssl.ssl_optimizers(model, 1, step_intervals={
        "det2d": 3})
    assert (opt3d.step_interval, opt2d.step_interval) == (1, 3)


# ----------------------------------------------------------- visualisation

def _scene(rng, n=12):
    boxes = np.concatenate([
        rng.uniform(-5, 75, (n, 1)), rng.uniform(-45, 45, (n, 1)),
        rng.uniform(-2, 0, (n, 1)), rng.uniform(0.5, 5, (n, 3)),
        rng.uniform(-np.pi, np.pi, (n, 1))], -1).astype(np.float32)
    pts = np.concatenate([rng.uniform(-5, 75, (500, 1)),
                          rng.uniform(-45, 45, (500, 1)),
                          rng.uniform(-3, 1, (500, 2))], -1
                         ).astype(np.float32)
    return boxes, pts


def test_bev_canvas_matches_cv2():
    """Boxes inside, across and outside the canvas's edges, with and
    without validity masks, several sets in their colors."""
    rng = np.random.RandomState(0)
    boxes, pts = _scene(rng)
    valid = rng.rand(len(boxes)) > 0.3
    sets = [boxes, (boxes[::-1].copy(), valid)]
    np.testing.assert_array_equal(pvis.bev_canvas(pts, sets),
                                  jvis.bev_canvas(pts, sets))


def test_2d_canvases_match_cv2_outside_text():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (120, 260, 3)).astype(np.uint8)
    k = 10
    xy = rng.uniform(-30, 280, (k, 2))
    b2d = np.concatenate([xy, xy + rng.uniform(2, 90, (k, 2))], -1
                         ).astype(np.float32)
    labels = rng.randint(0, 3, k)
    valid = rng.rand(k) > 0.2
    np.testing.assert_array_equal(
        pvis.draw_boxes_2d(img, b2d, labels=labels, valid=valid),
        jvis.draw_boxes_2d(img, b2d, labels=labels, valid=valid))
    # the pair canvas without its score text, and with it: equal outside
    # the text's rows
    boxes = np.concatenate([rng.uniform(5, 30, (k, 1)),
                            rng.uniform(-8, 8, (k, 1)),
                            np.full((k, 1), -1.0),
                            np.tile([3.9, 1.6, 1.56], (k, 1)),
                            rng.uniform(-3, 3, (k, 1))], -1).astype(np.float32)
    l2i = np.array([[0, -150, 0, 1300], [0, 0, -150, 600], [1, 0, 0, 0],
                    [0, 0, 0, 1]], np.float32)
    shape = np.array([120.0, 260.0], np.float32)
    pair_v = np.ones(k, bool)
    args = (img, boxes, b2d, pair_v, l2i, shape)
    want = jvis.matched_pair_canvas(*args)
    np.testing.assert_array_equal(pvis.matched_pair_canvas(*args), want)
    assert (want != img).any()
    s3, s2 = rng.rand(k, 3), rng.rand(k, 4)
    got = pvis.matched_pair_canvas(*args, scores3d=s3, scores2d=s2)
    assert (got != pvis.matched_pair_canvas(*args)).any()  # text drawn


def test_png_round_trip(tmp_path):
    img = np.random.RandomState(0).randint(0, 255, (7, 9, 3)).astype(
        np.uint8)
    pvis.write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(pvis.read_png(tmp_path / "a.png"), img)
    from PIL import Image
    with Image.open(tmp_path / "a.png") as im:
        np.testing.assert_array_equal(np.asarray(im), img)


# ---------------------------------------------------------------- logging

class _Sink:
    def __init__(self):
        self.entries, self.images, self.closed = [], [], False

    def log(self, entry):
        self.entries.append(entry)

    def log_image(self, tag, img, step):
        self.images.append((tag, step))

    def close(self):
        self.closed = True


def test_multilogger_fans_out_as_jax(tmp_path, capsys):
    """Every sink gets every entry (None sinks dropped), images reach the
    sinks that take them, ``close`` closes all; the JSON lines and the
    val-mode echo equal JAX's."""
    from detmatch_tpu.utils.logging import JsonlLogger as JJsonlLogger
    outs = []
    for multi, jsonl, name in ((MultiLogger, JsonlLogger, "port"),
                               (JMultiLogger, JJsonlLogger, "jax")):
        sink = _Sink()
        path = tmp_path / f"{name}.json"
        logger = multi(jsonl(str(path)), None, sink)
        logger.log(dict(iter=1, mode="train", loss=0.5, time=0.1))
        logger.log(dict(iter=2, mode="val", a=1.0, b=2.0))
        logger.log_image("x", np.zeros((2, 2, 3), np.uint8), 2)
        logger.close()
        assert sink.closed and len(sink.entries) == 2
        assert sink.images == [("x", 2)]
        outs.append((path.read_text(), capsys.readouterr().err))
    assert outs[0] == outs[1]
    assert "eval: 2 metrics logged" in outs[0][1]


@pytest.fixture
def tensorboard_without_tensorflow(monkeypatch):
    """``torch.utils.tensorboard`` on tensorboard's own stub: importing
    tensorflow, where it is installed, costs ~20 s and adds nothing."""
    if "torch.utils.tensorboard" not in sys.modules:
        monkeypatch.setitem(sys.modules, "tensorflow", None)


def test_tensorboard_sink(tmp_path, monkeypatch, capsys,
                          tensorboard_without_tensorflow):
    """Scalars under ``<mode>/<key>`` at ``iter`` (strings skipped);
    without tensorboard, a sink that does nothing and says so once."""
    sink = TensorBoardSink(str(tmp_path / "tb"))
    sink.log(dict(iter=3, mode="train", loss=1.5, note="x"))
    sink.log_image("vis", np.zeros((4, 4, 3), np.uint8), 3)
    sink.close()
    scalars = [(v.tag, e.step, v.simple_value)
               for e in _events(tmp_path / "tb") for v in e.summary.value
               if v.HasField("simple_value")]
    assert scalars == [("train/loss", 3, 1.5)]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    off = TensorBoardSink(str(tmp_path / "off"))
    off.log(dict(iter=1, loss=1.0))
    off.close()
    assert "tensorboard sink disabled" in capsys.readouterr().err
    assert not (tmp_path / "off").exists()


def _events(log_dir):
    """The tensorboard events of the one event file under ``log_dir``
    (TFRecord framing: length, its CRC, the record, its CRC)."""
    import struct
    from tensorboard.compat.proto import event_pb2
    (path,) = [p for p in log_dir.iterdir() if p.name.startswith("events")]
    data, pos, out = path.read_bytes(), 0, []
    while pos < len(data):
        (n,) = struct.unpack("<Q", data[pos:pos + 8])
        out.append(event_pb2.Event.FromString(data[pos + 12:pos + 12 + n]))
        pos += 16 + n
    return out


# ------------------------------------------------ train_ssl_batches' switches

def test_profile_vis_tensorboard_switches(tmp_path, monkeypatch,
                                          tensorboard_without_tensorflow):
    """Two iterations of the tiny SSL detector (the RoI head narrowed, as
    ``test_torch_port_checkpoints.py`` narrows it) with the profile window
    moved to iterations 0-1: a Chrome trace of the model's ops, the three
    PNGs of each iteration at their canvas shapes, and the tensorboard
    events beside ``log.json``."""
    monkeypatch.setattr(ptrain_ssl, "PROFILE_WINDOW", (0, 1))
    cfg = micro_cfg()
    model = fx.build_ssl(cfg, device="cpu")
    rng = np.random.RandomState(0)
    batches = iter([tiny.tiny_ssl_batch(rng) for _ in range(2)])
    work = tmp_path / "work"
    _, _, hist = ptrain_ssl.train_ssl_batches(
        model, fx.build_voxelizer(cfg), batches, str(work), 2,
        batch_size=1, log_interval=1, profile_dir=str(tmp_path / "prof"),
        vis_interval=1, tensorboard=True)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n or "linear" in n or "addmm" in n for n in names)
    canvas = tuple(cfg["model"]["detector_2d"]["canvas"])
    for it in (1, 2):
        for kind, shape in (("bev", (800, 704, 3)), ("2d", canvas + (3,)),
                            ("pairs", canvas + (3,))):
            img = pvis.read_png(work / "vis" / f"iter{it:06d}_{kind}.png")
            assert img.shape == shape, (kind, img.shape)
    losses = [v.simple_value for e in _events(work / "tb")
              for v in e.summary.value if v.tag == "train/loss"]
    np.testing.assert_allclose(losses, [h["loss"] for h in hist],
                               rtol=1e-6)
    assert len((work / "log.json").read_text().splitlines()) == 2
