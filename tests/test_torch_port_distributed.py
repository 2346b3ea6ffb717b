"""The port's data-parallel layer (``detmatch_tpu_torch/parallel``) on the
CPU: N gloo processes against one process on the same global batch.

* the ``parallel`` API: process index and count, the detached and the
  differentiable global sums (the latter's backward), the flat
  all-reduce, ``broadcast_state`` (module, optimizer, generator),
  ``local_shard``, ``global_rows``, ``reduce_logs``, and the refusal of
  two NCCL ranks on one device (the store check, with the device faked);
* ``masked_bn`` (with and without a mask) and ``batch_norm_2d``: forward,
  backward and running statistics, 2 processes against one;
* the global draws: dropout masks, RoI sampling (over a concatenated
  batch too) and the RPN's anchor sampling, 2 processes against one, bit
  for bit;
* the tiny PV-RCNN's train step, 2 processes x B = 1 against JAX's
  2-device mesh on the same B = 2 batch (``tests/test_multichip.py``'s
  case): the discrete outputs exactly, the loss terms within 1e-4 and
  every gradient within 1e-3 of its largest magnitude (JAX's own 1 <-> N
  study bounds its spread at 3.5e-3 abs, ``test_multichip.py:40``).
  JAX's RoI picks and dropout masks are handed to the port, as in
  ``test_torch_port_train_step.py``.

Each spawn of workers (``torch_port_dist_fixture.run_workers``) runs once
per module and every test reads it.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from detmatch_tpu.models.pvrcnn import roi_head as jroi  # noqa: E402
from detmatch_tpu.models.pvrcnn.pvrcnn import PVRCNN as JPVRCNN  # noqa: E402
from detmatch_tpu.ops import voxelize as jvox  # noqa: E402
from detmatch_tpu.utils import tiny  # noqa: E402
from detmatch_tpu_torch import parallel  # noqa: E402
from detmatch_tpu_torch.convert import from_jax_pvrcnn  # noqa: E402
from detmatch_tpu_torch.models import layers  # noqa: E402
from detmatch_tpu_torch.models.frcnn import rpn as prpn  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn import roi_head as proi  # noqa: E402
from detmatch_tpu_torch.parallel import distributed as D  # noqa: E402
from torch_port_dist_fixture import run_workers  # noqa: E402
import torch_port_ssl_fixture as fx  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

BN_RTOL = 1e-5     # two-pass sums over 2 x 4 rows in another order
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3    # of each tensor's largest magnitude
STAT_RTOL = 1e-4


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else ref
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


# ------------------------------------------------------- the primitives

def _inputs():
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    inp = dict(
        x2d=t(rng.randn(8, 5) * 2 + 1), mask=torch.from_numpy(
            np.array([1, 1, 0, 1, 0, 0, 1, 1], bool)),
        w2d=t(rng.randn(8, 5)), x4d=t(rng.randn(4, 3, 3, 3) + 0.5),
        w4d=t(rng.randn(4, 3, 3, 3)), gamma=t(1 + 0.1 * rng.randn(5)),
        beta=t(0.1 * rng.randn(5)), drop=t(rng.randn(6, 3, 5)))
    # RoI sampling: 4 global samples (2 labeled + 2 unlabeled), 24
    # proposals each, jittered around the gts
    b, g, n = 4, 6, 24
    gt = np.zeros((b, g, 8), np.float32)
    gt[:, :4, 0] = rng.rand(b, 4) * 20 + 5
    gt[:, :4, 1] = rng.rand(b, 4) * 10 - 5
    gt[:, :4, 2] = -1.0
    gt[:, :4, 3:6] = [3.9, 1.6, 1.56]
    gt[:, :4, 6] = rng.rand(b, 4) - 0.5
    gt[:, :4, 7] = rng.randint(1, 4, (b, 4))
    src = rng.randint(0, 4, (b, n))
    rois = np.take_along_axis(gt[..., :7], src[..., None], 1).copy()
    rois[..., :3] += rng.randn(b, n, 3).astype(np.float32) * \
        rng.choice([0.1, 0.6, 2.5], (b, n, 1))
    labels = np.take_along_axis(gt[..., 7], src, 1).astype(np.int32)
    inp["props"] = dict(rois=t(rois), roi_labels=torch.from_numpy(labels),
                        roi_scores=t(rng.rand(b, n)),
                        roi_scores_full=t(rng.randn(b, n, 3)))
    inp["gt"] = t(gt)
    # the RPN: one level of 4 x 4 x 3 anchors, 2 global images
    xy = rng.rand(48, 2) * 60
    inp["anchors"] = t(np.concatenate([xy, xy + 8 + rng.rand(48, 2) * 16],
                                      1))
    gt2 = inp["anchors"][rng.choice(48, (2, 4))].numpy() + rng.randn(
        2, 4, 4).astype(np.float32)
    inp["rpn"] = dict(cls=t(rng.randn(2, 4, 4, 3)),
                      reg=t(0.1 * rng.randn(2, 4, 4, 12)), gt=t(gt2),
                      gt_valid=torch.from_numpy(np.arange(4)[None].repeat(
                          2, 0) < 3))
    return inp


def _bn1d(inp):
    bn = torch.nn.BatchNorm1d(5, eps=1e-3, momentum=0.01)
    with torch.no_grad():
        bn.weight.copy_(inp["gamma"])
        bn.bias.copy_(inp["beta"])
    return bn.train()


def bn_case(inp, case, rows=slice(None)):
    """One batch-norm case on ``rows`` of the global inputs: (y, dx,
    dgamma, dbeta, running mean, running var); the loss is a weighted
    sum of the output."""
    if case == "bn2d":
        bn = torch.nn.BatchNorm2d(3, eps=1e-3, momentum=0.01).train()
        with torch.no_grad():
            bn.weight.copy_(inp["gamma"][:3])
            bn.bias.copy_(inp["beta"][:3])
        x = inp["x4d"][rows].clone().requires_grad_(True)
        y = layers.batch_norm_2d(bn, x)
        w = inp["w4d"][rows]
    else:
        bn = _bn1d(inp)
        x = inp["x2d"][rows].clone().requires_grad_(True)
        y = layers.masked_bn(bn, x, inp["mask"][rows]
                             if case == "masked" else None)
        w = inp["w2d"][rows]
    (y * w).sum().backward()
    parallel.all_reduce_grads(bn.parameters())
    return [t.detach().clone() for t in (y, x.grad, bn.weight.grad,
                                         bn.bias.grad, bn.running_mean,
                                         bn.running_var)]


def draw_cases(inp, rows=slice(None), parts=(2, 4), lab=2):
    """The global draws on ``rows`` (the plain batch) or on this
    process's parts of a concatenated one: dropout masks, RoI picks and
    the RPN's samples."""
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    x = inp["drop"]
    out = dict(drop=layers.dropout(x[rows], 0.3, gen()))
    # labeled rows [0, lab), unlabeled [lab, 6): this process's of each
    n, r = parallel.process_count(), parallel.process_index()
    pl, pu = lab // n, (6 - lab) // n
    cat = torch.cat([x[r * pl:(r + 1) * pl], x[lab + r * pu:
                                              lab + (r + 1) * pu]])
    out["drop_parts"] = layers.dropout(cat, 0.3, gen(), (pl, pu))
    pick = [r * 1, 2 + r * 1] if n == 2 else [0, 1, 2, 3]
    props = {k: v[pick] for k, v in inp["props"].items()}
    cfg = dict(proi.default_target_cfg(), roi_per_image=16)
    t = proi.assign_roi_targets(gen(), props, inp["gt"][pick], cfg,
                                row_groups=2)
    out["rois"] = {k: t[k] for k in ("rois", "roi_labels", "roi_ious",
                                     "reg_valid_mask", "rcnn_cls_labels",
                                     "gt_of_rois")}
    c = inp["rpn"]
    rows2 = [r] if n == 2 else [0, 1]
    out["rpn"] = parallel.reduce_logs(prpn.rpn_loss(
        gen(), [(c["cls"][rows2], c["reg"][rows2])], [inp["anchors"]],
        c["gt"][rows2], c["gt_valid"][rows2], num_samples=16))
    return out


PRIMITIVES = """
from torch import distributed as dist
from detmatch_tpu_torch.parallel import distributed as D
from detmatch_tpu_torch.train.optim import BranchOptimizer
import test_torch_port_distributed as T

inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
res = dict(index=parallel.process_index(), count=parallel.process_count(),
           primary=parallel.is_primary(),
           gsum=parallel.global_sum(torch.tensor([1.0, rank])),
           rows=parallel.global_rows(3, (1, 2)),
           order=parallel.rows_in_global_order(2, 2),
           shard=parallel.local_shard(dict(a=np.arange(6).reshape(6, 1),
                                           n=[torch.arange(4)], s="x")),
           logs=parallel.reduce_logs(dict(x=torch.tensor(rank + 1.0), s=3,
                                          c=torch.tensor(2)), ("s",)))
# the differentiable sum: its backward sums the gradient over processes
x = torch.tensor([1.0 + rank, 2.0], requires_grad=True)
y = parallel.global_sum_grad(x * x)
(y * torch.tensor([1.0, 3.0 + rank])).sum().backward()
res["sum_grad"] = (y.detach(), x.grad)
res["flat"] = parallel.all_reduce_flat(
    [torch.full((2, 3), rank + 1.0), torch.arange(4.0) * rank,
     torch.tensor([rank + 5])])
# broadcast: every process's state made process 0's
torch.manual_seed(10 + rank)
mod = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
mod[1].running_mean.fill_(rank)
opt = BranchOptimizer(mod.parameters(), "adamw", lambda c: torch.tensor(1.0))
opt.count, opt.calls, opt.skipped = 3 + rank, 4 + rank, rank
for m in opt.mu:
    m.fill_(rank + 0.5)
gen = torch.Generator().manual_seed(rank)
parallel.broadcast_state(mod, opt, gen)
res["bcast"] = dict(state={k: v.clone() for k, v in
                           mod.state_dict().items()},
                    opt=opt.state_dict(), draw=torch.rand(3, generator=gen))
res["bn"] = {c: T.bn_case(inp, c, slice(rank * 4, rank * 4 + 4) if c != "bn2d"
                          else slice(rank * 2, rank * 2 + 2))
             for c in ("masked", "unmasked", "bn2d")}
res["draws"] = T.draw_cases(inp, slice(rank * 3, rank * 3 + 3))
# two processes on one CUDA device (faked): both refuse; on two, neither
shared = []
for k, device in enumerate((lambda: 0, lambda: rank)):
    torch.cuda.current_device = device
    store = dist.FileStore(os.path.join(out, f"devices{k}"), world)
    try:
        D._refuse_shared_devices(store, world, rank)
        shared.append(None)
    except RuntimeError as e:
        shared.append(str(e))
res["shared"] = shared
save(res)
"""


@pytest.fixture(scope="module")
def prim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prim")
    inp = _inputs()
    torch.save(inp, tmp / "inputs.pt")
    return inp, run_workers(tmp, PRIMITIVES)


def test_init_distributed_is_a_no_op_for_one_process(monkeypatch):
    for k in ("DETMATCH_COORDINATOR", "DETMATCH_NUM_PROCESSES",
              "DETMATCH_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.init_distributed() is False
    assert parallel.init_distributed("localhost:1", 1, 0) is False
    monkeypatch.setenv("DETMATCH_NUM_PROCESSES", "1")
    assert parallel.init_distributed("localhost:1") is False
    monkeypatch.setenv("DETMATCH_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="process's id"):
        parallel.init_distributed("localhost:1")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        parallel.start_group("localhost:1", 2, 0, backend="nccl")
    assert parallel.process_count() == 1 and parallel.is_primary()
    x = torch.arange(3.0, requires_grad=True)
    assert parallel.global_sum_grad(x) is x
    assert parallel.global_rows(4, (1, 3)) == ([0, 1, 2, 3], 4)


def test_process_api(prim):
    _, res = prim
    for r, got in enumerate(res):
        assert (got["index"], got["count"], got["primary"]) == (r, 2, r == 0)
        assert got["gsum"].tolist() == [2.0, 1.0]
        np.testing.assert_array_equal(got["shard"]["a"][:, 0],
                                      [3 * r, 3 * r + 1, 3 * r + 2])
        assert got["shard"]["n"][0].tolist() == [2 * r, 2 * r + 1]
        assert got["shard"]["s"] == "x"
        assert float(got["logs"]["x"]) == 3.0 and got["logs"]["s"] == 3
        assert float(got["logs"]["c"]) == 4.0
    # 1 labeled + 2 unlabeled rows a process: [l0, l1 | u0 u1, u2 u3]
    assert res[0]["rows"] == ([0, 2, 3], 6)
    assert res[1]["rows"] == ([1, 4, 5], 6)
    assert res[0]["order"] == [0, None, 1, None]
    assert res[1]["order"] == [None, 0, None, 1]


def test_local_shard_refuses_an_uneven_batch(monkeypatch):
    monkeypatch.setattr(D, "process_count", lambda: 2)
    monkeypatch.setattr(D, "process_index", lambda: 1)
    got = parallel.local_shard({"a": np.arange(4)})
    np.testing.assert_array_equal(got["a"], [2, 3])
    with pytest.raises(ValueError, match="3 rows over 2"):
        parallel.local_shard({"a": np.arange(3)})


def test_global_sum_grad_backward_sums_over_processes(prim):
    """y = sum_r x_r^2, loss_r = <y, w_r>: d(sum_r loss_r)/dx_r =
    2 x_r * sum_r w_r, on each process its own."""
    _, res = prim
    w = torch.tensor([1.0, 3.0]) + torch.tensor([1.0, 3.0 + 1])
    for r, got in enumerate(res):
        y, g = got["sum_grad"]
        assert y.tolist() == [1.0 + 4.0, 8.0]
        x = torch.tensor([1.0 + r, 2.0])
        assert torch.equal(g, 2 * x * w)


def test_flat_all_reduce_and_broadcast(prim):
    _, res = prim
    for got in res:
        a, b, c = got["flat"]
        assert torch.equal(a, torch.full((2, 3), 3.0))
        assert torch.equal(b, torch.arange(4.0))
        assert c.tolist() == [11] and c.dtype == torch.int64
        assert got["bcast"]["opt"]["count"] == 3
        assert got["bcast"]["opt"]["calls"] == 4
        assert got["bcast"]["opt"]["skipped"] == 0
        assert all(float(m.max()) == 0.5 for m in got["bcast"]["opt"]["mu"])
    s0, s1 = (r["bcast"]["state"] for r in res)
    assert s0.keys() == s1.keys()
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert float(s0["1.running_mean"].max()) == 0.0
    assert torch.equal(res[0]["bcast"]["draw"], res[1]["bcast"]["draw"])
    assert torch.equal(res[0]["bcast"]["draw"], torch.rand(
        3, generator=torch.Generator().manual_seed(0)))


def test_two_nccl_ranks_on_one_device_raise(prim):
    _, res = prim
    for r, got in enumerate(res):
        assert "2 processes share a CUDA device" in got["shared"][0]
        assert f"process {r}" in got["shared"][0]
        assert got["shared"][1] is None


@pytest.mark.parametrize("case", ["masked", "unmasked", "bn2d"])
def test_global_batch_norm_matches_one_process(prim, case):
    """Output rows, input gradient rows, the parameters' summed
    gradients and the running statistics (equal on both processes)."""
    inp, res = prim
    ref = bn_case(inp, case)
    half = 4 if case != "bn2d" else 2
    names = ("y", "dx", "dgamma", "dbeta", "running_mean", "running_var")
    for r, got in enumerate(res):
        rows = slice(r * half, (r + 1) * half)
        for name, g, want in zip(names, got["bn"][case], ref):
            if name in ("y", "dx"):
                want = want[rows]
            assert rel(g, want) <= BN_RTOL, (case, name, r)
    for a, b in zip(res[0]["bn"][case][2:], res[1]["bn"][case][2:]):
        assert torch.equal(a, b)


def test_global_draws_match_one_process(prim):
    """Dropout masks (a plain and a concatenated batch), the RoI picks of
    a labeled + unlabeled batch and the RPN's anchor samples: each
    process's rows equal one process's bit for bit."""
    inp, res = prim
    ref = draw_cases(inp)
    r0, r1 = (r["draws"] for r in res)
    assert torch.equal(torch.cat([r0["drop"], r1["drop"]]), ref["drop"])
    # one process's concatenation [l0 l1 | u0..u3]; process r holds
    # [l_r | u_2r u_2r+1]
    d = ref["drop_parts"]
    for r, got in enumerate((r0, r1)):
        assert torch.equal(got["drop_parts"],
                           d[[r, 2 + 2 * r, 3 + 2 * r]])
    # RoIs: one process [l0 l1 u0 u1] (2 + 2 rows); process r [l_r u_r]
    for k, v in ref["rois"].items():
        for r, got in enumerate((r0, r1)):
            assert torch.equal(got["rois"][k], v[[r, 2 + r]]), k
    assert ref["rois"]["reg_valid_mask"].any()
    for k, v in ref["rpn"].items():
        for got in (r0, r1):
            assert rel(got["rpn"][k], v) <= 1e-6, k
    assert float(ref["rpn"]["loss_rpn_bbox"]) > 0


# ------------------------------------------- the tiny PV-RCNN against JAX

CFG = tiny.TINY_PV_CFG   # dropout 0.3 in the RoI head, as JAX's test
B = 2


def _jax_batch():
    rng = np.random.RandomState(0)
    view = tiny.tiny_view(rng, b=B, p=256, with_gt=True)
    valid = np.asarray(view["points_valid"]).copy()
    valid[1, 180:] = False
    vox = jax.vmap(lambda p, v: jvox.voxelize_mean(p, v, tiny.TINY_SPEC))(
        jnp.asarray(view["points"]), jnp.asarray(valid))
    return dict(points=np.asarray(view["points"]), points_valid=valid,
                gt_boxes=np.asarray(view["gt_boxes"]).copy(),
                voxel_features=np.asarray(vox["features"]),
                voxel_keys=np.asarray(vox["keys"]))


def _gt_near(out, gt):
    """The first three gt rows of each sample on its three best
    proposals (shifted, grown, turned a little): RoI foreground."""
    props = out["proposals"]
    gt = gt.copy()
    box = props["rois"][:, :3].copy()
    box[..., 0] += 0.15
    box[..., 3:6] *= 1.05
    box[..., 6] += 0.05
    gt[:, :3, :7] = box
    gt[:, :3, 7] = props["roi_labels"][:, :3]
    return gt


@pytest.fixture(scope="module")
def jmesh():
    """JAX's train step on a 2-device mesh (batch sharded, parameters
    replicated): losses, gradients, new statistics, the forward's
    outputs, the sampling key and the dropout masks drawn."""
    batch = _jax_batch()
    model = JPVRCNN(**CFG)
    var = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b,
                                       train=False))(
        jax.tree.map(jnp.asarray, batch))
    params = jax.tree.map(np.asarray, var["params"])
    srng = np.random.RandomState(1)

    def rand_stat(path, x):
        if path[-1].key == "var":
            return (0.5 + srng.rand(*x.shape)).astype(np.float32)
        return (0.2 * srng.randn(*x.shape)).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(
        rand_stat, jax.tree.map(np.asarray, var["batch_stats"]))
    captured, masks = {}, fx.DropoutMasks()
    assign = jroi.assign_roi_targets

    def spy(rng_key, proposals, gt_boxes, cfg=None):
        captured["key"] = rng_key
        return assign(rng_key, proposals, gt_boxes, cfg)

    def loss_fn(p, s, b, rng):
        v = {"params": p, "batch_stats": s}
        out, mut = model.apply(v, b, train=True,
                               rngs={"sampling": rng, "dropout": rng},
                               mutable=["batch_stats"])
        losses = model.apply(v, out, b, method=JPVRCNN.loss)
        return losses["loss"], (losses, mut["batch_stats"], out,
                                captured["key"], list(masks.traced))

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    repl, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   in_shardings=(repl, repl, shard, repl))
    key = jax.random.PRNGKey(7)
    with pytest.MonkeyPatch.context() as mp, mesh:
        mp.setattr(jroi, "assign_roi_targets", spy)
        rec = masks.recording()
        try:
            first = step(params, stats, jax.tree.map(jnp.asarray, batch),
                         key)[0][1][2]
            batch["gt_boxes"] = _gt_near(jax.tree.map(np.asarray, first),
                                         batch["gt_boxes"])
            (_, (losses, new_stats, out, skey, drawn)), grads = step(
                params, stats, jax.tree.map(jnp.asarray, batch), key)
        finally:
            rec.undo()
    return dict(batch=batch, params=params, stats=stats,
                losses=jax.tree.map(np.asarray, losses),
                new_stats=jax.tree.map(np.asarray, new_stats),
                out=jax.tree.map(np.asarray, out),
                key=np.asarray(jax.random.key_data(skey))
                if jnp.issubdtype(skey.dtype, jax.dtypes.prng_key)
                else np.asarray(skey),
                masks=[np.asarray(m) for m in drawn],
                grads=jax.tree.map(np.asarray, grads))


PVRCNN_STEP = """
import jax, jax.numpy as jnp
from detmatch_tpu_torch.models.pvrcnn import roi_head as proi
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import PVRCNN
import torch_port_ssl_fixture as fx

ref = torch.load(os.path.join(out, "ref.pt"), weights_only=False)
model = PVRCNN(**ref["cfg"]).train()
model.load_state_dict(ref["state"])
proi._pick = fx.roi_picks(jnp.asarray(ref["key"]), ref["b"])
masks = iter(ref["masks"])


def dropout(x, p, generator, row_groups=1):
    # JAX's mask at the global shape, this process's rows
    rows, _ = parallel.global_rows(x.shape[0], row_groups)
    keep = torch.from_numpy(next(masks))[rows]
    return torch.where(keep, x / (1.0 - p), 0.0)


proi.dropout = dropout
batch = {k: torch.from_numpy(v)
         for k, v in parallel.local_shard(ref["batch"]).items()}
out_ = model(batch, train=True, generator=torch.Generator())
losses = model.loss(out_, batch)
losses["loss"].backward()
parallel.all_reduce_grads(model.parameters())
t = out_["roi_targets"]
save(dict(losses={k: float(v) for k, v in parallel.reduce_logs(
              {k: v.detach() for k, v in losses.items()}).items()},
          grads={n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None},
          state={k: v.clone() for k, v in model.state_dict().items()},
          discrete=dict(roi_labels=out_["roi_labels"],
                        prop_labels=out_["proposals"]["roi_labels"],
                        prop_valid=out_["proposals"]["roi_valid"],
                        kp_valid=out_["kp_valid"],
                        reg_valid_mask=t["reg_valid_mask"]),
          rois=out_["rois"].detach()))
"""


@pytest.fixture(scope="module")
def port2(jmesh, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pvrcnn")
    torch.save(dict(cfg=CFG, b=B, key=jmesh["key"], masks=jmesh["masks"],
                    batch=jmesh["batch"],
                    state=from_jax_pvrcnn(jmesh["params"], jmesh["stats"],
                                          CFG)), tmp / "ref.pt")
    return run_workers(tmp, PVRCNN_STEP, timeout=240)


def test_pvrcnn_step_draws_and_discrete_outputs_match_jax_mesh(jmesh, port2):
    o = jmesh["out"]
    assert len(jmesh["masks"]) > 0 and jmesh["masks"][0].shape[0] == B
    want = dict(roi_labels=o["roi_labels"],
                prop_labels=o["proposals"]["roi_labels"],
                prop_valid=o["proposals"]["roi_valid"], kp_valid=o["kp_valid"],
                reg_valid_mask=o["roi_targets"]["reg_valid_mask"])
    assert want["reg_valid_mask"].any()
    for k, v in want.items():
        got = torch.cat([r["discrete"][k] for r in port2]).numpy()
        np.testing.assert_array_equal(got, v, err_msg=k)
    rois = torch.cat([r["rois"] for r in port2])
    assert rel(rois, o["rois"]) <= LOSS_RTOL


def test_pvrcnn_step_losses_match_jax_mesh(jmesh, port2):
    for r in port2:
        assert r["losses"].keys() == jmesh["losses"].keys()
        for k, v in jmesh["losses"].items():
            assert abs(r["losses"][k] - float(v)) <= LOSS_RTOL * abs(
                float(v)), (k, r["losses"][k], float(v))


def test_pvrcnn_step_gradients_and_statistics_match_jax_mesh(jmesh, port2):
    zero = jax.tree.map(np.zeros_like, jmesh["stats"])
    ref = from_jax_pvrcnn(jmesh["grads"], zero, CFG)
    g0, g1 = port2[0]["grads"], port2[1]["grads"]
    assert g0.keys() == g1.keys() and len(g0) > 0
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name
        assert rel(g, ref[name].numpy()) <= GRAD_TOL, name
    ref_stats = from_jax_pvrcnn(jmesh["params"], jmesh["new_stats"], CFG)
    n = 0
    for k, v in ref_stats.items():
        if k.endswith(("running_mean", "running_var")):
            for r in port2:
                assert rel(r["state"][k], v.numpy()) <= STAT_RTOL, k
            n += 1
    assert n > 0
