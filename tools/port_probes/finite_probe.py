"""Where the learning study's DetMatch arm first goes non-finite, on one
card.

Trains arm B of ``detmatch_tpu_torch/tools/misc/learning_study.py``
exactly as the study does (``make_data``, ``build_cfg`` with
``ssl_weight=1``, seed 0, ``run_training`` → ``train_ssl`` on the window
conv path) and wraps each iteration (``apis/train_ssl._iteration``)
without changing the package's code:

* before the iteration it copies the state (the detector's state dict,
  student and teacher, running statistics included; both optimizers'
  moments and counters), the generator's state and the collated batch;
* after it, one flat check on the card: every logged value, each
  branch's gradient flag (``BranchOptimizer.step``'s ``finite``: a rise
  of its ``skipped``), the largest magnitude of every batch-norm running
  statistic of the student and the teacher, and of every parameter;
* it logs the teacher's 3D detections a frame before and after
  ``max_score_filter`` (the fusion's input), their largest class score a
  frame, the 2D ones, and ``metrics.num_tea_hung``.

At the first non-finite value it stops training (``--study``: analyses
it, runs the iteration again from its start as it first ran, and goes
on) and replays that iteration from the copied state twice:

1. under a ``TorchFunctionMode`` that checks every torch call's floating
   outputs: a call whose output is non-finite while its inputs are finite
   starts a *source*; calls that consume a non-finite tensor carry its
   source on. The logged losses, the running statistics and the
   parameters that end non-finite name the sources that reach them; the
   earliest such source is the first non-finite value, reported with its
   call, its place in the code, the module whose ``forward`` ran it, and
   the non-finite elements. Sources cleared before any of those (masked
   sentinels) are listed apart;
2. under ``torch.autograd.detect_anomaly``, which names the first
   backward function that returns NaN and the forward call behind it;
   this replay also counts the calls as the first did and, at the first
   non-finite value's call, keeps its inputs and the tensors of every
   package frame around it (the inputs of the functions that ran it).

Writes to OUT_DIR (default ``build/finite_probe``):
``iterations.jsonl`` (one row an iteration), ``first_nonfinite.json``
(the verdict) and ``first_nonfinite.npz`` (replay 2's dump, a few MB);
the step's state at the start of that iteration (the detector's state
dict, both optimizers' moments and counters, the generator's state and
the collated batch; ~0.7 GB at the study's widths) goes beside the data
root's tree, as ``first_nonfinite_state.pt``.
``--study REPORT`` runs the study's whole arm (``learning_study --arm``:
training, recalibration with a check of every running statistic after
it, evaluation) with these checks attached and writes its report to
REPORT once the data root holds both arms, with the small files of its
data root (``evals.json``, the arm's ``log.json`` and ``run.json``) to
OUT_DIR; ``--carry-labonly RECORD`` takes arm A's results from a study
record (:func:`carry_labonly`). ``--arm labonly`` trains arm A instead
(the SSL weight 0; its teacher phase still runs and is logged). Run from the repository root, with one card
visible:

    python3 tools/port_probes/finite_probe.py [--iters N] [--out-dir DIR]
        [--data-root DIR] [--device cuda|cpu]
        [--arm ssl|labonly] [--study REPORT [--carry-labonly RECORD]]

``--iters`` (default 2,000) caps the run when nothing goes non-finite
(not with ``--study``).
Prints a progress line every 75 iterations and, last, one JSON line.
"""
from __future__ import annotations

import argparse
import copy
import inspect
import json
import math
import os
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

PKG = "detmatch_tpu_torch"
# calls whose output is uninitialised memory, not a computed value
UNINITIALISED = {"empty", "empty_like", "new_empty", "empty_strided",
                 "new_empty_strided"}
FRAME_BYTES = 4 << 20     # tensor bytes kept of one frame's locals
FRAMES_BYTES = 24 << 20   # ... of all the package frames around a source
CHAIN = 12                # calls kept of a source's chain


class Done(Exception):
    """Raised from the wrapped iteration at the iteration cap."""


class FirstEvent(Exception):
    """Raised from the wrapped iteration at its first non-finite value."""

    def __init__(self, row, snap, args):
        super().__init__(f"non-finite at iteration {row['iter']}")
        self.row, self.snap, self.args = row, snap, args


# ---- the state at the start of an iteration ----

def _opt_lists(opt):
    return [t for k in ("mu", "nu", "trace") for t in getattr(opt, k, [])]


class Snapshot:
    """Preallocated copies of the detector's state dict, both optimizers'
    moments and counters, the generator's state and the batch."""

    def __init__(self, ssl, opts):
        self.keys = list(ssl.state_dict().keys())
        sd = ssl.state_dict()
        self.state = [sd[k].detach().clone() for k in self.keys]
        self.moments = [[t.clone() for t in _opt_lists(o)] for o in opts]
        self.counters = None
        self.gen = self.batch = self.it = None

    def take(self, ssl, opts, generator, batch_np, it):
        sd = ssl.state_dict()
        torch._foreach_copy_(self.state, [sd[k] for k in self.keys])
        for dst, o in zip(self.moments, opts):
            torch._foreach_copy_(dst, _opt_lists(o))
        self.counters = [(o.count, o.calls, o.skipped) for o in opts]
        self.gen = generator.get_state()
        self.batch = copy.deepcopy(batch_np)
        self.it = it

    def restore(self, ssl, opts, generator):
        sd = ssl.state_dict()
        torch._foreach_copy_([sd[k] for k in self.keys], self.state)
        for src, o in zip(self.moments, opts):
            torch._foreach_copy_(_opt_lists(o), src)
        for (count, calls, skipped), o in zip(self.counters, opts):
            o.count, o.calls, o.skipped = count, calls, skipped
        generator.set_state(self.gen)

    def state_dict(self):
        return dict(zip(self.keys, self.state))


# ---- the per-iteration checks ----

def _running_stats(module):
    return [(n, b) for n, b in module.named_buffers()
            if n.endswith(("running_mean", "running_var")) and b.numel()]


def _params(module):
    return [(n, p) for n, p in module.named_parameters() if p.numel()]


class Recorder:
    """The teacher's sets at ``max_score_filter`` (patched in by
    :func:`patched_filter`) of the running iteration."""

    def __init__(self):
        self.calls = []


def patched_filter(recorder):
    from detmatch_tpu_torch.ssl import boxset
    orig = boxset.max_score_filter

    def max_score_filter(bs, score_thr):
        out = orig(bs, score_thr)
        recorder.calls.append((bs, out))
        return out

    boxset.max_score_filter = max_score_filter
    return lambda: setattr(boxset, "max_score_filter", orig)


def teacher_stats(calls):
    """[(kind, before a frame, after a frame, largest score a frame)] as
    tensors (one sync later), kind "3d" (boxes of 7) or "2d"."""
    out = []
    for bs, kept in calls:
        kind = "3d" if bs["boxes"].shape[-1] == 7 else "2d"
        top = torch.where(bs["valid"], bs["scores"].amax(-1),
                          torch.full_like(bs["scores"][..., 0], -1.0))
        out.append((kind, bs["valid"].sum(-1), kept["valid"].sum(-1),
                    top.amax(-1)))
    return out


def magnitudes(named):
    """The largest |x| of each tensor (NaN where one is NaN) as one
    tensor."""
    ts = [t.detach() for _, t in named]
    return torch.stack(torch._foreach_norm(ts, ord=float("inf")))


class Checker:
    def __init__(self, ssl):
        self.groups = dict(
            student_bn=_running_stats(ssl.student),
            teacher_bn=_running_stats(ssl.teacher),
            student_params=_params(ssl.student),
            teacher_params=_params(ssl.teacher))

    def check(self):
        """{group: [names of non-finite tensors]} in one sync."""
        mags = {g: magnitudes(v) for g, v in self.groups.items()}
        flags = torch.cat([torch.isfinite(m) for m in mags.values()]).cpu()
        bad, i = {}, 0
        for g, named in self.groups.items():
            f = flags[i:i + len(named)]
            i += len(named)
            bad[g] = [named[j][0] for j in np.flatnonzero(~f.numpy())]
        return bad


# ---- the provenance replay ----

def _tensors(x, out=None):
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _finite(t):
    return bool(torch.isfinite(t).all()) if t.numel() else True


def _repo_frames(limit=8):
    frames = [f for f in traceback.extract_stack() if PKG in f.filename]
    return [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}:{f.name}"
            for f in frames[-limit:]]


def _package_frames():
    """The package's frames on the stack, innermost first."""
    f, out = inspect.currentframe(), []
    while f is not None:
        if PKG in f.f_code.co_filename:
            out.append(f)
        f = f.f_back
    return out


def _module_of(names):
    """The innermost ``forward`` on the stack whose ``self`` is a module of
    the detector: its qualified name."""
    f = inspect.currentframe()
    while f is not None:
        me = f.f_locals.get("self")
        if isinstance(me, torch.nn.Module) and id(me) in names:
            return names[id(me)]
        f = f.f_back
    return None


def _frame_tensors(frame, budget=FRAME_BYTES):
    """The tensor locals of ``frame`` (dict and list entries one level
    down) as CPU numpy arrays, within ``budget`` bytes."""
    out, used = {}, 0
    items = []
    for k, v in frame.f_locals.items():
        if isinstance(v, torch.Tensor):
            items.append((k, v))
        elif isinstance(v, dict):
            items += [(f"{k}.{kk}", vv) for kk, vv in v.items()
                      if isinstance(vv, torch.Tensor)]
        elif isinstance(v, (list, tuple)):
            items += [(f"{k}.{i}", vv) for i, vv in enumerate(v)
                      if isinstance(vv, torch.Tensor)]
        elif hasattr(v, "_asdict"):
            items += [(f"{k}.{kk}", vv) for kk, vv in v._asdict().items()
                      if isinstance(vv, torch.Tensor)]
    for k, v in items:
        n = v.numel() * v.element_size()
        if used + n > budget:
            continue
        used += n
        out[k] = v.detach().cpu().numpy()
    return out


def _nonfinite_at(t, k=8):
    """The first ``k`` non-finite elements of ``t``: [(index, value)]."""
    bad = (~torch.isfinite(t)).nonzero()[:k].tolist()
    flat = t.detach()
    return [(i, float(flat[tuple(i)])) for i in bad]


class Provenance(TorchFunctionMode):
    """Tags every non-finite floating output with its source (see the
    module docstring). With ``dump_at`` (a source's ``op_index`` from an
    earlier replay of the same iteration) it only counts the calls, and
    at that call keeps its inputs and the tensors of the package frames
    around it (``dump``)."""

    def __init__(self, module_names, dump_at=None):
        super().__init__()
        self.names = module_names
        self.sources = []      # dicts, in order of appearance
        self.places = {}       # place -> source count
        self.ops = 0
        self.dump_at = dump_at
        self.dump = None

    def _new_source(self, fname, ins, bad, untracked):
        frames = _repo_frames()
        place = frames[-1] if frames else fname
        src = dict(id=len(self.sources), call=fname, place=place,
                   stack=frames, module=_module_of(self.names),
                   op_index=self.ops, untracked_inputs=untracked,
                   output_shapes=[list(t.shape) for t in bad],
                   nonfinite=[dict(nan=int(torch.isnan(t).sum()),
                                   inf=int(torch.isinf(t).sum()),
                                   first=_nonfinite_at(t)) for t in bad],
                   chain=[], reached=[])
        self.places[place] = self.places.get(place, 0) + 1
        self.sources.append(src)
        return src["id"]

    def _dump(self, fname, ins, outs):
        arrays = {f"op.in{i}": t.detach().cpu().numpy()
                  for i, t in enumerate(ins)
                  if t.numel() * t.element_size() <= FRAME_BYTES}
        frames, left = [], FRAMES_BYTES
        for depth, fr in enumerate(_package_frames()):
            name = fr.f_code.co_name
            frames.append(
                f"{os.path.relpath(fr.f_code.co_filename, ROOT)}:{name}")
            got = _frame_tensors(fr, min(FRAME_BYTES, left))
            left -= sum(a.nbytes for a in got.values())
            arrays.update({f"frame{depth}.{name}.{k}": v
                           for k, v in got.items()})
        self.dump = dict(call=fname, frames=frames, arrays=arrays,
                         output_nonfinite=not all(_finite(t) for t in outs))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fname = getattr(func, "__name__", None) or str(func)
        if fname in UNINITIALISED or fname == "__get__":
            return out
        outs = [t for t in _tensors(out) if t.is_floating_point()]
        in_place = fname.endswith("_") and not fname.startswith("__")
        if out is None or in_place or fname == "__setitem__":
            outs += [t for t in _tensors(args[:1]) if t.is_floating_point()]
        if not outs:
            return out
        self.ops += 1
        ins = [t for t in _tensors((args, kwargs))
               if t.is_floating_point() and all(t is not o for o in outs)]
        if self.dump_at is not None:
            if self.ops == self.dump_at:
                self._dump(fname, ins, outs)
            return out
        bad = [t for t in outs if not _finite(t)]
        if not bad:
            return out
        # an in-place call's target may carry a source already
        src = next((getattr(t, "_probe_src", None) for t in ins + outs
                    if getattr(t, "_probe_src", None) is not None), None)
        if src is None:
            untracked = [i for i, t in enumerate(ins) if not _finite(t)]
            src = self._new_source(fname, ins, bad, untracked)
        elif len(self.sources[src]["chain"]) < CHAIN:
            fr = _repo_frames(1)
            self.sources[src]["chain"].append(
                f"{fname} @ {fr[0] if fr else '?'}")
        for t in bad:
            try:
                t._probe_src = src
            except (AttributeError, RuntimeError):
                pass
        return out


def _source_of(t):
    return getattr(t, "_probe_src", None)


def replay_provenance(ssl, opts, vox, snap, orig_iteration, generator):
    """Replay 1 (see the module docstring): returns (sources, sinks,
    replay logs or the error)."""
    from detmatch_tpu_torch.ssl.detector import SSLDetector

    snap.restore(ssl, opts, generator)
    names = {id(m): n for n, m in ssl.named_modules()}
    captured = {}
    wrapped = {}
    for fn in ("student_losses_3d_concat", "student_losses_3d",
               "student_losses_2d", "teacher_pseudo_labels"):
        orig = getattr(SSLDetector, fn)

        def wrap(self, *a, _orig=orig, _fn=fn, **k):
            res = _orig(self, *a, **k)
            captured[_fn] = res
            return res
        wrapped[fn] = orig
        setattr(SSLDetector, fn, wrap)
    mode = Provenance(names)
    err = logs = None
    try:
        with mode:
            logs = orig_iteration(ssl, opts, vox, snap.batch, snap.it,
                                  generator)[0]
    except Exception as e:  # noqa: BLE001 - reported, not hidden
        err = f"{type(e).__name__}: {e}"
    finally:
        for fn, orig in wrapped.items():
            setattr(SSLDetector, fn, orig)
    sinks = []
    for fn, res in captured.items():
        if fn == "teacher_pseudo_labels":
            items = [(f"pseudo.{k}.{kk}", vv) for k, v in res.items()
                     if isinstance(v, dict) for kk, vv in v.items()]
        else:
            total, lg = res
            items = [("loss", total)] + list(lg.items())
        for k, v in items:
            if isinstance(v, torch.Tensor) and v.is_floating_point() \
                    and not _finite(v):
                sinks.append(dict(kind="logged" if fn != "teacher_pseudo_labels"
                                  else "pseudo-label", name=f"{fn}:{k}",
                                  source=_source_of(v)))
    for half in ("student", "teacher"):
        for n, b in _running_stats(getattr(ssl, half)):
            if not _finite(b):
                sinks.append(dict(kind="running statistic",
                                  name=f"{half}.{n}", source=_source_of(b)))
        for n, p in getattr(ssl, half).named_parameters():
            if not _finite(p):
                sinks.append(dict(kind="parameter", name=f"{half}.{n}",
                                  source=None))
            if p.grad is not None and not _finite(p.grad):
                sinks.append(dict(kind="gradient", name=f"{half}.{n}",
                                  source=None))
    for s in sinks:
        if s["source"] is not None:
            mode.sources[s["source"]]["reached"].append(s["name"])
    return mode, sinks, logs, err


def replay_anomaly(ssl, opts, vox, snap, orig_iteration, generator,
                   dump_at=None):
    """Replay 2: the first backward function that returns NaN under
    ``detect_anomaly`` and the forward trace behind it; with ``dump_at``
    also the dump of that call (:class:`Provenance`)."""
    snap.restore(ssl, opts, generator)
    mode = Provenance({}, dump_at=dump_at)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            with mode, torch.autograd.detect_anomaly(check_nan=True):
                orig_iteration(ssl, opts, vox, snap.batch, snap.it,
                               generator)
            err = None
        except RuntimeError as e:
            err = str(e)
    trace = [str(w.message) for w in caught
             if "Traceback of forward call" in str(w.message)
             or "Error detected" in str(w.message)]
    return dict(error=err, forward_trace=[t[-4000:] for t in trace[:2]]), \
        mode.dump


# ---- the run ----

def carry_labonly(root, record, iters):
    """Write arm A's results from a study record (``docs/
    learning_study_torch.json``) under ``root`` as ``--arm labonly``
    leaves them (its ``evals.json`` entry, ``run_labonly/run.json`` and
    the train lines of ``run_labonly/log.json``), so that ``--arm ssl``
    writes the report; the run record says where it came from."""
    from detmatch_tpu_torch.tools.misc import learning_study as ls

    with open(record) as f:
        rec = json.load(f)
    if rec["iters"] != iters:
        raise SystemExit(f"{record} has {rec['iters']} iterations, not "
                         f"{iters}")
    ls._store_eval(os.path.join(root, "evals.json"),
                   ls.eval_cache_key(f"labonly@{iters}"), rec["ap_labonly"])
    wd = os.path.join(root, "run_labonly")
    os.makedirs(wd, exist_ok=True)
    with open(os.path.join(wd, "run.json"), "w") as f:
        json.dump(dict(rec["run"]["labonly"],
                       carried_from=f"{os.path.basename(record)} "
                                    f"({rec['run'].get('card')})"), f)
    with open(os.path.join(wd, "log.json"), "w") as f:
        for it, loss in rec["curve_labonly"]:
            f.write(json.dumps(dict(iter=it, loss=loss, mode="train")) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--study-iters", type=int, default=3000,
                    help="the study's N (its ramp, warm-up, logs and "
                         "checkpoints follow it); default 3000")
    ap.add_argument("--out-dir", default=str(ROOT / "build"
                                             / "finite_probe"))
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--study", metavar="REPORT", default=None,
                    help="run the study's arm whole (learning_study "
                         "--arm: training, recalibration, evaluation) "
                         "with the checks attached, analyse the first "
                         "non-finite value and go on, and write the "
                         "study's report to REPORT")
    ap.add_argument("--carry-labonly", metavar="RECORD", default=None,
                    help="with --study: arm A's results from this study "
                         "record instead of a run of arm A")
    ap.add_argument("--arm", choices=("ssl", "labonly"), default="ssl",
                    help="the arm to train (default ssl, arm B; labonly "
                         "trains arm A, whose teacher phase runs with the "
                         "SSL weight at 0)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("finite_probe.py runs on a CUDA card "
                         "(--device cpu for a rehearsal)")
    from detmatch_tpu_torch.apis import train_ssl as ts
    from detmatch_tpu_torch.tools.misc import learning_study as ls

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    root = (args.data_root.rstrip("/") + "/" if args.data_root
            else tempfile.mkdtemp(prefix="finite_probe_") + "/")
    paths = ls.make_data(root)
    cfg = ls.build_cfg(root, paths, args.study_iters,
                       1.0 if args.arm == "ssl" else 0.0,
                       os.path.join(root, f"run_{args.arm}"), seed=0)
    card = ls.card_line() if torch.device(args.device).type == "cuda" \
        else None
    print(f"[probe] card {card}; arm {args.arm} of the study, "
          f"{args.study_iters} "
          "iterations' schedule, " + (
              "the whole arm, going on after the first non-finite value"
              if args.study else "stopping at the first non-finite value "
              f"or at {args.iters}"), flush=True)

    recorder = Recorder()
    unpatch = patched_filter(recorder)
    orig_iteration = ts._iteration
    orig_recal = ls.recalibrate
    rows_f = open(out_dir / "iterations.jsonl", "w")
    state = dict(events=[], analysis=None)
    t0 = time.perf_counter()

    def probed(ssl, opts, vox, batch_np, it, generator):
        if "snap" not in state:
            state["snap"] = Snapshot(ssl, opts)
            state["checker"] = Checker(ssl)
        snap = state["snap"]
        snap.take(ssl, opts, generator, batch_np, it)
        recorder.calls.clear()
        skipped = [o.skipped for o in opts]
        res = orig_iteration(ssl, opts, vox, batch_np, it, generator)
        logs = res[0]
        tstats = teacher_stats(recorder.calls)
        host = torch.cat([torch.stack([a.float(), b.float(), c.float()])
                          for _, a, b, c in tstats]).cpu() \
            if tstats else None
        bad = state["checker"].check()
        row = dict(iter=it, nonfinite_logs=[k for k, v in logs.items()
                                            if not math.isfinite(v)],
                   grad_finite=dict(det3d=opts[0].skipped == skipped[0],
                                    det2d=opts[1].skipped == skipped[1]),
                   nonfinite_state={g: v for g, v in bad.items() if v},
                   num_tea_hung=logs.get("metrics.num_tea_hung"),
                   loss=logs.get("loss"), ssl_weight=logs.get("ssl.weight"))
        if host is not None:
            for i, (kind, *_) in enumerate(tstats):
                row[f"tea{kind}"] = dict(
                    before=host[3 * i].tolist(),
                    after=host[3 * i + 1].tolist(),
                    top_score=host[3 * i + 2].tolist())
        rows_f.write(json.dumps(row) + "\n")
        if (it + 1) % 75 == 0:
            rows_f.flush()
            print(f"[probe] it {it + 1}: loss {row['loss']:.4f}, "
                  f"tea3d {row.get('tea3d')}, num_tea_hung "
                  f"{row['num_tea_hung']}, {len(state['events'])} "
                  f"non-finite so far, "
                  f"{(time.perf_counter() - t0) / (it + 1) * 1e3:.1f} ms "
                  "an iteration", flush=True)
        event = (row["nonfinite_logs"] or not all(row["grad_finite"].values())
                 or row["nonfinite_state"])
        if event:
            state["events"].append(it)
            ev = FirstEvent(row, snap, (ssl, opts, vox, generator))
            if not args.study:
                raise ev
            if state["analysis"] is None:
                state["analysis"] = dict(event=row, **analyse(
                    ev, orig_iteration, out_dir, root))
                # the iteration again from its start, as it first ran
                snap.restore(ssl, opts, generator)
                res = orig_iteration(ssl, opts, vox, snap.batch, snap.it,
                                     generator)
        if not args.study and it + 1 >= args.iters:
            raise Done
        return res

    def recalibrate(cfg, ssl, vox, passes=ls.RECAL_PASSES):
        out = orig_recal(cfg, ssl, vox, passes)
        state["after_recal"] = {g: v for g, v in
                                Checker(ssl).check().items() if v}
        return out

    ts._iteration = probed
    ls.recalibrate = recalibrate
    verdict = dict(card=card, iters_cap=None if args.study else args.iters,
                   study_iters=args.study_iters)
    try:
        if args.study:
            if args.carry_labonly:
                carry_labonly(root, args.carry_labonly, args.study_iters)
            try:
                ls.main(["--iters", str(args.study_iters), "--data-root",
                         root, "--arm", args.arm, "--device", args.device,
                         "--out", args.study])
                verdict["study_exit"] = 0
            except SystemExit as e:  # LEARNING CHECK FAILED exits 1
                verdict["study_exit"] = e.code
            for name in ("evals.json", f"run_{args.arm}/log.json",
                         f"run_{args.arm}/run.json"):
                src = Path(root) / name
                if src.exists():
                    dst = out_dir / name.replace("/", "_")
                    dst.write_bytes(src.read_bytes())
        else:
            ls.run_training(cfg, seed=0, device=args.device)
        verdict["event"] = None
    except Done:
        verdict["event"] = None
    except FirstEvent as ev:
        verdict["event"] = ev.row
        verdict.update(analyse(ev, orig_iteration, out_dir, root))
    finally:
        ts._iteration = orig_iteration
        ls.recalibrate = orig_recal
        unpatch()
        rows_f.close()
    if state["analysis"] is not None:
        verdict.update(state["analysis"])
    verdict["nonfinite_iterations"] = state["events"]
    verdict["nonfinite_after_recalibration"] = state.get("after_recal")
    verdict["wall_s"] = time.perf_counter() - t0
    with open(out_dir / "first_nonfinite.json", "w") as f:
        json.dump(verdict, f, indent=1, default=str)
    print(json.dumps({k: verdict.get(k) for k in
                      ("card", "event", "first", "anomaly", "replay_logs",
                       "nonfinite_iterations", "study_exit",
                       "nonfinite_after_recalibration", "wall_s")},
                     default=str)[-6000:], flush=True)


def analyse(ev, orig_iteration, out_dir, state_dir):
    """Both replays of the event's iteration, the dumps (the step's state
    to ``state_dir``); the verdict's entries."""
    ssl, opts, vox, generator = ev.args
    snap = ev.snap
    print(f"[probe] first non-finite value at iteration {snap.it}: "
          f"{ev.row}", flush=True)
    state_path = os.path.join(state_dir, "first_nonfinite_state.pt")
    torch.save(dict(it=snap.it, batch=snap.batch, generator=snap.gen,
                    counters=snap.counters,
                    state={k: v.cpu() for k, v in
                           snap.state_dict().items()},
                    moments=[[t.cpu() for t in m] for m in snap.moments]),
               state_path)
    t = time.perf_counter()
    mode, sinks, logs, err = replay_provenance(ssl, opts, vox, snap,
                                               orig_iteration, generator)
    prov_s = time.perf_counter() - t
    reached = [s for s in mode.sources if s["reached"]]
    first = min(reached, key=lambda s: s["id"]) if reached else None
    t = time.perf_counter()
    anomaly, dump = replay_anomaly(
        ssl, opts, vox, snap, orig_iteration, generator,
        dump_at=None if first is None else first["op_index"])
    anomaly_s = time.perf_counter() - t
    arrays = {} if dump is None else dump.pop("arrays")
    np.savez(out_dir / "first_nonfinite.npz", **arrays)
    benign = {}
    for s in mode.sources:
        if not s["reached"]:
            benign[s["place"]] = benign.get(s["place"], 0) + 1
    return dict(
        first=first, dump=dump,
        reaching_sources=reached[:8],
        sinks=sinks[:200], n_sinks=len(sinks),
        cleared_sources=benign, calls_checked=mode.ops,
        replay_logs=(None if logs is None else
                     {k: v for k, v in logs.items()
                      if not math.isfinite(v)}),
        replay_error=err, anomaly=anomaly,
        npz=sorted(arrays), state=state_path,
        replay_s=dict(provenance=prov_s, anomaly=anomaly_s))


if __name__ == "__main__":
    main()
