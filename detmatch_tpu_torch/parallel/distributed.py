"""Data-parallel training over ``torch.distributed`` (counterpart of
``detmatch_tpu/parallel/distributed.py``).

JAX runs one program over a global batch that a mesh shards, and every
batch reduction in it (batch-norm statistics, loss denominators, the
gradient) is global by construction. Here one process drives one device
and holds its rows of the global batch, so each such reduction is made
global by hand, with two collectives only, ``all_reduce`` (SUM) and
``broadcast``, which gloo also carries on CUDA tensors:

* counts and denominators: :func:`global_sum` (no gradient);
* batch-norm statistics: :func:`global_sum_grad`, whose backward sums
  the incoming gradient over the processes;
* the gradient: :func:`all_reduce_grads`, one flat buffer per student
  branch (:func:`all_reduce_flat`). Each process's loss is its share of
  the global loss (its numerators over the global denominators), so the
  summed gradient is the global one;
* random draws with a batch axis are made for every global row, in
  global order, from a generator that every process seeds alike, and a
  process keeps its own rows (:func:`global_rows`);
* the logged values are shares too, summed by :func:`reduce_logs`.

With no process group every function here is the identity (or the
one-process answer), so a single process runs exactly the code it ran
before. The students are not wrapped in ``DistributedDataParallel``: it
averages the gradients (each process's loss already is a share of the
global one, so a world-size factor would be needed back) and its hooks
fire on each of the two student branches' backward passes beside a
frozen teacher, which needs ``find_unused_parameters``.

Environment contract (the JAX launchers'):

* ``DETMATCH_COORDINATOR``   host:port of process 0 (or a ``tcp://`` /
  ``file://`` URL)
* ``DETMATCH_NUM_PROCESSES`` total processes
* ``DETMATCH_PROCESS_ID``    this process's rank
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# the other processes wait at their next collective while process 0
# evaluates or writes a checkpoint: the group's timeout outlasts that
TIMEOUT = timedelta(hours=2)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join (or create) the process group of a multi-process run.

    The arguments fall back to the ``DETMATCH_*`` environment; with
    neither, or one process, this is a single-process run and the call
    does nothing. Returns True iff a process group was started
    (:func:`start_group`).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "DETMATCH_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("DETMATCH_NUM_PROCESSES", 0)) \
            or None
    if process_id is None:
        pid = os.environ.get("DETMATCH_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator_address is None and num_processes is None:
        return False
    if num_processes is not None and num_processes <= 1:
        return False
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "a multi-process run needs the coordinator address, the number "
            "of processes and this process's id (DETMATCH_COORDINATOR, "
            "DETMATCH_NUM_PROCESSES, DETMATCH_PROCESS_ID)")
    start_group(coordinator_address, num_processes, process_id, backend)
    return True


def start_group(address: str, world: int, rank: int,
                backend: Optional[str] = None):
    """Start the process group, of any size (one included).

    ``address``: ``host:port`` or ``tcp://host:port`` (process 0 serves
    the store there) or ``file://path`` (a file store). ``backend``:
    "nccl" where CUDA is available, else "gloo", unless given. Where CUDA
    is available the process takes ``cuda:{rank % device_count}``. NCCL
    refuses two processes on one device: that raises on every process,
    it never falls back to another backend.
    """
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    if backend == "nccl" and not cuda:
        raise RuntimeError("the nccl backend needs CUDA; pass "
                           "backend='gloo' to run on the CPU")
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = _store(address, world, rank)
    if backend == "nccl":
        _refuse_shared_devices(store, world, rank)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)


def _store(address, world, rank):
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://"):], world)
    host, port = address.removeprefix("tcp://").rsplit(":", 1)
    return dist.TCPStore(host, int(port), world, rank == 0,
                         timeout=TIMEOUT)


def _store_barrier(store, name, world):
    if store.add(f"{name}/joined", 1) == world:
        store.set(f"{name}/done", "1")
    store.wait([f"{name}/done"])


def _refuse_shared_devices(store, world, rank):
    """Raise on every process if two of them hold one CUDA device."""
    device = f"{socket.gethostname()}/cuda:{torch.cuda.current_device()}"
    store.add(f"device/{device}", 1)
    _store_barrier(store, "devices", world)
    if store.add(f"device/{device}", 0) > 1:
        store.add("shared_devices", 1)
    _store_barrier(store, "shared", world)
    shared = store.add("shared_devices", 0)
    if shared:
        raise RuntimeError(
            f"nccl: {shared} processes share a CUDA device (process {rank} "
            f"on {device}); NCCL refuses two ranks on one device. Run at "
            "most one process per device, or pass backend='gloo'")


def shutdown():
    """Wait for every process (one all-reduce: process 0 may still be
    writing its last checkpoint), then leave the process group; nothing
    if none was started."""
    if _group():
        dist.all_reduce(_comm(torch.zeros(1)))
        dist.destroy_process_group()


def _group():
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _group() else 0


def process_count() -> int:
    return dist.get_world_size() if _group() else 1


def is_primary() -> bool:
    """True on the process that writes logs, checkpoints and pictures and
    runs the evaluation."""
    return process_index() == 0


def _comm(t):
    """``t`` on a device the backend carries: NCCL only CUDA tensors."""
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


# ------------------------------------------------------------ reductions

def global_sum(x):
    """The sum of ``x`` over the processes, without gradient (counts and
    denominators)."""
    x = x.detach()
    if not _group():
        return x
    y = _comm(x.clone())
    dist.all_reduce(y)
    return y.to(x.device)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _comm(x.clone())
        dist.all_reduce(y)
        return y.to(x.device)

    @staticmethod
    def backward(ctx, g):
        # every process's loss reads the summed value: the gradient of
        # the global loss at this process's addend is the sum of theirs
        g = _comm(g.contiguous().clone())
        dist.all_reduce(g)
        return g


def global_sum_grad(x):
    """The sum of ``x`` over the processes, differentiable: the backward
    sums the incoming gradient over the processes (the batch-norm
    statistics' collective). The identity without a process group."""
    return _GlobalSum.apply(x) if _group() else x


def global_count(n: int) -> int:
    """The global batch of a per-process batch of ``n`` rows: every
    process holds as many rows, as a sharded global batch does."""
    return n * process_count()


def _flat_groups(tensors):
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return groups.values()


@torch.no_grad()
def all_reduce_flat(tensors):
    """Sum each tensor of the list over the processes through one flat
    buffer per dtype (one collective, not one per tensor); returns the
    summed tensors, views of that buffer. The list itself without a
    process group."""
    tensors = list(tensors)
    if not _group():
        return tensors
    out = [None] * len(tensors)
    for idx in _flat_groups(tensors):
        flat = _comm(torch.cat([tensors[i].reshape(-1) for i in idx]))
        dist.all_reduce(flat)
        flat = flat.to(tensors[idx[0]].device)
        for i, piece in zip(idx, flat.split([tensors[i].numel()
                                             for i in idx])):
            out[i] = piece.view_as(tensors[i])
    return out


def all_reduce_grads(params):
    """Replace the ``.grad`` of every parameter that requires one by its
    sum over the processes, in one flat collective (a missing gradient
    counts as zero there and stays missing); nothing without a process
    group."""
    params = [p for p in params if p.requires_grad]
    if not _group() or not params:
        return
    grads = all_reduce_flat([p.grad if p.grad is not None
                             else torch.zeros_like(p) for p in params])
    for p, g in zip(params, grads):
        if p.grad is not None:
            p.grad = g


def reduce_logs(logs, replicated=()):
    """Logged values → their global values: every value is this process's
    share of the global one and is summed over the processes, but those
    named in ``replicated`` (equal on every process: a skip count, a
    schedule's value), which pass as they are. One collective."""
    if not _group():
        return dict(logs)
    keys = [k for k in logs if k not in replicated]
    if not keys:
        return dict(logs)
    dev = next((v.device for v in logs.values()
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    vec = torch.stack([torch.as_tensor(logs[k], dtype=torch.float32,
                                       device=dev).detach().reshape(())
                       for k in keys])
    vec = global_sum(vec)
    return dict(logs, **dict(zip(keys, vec.unbind())))


# ------------------------------------------------------------ state

def _leaves(tree, tensors, numbers):
    """Collect the tensor leaves and the (container, key) of the number
    leaves of a nested dict / list (tuples are configuration, skipped)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, torch.Tensor):
            tensors.append(v)
        elif isinstance(v, (int, float)):
            numbers.append((tree, k))
        elif isinstance(v, (dict, list)):
            _leaves(v, tensors, numbers)


@torch.no_grad()
def broadcast_state(*objs):
    """Copy process 0's state into every process's: modules (parameters
    and buffers, in place), ``torch.Generator``s, and anything with
    ``state_dict`` / ``load_state_dict`` (optimizers: a
    ``BranchOptimizer``'s moments and counters, a torch optimizer's
    state), every tensor and number of its state dict. One collective per
    dtype. Nothing without a process group."""
    if not _group():
        return
    tensors, numbers, dicts = [], [], []
    for obj in objs:
        if isinstance(obj, torch.nn.Module):
            tensors += list(obj.parameters()) + list(obj.buffers())
        elif isinstance(obj, torch.Generator):
            dicts.append((obj, obj.get_state()))
            tensors.append(dicts[-1][1])
        else:
            dicts.append((obj, obj.state_dict()))
            _leaves(dicts[-1][1], tensors, numbers)
    if numbers:
        tensors.append(torch.tensor([float(c[k]) for c, k in numbers],
                                    dtype=torch.float64))
    for idx in _flat_groups(tensors):
        flat = _comm(torch.cat([tensors[i].reshape(-1) for i in idx]))
        dist.broadcast(flat, 0)
        flat = flat.to(tensors[idx[0]].device)
        for i, piece in zip(idx, flat.split([tensors[i].numel()
                                             for i in idx])):
            tensors[i].copy_(piece.view_as(tensors[i]))
    if numbers:
        for (c, k), v in zip(numbers, tensors[-1].tolist()):
            c[k] = type(c[k])(v)
    for obj, state in dicts:
        (obj.set_state if isinstance(obj, torch.Generator)
         else obj.load_state_dict)(state)


# ------------------------------------------------------------ rows

def global_rows(b: int, groups=1):
    """Where this process's ``b`` rows sit in the global batch.

    The local batch is parts concatenated (the SSL student's labeled and
    unlabeled views), each part this process's rank-major shard of a
    global part, as concatenating sharded global arrays orders them.
    ``groups``: the number of equal parts, or the parts' local sizes.
    Returns (the global index of each local row, increasing; the global
    row count)."""
    sizes = [b // groups] * groups if isinstance(groups, int) else \
        list(groups)
    if sum(sizes) != b:
        raise ValueError(f"{b} rows in parts of {sizes}")
    n, r = process_count(), process_index()
    idx, base = [], 0
    for per in sizes:
        idx += [base + r * per + i for i in range(per)]
        base += per * n
    return idx, b * n


def rows_in_global_order(b: int, groups=1):
    """For every global row, in global order: its local index on this
    process, or None if another process holds it (the per-sample draws
    are made for every global row and kept for the own ones)."""
    idx, total = global_rows(b, groups)
    where = {g: i for i, g in enumerate(idx)}
    return [where.get(g) for g in range(total)]


def for_each_global_row(b: int, fn, groups=1):
    """``[fn(i) for i in range(b)]`` over this process's ``b`` rows, with
    ``fn`` called for every global row, in global order: on a row that
    another process holds, on local row 0 (the same shapes), its result
    dropped. So a per-row sampler whose draws depend on the shapes only,
    drawing from a generator that every process seeds alike, makes every
    global row's draws, and each process keeps its own rows'.
    ``groups`` as :func:`global_rows`."""
    out = []
    for i in rows_in_global_order(b, groups):
        kept = fn(0 if i is None else i)
        if i is not None:
            out.append(kept)
    return out


def local_shard(tree):
    """This process's rows of a global batch (a nested dict / list of
    numpy arrays or tensors, the batch on the leading axis): the rank-major
    slice ``[r * n / N, (r + 1) * n / N)``, as JAX's
    ``make_array_from_process_local_data`` lays a global batch out. A
    batch that the process count does not divide raises."""
    n, r = process_count(), process_index()
    if n == 1:
        return tree

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return x
        if x.shape[0] % n:
            raise ValueError(f"a global batch of {x.shape[0]} rows over "
                             f"{n} processes")
        per = x.shape[0] // n
        return x[r * per:(r + 1) * per]

    return take(tree)
