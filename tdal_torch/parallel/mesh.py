"""Data parallelism over ``torch.distributed``: the port of ``tdal/parallel/mesh.py``.

tdal's data parallelism is GSPMD: one program over the global batch, sharded over a
``data`` mesh axis, so every reduction in it is global by construction (BatchNorm
statistics, loss normalizers, the gradient, the clipping norm). The port runs one
process per device (a rank) in a process group (NCCL on the card, gloo on the CPU) and
makes the same reductions global by hand:

- ``Mesh``: the process group, its world size, this process's rank and its device.
  Entered as a context (``with mesh:``) it is the active mesh of the train steps run
  inside it; with no active mesh every function below is the single-device reduction
  (the identity), so one code path serves both.
- ``all_reduce_sum``: a sum over the ranks whose backward sums the cotangent over the
  ranks, so a statistic's gradient reaches every rank's rows (BatchNorm; the layers
  also feed the statistics' cotangents into the conv kernels' backward through it).
- ``partial_mean``: a rank's share of a mean over the global batch (the labelers'
  means). Each rank's loss is its share of the global loss, so the gradients are
  **summed** over the ranks (``all_reduce_grads``, bucketed, before the clip and the
  optimizer, in ``TrainState.apply_gradients``), not averaged as
  ``DistributedDataParallel`` does; ``sum_logs`` sums a step's logged shares.
- ``broadcast_module``: rank 0's weights and running statistics to every rank.
- ``shard_batch`` / ``rank_rows``: rank r's rows [r B/N, (r+1) B/N) of a batch that
  every rank builds whole, as tdal's host builds the global batch before
  ``shard_batch`` (its augmentation and dropout draws are those of one process).
- ``start_run`` and ``rank_step``: how a training loop enters data parallelism (the
  split checked, rank 0's weights broadcast, the other ranks' logs silenced) and runs a
  step on its rows; with no mesh (None) both are the single-device loop's.
- ``pad_to_multiple``, ``process_allgather`` and ``gather_to_main`` (host objects,
  through ``all_gather_object`` / ``gather_object``: gloo gathers no CUDA tensor),
  ``barrier`` (the host waits).
- ``init_distributed`` (a rank of a ``torchrun`` launch), ``spawn`` (one rank per card
  from a plain launch) and ``launch``, the CLIs' rule between them. Both form their
  group with ``TIMEOUT``.

``spatial_sharding`` (BEV spatial partitioning) is not ported.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from tdal_torch.device import resolve_device
from tdal_torch.runtime.logging_utils import quiet_logger

BUCKET_BYTES = 25 * 2**20  # gradient and broadcast buckets (DistributedDataParallel's)
# how long a rank waits in a collective before its group fails: the other ranks wait
# while rank 0 writes a checkpoint and computes the AP/APH of a validation split (the
# predictions are sharded, the metric is not), which NCCL's default of 10 minutes
# does not cover for a full split
TIMEOUT = datetime.timedelta(hours=2)

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("tdal_torch_mesh", default=None)


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a data-parallel process group: ``group`` None is the
    default group. ``with mesh:`` makes it the active mesh."""

    world: int
    rank: int
    device: torch.device
    group: object = None
    _tokens: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def __enter__(self):
        self._tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._tokens.pop())


def active():
    """The active mesh, or None."""
    return _ACTIVE.get()


def world_size() -> int:
    """The active mesh's world size (1 without one)."""
    mesh = _ACTIVE.get()
    return 1 if mesh is None else mesh.world


def is_main(mesh) -> bool:
    """Rank 0, or no mesh: the process that logs and writes files."""
    return mesh is None or mesh.rank == 0


# ---------------------------------------------------------------------------
# reductions over the active mesh
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    # the backward reads the group saved here: autograd may run it on another thread,
    # where the active mesh is not set

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active mesh's ranks, its cotangent summed over them in the
    backward; ``x`` itself without an active mesh. Every rank must call it in the same
    order with the same shape."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def partial_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch: x.sum() / (numel
    times the world size). Summed over the ranks (each holds as many rows) it is the
    mean of the whole batch."""
    return x.sum() / (x.numel() * world_size())


def sum_logs(logs: dict) -> dict:
    """A train or eval step's logs (each a rank's share of a sum or a mean, a scalar
    tensor) summed over the active mesh in one all-reduce, as f32; ``logs`` itself
    without an active mesh."""
    mesh = _ACTIVE.get()
    if mesh is None or not logs:
        return logs
    keys = list(logs)
    flat = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    return dict(zip(keys, flat.unbind()))


def _coalesced(tensors, collective, bucket_bytes: int = BUCKET_BYTES):
    """Runs ``collective`` (in place, on a flat tensor) over ``tensors`` packed into
    buckets of at most ``bucket_bytes`` of one dtype, and copies the results back."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        buckets, size = [[]], 0
        for t in group:
            nbytes = t.numel() * t.element_size()
            if buckets[-1] and size + nbytes > bucket_bytes:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += nbytes
        for bucket in buckets:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            collective(flat)
            for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(v.view_as(t))


def all_reduce_grads(params, mesh: Mesh):
    """Sum the ``.grad`` of ``params`` (those that have one) over ``mesh``, bucketed."""
    grads = [p.grad for p in params if p.grad is not None]
    _coalesced(grads, lambda flat: dist.all_reduce(flat, group=mesh.group))


def broadcast_module(module: torch.nn.Module, mesh: Mesh, src: int = 0):
    """Rank ``src``'s parameters and floating-point buffers (running statistics) to
    every rank of ``mesh``, bucketed."""
    tensors = [t.data for t in (*module.parameters(), *module.buffers())
               if t.is_floating_point()]
    with torch.no_grad():
        _coalesced(tensors, lambda flat: dist.broadcast(flat, src, group=mesh.group))


def barrier(mesh: Mesh):
    """Block this rank's host until every rank of ``mesh`` has reached the barrier (an
    all-reduce on the rank's device, which both backends run, then a wait for it)."""
    dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def per_rank(batch_size: int, mesh) -> int:
    """The rows of a global batch of ``batch_size`` that each rank of ``mesh`` takes;
    raises when they do not split evenly."""
    if mesh is None:
        return batch_size
    if batch_size % mesh.world:
        raise ValueError(f"the global batch of {batch_size} does not split over "
                         f"{mesh.world} ranks")
    return batch_size // mesh.world


def scope(mesh):
    """``with scope(mesh):`` makes ``mesh`` the active mesh of the block; with no mesh
    (None) the block runs on one device."""
    return mesh if mesh is not None else contextlib.nullcontext()


def start_run(mesh, batch_size: int, module: torch.nn.Module, logger):
    """Enter a training run on ``mesh`` (None: one device): check that the global batch
    of ``batch_size`` splits over the ranks, give every rank rank 0's weights and
    running statistics of ``module``, and silence the logs of the ranks other than 0.
    Returns (whether this rank logs and writes files, its logger)."""
    if mesh is None:
        return True, logger
    per_rank(batch_size, mesh)
    broadcast_module(module, mesh)
    return (True, logger) if mesh.rank == 0 else (False, quiet_logger())


@contextlib.contextmanager
def rank_step(mesh, batch):
    """``with rank_step(mesh, batch) as rows:`` a step on this rank's rows of a host
    batch that every rank built whole, with ``mesh`` active; ``batch`` itself on one
    device (``mesh`` None)."""
    with scope(mesh):
        yield shard_batch(batch, mesh)


def rank_rows(x, mesh=None):
    """Rank r's rows [r B/N, (r+1) B/N) of ``x`` (first axis B) on ``mesh`` (default:
    the active mesh); ``x`` itself without one."""
    mesh = mesh or _ACTIVE.get()
    if mesh is None:
        return x
    b = per_rank(x.shape[0], mesh)
    return x[mesh.rank * b : (mesh.rank + 1) * b]


def shard_batch(batch, mesh):
    """This rank's rows of a host batch that every rank built whole: each array (numpy
    or tensor) of the nested dicts, lists and tuples cut by ``rank_rows``; other
    leaves (tokens, counts) as they are. ``batch`` itself when ``mesh`` is None."""
    if mesh is None:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor)) and batch.ndim > 0:
        return rank_rows(batch, mesh)
    return batch


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad (by repeating the last element) so shape[axis] % multiple == 0.

    Returns (padded, n_valid). The repeat-pad mirrors the reference sampler's
    index-repetition padding (datasets/loader/sampler.py:146-155)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = np.take(arr, np.full(rem, n - 1, dtype=np.int64), axis=axis)
    return np.concatenate([arr, pad], axis=axis), n


def _stacked(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stacked([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stacked(list(t)) for t in zip(*trees))
    return np.stack([np.asarray(t) for t in trees])


def process_allgather(tree, mesh=None):
    """Gather a host tree (nested dicts, lists and tuples of numpy arrays or numbers)
    from every rank of ``mesh``: each leaf stacked along a new leading rank axis, as
    jax's ``multihost_utils.process_allgather``. The identity for one process."""
    if mesh is None or mesh.world == 1:
        return tree
    gathered = [None] * mesh.world
    dist.all_gather_object(gathered, tree, group=mesh.group)
    return _stacked(gathered)


def gather_to_main(obj, mesh=None):
    """Every rank's host object ``obj`` (picklable) as a list by rank on rank 0, None on
    the others; ``[obj]`` without a mesh. Every rank must call it."""
    if mesh is None:
        return [obj]
    main = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    gathered = [None] * mesh.world if mesh.rank == 0 else None
    dist.gather_object(obj, gathered, dst=main, group=mesh.group)
    return gathered


# ---------------------------------------------------------------------------
# process groups and launches
# ---------------------------------------------------------------------------


def make_mesh(device, group=None) -> Mesh:
    """The mesh over an initialized process group (the default one unless ``group``):
    its world size and this process's rank, with ``device`` as the rank's device."""
    return Mesh(dist.get_world_size(group), dist.get_rank(group), torch.device(device), group)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(device=None) -> Mesh:
    """Join the process group of a ``torchrun`` launch (``python -m
    torch.distributed.run``) as the rank its environment names (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). The rank's device is
    ``cuda:LOCAL_RANK`` (NCCL), or the CPU (gloo) when ``device`` is a CPU device. A
    group that does not form raises."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend(dev), init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]), timeout=TIMEOUT)
    return make_mesh(dev)


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned_rank(rank, entry, args, world, port, backend, devices):
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        entry(make_mesh(dev), *args)
    finally:
        dist.destroy_process_group()


def spawn(entry, args=(), devices=None, backend: str | None = None):
    """Run ``entry(mesh, *args)`` in one new process per entry of ``devices`` (default:
    every visible card), rank r on ``devices[r]``, over a process group formed on a free
    localhost port (``backend`` default: NCCL on cards, gloo on the CPU). ``entry`` and
    ``args`` must pickle (``entry`` by its import path). A rank's error is raised here
    after every rank has stopped."""
    devices = [str(d) for d in (devices or [f"cuda:{i}" for i in range(torch.cuda.device_count())])]
    backend = backend or _backend(torch.device(devices[0]))
    torch.multiprocessing.spawn(
        _spawned_rank, args=(entry, args, len(devices), free_port(), backend, devices),
        nprocs=len(devices), join=True)


def launch(entry, args=(), device=None, data_parallel: bool = True):
    """The CLIs' launch rule for ``entry(mesh, *args)`` (mesh None: one device):

    - under ``torchrun`` (``WORLD_SIZE`` set), this process is one rank of its group
      (``init_distributed``); refusing to train apart when ``data_parallel`` is off;
    - a plain launch with ``data_parallel`` on a card, where more than one is visible,
      spawns one rank per card (tdal's ``make_mesh()`` over every device);
    - otherwise one process on ``device`` (``--device cpu``: one rank)."""
    if "WORLD_SIZE" in os.environ:
        if not data_parallel:
            raise ValueError(f"launched as {os.environ['WORLD_SIZE']} ranks, but data "
                             "parallelism is off: launch one process instead")
        mesh = init_distributed(device)
        try:
            return entry(mesh, *args)
        finally:
            dist.destroy_process_group()
    dev = resolve_device(device)
    if data_parallel and dev.type == "cuda" and torch.cuda.device_count() > 1:
        return spawn(entry, args)
    return entry(None, *args)
