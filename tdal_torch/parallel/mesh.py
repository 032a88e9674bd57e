"""Data parallelism and BEV spatial partitioning over ``torch.distributed``: the port of
``tdal/parallel/mesh.py``.

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

BEV spatial partitioning (tdal's ``spatial_sharding``: the NHWC canvas's H split over a
``spatial`` mesh axis, and N over ``data``). tdal leaves the partitioning of every conv
and its one-row halo exchanges to XLA's SPMD partitioner; the port does them by hand:

- A ``Mesh`` with ``spatial`` > 1 is a 2-D mesh of world = data x spatial ranks, rank r
  at (r // spatial, r % spatial): the ranks of one spatial group (consecutive ranks)
  hold the same frames, each one band of rows of their BEV maps. ``per_rank``,
  ``rank_rows``, ``shard_batch``, ``partial_mean`` and ``sum_logs`` go over the data
  axis; ``all_reduce_sum(x, axis)`` over the whole world (BatchNorm moments and counts)
  or the data axis (loss normalizers: the spatial ranks of a group hold the same
  gathered maps); the gradient sum (``all_reduce_grads``) over the whole world.
- ``spatial_slab(mesh, height, factor)``: this rank's ``RowSlab`` of a map of
  ``height`` rows whose coarsest level is ``factor`` times smaller, the coarsest level's
  rows split into near-equal ranges (117 rows over 2 ranks: 59 + 58) and every finer
  level taking the same ranges times its factor (``RowSlab.scaled``), so a k == s
  deblock needs no halo and a stride-2 3x3 conv one row above only.
- ``RowSlab.exchange`` (autograd: the halo rows' cotangents go back to their owners and
  are added there) and ``RowSlab.pad_rows`` (no autograd, for the conv kernels' own
  backward) give a slab its neighbours' edge rows: ``dist.batch_isend_irecv`` over NCCL;
  over gloo, which sends no CUDA tensor, an all-reduce of a buffer of every rank's edge
  rows (gloo all-reduces CUDA tensors, so ranks sharing a card work too).
  ``RowSlab.gather`` gives every rank of the group the whole H (NCCL: an all-gather of
  padded slabs; gloo: an all-reduce of the zero-filled map); its backward keeps the
  rank's own rows of the cotangent where every rank computes the same function of the
  gathered map (``same=True``: the loss, decode), and sums the cotangent over the group
  first where each computes its own rows of it (the deformable head's sampling).
  ``RowSlab.take`` keeps the rank's rows of a map every rank built whole (the canvas);
  its backward fills the other rows with zeros, so a part computed by every rank enters
  the summed gradient once.
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
    """One rank's view of a process group: ``group`` None is the default group. With
    ``spatial`` > 1 it is a data x spatial mesh (``data_group``: the ranks of this
    rank's spatial index, ``spatial_group``: those of its data index). ``with mesh:``
    makes it the active mesh."""

    world: int
    rank: int
    device: torch.device
    group: object = None
    spatial: int = 1
    data_group: object = None
    spatial_group: object = None
    _tokens: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def data(self) -> int:
        """Ranks along the data axis."""
        return self.world // self.spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.spatial

    def group_of(self, axis=None):
        """The process group of ``axis``: None the whole world, "data" the data axis."""
        if axis is None or self.spatial == 1:
            return self.group
        if axis != "data":
            raise ValueError(f"no reduction axis {axis!r}: None or 'data'")
        return self.data_group

    def __enter__(self):
        self._tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._tokens.pop())


def active():
    """The active mesh, or None."""
    return _ACTIVE.get()


def data_size() -> int:
    """The active mesh's ranks along the data axis (1 without one): the global batch is
    this many times a rank's rows."""
    mesh = _ACTIVE.get()
    return 1 if mesh is None else mesh.data


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


def all_reduce_sum(x: torch.Tensor, axis=None) -> torch.Tensor:
    """``x`` summed over the active mesh's ranks (``axis`` None: the whole world;
    "data": the data axis), its cotangent summed over them in the backward; ``x`` itself
    without an active mesh. Every rank must call it in the same order with the same
    shape."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x
    return _AllReduceSum.apply(x, mesh.group_of(axis))


def partial_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch: x.sum() / (numel
    times the ranks of the data axis). Summed over them (each holds as many rows) it is
    the mean of the whole batch."""
    return x.sum() / (x.numel() * data_size())


def sum_logs(logs: dict) -> dict:
    """A train or eval step's logs (each a rank's share of a sum or a mean, a scalar
    tensor) summed over the active mesh's data axis in one all-reduce, as f32 (the
    ranks of a spatial group log the same values); ``logs`` itself without an active
    mesh."""
    mesh = _ACTIVE.get()
    if mesh is None or not logs:
        return logs
    keys = list(logs)
    flat = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=mesh.group_of("data"))
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
    """The rows of a global batch of ``batch_size`` that each rank of ``mesh`` takes
    (the ranks of a spatial group take the same rows); raises when they do not split
    evenly over the data axis."""
    if mesh is None:
        return batch_size
    if batch_size % mesh.data:
        raise ValueError(f"the global batch of {batch_size} does not split over "
                         f"{mesh.data} ranks")
    return batch_size // mesh.data


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
    """Rows [d B/N, (d+1) B/N) of ``x`` (first axis B) for data rank d of N on ``mesh``
    (default: the active mesh); ``x`` itself without one."""
    mesh = mesh or _ACTIVE.get()
    if mesh is None:
        return x
    b = per_rank(x.shape[0], mesh)
    return x[mesh.data_rank * b : (mesh.data_rank + 1) * b]


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


def make_mesh(device, group=None, spatial: int = 1) -> Mesh:
    """The mesh over an initialized process group (the default one unless ``group``):
    its world size and this process's rank, with ``device`` as the rank's device. With
    ``spatial`` > 1, a data x spatial mesh over the default group: every rank forms
    every data and spatial subgroup (``dist.new_group`` is collective), so every rank
    must call this with the same ``spatial``."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if spatial == 1:
        return Mesh(world, rank, torch.device(device), group)
    if group is not None or world % spatial:
        raise ValueError(f"a spatial axis of {spatial} needs the default group, and its "
                         f"world ({world}) a multiple of it")
    data = world // spatial
    by_data = [dist.new_group([d * spatial + s for s in range(spatial)], timeout=TIMEOUT)
               for d in range(data)]
    by_spatial = [dist.new_group([d * spatial + s for d in range(data)], timeout=TIMEOUT)
                  for s in range(spatial)]
    mesh = Mesh(world, rank, torch.device(device), None, spatial,
                data_group=by_spatial[rank % spatial], spatial_group=by_data[rank // spatial])
    # a first collective on every spatial group, so that NCCL's point-to-point sends
    # (the halo exchange) find it formed on every rank
    dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.spatial_group)
    return mesh


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


def _spawned_rank(rank, entry, args, world, port, backend, devices, spatial=1):
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        entry(make_mesh(dev, spatial=spatial), *args)
    finally:
        dist.destroy_process_group()


def spawn(entry, args=(), devices=None, backend: str | None = None, spatial: int = 1):
    """Run ``entry(mesh, *args)`` in one new process per entry of ``devices`` (default:
    every visible card), rank r on ``devices[r]``, over a process group formed on a free
    localhost port (``backend`` default: NCCL on cards, gloo on the CPU); ``spatial``
    > 1 makes the mesh data x spatial (``make_mesh``). ``entry`` and ``args`` must pickle
    (``entry`` by its import path). A rank's error is raised here after every rank has
    stopped."""
    devices = [str(d) for d in (devices or [f"cuda:{i}" for i in range(torch.cuda.device_count())])]
    backend = backend or _backend(torch.device(devices[0]))
    torch.multiprocessing.spawn(
        _spawned_rank,
        args=(entry, args, len(devices), free_port(), backend, devices, spatial),
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


# ---------------------------------------------------------------------------
# BEV spatial partitioning: row slabs, halo exchange, gathers
# ---------------------------------------------------------------------------


def row_ranges(rows: int, parts: int) -> tuple:
    """``rows`` split into ``parts`` near-equal consecutive ranges [a, b), the first
    ``rows % parts`` one row longer; raises where a part would be empty."""
    if rows < parts:
        raise ValueError(f"BEV spatial partitioning: {rows} rows at the coarsest level "
                         f"cannot split over {parts} ranks")
    base, extra = divmod(rows, parts)
    bounds = np.cumsum([0] + [base + (i < extra) for i in range(parts)])
    return tuple((int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]))


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slab, top, bottom):
        ctx.slab, ctx.top, ctx.bottom = slab, top, bottom
        return slab.pad_rows(x, top, bottom)

    @staticmethod
    def backward(ctx, g):
        slab = ctx.slab
        top, bottom = slab.halo(ctx.top, ctx.bottom)
        own = g[:, top : g.shape[1] - bottom].clone(memory_format=torch.contiguous_format)

        def edge(rows, has):  # a halo row's cotangent; zeros at the group's edges
            return rows.contiguous() if has else torch.zeros_like(own[:, :1])

        # each halo row's cotangent goes back to the rank that owns the row
        up = edge(g[:, :1], top) if ctx.top else None
        down = edge(g[:, -1:], bottom) if ctx.bottom else None
        from_above, from_below = slab._swap(up, down)
        if from_above is not None:
            own[:, :1] += from_above
        if from_below is not None:
            own[:, -1:] += from_below
        return own, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slab, same):
        ctx.slab, ctx.same = slab, same
        return slab._gather(x)

    @staticmethod
    def backward(ctx, g):
        slab = ctx.slab
        if not ctx.same:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=slab.mesh.spatial_group)
        return g[:, slab.start : slab.stop].contiguous(), None, None


@dataclasses.dataclass(frozen=True, eq=False)
class RowSlab:
    """This rank's rows [start, stop) of one level of a BEV map of ``height`` rows split
    by rows over ``mesh``'s spatial group; ``ranges`` holds every rank's [a, b). Maps
    are NHWC (rows on axis 1)."""

    mesh: Mesh
    ranges: tuple
    height: int

    @property
    def index(self) -> int:
        return self.mesh.spatial_rank

    @property
    def start(self) -> int:
        return self.ranges[self.index][0]

    @property
    def stop(self) -> int:
        return self.ranges[self.index][1]

    @property
    def rows(self) -> int:
        return self.stop - self.start

    def scaled(self, num: int, den: int = 1) -> "RowSlab":
        """The same partition at a level num / den times as tall (a finer level: num > 1;
        a coarser one: den > 1); raises where the ranges do not nest in it."""
        if any((a * num) % den or (b * num) % den for a, b in self.ranges) \
                or (self.height * num) % den:
            raise ValueError(f"BEV spatial partitioning: the row ranges {self.ranges} of "
                             f"{self.height} rows do not nest at {num}/{den} of the "
                             "level (its rows would straddle two ranks)")
        return RowSlab(self.mesh, tuple((a * num // den, b * num // den)
                                        for a, b in self.ranges), self.height * num // den)

    def halo(self, top: bool = True, bottom: bool = True) -> tuple:
        """(top, bottom) halo rows of this rank for a conv reading one row above (top)
        and below (bottom): none at the map's own edges."""
        last = self.index == len(self.ranges) - 1
        return int(bool(top) and self.index > 0), int(bool(bottom) and not last)

    def pad_rows(self, x, top: bool = True, bottom: bool = True):
        """``x`` (this rank's rows) with the neighbours' edge rows above (``top``) and
        below (``bottom``), where there is a neighbour; no autograd. Every rank of the
        group must call it with the same flags."""
        up = x[:, :1].contiguous() if bottom else None  # the rank above's bottom halo
        down = x[:, -1:].contiguous() if top else None
        from_above, from_below = self._swap(up, down)
        parts = [p for p in (from_above, x, from_below) if p is not None]
        return torch.cat(parts, dim=1) if len(parts) > 1 else x

    def exchange(self, x, top: bool = True, bottom: bool = True):
        """``pad_rows`` with autograd: the halo rows' cotangents go back to the ranks
        that own the rows and are added to theirs."""
        return _HaloExchange.apply(x, self, bool(top), bool(bottom))

    def take(self, x):
        """This rank's rows of a map of the whole height (autograd: the other rows'
        cotangent is zero)."""
        if x.shape[1] != self.height:
            raise ValueError(f"BEV spatial partitioning: a map of {x.shape[1]} rows where "
                             f"the partition has {self.height}")
        return x[:, self.start : self.stop]

    def gather(self, x, same: bool = True):
        """The whole height on every rank of the group from each rank's rows. Backward:
        this rank's rows of the cotangent where every rank computes the same function
        of the gathered map (``same``), else the cotangent summed over the group first."""
        return _GatherRows.apply(x, self, bool(same))

    def _rank_of(self, index: int) -> int:
        return self.mesh.rank - self.index + index

    def _swap(self, up, down):
        """Send ``up`` (rows) to the rank above and ``down`` to the rank below; every
        rank of the group passes the same pattern (None: nobody sends that way).
        Returns (what the rank above sent down, what the rank below sent up), None at
        the group's edges and where nothing is sent."""
        i, n = self.index, len(self.ranges)
        group = self.mesh.spatial_group
        like = up if up is not None else down
        if like is None:
            return None, None
        if self.mesh.backend == "nccl":
            ops, from_above, from_below = [], None, None
            if down is not None:
                if i + 1 < n:
                    ops.append(dist.P2POp(dist.isend, down, self._rank_of(i + 1), group))
                if i > 0:
                    from_above = torch.empty_like(down)
                    ops.append(dist.P2POp(dist.irecv, from_above, self._rank_of(i - 1), group))
            if up is not None:
                if i > 0:
                    ops.append(dist.P2POp(dist.isend, up, self._rank_of(i - 1), group))
                if i + 1 < n:
                    from_below = torch.empty_like(up)
                    ops.append(dist.P2POp(dist.irecv, from_below, self._rank_of(i + 1), group))
            for req in dist.batch_isend_irecv(ops) if ops else ():
                req.wait()
            return from_above, from_below
        # gloo sends no CUDA tensor: every rank's edge rows in one all-reduced buffer
        buf = like.new_zeros((n, 2, *like.shape))
        if up is not None:
            buf[i, 0] = up
        if down is not None:
            buf[i, 1] = down
        dist.all_reduce(buf, group=group)
        from_above = buf[i - 1, 1] if down is not None and i > 0 else None
        from_below = buf[i + 1, 0] if up is not None and i + 1 < n else None
        return from_above, from_below

    def _gather(self, x):
        b, _, w, c = x.shape
        group = self.mesh.spatial_group
        if self.mesh.backend == "nccl":
            most = max(bb - a for a, bb in self.ranges)
            mine = x.new_zeros((b, most, w, c))
            mine[:, : self.rows] = x
            every = x.new_empty((len(self.ranges), b, most, w, c))
            dist.all_gather_into_tensor(every, mine.contiguous(), group=group)
            return torch.cat([every[j, :, : bb - a] for j, (a, bb) in enumerate(self.ranges)],
                             dim=1)
        full = x.new_zeros((b, self.height, w, c))
        full[:, self.start : self.stop] = x
        dist.all_reduce(full, group=group)
        return full


def spatial_slab(mesh: Mesh, height: int, factor: int = 1) -> RowSlab:
    """This rank's ``RowSlab`` of a map of ``height`` rows over ``mesh``'s spatial axis,
    partitioned at its coarsest level (``height / factor`` rows, which must be whole)."""
    if height % factor:
        raise ValueError(f"BEV spatial partitioning: {height} rows do not nest over the "
                         f"RPN's total stride {factor}")
    coarse = RowSlab(mesh, row_ranges(height // factor, mesh.spatial), height // factor)
    return coarse.scaled(factor)


@dataclasses.dataclass(frozen=True)
class SpatialSharding:
    """A detector's BEV spatial partitioning over ``mesh``'s spatial axis (tdal's
    ``spatial_sharding``; the data axis, where the mesh has one, shards the batch)."""

    mesh: Mesh

    def __deepcopy__(self, memo):
        return self  # its process groups are the process's, not the model's


def spatial_sharding(mesh: Mesh) -> SpatialSharding:
    """The counterpart of tdal's ``spatial_sharding(mesh, batch_axis)``: pass it to a
    detector's ``bev_sharding``."""
    if mesh.spatial < 2:
        raise ValueError("spatial_sharding needs a mesh with a spatial axis of 2 ranks or more")
    return SpatialSharding(mesh)
