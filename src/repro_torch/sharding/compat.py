"""Process groups: the port's analogue of ``repro/sharding/compat.py``.

The reference shards rows over a JAX device mesh inside one process. Here
a rank is one process on one device, and the ranks form one
``torch.distributed`` group (the default process group). This module is
the one place that makes, enters and describes that group:

  * :func:`make_group`    — context manager joining the group that
                            ``torchrun``'s environment describes, and
                            leaving it at the end (the reference's
                            ``make_mesh``); without ``torchrun``, the world
                            of one, :data:`SOLO`.
  * :data:`SOLO`          — a world of one in this process, with no process
                            group: every collective over it is the
                            identity, and it leaves no global state.
  * :func:`use_group`     — context manager making a group current
                            (``use_mesh``).
  * :func:`current_group` — the entered group, else the default process
                            group, else None (``current_mesh``).
  * :func:`axis_size`     — the world size.
  * :func:`spawn`         — run a function on ``world`` ranks of a new group
                            (``torch.multiprocessing`` under ``spawn``) and
                            return each rank's result; a rank's failure is
                            re-raised with its traceback, and a rank that
                            hangs fails the call at its timeout.
  * :func:`layout_backend` and :func:`rank_device` — the backend and the
    device by layout: NCCL when each rank has its own card; gloo on the CPU
    and when ranks share a card (NCCL refuses two ranks on one device).
  * :func:`shard_rows` and :class:`RowShard` — one rank's rows of a
    zero-padded array.
  * :class:`Grid`, :func:`make_grid`, :func:`join_grid`, :func:`use_grid`
    and :func:`current_grid` — a named grid of ranks (the reference's 2-D
    and 3-D meshes, ``("data", "model")`` or ``("pod", "data", "model")``):
    a pure description until a process group of its size is up, then also
    this rank's coordinates and one sub-group per axis line.
  * :func:`all_to_all`, :func:`all_gather_cat` and :func:`all_reduce_sum` —
    the collectives on one axis line, staged through pinned host buffers
    when a gloo group carries CUDA tensors.

``cost_analysis`` and ``shard_map`` are XLA's and have no counterpart: a
rank runs its own program on its own rows, and no compiled module exists
to analyse.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import gc
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Ranks a CPU run of the shard_map path starts when nothing else says (the
# counterpart of the reference tests' XLA_FLAGS
# --xla_force_host_platform_device_count=8): ``REPRO_TORCH_CPU_RANKS=8``.
CPU_RANKS_ENV = "REPRO_TORCH_CPU_RANKS"
DEFAULT_TIMEOUT = 600.0           # seconds, per spawn and per collective

_CURRENT: contextvars.ContextVar[Optional["Group"]] = contextvars.ContextVar(
    "repro_torch_group", default=None)


@dataclasses.dataclass(frozen=True)
class Group:
    """A group of ranks as one of them sees it: the default process group,
    or ``SOLO``."""

    world: int
    rank: int
    backend: str                  # "nccl", "gloo", or "none" for SOLO
    local_rank: int = 0           # rank among the ranks of this host


# A world of one in this process: no process group, no collective.
SOLO = Group(1, 0, "none")


def layout_backend(device, ranks_per_host: int) -> str:
    """NCCL when the ranks are on the card and each has its own card,
    gloo otherwise (the CPU, or ranks that share a card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """The device of local rank ``local_rank``: card ``local_rank`` modulo
    the card count for an unindexed ``cuda`` (so ranks beyond the cards
    share them), ``device`` itself otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def local_world(device) -> int:
    """Ranks this host runs on its own: one per visible card, or on the CPU
    the count in ``REPRO_TORCH_CPU_RANKS`` (default 1)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return int(os.environ.get(CPU_RANKS_ENV, "1"))


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def current_group() -> Optional[Group]:
    """The group entered with :func:`use_group`, else the default process
    group when one is initialized, else None."""
    g = _CURRENT.get()
    if g is not None or not dist.is_initialized():
        return g
    rank = dist.get_rank()
    return Group(dist.get_world_size(), rank, dist.get_backend(),
                 int(os.environ.get("LOCAL_RANK", rank)))


@contextlib.contextmanager
def use_group(group: Group):
    """Make ``group`` the current group inside the block."""
    token = _CURRENT.set(group)
    try:
        yield group
    finally:
        _CURRENT.reset(token)


def axis_size(group=None) -> int:
    """The world size of ``group`` (default: the current group; 1 without
    one). An axis name, or a tuple of them, gives the size of that axis of
    the current grid (the reference's ``compat.axis_size(axis)``): 1 without
    a grid, where every axis is a world of one."""
    if isinstance(group, (str, tuple)):
        grid = current_grid()
        return 1 if grid is None else grid.axis_size(group)
    g = group if group is not None else current_group()
    return 1 if g is None else g.world


@contextlib.contextmanager
def make_group(device="cuda"):
    """Join the group that ``torchrun``'s environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``/``PORT``) on the backend :func:`layout_backend` picks
    for ``device``, and yield it; a CUDA rank's current device becomes its
    card. The default process group is destroyed on leaving the block.
    Without ``torchrun`` this yields :data:`SOLO` and touches nothing."""
    if not launched_by_torchrun():
        yield SOLO
        return
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    backend = layout_backend(
        device, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    dev = rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank,
                            timeout=timedelta(seconds=DEFAULT_TIMEOUT),
                            device_id=dev if backend == "nccl" else None)
    try:
        yield Group(world, rank, backend, local)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# grids of ranks
# ---------------------------------------------------------------------------

_GRID: contextvars.ContextVar[Optional["Grid"]] = contextvars.ContextVar(
    "repro_torch_grid", default=None)


@dataclasses.dataclass(frozen=True)
class Grid:
    """A named grid of ranks, the port's counterpart of a JAX ``Mesh``.

    Rank r sits at the row-major coordinates of r in ``shape`` (the device
    order of ``jax.make_mesh`` on host devices). As made by
    :func:`make_grid` it is a pure description: nothing is allocated and no
    group is joined, so the dry-run can use the production layouts. As
    returned by :func:`join_grid` it also holds this rank and, per axis,
    the process group of this rank's line along that axis (None where the
    axis has size 1, or for the whole world when the line is the world)."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    rank: Optional[int] = None
    groups: Tuple[Any, ...] = ()

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"grid shape {self.shape} and axes "
                             f"{self.axes} differ in length")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.axes

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def joined(self) -> bool:
        return self.rank is not None

    def axis_size(self, axis) -> int:
        """The size of one axis, or the product over a tuple of axes."""
        if isinstance(axis, tuple):
            return int(np.prod([self.axis_size(a) for a in axis],
                               dtype=np.int64))
        return self.shape[self.axes.index(axis)]

    def coords_of(self, rank: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(rank, self.shape))

    def index(self, axis, coords: Optional[Sequence[int]] = None) -> int:
        """This rank's (or ``coords``') index along ``axis``; along a tuple
        of axes, the row-major index over them (how a dimension split over
        several axes is tiled)."""
        if coords is None and self.rank is None:
            raise ValueError("a grid description has no rank: join it")
        c = self.coords_of(self.rank) if coords is None else tuple(coords)
        names = axis if isinstance(axis, tuple) else (axis,)
        i = 0
        for a in names:
            i = i * self.axis_size(a) + c[self.axes.index(a)]
        return i

    def line(self, axis, rank: Optional[int] = None) -> List[int]:
        """The ranks of ``rank``'s line along ``axis``, in axis order."""
        c = list(self.coords_of(self.rank if rank is None else rank))
        k = self.axes.index(axis)
        out = []
        for j in range(self.shape[k]):
            c[k] = j
            out.append(int(np.ravel_multi_index(c, self.shape)))
        return out

    def group(self, axis):
        """The process group of this rank's line along ``axis``."""
        if not self.joined:
            raise ValueError("a grid description has no groups: join it")
        return self.groups[self.axes.index(axis)]


def make_grid(shape: Sequence[int], axes: Sequence[str]) -> Grid:
    """A grid description (the reference's ``make_mesh``)."""
    return Grid(tuple(int(s) for s in shape), tuple(axes))


def join_grid(grid: Grid) -> Grid:
    """``grid`` with this rank's coordinates and one ``dist.new_group`` per
    axis line, inside a process group of exactly ``grid.size`` ranks. Every
    rank makes every line's group in the same order, as ``new_group``
    requires; a line of one rank gets no group, and a line that is the
    whole world takes the default group."""
    if not dist.is_initialized():
        raise RuntimeError("join_grid needs an initialized process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != grid.size:
        raise ValueError(f"grid {grid.shape} needs {grid.size} ranks, the "
                         f"group has {world}")
    groups = []
    for axis, n in zip(grid.axes, grid.shape):
        mine = None
        if n == world:
            mine = dist.group.WORLD
        elif n > 1:
            lines = sorted({tuple(grid.line(axis, r)) for r in range(world)})
            for ranks in lines:
                g = dist.new_group(list(ranks))
                if rank in ranks:
                    mine = g
        groups.append(mine)
    return dataclasses.replace(grid, rank=rank, groups=tuple(groups))


def current_grid() -> Optional[Grid]:
    """The grid entered with :func:`use_grid`, or None."""
    return _GRID.get()


@contextlib.contextmanager
def use_grid(grid: Optional[Grid]):
    """Make ``grid`` the current grid inside the block."""
    token = _GRID.set(grid)
    try:
        yield grid
    finally:
        _GRID.reset(token)


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group: gloo has no card path for every
    collective, so the hop goes through pinned host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Equal chunks of dim 0 of ``t``, chunk j to rank j of ``group``;
    chunk i of the result came from rank i (``jax.lax.all_to_all(x, axis,
    0, 0, tiled=False)`` on (M, ...) buffers)."""
    if _staged(t, group):
        host = _to_host(t.contiguous())
        out = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        dist.all_to_all_single(out, host, group=group)
        return out.to(t.device)
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in rank
    order."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _to_host(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group`` (a new tensor)."""
    if _staged(t, group):
        host = _to_host(t)
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


# ---------------------------------------------------------------------------
# row shards
# ---------------------------------------------------------------------------

def shard_rows(arr, rank: int, world: int):
    """Rank ``rank``'s rows of ``arr`` zero-padded to a multiple of
    ``world`` rows: ``ceil(m / world)`` rows, a view where no padding falls
    in them. Takes numpy arrays and tensors and returns the same kind."""
    m = arr.shape[0]
    per = -(-m // world)
    start = min(rank * per, m)
    stop = min(start + per, m)
    part = arr[start:stop]
    if stop - start == per:
        return part
    pad = (per - (stop - start),) + tuple(arr.shape[1:])
    if isinstance(arr, np.ndarray):
        return np.concatenate([part, np.zeros(pad, arr.dtype)])
    return torch.cat([part, part.new_zeros(pad)])


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A placement: rank ``rank``'s rows (of ``world``) of the zero-padded
    array, on ``device`` (the CPU when None)."""

    rank: int
    world: int
    device: Optional[torch.device] = None

    def take(self, t: torch.Tensor) -> torch.Tensor:
        part = shard_rows(t, self.rank, self.world)
        return part if self.device is None else part.to(self.device)


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------

def _host(obj):
    """Tensors in a result as numpy arrays: a CUDA tensor cannot outlive
    the rank that made it, and a shared CPU tensor would hold a file
    descriptor open."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world, backend, init_file, device, timeout,
               threads, inbox, results):
    """One rank: join the group, take the arguments from ``inbox``, run
    ``fn(*args)`` inside the group, drop the arguments, report."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        # NCCL binds its rank to its card at init (and builds the
        # communicator then, not at the first collective)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout),
                                device_id=dev if backend == "nccl" else None)
        args = inbox.get()
        with use_group(Group(world, rank, backend, rank)):
            out = _host(fn(*args))
        # release shared tensors (a CUDA IPC view holds its producer's
        # memory) before the parent learns that this rank is done
        del args
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.destroy_process_group()
    except Exception:
        # the boundary of the rank: report the traceback to the parent,
        # then exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def spawn(fn: Callable, world: int, backend: str, *,
          args: Sequence[Any] = (), device="cuda",
          timeout: float = DEFAULT_TIMEOUT,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` new ranks, each inside
    ``use_group`` of one ``backend`` group; returns the results in rank
    order (tensors in them as numpy arrays).

    ``fn`` is pickled by import path: define it in a module the rank can
    import without JAX. Tensors in ``args`` are shared, not copied: CPU
    tensors through shared memory, CUDA tensors through CUDA IPC, so a rank
    can take a view of its rows of one array on the card; the caller keeps
    them alive until this returns. The ranks meet through a rendezvous file
    in a fresh temporary directory. Rank r computes on
    ``rank_device(device, r)``; ``threads`` sets each rank's CPU thread
    count. A rank that raises fails the call with its traceback; a rank
    that exits without a result, or a call that passes ``timeout`` seconds,
    fails it too. Every rank is stopped before this returns or raises."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
    init_file = os.path.join(tmp, "rendezvous")
    inbox, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, init_file,
                               str(device), timeout, threads, inbox,
                               results))
             for r in range(world)]
    ok = False
    try:
        for p in procs:
            p.start()
        for _ in procs:
            inbox.put(tuple(args))
        out = _collect(procs, results, timeout)
        ok = True
        return out
    finally:
        if ok:                    # let finished ranks exit on their own
            for p in procs:
                p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=60)
        for q in (inbox, results):
            q.close()
        # arguments a failed rank never took must not hold this process's
        # exit on their pipe
        inbox.cancel_join_thread()
        shutil.rmtree(tmp, ignore_errors=True)


def _collect(procs, results, timeout: float) -> List[Any]:
    """Each rank's result, in rank order; raises on a failed, vanished or
    late rank."""
    world = len(procs)
    deadline = time.monotonic() + timeout
    out = {}
    gone_since = None
    while len(out) < world:
        left = deadline - time.monotonic()
        if left <= 0:
            missing = [r for r in range(world) if r not in out]
            raise TimeoutError(f"ranks {missing} of {world} did not finish "
                               f"within {timeout:.0f} s")
        try:
            rank, ok, payload = results.get(timeout=min(left, 1.0))
        except queue_mod.Empty:
            gone = [r for r, p in enumerate(procs)
                    if r not in out and p.exitcode is not None]
            if not gone:
                gone_since = None
                continue
            # a rank's last put may still be in the pipe: give it 2 s
            gone_since = gone_since or time.monotonic()
            if time.monotonic() - gone_since > 2.0:
                codes = [procs[r].exitcode for r in gone]
                raise RuntimeError(f"ranks {gone} of {world} exited "
                                   f"(codes {codes}) without a result")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
        out[rank] = payload
    return [out[r] for r in range(world)]
