"""Collective traffic, operation counts and the 3-term roofline on the
H100; port of ``repro/roofline/hlo.py``.

The reference parses XLA's optimized HLO for collectives. The port has no
compiled module, so :class:`CollectiveStats` is filled from records of
(kind, result shape and dtype, group size), which come from two sources:

  * :class:`CollectiveRecorder` — a context manager that records every
    ``torch.distributed`` collective issued inside it (the a2a hops, the
    ADMM reductions), real or on a fake process group;
  * the dry-run's layout rules (``launch.dryrun``), which model the
    collectives a sharded step would issue.

Accounting (per device, ring algorithm), as in the reference:
  all-reduce       2 * size * (G-1)/G      (reduce-scatter + all-gather)
  all-gather       out_size * (G-1)/G
  reduce-scatter   in_size  * (G-1)/G
  all-to-all       size * (G-1)/G
  collective-permute  size
plus the raw operand-size sum; the time term uses the ring wire bytes.

:class:`OpCounter` counts FLOPs (``torch.utils.flop_counter``'s formulas:
matrix products, convolutions and attention, plus matrix-vector products;
elementwise work is not counted) and bytes: each aten op's operand and result bytes, views
excluded. That is an UNFUSED count: XLA's "bytes accessed" counts after
fusion, where a chain of elementwise ops reads its input once, so the
port's byte counts are an upper bound on what a fused program moves.

Hardware constants: the H100 SXM's published peaks (``PEAKS``, by card
name, the one table the smoke script also reads) and one link rate per hop
kind: NVLink 4 at 450 GB/s per direction between the 8 cards of a node
(NVIDIA H100 data sheet: 900 GB/s bidirectional), 400 Gb/s InfiniBand
(50 GB/s a card, one ConnectX-7 per card, DGX H100 data sheet) between
nodes. A group that spans nodes is timed at the slower rate.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# HBM bytes/s, FP32 (non-tensor) FLOP/s and bf16 tensor-core FLOP/s, by
# the card's name.
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 835e12),
         "H100": (3.35e12, 67e12, 989.4e12)}


def peaks(name: str):
    """(key, (HBM B/s, FP32 FLOP/s, bf16 FLOP/s)) of the first ``PEAKS``
    key in ``name``; the H100 SXM's when none is."""
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


HBM_BW, PEAK_FP32, PEAK_FLOPS = PEAKS["H100"]
NVLINK_BW = 450e9            # bytes/s per direction per card, NVLink 4
IB_BW = 50e9                 # bytes/s per card, 400 Gb/s InfiniBand
CARDS_PER_NODE = 8

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

# torch dtypes under the HLO names above
_TORCH_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def dtype_name(dtype) -> str:
    """The HLO name of a torch dtype (or an HLO name as it is)."""
    return dtype if isinstance(dtype, str) else _TORCH_NAMES[dtype]


def shape_bytes(shape: Sequence[int], dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES[dtype_name(dtype)]


def record(kind: str, shape: Sequence[int], dtype, group: int, *,
           spans_nodes: bool = False, what: str = "") -> Dict:
    """One collective: its result's shape and dtype, its group size, and
    the reference's per-device byte accounting."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    out_bytes = shape_bytes(shape, dtype)
    g = max(int(group), 1)
    if kind == "all-reduce":
        operand = out_bytes
        wire = int(2 * out_bytes * (g - 1) / g)
    elif kind == "all-gather":
        operand = out_bytes // g
        wire = int(out_bytes * (g - 1) / g)
    elif kind == "reduce-scatter":
        operand = out_bytes * g
        wire = int(operand * (g - 1) / g)
    elif kind == "all-to-all":
        operand = out_bytes
        wire = int(out_bytes * (g - 1) / g)
    else:  # collective-permute
        operand = out_bytes
        wire = out_bytes
    return {"kind": kind, "bytes": out_bytes, "group": g,
            "operand_bytes": operand, "wire_bytes": wire,
            "spans_nodes": bool(spans_nodes), "what": what}


@dataclasses.dataclass
class CollectiveStats:
    ops: List[Dict]
    operand_bytes: int           # sum of operand sizes
    wire_bytes: int              # ring-model bytes per device

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            out[op["kind"]] = out.get(op["kind"], 0) + op["wire_bytes"]
        return out

    def seconds(self) -> float:
        """Each op's wire bytes at its link's rate (NVLink within a node,
        InfiniBand for a group that spans nodes)."""
        return sum(op["wire_bytes"] / (IB_BW if op["spans_nodes"]
                                       else NVLINK_BW) for op in self.ops)


def stats(ops: Sequence[Dict]) -> CollectiveStats:
    """``CollectiveStats`` of a list of :func:`record` dicts."""
    ops = list(ops)
    return CollectiveStats(ops, sum(o["operand_bytes"] for o in ops),
                           sum(o["wire_bytes"] for o in ops))


def spans_nodes(ranks: Sequence[int],
                cards_per_node: int = CARDS_PER_NODE) -> bool:
    """Whether ranks (one a card, ``cards_per_node`` consecutive ranks a
    node) lie on more than one node."""
    return len({r // cards_per_node for r in ranks}) > 1


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   collective, *, peak_flops: float = PEAK_FLOPS,
                   link_bw: float = NVLINK_BW) -> Dict[str, float]:
    """Three per-device time terms (seconds) + the dominant bottleneck.
    ``collective`` is wire bytes (timed at ``link_bw``) or a
    ``CollectiveStats`` (each op at its own link's rate); ``peak_flops``
    is the bf16 tensor-core peak unless the work is FP32
    (``PEAK_FP32``)."""
    t_compute = flops_per_device / peak_flops
    t_memory = hbm_bytes_per_device / HBM_BW
    if isinstance(collective, CollectiveStats):
        t_collective = collective.seconds()
    else:
        t_collective = float(collective) / link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    # Roofline fraction: useful-compute time over the max term (how close the
    # dominant resource is to being the only cost).
    tmax = max(t_compute, t_memory, t_collective)
    terms["compute_fraction_of_bound"] = t_compute / tmax if tmax > 0 else 0.0
    return terms


# ---------------------------------------------------------------------------
# the collective recorder
# ---------------------------------------------------------------------------

class CollectiveRecorder:
    """Records every ``torch.distributed`` collective issued while it is
    active (``with CollectiveRecorder() as rec:``), as :func:`record`
    dicts in ``rec.ops``; ``rec.stats()`` sums them. It wraps the module
    functions in ``KINDS_BY_CALL`` (a broadcast is recorded as a
    collective-permute of its tensor) and restores them on exit; callers
    that look the functions up on ``torch.distributed`` at call time, as
    the port does, are seen. A group's ranks are read as cards, eight
    consecutive ones a node (``spans_nodes``)."""

    # call -> (kind, the argument whose shape is the result's)
    KINDS_BY_CALL = {
        "all_reduce": ("all-reduce", 0),
        "all_gather": ("all-gather", 1),       # a list out; one part in
        "all_gather_into_tensor": ("all-gather", 0),
        "reduce_scatter_tensor": ("reduce-scatter", 0),
        "all_to_all_single": ("all-to-all", 0),
        "broadcast": ("collective-permute", 0),
    }

    def __init__(self):
        self.ops: List[Dict] = []
        self._saved = {}

    def _wrap(self, name, fn):
        kind, arg = self.KINDS_BY_CALL[name]

        def wrapper(*args, **kwargs):
            group = kwargs.get("group")
            g = dist.get_world_size(group)
            ranks = dist.get_process_group_ranks(
                group if group is not None else dist.group.WORLD)
            t = args[arg]
            shape = tuple(t.shape)
            if name == "all_gather":
                shape = (g * shape[0],) + shape[1:] if shape else (g,)
            self.ops.append(record(kind, shape, t.dtype, g, what=name,
                                   spans_nodes=spans_nodes(ranks)))
            return fn(*args, **kwargs)

        return wrapper

    def __enter__(self):
        for name in self.KINDS_BY_CALL:
            fn = getattr(dist, name)
            self._saved[name] = fn
            setattr(dist, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        self._saved.clear()
        return False

    def stats(self) -> CollectiveStats:
        return stats(self.ops)


# ---------------------------------------------------------------------------
# the operation counter
# ---------------------------------------------------------------------------

def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


# ops that return a view of their input without saying so in their schema
_UNANNOTATED_VIEWS = (torch.ops.aten._unsafe_view.default,)


def _is_view(func) -> bool:
    if func in _UNANNOTATED_VIEWS:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


_META_BINCOUNT = torch.ops.aten.bincount.default

# matrix-vector products, which the registry leaves out: 2 m n
_aten = torch.ops.aten
_MV_FLOPS = {
    _aten.mv: lambda a, v, *_, **__: 2 * a.shape[0] * a.shape[1],
    _aten.addmv: lambda c, a, v, *_, **__: 2 * a.shape[0] * a.shape[1],
    _aten.dot: lambda a, b, *_, **__: 2 * a.shape[0],
}


class OpCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten op run inside it
    (``with OpCounter() as c:`` then ``c.flops``, ``c.bytes``). FLOPs by
    ``torch.utils.flop_counter``'s formulas, and 2 m n for the
    matrix-vector products it leaves out; bytes as the unfused sum of
    each op's tensor operands and results, views excluded (see the module
    docstring). On the meta device it also stands in for the one data-
    dependent op the LM path runs, ``bincount`` with ``minlength``, whose
    result has ``minlength`` bins when the values are below it (expert and
    rank ids always are)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_op: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _META_BINCOUNT and args[0].is_meta:
            n = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            w = kwargs.get("weights", args[1] if len(args) > 1 else None)
            dt = torch.int64 if w is None else w.dtype
            out = torch.empty((int(n),), dtype=dt, device="meta")
        else:
            out = func(*args, **kwargs)
        packet = func._overloadpacket
        f = None
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
        elif packet in _MV_FLOPS:
            f = int(_MV_FLOPS[packet](*args, **kwargs))
        if f is not None:
            self.flops += f
            self.by_op[str(packet)] = self.by_op.get(str(packet), 0) + f
        if not _is_view(func):
            self.bytes += _tensor_bytes(list(args)) \
                + _tensor_bytes(list(kwargs.values())) + _tensor_bytes(out)
        return out


@contextlib.contextmanager
def counting():
    """An :class:`OpCounter` and a :class:`CollectiveRecorder` together:
    ``with counting() as (ops, coll):``."""
    with CollectiveRecorder() as coll, OpCounter() as ops:
        yield ops, coll

