"""The per-iteration reduction object and the tree it flows up.

What one worker ships per iteration (paper Alg. 2 line 6, plus the
stopping rule's same-pass reductions — DESIGN.md §8):

  * three n-vectors    d = D_i^T(y' - lam'), w = D_i^T(y' - y),
                       v = D_i^T lam'
  * five scalars       r_sq, dx_sq, y_sq, obj (Boyd residual/tolerance
                       inputs + telemetry) and the covered row count

— NOTHING m-sized. That is the entire point of transpose reduction: a
consensus/data-parallel scheme would move O(m_i) per worker per round.

Tree reduce: workers form a ``fanout``-ary heap over the membership
order; each node merges its children's contributions into its own and
ships ONE partial up, so the coordinator receives a single message per
iteration and no link carries more than one contribution — the shape
that scales past the coordinator's ingress at large N. The topology
carries an ``epoch``: membership changes bump it, and every in-flight
contribution is tagged so partials from a dead topology are discarded
instead of double-counted.

Compression composes per HOP: each worker quantizes the partial it
transmits (its own + dequantized children) with
:mod:`repro_torch.cluster.compress`; error feedback on the d-component is
per-sender, so each hop's rounding bias re-enters that hop's next
transmission and vanishes over iterations (w/v are stopping-rule-only
and quantized stateless).

Port of ``repro/cluster/reduction.py``. The wire format is the
reference's: a payload carries numpy float32 n-vectors (or int8 codes and
float32 scales), never a tensor — a pickled CUDA tensor would carry a
device handle, and float64 would double the bytes the counters report.
The port's :mod:`~repro_torch.cluster.compress` works on tensors; this
module wraps numpy arrays into CPU tensors for it (sharing memory) and
hands numpy back, with the reference's bits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cluster import compress

SCALARS = ("r_sq", "dx_sq", "y_sq", "obj")


@dataclasses.dataclass
class Contribution:
    """One (partial) reduction: a worker's own, or a merged subtree's."""

    iteration: int
    workers: Tuple[int, ...]            # who is folded in (subtree)
    rows: int                           # logical rows covered
    d: np.ndarray                       # (n,) f32
    w: np.ndarray
    v: np.ndarray
    scalars: Dict[str, float]

    def merge(self, other: "Contribution") -> "Contribution":
        assert self.iteration == other.iteration, \
            f"merging iterations {self.iteration} != {other.iteration}"
        return Contribution(
            iteration=self.iteration,
            workers=tuple(sorted(self.workers + other.workers)),
            rows=self.rows + other.rows,
            d=self.d + other.d, w=self.w + other.w, v=self.v + other.v,
            scalars={k: self.scalars[k] + other.scalars[k]
                     for k in SCALARS})

    @classmethod
    def zero(cls, iteration: int, n: int) -> "Contribution":
        z = np.zeros((n,), np.float32)
        return cls(iteration=iteration, workers=(), rows=0,
                   d=z, w=z.copy(), v=z.copy(),
                   scalars={k: 0.0 for k in SCALARS})


def _t(a) -> torch.Tensor:
    """A float32 CPU tensor over a numpy vector (shared where it can be)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def encode(c: Contribution, compressed: bool,
           ef_err: Optional[np.ndarray] = None
           ) -> Tuple[dict, Optional[np.ndarray]]:
    """Wire payload for one hop. ``compressed`` quantizes all three
    n-vectors to int8 (+ per-group scales); ``ef_err`` is the sender's
    error-feedback residual for d (returned updated — the caller owns
    it across iterations). Returns (payload, new_ef_err)."""
    n = int(c.d.shape[0])
    head = {"iteration": c.iteration, "workers": c.workers,
            "rows": c.rows, "n": n, "scalars": c.scalars,
            "compressed": compressed}
    # the three vectors travel PACKED as one array each way: per-array
    # pickle framing (~150 B) would otherwise rival the payload at
    # small n and hide the n-vs-m story the byte counters exist to tell
    if not compressed:
        head["dwv"] = np.stack(
            [np.asarray(c.d, np.float32), np.asarray(c.w, np.float32),
             np.asarray(c.v, np.float32)])
        return head, ef_err
    if ef_err is None:
        ef_err = np.zeros((n,), np.float32)
    qd, sd, new_err = (a.numpy() for a in
                       compress.ef_compress(_t(c.d), _t(ef_err)))
    qw, sw = (a.numpy() for a in compress.quantize_int8(_t(c.w)))
    qv, sv = (a.numpy() for a in compress.quantize_int8(_t(c.v)))
    head["q"] = np.stack([qd, qw, qv])
    head["s"] = np.stack([sd, sw, sv])
    return head, new_err


def decode(payload: dict) -> Contribution:
    """Inverse of :func:`encode`, with strict shape validation: a frame
    that unpickles but carries a malformed contribution (chaos-corrupted
    or truncated) must surface as ``ValueError`` here — which receivers
    treat like a dead link — never as a silently wrong reduction."""
    try:
        n = int(payload["n"])
        iteration = int(payload["iteration"])
        rows = int(payload["rows"])
        workers = tuple(int(w) for w in payload["workers"])
        scalars = {k: float(payload["scalars"][k]) for k in SCALARS}
        if payload["compressed"]:
            q, s = payload["q"], payload["s"]
            if q.shape[0] != 3 or s.shape[0] != 3:
                raise ValueError(f"bad q/s stack {q.shape}/{s.shape}")
            d, w, v = (compress.dequantize_int8(
                torch.from_numpy(np.asarray(q[i], np.int8)),
                _t(s[i]), n).numpy() for i in range(3))
        else:
            dwv = np.asarray(payload["dwv"], np.float32)
            if dwv.shape != (3, n):
                raise ValueError(f"bad dwv shape {dwv.shape} for n={n}")
            d, w, v = dwv
        if d.shape != (n,) or rows < 0 or iteration < 0:
            raise ValueError("inconsistent contribution fields")
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"malformed contribution payload: {e}") from e
    return Contribution(iteration=iteration, workers=workers,
                        rows=rows, d=d, w=w, v=v, scalars=scalars)


@dataclasses.dataclass(frozen=True)
class TreeTopology:
    """``fanout``-ary heap over the (sorted) live worker ids.

    position(wid) follows membership order; parent(pos) = (pos-1)//f.
    The root's parent is the coordinator. Deterministic from the member
    list, so coordinator and workers never need to exchange the full
    tree — each worker is told only its parent address and child count.
    """

    order: Tuple[int, ...]
    fanout: int = 2
    epoch: int = 0

    @classmethod
    def build(cls, worker_ids: Sequence[int], fanout: int = 2,
              epoch: int = 0) -> "TreeTopology":
        assert fanout >= 1
        return cls(order=tuple(sorted(worker_ids)), fanout=fanout,
                   epoch=epoch)

    @property
    def root(self) -> int:
        return self.order[0]

    def parent(self, wid: int) -> Optional[int]:
        pos = self.order.index(wid)
        if pos == 0:
            return None                  # root reports to the coordinator
        return self.order[(pos - 1) // self.fanout]

    def children(self, wid: int) -> List[int]:
        pos = self.order.index(wid)
        lo = self.fanout * pos + 1
        return [self.order[i]
                for i in range(lo, min(lo + self.fanout, len(self.order)))]

    def depth(self) -> int:
        """Hops from the deepest leaf to the coordinator (>= 1)."""
        d, pos = 1, len(self.order) - 1
        while pos > 0:
            pos = (pos - 1) // self.fanout
            d += 1
        return d
