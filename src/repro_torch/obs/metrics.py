"""Process-local, thread-safe metrics registry (DESIGN.md §12).

One registry = one process's counters, gauges, and histograms, each
addressed by ``(name, labels)``. The registry exists to replace the
repo's scattered one-off accounting (``service.server.ServerCounters``'
racy ``+=`` fields, ``cluster.transport.ByteCounter``'s hand-rolled
dicts) with ONE mergeable schema:

  * ``snapshot()`` produces a plain-JSON dict that crosses process
    boundaries (cluster workers ship theirs in heartbeats and at
    shutdown);
  * ``merge(snapshot)`` folds another process's snapshot in — counters
    and histogram bucket counts ADD, gauges take the incoming value,
    min/max combine — optionally relabelled (``extra_labels``) so a
    coordinator can keep per-worker series side by side;
  * histograms use FIXED log-spaced buckets (32 per decade over
    [1e-7, 1e5)), so merged percentile estimates are exact merges of the
    underlying distributions: quantile error is bounded by the bucket
    width (a factor of 10^(1/32) ≈ 7.5%, ≈ 3.7% at the geometric
    midpoint) regardless of how many snapshots were folded.

Everything here is pure stdlib and allocation-light: an ``inc`` or
``observe`` is one lock acquire + dict update, cheap enough for
per-block hot paths on the HOST side (never called from jitted code —
DESIGN.md §12's overhead budget).

Copy of ``repro/obs/metrics.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, Optional, Tuple

# -- fixed log-spaced histogram geometry -------------------------------------
HIST_LO = 1e-7                  # 100 ns — below any timeable latency
HIST_DECADES = 12               # up to 1e5 (> a day, in seconds)
BUCKETS_PER_DECADE = 32
NBUCKETS = HIST_DECADES * BUCKETS_PER_DECADE
# counts index 0 = underflow (v < HIST_LO), 1..NBUCKETS = log buckets,
# NBUCKETS + 1 = overflow.

_LabelKey = Tuple[Tuple[str, str], ...]


def _key(name: str, labels: Dict[str, str]) -> Tuple[str, _LabelKey]:
    return (name, tuple(sorted((str(k), str(v))
                               for k, v in labels.items())))


def _bucket_index(v: float) -> int:
    if not v > 0 or v < HIST_LO:
        return 0
    i = 1 + int(math.log10(v / HIST_LO) * BUCKETS_PER_DECADE)
    return min(i, NBUCKETS + 1)


def _bucket_mid(i: int) -> float:
    """Geometric midpoint of bucket i (1-based log buckets)."""
    lo = HIST_LO * 10.0 ** ((i - 1) / BUCKETS_PER_DECADE)
    return lo * 10.0 ** (0.5 / BUCKETS_PER_DECADE)


class Histogram:
    """Sparse fixed-bucket histogram. NOT thread-safe on its own — the
    registry serializes access; standalone use is single-threaded
    (snapshot decoding in reports)."""

    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float):
        v = float(v)
        i = _bucket_index(v)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile (q in [0, 1]) from the buckets; the
        estimate is clamped to the observed [min, max]."""
        if self.count == 0:
            return None
        target = max(1.0, math.ceil(q * self.count))
        cum = 0
        for i in sorted(self.counts):
            cum += self.counts[i]
            if cum >= target:
                if i == 0:
                    est = HIST_LO
                elif i == NBUCKETS + 1:
                    est = self.max
                else:
                    est = _bucket_mid(i)
                return min(max(est, self.min), self.max)
        return self.max

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def merge(self, other: "Histogram"):
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.sum += other.sum
        self.count += other.count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def to_snapshot(self) -> dict:
        return {"counts": {str(i): c for i, c in self.counts.items()},
                "sum": self.sum, "count": self.count,
                "min": (None if self.count == 0 else self.min),
                "max": (None if self.count == 0 else self.max)}

    @classmethod
    def from_snapshot(cls, d: dict) -> "Histogram":
        h = cls()
        h.counts = {int(i): int(c) for i, c in d.get("counts", {}).items()}
        h.sum = float(d.get("sum", 0.0))
        h.count = int(d.get("count", 0))
        h.min = math.inf if d.get("min") is None else float(d["min"])
        h.max = -math.inf if d.get("max") is None else float(d["max"])
        return h


def summarize_histogram(snap: dict, scale: float = 1.0) -> dict:
    """p50/p90/p99 + mean/count from one histogram snapshot (values
    multiplied by ``scale``, e.g. 1e3 for seconds -> ms)."""
    h = Histogram.from_snapshot(snap)
    r = lambda v: None if v is None else round(v * scale, 6)  # noqa: E731
    return {"count": h.count, "mean": r(h.mean), "p50": r(h.quantile(0.5)),
            "p90": r(h.quantile(0.9)), "p99": r(h.quantile(0.99)),
            "min": r(None if h.count == 0 else h.min),
            "max": r(None if h.count == 0 else h.max)}


class MetricsRegistry:
    """Thread-safe counters / gauges / histograms with labels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _LabelKey], float] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], float] = {}
        self._hists: Dict[Tuple[str, _LabelKey], Histogram] = {}

    # -- write paths --------------------------------------------------------
    def inc(self, name: str, value: float = 1, **labels):
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + value

    def set_gauge(self, name: str, value: float, **labels):
        with self._lock:
            self._gauges[_key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels):
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = Histogram()
            h.observe(value)

    # -- read paths ---------------------------------------------------------
    def counter_value(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(_key(name, labels), 0)

    def labeled(self, name: str, label: str) -> Dict[str, float]:
        """{label value -> counter value} for every counter named
        ``name`` that carries ``label`` (the ByteCounter per-message-type
        view)."""
        out: Dict[str, float] = {}
        with self._lock:
            for (n, lk), v in self._counters.items():
                if n != name:
                    continue
                d = dict(lk)
                if label in d:
                    out[d[label]] = out.get(d[label], 0) + v
        return out

    def quantile(self, name: str, q: float, **labels) -> Optional[float]:
        with self._lock:
            h = self._hists.get(_key(name, labels))
            return h.quantile(q) if h is not None else None

    def histogram_snapshot(self, name: str, **labels) -> Optional[dict]:
        with self._lock:
            h = self._hists.get(_key(name, labels))
            return h.to_snapshot() if h is not None else None

    # -- snapshot / merge ----------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": [{"name": n, "labels": dict(lk), "value": v}
                             for (n, lk), v in self._counters.items()],
                "gauges": [{"name": n, "labels": dict(lk), "value": v}
                           for (n, lk), v in self._gauges.items()],
                "histograms": [{"name": n, "labels": dict(lk),
                                **h.to_snapshot()}
                               for (n, lk), h in self._hists.items()],
            }

    def merge(self, snap: dict, extra_labels: Optional[Dict[str, str]] = None):
        """Fold another registry's :meth:`snapshot` in. ``extra_labels``
        relabel the incoming series (e.g. ``{"worker": "3"}``) so merged
        processes stay distinguishable."""
        extra = extra_labels or {}
        with self._lock:
            for e in snap.get("counters", []):
                k = _key(e["name"], {**e.get("labels", {}), **extra})
                self._counters[k] = self._counters.get(k, 0) + e["value"]
            for e in snap.get("gauges", []):
                k = _key(e["name"], {**e.get("labels", {}), **extra})
                self._gauges[k] = e["value"]
            for e in snap.get("histograms", []):
                k = _key(e["name"], {**e.get("labels", {}), **extra})
                h = self._hists.get(k)
                if h is None:
                    h = self._hists[k] = Histogram()
                h.merge(Histogram.from_snapshot(e))


def snapshot_counters(snap: dict, name: str) -> float:
    """Sum of every counter named ``name`` in a snapshot (labels folded)."""
    return sum(e["value"] for e in snap.get("counters", [])
               if e["name"] == name)


def snapshot_histograms(snap: dict, name: str) -> Iterable[dict]:
    return [e for e in snap.get("histograms", []) if e["name"] == name]


def merged_histogram(snaps: Iterable[dict]) -> Histogram:
    h = Histogram()
    for s in snaps:
        h.merge(Histogram.from_snapshot(s))
    return h
