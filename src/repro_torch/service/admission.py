"""Admission control for the networked fit service (DESIGN.md §15).

The front end must degrade instead of failing: under overload it says
"no, retry later" *immediately* (bounded queue + per-tenant token
quotas), and when the expensive cold-solve backend starts failing or
blowing its budget it stops feeding it (circuit breaker) and serves
degraded answers from cache instead of letting the queue collapse.

Three small, independently testable pieces:

  * :class:`TokenBucket` — per-tenant request quota: ``rate`` tokens/s
    refill up to ``burst``; an empty bucket yields a retry-after hint
    (when the next token lands) rather than queueing the request.
  * :class:`AdmissionController` — tenant buckets + a bounded global
    queue.  ``admit`` is the ONLY gate between a decoded fit frame and
    the solve queue; everything it turns away is answered
    ``status="rejected"`` with a retry-after hint, never silently
    dropped or left to grow an unbounded backlog.
  * :class:`CircuitBreaker` — classic closed → open → half-open.
    ``failure_threshold`` consecutive cold-solve failures (exceptions
    OR blown budgets) open it; while open every cold request sheds to a
    degraded cached answer at zero backend cost; after ``reset_after_s``
    one probe request is let through and its outcome closes or re-opens
    the breaker.

All three are thread-safe: handler threads admit concurrently, the
solver thread records breaker outcomes.

Copy of ``repro/service/admission.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

from repro_torch.obs.metrics import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class Admission:
    """Outcome of one admission decision."""
    ok: bool
    reason: str = ""              # "" | "queue_full" | "quota"
    retry_after_s: float = 0.0    # hint shipped on rejected responses


class TokenBucket:
    """Standard token bucket; NOT thread-safe on its own — the
    controller serializes access."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_last = time.monotonic()

    def try_take(self, now: Optional[float] = None) -> Admission:
        now = time.monotonic() if now is None else now
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return Admission(ok=True)
        retry = (1.0 - self.tokens) / self.rate if self.rate > 0 else 1.0
        return Admission(ok=False, reason="quota",
                         retry_after_s=round(retry, 4))


class AdmissionController:
    """Per-tenant quotas + a bounded global queue.

    ``max_queue`` bounds how many admitted-but-unanswered requests may
    exist at once (the front end passes its live in-flight count);
    ``tenant_rate``/``tenant_burst`` parameterize each tenant's bucket
    (``None`` rate = unmetered tenants, queue bound still applies).
    """

    def __init__(self, max_queue: int = 256,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 max_labeled_tenants: int = 32):
        self.max_queue = int(max_queue)
        self.tenant_rate = tenant_rate
        self.tenant_burst = (float(tenant_burst) if tenant_burst is not None
                             else (2.0 * tenant_rate if tenant_rate else 0.0))
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self.admitted = 0
        self.rejected = 0
        # Optional per-tenant labelled series (admission.admitted /
        # admission.rejected / admission.tokens gauges) for the scrape
        # endpoint. Tenant names come off the wire, so label cardinality
        # is bounded: the first ``max_labeled_tenants`` distinct names
        # get their own label, later ones collapse into "_other" — a
        # hostile client inventing tenants cannot grow the registry.
        self._registry = registry
        self._max_labeled = int(max_labeled_tenants)
        self._labeled: set = set()

    def _label(self, tenant: str) -> str:
        # caller holds the lock
        if tenant in self._labeled:
            return tenant
        if len(self._labeled) < self._max_labeled:
            self._labeled.add(tenant)
            return tenant
        return "_other"

    def admit(self, tenant: str, in_flight: int) -> Admission:
        """One decision: queue bound first (overload protection beats
        fairness), then the tenant's bucket."""
        with self._lock:
            reg = self._registry
            label = self._label(tenant) if reg is not None else tenant
            if reg is not None:
                reg.set_gauge("admission.queue_depth", in_flight)
            if in_flight >= self.max_queue:
                self.rejected += 1
                if reg is not None:
                    reg.inc("admission.rejected", tenant=label,
                            reason="queue_full")
                # the backlog drains at the service rate; a full queue's
                # retry hint is proportional to how deep the caller
                # would have been, floored so clients do not hammer
                return Admission(ok=False, reason="queue_full",
                                 retry_after_s=max(0.05,
                                                   0.002 * in_flight))
            if self.tenant_rate is not None:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = TokenBucket(
                        self.tenant_rate, self.tenant_burst)
                adm = bucket.try_take()
                if reg is not None:
                    reg.set_gauge("admission.tokens", bucket.tokens,
                                  tenant=label)
                if not adm.ok:
                    self.rejected += 1
                    if reg is not None:
                        reg.inc("admission.rejected", tenant=label,
                                reason="quota")
                    return adm
            self.admitted += 1
            if reg is not None:
                reg.inc("admission.admitted", tenant=label)
            return Admission(ok=True)

    def bucket_levels(self) -> Dict[str, float]:
        """{tenant -> current token level} (cardinality-capped names)."""
        with self._lock:
            return {self._label(t): b.tokens
                    for t, b in self._buckets.items()}

    def snapshot(self) -> dict:
        with self._lock:
            return {"admitted": self.admitted, "rejected": self.rejected,
                    "tenants": len(self._buckets),
                    "max_queue": self.max_queue}


class CircuitBreaker:
    """Closed → open → half-open breaker for the cold-solve backend.

    ``record_failure`` covers both exception outcomes and blown budgets:
    either way the backend is not producing answers inside the service's
    latency contract, and feeding it more work just grows the backlog.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3,
                 reset_after_s: float = 5.0):
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self._lock = threading.Lock()
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probing = False
        self.trips = 0            # observable: times the breaker opened

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self):
        if (self._state == self.OPEN
                and time.monotonic() - self._opened_at >= self.reset_after_s):
            self._state = self.HALF_OPEN
            self._probing = False

    def allow(self) -> bool:
        """May a cold solve be dispatched right now? Half-open lets ONE
        probe through; its outcome decides the next state."""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._state = self.CLOSED
            self._probing = False

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if (self._state == self.HALF_OPEN
                    or self._failures >= self.failure_threshold):
                if self._state != self.OPEN:
                    self.trips += 1
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                self._probing = False

    def snapshot(self) -> dict:
        with self._lock:
            self._maybe_half_open()
            return {"state": self._state, "failures": self._failures,
                    "trips": self.trips}
