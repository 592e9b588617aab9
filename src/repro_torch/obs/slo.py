"""Declarative SLOs with rolling-window error-budget burn rates.

Objectives are defined over the serving stack's terminal-status taxonomy
(DESIGN.md §15): every decoded fit request ends in exactly one of
ok / degraded / rejected / deadline / error.  An :class:`Objective` says
what fraction of recent requests must be "good"; the tracker keeps a
rolling window of terminal events and evaluates each objective into an
SLI, remaining error budget, and a burn rate:

    burn_rate = (1 - sli) / (1 - target)

1.0 means failures arrive exactly at the sustainable rate (the budget
lasts the window); > 1 means the budget is burning faster than allowed
(the alerting signal); 0 means no failures.  For a target of 1.0 (zero
tolerance, e.g. zero-lost) any failure is an infinite burn, capped at
``BURN_CAP`` to stay JSON/gauge friendly.

Three kinds:
  * ``availability`` — good = status in ``good_statuses`` over all
    terminal events (availability = terminal ok+degraded / decoded);
  * ``latency``      — good = latency <= threshold among events matching
    ``scope`` (warm/cold/all); target 0.99 + threshold X is exactly
    "p99 < X";
  * ``external``     — a boolean invariant fed at evaluation time (the
    zero-lost-requests accounting identity lives in the frontend, not in
    the event stream).

``evaluate`` is pure over the window; ``export_gauges`` mirrors the
results into a registry so the scrape endpoint and metrics.json carry
``slo.sli{objective=...}`` / ``slo.burn_rate{objective=...}`` without
extra plumbing.

Copy of ``repro/obs/slo.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

__all__ = ["Objective", "SLOTracker", "DEFAULT_OBJECTIVES", "BURN_CAP"]

BURN_CAP = 1e6


@dataclass(frozen=True)
class Objective:
    name: str
    kind: str                    # "availability" | "latency" | "external"
    target: float                # required good fraction, in (0, 1]
    good_statuses: Tuple[str, ...] = ("ok", "degraded")
    threshold_s: float = 1.0     # latency only
    scope: str = "all"           # latency only: "warm" | "cold" | "all"
    description: str = ""


DEFAULT_OBJECTIVES: Tuple[Objective, ...] = (
    Objective(name="availability", kind="availability", target=0.65,
              description="terminal ok+degraded over decoded requests"),
    Objective(name="warm_latency", kind="latency", target=0.99,
              threshold_s=2.0, scope="warm",
              description="warm-path p99 under threshold"),
    Objective(name="zero_lost", kind="external", target=1.0,
              description="every decoded request got exactly one "
                          "terminal response"),
)


@dataclass
class _Event:
    t: float
    status: str
    latency_s: Optional[float]
    warm: Optional[bool]


@dataclass
class SLOTracker:
    """Rolling window of terminal events + objective evaluation."""

    window_s: float = 600.0
    max_events: int = 100_000
    _events: Deque[_Event] = field(default_factory=deque, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, status: str, latency_s: Optional[float] = None,
               warm: Optional[bool] = None, t: Optional[float] = None):
        ev = _Event(t=time.monotonic() if t is None else t, status=status,
                    latency_s=latency_s, warm=warm)
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self.max_events:
                self._events.popleft()

    def _window(self, now: Optional[float]) -> List[_Event]:
        now = time.monotonic() if now is None else now
        lo = now - self.window_s
        with self._lock:
            # drop expired events from the left while here (events are
            # appended in time order)
            while self._events and self._events[0].t < lo:
                self._events.popleft()
            return list(self._events)

    def evaluate(self, objectives: Tuple[Objective, ...] = DEFAULT_OBJECTIVES,
                 external: Optional[Dict[str, bool]] = None,
                 now: Optional[float] = None) -> dict:
        """Evaluate each objective over the current window.

        ``external`` supplies the boolean SLI for ``kind="external"``
        objectives by name; an external objective with no supplied value
        evaluates to ok=None (unknown), never a spurious pass/fail.
        """
        events = self._window(now)
        external = external or {}
        out = {"window_s": self.window_s, "events": len(events),
               "objectives": []}
        for obj in objectives:
            out["objectives"].append(self._eval_one(obj, events, external))
        out["ok"] = all(o["ok"] is not False for o in out["objectives"])
        return out

    def _eval_one(self, obj: Objective, events: List[_Event],
                  external: Dict[str, bool]) -> dict:
        res = {"name": obj.name, "kind": obj.kind, "target": obj.target,
               "description": obj.description}
        if obj.kind == "external":
            val = external.get(obj.name)
            if val is None:
                res.update({"sli": None, "burn_rate": None, "ok": None})
                return res
            sli = 1.0 if val else 0.0
            total = good = None
        else:
            if obj.kind == "availability":
                pool = events
                good_of = lambda e: e.status in obj.good_statuses  # noqa: E731
            elif obj.kind == "latency":
                pool = [e for e in events if e.latency_s is not None
                        and (obj.scope == "all"
                             or (obj.scope == "warm" and e.warm is True)
                             or (obj.scope == "cold" and e.warm is False))]
                good_of = lambda e: e.latency_s <= obj.threshold_s  # noqa: E731
            else:
                raise ValueError(f"unknown objective kind: {obj.kind!r}")
            total = len(pool)
            if total == 0:
                res.update({"events": 0, "good": 0, "sli": None,
                            "burn_rate": None, "ok": None})
                return res
            good = sum(1 for e in pool if good_of(e))
            sli = good / total
        budget = 1.0 - obj.target
        bad = 1.0 - sli
        if budget <= 0.0:
            burn = 0.0 if bad <= 0.0 else BURN_CAP
        else:
            burn = min(bad / budget, BURN_CAP)
        res.update({
            "sli": round(sli, 6),
            "burn_rate": round(burn, 4),
            "budget": round(budget, 6),
            "budget_used": round(min(burn, BURN_CAP), 4),
            "ok": sli >= obj.target,
        })
        if total is not None:
            res["events"] = total
            res["good"] = good
        if obj.kind == "latency":
            res["threshold_s"] = obj.threshold_s
            res["scope"] = obj.scope
        return res

    def export_gauges(self, registry, evaluation: Optional[dict] = None,
                      objectives: Tuple[Objective, ...] = DEFAULT_OBJECTIVES,
                      external: Optional[Dict[str, bool]] = None):
        """Mirror an evaluation into ``slo.*`` gauges on ``registry``."""
        ev = evaluation or self.evaluate(objectives, external=external)
        for o in ev["objectives"]:
            if o.get("sli") is not None:
                registry.set_gauge("slo.sli", o["sli"], objective=o["name"])
            if o.get("burn_rate") is not None:
                registry.set_gauge("slo.burn_rate", o["burn_rate"],
                                   objective=o["name"])
            registry.set_gauge(
                "slo.ok",
                1.0 if o["ok"] else (0.0 if o["ok"] is False else -1.0),
                objective=o["name"])
        return ev
