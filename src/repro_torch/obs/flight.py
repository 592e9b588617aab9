"""Flight recorder: bounded in-memory event ring + incident dumps.

Always-on trace files are too expensive for a long-running service, but
when a request dies (error/deadline) or the circuit breaker trips you
want the recent past, not just counters.  :class:`FlightRecorder` keeps
a fixed-capacity ring of recent events — span summaries, status
transitions, breaker state changes, admission decisions — each stamped
with wall/monotonic time and any active trace context, and
:meth:`incident` snapshots the last ``window_s`` seconds of that ring
into a self-contained JSON file.

Bounds (DESIGN.md §16): memory is capped by ``capacity`` (a deque
maxlen — old events fall off silently), disk by ``max_incidents`` per
recorder (later triggers increment a dropped counter instead of
writing), and each dump covers at most the ring ∩ window, so a trigger
storm cannot fill the disk or stall the serving path: ``note`` is one
lock + deque append.

Copy of ``repro/obs/flight.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.context import current_context
from repro_torch.obs.telemetry import jsonable

__all__ = ["FlightRecorder", "load_incident"]


class FlightRecorder:
    def __init__(self, dir: Optional[str] = None, capacity: int = 4096,
                 window_s: float = 30.0, max_incidents: int = 50,
                 process_name: str = "main",
                 enabled: Optional[bool] = None):
        self.dir = dir
        self.enabled = bool(dir) if enabled is None else bool(enabled)
        self.capacity = int(capacity)
        self.window_s = float(window_s)
        self.max_incidents = int(max_incidents)
        self.process_name = process_name
        self._lock = threading.Lock()
        self._ring: List[dict] = []          # bounded manually (ring index)
        self._head = 0
        self._seq = 0
        self._incidents: List[str] = []
        self._dropped_incidents = 0
        if self.enabled and dir is not None:
            os.makedirs(dir, exist_ok=True)

    # -- recording -----------------------------------------------------------
    def note(self, kind: str, **fields):
        """Append one event to the ring. Cheap; safe from any thread."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {"kind": kind, "t_wall": time.time(),
                              "t_mono": time.monotonic()}
        ctx = current_context()
        if ctx is not None:
            ev["trace_id"] = ctx.trace_id
            ev["span_id"] = ctx.span_id
        if fields:
            ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) < self.capacity:
                self._ring.append(ev)
            else:
                self._ring[self._head] = ev
                self._head = (self._head + 1) % self.capacity

    def _recent(self, window_s: float) -> List[dict]:
        # caller holds the lock; returns events in seq order
        lo = time.monotonic() - window_s
        ordered = self._ring[self._head:] + self._ring[:self._head]
        return [e for e in ordered if e["t_mono"] >= lo]

    # -- incident dumps ------------------------------------------------------
    def incident(self, reason: str, **fields) -> Optional[str]:
        """Dump the recent ring to ``incident-NNN-<reason>.json``.

        Returns the path, or None when disabled / over the incident cap.
        """
        if not self.enabled or self.dir is None:
            return None
        with self._lock:
            if len(self._incidents) >= self.max_incidents:
                self._dropped_incidents += 1
                return None
            events = self._recent(self.window_s)
            n = len(self._incidents)
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:60]
        path = os.path.join(self.dir, f"incident-{n:03d}-{safe}.json")
        doc = {
            "reason": reason,
            "t_wall": time.time(),
            "window_s": self.window_s,
            "process": {"pid": os.getpid(), "name": self.process_name},
            "trigger": jsonable(fields),
            "events": jsonable(events),
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)      # a torn dump never shadows a good one
        with self._lock:
            self._incidents.append(path)
        return path

    # -- introspection -------------------------------------------------------
    def incidents(self) -> List[str]:
        with self._lock:
            return list(self._incidents)

    def snapshot(self) -> dict:
        with self._lock:
            return {"events_recorded": self._seq,
                    "ring_size": len(self._ring),
                    "capacity": self.capacity,
                    "incidents": len(self._incidents),
                    "incidents_dropped": self._dropped_incidents}


def load_incident(path: str) -> dict:
    """Load one incident dump (they are written atomically, so plain
    json.load; raises on a file that isn't an incident dump)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "reason" not in doc:
        raise ValueError(f"not a flight-recorder incident file: {path}")
    doc.setdefault("events", [])
    return doc


NOOP = FlightRecorder(dir=None, enabled=False)
