"""Unified observability layer (DESIGN.md §12): metrics registry +
tracing spans + per-iteration telemetry, bundled per run directory.

``Observability`` is the object the solvers take: ``obs=None`` (or the
module-level ``NOOP``) is the disabled fast path — ``span`` returns a
reused null context manager, ``record``/``inc``/``observe`` return
immediately — so instrumented code costs one attribute check when
observability is off, and nothing is ever called from inside jitted
code (host-side boundaries only).

An enabled instance owns a run directory and writes three artifacts:

  * ``telemetry.jsonl`` — one line per solver iteration (streamed);
  * ``metrics.json``    — the registry snapshot at ``finish()``
    (counters, gauges, log-bucket histograms);
  * ``trace.json``      — Chrome-trace/Perfetto events, including any
    worker-process events merged in (one timeline per cluster solve).

``launch/obs_report.py`` reads the directory back and prints the
summary (percentiles, bytes/iter, span hotspots).

``current()`` is the process's current instance: ``NOOP`` unless a
``recording(ob)`` block has set one. Code that takes no ``obs`` argument
(``solve_with_executor`` called without one, and the executors below it)
opens its spans there, so a caller that holds none of those objects,
such as a benchmark around a whole fit, switches them on for its block.
It is process-wide, not per thread or per context, so spans from every
thread of the process are recorded.

Copy of ``repro/obs/__init__.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import signal
import threading
from typing import Optional

import numpy as np

from repro_torch.obs.context import (          # noqa: F401  (re-exports)
    TraceContext,
    current_context,
    new_trace,
    use_context,
)
from repro_torch.obs.flight import FlightRecorder, load_incident  # noqa: F401
from repro_torch.obs.metrics import (          # noqa: F401  (re-exports)
    Histogram,
    MetricsRegistry,
    merged_histogram,
    snapshot_counters,
    snapshot_histograms,
    summarize_histogram,
)
from repro_torch.obs.scrape import ScrapeServer, render_prometheus  # noqa: F401
from repro_torch.obs.slo import DEFAULT_OBJECTIVES, Objective, SLOTracker  # noqa: F401
from repro_torch.obs.telemetry import TelemetryWriter, jsonable, read_jsonl  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    Tracer,
    is_ancestor,
    load_trace,
    span_hotspots,
    span_tree,
)

TELEMETRY_FILE = "telemetry.jsonl"
METRICS_FILE = "metrics.json"
TRACE_FILE = "trace.json"


class Observability:
    """Registry + tracer + telemetry sink for one run directory."""

    def __init__(self, dir: Optional[str] = None,
                 process_name: str = "main",
                 enabled: Optional[bool] = None,
                 crash_flush: bool = True):
        self.dir = dir
        self.enabled = bool(dir) if enabled is None else bool(enabled)
        self.registry = MetricsRegistry()
        self.tracer = Tracer(enabled=self.enabled,
                             process_name=process_name)
        self.telemetry: Optional[TelemetryWriter] = None
        if self.enabled and dir is not None:
            os.makedirs(dir, exist_ok=True)
            self.telemetry = TelemetryWriter(
                os.path.join(dir, TELEMETRY_FILE))
            if crash_flush:
                self._install_crash_flush()

    @classmethod
    def create(cls, dir: str, process_name: str = "main") -> "Observability":
        return cls(dir=dir, process_name=process_name)

    # -- span / metric front doors (no-ops when disabled) -------------------
    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def inc(self, name: str, value: float = 1, **labels):
        if self.enabled:
            self.registry.inc(name, value, **labels)

    def observe(self, name: str, value: float, **labels):
        if self.enabled:
            self.registry.observe(name, value, **labels)

    def set_gauge(self, name: str, value: float, **labels):
        if self.enabled:
            self.registry.set_gauge(name, value, **labels)

    # -- telemetry -----------------------------------------------------------
    def record(self, **fields):
        if self.telemetry is not None:
            self.telemetry.write(fields)

    def write_history(self, history, tau: Optional[float] = None,
                      rho: Optional[float] = None, start_iter: int = 0,
                      **extra):
        """Stream an :class:`~repro_torch.core.unwrapped.ADMMHistory` (or any
        object with objective/primal_res/dual_res arrays) to the JSONL
        sink — the post-scan path for the fully-jitted drivers, where
        per-iteration host callbacks are off-limits."""
        if self.telemetry is None or history is None:
            return
        obj = np.asarray(history.objective)
        pr = np.asarray(history.primal_res)
        du = np.asarray(history.dual_res)
        gs = (np.asarray(history.grad_sq)
              if getattr(history, "grad_sq", None) is not None else None)
        for i in range(len(obj)):
            rec = {"iter": start_iter + i, "objective": float(obj[i]),
                   "primal_res": float(pr[i]), "dual_res": float(du[i]),
                   "tau": tau, "rho": rho}
            if gs is not None:
                rec["grad_sq"] = float(gs[i])
            rec.update(extra)
            self.record(**rec)

    # -- lifecycle -----------------------------------------------------------
    def _install_crash_flush(self):
        """Crash-safe artifacts (DESIGN.md §16): flush on interpreter
        exit and, when possible, on SIGTERM.

        ``atexit`` covers clean-but-finish()-less exits; the SIGTERM
        hook covers polite kills (it flushes, restores the default
        handler, and re-raises so exit status stays conventional).  Only
        installed from the main thread and only when SIGTERM is still at
        its default — never steals a handler someone else set.  SIGKILL
        cannot be caught; for that case telemetry flushes per line and
        the readers tolerate torn tails (read_jsonl / load_trace).
        """
        atexit.register(self.finish)
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            if signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL:
                return

            def _flush_and_die(signum, frame):
                try:
                    self.finish()
                finally:
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            signal.signal(signal.SIGTERM, _flush_and_die)
        except (ValueError, OSError):
            pass  # exotic embedding (no signal support): atexit still holds

    def flush(self):
        """Write metrics.json + trace.json NOW without closing the
        telemetry sink — the periodic checkpoint for long-running
        serving processes (finish() remains the closing flush)."""
        if not self.enabled or self.dir is None:
            return
        with open(os.path.join(self.dir, METRICS_FILE), "w") as f:
            json.dump(jsonable(self.registry.snapshot()), f, indent=2)
            f.write("\n")
        self.tracer.export(os.path.join(self.dir, TRACE_FILE))

    def finish(self):
        """Write metrics.json + trace.json and close the JSONL sink.
        Idempotent; a later finish() re-exports the (grown) state."""
        if not self.enabled or self.dir is None:
            return
        self.flush()
        if self.telemetry is not None:
            self.telemetry.close()
            self.telemetry = None
        atexit.unregister(self.finish)


NOOP = Observability(dir=None, enabled=False)


_current = NOOP


def current() -> Observability:
    """The process's current :class:`Observability`: the one a
    ``recording`` block has set, else ``NOOP``."""
    return _current


@contextlib.contextmanager
def recording(ob: Observability):
    """Make ``ob`` the process's current :class:`Observability` for the
    block, and restore the one before it on exit."""
    global _current
    prev, _current = _current, ob
    try:
        yield ob
    finally:
        _current = prev
