"""Networked multi-tenant front end for the FitServer (DESIGN.md §15).

The paper's global sub-problem is cheap enough that ONE node can answer
fits over massive data — so the serving story is a single shared
:class:`~repro_torch.service.server.FitServer` (cached Gram stats,
micro-batch coalescing) behind a threaded TCP front end speaking the cluster
runtime's length-prefixed framing (:mod:`repro_torch.cluster.transport`).

The design goal is *degrade instead of fail*; every request admitted
past the framing layer receives exactly one terminal response:

  ``ok``        solved (warm from cached stats, or cold within budget)
  ``degraded``  cold budget blown / breaker open → best warm/cached
                answer (a ridge fit from the dataset's Gram stats)
  ``deadline``  the request's deadline expired while still queued
  ``rejected``  admission control said no (tenant quota / queue bound),
                with a retry-after hint
  ``error``     the request itself was bad (unknown fingerprint,
                missing mu/b, stats-only dataset needing raw rows) or
                the backend failed on it

Failure containment: each client connection gets its own handler
thread; a crashed, slow-loris, or byte-corrupting client is severed at
the transport layer (frame deadline / frame cap / undecodable frame —
see ``Listener``'s per-accept knobs) without touching any sibling
tenant's connection, and its undeliverable responses are accounted, not
lost. A failing or budget-blowing cold-solve backend trips the
:class:`~repro_torch.service.admission.CircuitBreaker` and subsequent cold
requests shed to degraded answers instead of piling onto a dead pool.

Chaos: a :class:`~repro_torch.cluster.chaos.FaultInjector` built over
``SERVICE_DATA_PLANE`` frame types can be handed to the front end — its
wire faults ride ``Connection.send`` on accepted connections (via
``Listener``), and its ``slow`` process faults stall the cold-solve
backend, which is how the load benchmark proves the degrade path.

Copy of ``repro/service/frontend.py``; only ``device`` is new: the device
of the :class:`FitServer` the front end builds when it is handed none (the
card unless the caller asks for the CPU). Frames carry numpy arrays and
plain values, never a tensor, so either package's client talks to either
package's front end.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.chaos import FaultInjector
from repro_torch.cluster.transport import (
    ByteCounter,
    Connection,
    ConnectionClosed,
    Listener,
    connect,
)
from repro_torch.obs import Observability
from repro_torch.obs.context import TraceContext, current_context, \
    new_trace, use_context
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.flight import NOOP as FLIGHT_NOOP
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.scrape import ScrapeServer
from repro_torch.obs.slo import DEFAULT_OBJECTIVES, Objective, SLOTracker
from repro_torch.obs.trace import Tracer
from repro_torch.service import registry
from repro_torch.service.admission import AdmissionController, \
    CircuitBreaker
from repro_torch.service.server import FitRequest, FitResponse, FitServer

#: frame types the service treats as chaos-injectable data plane
SERVICE_DATA_PLANE = ("fit", "fit_result")

#: terminal response statuses (DESIGN.md §15 taxonomy)
TERMINAL_STATUSES = ("ok", "degraded", "deadline", "rejected", "error")


class _Pending:
    """One admitted fit awaiting its terminal response. ``respond`` is
    exactly-once: the first caller wins, later callers (e.g. a cold
    future completing after its budget already answered ``degraded``)
    are no-ops — this is what makes "every request gets exactly one
    terminal response" a structural property rather than a hope."""

    __slots__ = ("req", "tenant", "rid", "conn", "deadline", "enqueue_t",
                 "enqueue_wall_us", "ctx", "_done", "_lock")

    def __init__(self, req: FitRequest, tenant: str, rid: int,
                 conn: Connection, deadline: Optional[float],
                 ctx: Optional[TraceContext] = None):
        self.req = req
        self.tenant = tenant
        self.rid = rid
        self.conn = conn
        self.deadline = deadline          # absolute monotonic, or None
        self.enqueue_t = time.monotonic()
        self.enqueue_wall_us = time.time_ns() // 1000
        self.ctx = ctx                    # request's wire TraceContext
        self._done = False
        self._lock = threading.Lock()

    def claim(self) -> bool:
        with self._lock:
            if self._done:
                return False
            self._done = True
            return True


class FitFrontend:
    """Threaded TCP front end over one shared :class:`FitServer`.

    Threads: one acceptor, one handler per live connection, one solver
    (micro-batch flush + deadline sweep + cold-future polling), plus a
    small cold-solve pool. All request admission and response delivery
    is exactly-once under ``_cv``/per-pending locks.
    """

    def __init__(self, server: Optional[FitServer] = None,
                 host: str = "127.0.0.1", port: int = 0, *,
                 window: int = 16, flush_interval_s: float = 0.01,
                 max_queue: int = 256,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 default_deadline_s: float = 30.0,
                 cold_budget_s: Optional[float] = None,
                 cold_workers: int = 2,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 5.0,
                 idle_timeout_s: float = 60.0,
                 frame_deadline_s: float = 5.0,
                 max_frame_bytes: int = 64 << 20,
                 chaos: Optional[FaultInjector] = None,
                 obs: Optional[Observability] = None,
                 scrape_port: Optional[int] = None,
                 slo_objectives: Optional[Sequence[Objective]] = None,
                 slo_window_s: float = 600.0,
                 flight: Optional[FlightRecorder] = None,
                 device="cuda"):
        self.server = server or FitServer(window=window, device=device)
        self.window = int(window)
        self.flush_interval_s = float(flush_interval_s)
        self.default_deadline_s = float(default_deadline_s)
        self.cold_budget_s = cold_budget_s
        self.chaos = chaos
        # Live observability plane (DESIGN.md §16). The metrics registry
        # is ALWAYS real — status_counts()/zero_lost_requests() are
        # service accounting, not optional telemetry — but when an
        # enabled Observability is handed in, the service counts into
        # ITS registry so metrics.json / the scrape endpoint carry the
        # serving series, and its tracer records the request spans.
        self.obs = obs
        if obs is not None:
            self.metrics = obs.registry
            self.tracer = obs.tracer
        else:
            self.metrics = MetricsRegistry()
            self.tracer = Tracer(enabled=False)
        if flight is not None:
            self.flight = flight
        elif obs is not None and obs.enabled and obs.dir is not None:
            self.flight = FlightRecorder(
                dir=os.path.join(obs.dir, "incidents"),
                process_name="frontend")
        else:
            self.flight = FLIGHT_NOOP
        self.slo = SLOTracker(window_s=slo_window_s)
        self.slo_objectives: Tuple[Objective, ...] = (
            tuple(slo_objectives) if slo_objectives is not None
            else DEFAULT_OBJECTIVES)
        self.admission = AdmissionController(
            max_queue=max_queue, tenant_rate=tenant_rate,
            tenant_burst=tenant_burst, registry=self.metrics)
        self.breaker = CircuitBreaker(failure_threshold=breaker_threshold,
                                      reset_after_s=breaker_reset_s)
        self.counter = ByteCounter(self.metrics)
        self.listener = Listener(host, port, chaos=chaos,
                                 max_frame_bytes=max_frame_bytes,
                                 frame_deadline_s=frame_deadline_s)
        self.address: Tuple[str, int] = self.listener.address
        self.idle_timeout_s = float(idle_timeout_s)
        self._t_start = time.monotonic()
        # live scrape endpoint (/metrics, /healthz, /slo) — optional;
        # port 0 asks the OS for one (see self.scrape.address)
        self.scrape: Optional[ScrapeServer] = None
        if scrape_port is not None:
            self.scrape = ScrapeServer(
                snapshot_fn=self.metrics_snapshot,
                health_fn=self.health,
                slo_fn=self.slo_snapshot,
                host=host, port=int(scrape_port))

        self._cv = threading.Condition()
        self._pending: List[_Pending] = []
        self._cold_inflight: List[Tuple[_Pending, object,
                                        Optional[float]]] = []
        self._conns: Dict[int, Connection] = {}
        self._conn_ids = itertools.count()
        self._fit_seq = 0
        self._stop = threading.Event()
        self._cold_pool = ThreadPoolExecutor(
            max_workers=cold_workers, thread_name_prefix="cold-solve")
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True,
                             name="svc-accept"),
            threading.Thread(target=self._solve_loop, daemon=True,
                             name="svc-solver"),
        ]
        for t in self._threads:
            t.start()

    # -- connection plane ----------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn = self.listener.accept(timeout=0.2,
                                            counter=self.counter)
            except OSError:
                return                    # listener closed under us
            if conn is None:
                continue
            cid = next(self._conn_ids)
            with self._cv:
                self._conns[cid] = conn
            threading.Thread(target=self._handle, args=(conn, cid),
                             daemon=True, name=f"svc-conn-{cid}").start()

    def _handle(self, conn: Connection, cid: int):
        """Per-connection receive loop. Any transport-level failure on
        THIS connection severs THIS connection only; its queued requests
        stay pending and their responses are recorded undeliverable."""
        reason = "eof"
        try:
            while not self._stop.is_set():
                msg = conn.recv(timeout=self.idle_timeout_s)
                if msg is None:           # idle — keep the session open
                    continue
                self._dispatch_msg(conn, msg)
        except ConnectionClosed as e:
            reason = "eof" if "EOF" in str(e) else "protocol"
        finally:
            self.metrics.inc("service.conn_closed", reason=reason)
            if reason != "eof":
                self.metrics.inc("service.severed")
            conn.close()
            with self._cv:
                self._conns.pop(cid, None)

    def _dispatch_msg(self, conn: Connection, msg: dict):
        mtype = msg.get("type")
        rid = msg.get("rid", 0)
        tenant = str(msg.get("tenant", "?"))
        if mtype == "fit":
            self._admit_fit(conn, msg, rid, tenant)
        elif mtype == "register":
            self._reply(conn, "registered", rid, lambda: {
                "fingerprint": self.server.register_dataset(
                    np.asarray(msg["D"]),
                    None if msg.get("b") is None else np.asarray(msg["b"]),
                    keep_data=bool(msg.get("keep_data", True)))})
        elif mtype == "ingest":
            self._reply(conn, "ingested", rid, lambda: {
                "fingerprint": self.server.ingest_block(
                    msg["fingerprint"], np.asarray(msg["D"]),
                    None if msg.get("b") is None
                    else np.asarray(msg["b"]))})
        elif mtype == "retire":
            self._reply(conn, "retired", rid, lambda: {
                "fingerprint": self.server.retire_block(
                    msg["fingerprint"], np.asarray(msg["D"]),
                    None if msg.get("b") is None
                    else np.asarray(msg["b"]))})
        elif mtype == "counters":
            self._reply(conn, "counters_result", rid, lambda: {
                "server": self.server.counters.snapshot(),
                "admission": self.admission.snapshot(),
                "breaker": self.breaker.snapshot(),
                "frontend": self.status_counts(),
                "slo": self.slo_snapshot(),
                "flight": self.flight.snapshot()})
        elif mtype == "ping":
            self._safe_send(conn, "pong", rid=rid)
        else:
            self._safe_send(conn, "error_reply", rid=rid,
                            error=f"unknown message type {mtype!r}")

    def _reply(self, conn: Connection, ok_type: str, rid: int, fn):
        """Run a synchronous admin op; errors become error replies for
        THIS request instead of killing the connection."""
        try:
            payload = fn()
        except Exception as e:            # noqa: BLE001 — containment
            self._safe_send(conn, "error_reply", rid=rid,
                            error=f"{type(e).__name__}: {e}")
            return
        self._safe_send(conn, ok_type, rid=rid, **payload)

    def _safe_send(self, conn: Connection, mtype: str, **payload) -> bool:
        try:
            conn.send(mtype, **payload)
            return True
        except (ConnectionClosed, OSError):
            self.metrics.inc("service.undeliverable")
            return False

    # -- admission -----------------------------------------------------------
    def _admit_fit(self, conn: Connection, msg: dict, rid: int,
                   tenant: str):
        # Re-activate the request's wire TraceContext (if the client
        # sent one) for the dynamic extent of the admission decision:
        # the admit span becomes a child of the client's span, and the
        # context rides the _Pending into queue-wait / solve spans.
        ctx = TraceContext.from_wire(msg.get("_ctx"))
        with use_context(ctx):
            with self.tracer.span("frontend.admit", tenant=tenant,
                                  rid=rid):
                self._admit_fit_inner(conn, msg, rid, tenant, ctx)

    def _admit_fit_inner(self, conn: Connection, msg: dict, rid: int,
                         tenant: str, ctx: Optional[TraceContext]):
        self.metrics.inc("service.fit_seen", tenant=tenant)
        with self._cv:
            in_flight = len(self._pending) + len(self._cold_inflight)
        adm = self.admission.admit(tenant, in_flight)
        if not adm.ok:
            self.metrics.inc("service.responses", status="rejected")
            self.metrics.inc("service.rejected", reason=adm.reason)
            self.slo.record("rejected")
            self.tracer.instant("frontend.rejected", tenant=tenant,
                                reason=adm.reason)
            self.flight.note("reject", tenant=tenant, rid=rid,
                             reason=adm.reason)
            self._safe_send(conn, "fit_result", rid=rid,
                            status="rejected", x=None, iters=0,
                            batch_size=0, from_cache=False,
                            error=adm.reason,
                            retry_after_s=adm.retry_after_s)
            return
        req = FitRequest(
            problem=str(msg["problem"]), fingerprint=str(msg["fingerprint"]),
            b=None if msg.get("b") is None else np.asarray(msg["b"]),
            mu=msg.get("mu"), l2=float(msg.get("l2", 0.0)),
            C=float(msg.get("C", 1.0)), delta=float(msg.get("delta", 1.0)),
            iters=int(msg.get("iters", 1000)))
        dl = msg.get("deadline_s", None)
        dl = self.default_deadline_s if dl is None else float(dl)
        deadline = (time.monotonic() + dl) if dl > 0 else None
        p = _Pending(req, tenant, rid, conn, deadline, ctx=ctx)
        self.flight.note("admit", tenant=tenant, rid=rid,
                         problem=req.problem)
        with self._cv:
            self._fit_seq += 1
            if self.chaos is not None:
                self.chaos.set_iteration(self._fit_seq)
            self._pending.append(p)
            self._cv.notify()

    # -- response plane ------------------------------------------------------
    def _respond(self, p: _Pending, status: str,
                 x: Optional[np.ndarray] = None, iters: int = 0,
                 batch_size: int = 1, from_cache: bool = False,
                 error: Optional[str] = None,
                 retry_after_s: Optional[float] = None) -> bool:
        if not p.claim():
            return False
        latency_s = time.monotonic() - p.enqueue_t
        warm = p.req.problem in registry.GRAM_SOLVERS
        self.metrics.inc("service.responses", status=status)
        self.metrics.observe("service.queue_wait_s", latency_s)
        self.slo.record(status, latency_s=latency_s, warm=warm)
        self.flight.note("respond", status=status, tenant=p.tenant,
                         rid=p.rid, latency_s=round(latency_s, 6),
                         **({"trace_id": p.ctx.trace_id}
                            if p.ctx is not None else {}))
        # the terminal frame carries the request context back (p.ctx
        # re-activated so transport stamps _ctx; solver thread has none)
        with use_context(p.ctx):
            self._safe_send(p.conn, "fit_result", rid=p.rid, status=status,
                            x=None if x is None else np.asarray(x),
                            iters=int(iters), batch_size=int(batch_size),
                            from_cache=bool(from_cache), error=error,
                            retry_after_s=retry_after_s)
        if status in ("error", "deadline"):
            # post-incident debugging trigger (DESIGN.md §16): dump the
            # flight ring around any request that died
            self.flight.incident(
                f"status_{status}", tenant=p.tenant, rid=p.rid,
                error=error,
                **({"trace_id": p.ctx.trace_id}
                   if p.ctx is not None else {}))
        return True

    def _respond_from(self, p: _Pending, r: FitResponse):
        self._respond(p, r.status, x=r.x, iters=r.iters,
                      batch_size=r.batch_size, from_cache=r.from_cache,
                      error=r.error)

    def _respond_degraded(self, p: _Pending, why: str):
        """Best warm/cached answer: a ridge fit straight from the
        dataset's Gram stats (zero data passes when the factor is live).
        Mirrors the cluster DegradePolicy semantics — an explicit,
        bounded-quality answer instead of an unbounded wait."""
        fb = FitRequest(problem="ridge", fingerprint=p.req.fingerprint,
                        b=p.req.b,
                        mu=p.req.mu if p.req.mu is not None else 1.0,
                        iters=1)
        self.flight.note("degrade", tenant=p.tenant, rid=p.rid, why=why,
                         **({"trace_id": p.ctx.trace_id}
                            if p.ctx is not None else {}))
        try:
            with use_context(p.ctx):
                with self.tracer.span("frontend.degrade", why=why,
                                      tenant=p.tenant):
                    r = self.server.solve_one(fb)
            if r.status != "ok":
                raise RuntimeError(r.error or "fallback failed")
            self.metrics.inc("service.degraded", why=why)
            self._respond(p, "degraded", x=r.x, iters=r.iters,
                          from_cache=True, error=why)
        except Exception as e:            # noqa: BLE001 — containment
            self._respond(p, "error",
                          error=f"{why}; degraded fallback failed: {e}")

    # -- solver loop ---------------------------------------------------------
    def _solve_loop(self):
        while not self._stop.is_set():
            with self._cv:
                if not self._pending and not self._cold_inflight:
                    self._cv.wait(timeout=0.05)
                now = time.monotonic()
                expired = [p for p in self._pending
                           if p.deadline is not None and now > p.deadline]
                for p in expired:
                    self._pending.remove(p)
                batch: List[_Pending] = []
                if self._pending and (
                        len(self._pending) >= self.window
                        or now - self._pending[0].enqueue_t
                        >= self.flush_interval_s):
                    batch = self._pending[:self.window]
                    del self._pending[:len(batch)]
            for p in expired:
                self.metrics.inc("service.deadline_expired", where="queue")
                self._respond(p, "deadline",
                              error="deadline expired in queue")
            if batch:
                self._dispatch_batch(batch)
            polled = self._poll_cold()
            if not (expired or batch or polled):
                # work exists but is not actionable yet (window filling,
                # cold futures running): don't spin the CPU against it
                time.sleep(0.002)
        # shutdown: drain everything still pending with explicit errors —
        # a stopping service must not strand a single request
        with self._cv:
            leftovers = self._pending[:]
            self._pending.clear()
            cold = self._cold_inflight[:]
            self._cold_inflight = []
        for p in leftovers:
            self._respond(p, "error", error="service shutting down")
        for p, _fut, _dl in cold:
            self._respond(p, "error", error="service shutting down")

    def _dispatch_batch(self, batch: List[_Pending]):
        # close out each request's queue-wait interval: a retroactive
        # span (nobody was "in" it) parented under the request context,
        # plus the dispatch_wait histogram the trace tests reconcile
        now = time.monotonic()
        for p in batch:
            wait_s = now - p.enqueue_t
            self.metrics.observe("service.dispatch_wait_s", wait_s)
            self.tracer.complete_at("frontend.queue_wait",
                                    p.enqueue_wall_us, wait_s,
                                    ctx=p.ctx, tenant=p.tenant)
        warm = [p for p in batch if p.req.problem in registry.GRAM_SOLVERS]
        cold = [p for p in batch if p.req.problem not in
                registry.GRAM_SOLVERS]
        if warm:
            resps: List[FitResponse] = []
            with self.tracer.span("frontend.warm_flush",
                                  batch=len(warm)):
                for p in warm:
                    resps.extend(self.server.submit(p.req))
                resps.extend(self.server.flush())
            by_id = {r.request_id: r for r in resps}
            for p in warm:
                r = by_id.get(p.req.request_id)
                if r is None:             # structurally unreachable; keep
                    self._respond(p, "error",  # the invariant anyway
                                  error="response lost in flush")
                else:
                    self._respond_from(p, r)
        for p in cold:
            self._dispatch_cold(p)

    def _dispatch_cold(self, p: _Pending):
        if not self.breaker.allow():
            self.metrics.inc("service.breaker_shed")
            self._respond_degraded(p, "circuit breaker open")
            return
        budget = None
        if p.deadline is not None:
            budget = p.deadline
        if self.cold_budget_s is not None:
            b = time.monotonic() + self.cold_budget_s
            budget = b if budget is None else min(budget, b)
        fut = self._cold_pool.submit(self._cold_solve, p.req, p.ctx)
        with self._cv:
            self._cold_inflight.append((p, fut, budget))

    def _cold_solve(self, req: FitRequest,
                    ctx: Optional[TraceContext] = None) -> FitResponse:
        # contextvars do not follow work into pool threads, so the
        # request context is passed explicitly and re-activated here;
        # the executor span (chaos stall included — the timeline should
        # SHOW the injected slowness) chains under the client's span.
        with use_context(ctx):
            with self.tracer.span("frontend.cold_solve",
                                  problem=req.problem):
                if self.chaos is not None:
                    for kind, param in self.chaos.process_actions(
                            self._fit_seq):
                        if kind == "slow":
                            time.sleep(param / 1e3)
                return self.server.solve_one(req)

    def _poll_cold(self) -> int:
        with self._cv:
            now = time.monotonic()
            done, timed_out, still = [], [], []
            for entry in self._cold_inflight:
                p, fut, budget = entry
                if fut.done():
                    done.append((p, fut))
                elif budget is not None and now > budget:
                    timed_out.append(p)   # future keeps running; its
                    # eventual result loses the respond race by design
                else:
                    still.append(entry)
            self._cold_inflight = still
        for p, fut in done:
            try:
                r = fut.result()
                self.breaker.record_success()
                self._respond_from(p, r)
            except (KeyError, ValueError) as e:
                # the REQUEST was bad — not a backend failure, so the
                # breaker stays untouched
                self._respond(p, "error", error=f"{type(e).__name__}: {e}")
            except Exception as e:        # noqa: BLE001 — backend failure
                self._breaker_failure(why=f"{type(e).__name__}: {e}")
                self.metrics.inc("service.cold_failures")
                self._respond(p, "error", error=f"{type(e).__name__}: {e}")
        for p in timed_out:
            self._breaker_failure(why="cold budget blown")
            self.metrics.inc("service.cold_budget_blown")
            self._respond_degraded(p, "cold solve blew its budget")
        return len(done) + len(timed_out)

    def _breaker_failure(self, why: str):
        """Record a cold-backend failure; a closed→open transition (a
        trip) is an incident trigger — dump the flight ring."""
        before = self.breaker.trips
        self.breaker.record_failure()
        if self.breaker.trips > before:
            self.metrics.inc("service.breaker_trips")
            self.tracer.instant("breaker.trip", why=why)
            self.flight.note("breaker", state="open", why=why)
            self.flight.incident("breaker_trip", why=why,
                                 failures=self.breaker.failure_threshold)

    # -- observability / lifecycle -------------------------------------------
    def metrics_snapshot(self) -> dict:
        """One merged registry snapshot for the scrape endpoint: the
        service/admission series, the shared FitServer's ``server.*``
        series, live gauges (queue depth, breaker, connections), and the
        current SLO gauges — what a Prometheus scrape should see."""
        reg = MetricsRegistry()
        reg.merge(self.metrics.snapshot())
        if self.server.counters.registry is not self.metrics:
            reg.merge(self.server.counters.registry.snapshot())
        with self._cv:
            reg.set_gauge("service.queue_depth", len(self._pending))
            reg.set_gauge("service.cold_inflight", len(self._cold_inflight))
            reg.set_gauge("service.connections", len(self._conns))
        for tenant, tokens in self.admission.bucket_levels().items():
            reg.set_gauge("admission.tokens", tokens, tenant=tenant)
        b = self.breaker.snapshot()
        reg.set_gauge("breaker.open", 1.0 if b["state"] == "open" else 0.0)
        reg.set_gauge("breaker.failures", b["failures"])
        reg.set_gauge("breaker.trips", b["trips"])
        reg.set_gauge("service.uptime_s",
                      round(time.monotonic() - self._t_start, 3))
        self.slo.export_gauges(reg, objectives=self.slo_objectives,
                               external={"zero_lost":
                                         self.zero_lost_requests()})
        return reg.snapshot()

    def health(self) -> dict:
        """Liveness summary for /healthz."""
        with self._cv:
            in_flight = len(self._pending) + len(self._cold_inflight)
            conns = len(self._conns)
        return {
            "status": "stopping" if self._stop.is_set() else "ok",
            "address": list(self.address),
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "in_flight": in_flight,
            "connections": conns,
            "breaker": self.breaker.snapshot(),
            "admission": self.admission.snapshot(),
        }

    def slo_snapshot(self) -> dict:
        """Current SLO evaluation (rolling window) for /slo."""
        return self.slo.evaluate(
            self.slo_objectives,
            external={"zero_lost": self.zero_lost_requests()})

    def status_counts(self) -> Dict[str, int]:
        """{terminal status -> count} plus bookkeeping totals."""
        out = {s: int(v) for s, v in
               self.metrics.labeled("service.responses", "status").items()}
        out["fit_seen"] = int(sum(
            self.metrics.labeled("service.fit_seen", "tenant").values()))
        out["undeliverable"] = int(
            self.metrics.counter_value("service.undeliverable"))
        out["severed"] = int(
            self.metrics.counter_value("service.severed"))
        with self._cv:
            out["in_flight"] = (len(self._pending)
                                + len(self._cold_inflight))
        return out

    def zero_lost_requests(self) -> bool:
        """Every decoded fit request has exactly one terminal response
        and nothing is still queued — the service-side half of the
        zero-lost invariant (the client-side half is each healthy
        tenant's submitted == received accounting)."""
        c = self.status_counts()
        responded = sum(c.get(s, 0) for s in TERMINAL_STATUSES)
        return c["in_flight"] == 0 and responded == c["fit_seen"]

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self.scrape is not None:
            self.scrape.close()
        self.listener.close()
        with self._cv:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()
        self._cold_pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class FitServiceClient:
    """Blocking client for one tenant. Requests are rid-tagged; replies
    arriving out of order (sibling requests coalesced into different
    micro-batches) are buffered until their caller asks. ``fit_async``/
    ``result`` expose the pipelined form the load generator uses."""

    def __init__(self, address: Tuple[str, int], tenant: str = "t0",
                 timeout: float = 10.0, chaos=None, retries: int = 2,
                 tracer: Optional[Tracer] = None):
        self.conn = connect(address, timeout=timeout, chaos=chaos,
                            retries=retries)
        self.tenant = tenant
        # optional client-side tracer: each fit mints a TraceContext and
        # records a client span; transport ships the context in-frame so
        # the frontend's spans chain under it (DESIGN.md §16)
        self.tracer = tracer
        self._rid = itertools.count(1)
        self._buffer: Dict[int, dict] = {}

    def _traced(self) -> bool:
        return self.tracer is not None and self.tracer.enabled

    def _send(self, mtype: str, **payload) -> int:
        rid = next(self._rid)
        self.conn.send(mtype, rid=rid, tenant=self.tenant, **payload)
        return rid

    def result(self, rid: int, timeout: float = 30.0) -> dict:
        if rid in self._buffer:
            return self._buffer.pop(rid)
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"no reply for rid {rid} within {timeout}s")
            msg = self.conn.recv(timeout=remaining)
            if msg is None:
                continue
            if msg.get("rid") == rid:
                return msg
            self._buffer[msg["rid"]] = msg

    # -- ops ----------------------------------------------------------------
    def register(self, D, b=None, keep_data: bool = True,
                 timeout: float = 60.0) -> str:
        rid = self._send("register", D=np.asarray(D),
                         b=None if b is None else np.asarray(b),
                         keep_data=keep_data)
        msg = self.result(rid, timeout=timeout)
        if msg["type"] != "registered":
            raise RuntimeError(msg.get("error", "register failed"))
        return msg["fingerprint"]

    def ingest(self, fingerprint: str, D, b=None,
               timeout: float = 60.0) -> str:
        rid = self._send("ingest", fingerprint=fingerprint,
                         D=np.asarray(D),
                         b=None if b is None else np.asarray(b))
        msg = self.result(rid, timeout=timeout)
        if msg["type"] != "ingested":
            raise RuntimeError(msg.get("error", "ingest failed"))
        return msg["fingerprint"]

    def fit_async(self, problem: str, fingerprint: str, *, b=None,
                  mu=None, l2: float = 0.0, C: float = 1.0,
                  delta: float = 1.0, iters: int = 1000,
                  deadline_s: Optional[float] = None) -> int:
        send = lambda: self._send(  # noqa: E731
            "fit", problem=problem, fingerprint=fingerprint,
            b=None if b is None else np.asarray(b), mu=mu,
            l2=l2, C=C, delta=delta, iters=iters, deadline_s=deadline_s)
        if not self._traced():
            return send()
        # mint a trace unless the caller already opened one (sync fit()
        # wraps this in a request-spanning client span)
        mint = current_context() is None
        with use_context(new_trace() if mint else None):
            with self.tracer.span("client.submit", tenant=self.tenant,
                                  problem=problem):
                return send()

    def fit(self, problem: str, fingerprint: str,
            timeout: float = 30.0, **kw) -> dict:
        if not self._traced():
            rid = self.fit_async(problem, fingerprint, **kw)
            return self.result(rid, timeout=timeout)
        # one client span covering submit → terminal response; the span's
        # context crosses the wire inside the fit frame, so every
        # frontend/executor span of this request is its descendant
        with use_context(new_trace()):
            with self.tracer.span("client.fit", tenant=self.tenant,
                                  problem=problem):
                rid = self.fit_async(problem, fingerprint, **kw)
                return self.result(rid, timeout=timeout)

    def counters(self, timeout: float = 10.0) -> dict:
        return self.result(self._send("counters"), timeout=timeout)

    def ping(self, timeout: float = 10.0) -> bool:
        return self.result(self._send("ping"),
                           timeout=timeout)["type"] == "pong"

    def close(self):
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
