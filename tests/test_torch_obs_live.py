"""Port parity for the live observability plane (DESIGN.md section 16):
the mirror of the service-free tests of ``tests/test_obs_live.py``, on
``repro_torch.obs`` and ``repro_torch.launch.obs_report`` (copies of the
JAX package's modules).

Covered: the request-scoped trace context (in process and across the TCP
wire of ``repro_torch.cluster.transport``), the scrape endpoint, the SLOs
with burn rates, the flight recorder, crash-safe artifacts (atexit,
SIGTERM and SIGKILL flushes, truncated salvage) and obs_report's service
view; and one registry rendered through both packages'
``render_prometheus`` and ``build_report``, which must agree.

Waiting, with the modules they test:
  * the fit service (ROADMAP item 10, not ported yet):
    ``test_trace_propagates_through_chaos_slowed_cold_solve``,
    ``test_queue_wait_span_reconciles_with_dispatch_histogram``,
    ``test_old_format_frames_still_decode``,
    ``test_breaker_trip_dumps_incident`` (all drive ``FitFrontend``),
    ``test_admission_emits_bounded_tenant_labels``,
    ``test_admission_reject_reason_labeled`` (``AdmissionController``) and
    ``test_frontend_scrape_reconciles_with_status_counts``;
  * the benchmark scripts (ROADMAP item 5): the three ``bench_compare``
    tests.
"""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from repro_torch.launch.obs_report import build_report
from repro_torch.obs import Observability, load_incident, read_jsonl
from repro_torch.obs.context import (
    TraceContext,
    current_context,
    new_trace,
    use_context,
)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.scrape import ScrapeServer, render_prometheus
from repro_torch.obs.slo import BURN_CAP, Objective, SLOTracker
from repro_torch.obs.telemetry import jsonable
from repro_torch.obs.trace import Tracer, is_ancestor, load_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


# ---------------------------------------------------------------------------
# trace context units
# ---------------------------------------------------------------------------

def test_context_child_and_wire_roundtrip():
    root = new_trace()
    child = root.child()
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id
    assert TraceContext.from_wire(root.to_wire()) == root
    # malformed wire forms decode to None, never raise
    for bad in (None, 17, "x", {}, {"trace_id": 1, "span_id": "a"},
                {"trace_id": "t"}):
        assert TraceContext.from_wire(bad) is None
    # non-string parent_id is dropped, context still usable
    ctx = TraceContext.from_wire({"trace_id": "t", "span_id": "s",
                                  "parent_id": 9})
    assert ctx is not None and ctx.parent_id is None


def test_use_context_is_scoped_and_none_is_noop():
    assert current_context() is None
    with use_context(None):
        assert current_context() is None
    ctx = new_trace()
    with use_context(ctx):
        assert current_context() is ctx
        with use_context(ctx.child()) as inner:
            assert current_context() is inner
        assert current_context() is ctx
    assert current_context() is None


def test_spans_chain_under_active_context_and_stamp_args():
    tr = Tracer(enabled=True)
    with use_context(new_trace()):
        root_ctx = current_context()
        with tr.span("outer"):
            with tr.span("inner"):
                pass
    evs = [e for e in tr.events() if e.get("ph") == "X"]
    by_name = {e["name"]: e["args"] for e in evs}
    assert by_name["outer"]["parent_id"] == root_ctx.span_id
    assert by_name["inner"]["parent_id"] == by_name["outer"]["span_id"]
    assert (by_name["inner"]["trace_id"] == by_name["outer"]["trace_id"]
            == root_ctx.trace_id)
    assert is_ancestor(evs, by_name["outer"]["span_id"],
                       by_name["inner"]["span_id"])
    assert not is_ancestor(evs, by_name["inner"]["span_id"],
                           by_name["outer"]["span_id"])


def test_complete_at_records_retroactive_child_span():
    tr = Tracer(enabled=True)
    ctx = new_trace()
    t0_us = time.time_ns() // 1000 - 50_000
    tr.complete_at("queue_wait", t0_us, 0.05, ctx=ctx, tenant="t")
    (ev,) = [e for e in tr.events() if e.get("ph") == "X"]
    assert ev["ts"] == t0_us and ev["dur"] == pytest.approx(50_000)
    assert ev["args"]["parent_id"] == ctx.span_id
    assert ev["args"]["tenant"] == "t"


def test_traced_frames_are_ignored_gracefully_by_raw_reader():
    """The _ctx field is additive: a frame sent from inside an active
    context carries it, and a reader that only looks at the keys it
    knows still gets everything it asked for."""
    from repro_torch.cluster.transport import Listener, connect
    lst = Listener("127.0.0.1", 0)
    try:
        got = {}

        def _serve():
            conn = lst.accept(timeout=5.0)
            got.update(conn.recv(timeout=5.0))
            conn.close()

        import threading
        th = threading.Thread(target=_serve, daemon=True)
        th.start()
        conn = connect(lst.address, timeout=5.0)
        ctx = new_trace()
        with use_context(ctx):
            conn.send("ping", rid=1)
        th.join(timeout=5.0)
        conn.close()
        assert got["type"] == "ping" and got["rid"] == 1
        assert got["_ctx"] == ctx.to_wire()
        assert TraceContext.from_wire(got["_ctx"]) == ctx
    finally:
        lst.close()


# ---------------------------------------------------------------------------
# scrape endpoint
# ---------------------------------------------------------------------------

def test_render_prometheus_groups_and_types():
    snap = {
        "counters": [
            {"name": "svc.b", "labels": {}, "value": 1},
            {"name": "svc.a", "labels": {"k": "1"}, "value": 2},
            {"name": "svc.b", "labels": {"k": "2"}, "value": 3},
        ],
        "gauges": [{"name": "g.x", "labels": {}, "value": 1.5}],
        "histograms": [],
    }
    text = render_prometheus(snap)
    lines = [ln for ln in text.splitlines() if ln]
    # one TYPE line per metric, all samples of a metric contiguous
    assert lines.count("# TYPE svc_b_total counter") == 1
    bi = [i for i, ln in enumerate(lines) if ln.startswith("svc_b_total")]
    assert bi == list(range(bi[0], bi[0] + 2))
    assert 'svc_a_total{k="1"} 2' in lines
    assert "# TYPE g_x gauge" in lines and "g_x 1.5" in lines


def test_render_prometheus_histogram_summary():
    reg = MetricsRegistry()
    for v in [0.01, 0.02, 0.03, 0.5]:
        reg.observe("lat_s", v, kind="warm")
    text = render_prometheus(reg.snapshot())
    assert "# TYPE lat_s summary" in text
    assert 'lat_s{kind="warm",quantile="0.5"}' in text
    assert 'lat_s_count{kind="warm"} 4' in text


def test_scrape_server_routes_live_registry():
    reg = MetricsRegistry()
    reg.inc("hits", route="a")
    srv = ScrapeServer(lambda: reg.snapshot(),
                       health_fn=lambda: {"status": "ok", "n": 1},
                       slo_fn=lambda: {"objectives": [], "ok": True})
    try:
        st, text = _get(srv.url("/metrics"))
        assert st == 200 and 'hits_total{route="a"} 1' in text
        # the snapshot callable runs per scrape: counters move live
        reg.inc("hits", route="a")
        _, js = _get(srv.url("/metrics.json"))
        snap = json.loads(js)
        assert [c["value"] for c in snap["counters"]
                if c["name"] == "hits"] == [2]
        st, hz = _get(srv.url("/healthz"))
        assert st == 200 and json.loads(hz)["status"] == "ok"
        st, slo = _get(srv.url("/slo"))
        assert st == 200 and json.loads(slo)["ok"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url("/nope"))
        assert ei.value.code == 404
    finally:
        srv.close()


def test_scrape_callback_error_is_500_not_thread_death():
    boom = {"on": True}

    def snap():
        if boom["on"]:
            raise RuntimeError("kaboom")
        return {"counters": [], "gauges": [], "histograms": []}

    srv = ScrapeServer(snap)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url("/metrics"))
        assert ei.value.code == 500
        boom["on"] = False
        st, _ = _get(srv.url("/metrics"))   # thread survived the error
        assert st == 200
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

def _objs():
    return (
        Objective(name="avail", kind="availability", target=0.8),
        Objective(name="warm_lat", kind="latency", target=0.9,
                  threshold_s=1.0, scope="warm"),
        Objective(name="zero_lost", kind="external", target=1.0),
    )


def test_slo_availability_and_burn_rate():
    tr = SLOTracker(window_s=60.0)
    for _ in range(9):
        tr.record("ok", latency_s=0.1, warm=True)
    tr.record("error", latency_s=0.1, warm=True)
    ev = tr.evaluate(_objs(), external={"zero_lost": True})
    by = {o["name"]: o for o in ev["objectives"]}
    assert by["avail"]["sli"] == pytest.approx(0.9)
    # 10% bad against a 20% budget burns at half the sustainable rate
    assert by["avail"]["burn_rate"] == pytest.approx(0.5)
    assert by["avail"]["ok"] is True and ev["ok"] is True


def test_slo_latency_scope_and_threshold():
    tr = SLOTracker(window_s=60.0)
    for _ in range(8):
        tr.record("ok", latency_s=0.2, warm=True)
    tr.record("ok", latency_s=3.0, warm=True)      # warm, slow
    tr.record("ok", latency_s=9.0, warm=False)     # cold: out of scope
    by = {o["name"]: o
          for o in tr.evaluate(_objs(),
                               external={"zero_lost": True})["objectives"]}
    assert by["warm_lat"]["events"] == 9
    assert by["warm_lat"]["sli"] == pytest.approx(8 / 9)
    assert by["warm_lat"]["ok"] is False


def test_slo_external_zero_tolerance_and_unknown():
    tr = SLOTracker(window_s=60.0)
    tr.record("ok")
    by = {o["name"]: o
          for o in tr.evaluate(_objs(),
                               external={"zero_lost": False})["objectives"]}
    assert by["zero_lost"]["ok"] is False
    assert by["zero_lost"]["burn_rate"] == BURN_CAP
    ev = tr.evaluate(_objs())              # no external supplied
    by = {o["name"]: o for o in ev["objectives"]}
    assert by["zero_lost"]["ok"] is None
    assert ev["ok"] is True                # unknown is not a failure


def test_slo_window_expiry_and_empty_pool():
    tr = SLOTracker(window_s=10.0)
    now = time.monotonic()
    tr.record("error", t=now - 60.0)       # long expired
    ev = tr.evaluate(_objs(), external={"zero_lost": True}, now=now)
    by = {o["name"]: o for o in ev["objectives"]}
    assert by["avail"]["ok"] is None and by["avail"]["events"] == 0


def test_slo_export_gauges():
    tr = SLOTracker(window_s=60.0)
    tr.record("ok", latency_s=0.1, warm=True)
    reg = MetricsRegistry()
    tr.export_gauges(reg, objectives=_objs(),
                     external={"zero_lost": True})
    snap = reg.snapshot()
    gauges = {(g["name"], g["labels"].get("objective")): g["value"]
              for g in snap["gauges"]}
    assert gauges[("slo.sli", "avail")] == 1.0
    assert gauges[("slo.ok", "zero_lost")] == 1.0


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_flight_ring_is_bounded_and_ordered(tmp_path):
    fr = FlightRecorder(dir=str(tmp_path), capacity=8, window_s=60.0)
    for i in range(20):
        fr.note("tick", i=i)
    snap = fr.snapshot()
    assert snap["events_recorded"] == 20 and snap["ring_size"] == 8
    path = fr.incident("probe")
    doc = load_incident(path)
    assert [e["i"] for e in doc["events"]] == list(range(12, 20))


def test_flight_incident_stamps_trace_context(tmp_path):
    fr = FlightRecorder(dir=str(tmp_path))
    ctx = new_trace()
    with use_context(ctx):
        fr.note("respond", status="error")
    doc = load_incident(fr.incident("status_error", rid=3))
    assert doc["trigger"]["rid"] == 3
    assert doc["events"][-1]["trace_id"] == ctx.trace_id


def test_flight_incident_cap_counts_drops(tmp_path):
    fr = FlightRecorder(dir=str(tmp_path), max_incidents=2)
    fr.note("x")
    assert fr.incident("a") and fr.incident("b")
    assert fr.incident("c") is None
    snap = fr.snapshot()
    assert snap["incidents"] == 2 and snap["incidents_dropped"] == 1
    assert len(fr.incidents()) == 2


def test_disabled_flight_recorder_is_noop():
    fr = FlightRecorder(dir=None, enabled=False)
    fr.note("x")
    assert fr.incident("y") is None
    assert fr.snapshot()["events_recorded"] == 0


# ---------------------------------------------------------------------------
# crash-safe artifacts
# ---------------------------------------------------------------------------

_CHILD = r"""
import os, sys, time
from repro_torch.obs import Observability
obs = Observability(dir=sys.argv[1], process_name="victim")
obs.inc("child.counter", 3)
with obs.span("child.work"):
    pass
for i in range(20):
    obs.record(iter=i, objective=float(i))
mode = sys.argv[2]
if mode == "atexit":
    sys.exit(0)                      # no finish(): atexit must flush
obs.flush()
print("READY", flush=True)
while True:                          # parent kills us here
    obs.record(iter=999, objective=0.0)
    time.sleep(0.01)
"""


def _spawn_victim(tmp_path, mode):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(tmp_path), mode],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        text=True)


def _wait_ready(proc, timeout=60.0):
    line = proc.stdout.readline()
    assert "READY" in line


def test_atexit_flushes_artifacts_without_finish(tmp_path):
    proc = _spawn_victim(tmp_path, "atexit")
    assert proc.wait(timeout=120.0) == 0
    snap = json.load(open(tmp_path / "metrics.json"))
    assert [c["value"] for c in snap["counters"]
            if c["name"] == "child.counter"] == [3]
    evs = load_trace(str(tmp_path / "trace.json"))
    assert any(e.get("name") == "child.work" for e in evs)
    recs = read_jsonl(str(tmp_path / "telemetry.jsonl"))
    assert len(recs) == 20


def test_sigterm_flushes_then_dies_with_conventional_status(tmp_path):
    proc = _spawn_victim(tmp_path, "loop")
    _wait_ready(proc)
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=120.0)
    assert rc == -signal.SIGTERM
    assert any(e.get("name") == "child.work"
               for e in load_trace(str(tmp_path / "trace.json")))
    assert len(read_jsonl(str(tmp_path / "telemetry.jsonl"))) >= 20


def test_sigkill_leaves_loadable_artifacts(tmp_path):
    """SIGKILL mid-write: everything written before the kill loads
    cleanly through the tolerant readers."""
    proc = _spawn_victim(tmp_path, "loop")
    _wait_ready(proc)
    time.sleep(0.1)                    # let it write mid-loop records
    proc.kill()
    proc.wait(timeout=60.0)
    recs = read_jsonl(str(tmp_path / "telemetry.jsonl"))
    assert len(recs) >= 20             # pre-kill records all present
    assert [r["iter"] for r in recs[:20]] == list(range(20))
    evs = load_trace(str(tmp_path / "trace.json"))
    assert any(e.get("name") == "child.work" for e in evs)


def test_truncated_artifacts_salvage(tmp_path):
    obs = Observability(dir=str(tmp_path), process_name="t",
                        crash_flush=False)
    for i in range(5):
        obs.record(iter=i)
    with obs.span("kept"):
        pass
    obs.finish()
    # tear both files the way a dying writer would
    tpath = tmp_path / "telemetry.jsonl"
    tpath.write_text(tpath.read_text() + '{"iter": 99, "obj')
    trpath = tmp_path / "trace.json"
    raw = trpath.read_text()
    trpath.write_text(raw[:int(len(raw) * 0.7)])
    recs = read_jsonl(str(tpath))
    assert [r["iter"] for r in recs] == list(range(5))
    evs = load_trace(str(trpath))      # salvages complete event objects
    assert isinstance(evs, list)


# ---------------------------------------------------------------------------
# obs_report service mode
# ---------------------------------------------------------------------------

def test_obs_report_renders_service_section(tmp_path):
    reg = MetricsRegistry()
    for status, n in (("ok", 5), ("degraded", 1), ("rejected", 2)):
        for _ in range(n):
            reg.inc("service.responses", status=status)
    reg.inc("service.fit_seen", 8, tenant="t0")
    reg.inc("service.degraded", why="cold solve blew its budget")
    reg.inc("admission.admitted", 6, tenant="t0")
    reg.inc("admission.rejected", 2, tenant="t0", reason="quota")
    for v in (0.01, 0.02):
        reg.observe("server.fit_latency_s", v, kind="warm")
    rundir = tmp_path / "run"
    rundir.mkdir()
    (rundir / "metrics.json").write_text(
        json.dumps(jsonable(reg.snapshot())))
    report = build_report(str(rundir))
    svc = report["service"]
    assert svc["status_mix"] == {"ok": 5, "degraded": 1, "rejected": 2}
    (tenant_row,) = svc["per_tenant"]
    assert tenant_row["tenant"] == "t0"
    assert tenant_row["admitted"] == 6 and tenant_row["rejected"] == 2
    assert svc["degrade_why"] == {"cold solve blew its budget": 1}


def test_both_packages_render_the_same_registry(tmp_path):
    """One registry (service counters, a labelled histogram, gauges, a
    worker series) and one telemetry stream, rendered by both packages:
    the Prometheus text and the obs_report summary are the same."""
    from repro.launch.obs_report import build_report as j_build_report
    from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
    from repro.obs.scrape import render_prometheus as j_render

    regs = (MetricsRegistry(), JMetricsRegistry())
    for reg in regs:
        for status, n in (("ok", 4), ("rejected", 1)):
            reg.inc("service.responses", n, status=status)
        reg.inc("transport.rx_bytes", 1234, type="contrib")
        reg.set_gauge("slo.sli", 0.97, objective="avail")
        for v in (0.004, 0.011, 0.019, 0.25):
            reg.observe("worker.block_step_s", v, worker="0")
            reg.observe("server.fit_latency_s", v / 2, kind="warm")
    port_snap, jax_snap = (reg.snapshot() for reg in regs)
    assert render_prometheus(port_snap) == j_render(jax_snap)
    dirs = []
    for name, snap in (("port", port_snap), ("jax", jax_snap)):
        rundir = tmp_path / name
        rundir.mkdir()
        (rundir / "metrics.json").write_text(json.dumps(jsonable(snap)))
        (rundir / "telemetry.jsonl").write_text("".join(
            json.dumps({"iter": i, "objective": 1.0 / i,
                        "iter_s": 0.01 * i,
                        "rx_bytes": {"contrib": 100}}) + "\n"
            for i in range(1, 6)))
        dirs.append(str(rundir))
    port, ref = build_report(dirs[0]), j_build_report(dirs[1])
    port.pop("rundir"), ref.pop("rundir")
    assert port == ref
    assert port["service"]["status_mix"] == {"ok": 4, "rejected": 1}
