"""Port parity for ``repro_torch.obs`` (a copy of ``repro.obs``) and its
wiring into the solvers: the mirror of ``tests/test_obs.py``. Registry
thread safety, histogram percentiles, span nesting and attributes in the
exported Chrome trace, the cluster snapshot merge (registry and
ByteCounter), telemetry against the JAX package's telemetry record for
record on a lasso run, and bit-identical x with observability on or off
(the shared driver reads its telemetry from the one host transfer it makes
per iteration)."""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import prox as jprox
from repro.core.unwrapped import UnwrappedADMM as JADMM
from repro.data.synthetic import lasso_problem
from repro.obs import Observability as JObservability
from repro.obs import read_jsonl as j_read_jsonl
from repro_torch.cluster.transport import ByteCounter
from repro_torch.core.prox import StackedProx, make_l1, make_least_squares
from repro_torch.core.unwrapped import UnwrappedADMM
from repro_torch.obs import (
    METRICS_FILE,
    NOOP,
    TELEMETRY_FILE,
    TRACE_FILE,
    Histogram,
    MetricsRegistry,
    Observability,
    Tracer,
    current,
    jsonable,
    load_trace,
    read_jsonl,
    recording,
    span_hotspots,
    summarize_histogram,
)
from repro_torch.sharding import compat
from obs_ranks import traced_shard_solve

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)


# -- registry ---------------------------------------------------------------

def test_registry_thread_safety():
    """Concurrent incs/observes from many threads lose no updates."""
    reg = MetricsRegistry()
    threads, per_thread = 8, 2000

    def worker(tid):
        for i in range(per_thread):
            reg.inc("ops", 1, kind="a" if i % 2 else "b")
            reg.observe("lat_s", 1e-3 * (1 + (i % 7)))

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    total = sum(reg.labeled("ops", "kind").values())
    assert total == threads * per_thread
    snap = reg.histogram_snapshot("lat_s")
    assert snap["count"] == threads * per_thread


def test_histogram_percentiles_vs_numpy():
    """Log-bucket quantile estimates stay within one bucket width
    (factor 10^(1/32) ~ 7.5%) of numpy's exact percentiles."""
    rng = np.random.default_rng(0)
    vals = rng.lognormal(mean=-6.0, sigma=1.0, size=20000)
    h = Histogram()
    for v in vals:
        h.observe(float(v))
    for q in (0.5, 0.9, 0.99):
        exact = float(np.quantile(vals, q))
        est = h.quantile(q)
        assert abs(est - exact) / exact < 0.08, (q, est, exact)
    assert abs(h.mean - vals.mean()) / vals.mean() < 1e-6
    assert h.min == vals.min() and h.max == vals.max()


def test_histogram_snapshot_roundtrip_and_summary():
    h = Histogram()
    for v in (0.001, 0.002, 0.004, 0.008):
        h.observe(v)
    snap = h.to_snapshot()
    h2 = Histogram.from_snapshot(json.loads(json.dumps(snap)))
    assert h2.count == 4 and h2.sum == h.sum
    s = summarize_histogram(snap, scale=1e3)   # seconds -> ms
    assert s["count"] == 4
    assert s["min"] == 1.0 and s["max"] == 8.0
    assert 1.0 <= s["p50"] <= 8.0


def test_registry_merge_with_extra_labels():
    """Coordinator folding two worker snapshots keeps per-worker series
    apart while counters/buckets add."""
    coord, w0, w1 = MetricsRegistry(), MetricsRegistry(), MetricsRegistry()
    for _ in range(3):
        w0.inc("worker.iters")
        w0.observe("worker.iter_s", 0.010)
    for _ in range(5):
        w1.inc("worker.iters")
        w1.observe("worker.iter_s", 0.020)
    coord.merge(w0.snapshot(), extra_labels={"worker": "0"})
    coord.merge(w1.snapshot(), extra_labels={"worker": "1"})
    assert coord.counter_value("worker.iters", worker="0") == 3
    assert coord.counter_value("worker.iters", worker="1") == 5
    assert coord.labeled("worker.iters", "worker") == {"0": 3, "1": 5}
    h0 = coord.histogram_snapshot("worker.iter_s", worker="0")
    h1 = coord.histogram_snapshot("worker.iter_s", worker="1")
    assert h0["count"] == 3 and h1["count"] == 5
    assert abs(h0["sum"] - 0.030) < 1e-12


def test_bytecounter_legacy_snapshot_and_merge():
    """ByteCounter rides the registry but keeps its legacy dict shape."""
    a, b = ByteCounter(), ByteCounter()
    a.add("tx", "contrib", 100)
    a.add("tx", "contrib", 50)
    a.add("rx", "x", 24)
    b.add("tx", "hello", 7)
    snap = a.snapshot()
    assert snap["sent_bytes"] == {"contrib": 150}
    assert snap["sent_msgs"] == {"contrib": 2}
    assert snap["received_bytes"] == {"x": 24}
    a.merge(b.snapshot())
    assert a.snapshot()["sent_bytes"] == {"contrib": 150, "hello": 7}
    assert a.total("tx") == 157


# -- tracer -----------------------------------------------------------------

def test_span_nesting_and_attrs(tmp_path):
    tr = Tracer(enabled=True, process_name="test-proc")
    with tr.span("outer", k=1):
        with tr.span("inner", block="b3", k=2):
            pass
    path = str(tmp_path / "trace.json")
    tr.export(path)
    events = load_trace(path)
    xs = {e["name"]: e for e in events if e.get("ph") == "X"}
    assert set(xs) == {"outer", "inner"}
    assert xs["inner"]["args"] == {"block": "b3", "k": 2}
    assert xs["outer"]["args"] == {"k": 1}
    o, i = xs["outer"], xs["inner"]
    assert i["ts"] >= o["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1.0
    metas = [e for e in events if e.get("ph") == "M"]
    assert any(e["name"] == "process_name"
               and e["args"]["name"] == "test-proc" for e in metas)
    assert any(e["name"] == "thread_name"
               and e["tid"] == o["tid"] for e in metas)
    hot = span_hotspots(events)
    assert hot[0]["name"] == "outer" and hot[0]["count"] == 1


def test_tracer_merges_worker_events():
    """Coordinator folds a worker's shipped event list under its own
    timeline with a process_name track for the worker pid."""
    coord = Tracer(enabled=True, process_name="coordinator")
    worker = Tracer(enabled=True)
    with worker.span("block_step", block=0):
        pass
    coord.add_events(worker.events(), process_name="worker-0", pid=4242)
    events = coord.events()
    assert any(e.get("ph") == "M" and e.get("name") == "process_name"
               and e.get("pid") == 4242
               and e["args"]["name"] == "worker-0" for e in events)
    assert any(e.get("ph") == "X" and e["name"] == "block_step"
               for e in events)


def test_disabled_tracer_is_noop():
    tr = Tracer(enabled=False, process_name="off")
    with tr.span("x", a=1):
        pass
    tr.instant("i")
    assert tr.events() == []
    obs = Observability(dir=None, enabled=False)
    obs.inc("n")
    obs.observe("h", 1.0)
    obs.record(iter=1)
    with obs.span("s"):
        pass
    assert obs.registry.snapshot()["counters"] == []
    obs.finish()   # no dir: must not write anything / raise
    # tensors go to JSON as numbers and lists, never as their repr
    assert jsonable({"a": torch.tensor(2.5), "b": torch.arange(3),
                     "c": torch.tensor(float("nan"))}) == \
        {"a": 2.5, "b": [0, 1, 2], "c": None}


# -- telemetry parity with the JAX package ----------------------------------

def _lasso_inputs(key, N, m_per_node, n=16):
    """The reference's stacked lasso (D_hat = [I; D], tau = 0.01 m) as
    numpy arrays both packages take."""
    prob = lasso_problem(jax.random.PRNGKey(key), N=N,
                         m_per_node=m_per_node, n=n)
    Dflat = np.asarray(prob.D).reshape(-1, n)
    m = Dflat.shape[0]
    D_hat = np.concatenate([np.eye(n, dtype=np.float32), Dflat])[None]
    aux = np.concatenate([np.zeros(n, np.float32),
                          np.asarray(prob.b).reshape(-1)])[None]
    return D_hat, aux, float(prob.mu), m, n


def _solver_pair(mu, m, n):
    jsp = jprox.StackedProx(blocks=(jprox.make_l1(mu),
                                    jprox.make_least_squares()),
                            sizes=(n, m))
    tsp = StackedProx(blocks=(make_l1(mu), make_least_squares()),
                      sizes=(n, m))
    return (JADMM(loss=jsp.as_loss(), tau=0.01 * m),
            UnwrappedADMM(loss=tsp.as_loss(), tau=0.01 * m, device="cpu"))


# ``run``'s parity tolerances against the JAX package
# (tests/test_torch_unwrapped.py::test_run_matches_jax)
RUN_TOL = {"objective": dict(rtol=1e-4),
           "primal_res": dict(rtol=1e-3, atol=1e-3),
           "dual_res": dict(rtol=1e-3, atol=1e-3),
           "grad_sq": dict(rtol=1e-3, atol=1e-4)}


def test_telemetry_matches_admm_history_lasso(tmp_path):
    """A small lasso run with telemetry on, in both packages: the port's
    JSONL stream reproduces its own ADMMHistory to 1e-6 (the reference's
    bar) and the JAX package's stream record for record, with the same
    keys, the floats to ``run``'s parity tolerances (RUN_TOL) and every
    other value equal, and the same run artifacts."""
    D_hat, aux, mu, m, n = _lasso_inputs(5, 2, 100)
    jsolver, tsolver = _solver_pair(mu, m, n)

    jobs = JObservability(dir=str(tmp_path / "jax"), process_name="test")
    jsolver.run(jnp.asarray(D_hat), jnp.asarray(aux), iters=25, obs=jobs)
    jobs.finish()
    obs = Observability(dir=str(tmp_path / "obs"), process_name="test")
    res = tsolver.run(D_hat, aux, iters=25, obs=obs)
    obs.finish()

    recs = [r for r in read_jsonl(str(tmp_path / "obs" / TELEMETRY_FILE))
            if "iter" in r]
    jrecs = [r for r in j_read_jsonl(str(tmp_path / "jax" / TELEMETRY_FILE))
             if "iter" in r]
    hist = res.history
    assert len(recs) == len(jrecs) == 25
    for key, col in (("objective", hist.objective),
                     ("primal_res", hist.primal_res),
                     ("dual_res", hist.dual_res)):
        np.testing.assert_allclose([r[key] for r in recs], col.numpy(),
                                   rtol=1e-6)
    for r, jr in zip(recs, jrecs):
        assert set(r) == set(jr)
        for key, v in jr.items():
            if key in RUN_TOL and v is not None:    # null: NaN in both
                np.testing.assert_allclose(r[key], v, **RUN_TOL[key],
                                           err_msg=key)
            else:
                assert r[key] == v, key
    assert all(r["tau"] == tsolver.tau for r in recs)

    with open(tmp_path / "obs" / METRICS_FILE) as f:
        snap = json.load(f)
    assert any(e["name"] == "admm.runs" and e["value"] == 1
               for e in snap["counters"])
    trace = load_trace(str(tmp_path / "obs" / TRACE_FILE))
    assert any(e.get("ph") == "X" and e["name"] == "admm_run"
               for e in trace)


def test_obs_disabled_run_identical(tmp_path):
    """obs=None and an enabled obs produce bit-identical solver output,
    on ``run`` and on the shared driver's ``solve`` (instrumentation
    reads, never perturbs), and the solve's telemetry records carry the
    driver's per-iteration keys."""
    D_hat, aux, mu, m, n = _lasso_inputs(6, 1, 80)
    _, solver = _solver_pair(mu, m, n)
    r0 = solver.run(D_hat, aux, iters=10)
    obs = Observability(dir=str(tmp_path / "o"), process_name="t")
    r1 = solver.run(D_hat, aux, iters=10, obs=obs)
    s0 = solver.solve(D_hat, aux, max_iters=15)
    s1 = solver.solve(D_hat, aux, max_iters=15, obs=obs)
    obs.finish()
    assert torch.equal(r0.x, r1.x)
    assert torch.equal(s0.x, s1.x) and s0.iters == s1.iters
    recs = [r for r in read_jsonl(str(tmp_path / "o" / TELEMETRY_FILE))
            if r.get("executor") == "local"]
    assert len(recs) == s1.iters
    assert {"iter", "objective", "primal_res", "dual_res", "eps_pri",
            "eps_dual", "iter_s", "sweep_s", "backend"} <= set(recs[0])


# -- the fit loop's spans ----------------------------------------------------

LOOP_SPANS = ("iterate", "x_solve", "sweep", "stop_terms", "host_sync")


def test_disabled_span_is_the_shared_null_object():
    """Off, a span is one attribute read: the same null object every
    time, with no event and no allocation of its own."""
    from repro_torch.obs.trace import _NULL_SPAN
    assert NOOP.span("x_solve", k=1) is _NULL_SPAN
    assert NOOP.tracer.iter_span("x_solve", 1) is _NULL_SPAN
    assert NOOP.tracer.iter_span("stop_terms") is _NULL_SPAN
    assert NOOP.tracer.events() == []


def test_recording_sets_and_restores_the_current_observability():
    assert current() is NOOP
    outer, inner = Observability(enabled=True), Observability(enabled=True)
    with recording(outer):
        assert current() is outer
        with recording(inner):
            assert current() is inner
        assert current() is outer
    assert current() is NOOP
    try:
        with recording(outer):
            raise KeyError("x")
    except KeyError:
        pass
    assert current() is NOOP


def test_span_encloses_the_profilers_event():
    """A span and the profiler share one clock: the profiler's event for
    the op the span wraps lies inside the span's nanosecond interval."""
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer(enabled=True)
    a, b = torch.ones(256), torch.ones(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(20):
            with tr.iter_span("add", k):
                torch.add(a, b)
    spans = [e for e in tr.events() if e.get("ph") == "X"]
    adds = sorted((e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() == "aten::add")
    assert len(spans) == len(adds) == 20
    for e, (a0, a1) in zip(sorted(spans, key=lambda e: e["ts_ns"]), adds):
        assert e["ts"] == e["ts_ns"] // 1000
        assert e["ts_ns"] <= a0 and a1 <= e["ts_ns"] + e["dur"] * 1000


def test_iter_span_stamps_the_loop_iteration():
    """Spans opened without ``k`` below the solve loop take the iteration
    the loop's last span named on their thread."""
    tr = Tracer(enabled=True)
    for k in (1, 2):
        with tr.iter_span("iterate", k):
            with tr.iter_span("stop_terms"):
                pass
    got = [(e["name"], e["args"]["k"]) for e in tr.events()
           if e.get("ph") == "X"]
    assert sorted(got) == [("iterate", 1), ("iterate", 2),
                           ("stop_terms", 1), ("stop_terms", 2)]


def test_solve_under_recording_spans_each_iteration_once():
    """``UnwrappedADMM.solve`` with no ``obs``, inside ``recording``: one
    of each loop span per iteration, each stamped with its iteration, and
    an answer bitwise equal to the untraced solve's."""
    D_hat, aux, mu, m, n = _lasso_inputs(7, 2, 60)
    _, solver = _solver_pair(mu, m, n)
    plain = solver.solve(D_hat, aux, max_iters=12)
    ob = Observability(enabled=True)
    with recording(ob):
        traced = solver.solve(D_hat, aux, max_iters=12)
    assert torch.equal(plain.x, traced.x) and plain.iters == traced.iters
    xs = [e for e in ob.tracer.events() if e.get("ph") == "X"]
    for name in LOOP_SPANS:
        ks = sorted(e["args"]["k"] for e in xs if e["name"] == name)
        assert ks == list(range(1, traced.iters + 1)), name
    assert [e["name"] for e in xs if e["name"] not in LOOP_SPANS] \
        == ["gram_setup"]
    assert not any(e["name"] == "exchange" for e in xs)


def test_shard_map_under_recording_spans_each_iteration_once():
    """``ShardMapExecutor`` on a gloo world of 2 inside ``recording``: the
    loop spans and one ``exchange`` per iteration on every rank, and each
    rank's x bitwise equal to its untraced solve's."""
    rng = np.random.default_rng(3)
    D = rng.standard_normal((400, 12)).astype(np.float32)
    labels = np.sign(rng.standard_normal(400)).astype(np.float32)
    out = compat.spawn(traced_shard_solve, 2, "gloo",
                       args=(D, labels, 15), device="cpu", threads=1,
                       timeout=300)
    for r in out:
        assert np.array_equal(r["x0"], r["x1"])
        for name in LOOP_SPANS + ("exchange",):
            assert r["counts"][name] == r["iters"], name
        assert r["counts"]["gram_setup"] == 1
