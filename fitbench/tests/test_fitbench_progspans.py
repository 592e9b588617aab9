"""``progspans`` on hand-made traces: launches attributed by correlation
id, an idle partition that sums to the fits' idle time, the ``(none)``
bucket, the device clock put back on the host's, and the exchange's wait
for the slowest rank; the span readers on tables with known idle; a
``--trace 0`` run of the harness, whose window records no program span,
and ``--trace 1`` runs, whose rank summaries carry the program's spans and
counters."""
from types import SimpleNamespace

import pytest
import torch

from fitbench import devtrace, harness, layers, loadgen, manifest, progspans
from fitbench import ranks

PAGEABLE = "Memcpy DtoH (Device -> Pageable)"
# one fit [0, 100) with two iterations of the loop's spans (times in ns)
FIT = [(0, 100)]
SPANS = [(5, 45, "iterate"), (6, 10, "x_solve"), (12, 30, "sweep"),
         (20, 28, "stop_terms"), (32, 44, "host_sync"),
         (50, 95, "iterate"), (51, 55, "x_solve"), (57, 75, "sweep"),
         (65, 73, "stop_terms"), (77, 94, "host_sync")]
# (start, end, name, correlation id): K3 at 14 and 59, the
# m-vector ops at 21 and 66, the solves at 7 and 52, the copies at 33, 78
DEV = [(8, 12, "trsv_ln", 1), (14, 34, "admm_ring_kernel", 2),
       (34, 38, "elementwise", 3), (38, 40, PAGEABLE, 4),
       (53, 57, "trsv_ln", 5), (59, 79, "admm_ring_kernel", 6),
       (79, 83, "elementwise", 7), (83, 85, PAGEABLE, 8),
       (96, 97, "orphan", 99)]
LAUNCH = {1: (7, 8), 2: (14, 16), 3: (21, 22), 4: (33, 41), 5: (52, 53),
          6: (59, 60), 7: (66, 67), 8: (78, 86)}


def _table(dev=DEV, launch=LAUNCH, spans=SPANS, fits=FIT):
    return progspans.attribute(dev, launch, fits, spans)


def test_innermost_stretches_follow_the_nesting():
    segs = progspans.innermost([(0, 10, "a"), (2, 4, "b"), (6, 8, "c")])
    assert [(a, b, n) for a, b, n, _ in segs] == [
        (0, 2, "a"), (2, 4, "b"), (4, 6, "a"), (6, 8, "c"), (8, 10, "a")]
    assert segs[1][3] == 2 and segs[2][3] == 0


def test_launches_are_attributed_by_correlation_id():
    s = _table()
    dev = {k: round(v["device_s"] * 1e9) for k, v in s["spans"].items()}
    assert dev == {"x_solve": 8, "sweep": 40, "stop_terms": 8,
                   "host_sync": 4, "iterate": 0, progspans.NONE: 0,
                   progspans.UNMATCHED: 1}
    assert s["iters"] == 2 and s["spans"]["sweep"]["count"] == 2
    assert s["early"] == 0
    assert round(s["fits_device_s"] * 1e9) == 61


def test_idle_partition_sums_to_the_fits_idle():
    s = _table()
    idle = {k: round(v["idle_s"] * 1e9) for k, v in s["spans"].items()}
    # device busy [8, 12), [14, 40), [53, 57), [59, 85), [96, 97) in
    # [0, 100): idle 0-8, 12-14, 40-53, 57-59, 85-96, 97-100
    assert round(s["fits_idle_s"] * 1e9) == 8 + 2 + 13 + 2 + 11 + 3
    assert sum(idle.values()) == round(s["fits_idle_s"] * 1e9)
    assert idle == {"iterate": 1 + 1 + 1 + 1, "x_solve": 2 + 2,
                    "sweep": 2 + 2, "stop_terms": 0, "host_sync": 4 + 9,
                    progspans.NONE: 5 + 5 + 1 + 3,
                    progspans.UNMATCHED: 0}
    ms = progspans.per_iter_ms([s])
    assert ms["sync_idle"] == pytest.approx(13e-9 / 2 * 1e3)
    assert ms["dispatch_idle"] == pytest.approx((4 + 4 + 4) * 1e-9 / 2
                                                * 1e3)
    assert ms["stop_terms"] == pytest.approx(8e-9 / 2 * 1e3)


def test_idle_outside_every_span_goes_under_none():
    s = _table(spans=[])
    assert s["iters"] == 0
    assert s["spans"][progspans.NONE]["idle_s"] == pytest.approx(
        s["fits_idle_s"])
    assert s["spans"][progspans.NONE]["device_s"] == pytest.approx(60e-9)


def test_device_clock_is_put_back_on_the_host_clock():
    """Device times 35 ms early, as the profiler gave on a card: the
    bracket of launches and copies undoes the shift, and the table reads
    as with no shift at all."""
    off = 35_000_000
    moved = [(a - off, b - off, *rest) for a, b, *rest in DEV]
    s0, s1 = _table(), _table(dev=moved)
    assert s1["raw_lead_min_ns"] == s0["raw_lead_min_ns"] - off
    assert s1["shift_ns"] == [off + x for x in s0["shift_ns"]]
    for name, row in s0["spans"].items():
        for key in ("device_s", "idle_s"):
            assert s1["spans"][name][key] == pytest.approx(row[key],
                                                           abs=2e-9)
    assert s1["early"] == 0
    # a copy to pinned memory returns at once and may end long after its
    # call: it bounds nothing
    pinned = (88, 90, "Memcpy DtoH (Device -> Pinned)", 10)
    s2 = _table(dev=DEV + [pinned], launch={**LAUNCH, 10: (60, 61)})
    assert s2["shift_ns"] == s0["shift_ns"]


def test_exchange_wait_of_two_ranks_with_known_skew():
    # rank 1's collective starts 30 ns after rank 0's in the first
    # exchange, rank 0's 10 ns after rank 1's in the second
    assert progspans.exchange_wait_s([[100, 310], [130, 300]]) \
        == pytest.approx((30 + 10) / 2 * 1e-9)
    spans = [(0, 50, "iterate"), (10, 40, "exchange"),
             (50, 100, "iterate"), (60, 90, "exchange")]
    dev = [(15, 20, "ncclDevKernel_AllGather", 1),
           (21, 22, "Memcpy DtoD", 2),
           (65, 70, "ncclDevKernel_AllGather", 3)]
    launch = {1: (12, 13), 2: (14, 15), 3: (62, 63)}
    r0 = progspans.attribute(dev, launch, [(0, 100)], spans)
    later = [(a + 30, b + 30, *x) for a, b, *x in dev]
    launch1 = {k: (a + 30, b + 30) for k, (a, b) in launch.items()}
    r1 = progspans.attribute(later, launch1, [(0, 130)],
                             [(a + 30, b + 30, n) for a, b, n in spans])
    assert r0["exchange_nccl_ns"] == [15, 65]
    assert r1["exchange_nccl_ns"] == [45, 95]
    ms = progspans.per_iter_ms([r0, r1])
    assert ms["exchange_wait"] == pytest.approx(1e3 * 30e-9 / 2)


def test_untraced_window_records_no_program_span(monkeypatch):
    """A ``--trace 0`` run: inside the window the process's current
    Observability is the disabled one."""
    from repro_torch import obs
    seen = []
    real = loadgen.drive

    def drive(mix, fit, *a, **kw):
        def watched(req):
            seen.append(obs.current())
            return fit(req)
        return real(mix, watched, *a, **kw)
    monkeypatch.setattr(loadgen, "drive", drive)
    out = harness.run_cell("star-logistic", 2 ** 31 + 11, 0.001, False,
                           device="cpu",
                           cfg_override={"rows_per_node": 20000})
    assert out["attempted"] >= 1
    assert seen and all(o is obs.NOOP for o in seen)


def _two_ranks():
    """Two ranks' tables of two iterations each, the second rank's
    exchange 30 ns after the first's, and 13 ns of idle under
    ``host_sync`` and 4 under ``iterate`` on each."""
    spans = [(0, 50, "iterate"), (10, 30, "exchange"), (35, 45, "host_sync"),
             (50, 100, "iterate"), (60, 80, "exchange"),
             (85, 95, "host_sync")]
    dev = [(15, 20, "ncclDevKernel_AllGather", 1),
           (36, 40, PAGEABLE, 2),
           (65, 70, "ncclDevKernel_AllGather", 3),
           (86, 90, PAGEABLE, 4)]
    launch = {1: (12, 13), 2: (35, 41), 3: (62, 63), 4: (85, 91)}

    def table(off):
        return progspans.attribute(
            [(a + off, b + off, *x) for a, b, *x in dev],
            {k: (a + off, b + off) for k, (a, b) in launch.items()},
            [(off, 100 + off)], [(a + off, b + off, n) for a, b, n in spans])
    return [table(0), table(30)]


def _ctx(tables):
    return SimpleNamespace(trace=[{"spans": t} for t in tables])


# (reader, ranks' tables, expected ms an iteration); times in ns, 2 iters
READERS = [
    ("sync_idle_ms_per_iter", lambda: [_table()], 13e-9 / 2 * 1e3),
    ("dispatch_idle_ms_per_iter", lambda: [_table()], 12e-9 / 2 * 1e3),
    # on each rank: idle under host_sync 35-36, 40-45, 85-86, 90-95
    ("sync_idle_ms_per_iter.x4", _two_ranks, 12e-9 / 2 * 1e3),
    # under exchange 10-15, 20-30, 60-65, 70-80; under iterate 0-10,
    # 30-35, 45-60, 80-85, 95-100
    ("dispatch_idle_ms_per_iter.x4", _two_ranks,
     (30 + 40) * 1e-9 / 2 * 1e3),
    # rank 0 waits 30 ns in each exchange for rank 1, which waits none:
    # over 2 exchanges, 2 ranks and 2 iterations
    ("exchange_wait_ms_per_iter.x4", _two_ranks,
     (30 + 30) * 1e-9 / 2 / 2 * 1e3),
]


@pytest.mark.parametrize("name,tables,ms", READERS,
                         ids=[r[0] for r in READERS])
def test_span_reader_gives_known_ms(name, tables, ms):
    reader = manifest.module("metrics", name)
    assert reader.read(_ctx(tables())) == pytest.approx(ms, rel=1e-9)


@pytest.mark.parametrize("name", [r[0] for r in READERS])
def test_span_reader_without_spans_gives_none(name):
    reader = manifest.module("metrics", name)
    t = _two_ranks()
    assert reader.read(SimpleNamespace(trace=None)) is None
    assert reader.read(SimpleNamespace(trace=[{"spans": None}])) is None
    assert reader.read(_ctx([t[0], None])) is None
    assert reader.read(SimpleNamespace(trace=[{}, {}])) is None
    # a table with no iteration in it
    assert reader.read(_ctx([_table(spans=[])])) is None


def test_span_helper_needs_every_rank():
    t = _two_ranks()
    ctx = _ctx(t)
    assert layers.span_ms_per_iter(ctx, "sync_idle") \
        == pytest.approx(progspans.per_iter_ms(t)["sync_idle"])
    assert layers.span_ms_per_iter(_ctx([t[0], {"iters": 0}]),
                                   "sync_idle") is None


def _summary(prof):
    """``devtrace.summarize`` of a window with no device: it raises on a
    CPU profile."""
    return {"window_s": 1.0, "busy_s": 0.5, "fits": [(1.0, 0.5)],
            "kernels": {}, "idle": {}}


def _traced_rank(w, seed, seconds, trace, device, t0, rank=None):
    """``harness._rank`` with the device summary stubbed; rank 0's result
    also carries every rank's trace summary and window iterations, and the
    ``Observability`` each of its fits saw."""
    from repro_torch import obs
    mp = pytest.MonkeyPatch()
    mp.setattr(devtrace, "summarize", _summary)
    seen = []
    drive, finish = loadgen.drive, harness._finish

    def watched(mix, fit, *a, **kw):
        def fit_seen(req):
            seen.append(obs.current())
            return fit(req)
        return drive(mix, fit_seen, *a, **kw)

    def kept(w, payloads, *a):
        return {**finish(w, payloads, *a), "seen": seen,
                "traces": [p["trace"] for p in payloads],
                "iters": [[x["iters"] for x in p["answers"]]
                          for p in payloads]}
    mp.setattr(loadgen, "drive", watched)
    mp.setattr(harness, "_finish", kept)
    torch.set_num_threads(1)
    try:
        return harness._rank(w, seed, seconds, trace, device, t0, rank=rank)
    finally:
        mp.undo()


@pytest.mark.parametrize("cell,rows", [("star-logistic", 1000),
                                       ("star-logistic-x4", 1000)])
def test_traced_window_records_the_program_spans_and_counters(
        cell, rows, monkeypatch):
    """A ``--trace 1`` run: every fit of the window sees an enabled
    ``Observability``; each rank's summary carries the loop's spans, one
    ``iterate`` an iteration of the window, and its counters, one
    ``stop_terms`` count a sweep; the cell's span readers read them."""
    from repro_torch import obs
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    w = manifest.cell(manifest.load(), cell)
    w["cfg"].update({"rows_per_node": rows, "base_features": 3,
                     "max_iters": 20})
    args = (w, 2 ** 31 + 19, 0.001, True, "cpu", 0.0)
    out = _traced_rank(*args) if w["chips"] == 1 \
        else ranks.run(w["chips"], _traced_rank, args)
    assert out["correct"], out["checks"]
    assert out["seen"] and all(o.enabled and o is not obs.NOOP
                               for o in out["seen"])
    assert len({id(o) for o in out["seen"]}) == 1
    assert obs.current() is obs.NOOP
    assert len(out["traces"]) == w["chips"]
    for t, iters in zip(out["traces"], out["iters"]):
        sweeps = sum(iters)
        assert sweeps > 0
        assert t["spans"]["iters"] == sweeps
        assert t["spans"]["spans"]["host_sync"]["count"] == sweeps
        c = t["counters"]
        assert c.get("stop_terms.torch", 0) + c.get("stop_terms.fused", 0) \
            == sweeps
        assert all(isinstance(v, (int, float)) for v in c.values())
        # no device on the CPU: the fits' time is all idle, split by span
        assert sum(r["idle_s"] for r in t["spans"]["spans"].values()) \
            == pytest.approx(t["spans"]["fits_idle_s"])
    spanned = [m["name"] for m in w["per_layer"]
               if m["source"] == "program_span"]
    got = {k for k, v in out["metrics"].items() if v["value"] > 0}
    # no NCCL on the CPU: the exchange's wait is not read there
    assert set(spanned) - got == ({"exchange_wait_ms_per_iter.x4"}
                                  if w["chips"] > 1 else set())
