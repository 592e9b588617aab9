"""Port parity for the networked fit service: ``repro_torch.service.admission``
and ``repro_torch.service.frontend`` (copies of the JAX package's modules,
over the port's ``cluster.transport``, ``cluster.chaos`` and ``obs``), on the
CPU.

The mirror of every test of ``tests/test_frontend.py`` — the admission ->
deadline -> degrade -> shed state machine, the exactly-one-terminal-response
invariant, failure containment between tenants (crash / slow-loris / corrupt
frame), the cold-solve circuit breaker and the transport plumb-through — with
the front end's FitServer on the CPU (``device="cpu"``; the default is the
card). Every socket wait and every result has its own timeout.

Then one round trip each way between the packages: the JAX client against
the port's front end and the port's client against the JAX front end. The
frames are plain dicts of numpy arrays and values, so this holds the wire
format too; the fingerprints are the same strings on both sides.
"""
import functools
import socket
import struct
import threading
import time

import numpy as np
import pytest

from repro_torch.cluster.chaos import FaultEvent, FaultInjector
from repro_torch.cluster.transport import ConnectionClosed, Listener, connect
from repro_torch.service.admission import (
    AdmissionController,
    CircuitBreaker,
    TokenBucket,
)
from repro_torch.service.frontend import (
    SERVICE_DATA_PLANE,
    FitServiceClient,
)
from repro_torch.service.frontend import FitFrontend as _FitFrontend

# the front end's own FitServer on the CPU (its default is the card)
FitFrontend = functools.partial(_FitFrontend, device="cpu")


def _data(m=300, n=16, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    return D, b


def _labels(D):
    return np.sign(D @ np.ones(D.shape[1], D.dtype) + 0.1).astype(D.dtype)


# ---------------------------------------------------------------------------
# admission units
# ---------------------------------------------------------------------------

def test_token_bucket_rate_and_retry_hint():
    tb = TokenBucket(rate=10.0, burst=2.0)
    now = time.monotonic()
    assert tb.try_take(now).ok
    assert tb.try_take(now).ok
    adm = tb.try_take(now)
    assert not adm.ok and adm.reason == "quota"
    assert 0.0 < adm.retry_after_s <= 0.11
    # a tenth of a second refills one token at rate 10
    assert tb.try_take(now + 0.11).ok


def test_admission_queue_bound_beats_quota():
    ac = AdmissionController(max_queue=4, tenant_rate=1000.0)
    assert ac.admit("t", in_flight=3).ok
    adm = ac.admit("t", in_flight=4)
    assert not adm.ok and adm.reason == "queue_full"
    assert adm.retry_after_s >= 0.05
    snap = ac.snapshot()
    assert snap["admitted"] == 1 and snap["rejected"] == 1


def test_circuit_breaker_state_machine():
    cb = CircuitBreaker(failure_threshold=2, reset_after_s=0.05)
    assert cb.state == "closed" and cb.allow()
    cb.record_failure()
    assert cb.state == "closed"
    cb.record_failure()
    assert cb.state == "open" and not cb.allow() and cb.trips == 1
    time.sleep(0.06)
    assert cb.state == "half_open"
    assert cb.allow()            # one probe
    assert not cb.allow()        # only one
    cb.record_failure()          # probe failed -> re-open
    assert cb.state == "open" and cb.trips == 2
    time.sleep(0.06)
    assert cb.allow()
    cb.record_success()
    assert cb.state == "closed" and cb.allow()


# ---------------------------------------------------------------------------
# transport plumb-through (satellite: Listener.accept knobs)
# ---------------------------------------------------------------------------

def test_listener_threads_knobs_into_accepted_connections():
    chaos = FaultInjector([FaultEvent(0, "x", "delay", 1.0)])
    lst = Listener(chaos=chaos, max_frame_bytes=1234, frame_deadline_s=0.5)
    try:
        client = threading.Thread(target=lambda: connect(lst.address))
        client.start()
        conn = lst.accept(timeout=2.0)
        client.join()
        assert conn is not None
        assert conn.chaos is chaos
        assert conn.max_frame_bytes == 1234
        assert conn.frame_deadline_s == 0.5
        # explicit per-accept override, including chaos=None
        c2 = threading.Thread(target=lambda: connect(lst.address))
        c2.start()
        conn2 = lst.accept(timeout=2.0, chaos=None, max_frame_bytes=99,
                           frame_deadline_s=9.0)
        c2.join()
        assert conn2.chaos is None and conn2.max_frame_bytes == 99
        assert conn2.frame_deadline_s == 9.0
        conn.close()
        conn2.close()
    finally:
        lst.close()


def test_slow_loris_client_is_severed():
    """Partial frame then stall: the receiver must raise within the
    frame deadline instead of pinning the handler thread."""
    lst = Listener(frame_deadline_s=0.3)
    try:
        raw = socket.create_connection(lst.address)
        conn = lst.accept(timeout=2.0)
        raw.sendall(struct.pack(">Q", 1000)[:4])     # half a header, stall
        t0 = time.monotonic()
        with pytest.raises(ConnectionClosed, match="stalled"):
            conn.recv(timeout=5.0)
        assert time.monotonic() - t0 < 2.0
        assert conn.closed
        raw.close()
    finally:
        lst.close()


def test_oversized_frame_client_is_severed_others_unaffected():
    lst = Listener(max_frame_bytes=1 << 10)
    try:
        bad_raw = socket.create_connection(lst.address)
        bad = lst.accept(timeout=2.0)
        good = None
        t = threading.Thread(target=lambda: connect(lst.address).send(
            "ping", tenant="good"))
        t.start()
        good = lst.accept(timeout=2.0)
        t.join()
        bad_raw.sendall(struct.pack(">Q", 1 << 20))  # absurd length
        with pytest.raises(ConnectionClosed, match="exceeds cap"):
            bad.recv(timeout=2.0)
        # the sibling connection still delivers
        msg = good.recv(timeout=2.0)
        assert msg["type"] == "ping" and msg["tenant"] == "good"
        bad_raw.close()
        good.close()
    finally:
        lst.close()


# ---------------------------------------------------------------------------
# front end: happy path + taxonomy
# ---------------------------------------------------------------------------

def test_frontend_multi_tenant_round_trip_and_coalescing():
    D, b = _data()
    with FitFrontend(window=4, flush_interval_s=0.05) as fe:
        with FitServiceClient(fe.address, tenant="alice") as alice, \
             FitServiceClient(fe.address, tenant="bob") as bob:
            fp = alice.register(D, b)
            rids_a = [alice.fit_async("ridge", fp, mu=1.0)
                      for _ in range(2)]
            rids_b = [bob.fit_async("ridge", fp, mu=1.0)
                      for _ in range(2)]
            res = ([alice.result(r, timeout=20.0) for r in rids_a]
                   + [bob.result(r, timeout=20.0) for r in rids_b])
            assert all(r["status"] == "ok" for r in res)
            x_ref = np.linalg.solve(D.T @ D + np.eye(16), D.T @ b)
            for r in res:
                np.testing.assert_allclose(r["x"], x_ref, rtol=1e-3,
                                           atol=1e-3)
            # tenants' requests coalesced into shared micro-batches
            assert any(r["batch_size"] >= 2 for r in res)
        assert fe.zero_lost_requests()


def test_frontend_rejects_over_quota_with_retry_hint():
    D, b = _data()
    with FitFrontend(window=4, tenant_rate=2.0, tenant_burst=2.0) as fe:
        with FitServiceClient(fe.address, tenant="greedy") as c:
            fp = c.register(D, b)
            rids = [c.fit_async("ridge", fp, mu=1.0) for _ in range(5)]
            res = [c.result(r, timeout=20.0) for r in rids]
            statuses = [r["status"] for r in res]
            assert statuses.count("ok") == 2
            assert statuses.count("rejected") == 3
            rej = [r for r in res if r["status"] == "rejected"]
            assert all(r["retry_after_s"] > 0 for r in rej)
        assert fe.zero_lost_requests()


def test_frontend_queue_bound_sheds_instead_of_growing():
    D, b = _data()
    # a solver that never flushes (huge window + interval) so the queue
    # genuinely fills; max_queue=3 must shed the rest immediately
    with FitFrontend(window=1024, flush_interval_s=30.0, max_queue=3,
                     default_deadline_s=1.0) as fe:
        with FitServiceClient(fe.address, tenant="t") as c:
            fp = c.register(D, b)
            rids = [c.fit_async("ridge", fp, mu=1.0) for _ in range(8)]
            res = [c.result(r, timeout=20.0) for r in rids]
            statuses = [r["status"] for r in res]
            assert statuses.count("rejected") == 5
            # the 3 admitted ones expire their deadline mid-queue —
            # still a terminal answer, never a hang
            assert statuses.count("deadline") == 3
        assert fe.zero_lost_requests()


def test_frontend_deadline_expires_mid_queue():
    D, b = _data()
    with FitFrontend(window=1024, flush_interval_s=30.0) as fe:
        with FitServiceClient(fe.address, tenant="t") as c:
            fp = c.register(D, b)
            t0 = time.monotonic()
            r = c.fit("ridge", fp, mu=1.0, deadline_s=0.25, timeout=20.0)
            dt = time.monotonic() - t0
            assert r["status"] == "deadline"
            assert dt < 5.0              # answered promptly, not hung
        assert fe.zero_lost_requests()


def test_frontend_bad_requests_get_error_and_siblings_survive():
    """Flush-poisoning end to end: a bad group in the same micro-batch
    must not cost any sibling its response."""
    D, b = _data()
    with FitFrontend(window=4, flush_interval_s=0.5) as fe:
        with FitServiceClient(fe.address, tenant="t") as c:
            fp = c.register(D, b)
            rids = [
                c.fit_async("ridge", fp, mu=1.0),
                c.fit_async("ridge", "0" * 64, mu=1.0),   # unknown fp
                c.fit_async("lasso", fp),                 # missing mu
                c.fit_async("ridge", fp, mu=2.0),
            ]
            res = [c.result(r, timeout=20.0) for r in rids]
            assert [r["status"] for r in res] == [
                "ok", "error", "error", "ok"]
            assert "unknown dataset fingerprint" in res[1]["error"]
            assert "no mu" in res[2]["error"]
        assert fe.zero_lost_requests()


# ---------------------------------------------------------------------------
# degradation: budgets, breaker, chaos
# ---------------------------------------------------------------------------

def test_cold_budget_blown_returns_degraded_cached_answer():
    D, _ = _data()
    labels = _labels(D)
    chaos = FaultInjector([FaultEvent(1, "svc", "slow", 1500.0)],
                          data_plane=SERVICE_DATA_PLANE)
    with FitFrontend(window=4, flush_interval_s=0.005, chaos=chaos,
                     cold_budget_s=0.2, breaker_threshold=10) as fe:
        with FitServiceClient(fe.address, tenant="t") as c:
            fp = c.register(D, labels)
            t0 = time.monotonic()
            r = c.fit("logistic", fp, iters=50, timeout=20.0)
            dt = time.monotonic() - t0
            assert r["status"] == "degraded"
            assert "budget" in r["error"]
            assert r["from_cache"] is True
            assert dt < 5.0
            # the degraded answer is the warm ridge probe — a usable
            # linear classifier, not garbage
            acc = np.mean(np.sign(D @ r["x"]) == labels)
            assert acc > 0.8
        assert fe.zero_lost_requests()


def test_breaker_trips_and_sheds_to_degraded():
    D, _ = _data()
    labels = _labels(D)
    # every cold solve stalls 1.5s against a 0.15s budget -> failures
    events = [FaultEvent(i, "svc", "slow", 1500.0) for i in range(1, 4)]
    chaos = FaultInjector(events, data_plane=SERVICE_DATA_PLANE)
    with FitFrontend(window=2, flush_interval_s=0.005, chaos=chaos,
                     cold_budget_s=0.15, breaker_threshold=2,
                     breaker_reset_s=60.0, cold_workers=4) as fe:
        with FitServiceClient(fe.address, tenant="t") as c:
            fp = c.register(D, labels)
            statuses = []
            for _ in range(4):
                r = c.fit("logistic", fp, iters=50, timeout=20.0)
                statuses.append(r["status"])
            assert all(s == "degraded" for s in statuses)
            assert fe.breaker.state == "open"
            # once open, sheds happen without touching the backend
            assert fe.metrics.counter_value("service.breaker_shed") >= 1
        assert fe.zero_lost_requests()


def test_breaker_trips_on_backend_exceptions(monkeypatch):
    D, b = _data()
    fe = FitFrontend(window=2, flush_interval_s=0.005,
                     breaker_threshold=2, breaker_reset_s=60.0)
    try:
        with FitServiceClient(fe.address, tenant="t") as c:
            fp = c.register(D, b)

            def boom(req):
                raise RuntimeError("backend down")

            monkeypatch.setattr(fe.server, "solve_one", boom)
            r1 = c.fit("logistic", fp, b=_labels(D), timeout=20.0)
            r2 = c.fit("logistic", fp, b=_labels(D), timeout=20.0)
            assert r1["status"] == "error" and "backend down" in r1["error"]
            assert r2["status"] == "error"
            assert fe.breaker.state == "open"
            # breaker open: next cold request degrades; the fallback
            # path (solve_one) is also broken, so it lands on "error" —
            # still terminal, still accounted
            r3 = c.fit("logistic", fp, b=_labels(D), timeout=20.0)
            assert r3["status"] == "error"
            assert fe.metrics.counter_value("service.breaker_shed") >= 1
        assert fe.zero_lost_requests()
    finally:
        fe.close()


def test_crashed_client_does_not_stall_siblings():
    D, b = _data()
    # flush well after the victim's EOF is noticed, so its responses
    # deterministically hit a dead connection
    with FitFrontend(window=8, flush_interval_s=0.2) as fe:
        with FitServiceClient(fe.address, tenant="alice") as alice:
            fp = alice.register(D, b)
            victim = FitServiceClient(fe.address, tenant="victim")
            for _ in range(3):
                victim.fit_async("ridge", fp, mu=1.0)
            victim.conn.close()          # crash with requests in flight
            rids = [alice.fit_async("ridge", fp, mu=1.0)
                    for _ in range(4)]
            res = [alice.result(r, timeout=20.0) for r in rids]
            assert all(r["status"] == "ok" for r in res)
            # the victim's responses were produced and accounted, just
            # undeliverable — not lost, not blocking
            deadline = time.monotonic() + 10.0
            while (fe.metrics.counter_value("service.undeliverable") < 3
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert fe.metrics.counter_value("service.undeliverable") == 3
        assert fe.zero_lost_requests()


def test_corrupting_and_loris_clients_are_severed_siblings_fine():
    D, b = _data()
    with FitFrontend(window=8, flush_interval_s=0.02,
                     frame_deadline_s=0.3) as fe:
        with FitServiceClient(fe.address, tenant="alice") as alice:
            fp = alice.register(D, b)
            # corrupt-frame client: garbage body of a plausible length
            bad = socket.create_connection(fe.address)
            bad.sendall(struct.pack(">Q", 16) + b"\xff" * 16)
            # slow-loris client: half a header, then silence
            loris = socket.create_connection(fe.address)
            loris.sendall(struct.pack(">Q", 100)[:3])
            res = [alice.fit("ridge", fp, mu=1.0, timeout=20.0)
                   for _ in range(3)]
            assert all(r["status"] == "ok" for r in res)
            deadline = time.monotonic() + 10.0
            while (fe.metrics.counter_value("service.severed") < 2
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert fe.metrics.counter_value("service.severed") == 2
            bad.close()
            loris.close()
        assert fe.zero_lost_requests()


def test_frontend_shutdown_answers_stranded_requests():
    D, b = _data()
    fe = FitFrontend(window=1024, flush_interval_s=30.0,
                     default_deadline_s=30.0)
    c = FitServiceClient(fe.address, tenant="t")
    fp = c.register(D, b)
    rid = c.fit_async("ridge", fp, mu=1.0)
    # wait until the request is queued server-side, then stop the service
    deadline = time.monotonic() + 5.0
    while (fe.status_counts()["in_flight"] < 1
           and time.monotonic() < deadline):
        time.sleep(0.01)
    fe.close()
    r = c.result(rid, timeout=10.0)
    assert r["status"] == "error" and "shutting down" in r["error"]
    c.close()
    assert fe.zero_lost_requests()


# ---------------------------------------------------------------------------
# across the packages: one client of each against the other's front end
# ---------------------------------------------------------------------------

def _fingerprint(D, b):
    from repro.service.stats import fingerprint_array
    return fingerprint_array(D, b)


def _round_trip(fe, client_cls):
    D, b = _data()
    labels = _labels(D)
    with client_cls(fe.address, tenant="other", timeout=10.0) as c:
        assert c.ping(timeout=10.0)
        fp = c.register(D, b, timeout=30.0)
        assert fp == _fingerprint(D, b)
        rids = [c.fit_async("ridge", fp, mu=1.0),
                c.fit_async("lasso", fp, mu=2.0, iters=300),
                c.fit_async("logistic", fp, b=labels, iters=50)]
        res = [c.result(r, timeout=30.0) for r in rids]
        assert [r["status"] for r in res] == ["ok", "ok", "ok"]
        for r in res:
            assert isinstance(r["x"], np.ndarray)
            assert r["x"].dtype == np.float32 and r["x"].shape == (16,)
        np.testing.assert_allclose(res[0]["x"], np.linalg.solve(
            D.T @ D + np.eye(16), D.T @ b), rtol=1e-3, atol=1e-3)
        assert res[0]["from_cache"] and not res[2]["from_cache"]
        acc = np.mean(np.sign(D @ res[2]["x"]) == labels)
        assert acc > 0.9
        counters = c.counters(timeout=10.0)
        assert counters["type"] == "counters_result"
        assert counters["server"]["gram_passes"] == 1
        assert counters["server"]["full_solves"] == 1
    return res


def test_jax_client_against_port_frontend():
    from repro.service.frontend import FitServiceClient as JClient
    with FitFrontend(window=4, flush_interval_s=0.01) as fe:
        port = _round_trip(fe, JClient)
        assert fe.zero_lost_requests()
    from repro.service.frontend import FitFrontend as JFrontend
    with JFrontend(window=4, flush_interval_s=0.01) as jfe:
        ref = _round_trip(jfe, JClient)
    for a, r in zip(port, ref):
        np.testing.assert_allclose(a["x"], r["x"], rtol=1e-3, atol=1e-3)


def test_port_client_against_jax_frontend():
    from repro.service.frontend import FitFrontend as JFrontend
    with JFrontend(window=4, flush_interval_s=0.01) as fe:
        _round_trip(fe, FitServiceClient)
        assert fe.zero_lost_requests()
