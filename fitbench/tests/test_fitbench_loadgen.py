"""The load generator on made-up systems: closed and open loops, several
callers, request classes drawn from the seed, and the gate over ranks."""
import threading
import time

import pytest

from fitbench import loadgen, manifest


def _system(seconds=0.01):
    calls = []
    lock = threading.Lock()

    def fit(req):
        with lock:
            calls.append(req)
        time.sleep(seconds)
        return {"index": req["index"]}
    return fit, calls


def test_closed_loop_one_caller():
    fit, calls = _system()
    recs, window = loadgen.drive({"loop": "closed"}, fit, 0.2, seed=1,
                                 sync=lambda: None)
    assert len(recs) == len(calls) >= 10
    assert [r["index"] for _, _, r in recs] == list(range(len(recs)))
    assert all(0.009 < s < 0.1 for s, _, _ in recs)
    assert window >= 0.2


def test_closed_loop_several_callers_overlap():
    fit, calls = _system(0.05)
    recs, window = loadgen.drive({"loop": "closed", "clients": 4}, fit, 0.3,
                                 seed=1, sync=lambda: None)
    # four callers at once finish about four times the requests of one
    assert len(recs) >= 16
    assert sorted(r["index"] for _, _, r in recs) == list(range(len(recs)))


@pytest.mark.parametrize("arrivals", ["fixed", "poisson"])
def test_open_loop_rate_and_queueing(arrivals):
    fit, calls = _system(0.002)
    mix = {"loop": "open", "rate_per_s": 200, "arrivals": arrivals}
    recs, window = loadgen.drive(mix, fit, 0.5, seed=2 ** 31 + 3,
                                 sync=lambda: None)
    assert 70 <= len(recs) <= 130
    # a system slower than the arrivals: latency counts the wait
    slow, _ = _system(0.02)
    recs, _ = loadgen.drive({"loop": "open", "rate_per_s": 100,
                             "arrivals": "fixed"}, slow, 0.3, seed=5,
                            sync=lambda: None)
    lat = [s for s, _, _ in recs]
    assert lat[-1] > 5 * lat[0]


def test_same_seed_same_requests():
    mix = {"loop": "open", "rate_per_s": 50,
           "classes": [{"weight": 3, "tenant": "a"},
                       {"weight": 1, "tenant": "b", "rows": 10}]}

    def take(seed, k=400):
        gen = loadgen.requests(mix, seed)
        return [next(gen) for _ in range(k)]
    one, two = take(2 ** 33 + 1), take(2 ** 33 + 1)
    assert one == two and one != take(2 ** 33 + 2)
    share = sum(r["tenant"] == "a" for _, _, r in one) / len(one)
    assert 0.65 < share < 0.85
    assert all(r.get("rows") == 10 for _, _, r in one if r["tenant"] == "b")
    assert all(b[1] > a[1] for a, b in zip(one, one[1:]))


def test_gate_decides_for_every_rank():
    fit, calls = _system(0.0)
    said = []

    def gate(go):
        said.append(go)
        return len(said) <= 3          # the first rank's decision
    recs, _ = loadgen.drive({"loop": "closed"}, fit, 100.0, seed=1,
                            sync=lambda: None, gate=gate)
    assert len(recs) == 3
    with pytest.raises(ValueError):
        loadgen.drive({"loop": "closed", "clients": 2}, fit, 1.0, seed=1,
                      sync=lambda: None, gate=gate)


def test_warm_sends_the_mix_first_requests():
    fit, calls = _system(0.0)
    loadgen.warm({"loop": "closed", "warm_requests": 2}, fit, 1,
                 lambda: None)
    assert [c["index"] for c in calls] == [0, 1]


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (manifest.HERE / "traffic").glob("*.json")))
def test_traffic_files_use_known_keys(mix):
    body = manifest.data_file("traffic", mix)
    assert set(body) <= {"loop", "clients", "rate_per_s", "arrivals",
                         "classes", "warm_requests", "why"}
    assert body["loop"] in ("closed", "open")
    gen = loadgen.requests(body, 7)
    assert next(gen)[2]["index"] == 0
