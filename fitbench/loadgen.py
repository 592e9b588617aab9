"""The one load generator: it reads a traffic mix (``traffic/<mix>.json``, a
file of parameters and nothing else) and drives requests through the system
under test for the measured window.

A mix's keys:

- ``loop``: ``"closed"``, each of ``clients`` callers sends its next
  request when its last returns, until ``seconds`` have passed; or
  ``"open"``, requests arrive at ``rate_per_s`` (``arrivals``:
  ``"poisson"``, the default, or ``"fixed"`` spacing) until ``seconds``
  have passed, and ``clients`` workers serve them in order of arrival.
  Requests in flight or queued when the window ends are finished: the
  window closes with the last answer.
- ``clients``: callers or workers (default 1), each a thread of its own.
- ``classes``: optional, a list of request classes, each with a
  ``weight`` and any parameters the system reads (a tenant, a problem, a
  size); each request draws its class from the seed. Without it every
  request is ``{}`` plus its index.
- ``warm_requests``: requests sent in set-up, before the window, to build
  and load every kernel the window uses.

The system under test is a function of one request (a dict with
``index`` and its class's parameters) that returns its answer. A request's
latency runs from its arrival (open loop) or its call (closed loop) until
its answer is on the device (``sync``). Over several ranks every rank runs
the same requests together, one at a time: ``gate`` carries the first
rank's decision to go on to all of them.
"""
from __future__ import annotations

import random
import threading
import time

from fitbench import devtrace


def requests(mix: dict, seed: int):
    """The mix's requests in order, endless: (index, arrival offset in
    seconds or None in a closed loop, request). The same seed gives the
    same requests."""
    rng = random.Random(int(seed))
    classes = mix.get("classes") or [{"weight": 1}]
    weights = [float(c["weight"]) for c in classes]
    params = [{k: v for k, v in c.items() if k != "weight"} for c in classes]
    openloop = mix["loop"] == "open"
    rate = float(mix["rate_per_s"]) if openloop else 0.0
    poisson = mix.get("arrivals", "poisson") == "poisson"
    t, i = 0.0, 0
    while True:
        if openloop:
            t += rng.expovariate(rate) if poisson else 1.0 / rate
        k = rng.choices(range(len(classes)), weights)[0] \
            if len(classes) > 1 else 0
        yield i, (t if openloop else None), {"index": i, **params[k]}
        i += 1


def warm(mix: dict, fit, seed: int, sync) -> None:
    """Set-up's warm requests: the first of the mix's own, in order."""
    gen = requests(mix, seed)
    for _ in range(int(mix.get("warm_requests", 1))):
        fit(next(gen)[2])
    sync()


def drive(mix: dict, fit, seconds: float, *, seed: int, sync, gate=None,
          trace: bool = False):
    """(records, window seconds): a record is (latency seconds, answer,
    request) for every request of the window, in the order they ended."""
    if mix["loop"] not in ("closed", "open"):
        raise ValueError(f"unknown loop {mix['loop']!r} in {mix}")
    clients = int(mix.get("clients", 1))
    if gate is not None and clients != 1:
        raise ValueError("requests over several ranks run one at a time")
    gen = requests(mix, seed)
    lock = threading.Lock()
    records = []
    with devtrace.span(devtrace.WINDOW, trace):
        start = time.perf_counter()

        def serve():
            while True:
                with lock:
                    _, due, req = next(gen)
                    go = (due if due is not None
                          else time.perf_counter() - start) < seconds
                    if gate is not None:
                        go = gate(go)
                if not go:
                    return
                if due is not None:
                    time.sleep(max(0.0, start + due - time.perf_counter()))
                with devtrace.span(devtrace.FIT, trace):
                    t0 = start + due if due is not None \
                        else time.perf_counter()
                    ans = fit(req)
                    sync()
                    t1 = time.perf_counter()
                with lock:
                    records.append((t1 - t0, ans, req))

        if clients == 1:
            serve()
        else:
            workers = [threading.Thread(target=serve)
                       for _ in range(clients)]
            for w in workers:
                w.start()
            for w in workers:
                w.join()
        window = time.perf_counter() - start
    return records, window
