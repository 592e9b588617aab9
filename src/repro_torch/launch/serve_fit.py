"""Fit-serving launcher: batched multi-problem serving from cached stats;
port of ``repro/launch/serve_fit.py``.

``python -m repro_torch.launch.serve_fit --rows 20000 --features 128
     --requests 64 --problem ridge [--window 16] [--mu-path]``

Registers a synthetic dataset once (ONE Gram pass: K2b on the card), then
drives a stream of fit requests — fresh linear-probe label vectors, or a
lasso mu-path with ``--mu-path`` — through the micro-batching FitServer,
and reports latency against the naive per-request lower bound plus the
server's cost counters.

``--port`` switches to the NETWORKED multi-tenant service: a
:class:`~repro_torch.service.frontend.FitFrontend` over TCP with admission
control (``--max-queue``, ``--tenant-quota``), per-request deadlines
(``--deadline-s``), and optional seeded chaos against the cold-solve
backend (``--chaos-seed``). With ``--requests N`` it drives N fits from
two loopback tenants and prints the terminal-status mix + latency; with
``--requests 0`` it serves until interrupted. The dataset is registered
over the wire, in one frame: the front end's frame cap is raised to hold
it.

It runs on the card (``--device cuda``) unless asked for the CPU; the data
are made on the host with numpy from ``--seed``, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.fit import fit
from repro_torch.device import resolve_device
from repro_torch.service import FitRequest, FitServer
from repro_torch.service.batching import lasso_mu_path

# the register frame carries D and b pickled, plus this much for the rest
FRAME_SLACK = 1 << 20


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _serve_networked(args, dev: torch.device):
    from repro_torch.cluster.chaos import FaultEvent, FaultInjector
    from repro_torch.service.frontend import (
        SERVICE_DATA_PLANE,
        FitFrontend,
        FitServiceClient,
    )

    rng = np.random.default_rng(args.seed)
    m, n = args.rows, args.features
    D = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)

    chaos = None
    if args.chaos_seed is not None:
        crng = np.random.default_rng(args.chaos_seed)
        points = sorted(int(p) for p in crng.integers(
            2, max(3, args.requests or 64), size=3))
        chaos = FaultInjector(
            [FaultEvent(p, "svc", "slow", 1500.0) for p in points],
            data_plane=SERVICE_DATA_PLANE)
        print(f"chaos: slow cold backend at request seq {points} "
              f"(seed {args.chaos_seed})")

    obs = None
    if args.obs_dir is not None:
        from repro_torch.obs import Observability
        obs = Observability(dir=args.obs_dir, process_name="frontend")

    fe = FitFrontend(window=args.window, max_queue=args.max_queue,
                     tenant_rate=args.tenant_quota,
                     default_deadline_s=args.deadline_s,
                     cold_budget_s=min(2.0, args.deadline_s),
                     port=args.port, chaos=chaos, obs=obs,
                     scrape_port=args.scrape_port, device=dev,
                     max_frame_bytes=max(64 << 20, D.nbytes + b.nbytes
                                         + FRAME_SLACK))
    host, port = fe.address
    print(f"fit service listening on {host}:{port} "
          f"(max_queue={args.max_queue}, "
          f"tenant_quota={args.tenant_quota}, "
          f"deadline_s={args.deadline_s}, device={dev})", flush=True)
    if fe.scrape is not None:
        print(f"scrape endpoint: {fe.scrape.url('/metrics')}  "
              f"(also /metrics.json /healthz /slo)", flush=True)
    try:
        with FitServiceClient(fe.address, tenant="launcher") as setup:
            t0 = time.time()
            fp = setup.register(D, b)
            print(f"registered {m:,} x {n} dataset in "
                  f"{time.time()-t0:.2f}s (fingerprint {fp[:12]}...)",
                  flush=True)
        if not args.requests:
            print("serving until interrupted (Ctrl-C)...", flush=True)
            try:
                while True:
                    time.sleep(1.0)
            except KeyboardInterrupt:
                return
        lat = []
        statuses: dict = {}
        t_run = time.time()
        with FitServiceClient(fe.address, tenant="t0") as c0, \
                FitServiceClient(fe.address, tenant="t1") as c1:
            for i in range(args.requests):
                c = (c0, c1)[i % 2]
                problem = (args.problem if i % 3 else "logistic")
                t0 = time.time()
                kw = ({"mu": args.mu} if problem != "logistic" else {})
                r = c.fit(problem, fp, iters=args.iters,
                          deadline_s=args.deadline_s, timeout=120.0,
                          **kw)
                lat.append(time.time() - t0)
                statuses[r["status"]] = statuses.get(r["status"], 0) + 1
        dt = time.time() - t_run
        lat_ms = np.asarray(lat) * 1e3
        print(f"drove {args.requests} requests from 2 tenants in "
              f"{dt:.2f}s: statuses {statuses}; latency p50 "
              f"{np.percentile(lat_ms, 50):.1f} ms, p99 "
              f"{np.percentile(lat_ms, 99):.1f} ms")
        print("service counts:", fe.status_counts())
        print("zero lost requests:", fe.zero_lost_requests())
        slo = fe.slo_snapshot()
        print("slo:", {o["name"]: (o["ok"], o.get("burn_rate"))
                       for o in slo["objectives"]})
        return {"statuses": statuses, "counts": fe.status_counts(),
                "zero_lost": fe.zero_lost_requests(),
                "counters": fe.server.counters.snapshot()}
    finally:
        fe.close()
        if obs is not None:
            obs.finish()
            print(f"observability artifacts in {args.obs_dir}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="ridge",
                    choices=["ridge", "lasso", "elastic_net", "nnls"])
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--mu", type=float, default=1.0)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--mu-path", action="store_true",
                    help="serve a lasso regularization path instead of "
                         "fresh-label probes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the server keeps the data and solves "
                         "(default cuda; pass cpu to run without a GPU)")
    net = ap.add_argument_group("networked service (--port)")
    net.add_argument("--port", type=int, default=None,
                     help="serve over TCP on this port (0 = OS-assigned) "
                          "instead of driving the in-process server")
    net.add_argument("--max-queue", type=int, default=256,
                     help="bounded admission queue; beyond it requests "
                          "are answered status=rejected with a "
                          "retry-after hint")
    net.add_argument("--tenant-quota", type=float, default=None,
                     help="per-tenant token-bucket rate (requests/s); "
                          "default unmetered")
    net.add_argument("--deadline-s", type=float, default=30.0,
                     help="default per-request deadline; expired "
                          "requests are answered status=deadline")
    net.add_argument("--chaos-seed", type=int, default=None,
                     help="seed slow-cold-backend faults so the degrade "
                          "path (status=degraded from cached stats) is "
                          "observable")
    net.add_argument("--scrape-port", type=int, default=None,
                     help="expose /metrics (Prometheus text), /healthz "
                          "and /slo on this port (0 = OS-assigned)")
    net.add_argument("--obs-dir", default=None,
                     help="write metrics.json / trace.json / "
                          "telemetry.jsonl + flight-recorder incidents "
                          "into this run directory")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.port is not None:
        return _serve_networked(args, dev)

    rng = np.random.default_rng(args.seed)
    m, n = args.rows, args.features
    D = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)) \
        .to(dev)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(dev)

    srv = FitServer(window=args.window, device=dev)
    t0 = time.time()
    fp = srv.register_dataset(D, b)
    _sync(dev)
    print(f"registered {m:,} x {n} dataset in {time.time()-t0:.2f}s "
          f"(fingerprint {fp[:12]}..., ONE Gram pass)", flush=True)

    if args.mu_path:
        mus = torch.logspace(-2, 1, args.requests)
        t0 = time.time()
        X = lasso_mu_path(srv.stats_for(fp).G, srv.stats_for(fp).c, mus,
                          iters=args.iters)
        _sync(dev)
        dt = time.time() - t0
        nnz = (X.abs() > 1e-5).sum(1).cpu().numpy()
        print(f"lasso mu-path: {args.requests} solves sharing one Gram in "
              f"{dt:.2f}s ({dt/args.requests*1e3:.1f} ms/solve); "
              f"support {nnz.max()} -> {nnz.min()} along the path")
        return {"X": X, "seconds": dt, "counters": srv.counters.snapshot()}

    reqs = [
        FitRequest(problem=args.problem, fingerprint=fp,
                   b=rng.standard_normal(m).astype(np.float32),
                   mu=args.mu, iters=args.iters)
        for _ in range(args.requests)
    ]
    t0 = time.time()
    resp = srv.serve(reqs)
    dt = time.time() - t0
    assert len(resp) == args.requests

    # naive lower bound: one request through the one-shot fit() path
    t0 = time.time()
    fit(args.problem, D.reshape(1, m, n), reqs[0].b.reshape(1, m),
        mu=args.mu, iters=args.iters, device=dev)
    _sync(dev)
    t_single = time.time() - t0

    print(f"served {args.requests} {args.problem} requests in {dt:.2f}s "
          f"({dt/args.requests*1e3:.1f} ms/request, window={args.window})")
    print(f"one-shot fit() of a single request: {t_single:.2f}s -> naive "
          f"serial estimate {t_single*args.requests:.1f}s, "
          f"speedup ~{t_single*args.requests/max(dt, 1e-9):.0f}x")
    print("counters:", srv.counters.snapshot())
    return {"responses": resp, "seconds": dt,
            "counters": srv.counters.snapshot()}


if __name__ == "__main__":
    main()
