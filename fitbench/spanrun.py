"""Traced windows of one cell, with the program's spans recorded and not in
turns, in one process: the split of the fits' device time and idle time
by the program's spans (``progspans``), and what recording them costs.

    python3 fitbench/spanrun.py --workload <name> --seed <n> \\
        --seconds <s> [--windows 4] [--out <file>]

Set-up (data, system, warm requests) runs once, as in ``run.py``. Then
every window runs the cell's traffic under ``torch.profiler``, as the
window of a ``--trace 1`` run does; windows 2 and 3 of every four also
record the program's spans under ``repro_torch.obs.recording``. For each
window one JSON line goes to standard output: its fits and iterations,
``host_ms_per_iter`` and ``idle_pct`` as the benchmark's readers compute
them, and, with the spans on, the per-iteration split
(``progspans.per_iter_ms``), each rank's per-span table and three checks:
the idle partition's sum against the fits' idle time, the share of the
fits' device time attributed to a span, and the number of operations that
started on the device before their span opened. The tables also go to
standard error. ``--device cpu`` with a small ``--rows-per-node``
rehearses the run without a card (no device time there).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _window(mix, fit, seconds, seed, dev, gate, on):
    """One traced window on this rank: its record for rank 0."""
    from repro_torch import obs

    from fitbench import devtrace, harness, loadgen, progspans
    ob = obs.Observability(enabled=True) if on else obs.NOOP
    with devtrace.profiled(True, dev.type) as prof, obs.recording(ob):
        records, window = loadgen.drive(
            mix, fit, seconds, seed=seed, sync=lambda: harness._sync(dev),
            gate=gate, trace=True)
        harness._sync(dev)
    out = {"iters": [a["iters"] for _, a, _ in records], "window_s": window,
           "trace": devtrace.summarize(prof) if dev.type == "cuda"
           else None,
           "spans": progspans.summarize(prof, ob.tracer.events(),
                                        threading.get_ident())
           if on else None}
    del prof
    gc.collect()
    return out


def _rank_windows(w, seed, seconds, windows, device, group):
    import torch

    from fitbench import harness, loadgen, manifest
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda" and group is not None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg, mix = w["cfg"], w["mix"]
    inputs = manifest.module("data", cfg["data"]).make(cfg, seed, dev)
    fit = manifest.module("systems", cfg["system"]).prepare(
        cfg, inputs, dev, group)
    gate = None
    if group is not None:
        import torch.distributed as dist
        flag = torch.zeros(1, device=dev)

        def gate(go):
            flag.fill_(1.0 if go else 0.0)
            dist.broadcast(flag, src=0)
            return bool(flag.item())
    loadgen.warm(mix, fit, seed, lambda: harness._sync(dev))
    if group is None or group.rank == 0:
        print(f"spanrun: set-up {time.perf_counter() - T0:.2f} s",
              file=sys.stderr, flush=True)
    return [_window(mix, fit, seconds, seed, dev, gate, i % 4 in (1, 2))
            for i in range(windows)]


def _rank(w, seed, seconds, windows, device, rank=None):
    """Every rank's windows, on rank 0 (ranks' lists, in rank order)."""
    if rank is None:
        return [_rank_windows(w, seed, seconds, windows, device, None)]
    import torch.distributed as dist

    from repro_torch.sharding import compat
    with compat.make_group(device=device) as group, compat.use_group(group):
        mine = _rank_windows(w, seed, seconds, windows, device, group)
        outs = [None] * group.world if group.rank == 0 else None
        dist.gather_object(mine, outs, dst=0)
    return outs


def combine(w, per_rank, device_name) -> dict:
    """One window's result from the ranks' records: the cell's per-layer
    metrics, read by the benchmark's own readers from the same inputs a
    ``--trace 1`` run gives them, and with the spans on, the split and its
    checks."""
    from fitbench import manifest, progspans, roofline
    r0 = per_rank[0]
    m, n = manifest.module("data", w["cfg"]["data"]).size(w["cfg"])
    out = {"fits": len(r0["iters"]), "iters": sum(r0["iters"]),
           "window_s": r0["window_s"]}
    if r0["trace"] is not None:
        ctx = SimpleNamespace(
            cfg=w["cfg"], chips=len(per_rank), window_s=r0["window_s"],
            iters=r0["iters"], m=m, m_rank=-(-m // len(per_rank)), n=n,
            peaks=roofline.peaks(device_name),
            trace=[r["trace"] for r in per_rank])
        out["metrics"] = {
            x["name"]: manifest.module("metrics", x["name"]).read(ctx)
            for x in w["per_layer"]}
    spans = [r["spans"] for r in per_rank]
    if spans[0] is None:
        return out
    out["per_iter_ms"] = progspans.per_iter_ms(spans)
    idle = sum(s["fits_idle_s"] for s in spans)
    device = sum(s["fits_device_s"] for s in spans)

    def total(name, key):
        return sum(s["spans"].get(name, {}).get(key, 0.0) for s in spans)
    out["checks"] = {
        "partition_over_fits_idle": (
            sum(r["idle_s"] for s in spans for r in s["spans"].values())
            / idle if idle else None),
        "fits_idle_over_trace_idle": (
            idle / sum(s - b for r in per_rank
                       for s, b in r["trace"]["fits"])
            if r0["trace"] is not None else None),
        "none_idle_share": total(progspans.NONE, "idle_s") / idle
        if idle else None,
        "attributed_device_share": 1 - (
            total(progspans.NONE, "device_s")
            + total(progspans.UNMATCHED, "device_s")) / device
        if device else None,
        "early": sum(s["early"] for s in spans),
        "early_max_ns": max(s["early_max_ns"] for s in spans),
        "raw_lead_min_ns": [s["raw_lead_min_ns"] for s in spans],
        "shift_ns": [s["shift_ns"] for s in spans],
        "bracket_ns": [s["bracket_ns"] for s in spans],
        "drifted": [s["drifted"] for s in spans]}
    out["spans"] = [s["spans"] for s in spans]
    out["top_ops"] = spans[0]["top_ops"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows-per-node", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from fitbench import card, manifest, progspans, ranks, run
    for var, sub in run.CACHES.items():
        os.environ[var] = str(ROOT / "build" / "fitbench" / sub)
    w = manifest.cell(manifest.load(ROOT / "BENCHMARK.json"), args.workload)
    if args.rows_per_node:
        w["cfg"]["rows_per_node"] = args.rows_per_node
    call = (w, args.seed, args.seconds, args.windows, args.device)
    chips = int(w["chips"])
    per_rank = _rank(*call) if chips == 1 else ranks.run(chips, _rank, call)
    import torch
    name = torch.cuda.get_device_name() if args.device == "cuda" else "cpu"
    lines = []
    for i in range(args.windows):
        res = {"workload": args.workload, "window": i,
               "spans_on": i % 4 in (1, 2),
               **combine(w, [r[i] for r in per_rank], name)}
        if args.device == "cuda":
            res["card"] = card.name_and_limit()
        for r, tab in enumerate(res.get("spans", [])):
            print(f"spanrun: window {i}, rank {r}", file=sys.stderr)
            print("\n".join(progspans.table({"spans": tab})),
                  file=sys.stderr)
        lines.append(json.dumps(res))
        print(json.dumps({k: v for k, v in res.items() if k != "spans"}),
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
