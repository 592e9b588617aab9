"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference that decides ``correct``.

Set-up makes the data from the seed on the device, prepares the system
under test and sends the mix's warm requests, which build and load every
kernel the window uses. The window is the load generator's (``loadgen``)
run of the traffic mix; with ``trace`` the profiler records it. Once it has
closed the peak memory is read, the program's state is freed, and the
reference works the answer out again from the same inputs; every answer is
judged against it. Every rank then lists the modules of JAX or the JAX
package it holds, so that the run can be refused when any rank loaded one.

What a per-layer reader (``metrics/<name>.py::read(ctx)``) finds in a
traced run: ``ctx.trace`` holds one summary a rank, in rank order, and
``None`` in an untraced run. Each is ``devtrace.summarize``'s dict (busy
and window seconds, each fit's span, device seconds and launches by
kernel, idle seconds by host op) with two keys more, from the program
itself, which records them only in a traced window (after the warm
requests; an untraced window sees ``repro_torch.obs.NOOP``):

- ``t["spans"]``: ``progspans.summarize`` of the program's spans on the
  thread that ran the fits; the table of one span is
  ``t["spans"]["spans"][<span>]``, with ``count``, ``host_s``,
  ``device_s`` and ``idle_s``. ``None`` where several clients ran fits on
  threads of their own: a span reader then returns ``None``.
- ``t["counters"]``: ``{<name>: value}``, each of the program's counters
  (``Observability.inc``) summed over its labels, over the window.
"""
from __future__ import annotations

import gc
import math
import statistics
import sys
import threading
import time
from types import SimpleNamespace

import torch
from repro_torch import obs

from fitbench import card, devtrace, loadgen, manifest, progspans, roofline

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """This process's modules whose top-level name, compared whole, is
    JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", bench: dict | None = None,
             t0: float | None = None, cfg_override: dict | None = None
             ) -> dict:
    """The result of one run of cell ``name`` (the dict the result line
    prints, with ``forbidden``: the modules each rank loaded that a run
    may not hold). ``t0`` is the process's start on the host clock."""
    bench = bench if bench is not None else manifest.load()
    w = manifest.cell(bench, name)
    w["cfg"].update(cfg_override or {})
    t0 = time.perf_counter() if t0 is None else t0
    args = (w, int(seed), float(seconds), bool(trace), str(device), t0)
    if int(w["chips"]) == 1:
        return _rank(*args, rank=None)
    from fitbench import ranks
    return ranks.run(int(w["chips"]), _rank, args)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _on_cpu(answer: dict) -> dict:
    return {k: v.detach().cpu() if torch.is_tensor(v) else v
            for k, v in answer.items()}


def _measure(w, seed, seconds, trace, dev, t0, group):
    """This rank's set-up and window: (payload, inputs)."""
    cfg, mix = w["cfg"], w["mix"]
    t_data = time.perf_counter()
    data = manifest.module("data", cfg["data"])
    inputs = data.make(cfg, seed, dev)
    _sync(dev)
    t_warm = time.perf_counter()
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
    loadgen.warm(mix, fit, seed, lambda: _sync(dev))
    setup_s = time.perf_counter() - t0
    first = group is None or group.rank == 0
    if first:
        print(f"fitbench: set-up {setup_s:.2f} s = {t_data - t0:.2f} to "
              f"the data, data {t_warm - t_data:.2f}, warm requests "
              f"{t0 + setup_s - t_warm:.2f}", file=sys.stderr)
    watch = first and dev.type == "cuda"
    cards = [card.state()] if watch else []
    # the program's spans and counters, in a traced window only
    ob = obs.Observability(enabled=True) if trace else obs.NOOP
    with devtrace.profiled(trace, dev.type) as prof, obs.recording(ob):
        records, window = loadgen.drive(mix, fit, seconds, seed=seed,
                                        sync=lambda: _sync(dev),
                                        gate=gate, trace=trace)
        _sync(dev)
    if watch:
        cards.append(card.state())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    payload = {"setup_s": setup_s, "window_s": window,
               "latency_s": [s for s, _, _ in records],
               "answers": [{**_on_cpu(a), "request": r}
                           for _, a, r in records],
               "size": data.size(cfg), "peak": peak, "cards": cards,
               "trace": None}
    del fit, records
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if prof is not None:
        t = time.perf_counter()
        summary = devtrace.summarize(prof)
        # the loop's spans lie on the one thread that ran the fits
        tid = threading.get_ident() \
            if int(mix.get("clients", 1)) == 1 else None
        summary["spans"] = None if tid is None else progspans.summarize(
            prof, ob.tracer.events(), tid)
        summary["counters"] = _counter_totals(ob.registry)
        payload["trace"] = summary
        if first:
            print(f"fitbench: trace of the window read in "
                  f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
            sp = summary["spans"]
            if sp is not None:
                print("\n".join(progspans.table(sp)), file=sys.stderr)
                print(f"fitbench: the fits' idle {sp['fits_idle_s']:.6f} s "
                      f"split by span (device clock aligned), "
                      f"{sum(s - b for s, b in summary['fits']):.6f} s by "
                      f"the trace; shift ns {sp['shift_ns']}, bracket ns "
                      f"{sp['bracket_ns']}, drifted {sp['drifted']}, early "
                      f"{sp['early']}", file=sys.stderr)
    return payload, inputs


def _counter_totals(registry) -> dict:
    """{name: value summed over its labels} of a registry's counters."""
    out = {}
    for c in registry.snapshot()["counters"]:
        out[c["name"]] = out.get(c["name"], 0) + c["value"]
    return out


def _rank(w, seed, seconds, trace, device, t0, rank=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    ref_mod = manifest.module("reference", w["cfg"]["reference"])
    if rank is None:
        payload, inputs = _measure(w, seed, seconds, trace, dev, t0, None)
        t_ref = time.perf_counter()
        ref = ref_mod.solve(w["cfg"], inputs, dev)
        payload["forbidden"] = loaded_forbidden()
        payloads = [payload]
    else:
        import torch.distributed as dist

        from repro_torch.sharding import compat
        with compat.make_group(device=device) as group, \
                compat.use_group(group):
            if dev.type == "cuda":
                dev = torch.device("cuda", torch.cuda.current_device())
            payload, inputs = _measure(w, seed, seconds, trace, dev, t0,
                                       group)
            # the reference takes each rank's share of the rows
            t_ref = time.perf_counter()
            ref = ref_mod.solve(w["cfg"], inputs, dev)
            payload["forbidden"] = loaded_forbidden()
            payloads = [None] * group.world if group.rank == 0 else None
            dist.gather_object(payload, payloads, dst=0)
        if rank != 0:
            return None
    return _finish(w, payloads, ref_mod, ref, time.perf_counter() - t_ref,
                   dev, trace)


def judge_ranks(cfg: dict, ref_mod, ref: dict, answers: list) -> list:
    """Each request's numbers, its worst over the ranks: the reference
    module's judge of every rank's answer, and over several ranks
    ``rank_gap``, the largest distance of a rank's answer tensors from the
    first rank's, relative to the first rank's largest entry.
    ``answers[r][i]`` is rank r's answer to request i."""
    per = [ref_mod.judge(cfg, ref, a) for a in answers]
    numbers = [{k: max((p[i][k] for p in per), key=lambda v: (v != v, v))
                for k in per[0][i]} for i in range(len(answers[0]))]
    if len(answers) > 1:
        for i, num in enumerate(numbers):
            gap = 0.0
            for k, a0 in answers[0][i].items():
                if not torch.is_tensor(a0):
                    continue
                a0 = a0.double()
                scale = max(float(a0.abs().max()), 1e-30)
                for a in answers[1:]:
                    d = float((a[i][k].double() - a0).abs().max()) / scale
                    gap = max(gap, d, key=lambda v: (v != v, v))
            num["rank_gap"] = gap
    return numbers


def _finish(w, payloads, ref_mod, ref, ref_s, dev, trace) -> dict:
    cfg = w["cfg"]
    p0 = payloads[0]
    nfits = len(p0["answers"])
    fit_numbers = judge_ranks(cfg, ref_mod, ref,
                              [p["answers"] for p in payloads]) \
        if nfits else []
    limits = cfg["limits"]
    numbers = {k: _aggregate(k, fit_numbers) for k in limits} \
        if fit_numbers else {}

    def within(v, lim):
        return v <= lim          # False for NaN

    failed = sum(1 for f in fit_numbers
                 if not all(within(f[_base(k)], limits[k]) for k in limits))
    correct = nfits > 0 and failed == 0 and all(
        within(numbers[k], limits[k]) for k in limits)
    m_rows, n = p0["size"]
    iters = [a.get("iters") for a in p0["answers"]]
    ctx = SimpleNamespace(
        cfg=cfg, chips=len(payloads), setup_s=p0["setup_s"],
        window_s=p0["window_s"], fit_s=p0["latency_s"],
        requests=[a["request"] for a in p0["answers"]],
        iters=iters if None not in iters else [],
        m=m_rows, m_rank=-(-m_rows // len(payloads)), n=n,
        peaks=roofline.peaks(_device_name(dev)),
        trace=[p["trace"] for p in payloads] if trace else None)
    metrics = {}
    for m in (w["per_layer"] if trace else w["end_to_end"]):
        v = manifest.module("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": _device_name(dev), "count": len(payloads),
              "memory_peak_bytes": max(p["peak"] for p in payloads)}
    out = {"correct": bool(correct), "attempted": nfits, "failed": failed,
           "metrics": metrics, "device": device}
    if trace:
        sums = ctx.trace
        device["busy_s"] = sum(s["busy_s"] for s in sums) / len(sums)
        device["window_s"] = sum(s["window_s"] for s in sums) / len(sums)
        out["breakdown"] = devtrace.breakdown(sums)
    out["cards"] = dict(zip(("window_start", "window_end"), p0["cards"]))
    out["reference"] = {
        "seconds": ref_s,
        "numbers": {f"{k}{agg}": _aggregate(f"{k}{agg}", fit_numbers)
                    for k in (fit_numbers[0] if fit_numbers else {})
                    for agg in ("", "_median")},
        **{k: v for k, v in ref.items() if not torch.is_tensor(v)}}
    out["forbidden"] = {str(r): p["forbidden"]
                        for r, p in enumerate(payloads) if p["forbidden"]}
    out["checks"] = {k: {"value": numbers.get(k), "limit": limits[k]}
                     for k in limits}
    return out


def _base(key: str) -> str:
    return key[:-len("_median")] if key.endswith("_median") else key


def _aggregate(key: str, fit_numbers) -> float:
    """A limit's number over the window's answers: the median of the
    answers' ``<name>`` for ``<name>_median``, else the worst answer's."""
    vals = [f[_base(key)] for f in fit_numbers]
    if key.endswith("_median"):
        return math.nan if any(v != v for v in vals) \
            else float(statistics.median(vals))
    return max(vals, key=lambda v: (v != v, v))    # NaN is the worst


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
