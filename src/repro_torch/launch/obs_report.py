"""Summarize an observability run directory (DESIGN.md §12, §16).

``python -m repro_torch.launch.obs_report RUNDIR [--json]``
``python -m repro_torch.launch.obs_report INCIDENT.json``

Reads the artifacts an ``--obs-dir`` run writes — ``metrics.json``
(registry snapshot), ``telemetry.jsonl`` (one record per solver
iteration), ``trace.json`` (Chrome-trace spans) — and prints the
operator's questions back as tables: counter totals, latency
percentiles per histogram (p50/p90/p99, aggregated across label sets so
a cluster's per-worker block-step series also report cluster-wide),
bytes per iteration by message type, and span hotspots (where the wall
time went). ``--json`` emits the same summary as one JSON document.

Service mode (automatic): when the metrics snapshot carries ``service.*``
series — the run dir belongs to a :class:`FitFrontend` — the report adds
the serving view: terminal-status mix, warm/cold latency split,
degrade-why breakdown, and a per-tenant admission table.  Flight-
recorder incident dumps under ``RUNDIR/incidents/`` are summarized too,
and pointing the CLI at one incident file pretty-prints it.

Copy of ``repro/launch/obs_report.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.obs import (
    METRICS_FILE,
    TELEMETRY_FILE,
    TRACE_FILE,
    load_incident,
    load_trace,
    merged_histogram,
    read_jsonl,
    span_hotspots,
    summarize_histogram,
)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def _table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    def line(r):
        return "  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
    return "\n".join([line(header), line(["-" * w for w in widths])]
                     + [line(r) for r in rows])


# -- metrics.json -----------------------------------------------------------

def summarize_metrics(snap: dict) -> dict:
    counters = sorted(
        ({"name": e["name"], "labels": e.get("labels", {}),
          "value": e["value"]} for e in snap.get("counters", [])),
        key=lambda e: (e["name"], sorted(e["labels"].items())))
    hists: Dict[str, List[dict]] = {}
    for e in snap.get("histograms", []):
        hists.setdefault(e["name"], []).append(e)
    out_h = []
    for name in sorted(hists):
        entries = hists[name]
        # seconds-valued histograms report in ms
        scale = 1e3 if name.endswith("_s") else 1.0
        unit = "ms" if scale == 1e3 else ""
        for e in sorted(entries,
                        key=lambda e: sorted(e.get("labels", {}).items())):
            out_h.append({"name": name + _fmt_labels(e.get("labels", {})),
                          "unit": unit,
                          **summarize_histogram(e, scale=scale)})
        if len(entries) > 1:   # cluster-wide view across label sets
            agg = merged_histogram(entries).to_snapshot()
            out_h.append({"name": name + "{ALL}", "unit": unit,
                          **summarize_histogram(agg, scale=scale)})
    return {"counters": counters, "histograms": out_h,
            "gauges": snap.get("gauges", [])}


# -- service view (frontend run dirs) ---------------------------------------

def _labeled_sum(counters: List[dict], name: str,
                 label: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for e in counters:
        if e["name"] == name and label in e.get("labels", {}):
            key = e["labels"][label]
            out[key] = out.get(key, 0) + e["value"]
    return out


def summarize_service(snap: dict) -> Optional[dict]:
    """The serving view of a metrics snapshot; None when the snapshot
    has no ``service.*`` series (a solver run, not a frontend run)."""
    counters = snap.get("counters", [])
    if not any(e["name"].startswith("service.") for e in counters):
        return None

    def total(name: str) -> float:
        return sum(e["value"] for e in counters if e["name"] == name)

    seen = _labeled_sum(counters, "service.fit_seen", "tenant")
    admitted = _labeled_sum(counters, "admission.admitted", "tenant")
    rej_tenant = _labeled_sum(counters, "admission.rejected", "tenant")
    tenants = sorted(set(seen) | set(admitted) | set(rej_tenant))
    per_tenant = [{"tenant": t,
                   "fit_seen": int(seen.get(t, 0)),
                   "admitted": int(admitted.get(t, 0)),
                   "rejected": int(rej_tenant.get(t, 0))}
                  for t in tenants]

    latency = {}
    for e in snap.get("histograms", []):
        if e["name"] == "server.fit_latency_s":
            kind = e.get("labels", {}).get("kind", "?")
            latency[kind] = summarize_histogram(e, scale=1e3)
        elif e["name"] in ("service.queue_wait_s",
                           "service.dispatch_wait_s"):
            latency[e["name"].split(".", 1)[1]] = summarize_histogram(
                e, scale=1e3)

    return {
        "status_mix": {k: int(v) for k, v in sorted(_labeled_sum(
            counters, "service.responses", "status").items())},
        "degrade_why": {k: int(v) for k, v in sorted(_labeled_sum(
            counters, "service.degraded", "why").items())},
        "reject_reason": {k: int(v) for k, v in sorted(_labeled_sum(
            counters, "admission.rejected", "reason").items())},
        "per_tenant": per_tenant,
        "latency_ms": latency,
        "breaker_trips": int(total("service.breaker_trips")),
        "severed": int(total("service.severed")),
        "undeliverable": int(total("service.undeliverable")),
    }


# -- flight-recorder incidents ----------------------------------------------

def summarize_incident(path: str) -> dict:
    """One incident dump -> a summary dict (used for both the per-file
    CLI mode and the run-dir listing)."""
    doc = load_incident(path)
    events = doc.get("events", [])
    by_kind: Dict[str, int] = {}
    for e in events:
        k = str(e.get("kind", "?"))
        by_kind[k] = by_kind.get(k, 0) + 1
    statuses = [e for e in events if e.get("kind") == "respond"]
    return {
        "path": path,
        "reason": doc.get("reason"),
        "t_wall": doc.get("t_wall"),
        "window_s": doc.get("window_s"),
        "process": doc.get("process"),
        "trigger": doc.get("trigger"),
        "events": len(events),
        "events_by_kind": dict(sorted(by_kind.items())),
        "last_status_transitions": [
            {k: e.get(k) for k in ("status", "tenant", "rid",
                                   "latency_s", "trace_id")
             if e.get(k) is not None}
            for e in statuses[-8:]],
    }


def print_incident(summary: dict):
    print(f"== flight-recorder incident: {summary['path']} ==")
    print(f"reason: {summary['reason']}   window: {summary['window_s']}s"
          f"   events: {summary['events']}")
    proc = summary.get("process") or {}
    if proc:
        print(f"process: {proc.get('name')} (pid {proc.get('pid')})")
    trig = summary.get("trigger") or {}
    if trig:
        print("trigger: " + "  ".join(f"{k}={v}" for k, v in trig.items()))
    if summary["events_by_kind"]:
        print("\nevents by kind:")
        print(_table([[k, str(v)] for k, v in
                      summary["events_by_kind"].items()],
                     ["kind", "count"]))
    last = summary.get("last_status_transitions") or []
    if last:
        print("\nlast status transitions:")
        print(_table(
            [[str(e.get("status", "-")), str(e.get("tenant", "-")),
              str(e.get("rid", "-")), _fmt(e.get("latency_s")),
              str(e.get("trace_id", "-"))] for e in last],
            ["status", "tenant", "rid", "latency_s", "trace_id"]))


# -- telemetry.jsonl --------------------------------------------------------

def summarize_telemetry(records: List[dict]) -> Optional[dict]:
    iters = [r for r in records if "iter" in r]
    if not iters:
        return None
    last = iters[-1]
    by_type: Dict[str, int] = {}
    for r in iters:
        for key in ("tx_bytes", "rx_bytes"):
            for t, v in (r.get(key) or {}).items():
                by_type[f"{key}.{t}"] = by_type.get(f"{key}.{t}", 0) + v
    n = len(iters)
    out = {
        "iterations": n,
        "final": {k: last.get(k) for k in
                  ("iter", "objective", "primal_res", "dual_res")},
        "bytes_per_iter_by_type": {t: round(v / n, 1)
                                   for t, v in sorted(by_type.items())},
    }
    iter_s = [r["iter_s"] for r in iters if r.get("iter_s") is not None]
    if iter_s:
        out["mean_iter_s"] = round(sum(iter_s) / len(iter_s), 6)
    return out


# -- report -----------------------------------------------------------------

def build_report(rundir: str) -> dict:
    report: dict = {"rundir": rundir}
    mpath = os.path.join(rundir, METRICS_FILE)
    if os.path.exists(mpath):
        with open(mpath) as f:
            snap = json.load(f)
        report["metrics"] = summarize_metrics(snap)
        service = summarize_service(snap)
        if service is not None:
            report["service"] = service
    tpath = os.path.join(rundir, TELEMETRY_FILE)
    if os.path.exists(tpath):
        report["telemetry"] = summarize_telemetry(read_jsonl(tpath))
    trpath = os.path.join(rundir, TRACE_FILE)
    if os.path.exists(trpath):
        report["hotspots"] = span_hotspots(load_trace(trpath))
    incidents = sorted(glob.glob(os.path.join(rundir, "incidents",
                                              "incident-*.json")))
    if incidents:
        report["incidents"] = [summarize_incident(p) for p in incidents]
    return report


def print_report(report: dict, top: int = 15):
    print(f"== obs report: {report['rundir']} ==")
    svc = report.get("service")
    if svc:
        print("\nservice status mix:")
        print(_table([[s, str(v)] for s, v in svc["status_mix"].items()],
                     ["status", "count"]))
        if svc["degrade_why"]:
            print("\ndegraded responses by cause:")
            print(_table([[w, str(v)] for w, v in
                          svc["degrade_why"].items()], ["why", "count"]))
        if svc["reject_reason"]:
            print("\nrejections by reason:")
            print(_table([[w, str(v)] for w, v in
                          svc["reject_reason"].items()],
                         ["reason", "count"]))
        if svc["per_tenant"]:
            print("\nper-tenant admission:")
            print(_table(
                [[t["tenant"], str(t["fit_seen"]), str(t["admitted"]),
                  str(t["rejected"])] for t in svc["per_tenant"]],
                ["tenant", "fit_seen", "admitted", "rejected"]))
        if svc["latency_ms"]:
            print("\nservice latency (ms):")
            print(_table(
                [[k, _fmt(h["count"]), _fmt(h["mean"]), _fmt(h["p50"]),
                  _fmt(h["p90"]), _fmt(h["p99"]), _fmt(h["max"])]
                 for k, h in sorted(svc["latency_ms"].items())],
                ["series", "count", "mean", "p50", "p90", "p99", "max"]))
        print(f"\nbreaker trips: {svc['breaker_trips']}   "
              f"severed conns: {svc['severed']}   "
              f"undeliverable: {svc['undeliverable']}")
    incidents = report.get("incidents")
    if incidents:
        print(f"\nflight-recorder incidents ({len(incidents)}):")
        print(_table(
            [[os.path.basename(i["path"]), str(i["reason"]),
              str(i["events"])] for i in incidents],
            ["file", "reason", "events"]))
    tel = report.get("telemetry")
    if tel:
        fin = tel["final"]
        print(f"\niterations: {tel['iterations']}"
              + (f"  (mean {tel['mean_iter_s']*1e3:.2f} ms/iter)"
                 if tel.get("mean_iter_s") is not None else ""))
        print("final: " + "  ".join(
            f"{k}={_fmt(fin[k])}" for k in fin if fin[k] is not None))
        if tel["bytes_per_iter_by_type"]:
            print("\nbytes/iter by message type:")
            print(_table([[t, f"{v:.1f}"] for t, v in
                          tel["bytes_per_iter_by_type"].items()],
                         ["message", "bytes/iter"]))
    met = report.get("metrics")
    if met:
        if met["counters"]:
            print("\ncounters:")
            print(_table(
                [[e["name"] + _fmt_labels(e["labels"]), _fmt(e["value"])]
                 for e in met["counters"]], ["counter", "value"]))
        if met["histograms"]:
            print("\nlatency histograms:")
            print(_table(
                [[h["name"], h["unit"], _fmt(h["count"]), _fmt(h["mean"]),
                  _fmt(h["p50"]), _fmt(h["p90"]), _fmt(h["p99"]),
                  _fmt(h["max"])] for h in met["histograms"]],
                ["histogram", "unit", "count", "mean", "p50", "p90",
                 "p99", "max"]))
    hot = report.get("hotspots")
    if hot:
        print(f"\nspan hotspots (top {top}):")
        print(_table(
            [[h["name"], _fmt(h["count"]), _fmt(h["total_ms"]),
              _fmt(h["mean_ms"])] for h in hot[:top]],
            ["span", "count", "total_ms", "mean_ms"]))
    if not (tel or met or hot or report.get("service")
            or report.get("incidents")):
        print("(no observability artifacts found — was the run launched "
              "with --obs-dir?)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="summarize an --obs-dir run directory (or pretty-"
                    "print one flight-recorder incident file)")
    ap.add_argument("rundir", help="run directory holding trace.json / "
                                   "metrics.json / telemetry.jsonl, or a "
                                   "flight-recorder incident-*.json file")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as one JSON document")
    ap.add_argument("--top", type=int, default=15,
                    help="span-hotspot rows to print")
    args = ap.parse_args(argv)
    if os.path.isfile(args.rundir):
        summary = summarize_incident(args.rundir)
        if args.json:
            print(json.dumps(summary, indent=2))
        else:
            print_incident(summary)
        return summary
    report = build_report(args.rundir)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print_report(report, top=args.top)
    return report


if __name__ == "__main__":
    main()
