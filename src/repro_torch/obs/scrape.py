"""Live scrape endpoint: /metrics, /healthz, /slo over stdlib http.server.

The run directory's artifacts are written when a run *finishes*; a serving
frontend runs forever, so this module exposes the same
:class:`~repro_torch.obs.metrics.MetricsRegistry` snapshot while the process
is alive.  :class:`ScrapeServer` owns a ``ThreadingHTTPServer`` on a
daemon thread and renders whatever snapshot the supplied callable
returns at request time — it works over any registry, including
cluster-merged ones, and adds no dependencies.

Routes:
  * ``/metrics``       Prometheus text exposition (version 0.0.4)
  * ``/metrics.json``  the raw snapshot dict (exact histograms included)
  * ``/healthz``       liveness JSON from ``health_fn``
  * ``/slo``           SLO evaluation JSON from ``slo_fn``

Rendering notes: counter/gauge names are sanitized to the Prometheus
grammar (dots become underscores); histograms are rendered as summaries
(quantile series + ``_sum``/``_count``) because the registry's
log-spaced buckets already bound quantile error and a summary keeps the
exposition small.  The JSON route carries the lossless form.

Copy of ``repro/obs/scrape.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import json
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.obs.metrics import Histogram

__all__ = ["ScrapeServer", "render_prometheus"]

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILES = (0.5, 0.9, 0.99)


def _metric_name(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace('"', r"\"")
        v = v.replace("\n", r"\n")
        parts.append(f'{_metric_name(str(k))}="{v}"')
    return "{" + ",".join(parts) + "}"


def _num(v: Any) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: dict) -> str:
    """Render a MetricsRegistry snapshot as Prometheus text exposition."""
    lines = []
    typed = set()

    def _type_line(name: str, kind: str):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    # exposition format requires all samples of one metric contiguous
    def _by_name(entries):
        return sorted(entries, key=lambda e: e["name"])

    for e in _by_name(snapshot.get("counters", [])):
        name = _metric_name(e["name"]) + "_total"
        _type_line(name, "counter")
        lines.append(f"{name}{_label_str(e.get('labels', {}))} "
                     f"{_num(e.get('value', 0))}")
    for e in _by_name(snapshot.get("gauges", [])):
        name = _metric_name(e["name"])
        _type_line(name, "gauge")
        lines.append(f"{name}{_label_str(e.get('labels', {}))} "
                     f"{_num(e.get('value', 0))}")
    for e in _by_name(snapshot.get("histograms", [])):
        name = _metric_name(e["name"])
        _type_line(name, "summary")
        labels = e.get("labels", {})
        h = Histogram.from_snapshot(e)
        for q in _QUANTILES:
            ql = dict(labels)
            ql["quantile"] = str(q)
            v = h.quantile(q)
            lines.append(f"{name}{_label_str(ql)} "
                         f"{_num(v if v is not None else float('nan'))}")
        lines.append(f"{name}_sum{_label_str(labels)} {_num(h.sum)}")
        lines.append(f"{name}_count{_label_str(labels)} {_num(h.count)}")
    return "\n".join(lines) + "\n"


class ScrapeServer:
    """Introspection HTTP listener on a daemon thread.

    ``snapshot_fn`` is called per scrape and must return a registry
    snapshot dict; ``health_fn``/``slo_fn`` return JSON-able dicts.
    Callbacks run on the HTTP thread — they must be cheap and
    thread-safe (registry snapshots are).  A callback that raises turns
    into a 500 with the error text rather than killing the thread.
    """

    def __init__(self, snapshot_fn: Callable[[], dict],
                 health_fn: Optional[Callable[[], dict]] = None,
                 slo_fn: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self._snapshot_fn = snapshot_fn
        self._health_fn = health_fn or (lambda: {"status": "ok"})
        self._slo_fn = slo_fn or (lambda: {})
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # keep scrapes out of stderr
                pass

            def do_GET(self):
                try:
                    body, ctype = outer._route(self.path)
                except Exception as e:  # noqa: BLE001 — report, don't die
                    payload = json.dumps({"error": str(e)}).encode()
                    self._reply(500, payload, "application/json")
                    return
                if body is None:
                    self._reply(404, b'{"error": "not found"}',
                                "application/json")
                    return
                self._reply(200, body, ctype)

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="obs-scrape", daemon=True)
        self._thread.start()

    def _route(self, path: str) -> Tuple[Optional[bytes], str]:
        path = path.split("?", 1)[0]
        if path == "/metrics":
            return (render_prometheus(self._snapshot_fn()).encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
        if path == "/metrics.json":
            return (json.dumps(self._snapshot_fn()).encode(),
                    "application/json")
        if path == "/healthz":
            return json.dumps(self._health_fn()).encode(), "application/json"
        if path == "/slo":
            return json.dumps(self._slo_fn()).encode(), "application/json"
        return None, ""

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    def url(self, path: str = "/metrics") -> str:
        host, port = self.address
        return f"http://{host}:{port}{path}"

    def close(self):
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()
