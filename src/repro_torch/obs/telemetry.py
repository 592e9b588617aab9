"""Structured per-iteration telemetry: a JSONL sink (DESIGN.md §12).

One line per solver iteration — iter index, primal/dual residuals,
objective, tau/rho, block timings, bytes by message type — written by
the HOST loop of whichever topology is solving (streaming sweep loop,
cluster coordinator, post-scan history dump for the fully-jitted
drivers). JSONL because the stream is append-only (a killed run keeps
every completed line) and line-parseable without loading the file.

Values are sanitized to plain JSON: numpy scalars and 0-d tensors
unwrap, arrays and tensors become lists (a CUDA tensor is copied to the
host first, never rendered with ``str``), NaN/inf become null (bare NaN
is invalid JSON — the BENCH_*.json convention).

Copy of ``repro/obs/telemetry.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import json
import math
import sys
import threading
from typing import Any, List, Optional


def jsonable(v: Any):
    if v is None or isinstance(v, (str, bool, int)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, dict):
        return {str(k): jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    torch = sys.modules.get("torch")     # no tensor exists before import
    if torch is not None and isinstance(v, torch.Tensor):
        return jsonable(v.item() if v.dim() == 0 else v.cpu().tolist())
    # numpy scalars and arrays
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", None) == 0:
        return jsonable(item())
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return jsonable(tolist())
    return str(v)


class TelemetryWriter:
    """Append-only JSONL sink; ``write`` is thread-safe and flushes per
    line so a SIGKILL keeps every completed record."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f: Optional[Any] = open(path, "w")

    def write(self, record: dict):
        line = json.dumps(jsonable(record))
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_jsonl(path: str) -> List[dict]:
    """Read a JSONL file, truncating at the first undecodable line.

    A process killed mid-``write`` leaves at most one partial trailing
    line; stopping at the first bad line keeps every complete record and
    never raises for a torn tail (DESIGN.md §16 crash-safe artifacts).
    """
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                break
    return out
