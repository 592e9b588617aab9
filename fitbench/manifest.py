"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); a configuration names its data generator
(``data/<data>.py``), the system under test (``systems/<system>.py``), its
plain reference (``reference/<reference>.py``) and the stages of its
roofline (``work/<stage>.py``); a metric is read by ``metrics/<name>.py``.
Adding a cell, a configuration or a metric adds files and entries and edits
none: a new cell joins an end-to-end metric by appending its name to that
metric's ``workloads``, and its per-layer metrics name it in theirs. A
reader of a configuration's own layers finds each rank's table of the
program's spans at ``t["spans"]["spans"][<span>]`` and its counters at
``t["counters"][<name>]``, for ``t`` in ``ctx.trace`` (``harness``).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def module(kind: str, name: str):
    """The module ``fitbench/<kind>/<name>.py``, loaded from its file (a
    metric's name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"fitbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def data_file(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def cell(bench: dict, name: str) -> dict:
    """The workload entry called ``name``, with its configuration and
    traffic files read, and the metrics it reports: ``end_to_end`` (a
    ``--trace 0`` run) and ``per_layer`` (``--trace 1``)."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = dict(found[0])
    w["cfg"] = data_file("configs", w["config"])
    w["mix"] = data_file("traffic", w["traffic"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    # a per-layer metric without ``workloads`` is read in every cell that
    # reports the end-to-end metric it moves
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    w["end_to_end"], w["per_layer"] = e2e, layer
    return w
