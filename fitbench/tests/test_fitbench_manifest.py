"""``BENCHMARK.json`` against the benchmark's contract: names, units and
lengths, the files each entry names, and that every per-layer metric moves
an end-to-end metric all its cells report."""
import json
import re

import pytest

from fitbench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (manifest.ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word
        assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        text = entry.get(key, "x")
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("fitbench/configs/")
    body = json.loads((manifest.ROOT / cfg["file"]).read_text())
    assert len(cfg["reduced"]) <= 16
    assert all(NAME.match(k) and k in body for k in cfg["reduced"])
    assert body["reduced"] == cfg["reduced"]
    # each configuration's modules are there, found by name
    for kind in ("data", "systems", "reference"):
        key = {"systems": "system"}.get(kind, kind)
        assert (manifest.HERE / kind / f"{body[key]}.py").is_file()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cells(cell):
    w = manifest.cell(BENCH, cell)
    assert set(k for k in w if k not in ("cfg", "mix", "end_to_end",
                                         "per_layer")) \
        == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4)
    names = [m["name"] for m in w["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert w["per_layer"]
    for m in w["end_to_end"] + w["per_layer"]:
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_pairs_once_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_what_its_cells_report(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    for cell in metric["workloads"]:
        assert cell in CELLS
        reported = [m["name"] for m in manifest.cell(BENCH, cell)
                    ["end_to_end"]]
        assert metric["moves"] in reported


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    if metric["name"] == "setup_s":
        assert metric["bound"] == 0.25


def test_run_seconds_fit_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        base = m["name"].split(".")[0]
        if base.endswith("_roofline") or "mfu" in base.split("_"):
            assert m["unit"] == "%" and m["better"] == "higher"
