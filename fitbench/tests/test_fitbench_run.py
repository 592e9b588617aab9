"""``run.py`` refuses to run without the card the cell asks for, in a
directory that holds only the benchmark, and where any rank of the run
loaded a module of JAX or the JAX package, printing no result."""
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from fitbench import manifest


def _run(cwd, cell="star-logistic"):
    return subprocess.run(
        [sys.executable, "fitbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_fails_without_a_card(cell):
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has the cards")
    out = _run(manifest.ROOT, cell)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "fitbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _rank_with_jax_on_rank_1(w, seed, seconds, trace, device, t0, rank):
    from fitbench import harness
    if rank == 1:
        sys.modules["jax"] = types.ModuleType("jax")
    torch.set_num_threads(1)
    return harness._rank(w, seed, seconds, trace, device, t0, rank=rank)


def test_a_jax_module_on_one_rank_is_found():
    """Rank 1 alone loads a module named ``jax``: the run names it. Rank 0
    runs in a new process too, so what this test's own process has loaded
    (another test file's JAX) is not seen."""
    code = (
        "import json\n"
        "from fitbench import manifest, ranks, run\n"
        "from fitbench.tests.test_fitbench_run import "
        "_rank_with_jax_on_rank_1\n"
        "w = manifest.cell(manifest.load(), 'star-logistic-x4')\n"
        "w['cfg'].update({'rows_per_node': 2000, 'max_iters': 20})\n"
        "out = ranks.run(4, _rank_with_jax_on_rank_1, "
        "(w, 2 ** 31 + 17, 0.001, False, 'cpu', 0.0))\n"
        "print(json.dumps({'correct': out['correct'], "
        "'forbidden': out['forbidden'], "
        "'found': run.forbidden_found(out)}))\n")
    root = manifest.ROOT
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "src")]))
    got = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["forbidden"] == {"1": ["jax"]}
    assert out["found"] == {"1": ["jax"]}


def test_a_found_module_refuses_the_result(monkeypatch, capsys):
    """``run.py`` exits 3 and prints no result when a rank held one."""
    from fitbench import harness, run
    for var in run.CACHES:
        monkeypatch.setenv(var, "")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {
        "correct": True, "forbidden": {"2": ["repro.core"]}})
    code = run.main(["--workload", "star-logistic-x4", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    got = capsys.readouterr()
    assert code == 3 and got.out == ""
    assert "repro.core" in got.err
