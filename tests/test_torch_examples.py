"""The port's examples (``repro_torch.examples``, the counterparts of
``examples/*.py``) and ``launch.diagnose_collectives`` (of
``scripts/diagnose_collectives.py``), each run as a user would at
``--smoke --device cpu`` in a subprocess; its last line is its JSON
result, checked here."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SCRIPTS = {
    "examples.quickstart": lambda r: r["lasso_support"] > 0
    and r["lasso_kkt"] < 1e-2 and r["iters_to_optimum"]["transpose"],
    "examples.distributed_fit": lambda r: r["ranks"] == 2
    and r["backend"] == "gloo"
    and abs(r["objective"] - r["optimum"]) <= 1e-3 * abs(r["optimum"]),
    "examples.probe_server": lambda r: r["gram_passes"] == 1
    and r["min_cosine"] > 0.9,
    "examples.train_lm": lambda r: r["steps"] == 8
    and r["final_loss"] < r["first_loss"],
    "examples.linear_probe": lambda r: r["train_acc"] > 0.9,
    "launch.diagnose_collectives": lambda r: r["recorded_ops"] == 5
    and r["modeled_ops"] > 0 and r["recorded_wire_bytes"] > 0,
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_runs_at_smoke_size_on_the_cpu(name, tmp_path):
    extra = ["--arch", "olmoe-1b-7b"] if "diagnose" in name else []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path))
    p = subprocess.run(
        [sys.executable, "-m", f"repro_torch.{name}", "--smoke", "--device",
         "cpu", *extra], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=240)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert SCRIPTS[name](result), result
