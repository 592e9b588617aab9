"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the plain references import nothing of the program."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from fitbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(manifest.HERE.rglob("*.py"))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(manifest.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((manifest.HERE / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "numpy",
                                       "torch"}
    text = path.read_text()
    assert "repro_torch" not in text.replace("``repro_torch", "")


def test_a_run_loads_no_jax_module():
    """A whole run at a tiny size on the CPU, then ``sys.modules``."""
    code = (
        "import json, sys\n"
        "from fitbench import harness\n"
        "out = harness.run_cell('star-logistic', 5, 0.001, False, "
        "device='cpu', cfg_override={'rows_per_node': 1000, "
        "'base_features': 3, 'max_iters': 20})\n"
        "mods = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'correct': out['correct'], 'mods': mods}))\n")
    root = manifest.ROOT
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "src")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert "repro_torch" in res["mods"]
    assert not set(res["mods"]) & FORBIDDEN
