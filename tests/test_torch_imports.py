"""The port's ground rules, checked: ``repro_torch`` and ``chip_smoke.py``
import neither ``jax`` nor anything of ``repro``; the entry points run on
the card by default and raise rather than fall back to the CPU; a CUDA
tensor goes to the kernel, never to the plain version; nothing on the
kernel path catches an error."""
import inspect
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core import prox as tprox
from repro_torch.core.unwrapped import UnwrappedADMM
from repro_torch.engine import IterationEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def test_port_imports_no_jax_and_no_repro():
    mods = _modules()
    assert "repro_torch.engine.engine" in mods and len(mods) >= 20
    for name in ("core.oracles", "core.fasta", "core.consensus", "core.fit",
                 "exec.problems", "service", "service.registry",
                 "data.store", "checkpoint.manager", "service.stats",
                 "engine.streaming", "exec.streaming", "cluster.compress",
                 "sharding.compat", "core.distributed", "exec.shard_map",
                 "obs", "obs.context", "obs.metrics", "obs.telemetry",
                 "obs.trace", "obs.flight", "obs.scrape", "obs.slo",
                 "launch.obs_report", "cluster.transport", "cluster.chaos",
                 "cluster.membership", "cluster.reduction", "cluster.worker",
                 "cluster.coordinator", "exec.cluster", "service.batching",
                 "service.server", "service.admission", "service.frontend",
                 "launch.serve_fit", "models.moe", "models.griffin",
                 "models.model", "models.decode", "launch.serve",
                 "configs.arctic_480b", "configs.command_r_35b",
                 "configs.olmoe_1b_7b", "configs.phi3_medium_14b",
                 "configs.qwen2_vl_72b", "configs.qwen3_14b",
                 "configs.recurrentgemma_9b",
                 "configs.seamless_m4t_large_v2",
                 "models.moe_a2a", "launch.dryrun", "launch.fit_cell",
                 "launch.input_specs", "launch.mesh", "sharding.specs",
                 "sharding.util", "roofline.hlo",
                 "launch.diagnose_collectives", "examples.quickstart",
                 "examples.distributed_fit", "examples.probe_server",
                 "examples.train_lm", "examples.linear_probe"):
        assert f"repro_torch.{name}" in mods, name
    code = (
        "import importlib, sys\n"
        f"for name in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'jaxlib'))\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cluster_worker_imports_no_jax_and_no_repro(tmp_path):
    """A cluster solve whose coordinator and spawned worker run with
    ``jax`` and ``repro`` poisoned on the path (importing either raises):
    the worker process loads neither, and the solve completes."""
    poison = tmp_path / "poison"
    for pkg in ("jax", "repro"):
        (poison / pkg).mkdir(parents=True)
        (poison / pkg / "__init__.py").write_text(
            f"raise ImportError('the port imported {pkg}')\n")
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from repro_torch.cluster.coordinator import ClusterConfig, "
        "cluster_solve\n"
        "if __name__ == '__main__':\n"
        "    rng = np.random.default_rng(0)\n"
        "    D = rng.standard_normal((200, 6)).astype(np.float32)\n"
        "    a = np.sign(rng.standard_normal(200)).astype(np.float32)\n"
        "    res = cluster_solve(D, a, {'name': 'logistic'}, tau=0.1,\n"
        "        max_iters=5, config=ClusterConfig(n_workers=1,\n"
        "        device='cpu', heartbeat_timeout_s=30,\n"
        "        register_timeout_s=120))\n"
        "    assert res.iters == 5 and res.telemetry['workers_alive'] == 1\n"
        "    bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "           ('jax', 'jaxlib', 'repro')]\n"
        "    print('BAD', bad)\n"
        "    sys.exit(1 if bad else 0)\n")
    env = _env()
    env["PYTHONPATH"] = os.pathsep.join([str(poison), env["PYTHONPATH"]])
    script = tmp_path / "solve.py"
    script.write_text(code)
    out = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_name_no_jax_or_repro():
    """A static look as well: no import line of the port or the smoke
    script names jax or the repro package."""
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                head = s.split()[1]
                assert head.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{f}: {s}"


def test_entry_points_default_to_cuda_and_raise_without_gpu(monkeypatch):
    assert UnwrappedADMM.__dataclass_fields__["device"].default == "cuda"
    assert IterationEngine.__dataclass_fields__["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UnwrappedADMM(tprox.make_logistic(), tau=0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IterationEngine(tprox.make_logistic())
    from repro_torch.launch import fit, serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit.main(["--nodes", "1", "--rows-per-node", "100",
                  "--features", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-8b", "--smoke", "--batch", "1",
                    "--prompt-len", "4", "--gen", "2"])
    # the LM's full-sequence path reaches the flash kernel unless asked not
    from repro_torch.models import decode, layers, model, rwkv6
    for fn in (model.forward, model.loss_fn, model._run_stack,
               model._apply_block, layers.attention):
        assert inspect.signature(fn).parameters["attn_impl"].default \
            == "cuda", fn
    # ... and the WKV kernel, in prefill too
    for fn in (model.forward, model.loss_fn, model._run_stack,
               model._apply_block, decode.prefill, decode._block_prefill,
               rwkv6.time_mix):
        assert inspect.signature(fn).parameters["wkv_impl"].default \
            == "cuda", fn
    # the CPU is used only when asked for
    assert UnwrappedADMM(tprox.make_logistic(), device="cpu").device == "cpu"


# The fit service answers a failing request or backend with a terminal
# status instead of dropping it (the reference's containment): the
# server's per-group isolation in ``flush`` and the front end's connection
# and cold-solve handling. An error there becomes an "error" (or
# "degraded") response, never a call of a plain version; chip_smoke.py's
# fit service phase requires every response "ok" and no errors.
CONTAINMENT = ("service/server.py", "service/frontend.py")


def _catches(text):
    return [s for s in (line.strip() for line in text.splitlines())
            if s.startswith(("try:", "except"))]


def test_kernel_path_catches_nothing():
    """No try/except on the path from the engine to the kernels: a build
    or launch error propagates, nothing falls back to the plain version.
    The service's containment files catch exactly what the reference's
    copies catch, and their handlers never name a plain version."""
    for sub in ("kernels", "engine", "exec", "core", "models", "service"):
        for f in (PKG / sub).rglob("*.py"):
            text = f.read_text()
            rel = f.relative_to(PKG).as_posix()
            assert "torch.compile" not in text, f
            if rel in CONTAINMENT:
                ref = (ROOT / "src" / "repro" / rel).read_text()
                assert _catches(text) == _catches(ref), f
                assert "_plain" not in text, f
            else:
                assert not _catches(text), (f, _catches(text))


def test_kernel_bodies_are_hand_written():
    """The CUDA sources call no library kernel (cuBLAS, cuDNN, CUTLASS's
    device-level GEMMs); each wrapper launches its own C entry point."""
    for f in (PKG / "kernels" / "csrc").iterdir():
        text = f.read_text().lower()
        for lib in ("cublas", "cudnn", "cutlass"):
            assert lib not in text, (f, lib)
    for op, entry in (("prox", "repro_prox_update"), ("gram", "repro_gram"),
                      ("admm_iter", "repro_admm_iter"),
                      ("flash_attn", "repro_flash_attn"),
                      ("wkv", "repro_wkv"),
                      ("spgram", "repro_spgram_iter")):
        assert f".{entry}(" in (PKG / "kernels" / op / "ops.py").read_text()


def test_smoke_script_refuses_without_checkout_or_gpu(tmp_path):
    """chip_smoke.py alone in a directory, or on a machine without a GPU,
    exits non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0 and '"ok"' not in out.stdout
        assert "torch.cuda.is_available() is False" in out.stdout


@pytest.mark.cuda
def test_cuda_wrappers_never_call_the_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from repro_torch.kernels.admm_iter import ops as iter_ops
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.prox import ops as prox_ops
    from repro_torch.kernels.spgram import ops as sp_ops
    from repro_torch.kernels.wkv import ops as wkv_ops

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, name in ((prox_ops, "prox_update_plain"),
                      (gram_ops, "gram_plain"),
                      (gram_ops, "gram_and_rhs_plain"),
                      (iter_ops, "admm_iter_plain"),
                      (attn_ops, "flash_attention_plain"),
                      (wkv_ops, "wkv_plain"),
                      (sp_ops, "sparse_admm_iter_plain")):
        monkeypatch.setattr(mod, name, boom)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    m, n = 1000, 37
    D = torch.randn((m, n), generator=g, device=dev)
    v = torch.randn((m,), generator=g, device=dev)
    x = torch.randn((n,), generator=g, device=dev)
    before = (prox_ops.prox_update.launches, gram_ops.gram.launches,
              gram_ops.gram_and_rhs.launches,
              iter_ops.admm_iter_full.launches)
    prox_ops.prox_update(v, v, torch.sign(v), kind="logistic", delta=1.0)
    gram_ops.gram(D)
    gram_ops.gram_and_rhs(D, v)
    iter_ops.admm_iter_full(D, torch.sign(v), v, v, x, kind="hinge",
                            delta=1.0)
    res = UnwrappedADMM(tprox.make_logistic(), tau=0.1).solve(
        D[None], torch.sign(v)[None], max_iters=5)
    torch.cuda.synchronize()
    after = (prox_ops.prox_update.launches, gram_ops.gram.launches,
             gram_ops.gram_and_rhs.launches,
             iter_ops.admm_iter_full.launches)
    assert [b - a for a, b in zip(before, after)] == [1, 2, 1, 1 + res.iters]
    from repro_torch.data.sparse import BlockCSR
    B = BlockCSR.from_dense(D * (D.abs() > 1.0))
    launched = sp_ops.sparse_admm_iter_full.launches
    res = UnwrappedADMM(tprox.make_logistic(), tau=0.1).solve(
        B, torch.sign(v), max_iters=5)
    torch.cuda.synchronize()
    assert sp_ops.sparse_admm_iter_full.launches == launched + res.iters
    q = torch.randn((1, 4, 100, 64), generator=g, device=dev)
    kv = torch.randn((1, 2, 100, 64), generator=g, device=dev)
    launched = attn_ops.flash_attention.launches
    attn_ops.flash_attention(q, kv, kv, causal=True)
    torch.cuda.synchronize()
    assert attn_ops.flash_attention.launches == launched + 1
    r = torch.randn((1, 2, 64, 64), generator=g, device=dev)
    launched = wkv_ops.wkv.launches
    wkv_ops.wkv(r, r, r, -torch.ones_like(r), r[0, :, 0], chunk=16)
    torch.cuda.synchronize()
    assert wkv_ops.wkv.launches == launched + 1


@pytest.mark.parametrize("fail_on", [None, "gram.cu", "-shared"])
def test_build_compiles_each_source_then_links(tmp_path, monkeypatch,
                                               fail_on):
    """``build.build`` runs one ``nvcc -c`` per source and one link, and
    raises on any compiler error, leaving no library behind (a stand-in
    nvcc that records its arguments takes the real one's place)."""
    from repro_torch.kernels import build
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$*\" >> {log}\n"
        + (f"case \"$*\" in *{fail_on}*) echo broken >&2; exit 2;; esac\n"
           if fail_on else "")
        + "out=\"\"; prev=\"\"\n"
        "for a in \"$@\"; do [ \"$prev\" = -o ] && out=\"$a\"; prev=\"$a\";"
        " done\n"
        "echo built > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(nvcc))
    out_dir = tmp_path / "out"
    if fail_on:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            build.build(out_dir)
        assert list(out_dir.iterdir()) == []
        return
    lib = build.build(out_dir)
    assert lib.name == f"librepro_torch_{build.source_hash()}.so"
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(compiles) == len(build.SOURCES) and len(calls) == \
        len(build.SOURCES) + 1 and "-shared" in calls[-1]
    assert list(out_dir.iterdir()) == [lib]
    assert build.build(out_dir) == lib and len(
        log.read_text().splitlines()) == len(calls)   # cached: no compiler
