"""Port parity: the training fault-tolerance loop (``launch/train.py``,
``data/pipeline.py``, checkpoints of ``(params, opt_state)``); mirrors of
the four tests of ``tests/test_fault_tolerance.py``.

Kill training mid-run, restart from the checkpoint, and reach the same
result as an uninterrupted run (``python -m repro_torch.launch.train
--device cpu``, the reference's recipe); the deterministic data pipeline,
its elastic repartition and its prefetch iterator. Beyond the mirrors:
``batch_at`` bit for bit against the reference's pipeline for the none,
vision and audio frontends (the bf16 frames as float32 holding the bf16
values, placed as bf16 exactly), and a checkpoint of the
``(params, opt_state)`` tuple restored bit for bit with its list of
segments, for AdamW's and Adafactor's state.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro.data.pipeline import TokenPipeline as JPipeline
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline, place
from repro_torch.launch import train as train_lib
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import make_optimizer

torch.set_num_threads(1)

ROOT = str(Path(__file__).parent.parent)


def _run_train(args, check=True):
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--device", "cpu"] + args
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       env={"PYTHONPATH": "src",
                            "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                            "HOME": os.environ.get("HOME", "/tmp"),
                            "TMPDIR": os.environ.get("TMPDIR", "/tmp"),
                            "OMP_NUM_THREADS": "1"},
                       timeout=300)
    if check:
        assert p.returncode == 0, p.stderr[-2000:]
    return p


def _final_loss(stdout):
    m = re.search(r"\[done\] final loss ([0-9.]+)", stdout)
    assert m, stdout[-2000:]
    return float(m.group(1))


def test_kill_and_restart_reproduces_run(tmp_path):
    common = ["--arch", "qwen3-8b", "--smoke", "--steps", "24",
              "--batch", "2", "--seq", "32", "--ckpt-every", "8",
              "--lr", "1e-3"]
    # uninterrupted reference
    ref = _run_train(common + ["--ckpt-dir", str(tmp_path / "ref")])
    ref_loss = _final_loss(ref.stdout)
    # killed at step 12 (after the step-8 checkpoint), then resumed
    crash = _run_train(common + ["--ckpt-dir", str(tmp_path / "ft"),
                                 "--die-at-step", "12"], check=False)
    assert crash.returncode != 0  # SIGKILL
    assert "[failure-injection] SIGKILL at step 12" in crash.stdout
    resumed = _run_train(common + ["--ckpt-dir", str(tmp_path / "ft")])
    assert "[resume] restored step" in resumed.stdout
    res_loss = _final_loss(resumed.stdout)
    # bitwise-identical batches + state restore => same trajectory
    np.testing.assert_allclose(res_loss, ref_loss, rtol=1e-5)


def test_pipeline_determinism_and_restart():
    pipe = TokenPipeline(vocab_size=100, global_batch=8, seq_len=16, seed=3)
    a = pipe.batch_at(5)
    b = pipe.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = pipe.batch_at(6)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # a "restarted" pipeline object reproduces the same stream
    pipe2 = TokenPipeline(vocab_size=100, global_batch=8, seq_len=16, seed=3)
    np.testing.assert_array_equal(pipe2.batch_at(5)["tokens"], a["tokens"])


def test_pipeline_elastic_repartition():
    """The same global batch, split across 2 vs 4 workers, is identical data
    — elastic rescale only changes placement."""
    pipe = TokenPipeline(vocab_size=50, global_batch=8, seq_len=4, seed=1)
    g = pipe.batch_at(0)["tokens"]
    two = np.split(g, 2)
    four = np.split(g, 4)
    np.testing.assert_array_equal(np.concatenate(two),
                                  np.concatenate(four))


@pytest.mark.parametrize("device", [None, "cpu"])
def test_pipeline_prefetch_iterator(device):
    pipe = TokenPipeline(vocab_size=50, global_batch=4, seq_len=8, seed=0)
    it = pipe.shard_iterator(start_step=10, device=device)
    step, batch = next(it)
    assert step == 10
    np.testing.assert_array_equal(np.asarray(batch["tokens"]),
                                  pipe.batch_at(10)["tokens"])
    if device is not None:
        assert batch["tokens"].dtype == torch.int64
    step, _ = next(it)
    assert step == 11


# -- beyond the mirrors -------------------------------------------------------

@pytest.mark.parametrize("frontend,mrope", [("none", False),
                                            ("vision", True),
                                            ("audio", False)])
def test_batch_at_is_bit_identical_to_reference(frontend, mrope):
    kw = dict(vocab_size=300, global_batch=4, seq_len=24, seed=7,
              frontend=frontend, d_model=40, mrope=mrope)
    ours, ref = TokenPipeline(**kw), JPipeline(**kw)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in b:
            want = np.asarray(b[k])
            if want.dtype.name == "bfloat16":
                # f32 holding the bf16 values; placed as bf16 exactly
                assert a[k].dtype == np.float32
                want = want.astype(np.float32)
                assert torch.equal(place(a, "cpu")[k],
                                   torch.from_numpy(want).bfloat16())
            else:
                assert a[k].dtype == want.dtype, k
            assert a[k].shape == want.shape, k
            assert a[k].tobytes() == want.tobytes(), (step, k)
    placed = place(ours.batch_at(0), "cpu")
    assert placed["labels"].dtype == torch.int64


@pytest.mark.parametrize("arch,opt", [("qwen3-8b", "adamw"),
                                      ("recurrentgemma-9b", "adafactor")])
def test_checkpoint_restores_params_and_optimizer_state(tmp_path, arch, opt):
    """``(params, opt_state)`` saved and restored into fresh trees of the
    same structure: a tuple of two dicts, the segments a list (griffin's
    has several), every leaf bit for bit on the template's device."""
    cfg = configs.get_smoke(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    o = make_optimizer(opt)
    state = o.init(params)
    for t in _leaves(state):        # a state that is not all zeros
        t.add_(0.25)
    ck = CheckpointManager(str(tmp_path))
    ck.save(3, (params, state), extra={"step": 3}, background=True)
    ck.wait()
    like = (init_params(cfg, torch.Generator().manual_seed(1)),
            o.init(params))
    (p2, s2), extra = ck.restore(like)
    assert extra == {"step": 3}
    assert isinstance(p2["blocks"], list) and len(p2["blocks"]) == len(
        params["blocks"])
    assert isinstance(s2, dict) and sorted(s2) == sorted(state)
    for a, b in zip(_leaves((params, state)), _leaves((p2, s2))):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_train_launcher_defaults_to_the_card():
    """Without ``--device cpu`` the launcher asks for the GPU, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lib.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1"])
