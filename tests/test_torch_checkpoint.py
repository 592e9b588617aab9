"""Port parity for ``repro_torch.checkpoint.manager`` — the contract of
``tests/test_checkpoint.py`` (round trip, latest + GC, background save,
corruption detected, uncommitted tmp ignored, a killed writer never
corrupts) and the reference's on-disk layout: a checkpoint the JAX
package's ``CheckpointManager`` wrote restores here to the same arrays,
and the other way round. ``test_elastic_restore_new_sharding`` (re-placing
leaves on another mesh through ``shardings=``) is JAX-specific and waits
for the multi-GPU port (ROADMAP item 8)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch.checkpoint import CheckpointManager

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _tree(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"a": scale * torch.randn((16, 8), generator=g),
            "b": {"c": scale * torch.randn((4,), generator=g),
                  "d": torch.arange(5, dtype=torch.int32)}}


def _leaves(tree):
    return [tree["a"], tree["b"]["c"], tree["b"]["d"]]


def test_save_restore_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = _tree(0)
    m.save(7, tree, extra={"step": 7, "note": "x"})
    restored, extra = m.restore(tree)
    assert extra == {"step": 7, "note": "x"}
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # lists, tuples, named tuples and None hold their places
    from repro_torch.engine.streaming import SweepResult
    sw = SweepResult(*(torch.full((3,), float(i)) for i in range(7)))
    other = {"t": (torch.ones(2), None, [torch.zeros(3)]), "s": sw}
    m.save(8, other)
    back, _ = m.restore(other)
    assert isinstance(back["s"], SweepResult) and back["t"][1] is None
    assert torch.equal(back["s"].obj, sw.obj)
    assert torch.equal(back["t"][2][0], torch.zeros(3))


def test_latest_and_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree(1)
    for s in (1, 5, 9, 12):
        m.save(s, tree, extra={"step": s})
    assert m.latest_step() == 12
    assert m.all_steps() == [9, 12]  # gc kept last 2


def test_background_save_copies_the_live_buffers(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = _tree(2)
    want = [t.clone() for t in _leaves(tree)]
    m.save(3, tree, extra={"step": 3}, background=True)
    tree["a"].add_(1.0)          # the caller reuses its buffer at once
    m.wait()
    restored, extra = m.restore(tree)
    assert extra["step"] == 3
    for a, b in zip(want, _leaves(restored)):
        assert torch.equal(a, b)


def test_corruption_detected(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = _tree(3)
    m.save(1, tree, extra={"step": 1})
    leaf = tmp_path / "step_00000001" / "leaf_0.npy"
    data = bytearray(leaf.read_bytes())
    data[-5] ^= 0xFF
    leaf.write_bytes(bytes(data))
    with pytest.raises(IOError, match="corruption"):
        m.restore(tree)


def test_fallback_walks_back_to_an_intact_step(tmp_path):
    m = CheckpointManager(str(tmp_path))
    old, new = _tree(4), _tree(5)
    m.save(1, old, extra={"step": 1})
    m.save(2, new, extra={"step": 2})
    leaf = tmp_path / "step_00000002" / "leaf_1.npy"
    data = bytearray(leaf.read_bytes())
    data[-3] ^= 0xFF
    leaf.write_bytes(bytes(data))
    restored, extra = m.restore(new, fallback=True)
    assert extra["step"] == 1
    assert torch.equal(restored["a"], old["a"])
    with pytest.raises(IOError, match="corruption"):
        m.restore(new, step=2, fallback=True)    # explicit step: no walk


def test_uncommitted_tmp_ignored(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = _tree(6)
    m.save(1, tree, extra={"step": 1})
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "leaf_0.npy").write_bytes(b"garbage")
    assert m.latest_step() == 1
    restored, extra = m.restore(tree)
    assert extra["step"] == 1


def test_killed_writer_never_corrupts(tmp_path):
    """SIGKILL a process mid-save: the committed step survives and restores
    (the .tmp of the interrupted save is ignored)."""
    script = f"""
import os, signal, threading
import torch
from repro_torch.checkpoint import CheckpointManager
m = CheckpointManager({str(tmp_path)!r})
tree = {{"w": torch.ones((2048, 512)), "b": torch.zeros((4096,))}}
m.save(1, tree, extra={{"step": 1}})
t = threading.Thread(target=m.save, args=(2, tree),
                     kwargs={{"extra": {{"step": 2}}}})
t.start()
os.kill(os.getpid(), signal.SIGKILL)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, timeout=120)
    assert p.returncode != 0  # killed
    m = CheckpointManager(str(tmp_path))
    tree = {"w": torch.ones((2048, 512)), "b": torch.zeros((4096,))}
    step = m.latest_step()
    assert step in (1, 2)
    restored, extra = m.restore(tree, step=step)
    assert torch.equal(restored["w"], torch.ones((2048, 512)))


def test_reference_checkpoints_restore_here_and_back(tmp_path):
    """The on-disk layout is the reference's: leaf i is the same array in
    both packages (a dict's leaves by sorted key)."""
    rng = np.random.default_rng(7)
    arrays = {"x": rng.standard_normal(12).astype(np.float32),
              "y": rng.standard_normal(300).astype(np.float32),
              "lam": rng.standard_normal(300).astype(np.float32),
              "d": rng.standard_normal(12).astype(np.float32),
              "k": np.arange(4, dtype=np.int32)}
    JManager(str(tmp_path / "ref")).save(
        11, {k: jnp.asarray(v) for k, v in arrays.items()},
        extra={"kind": "streaming_solve", "iter": 11})
    like = {k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype)
            for k, v in arrays.items()}
    tree, extra = CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert extra == {"kind": "streaming_solve", "iter": 11}
    for k, v in arrays.items():
        np.testing.assert_array_equal(tree[k].numpy(), v)
    CheckpointManager(str(tmp_path / "ours")).save(
        3, {k: torch.from_numpy(v) for k, v in arrays.items()},
        extra={"iter": 3})
    jtree, jextra = JManager(str(tmp_path / "ours")).restore(
        {k: jnp.zeros(v.shape, v.dtype) for k, v in arrays.items()})
    assert jextra == {"iter": 3}
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(jtree[k]), v)
