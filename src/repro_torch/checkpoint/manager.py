"""Fault-tolerant checkpointing: atomic, manifest-verified, background-
writable; port of ``repro/checkpoint/manager.py``.

Layout per step (the reference's, so either package restores the other's
checkpoints):
  <dir>/step_<n>.tmp<pid>_<thread>/   (written)
  <dir>/step_<n>/                     (atomic rename commit)
      manifest.json        (tree structure, shapes, dtypes, crc32 per leaf,
                            caller's ``extra``)
      leaf_<i>.npy

Guarantees:
  * a SIGKILL at any instant leaves either a complete committed step or an
    uncommitted .tmp (ignored on restore) — never a torn checkpoint;
  * restore is exact (bitwise).

Trees are dicts, lists, tuples and named tuples of tensors, numpy arrays
or Python scalars; ``None`` holds no leaf. Leaves go in JAX's flattening
order (a dict by sorted keys), so leaf ``i`` is the same array in both
packages. Leaves are gathered to the host on the calling thread (copies:
the caller may overwrite its buffers as soon as ``save`` returns) and
restored as tensors on the device of the matching leaf of ``tree_like``
(CPU where that leaf is not a tensor). The reference's ``shardings=``
(re-placing leaves on another mesh) has no counterpart before the
multi-GPU port (ROADMAP item 8).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure) in JAX's order; the structure rebuilds the tree
    with :func:`_unflatten`."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, subs = [], []
        for k in keys:
            lv, s = _flatten(tree[k])
            leaves += lv
            subs.append(s)
        return leaves, ("dict", keys, subs)
    if isinstance(tree, (list, tuple)):
        leaves, subs = [], []
        for v in tree:
            lv, s = _flatten(v)
            leaves += lv
            subs.append(s)
        kind = type(tree) if _is_namedtuple(tree) else type(tree).__name__
        return leaves, ("seq", kind, subs)
    return [tree], "*"


def _unflatten(struct, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s == "*":
            return next(it)
        if s[0] == "dict":
            return {k: build(sub) for k, sub in zip(s[1], s[2])}
        items = [build(sub) for sub in s[2]]
        if s[1] == "list":
            return items
        if s[1] == "tuple":
            return tuple(items)
        return s[1](*items)

    return build(struct)


def _describe(struct) -> str:
    """The structure as text for the manifest (informational only)."""
    if struct is None:
        return "None"
    if struct == "*":
        return "*"
    if struct[0] == "dict":
        return "{" + ", ".join(f"{k!r}: {_describe(s)}"
                               for k, s in zip(struct[1], struct[2])) + "}"
    return "(" + ", ".join(_describe(s) for s in struct[2]) + ")"


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf (never a view of the caller's buffer)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf has no numpy dtype to save; "
                            "cast it to float32")
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()
    return np.array(leaf, copy=True)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        self.dir = Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._bg: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             background: bool = False):
        """Serialize ``tree`` at ``step``; ``background=True`` writes on a
        thread (``wait()`` joins it; a second save joins the first)."""
        leaves, struct = _flatten(tree)
        host_leaves = [_to_host(x) for x in leaves]   # gather to host
        if background:
            if self._bg is not None:
                self._bg.join()
            self._bg = threading.Thread(
                target=self._write,
                args=(step, host_leaves, _describe(struct), extra))
            self._bg.start()
        else:
            self._write(step, host_leaves, _describe(struct), extra)

    def wait(self):
        if self._bg is not None:
            self._bg.join()
            self._bg = None

    def _write(self, step, host_leaves, treedef, extra):
        # unique tmp per writer: concurrent saves of the same step must not
        # clobber each other's staging dir; the rename commit stays atomic
        tmp = self.dir / (f"step_{step:08d}.tmp{os.getpid()}_"
                          f"{threading.get_ident()}")
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            for p in tmp.iterdir():
                p.unlink()
            tmp.rmdir()
        tmp.mkdir()
        manifest = {
            "step": step,
            "treedef": treedef,
            "extra": extra or {},
            "leaves": [],
        }
        for i, leaf in enumerate(host_leaves):
            np.save(tmp / f"leaf_{i}.npy", leaf)
            manifest["leaves"].append({
                "shape": list(leaf.shape),
                "dtype": str(leaf.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(leaf).tobytes()),
            })
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():  # overwrite-safe (same step already committed)
            for p in tmp.iterdir():
                p.unlink()
            tmp.rmdir()
            return
        try:
            tmp.rename(final)  # atomic commit
        except OSError:
            pass  # lost the race to an identical commit — fine
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            d = self.dir / f"step_{s:08d}"
            for p in d.iterdir():
                p.unlink()
            d.rmdir()

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") \
                    and ".tmp" not in p.name:
                if (p / "manifest.json").exists():
                    out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                fallback: bool = False) -> Tuple[Any, Dict]:
        """Restore into the structure of ``tree_like``; returns (tree,
        extra). ``fallback=True`` walks back to the previous committed step
        when the newest one fails its crc / manifest check (disk rot on the
        most recent write must not strand a recovering solve when older
        intact steps exist); an explicit ``step`` disables the walk-back."""
        if step is None and fallback:
            last_err: Optional[Exception] = None
            for s in reversed(self.all_steps()):
                try:
                    return self._restore_step(tree_like, s)
                except (IOError, OSError, ValueError, KeyError) as e:
                    last_err = e
            if last_err is not None:
                raise IOError(
                    f"every checkpoint step failed to restore; newest "
                    f"error: {last_err}") from last_err
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        return self._restore_step(tree_like, step)

    def _restore_step(self, tree_like: Any, step: int) -> Tuple[Any, Dict]:
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves_like, struct = _flatten(tree_like)
        if len(leaves_like) != len(manifest["leaves"]):
            raise ValueError(f"tree mismatch: {len(leaves_like)} leaves vs "
                             f"{len(manifest['leaves'])} in step {step}")
        out = []
        for i, (meta, like) in enumerate(zip(manifest["leaves"],
                                             leaves_like)):
            arr = np.load(d / f"leaf_{i}.npy")
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != meta["crc32"]:
                raise IOError(f"checkpoint corruption in leaf {i} "
                              f"(crc {crc} != {meta['crc32']})")
            t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
            if isinstance(like, torch.Tensor):
                t = t.to(like.device)
            out.append(t)
        return _unflatten(struct, out), manifest["extra"]
