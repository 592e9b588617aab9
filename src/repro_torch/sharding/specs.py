"""Parameter / optimizer-state / batch / cache spec rules; port of
``repro/sharding/specs.py``.

Megatron-style TP on 'model' (attention heads, FFN hidden, experts, vocab),
DP on ('pod','data'), and ZeRO-1: optimizer state additionally sharded over
the DP axes along the first divisible unsharded dim.

Trees are the port's parameter trees (nested dicts and lists of tensors,
numpy arrays or anything with a ``shape``); a spec is a plain tuple (see
``sharding.util``), and a spec tree has the structure of its tree with a
spec at each leaf. A grid is a ``compat.Grid``, joined or a description.
Beyond the reference's rules, :func:`local_shape`, :func:`local_bytes` and
:func:`local_slice` give a leaf's per-rank shape, bytes and cut under a
spec: the a2a path cuts each rank's expert shard with them, the dry-run
sums per-device memory with them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.sharding.util import DP

# Base (unstacked) spec per leaf name; leading dims (scan L, expert E pre-
# existing in shapes below) are part of the listed spec where relevant.
_BASE = {
    # embeddings / head: shard vocab-or-feature on 'model'
    "embed": (None, "model"),
    "lm_head": (None, "model"),
    "final_norm": (),
    "enc_norm": (),
    # attention
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wo": ("model", None),
    "q_norm": (),
    "k_norm": (),
    # mlp
    "w1": (None, "model"),
    "w3": (None, "model"),
    "w2": ("model", None),
    # moe (E, d, ff) — experts on 'model' (EP)
    "router": (),
    "we1": ("model", None, None),
    "we3": ("model", None, None),
    "we2": ("model", None, None),
    # rwkv time-mix / channel-mix
    "wr": (None, "model"),
    "wg": (None, "model"),
    "maa_base": (),
    "maa_w1": (),
    "maa_w2": (),
    "decay_base": (),
    "decay_w1": (),
    "decay_w2": (),
    "bonus": (),
    "gn_scale": (),
    "gn_bias": (),
    "mu_k": (),
    "mu_r": (),
    # griffin
    "w_gate": (None, "model"),
    "w_x": (None, "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "lru_lambda": ("model",),
    "w_a": (None, "model"),
    "w_i": (None, "model"),
    "w_out": ("model", None),
    # norms
    "ln1": (),
    "ln2": (),
    "ln_x": (),
}


def tree_map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts and lists;
    ``path`` holds the dict keys and list indices down to the leaf. The
    ``rest`` trees follow ``tree``'s structure (spec trees included: a
    tuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                   path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def leaves(tree):
    """The leaves of a tree (tuples count as leaves), in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _ndim(leaf) -> int:
    return len(leaf.shape)


def param_spec(params, parallelism: str = "tp") -> Any:
    """Spec tree matching ``params`` (handles stacked L dims by left-padding
    the base spec with None). parallelism="fsdp" strips the 'model' (TP)
    entries — params are then sharded over the DP axes by zero1_spec
    instead."""

    def per_leaf(path, leaf):
        name = _leaf_name(path)
        base = _BASE.get(name, ())
        if parallelism == "fsdp":
            base = tuple(None if e == "model" else e for e in base)
        pad = _ndim(leaf) - len(base)
        assert pad >= 0, (name, tuple(leaf.shape), base)
        return (None,) * pad + base

    return tree_map_with_path(per_leaf, params)


def zero1_spec(pspec_tree, params, grid, axes=DP) -> Any:
    """Optimizer-state spec: param spec + DP sharding on the first unsharded
    dim whose size divides the DP axis product (ZeRO-1)."""
    dp_axes = tuple(a for a in axes if a in grid.axis_names)
    dp_size = 1
    for a in dp_axes:
        dp_size *= grid.axis_size(a)

    def per_leaf(leaf, spec):
        if dp_size <= 1:
            return spec
        entries = list(spec) + [None] * (_ndim(leaf) - len(spec))
        for i, (e, dim) in enumerate(zip(entries, leaf.shape)):
            if e is None and dim % dp_size == 0:
                entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
                return tuple(entries)
        return tuple(entries)

    return tree_map(per_leaf, params, pspec_tree)


def axis_size(grid, entry) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    size = 1
    for n in names:
        if n in grid.axis_names:
            size *= grid.axis_size(n)
    return size


def divisible_spec(spec, shape, grid):
    """Drop axis names whose grid size does not divide the dim (explicit
    input shardings must tile evenly; e.g. batch=1 long-context decode, or
    8 kv heads on 16-way TP)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for e, dim in zip(entries, shape):
        out.append(e if dim % axis_size(grid, e) == 0 else None)
    return tuple(out)


def batch_spec(batch_shapes: Dict[str, Any], grid=None,
               axes=DP) -> Dict[str, tuple]:
    """Inputs: batch dim on the DP axes (all grid axes under fsdp
    parallelism). mrope positions (3,B,S) shard dim 1."""
    out = {}
    for k, v in batch_shapes.items():
        nd = _ndim(v)
        if k == "positions" and nd == 3:
            spec = (None, axes, None)
        else:
            spec = (axes,) + (None,) * (nd - 1)
        if grid is not None:
            spec = divisible_spec(spec, v.shape, grid)
        out[k] = spec
    return out


def cache_spec(caches, grid=None) -> Any:
    """KV/state caches: dim0 is L (replicated), batch on DP, heads/channels
    on 'model'. When the kv-head count does not divide the TP size (GQA-8 on
    TP16 without kv_repeat), the sharding falls back to the head_dim axis;
    non-divisible batch (long-context batch=1) falls back to replication.
    """

    def per_leaf(path, leaf):
        name = _leaf_name(path)
        if name in ("k", "v", "xk", "xv"):       # (L,B,S,Hkv,hd)
            spec = (None, DP, None, "model", None)
            if grid is not None and leaf.shape[3] % axis_size(
                    grid, "model") != 0:
                spec = (None, DP, None, None, "model")  # shard head_dim
        elif name == "S":                         # (L,B,H,hd,hd)
            spec = (None, DP, "model", None, None)
        elif name in ("tmix_x", "cmix_x"):        # (L,B,d)
            spec = (None, DP, None)
        elif name == "h":                         # (L,B,lw)
            spec = (None, DP, "model")
        elif name == "conv":                      # (L,B,W-1,lw)
            spec = (None, DP, None, "model")
        else:
            spec = (None,) * _ndim(leaf)
        if grid is not None:
            spec = divisible_spec(spec, leaf.shape, grid)
        return spec

    return tree_map_with_path(per_leaf, caches)


# ---------------------------------------------------------------------------
# per-rank shapes, bytes and cuts
# ---------------------------------------------------------------------------

def _itemsize(leaf) -> int:
    dt = leaf.dtype
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).element_size()
    return np.dtype(dt).itemsize


def local_shape(shape: Sequence[int], spec, grid) -> tuple:
    """A leaf's per-rank shape under ``spec`` (axis names the grid lacks
    are ignored; a dim that does not divide is padded to the next multiple,
    as GSPMD pads an uneven sharding)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(-(-dim // axis_size(grid, e))
                 for e, dim in zip(entries, shape))


def local_bytes(tree, spec_tree, grid) -> int:
    """Bytes one rank holds of ``tree`` under ``spec_tree``."""
    total = 0
    for leaf, spec in zip(leaves(tree), leaves(spec_tree)):
        total += int(np.prod(local_shape(leaf.shape, spec, grid),
                             dtype=np.int64)) * _itemsize(leaf)
    return total


def local_slice(leaf, spec, grid, coords: Optional[Sequence[int]] = None):
    """The block of ``leaf`` (a tensor or a numpy array) that the rank at
    ``coords`` (default: the joined grid's own) holds under ``spec``: a
    view. A dim split over several axes is tiled row-major over them."""
    entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
    idx = []
    for e, dim in zip(entries, leaf.shape):
        names = tuple(a for a in ((e,) if isinstance(e, str) else (e or ()))
                      if a in grid.axis_names)
        if not names:
            idx.append(slice(None))
            continue
        n = axis_size(grid, names)
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {e} ({n})")
        per = dim // n
        i = grid.index(names, coords)
        idx.append(slice(i * per, (i + 1) * per))
    return leaf[tuple(idx)]


def shard_tree(tree, spec_tree, grid, coords=None):
    """Every leaf of ``tree`` cut to the rank's block (views)."""
    return tree_map(lambda leaf, spec: local_slice(leaf, spec, grid, coords),
                    tree, spec_tree)
