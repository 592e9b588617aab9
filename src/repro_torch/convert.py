"""Carry the JAX package's solver state, data and LM weights into the port.

The JAX package hands over numpy arrays (``np.asarray`` of an
``ADMMResult`` field, of a ``CheckpointManager`` tree leaf or of an LM
``init_params`` tree); this module turns them into the port's tensors on a
given device, so a solve started in JAX can continue here and both
packages' LMs can run on the same weights (the parity tests do exactly
that). The JAX ``ShardMapExecutor``'s iterate state becomes one rank's
(:func:`shard_state`). A JAX loss spec (``{"name": "hinge", "C": 1.0}``)
becomes the port's loss through :func:`loss_from_spec`. It imports nothing of the JAX
package: the inputs are plain numpy arrays, dicts and loss specs.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.prox import loss_from_spec  # noqa: F401 (re-export)
from repro_torch.device import resolve_device
from repro_torch.sharding.compat import shard_rows

STATE_KEYS = ("x", "y", "lam", "d")


def tensor(a, device="cuda", dtype: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """One array (numpy or anything ``np.asarray`` takes) as a tensor on
    ``device``; bf16 arrays (which numpy keeps as ml_dtypes) go through
    float32."""
    arr = np.asarray(a)
    bf16 = arr.dtype.name == "bfloat16"
    if bf16:
        arr = arr.astype(np.float32)
    # a writable C-ordered array (copied only if it is not one already:
    # a JAX array's numpy view is read-only)
    arr = np.require(arr, requirements=["C", "W"])
    t = torch.from_numpy(arr).to(resolve_device(device))
    if dtype is None and bf16:
        dtype = torch.bfloat16
    return t if dtype is None else t.to(dtype)


def solver_state(src, device="cuda") -> dict:
    """``{"x", "y", "lam", "d"}`` tensors from an ``ADMMResult``-like
    object (fields as attributes) or a checkpoint tree (a mapping); keys
    the source lacks come back as None. Iterates keep the node-stacked
    (N, m_i) layout."""
    get = (src.get if isinstance(src, Mapping)
           else lambda k: getattr(src, k, None))
    out = {}
    for k in STATE_KEYS:
        v = get(k)
        out[k] = None if v is None else tensor(v, device, torch.float32)
    return out


def shard_state(src: Mapping, m: int, rank: int, world: int,
                device="cuda") -> dict:
    """The JAX ``ShardMapExecutor``'s iterate state as rank ``rank``'s of
    ``world`` in the port (``ShardMapExecutor.adopt`` takes it).

    ``src`` maps ``y`` and ``lam`` (the reference's global arrays, (m,) or
    (m, K), possibly zero-padded to its own shard multiple) and ``err``
    ((shards, n): one EF residual per shard) to numpy arrays; ``m`` is the
    unpadded row count. y and lam become this rank's rows of the arrays
    zero-padded at ``world``. The EF error becomes row ``rank`` of err when
    the reference ran ``world`` shards; at another world size it starts at
    zero, as on a restore (a residual belongs to its sender's stream)."""
    out = {k: tensor(shard_rows(np.asarray(src[k])[:m], rank, world),
                     device, torch.float32) for k in ("y", "lam")}
    err = np.asarray(src["err"], dtype=np.float32)
    out["err"] = tensor(err[rank] if err.shape[0] == world
                        else np.zeros(err.shape[1:], np.float32),
                        device, torch.float32)
    return out


def lm_params(tree, device="cuda"):
    """The JAX package's ``init_params`` tree, handed over as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's parameter tree:
    the same keys, the list of stacked segments, shapes and dtypes (bf16
    leaves stay bf16). An AdamW or Adafactor state tree (``{"m", "v"}``,
    ``{"f"}``) carries over the same way, and the port's optimizers take
    it as it is (they match trees by key)."""
    if isinstance(tree, Mapping):
        return {k: lm_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params(v, device) for v in tree]
    return tensor(tree, device)


def problem_data(D, aux=None, device="cuda",
                 dtype: Optional[torch.dtype] = None):
    """(D, aux) as tensors on ``device``; D keeps its (N, m_i, n) layout
    and, unless ``dtype`` is given, its type (f32 or bf16)."""
    return (tensor(D, device, dtype),
            None if aux is None else tensor(aux, device, torch.float32))


def lm_params_shard(tree, spec_tree, grid, coords, device="cuda"):
    """One rank's block of a JAX ``init_params`` tree (numpy arrays) as the
    port's parameters: each leaf cut under its spec (``spec_tree``, e.g.
    ``sharding.specs.param_spec``) for the rank at ``coords`` of ``grid``,
    then converted as :func:`lm_params` does."""
    from repro_torch.sharding.specs import shard_tree
    return lm_params(shard_tree(tree, spec_tree, grid, coords), device)
