"""Transpose reduction: Gram-matrix computation (paper section 4); port
of ``repro/core/gram.py``.

For tall D (m >> n), ``D^T D = sum_i D_i^T D_i`` is only n x n. Each node
builds its local Gram matrix by streaming row blocks; one all-reduce
produces the global Gram.

Implementations with identical semantics:
  * ``gram`` / ``gram_rhs``   — one-shot torch (oracle / small inputs).
  * ``gram_chunked`` and friends — a Python loop over row blocks; live
    memory is one upcast block.
  * ``repro_torch.kernels.gram.ops.gram`` — the CUDA kernel.

Accumulation is always f32 (or f64 if inputs are f64): the Gram sum is a
long reduction, so bf16 inputs are upcast per block. The Cholesky factor
and the triangular solves were ``jnp.linalg`` in the reference, so
``torch.linalg`` is their counterpart here.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _acc_dtype(dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def blocked_rows(x: torch.Tensor, block_rows: int):
    """Row blocks of ``x`` as views, the last one ragged (the reference
    zero-pads to a block multiple; a view of the ragged rest needs no
    padding and changes no sum)."""
    return [x[s:s + block_rows] for s in range(0, x.shape[0], block_rows)]


def gram(D: torch.Tensor) -> torch.Tensor:
    """D^T D in accumulation precision."""
    Dc = D.to(_acc_dtype(D.dtype))
    return Dc.T @ Dc


def gram_rhs(D: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """D^T b in accumulation precision (the lasso RHS, paper section 4)."""
    acc = _acc_dtype(D.dtype)
    return D.to(acc).T @ b.to(acc)


def gram_chunked(D: torch.Tensor, block_rows: int = 1024) -> torch.Tensor:
    """Streaming D^T D over row blocks of size ``block_rows``."""
    m, n = D.shape
    acc = _acc_dtype(D.dtype)
    G = torch.zeros((n, n), dtype=acc, device=D.device)
    for blk in blocked_rows(D, block_rows):
        blk = blk.to(acc)
        G = G + blk.T @ blk
    return G


def gram_and_rhs_chunked(D: torch.Tensor, b: torch.Tensor,
                         block_rows: int = 1024
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused streaming (D^T D, D^T b) — one pass over the data. ``b`` may
    be (m,) or (m, r); c comes back (n,) or (n, r)."""
    m, n = D.shape
    acc = _acc_dtype(D.dtype)
    G = torch.zeros((n, n), dtype=acc, device=D.device)
    c = torch.zeros((n,) + tuple(b.shape[1:]), dtype=acc, device=D.device)
    for Db, bb in zip(blocked_rows(D, block_rows),
                      blocked_rows(b, block_rows)):
        Db = Db.to(acc)
        G = G + Db.T @ Db
        c = c + Db.T @ bb.to(acc)
    return G, c


def gram_rhs_chunked(D: torch.Tensor, b: torch.Tensor,
                     block_rows: int = 1024) -> torch.Tensor:
    """Streaming D^T b over row blocks — never materializes a full
    accumulation-precision copy of D (the warm-start ``transpose_d`` and
    ``rmatvec`` paths of the iteration engine)."""
    m, n = D.shape
    acc = _acc_dtype(D.dtype)
    c = torch.zeros((n,) + tuple(b.shape[1:]), dtype=acc, device=D.device)
    for Db, bb in zip(blocked_rows(D, block_rows),
                      blocked_rows(b, block_rows)):
        c = c + Db.to(acc).T @ bb.to(acc)
    return c


def gram_factor(G: torch.Tensor, ridge: float = 0.0) -> torch.Tensor:
    """Cholesky factor of (G + ridge*I). The paper stores the explicit
    inverse; the Cholesky factor has the same cost and better conditioning
    (DESIGN.md section 3). ``ridge`` carries the rho/tau term of
    ridge-regularized x-updates (SVM). Raises if the matrix is not
    positive definite (the reference returned NaN)."""
    n = G.shape[0]
    A = G + ridge * torch.eye(n, dtype=G.dtype, device=G.device) \
        if ridge else G
    return torch.linalg.cholesky(A)


def gram_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = rhs given the Cholesky factor L; rhs (n,) or
    (n, r)."""
    vec = rhs.dim() == 1
    B = rhs.unsqueeze(-1) if vec else rhs
    z = torch.linalg.solve_triangular(L, B, upper=False)
    x = torch.linalg.solve_triangular(L.T, z, upper=True)
    return x.squeeze(-1) if vec else x
