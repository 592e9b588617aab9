"""Multi-request coalescing: one cached factor, many solves; port of
``repro/service/batching.py``.

The asymmetry the serving layer exploits: after the O(m n^2) Gram reduction,
every additional solve against the same dataset is O(n^2) — so requests that
share a dataset fingerprint should share one factor and run as a *stacked*
solve. Three coalescing shapes:

  * ``batched_gram_solve``   — k right-hand sides through one Cholesky
                               factor (64 ridge probes = one (n, 64) solve);
  * ``batched_quad_prox``    — FASTA over stacked (c_j, mu_j) lanes
                               sharing one G (lasso mu-path, elastic-net
                               grids, NNLS probe banks);
  * ``rhs_chunked``          — D^T B for a whole micro-batch of label
                               vectors (one data pass for k requests, not
                               k passes).

The reference ``jax.vmap``s each registered gram solver over the lanes.
Under vmap, FASTA's ``lax.cond(done, skip, step)`` and its backtracking
``while_loop`` freeze a lane once it is done or its backtrack test holds,
so every lane returns the x and iteration count of its own single solve.
The port's ``Fasta.run`` is a host loop and cannot be vmapped: the
registered FASTA problems (lasso, elastic_net, nnls) run here as one
lane-batched FASTA on (k, n) iterates, one ``X @ G^T`` per evaluation
point, with per-lane masks for ``done`` and for the backtracks. Other gram
solvers (ridge, and any later registration) loop over their lanes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import gram as gram_lib
from repro_torch.core.fasta import Fasta, power_lmax
from repro_torch.core.prox import soft_threshold
from repro_torch.service import registry

Tensor = torch.Tensor

def batched_gram_solve(L: Tensor, rhs_stack: Tensor) -> Tensor:
    """Solve (L L^T) X = rhs for k stacked right-hand sides.

    ``rhs_stack`` is (k, n); returns (k, n). One triangular solve pair over
    an (n, k) block — the BLAS-3 path, not k separate BLAS-2 solves.
    """
    return gram_lib.gram_solve(L, rhs_stack.T).T


def rhs_chunked(D: Tensor, B: Tensor, block_rows: int = 1024) -> Tensor:
    """Streaming D^T B over row blocks: (m, n), (m, k) -> (n, k).

    The micro-batch analogue of gram_and_rhs_chunked's rhs pass — k label
    vectors share one pass over the data (and skip the Gram term, which the
    caller already has cached). The block partials are summed in block
    order. On the CPU the blocks are the reference's; on the card the
    pass is one GEMM on D and B whole (16M rows in 1024-row blocks would
    be 16,384 launches; a bf16 D is upcast whole; PyTorch's default keeps
    TF32 off for f32 matmuls).
    """
    m, n = D.shape
    acc = gram_lib._acc_dtype(D.dtype)
    if D.device.type == "cuda":
        block_rows = max(m, 1)
    C = torch.zeros((n, B.shape[1]), dtype=acc, device=D.device)
    for Db, Bb in zip(gram_lib.blocked_rows(D, block_rows),
                      gram_lib.blocked_rows(B, block_rows)):
        C = C + Db.to(acc).T @ Bb.to(acc)
    return C


def _lane_fasta(G: Tensor, C: Tensor, mus: Tensor, l2: float, iters: int,
                kind: str) -> Tuple[Tensor, Tensor]:
    """FASTA on k lanes sharing G: lane j minimizes J_j(x) + 0.5 x^T G x
    - x^T c_j + l2/2 ||x||^2, with J_j = mu_j |x|_1 (``kind`` "l1") or
    the indicator of x >= 0 ("nonneg"). The steps, the non-monotone
    backtracking against each lane's window and the BB step sizes are
    ``core.fasta.Fasta.run``'s, lane by lane; a lane that is done, or
    whose backtrack test holds, keeps its state while the others move
    (the reference's vmap semantics). Returns (X (k, n), iters (k,))."""
    k, n = C.shape
    M = Fasta.window       # Fasta's defaults, as the registered solvers

    def prox(Z, t):
        if kind == "l1":
            return soft_threshold(Z, (t * mus)[:, None])
        return torch.clamp(Z, min=0.0)

    def at(X):
        """(g(x_j), grad g(x_j)) for every lane: one GEMM."""
        GX = X @ G.T
        g = 0.5 * torch.sum(X * GX, 1) - torch.sum(X * C, 1) \
            + 0.5 * l2 * torch.sum(X * X, 1)
        return g, GX - C + l2 * X

    def keep(mask, new, old):
        return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)),
                           new, old)

    X = torch.zeros((k, n), dtype=G.dtype, device=G.device)
    fx, gx = at(X)
    fmem = fx[:, None].repeat(1, M)
    t = torch.full((k,), 1.0, dtype=G.dtype, device=G.device) / (
        power_lmax(G) + l2)
    done = torch.zeros((k,), dtype=torch.bool, device=G.device)
    used = torch.zeros((k,), dtype=torch.int64, device=G.device)
    for it in range(iters):
        live = ~done
        if not bool(live.any()):
            break
        fmax = torch.max(fmem, 1).values
        tt = t
        xn = prox(X - tt[:, None] * gx, tt)
        fn, gn = at(xn)
        tries = 0
        while tries < Fasta.max_backtracks:
            dx = xn - X
            model = fmax + torch.sum(gx * dx, 1) \
                + torch.sum(dx * dx, 1) / (2 * tt)
            back = live & (fn > model + 1e-12)
            if not bool(back.any()):
                break
            tt = torch.where(back, tt * Fasta.backtrack_factor, tt)
            x2 = prox(X - tt[:, None] * gx, tt)
            f2, g2 = at(x2)
            xn, fn, gn = keep(back, x2, xn), keep(back, f2, fn), \
                keep(back, g2, gn)
            tries += 1
        # adaptive BB stepsize (steepest-descent / min-residual hybrid)
        dx = xn - X
        dg = gn - gx
        dxdg = torch.sum(dx * dg, 1)
        t_s = torch.where(dxdg > 0, torch.sum(dx * dx, 1) / dxdg, tt * 2.0)
        t_m = torch.where(dxdg > 0, dxdg / torch.sum(dg * dg, 1), tt * 2.0)
        t_new = torch.where(2.0 * t_m > t_s, t_m, t_s - 0.5 * t_m)
        t_new = torch.where((t_new <= 0) | ~torch.isfinite(t_new),
                            tt * 1.5, t_new)
        res = torch.linalg.norm(dx, dim=1) / torch.clamp(tt, min=1e-30)
        nrm = torch.clamp(torch.linalg.norm(gx, dim=1), min=1e-30)
        fmem[:, it % M] = keep(live, fn, fmem[:, it % M])
        X, gx, t = keep(live, xn, X), keep(live, gn, gx), keep(live, t_new, t)
        used += live.to(used.dtype)
        done = done | (live & (res / nrm < Fasta.tol))
    return X, used


# the registered FASTA solvers that run lane-batched, and their penalty;
# keyed by the function so a later registration under the same name takes
# the per-lane loop
_LANE_FASTA = {registry.lasso_from_stats: "l1",
               registry.elastic_net_from_stats: "l1",
               registry.nnls_from_stats: "nonneg"}


def batched_quad_prox(G: Tensor, c_stack, mu_stack, kind: str = "lasso",
                      l2: float = 0.0, iters: int = 1000
                      ) -> Tuple[Tensor, Tensor]:
    """Stats-path solve over stacked (c_j, mu_j) lanes sharing G.

    ``kind`` is any problem with a registered gram solver
    (registry.GRAM_SOLVERS — lasso / elastic_net / nnls / ridge / future
    registrations). Returns (X, iters_used) with X of shape (k, n). A lasso
    regularization path is the degenerate case c_stack = tile(c),
    mu_stack = the mu grid.
    """
    solver = registry.GRAM_SOLVERS.get(kind)
    if solver is None:
        raise ValueError(
            f"no gram solver registered for {kind!r}; "
            f"available: {sorted(registry.GRAM_SOLVERS)}")
    C = torch.as_tensor(c_stack).to(device=G.device, dtype=G.dtype)
    mus = torch.as_tensor(mu_stack).to(device=G.device, dtype=G.dtype)
    lane = _LANE_FASTA.get(solver)
    if lane is not None:
        # nnls takes no l2 (its solver swallows it, as in the reference)
        return _lane_fasta(G, C, mus, float(l2) if lane == "l1" else 0.0,
                           iters, lane)
    xs, its = [], []
    for c, mu in zip(C, mus.tolist()):
        x, it, _ = solver(G, c, mu=mu, l2=l2, iters=iters)
        xs.append(x)
        its.append(int(it))
    return torch.stack(xs), torch.tensor(its, device=G.device)


def lasso_mu_path(G: Tensor, c: Tensor, mus, iters: int = 1000) -> Tensor:
    """Full regularization path from ONE cached Gram: (len(mus), n)."""
    mus = torch.as_tensor(mus).to(device=G.device, dtype=G.dtype)
    c_stack = c.expand((mus.shape[0],) + tuple(c.shape))
    X, _ = batched_quad_prox(G, c_stack, mus, kind="lasso", iters=iters)
    return X
