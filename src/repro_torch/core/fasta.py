"""FASTA-style forward-backward splitting (Goldstein et al. 2014b/2015);
port of ``repro/core/fasta.py``.

Solves ``min_x g(x) + J(x)`` with smooth g and proximable J via

    x^{k+1} = prox_J(x^k - t_k grad g(x^k), t_k)

with spectral (Barzilai-Borwein) adaptive stepsizes and a non-monotone
backtracking line search — the single-node solver the paper uses for the
transpose-reduced lasso (section 4): after the Gram reduction the whole
problem is

    min_x J(x) + 0.5 x^T (D^T D) x - x^T (D^T b)

whose gradient only needs the cached n x n Gram matrix (paper eq. 8).

The reference is one jitted ``lax.scan`` with a ``lax.while_loop``
backtrack. Here it is a host loop over small tensors on G's device,
computing in G's dtype, with the reference's semantics: a window of 10
for the non-monotone test, at most 20 backtracks by 0.5, the BB hybrid
step with its fallbacks. Once the residual test holds the reference repeats
its carry, so ``objective`` and ``residual`` keep length ``iters`` (the last
values repeated) and ``iters`` counts the steps taken.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import gram as gram_lib
from repro_torch.core.prox import soft_threshold

Tensor = torch.Tensor


class FastaResult(NamedTuple):
    x: Tensor
    iters: int
    objective: Tensor          # per-iteration g+J telemetry (fixed length)
    residual: Tensor           # ||x^{k+1}-x^k|| / t_k (prox-gradient residual)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


@dataclasses.dataclass(frozen=True)
class Fasta:
    gradg: Callable[[Tensor], Tensor]
    g: Callable[[Tensor], Tensor]
    proxJ: Callable[[Tensor, Tensor], Tensor]    # (z, t) -> prox_{tJ}(z)
    J: Callable[[Tensor], Tensor]
    tol: float = 1e-10                           # on normalized residual
    window: int = 10                             # non-monotone window M
    backtrack_factor: float = 0.5
    max_backtracks: int = 20

    def run(self, x0: Tensor, t0, iters: int) -> FastaResult:
        M = self.window
        x = x0
        fx, gx = self.g(x), self.gradg(x)
        fmem = fx.reshape(1).repeat(M)
        t = torch.as_tensor(t0, dtype=x0.dtype, device=x0.device)
        objs, ress = [], []
        for k in range(iters):
            # candidate step, backtracked against the window's max
            fmax = torch.max(fmem)
            tt = t
            xn = self.proxJ(x - tt * gx, tt)
            fn = self.g(xn)
            tries = 0
            while tries < self.max_backtracks:
                dx = xn - x
                model = fmax + _dot(gx, dx) + torch.sum(dx * dx) / (2 * tt)
                if not bool(fn > model + 1e-12):
                    break
                tt = tt * self.backtrack_factor
                xn = self.proxJ(x - tt * gx, tt)
                fn = self.g(xn)
                tries += 1
            gn = self.gradg(xn)
            # adaptive BB stepsize (steepest-descent / min-residual hybrid)
            dx = xn - x
            dg = gn - gx
            dxdg = _dot(dx, dg)
            t_s = torch.where(dxdg > 0, _dot(dx, dx) / dxdg, tt * 2.0)
            t_m = torch.where(dxdg > 0, dxdg / _dot(dg, dg), tt * 2.0)
            t_new = torch.where(2.0 * t_m > t_s, t_m, t_s - 0.5 * t_m)
            t_new = torch.where((t_new <= 0) | ~torch.isfinite(t_new),
                                tt * 1.5, t_new)
            res = torch.linalg.norm(dx) / torch.clamp(tt, min=1e-30)
            nrm = torch.clamp(torch.linalg.norm(gx), min=1e-30)
            fmem[k % M] = fn
            x, gx, t = xn, gn, t_new
            objs.append(fn + self.J(xn))
            ress.append(res)
            if bool(res / nrm < self.tol):
                break
        used = len(objs)
        pad = iters - used
        objective = torch.stack(objs + objs[-1:] * pad) if objs else \
            torch.zeros((0,), dtype=x0.dtype, device=x0.device)
        residual = torch.stack(ress + ress[-1:] * pad) if ress else \
            torch.zeros((0,), dtype=x0.dtype, device=x0.device)
        return FastaResult(x, used, objective, residual)


def power_lmax(G: Tensor, iters: int = 20) -> Tensor:
    """lambda_max(G) for PSD G by power iteration (the Lipschitz
    estimate)."""
    n = G.shape[0]
    v = torch.ones((n,), dtype=G.dtype, device=G.device) / math.sqrt(n)
    for _ in range(iters):
        w = G @ v
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    return torch.clamp(torch.dot(v, G @ v), min=1e-12)


def transpose_reduction_lasso(G: Tensor, c: Tensor, mu, iters: int = 2000,
                              x0: Optional[Tensor] = None,
                              l2: float = 0.0) -> FastaResult:
    """Paper section 4: solve lasso from cached (D^T D, D^T b) on a single
    node.

    min_x mu|x| + l2/2||x||^2 + 0.5 x^T G x - x^T c. Gradient G x - c
    (+ l2 x); the initial step is 1 / (lambda_max(G) + l2), by power
    iteration. ``l2 > 0`` is the elastic net: the extra quadratic folds
    into the smooth part, so the same cached Gram serves the family."""
    n = G.shape[0]
    mu, l2 = float(mu), float(l2)
    if x0 is None:
        x0 = torch.zeros((n,), dtype=G.dtype, device=G.device)
    t0 = 1.0 / (power_lmax(G) + l2)

    solver = Fasta(
        gradg=lambda x: G @ x - c + l2 * x,
        g=lambda x: 0.5 * torch.dot(x, G @ x) - torch.dot(x, c)
        + 0.5 * l2 * torch.dot(x, x),
        proxJ=lambda z, t: soft_threshold(z, t * mu),
        J=lambda x: mu * torch.sum(torch.abs(x)),
    )
    return solver.run(x0.to(G.dtype), t0, iters)


def lasso_mu_max(D2: Tensor, b: Tensor) -> Tensor:
    """Smallest mu for which the lasso solution is exactly 0: ||D^T b||_inf.
    The paper's "10% rule" (section 10.1) sets mu = 0.1 * mu_max."""
    return torch.max(torch.abs(gram_lib.gram_rhs(D2, b)))
