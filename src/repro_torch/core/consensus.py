"""Consensus ADMM baseline (Boyd et al. 2010) — the method the paper beats;
port of ``repro/core/consensus.py``.

Global consensus form:  min sum_i f_i(x_i) + g(z)  s.t.  x_i = z.

    x_i^{k+1} = argmin_{x_i} f_i(x_i) + tau/2 ||x_i - z^k + u_i^k||^2   (inner)
    z^{k+1}   = prox_g( mean_i(x_i^{k+1} + u_i^k), 1/(N tau) )
    u_i^{k+1} = u_i^k + x_i^{k+1} - z^{k+1}

Every node runs an inner solver per outer iteration:

  * lasso:    a per-node cached Cholesky factor of (D_i^T D_i + tau I);
  * logistic: damped Newton with warm start;
  * SVM:      dual coordinate descent on paper eq. (21) (Appendix A), with
              greedy largest-residual ordering and warm start.

The reference's per-node ``jax.vmap`` calls are batched ops over the node
axis here: batched Cholesky factors and solves over (N, n, n), and for the
SVM one coordinate step of every node at a time. The CD is sequential over
the m_i coordinates of a pass. Like the reference, ``run`` takes every one
of ``iters`` iterations and reports where Boyd's rule first held.

Node layout matches ``unwrapped.py``: D is (N, m_i, n), labels/b (N, m_i).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import gram as gram_lib
from repro_torch.core.prox import soft_threshold, softplus

Tensor = torch.Tensor


class ConsensusHistory(NamedTuple):
    objective: Tensor
    primal_res: Tensor      # ||x_i - z|| stacked norm (Boyd)
    dual_res: Tensor        # tau ||z^{k+1} - z^k|| * sqrt(N)
    inner_iters: Tensor     # inner-solver iterations spent this outer iter
    converged_at: int


class ConsensusResult(NamedTuple):
    z: Tensor
    iters: int
    history: Optional[ConsensusHistory]


def _stopping(x_stack, z, u_stack, tau, z_old, eps_rel, eps_abs):
    N, n = x_stack.shape
    r = torch.linalg.norm((x_stack - z[None, :]).reshape(-1))
    s = tau * math.sqrt(N) * torch.linalg.norm(z - z_old)
    eps_pri = math.sqrt(N * n) * eps_abs + eps_rel * torch.maximum(
        torch.linalg.norm(x_stack.reshape(-1)),
        math.sqrt(N) * torch.linalg.norm(z))
    eps_dual = math.sqrt(N * n) * eps_abs + eps_rel * tau * \
        torch.linalg.norm(u_stack.reshape(-1))
    return (r <= eps_pri) & (s <= eps_dual), r, s


def _finish(z, iters, objs, rs, ss, inner, k_conv) -> ConsensusResult:
    """History on the device, one host read of the convergence point."""
    kc = int(k_conv.item())
    dev = z.device
    hist = ConsensusHistory(
        torch.stack(objs), torch.stack(rs), torch.stack(ss),
        torch.full((iters,), inner, dtype=torch.int32, device=dev), kc)
    return ConsensusResult(z, kc + 1 if kc >= 0 else iters, hist)


def _converged(k_conv, done, k):
    return torch.where((k_conv < 0) & done,
                       torch.full_like(k_conv, k), k_conv)


def greedy_order(pg: Tensor) -> Tensor:
    """Coordinates by decreasing |pg| along the last axis, ties in index
    order: the reference's stable ``jnp.argsort(-|pg|)``. The key is
    0 - |pg|, never -0.0, so every zero ties with every other."""
    return torch.argsort(0.0 - torch.abs(pg), dim=-1, stable=True)


def _matvec(D: Tensor, x: Tensor) -> Tensor:
    """(N, m_i, n) x (N, n) -> (N, m_i)."""
    return (D @ x[..., None])[..., 0]


def _rmatvec(D: Tensor, u: Tensor) -> Tensor:
    """(N, m_i, n)^T x (N, m_i) -> (N, n)."""
    return (D.mT @ u[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class ConsensusLasso:
    """min 0.5||Dx-b||^2 + mu|x| via consensus (Boyd sections 6.4 / 8.2)."""

    mu: float
    tau: float = 1.0
    eps_rel: float = 1e-3
    eps_abs: float = 1e-6

    def run(self, D: Tensor, b: Tensor, iters: int) -> ConsensusResult:
        N, mi, n = D.shape
        acc = gram_lib._acc_dtype(D.dtype)
        Dc = D.to(acc)
        bc = b.to(acc)
        mu, tau = float(self.mu), float(self.tau)
        # setup: every node factors (D_i^T D_i + tau I) — the consensus
        # counterpart of the one global Gram factorization
        Gs = Dc.mT @ Dc
        eye = torch.eye(n, dtype=acc, device=D.device)
        Ls = torch.linalg.cholesky(Gs + tau * eye)
        del Gs
        Dtb = _rmatvec(Dc, bc)
        z = torch.zeros((n,), dtype=acc, device=D.device)
        u = torch.zeros((N, n), dtype=acc, device=D.device)
        k_conv = torch.tensor(-1, device=D.device)
        objs, rs, ss = [], [], []
        for k in range(iters):
            rhs = Dtb + tau * (z[None, :] - u)
            xs = torch.cholesky_solve(rhs[..., None], Ls)[..., 0]
            w = torch.mean(xs + u, dim=0)
            z_new = soft_threshold(w, mu / (tau * N))
            u_new = u + xs - z_new[None, :]
            done, r, s = _stopping(xs, z_new, u_new, tau, z, self.eps_rel,
                                   self.eps_abs)
            k_conv = _converged(k_conv, done, k)
            obj = 0.5 * torch.sum((Dc @ z_new - bc) ** 2) + \
                mu * torch.sum(torch.abs(z_new))
            objs.append(obj)
            rs.append(r)
            ss.append(s)
            z, u = z_new, u_new
        return _finish(z, iters, objs, rs, ss, 1, k_conv)


@dataclasses.dataclass(frozen=True)
class ConsensusLogistic:
    """min sum log(1+exp(-l .)) (+ mu|x|) via consensus; Newton inner
    solver."""

    mu: float = 0.0
    tau: float = 1.0
    newton_iters: int = 8
    eps_rel: float = 1e-3
    eps_abs: float = 1e-6

    def _local_newton(self, Dc, lc, v, x0):
        """Per node argmin_x sum log(1+exp(-l D_i x)) + tau/2||x - v||^2,
        warm-started, every node at once."""
        n = Dc.shape[-1]
        eye = torch.eye(n, dtype=Dc.dtype, device=Dc.device)
        x = x0
        for _ in range(self.newton_iters):
            zi = _matvec(Dc, x)
            s = torch.sigmoid(-lc * zi)
            grad = _rmatvec(Dc, -lc * s) + self.tau * (x - v)
            Wd = s * (1.0 - s)
            H = (Dc * Wd[..., None]).mT @ Dc + self.tau * eye
            step = torch.linalg.solve(H, grad[..., None])[..., 0]
            x = x - step
        return x

    def run(self, D: Tensor, labels: Tensor, iters: int) -> ConsensusResult:
        N, mi, n = D.shape
        acc = gram_lib._acc_dtype(D.dtype)
        Dc = D.to(acc)
        lc = labels.to(acc)
        mu, tau = float(self.mu), float(self.tau)
        z = torch.zeros((n,), dtype=acc, device=D.device)
        u = torch.zeros((N, n), dtype=acc, device=D.device)
        xs = torch.zeros((N, n), dtype=acc, device=D.device)
        k_conv = torch.tensor(-1, device=D.device)
        objs, rs, ss = [], [], []
        for k in range(iters):
            v = z[None, :] - u
            xs = self._local_newton(Dc, lc, v, xs)      # warm start: xs
            w = torch.mean(xs + u, dim=0)
            z_new = soft_threshold(w, mu / (tau * N)) if mu > 0 else w
            u_new = u + xs - z_new[None, :]
            done, r, s = _stopping(xs, z_new, u_new, tau, z, self.eps_rel,
                                   self.eps_abs)
            k_conv = _converged(k_conv, done, k)
            obj = torch.sum(softplus(-lc * (Dc @ z_new))) + \
                mu * torch.sum(torch.abs(z_new))
            objs.append(obj)
            rs.append(r)
            ss.append(s)
            z, u = z_new, u_new
        return _finish(z, iters, objs, rs, ss, self.newton_iters, k_conv)


@dataclasses.dataclass(frozen=True)
class ConsensusSVM:
    """min 0.5||x||^2 + C h(Dx) via consensus; dual-CD inner solver
    (paper Appendix A).

    Each node solves  min_w ridge/2 ||w||^2 + C h_i(D_i w) + tau/2||w - v||^2
    with ridge = 1/N, so the node sum reproduces the global 0.5||x||^2
    (DESIGN.md section 3). With beta = ridge + tau the dual is paper
    eq. (21):

        min_{alpha in [0,C]}  1/(2 beta) ||D_i^T L alpha + tau v||^2 - alpha^T 1

    solved by coordinate descent over alpha, each pass in the order of
    decreasing projected-gradient magnitude, warm-started across outer
    iterations; w = (D_i^T L alpha + tau v) / beta. The order is a stable
    sort, as the reference's: at alpha = 0 many projected gradients tie
    at 0, and the order among ties sets the trajectory.
    """

    C: float = 1.0
    tau: float = 1.0
    cd_passes: int = 4
    eps_rel: float = 1e-3
    eps_abs: float = 1e-6

    def _local_cd(self, Dc, lc, rsq, v, alpha, beta):
        """One outer iteration's CD on every node at once; returns
        (alpha, w_primal)."""
        N, mi, n = Dc.shape
        C, tau = float(self.C), float(self.tau)
        tv = tau * v
        w = _rmatvec(Dc, lc * alpha)       # D_i^T (l * alpha)
        for _ in range(self.cd_passes):
            g = (lc * _matvec(Dc, w + tv)) / beta - 1.0
            pg = torch.where(
                alpha <= 0.0, torch.clamp(g, max=0.0),
                torch.where(alpha >= C, torch.clamp(g, min=0.0), g))
            order = greedy_order(pg)
            Do = torch.gather(Dc, 1, order[..., None].expand(N, mi, n))
            lo = torch.gather(lc, 1, order)
            qo = torch.clamp(torch.gather(rsq, 1, order) / beta, min=1e-12)
            ao = torch.gather(alpha, 1, order)
            for j in range(mi):
                dj, lj, aj = Do[:, j], lo[:, j], ao[:, j]
                gj = (lj * torch.sum(dj * (w + tv), dim=-1)) / beta - 1.0
                aj_new = torch.clamp(aj - gj / qo[:, j], 0.0, C)
                w = w + ((aj_new - aj) * lj)[:, None] * dj
                ao[:, j] = aj_new
            alpha = torch.scatter(alpha, 1, order, ao)
        return alpha, (w + tv) / beta

    def run(self, D: Tensor, labels: Tensor, iters: int) -> ConsensusResult:
        N, mi, n = D.shape
        acc = gram_lib._acc_dtype(D.dtype)
        Dc = D.to(acc)
        lc = labels.to(acc)
        tau = float(self.tau)
        beta = 1.0 / N + tau
        row_sq = torch.sum(Dc * Dc, dim=-1)   # (N, mi): ||a_k||^2 per row
        z = torch.zeros((n,), dtype=acc, device=D.device)
        u = torch.zeros((N, n), dtype=acc, device=D.device)
        alphas = torch.zeros((N, mi), dtype=acc, device=D.device)
        k_conv = torch.tensor(-1, device=D.device)
        objs, rs, ss = [], [], []
        for k in range(iters):
            v = z[None, :] - u
            alphas, xs = self._local_cd(Dc, lc, row_sq, v, alphas, beta)
            z_new = torch.mean(xs + u, dim=0)
            u_new = u + xs - z_new[None, :]
            done, r, s = _stopping(xs, z_new, u_new, tau, z, self.eps_rel,
                                   self.eps_abs)
            k_conv = _converged(k_conv, done, k)
            obj = 0.5 * torch.sum(z_new * z_new) + self.C * torch.sum(
                torch.clamp(1.0 - lc * (Dc @ z_new), min=0.0))
            objs.append(obj)
            rs.append(r)
            ss.append(s)
            z, u = z_new, u_new
        return _finish(z, iters, objs, rs, ss, self.cd_passes * mi, k_conv)
