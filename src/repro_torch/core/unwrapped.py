"""Unwrapped ADMM with transpose reduction — paper Algorithms 1 & 2; port
of ``repro/core/unwrapped.py`` (dense data).

Solves ``min_x rho/2 ||x||^2 + f(Dx)`` by splitting ``y = Dx``:

    x^{k+1} = (D^T D + (rho/tau) I)^{-1} D^T (y^k - lam^k)          (global LS)
    y^{k+1} = prox_f(D x^{k+1} + lam^k, 1/tau)                      (separable)
    lam^{k+1} = lam^k + D x^{k+1} - y^{k+1}

The per-iteration body is :mod:`repro_torch.engine`: the drivers carry
``(y, lam, d = D^T(y-lam), x)`` and call ``engine.iterate`` once per
iteration, which also yields w = D^T(y^{k+1}-y^k) and v = D^T lam^{k+1};
the other residual quantities are elementwise:

    Dx  = lam^{k+1} - lam^k + y^{k+1}
    r   = ||Dx - y^{k+1}|| = ||lam^{k+1} - lam^k||
    s   = tau ||w||,   eps_dual ~ tau ||v||

Data layout: ``D`` is ``(N, m_i, n)`` — N nodes, m_i rows each. N=1
recovers the single-node Alg. 1. ``device`` (``"cuda"`` by default) is
where the solve runs; inputs elsewhere are moved there once, and asking for
``cuda`` without a GPU raises. Sparse (``BlockCSR``) and out-of-core
drivers are ROADMAP items 6 and 7.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import gram as gram_lib
from repro_torch.core.prox import ProxLoss
from repro_torch.device import resolve_device

Tensor = torch.Tensor


class ADMMHistory(NamedTuple):
    """Per-iteration telemetry (paper Fig. 2 curves + Theorems 1/2)."""

    objective: Tensor     # f(Dx^k) (+ rho/2||x||^2)
    primal_res: Tensor    # ||D x^k - y^k||
    dual_res: Tensor      # tau * ||D^T (y^k - y^{k-1})||
    grad_sq: Tensor       # ||D^T grad f(D x^k)||^2 if f smooth else nan
    converged_at: int     # first iteration meeting Boyd's rule, or -1


class ADMMResult(NamedTuple):
    x: Tensor
    y: Tensor
    lam: Tensor
    iters: int                   # iterations actually informative
    history: Optional[ADMMHistory]


@dataclasses.dataclass(frozen=True)
class UnwrappedADMM:
    """Configured solver. ``loss`` acts on y with per-row aux (labels / b).

    ``backend`` / ``residency`` select the engine hot path (DESIGN.md
    section 8): "auto" picks the CUDA kernels for CUDA data and the
    chunked torch loop elsewhere; ``residency="bf16"`` keeps the iteration
    copy of D in bf16 (f32 accumulation)."""

    loss: ProxLoss
    tau: float = 1.0
    rho: float = 0.0              # ridge g(x) = rho/2 ||x||^2 (SVM: rho=1)
    eps_rel: float = 1e-3         # paper section 9 stopping constants
    eps_abs: float = 1e-6
    gram_block_rows: Optional[int] = None
    backend: str = "auto"         # reference | chunked | cuda | auto
    residency: Optional[str] = None   # None | "bf16" | "auto"
    device: str = "cuda"

    def __post_init__(self):
        resolve_device(self.device)

    @property
    def engine(self):
        # imported lazily: repro_torch.engine imports repro_torch.core
        from repro_torch.engine import IterationEngine
        return IterationEngine(loss=self.loss, tau=self.tau,
                               backend=self.backend,
                               residency=self.residency, device=self.device)

    def _to_device(self, a, dtype=None) -> Optional[Tensor]:
        """Inputs (tensors or numpy arrays) onto the solve's device, once."""
        if a is None:
            return None
        from repro_torch.engine.engine import reject_sparse
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        reject_sparse(a)
        return a.to(device=torch.device(self.device), dtype=dtype)

    # -- setup (Alg. 2 lines 2-3): one Gram reduction + one factorization --
    def setup(self, D) -> Tensor:
        D = self._to_device(D)
        N, mi, n = D.shape
        G, _ = self.engine.gram(D.reshape(N * mi, n),
                                block_rows=self.gram_block_rows)
        return gram_lib.gram_factor(G, ridge=self.rho / self.tau)

    # -- one iteration (Alg. 2 lines 5-8), reference-shaped API -------------
    def step(self, L: Tensor, D, aux, y, lam):
        """Single step on node-stacked arrays: d from (y, lam), the
        x-update, then the fused body. Returns (x, Dx, y', lam'), each
        node-stacked except x."""
        D, aux = self._to_device(D), self._to_device(aux)
        y, lam = self._to_device(y), self._to_device(lam)
        N, mi, n = D.shape
        eng = self.engine
        Dflat = D.reshape(N * mi, n)
        d = eng.transpose_d(Dflat, y.reshape(-1), lam.reshape(-1))
        x = gram_lib.gram_solve(L, d)
        st = eng.iterate(Dflat, aux.reshape(-1) if aux is not None else None,
                         y.reshape(-1), lam.reshape(-1), x, want_dual=False)
        Dx = st.lam - lam.reshape(-1) + st.y
        return (x, Dx.reshape(N, mi), st.y.reshape(N, mi),
                st.lam.reshape(N, mi))

    def _objective(self, x, Dx, aux_flat):
        obj = self.loss.value(Dx, aux_flat)
        if self.rho:
            obj = obj + 0.5 * self.rho * torch.sum(x * x)
        return obj

    def _init_state(self, Dflat, x0, m, n, acc):
        if x0 is not None:
            # warm start: y = D x0, so the first x-update returns
            # (D^T D + rI)^{-1} D^T D x0 — exactly x0 when rho = 0
            y = Dflat.to(acc) @ x0.to(acc)
            lam = torch.zeros((m,), dtype=acc, device=Dflat.device)
            d = self.engine.transpose_d(Dflat, y, lam)
        else:
            y = torch.zeros((m,), dtype=acc, device=Dflat.device)
            lam = torch.zeros_like(y)
            d = torch.zeros((n,), dtype=acc, device=Dflat.device)
        return y, lam, d

    # -- fixed-iteration driver with full telemetry --------------------------
    def run(self, D, aux, iters: int, x0=None, record: bool = True,
            obs=None) -> ADMMResult:
        """``iters`` iterations with per-iteration history (objective,
        residuals and the Theorem-2 gradient norm through the engine's
        streaming ``rmatvec``). No per-iteration host sync: the history
        stays on the device until the end."""
        if obs is not None:
            raise NotImplementedError("observability (repro.obs) is not "
                                      "ported yet (ROADMAP item 10)")
        D, aux, x0 = (self._to_device(D), self._to_device(aux),
                      self._to_device(x0))
        N, mi, n = D.shape
        m = N * mi
        acc = gram_lib._acc_dtype(D.dtype)
        eng = self.engine
        Dflat = D.reshape(m, n)
        L = self.setup(D)
        Dres = eng.prepare(Dflat)
        aux_f = aux.reshape(m) if aux is not None else None
        y, lam, d = self._init_state(Dflat, x0, m, n, acc)
        x = torch.zeros((n,), dtype=acc, device=Dflat.device)
        k_conv = torch.tensor(-1, device=Dflat.device)
        hist = []
        for k in range(iters):
            x = gram_lib.gram_solve(L, d)
            st = eng.iterate(Dres, aux_f, y, lam, x, want_dual=True)
            Dx = st.lam - lam + st.y
            r = torch.linalg.norm(st.lam - lam)
            s = self.tau * torch.linalg.norm(st.w)
            eps_pri = math.sqrt(m) * self.eps_abs + self.eps_rel * \
                torch.maximum(torch.linalg.norm(Dx), torch.linalg.norm(st.y))
            eps_dual = math.sqrt(n) * self.eps_abs + \
                self.eps_rel * self.tau * torch.linalg.norm(st.v)
            done = (r <= eps_pri) & (s <= eps_dual)
            k_conv = torch.where((k_conv < 0) & done,
                                 torch.tensor(k, device=k_conv.device),
                                 k_conv)
            if record:
                obj = self._objective(x, Dx, aux_f)
                if self.loss.grad is not None:
                    g = self.loss.grad(Dx, aux_f)
                    gsq = torch.sum(eng.rmatvec(Dflat, g) ** 2)
                else:
                    gsq = torch.tensor(math.nan, dtype=acc,
                                       device=Dflat.device)
                hist.append(torch.stack([obj.to(acc), r, s, gsq.to(acc)]))
            y, lam, d = st.y, st.lam, st.d
        kc = int(k_conv.item())
        history = None
        if record:
            h = torch.stack(hist).cpu() if hist else \
                torch.zeros((0, 4), dtype=acc)
            history = ADMMHistory(h[:, 0], h[:, 1], h[:, 2], h[:, 3], kc)
        iters_used = kc + 1 if kc >= 0 else iters
        return ADMMResult(x, y.reshape(N, mi), lam.reshape(N, mi),
                          iters_used, history)

    # -- early-stopping driver, deployment path -----------------------------
    def solve(self, D, aux, max_iters: int = 500, x0=None,
              record: bool = False, reg=None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0, resume: bool = False,
              obs=None) -> ADMMResult:
        """Runs through the shared executor driver (DESIGN.md section 14)
        on a :class:`repro_torch.exec.LocalExecutor`. ``reg`` (a
        :class:`repro_torch.exec.Regularizer`) switches the x-update to
        the composite prox-gradient."""
        from repro_torch.exec import LocalExecutor, solve_with_executor
        ex = LocalExecutor(self.engine, self._to_device(D),
                           aux=self._to_device(aux),
                           gram_block_rows=self.gram_block_rows)
        return solve_with_executor(
            ex, loss=self.loss, tau=self.tau, rho=self.rho,
            eps_rel=self.eps_rel, eps_abs=self.eps_abs,
            max_iters=max_iters, x0=self._to_device(x0), record=record,
            reg=reg, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume, obs=obs)

    def solve_streaming(self, store, **kwargs):
        raise NotImplementedError("the out-of-core streaming solve is not "
                                  "ported yet (ROADMAP item 7)")


def flat_to_nodes(D2: Tensor, N: int) -> Tensor:
    """(m, n) -> (N, m/N, n); m must divide evenly (pad upstream)."""
    m, n = D2.shape
    if m % N:
        raise ValueError(f"rows {m} not divisible by {N} nodes")
    return D2.reshape(N, m // N, n)
