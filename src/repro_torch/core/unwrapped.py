"""Unwrapped ADMM with transpose reduction — paper Algorithms 1 & 2; port
of ``repro/core/unwrapped.py``.

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
recovers the single-node Alg. 1. ``D`` may also be a flat
:class:`~repro_torch.data.sparse.BlockCSR`: the same drivers run over the
engine's sparse body (K6 on the card), with the Gram set up on the host,
and y / lam come back as (1, m). ``device`` (``"cuda"`` by default) is
where the solve runs; inputs elsewhere are moved there once, and asking for
``cuda`` without a GPU raises. ``solve_streaming`` is the out-of-core
driver over a host block store (``engine/streaming.py``). Every driver
takes ``obs`` (:class:`repro_torch.obs.Observability`), handled outside
the iteration loop as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import gram as gram_lib
from repro_torch.core.prox import ProxLoss
from repro_torch.data.sparse import BlockCSR
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
        """Inputs (tensors, numpy arrays or a BlockCSR) onto the solve's
        device, once."""
        if a is None:
            return None
        from repro_torch.engine.engine import reject_sparse
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        reject_sparse(a)
        if isinstance(a, BlockCSR):
            return a.to(self.device)
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
        stays on the device until the end. ``D`` is node-stacked dense
        (N, m_i, n) or a flat :class:`BlockCSR` (y / lam come back as
        (1, m)).

        ``obs`` is handled entirely OUTSIDE the loop: one span around it
        (closed after a sync, so it reads device time), then the recorded
        history is streamed to the telemetry sink."""
        if obs is None or not obs.enabled:
            return self._run(D, aux, iters, x0, record)
        with obs.span("admm_run", iters=iters,
                      sparse=isinstance(D, BlockCSR)):
            res = self._run(D, aux, iters, x0, record)
            if res.x.device.type == "cuda":
                torch.cuda.synchronize(res.x.device)
        obs.inc("admm.runs")
        if res.history is not None:
            obs.write_history(res.history, tau=self.tau, rho=self.rho)
        return res

    def _run(self, D, aux, iters, x0, record) -> ADMMResult:
        D, aux, x0 = (self._to_device(D), self._to_device(aux),
                      self._to_device(x0))
        if isinstance(D, BlockCSR):
            return self._run_sparse(D, aux, iters, x0=x0, record=record)
        N, mi, n = D.shape
        m = N * mi
        Dflat = D.reshape(m, n)
        L = self.setup(D)
        y, lam, d = self._init_state(Dflat, x0, m, n,
                                     gram_lib._acc_dtype(D.dtype))
        res = self._run_loop(Dflat, aux, L, y, lam, d, iters, record)
        return res._replace(y=res.y.reshape(N, mi), lam=res.lam.reshape(N, mi))

    def _run_loop(self, Dflat, aux, L, y, lam, d, iters, record):
        """The fixed-iteration loop of ``run`` over flat data (dense (m, n)
        or a BlockCSR) from the factor L and the state (y, lam, d); y and
        lam come back flat."""
        m, n = Dflat.shape
        acc = gram_lib._acc_dtype(Dflat.dtype)
        eng = self.engine
        Dres = eng.prepare(Dflat)
        aux_f = aux.reshape(m) if aux is not None else None
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
        return ADMMResult(x, y, lam, iters_used, history)

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

        def _drive(obs_arg):
            return solve_with_executor(
                ex, loss=self.loss, tau=self.tau, rho=self.rho,
                eps_rel=self.eps_rel, eps_abs=self.eps_abs,
                max_iters=max_iters, x0=self._to_device(x0), record=record,
                reg=reg, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume,
                obs=obs_arg)

        if obs is None or not obs.enabled:
            return _drive(None)
        with obs.span("admm_solve", max_iters=max_iters,
                      sparse=isinstance(D, BlockCSR)):
            res = _drive(obs)
            if res.x.device.type == "cuda":
                torch.cuda.synchronize(res.x.device)
        obs.inc("admm.solves")
        obs.record(event="solve_done", iters=int(res.iters),
                   tau=self.tau, rho=self.rho)
        return res

    # -- out-of-core driver: D streams from a host/disk block store --------
    def solve_streaming(
        self, store, max_iters: int = 500, x0=None, record: bool = False,
        overlap: bool = True, prefetch: int = 2,
        device_dtype: Optional[str] = None,
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
        resume: bool = False, obs=None,
    ) -> ADMMResult:
        """``solve`` for data that does not fit device memory: ``store``
        is a :class:`repro_torch.data.store.ShardedMatrixStore` (host RAM
        or memory-mapped) and every pass — Gram setup, each iteration's
        fused body — streams row blocks through pinned staging slots and a
        copy stream, overlapped with the compute (DESIGN.md section 9). The
        m-sized iterates (y, lam) stay on the host, so device memory is
        bounded by a few blocks regardless of m. Same stopping rule and
        warm-start semantics as ``solve``; ``overlap=False`` degrades to
        the naive synchronous transfer loop (the benchmark baseline);
        ``device_dtype`` casts the blocks at staging time.

        ``checkpoint_dir`` + ``checkpoint_every=K`` persist the loop state
        (x, y, lam, d, iter) every K iterations through
        :class:`repro_torch.checkpoint.CheckpointManager`; ``resume=True``
        restores the newest step and continues bitwise after a kill (the
        checkpoint refuses to resume against a store with a different
        content fingerprint).
        """
        from repro_torch.engine.streaming import solve_streaming as _solve
        return _solve(self, store, max_iters=max_iters,
                      x0=self._to_device(x0), record=record,
                      overlap=overlap, prefetch=prefetch,
                      device_dtype=device_dtype,
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every, resume=resume,
                      obs=obs)

    # -- sparse drivers: the same loop over a BlockCSR -----------------------
    # The sparse Gram is a HOST pass (scipy's CSR matmul,
    # kernels/spgram/ops.py); the per-iteration body, stopping rule,
    # telemetry and warm start are the dense drivers' own, through the
    # engine's sparse body.

    def _sparse_setup(self, D: BlockCSR) -> Tensor:
        G, _ = self.engine.gram(D)
        return gram_lib.gram_factor(G, ridge=self.rho / self.tau)

    def _sparse_init(self, D: BlockCSR, x0, m, n, acc):
        from repro_torch.kernels.spgram import ops as spgram_ops
        if x0 is not None:
            y = spgram_ops.matvec(D, x0.to(acc))
            lam = torch.zeros((m,), dtype=acc, device=D.device)
            d = self.engine.transpose_d(D, y, lam)
        else:
            y = torch.zeros((m,), dtype=acc, device=D.device)
            lam = torch.zeros_like(y)
            d = torch.zeros((n,), dtype=acc, device=D.device)
        return y, lam, d

    def _run_sparse(self, D: BlockCSR, aux, iters, x0=None, record=True):
        m, n = D.shape
        L = self._sparse_setup(D)
        y, lam, d = self._sparse_init(D, x0, m, n,
                                      gram_lib._acc_dtype(D.dtype))
        res = self._run_loop(D, aux, L, y, lam, d, iters, record)
        return res._replace(y=res.y[None], lam=res.lam[None])


def sparse_unwrapped_lasso_matrices(D, b, mu: float):
    """The stacked operator D_hat = [I; D] of the sparse fit
    min mu|x| + f(Dx) (paper section 7, eq. 15), the identity block
    standing for a dedicated "node" N+1, as one flat (n + N m_i, n)
    tensor; ``b`` and ``mu`` belong to the caller's StackedProx."""
    N, mi, n = D.shape
    Dflat = D.reshape(N * mi, n)
    return torch.cat([torch.eye(n, dtype=D.dtype, device=D.device), Dflat],
                     dim=0)


def flat_to_nodes(D2: Tensor, N: int) -> Tensor:
    """(m, n) -> (N, m/N, n); m must divide evenly (pad upstream)."""
    m, n = D2.shape
    if m % N:
        raise ValueError(f"rows {m} not divisible by {N} nodes")
    return D2.reshape(N, m // N, n)
