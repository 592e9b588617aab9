"""The iteration engine — the one place solver iteration bodies live; port
of ``repro/engine/engine.py``.

Backends (DESIGN.md section 8):

  * ``cuda``       — the hand-written kernels: the fused iteration
                     (``kernels/admm_iter``, K3) reads D once per iteration
                     for Dx, the prox, the lam-update and all three
                     transpose reductions d = D^T(y'-lam'), w = D^T(y'-y),
                     v = D^T lam'; the Gram setup is K2
                     (``kernels/gram``). Takes the place of ``pallas``; the
                     reference's ``pallas_interpret`` has no counterpart
                     (on a CPU tensor each kernel wrapper runs its plain
                     version).
  * ``chunked``    — a Python loop of torch ops over row blocks with the
                     same one-pass body; each block is upcast alone.
  * ``sparse``     — padded block-CSR data (``data/sparse.BlockCSR``): the
                     O(nnz) body, gather-based Dx and gather-based d/w/v
                     over each block's local CSC (``kernels/spgram``; on
                     the card the kernel K6, ``csrc/spgram.cu``, for the
                     kernel prox kinds with f32 or bf16 values, the torch
                     body otherwise). Selected by the DATA TYPE: a
                     ``BlockCSR`` takes this path under every backend but
                     an explicit ``reference``, which densifies (the parity
                     oracle); dense data under ``"sparse"`` resolve to the
                     device default, as in the reference.
  * ``reference``  — the textbook two-pass oracle (Dx pass, then a D^T
                     pass).

``auto`` resolves by the device of D (CUDA -> cuda, else chunked), then
falls back by capability: cuda needs a kernel prox kind (logistic / hinge
/ l1 / least_squares / quantile) and f32 or bf16 rows, else chunked;
chunked needs a coordinatewise prox, else reference. ``residency="bf16"``
keeps the iteration copy of D in bf16 with f32 accumulation;
``residency="auto"`` resolves to bf16 only on the cuda backend, as the
reference resolved it only on the real-TPU pallas backend. Whether bf16 is
a win on the card is for ``chip_smoke.py``'s numbers to show. A
``BlockCSR`` casts its values only; its indices stay int32.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import gram as gram_lib
from repro_torch.core.prox import ProxLoss
from repro_torch.data.sparse import BlockCSR
from repro_torch.device import resolve_device
from repro_torch.engine import autotune
from repro_torch.kernels.admm_iter import ops as iter_ops
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.spgram import ops as spgram_ops
from repro_torch.kernels.spgram import spgram

Tensor = torch.Tensor

BACKENDS = ("reference", "chunked", "sparse", "cuda")

# Prox kinds the fused CUDA iteration kernel evaluates in registers
# (the reference's PALLAS_KINDS).
KERNEL_KINDS = frozenset(
    {"logistic", "hinge", "l1", "least_squares", "quantile"})
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

RESIDENCY_DTYPES = {None: None, "bf16": torch.bfloat16, "auto": "auto"}


class EngineStep(NamedTuple):
    """One fused iteration: updated iterates plus the n-vector reductions
    accumulated in the same pass over D. The w/v differences are formed
    row-wise BEFORE reducing (differencing accumulated D^T y across
    iterations cancels catastrophically near convergence)."""

    y: Tensor            # y^{k+1} = prox_f(Dx + lam)
    lam: Tensor          # lam^{k+1} = lam + Dx - y^{k+1}
    d: Tensor            # D^T(y^{k+1} - lam^{k+1}) — next x-update RHS
    w: Optional[Tensor]  # D^T(y^{k+1} - y^k) — Boyd dual residual
    v: Optional[Tensor]  # D^T lam^{k+1} — dual tolerance


def default_backend(device) -> str:
    return "cuda" if torch.device(device).type == "cuda" else "chunked"


def reject_sparse(D):
    """Raise for data the engine does not take: torch's own sparse layouts
    (sparse data go in as a ``BlockCSR``) and anything but a tensor or a
    ``BlockCSR``."""
    if isinstance(D, BlockCSR):
        return
    if not isinstance(D, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor or a BlockCSR, got "
                        f"{type(D).__name__}")
    if D.layout != torch.strided:
        raise TypeError(f"torch's {D.layout} layout is not taken; build a "
                        "BlockCSR (repro_torch.data.sparse) for sparse data")


def gram_stats(D: Tensor, b: Optional[Tensor] = None, *,
               backend: str = "auto",
               block_rows: Optional[int] = None
               ) -> Tuple[Tensor, Optional[Tensor]]:
    """Backend-dispatched (D^T D, D^T b) in one streaming pass (paper
    section 4). ``b`` may be None (Gram only), (m,) or (m, r); returns
    (G, c) with c None iff b is None."""
    reject_sparse(D)
    if isinstance(D, BlockCSR):
        if backend == "reference":
            # the parity oracle: densify, then the textbook dense Gram
            Dd = D.to_dense()
            return gram_lib.gram(Dd), \
                None if b is None else gram_lib.gram_rhs(Dd, b)
        # the Gram on the host (scipy), the RHS by the CSC gather
        return spgram_ops.sparse_gram_rhs(D, b)
    if backend in ("auto", "sparse"):
        backend = default_backend(D.device)
    m, n = D.shape
    if backend == "cuda" and D.dtype not in KERNEL_DTYPES:
        backend = "chunked"          # the kernels take f32 / bf16 only
    if backend == "cuda":
        if b is None:
            return gram_ops.gram(D), None
        return gram_ops.gram_and_rhs(D, b)
    if backend == "chunked":
        br = block_rows or autotune.chunked_block_rows(m, n, D.dtype,
                                                       D.device)
        if b is None:
            return gram_lib.gram_chunked(D, br), None
        return gram_lib.gram_and_rhs_chunked(D, b, br)
    if backend == "reference":
        if b is None:
            return gram_lib.gram(D), None
        return gram_lib.gram(D), gram_lib.gram_rhs(D, b)
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS + ('auto',)}")


@dataclasses.dataclass(frozen=True)
class IterationEngine:
    """Per-device fused iteration body for unwrapped ADMM (paper Alg. 2
    lines 5-8 plus both telemetry reductions) on flat local data: D
    (m, n), aux/y/lam (m,), x (n,).

    ``device`` is where the engine computes: ``"cuda"`` by default, which
    raises at construction on a machine without a GPU. The engine never
    moves data by itself except in :meth:`prepare`; a tensor on another
    device raises."""

    loss: ProxLoss
    tau: float = 1.0
    backend: str = "auto"
    block_m: Optional[int] = None          # chunked row block; None: tuned
    residency: Optional[str] = None        # None | "bf16" | "auto"
    device: str = "cuda"

    def __post_init__(self):
        if self.backend not in BACKENDS + ("auto",):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.residency not in RESIDENCY_DTYPES:
            raise ValueError(f"unknown residency {self.residency!r}")
        resolve_device(self.device)

    @property
    def delta(self) -> float:
        return 1.0 / self.tau

    @property
    def dev(self) -> torch.device:
        return torch.device(self.device)

    # -- backend selection (rules documented in DESIGN.md section 8) -----
    def resolve(self, dtype=torch.float32) -> str:
        """The backend of dense data (a ``BlockCSR`` takes the sparse body
        whatever this says, unless the engine asks for ``reference``)."""
        b = default_backend(self.dev) if self.backend in ("auto", "sparse") \
            else self.backend
        if b == "cuda" and (self.loss.name not in KERNEL_KINDS
                            or dtype not in KERNEL_DTYPES):
            b = "chunked"
        if b == "chunked" and not self.loss.coordinatewise:
            b = "reference"
        return b

    def resolve_residency(self, dtype=torch.float32) -> Optional[str]:
        """Explicit settings are honored as-is; ``"auto"`` casts to bf16
        only on the cuda backend."""
        if self.residency != "auto":
            return self.residency
        return "bf16" if self.resolve(dtype) == "cuda" else None

    def _check(self, D):
        reject_sparse(D)
        if D.device.type != self.dev.type:
            raise ValueError(f"D is on {D.device} but the engine computes "
                             f"on {self.dev}; move it with prepare()")

    # -- data residency ---------------------------------------------------
    def prepare(self, D: Tensor) -> Tensor:
        """Move D to the engine's device and cast it ONCE to its
        iteration-residency dtype (bf16 halves the per-iteration bytes;
        accumulation stays f32). A ``BlockCSR`` casts its values only."""
        reject_sparse(D)
        D = D.to(self.dev)
        dt = RESIDENCY_DTYPES[self.resolve_residency(D.dtype)]
        if dt is None or D.dtype == dt:
            return D
        return D.astype(dt) if isinstance(D, BlockCSR) else D.to(dt)

    # -- setup: Gram (+ RHS) in one data pass -----------------------------
    def gram(self, D: Tensor, b: Optional[Tensor] = None,
             block_rows: Optional[int] = None):
        self._check(D)
        backend = self._gram_backend()
        if isinstance(D, BlockCSR) and self.backend == "reference":
            # the densify oracle stays reachable for the sparse Gram too
            backend = "reference"
        return gram_stats(D, b, backend=backend, block_rows=block_rows)

    def _gram_backend(self) -> str:
        b = default_backend(self.dev) if self.backend == "auto" \
            else self.backend
        return "chunked" if b == "reference" else b

    # -- transpose application: D^T u without a dense upcast --------------
    def rmatvec(self, D: Tensor, u: Tensor) -> Tensor:
        """D^T u in accumulation precision. The dense ``gram_rhs`` upcasts
        ALL of D at once, which would materialize a full f32 copy of a
        bf16-resident D; the streaming-class backends (chunked, cuda)
        upcast one block at a time; a ``BlockCSR`` gathers over its local
        CSC. ``u`` may be (m,) or (m, r)."""
        self._check(D)
        if isinstance(D, BlockCSR):
            return spgram_ops.rmatvec(D, u)
        b = default_backend(self.dev) if self.backend == "auto" \
            else self.backend
        if b == "reference":
            return gram_lib.gram_rhs(D, u)
        m, n = D.shape
        br = self.block_m or autotune.chunked_block_rows(m, n, D.dtype,
                                                         D.device)
        return gram_lib.gram_rhs_chunked(D, u, br)

    # -- warm-start init: d from existing iterates, one pass --------------
    def transpose_d(self, D: Tensor, y: Tensor, lam: Tensor) -> Tensor:
        """d = D^T(y - lam) — setup-time only (cold starts get zeros)."""
        return self.rmatvec(D, y - lam)

    # -- the fused iteration body -----------------------------------------
    def iterate(self, D: Tensor, aux: Optional[Tensor], y: Tensor,
                lam: Tensor, x: Tensor, want_dual: bool = True
                ) -> EngineStep:
        """Given x^{k+1}: stream D once, producing y^{k+1}, lam^{k+1} and
        the reductions that drive iteration k+2 and the stopping rule.
        ``D`` is a dense (m, n) tensor or a :class:`BlockCSR`."""
        self._check(D)
        if isinstance(D, BlockCSR):
            if self.backend == "reference":
                return self._iterate_reference(D.to_dense(), aux, y, lam,
                                               x, want_dual)
            return self._iterate_sparse(D, aux, y, lam, x, want_dual)
        backend = self.resolve(D.dtype)
        if (backend == "chunked" and self.backend == "auto"
                and D.numel() * D.element_size()
                <= 16 * autotune.CACHE_BUDGET):
            # small-D rule of the reference: once D fits in last-level
            # cache the two-pass body re-reads it for free
            backend = "reference"
        if backend == "cuda":
            return self._iterate_cuda(D, aux, y, lam, x, want_dual)
        if backend == "chunked":
            return self._iterate_chunked(D, aux, y, lam, x, want_dual)
        return self._iterate_reference(D, aux, y, lam, x, want_dual)

    def _iterate_reference(self, D, aux, y, lam, x, want_dual):
        acc = gram_lib._acc_dtype(D.dtype)
        Df = D.to(acc)
        Dx = Df @ x.to(acc)
        y_new = self.loss.prox(Dx + lam, self.delta, aux)
        lam_new = lam + Dx - y_new
        if want_dual:
            if y_new.dim() > 1:
                # matrix iterates (m, K): three multi-RHS products
                DfT = Df.T
                return EngineStep(y_new, lam_new, DfT @ (y_new - lam_new),
                                  DfT @ (y_new - y), DfT @ lam_new)
            dwv = Df.T @ torch.stack([y_new - lam_new, y_new - y, lam_new],
                                     dim=1)
            return EngineStep(y_new, lam_new, dwv[:, 0], dwv[:, 1],
                              dwv[:, 2])
        return EngineStep(y_new, lam_new, Df.T @ (y_new - lam_new),
                          None, None)

    def _iterate_chunked(self, D, aux, y, lam, x, want_dual):
        m, n = D.shape
        acc = gram_lib._acc_dtype(D.dtype)
        br = self.block_m or autotune.chunked_block_rows(m, n, D.dtype,
                                                         D.device)
        xc = x.to(acc)
        y_new = torch.empty((m,), dtype=acc, device=D.device)
        lam_new = torch.empty_like(y_new)
        d = torch.zeros((n,), dtype=acc, device=D.device)
        w = torch.zeros_like(d)
        v = torch.zeros_like(d)
        for s in range(0, m, br):
            e = min(m, s + br)
            Db = D[s:e].to(acc)
            lb = lam[s:e]
            ab = aux[s:e] if aux is not None else None
            Dx = Db @ xc
            y_b = self.loss.prox(Dx + lb, self.delta, ab)
            l_b = lb + Dx - y_b
            y_new[s:e] = y_b
            lam_new[s:e] = l_b
            d = d + (y_b - l_b) @ Db
            if want_dual:
                w = w + (y_b - y[s:e]) @ Db
                v = v + l_b @ Db
        return EngineStep(y_new, lam_new, d, w if want_dual else None,
                          v if want_dual else None)

    def _iterate_cuda(self, D, aux, y, lam, x, want_dual):
        y_new, lam_new, d, w, v = iter_ops.admm_iter_full(
            D, aux, y, lam, x, kind=self.loss.name,
            delta=self.loss.kernel_delta_scale * self.delta,
            param=self.loss.kernel_param)
        return EngineStep(y_new, lam_new, d, w if want_dual else None,
                          v if want_dual else None)

    def _iterate_sparse(self, D: BlockCSR, aux, y, lam, x, want_dual):
        """O(nnz) fused body: K6 where the dense path would take the cuda
        backend (the card, a kernel prox kind, f32 or bf16 values), the
        torch body (``spgram.sparse_iterate``) otherwise."""
        if self.resolve(D.dtype) == "cuda":
            out = spgram_ops.sparse_admm_iter_full(
                D, aux, y, lam, x, kind=self.loss.name,
                delta=self.loss.kernel_delta_scale * self.delta,
                param=self.loss.kernel_param, want_dual=want_dual)
        else:
            out = spgram.sparse_iterate(self.loss, self.delta, D, aux, y,
                                        lam, x, want_dual=want_dual)
        return EngineStep(*out)

    # -- host-loop step ---------------------------------------------------
    def make_step(self, D: Tensor, aux: Optional[Tensor], L: Tensor):
        """``step(y, lam, d) -> (y', lam', d', x)`` closing over the
        prepared data and Gram factor — for host-driven loops (serving,
        benchmarks)."""
        Dres = self.prepare(D)

        def step(y, lam, d):
            x = gram_lib.gram_solve(L, d)
            st = self.iterate(Dres, aux, y, lam, x, want_dual=False)
            return st.y, st.lam, st.d, x

        return step
