"""LocalExecutor — device-resident data, the paper's single-node Alg. 1;
port of ``repro/exec/local.py``. Accepts node-stacked dense (N, m_i, n)
tensors or a flat :class:`~repro_torch.data.sparse.BlockCSR` (y and lam
then come back as (1, m))."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import gram as gram_lib
from repro_torch.data.sparse import BlockCSR
from repro_torch.engine.engine import reject_sparse
from repro_torch.engine.streaming import SweepResult
from repro_torch.exec.base import SolveExecutor
from repro_torch.obs import current

Tensor = torch.Tensor


class LocalExecutor(SolveExecutor):
    name = "local"
    checkpoint_kind = "local_solve"
    kind_label = "local"

    def __init__(self, engine, D: Tensor, aux: Optional[Tensor] = None,
                 gram_block_rows: Optional[int] = None):
        reject_sparse(D)
        self.engine = engine
        self.sparse = isinstance(D, BlockCSR)
        if self.sparse:
            self.m, self.n = D.shape
            self._stack = None               # y comes back as (1, m)
            self._Dflat = D
        else:
            N, mi, n = D.shape
            self.m, self.n = N * mi, n
            self._stack = (N, mi)
            self._Dflat = D.reshape(self.m, n)
        self.acc = gram_lib._acc_dtype(D.dtype)
        self.device = D.device
        self.ycols = getattr(engine.loss, "ycols", 1)
        self.backend = "sparse" if self.sparse else engine.resolve(D.dtype)
        self._aux = aux.reshape(self.m) if aux is not None else None
        self._gbr = gram_block_rows
        self._Dres = None
        self._y = None
        self._lam = None

    def _yshape(self):
        return (self.m,) if self.ycols == 1 else (self.m, self.ycols)

    def setup(self) -> Tensor:
        G, _ = self.engine.gram(self._Dflat, block_rows=self._gbr)
        self._Dres = self.engine.prepare(self._Dflat)
        return G

    def init(self, x0: Optional[Tensor]) -> Tensor:
        if x0 is None:
            self._y = torch.zeros(self._yshape(), dtype=self.acc,
                                  device=self.device)
            self._lam = torch.zeros_like(self._y)
            return self.zero_x()
        # warm start: y = D x0, lam = 0, d = D^T(y - lam) — one extra
        # setup-time pass
        if self.sparse:
            from repro_torch.kernels.spgram import ops as spgram_ops
            y = spgram_ops.matvec(self._Dflat, x0.to(self.acc))
        else:
            y = self._Dflat.to(self.acc) @ x0.to(self.acc)
        self._y = y
        self._lam = torch.zeros_like(y)
        return self.engine.transpose_d(self._Dflat, y, self._lam)

    def sweep(self, x: Tensor, k: int) -> SweepResult:
        self._y, self._lam, sw = fused_step(
            self.engine, self._Dres, self._aux, self._y, self._lam, x)
        return sw

    # -- checkpointing (driver-owned cadence) -------------------------------
    def state_arrays(self, k: int) -> dict:
        return {"y": self._y, "lam": self._lam}

    def restore_state(self, k: int, tree: dict) -> Tensor:
        self._y = tree["y"].to(device=self.device, dtype=self.acc)
        self._lam = tree["lam"].to(device=self.device, dtype=self.acc)
        return tree["d"].to(self.device)

    def final_iterates(self):
        if self._stack is None:
            return self._y[None], self._lam[None]
        N, mi = self._stack
        shape = (N, mi) + tuple(self._y.shape[1:])
        return self._y.reshape(shape), self._lam.reshape(shape)


def fused_step(engine, D, aux, y, lam, x):
    """``(D, aux, y, lam, x) -> (y', lam', SweepResult)``: the engine's
    fused body followed by the stopping-rule scalars (all on the device;
    ``solve_with_executor`` brings them to the host in one transfer).
    The scalars' passes over the m-vectors open the span ``stop_terms``
    in the process's current :class:`~repro_torch.obs.Observability`."""
    st = engine.iterate(D, aux, y, lam, x, want_dual=True)
    with current().tracer.iter_span("stop_terms"):
        Dx = st.lam - lam + st.y
        sw = SweepResult(
            st.d, st.w, st.v,
            torch.sum((st.lam - lam) ** 2), torch.sum(Dx * Dx),
            torch.sum(st.y * st.y), engine.loss.value(Dx, aux))
    return st.y, st.lam, sw
