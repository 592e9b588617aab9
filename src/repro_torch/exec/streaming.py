"""StreamingExecutor — out-of-core data behind a ShardedMatrixStore; port
of ``repro/exec/streaming.py``.

The out-of-core solve reduced to its three primitives: the Gram over the
store blocks, the warm-start init and the pipelined fused sweep
(``engine/streaming.py``) — everything else (stopping rule, checkpoint
cadence) is the shared driver's. The m-sized iterates live on the host
(pinned when the engine computes on the card). The checkpoint is bound to
the store's content fingerprint and restored BITWISE (the restored state
is exactly the live state, so the remaining iterations replay the same
operations).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.data.store import ShardedMatrixStore
from repro_torch.engine.streaming import StreamingEngine, SweepResult
from repro_torch.exec.base import SolveExecutor

Tensor = torch.Tensor


class StreamingExecutor(SolveExecutor):
    name = "streaming"
    checkpoint_kind = "streaming_solve"
    kind_label = "streaming"

    def __init__(self, engine, store: ShardedMatrixStore,
                 overlap: bool = True, prefetch: int = 2,
                 device_dtype: Optional[str] = None):
        self.engine = engine
        self.store = store
        self.m, self.n = store.m, store.n
        self.ycols = getattr(engine.loss, "ycols", 1)
        self.overlap = overlap
        self.seng = StreamingEngine(engine=engine,
                                    prefetch=prefetch if overlap else 0,
                                    device_dtype=device_dtype)
        res = self.seng.residency_dtype(store)
        self.backend = "sparse" if store.sparse else engine.resolve(res)
        self.acc = self.seng.acc_dtype(store)
        self.device = engine.dev
        shape = (self.m,) if self.ycols == 1 else (self.m, self.ycols)
        self._y = self.seng.host_buffer(shape, self.acc)
        self._lam = self.seng.host_buffer(shape, self.acc)

    def setup(self) -> Tensor:
        return self.seng.gram_from_store(self.store)

    def init(self, x0: Optional[Tensor]) -> Tensor:
        if x0 is None:
            return self.zero_x()
        return self.seng.init_from_x0(self.store, x0.to(self.acc), self._y)

    def sweep(self, x: Tensor, k: int) -> SweepResult:
        return self.seng.sweep(self.store, x, self._y, self._lam,
                               overlap=self.overlap)

    def pad_objective(self) -> float:
        return self.seng.pad_objective(self.store)

    # -- checkpointing ------------------------------------------------------
    def state_like(self) -> dict:
        like = super().state_like()
        like["y"], like["lam"] = self._y, self._lam    # host-resident
        return like

    def checkpoint_extra(self) -> dict:
        return {"store_fingerprint": self.store.fingerprint}

    def verify_checkpoint(self, extra: dict):
        if extra.get("store_fingerprint") != self.store.fingerprint:
            raise ValueError(
                "checkpoint was written against a different store "
                "(content fingerprint mismatch)")

    def restore_state(self, k: int, tree: dict) -> Tensor:
        self._y.copy_(tree["y"])
        self._lam.copy_(tree["lam"])
        return tree["d"].to(self.device)

    def state_arrays(self, k: int) -> dict:
        # every sweep has synchronised its write-backs before returning
        return {"y": self._y, "lam": self._lam}

    def final_iterates(self):
        return self._y[None], self._lam[None]
