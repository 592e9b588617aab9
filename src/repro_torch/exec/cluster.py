"""ClusterExecutor — worker processes behind the fault-tolerant runtime;
port of ``repro/exec/cluster.py``.

Reduces ``ClusterCoordinator.solve``'s hand-rolled loop to the three
executor primitives: the setup stats-reduce, the warm-start base-state
shipment, and one broadcast-collect round per sweep (joins, chaos,
recovery and degradation all live INSIDE the sweep — the driver only
sees a SweepResult or None). Everything coordinator-flavored that the
other topologies also need (stopping rule, checkpoint cadence, history)
lives in the shared driver.

Wire format note: Contributions carry strictly flat numpy f32
n-vectors. For multi-column iterates (multinomial, ycols=K) the workers
ravel their (n, K) reductions to (n*K,) and this executor folds them back
— the tree reduce, int8 compression and row accounting never learn about
K. The reduced vectors become tensors on the coordinator's device here,
where the driver's x-update runs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import on_device
from repro_torch.engine.streaming import SweepResult
from repro_torch.exec.base import SolveExecutor

Tensor = torch.Tensor


class ClusterExecutor(SolveExecutor):
    name = "cluster"
    checkpoint_kind = "cluster_solve"
    kind_label = "cluster"
    restore_fallback = True              # a relaunched coordinator must
    # survive one corrupt newest step when an older intact one exists

    def __init__(self, coord):
        from repro_torch.cluster.coordinator import ClusterError
        self.error_cls = ClusterError
        self.coord = coord
        self.m, self.n = coord.store.m, coord.store.n
        self.ycols = getattr(coord.loss, "ycols", 1)
        self.backend = coord.cfg.backend
        self.device = coord.dev
        self.converged = False
        self._prev_wire = (coord.counter.snapshot()
                           if coord.obs.enabled else None)
        self._wire_delta = {}
        if coord.cfg.staleness > 0:
            coord._latest = {}

    def _dev(self, flat: np.ndarray) -> Tensor:
        v = torch.from_numpy(np.asarray(flat, np.float32))
        if self.ycols != 1:
            v = v.reshape(self.n, self.ycols)
        return v.to(self.device)

    def setup(self) -> Tensor:
        with self.coord.obs.span("stats_reduce"):
            return self.coord.stats().G

    def init(self, x0) -> Tensor:
        if x0 is None:
            return self.zero_x()
        # warm start = a zero-length resume: ship (y=Dx0, lam=0) as the
        # recovery base at iteration 0, force-overwriting worker state.
        # One streaming pass over the coordinator's own store replica
        # computes the base — n-vectors aside, nothing crosses the wire
        # that a checkpoint restore wouldn't.
        from repro_torch.engine import IterationEngine
        from repro_torch.engine.streaming import StreamingEngine
        coord = self.coord
        eng = StreamingEngine(engine=IterationEngine(
            loss=coord.loss, tau=coord.tau, backend="reference",
            device=str(self.device)))
        shape = ((self.m,) if self.ycols == 1 else (self.m, self.ycols))
        y = np.zeros(shape, np.float32)
        x0 = on_device(x0, self.device).to(torch.float32)
        d = eng.init_from_x0(coord.store, x0, y)
        coord._base_iter = 0
        coord._base_y = y
        coord._base_lam = np.zeros(shape, np.float32)
        coord._x_hist = []
        for w in coord.members.alive():
            coord._send_assign(w.wid, sorted(w.blocks), upto_iter=0,
                               force=True)
        return d

    def sweep(self, x: Tensor, k: int) -> Optional[SweepResult]:
        coord = self.coord
        # membership grows only at iteration boundaries: spawn any
        # chaos-scheduled joiners, then fold completed registrations in
        # (rebalance + epoch bump) before broadcasting k
        coord._spawn_due_joins(k)
        coord._apply_joins()
        if coord._coord_injector is not None:
            coord._coord_injector.set_iteration(k)
        x_np = x.detach().cpu().numpy().astype(np.float32)
        assert len(coord._x_hist) == k - 1 - coord._base_iter
        coord._x_hist.append(x_np)
        coord._broadcast_iter(k, x_np)
        with coord.obs.span("collect", k=k):
            total = (coord._collect_stale(k) if coord.cfg.staleness > 0
                     else coord._collect_strict(k, x_np))
        if total is None:
            # DegradePolicy exhausted: stop with the best-so-far x (the
            # newest broadcast) instead of hanging forever
            coord._status = "degraded"
            self.status = "degraded"
            return None
        coord._close_recovery(k)
        if coord.obs.enabled:
            wire = coord.counter.snapshot()
            prev = self._prev_wire
            tx = {t: v - prev["sent_bytes"].get(t, 0)
                  for t, v in wire["sent_bytes"].items()}
            rx = {t: v - prev["received_bytes"].get(t, 0)
                  for t, v in wire["received_bytes"].items()}
            self._prev_wire = wire
            self._wire_delta = {
                "tx_bytes": {t: v for t, v in tx.items() if v},
                "rx_bytes": {t: v for t, v in rx.items() if v}}
        sc = total.scalars
        scalars = torch.tensor([sc["r_sq"], sc["dx_sq"], sc["y_sq"],
                                sc["obj"]], dtype=torch.float32,
                               device=self.device)
        return SweepResult(self._dev(total.d), self._dev(total.w),
                           self._dev(total.v), *scalars)

    def pad_objective(self) -> float:
        return self.coord._pad_objective()

    def extra_record(self) -> dict:
        return dict(self._wire_delta)

    def finish(self, iters: int, converged: bool):
        self.converged = converged
        coord = self.coord
        coord._iters_run += iters - self.resume_iter
        if coord._status != "degraded":
            coord._status = "converged" if converged else "max_iters"

    # -- checkpointing ------------------------------------------------------
    def state_like(self) -> dict:
        like = super().state_like()
        # the m-sized iterates are assembled on the host from the workers'
        # slices and go back to them from there
        like["y"] = torch.zeros(like["y"].shape, dtype=self.acc)
        like["lam"] = torch.zeros(like["lam"].shape, dtype=self.acc)
        return like

    def checkpoint_extra(self) -> dict:
        coord = self.coord
        return {"loss": coord.loss_spec, "tau": coord.tau,
                "rho": coord.rho,
                "store_fingerprint": coord.store.fingerprint}

    def verify_checkpoint(self, extra: dict):
        if extra.get("store_fingerprint") != self.coord.store.fingerprint:
            raise self.error_cls("checkpoint belongs to a different store")

    def state_arrays(self, k: int) -> Optional[dict]:
        got = self.coord._gather_iterates(k)
        if got is None:
            return None                  # membership raced; next interval
        y, lam = got
        return {"y": y, "lam": lam}

    def on_checkpointed(self, k: int, state: dict):
        # the checkpoint is also the new recovery base: replays start
        # here, and the x-history before it can be dropped
        coord = self.coord
        coord._base_iter = k
        coord._base_y = np.asarray(state["y"], np.float32)
        coord._base_lam = np.asarray(state["lam"], np.float32)
        coord._x_hist = []

    def restore_state(self, k: int, tree: dict) -> Tensor:
        coord = self.coord
        coord._base_iter = k
        coord._base_y = tree["y"].numpy().astype(np.float32)
        coord._base_lam = tree["lam"].numpy().astype(np.float32)
        coord._x_hist = []
        for w in coord.members.alive():
            coord._send_assign(w.wid, sorted(w.blocks), upto_iter=k,
                               force=True)
        return tree["d"].to(device=self.device, dtype=torch.float32)

    def final_iterates(self):
        # the coordinator never holds full (y, lam); gathering them for
        # the result would cost a round — expose the empty node-stacked
        # convention instead (ClusterResult never carried them either)
        shape = ((0, self.m) if self.ycols == 1
                 else (0, self.m, self.ycols))
        return torch.zeros(shape), torch.zeros(shape)
