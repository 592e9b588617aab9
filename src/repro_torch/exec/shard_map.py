"""ShardMapExecutor — paper Alg. 2 over the ranks of a process group,
paced by the shared driver; port of ``repro/exec/shard_map.py``.

Every rank runs ``solve_with_executor`` on its own executor. D's rows are
sharded over the ranks (zero-padded to a multiple of the world size:
zero rows contribute nothing to any reduction); y, lam and the EF error
live on their rank. Each rank runs the Gram (K2a on the card) once on its
rows and the fused iteration (K3) once per iteration; what crosses
between the ranks is one all-gather a sweep of the packed (3n + 4)
vector (d, w, v, r_sq, dx_sq, y_sq, obj), summed in rank order on every
rank — the reference's seven psums in one collective. x therefore comes
out bitwise equal on every rank, and so do the driver's stopping decisions
(a rank that stopped alone would leave the others waiting in the next
collective). With ``compress`` d goes through the int8 error-feedback
all-reduce instead, and the packed vector carries the rest; matrix-valued
d (multinomial) takes the plain reduction, as in the reference.

Checkpoints hold the global, unpadded y and lam, as the reference's do:
every rank takes part in gathering them, rank 0 alone writes, and the
others wait for the commit. On restore every rank reads the files and
takes its rows, so a checkpoint written at one world size (or by the JAX
package's ``ShardMapExecutor``) resumes at another. The EF error restarts
at zero: it is a wire optimization, not solver state.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core import gram as gram_lib
from repro_torch.core.distributed import (
    all_gather,
    barrier,
    compressed_allreduce,
    ordered_allreduce,
)
from repro_torch.device import on_device
from repro_torch.engine.streaming import SweepResult
from repro_torch.exec.base import SolveExecutor
from repro_torch.exec.local import fused_step
from repro_torch.sharding.compat import (
    SOLO,
    Group,
    RowShard,
    current_group,
    shard_rows,
)

Tensor = torch.Tensor


def default_group() -> Group:
    """The current group; without one, ``SOLO``: a world of one in this
    process that starts no process group (the reference's
    ``default_mesh`` takes every local device of its one process)."""
    return current_group() or SOLO


class ShardMapExecutor(SolveExecutor):
    name = "shard_map"
    checkpoint_kind = "shard_map_solve"
    kind_label = "shard_map"

    def __init__(self, engine, D, aux=None, group: Optional[Group] = None,
                 compress: bool = False):
        """``D`` (m, n) or node-stacked (N, m_i, n) and ``aux`` are the
        global arrays, numpy or tensors, the same on every rank; this rank
        keeps its rows, on the engine's device."""
        self.engine = engine
        self.group = group if group is not None else default_group()
        self.world, self.rank = self.group.world, self.group.rank
        D = D.reshape(-1, D.shape[-1])
        self.m, self.n = D.shape
        self.device = engine.dev
        self.ycols = getattr(engine.loss, "ycols", 1)
        # int8 EF compression quantizes flat n-vectors; matrix-valued d
        # (multinomial) takes the plain reduction
        self.compress = bool(compress) and self.ycols == 1
        self.pad = -(-self.m // self.world) * self.world - self.m
        self._D = on_device(shard_rows(D, self.rank, self.world),
                            self.device)
        self.acc = gram_lib._acc_dtype(self._D.dtype)
        self.backend = engine.resolve(self._D.dtype)
        self.has_aux = aux is not None
        self._aux = None if aux is None else on_device(
            shard_rows(aux.reshape(self.m), self.rank, self.world),
            self.device)
        self.writes_checkpoint = self.rank == 0
        self._Dres = None
        self._y = self._lam = self._err = None

    def _yshape(self):
        m_loc = self._D.shape[0]
        return (m_loc,) if self.ycols == 1 else (m_loc, self.ycols)

    def _zero_err(self):
        self._err = torch.zeros((self.n,), dtype=torch.float32,
                                device=self.device)

    def setup(self) -> Tensor:
        G, _ = self.engine.gram(self._D)
        self._Dres = self.engine.prepare(self._D)
        return ordered_allreduce(G, self.group)

    def init(self, x0: Optional[Tensor]) -> Tensor:
        self._zero_err()
        if x0 is None:
            self._y = torch.zeros(self._yshape(), dtype=self.acc,
                                  device=self.device)
            self._lam = torch.zeros_like(self._y)
            return self.zero_x()
        # warm start: y = D_loc x0, lam = 0, d = sum_ranks D_loc^T y
        self._y = self._D.to(self.acc) @ x0.to(self.acc)
        self._lam = torch.zeros_like(self._y)
        return ordered_allreduce(
            self.engine.transpose_d(self._D, self._y, self._lam),
            self.group)

    def sweep(self, x: Tensor, k: int) -> SweepResult:
        self._y, self._lam, sw = fused_step(
            self.engine, self._Dres, self._aux, self._y, self._lam, x)
        return self.reduce(sw)

    def reduce(self, sw: SweepResult) -> SweepResult:
        """This rank's sweep partials summed over the ranks: the one
        collective of an iteration (two with ``compress``)."""
        scalars = torch.stack([sw.r_sq, sw.dx_sq, sw.y_sq, sw.obj]
                              ).to(self.acc)
        if self.compress:
            d, self._err = compressed_allreduce(sw.d, self._err, self.group)
            vecs = [sw.w, sw.v]
        else:
            vecs = [sw.d, sw.w, sw.v]
        total = ordered_allreduce(
            torch.cat([t.reshape(-1) for t in vecs] + [scalars]),
            self.group)
        shape = sw.d.shape
        parts = [p.reshape(shape) for p in
                 total[:-4].split(sw.d.numel())]
        if not self.compress:
            d = parts.pop(0)
        w, v = parts
        return SweepResult(d, w, v, *total[-4:].unbind(0))

    def pad_objective(self) -> float:
        if self.pad == 0:
            return 0.0
        shape = (self.pad,) if self.ycols == 1 else (self.pad, self.ycols)
        z = torch.zeros(shape, dtype=torch.float32, device=self.device)
        a = torch.zeros((self.pad,), dtype=torch.float32,
                        device=self.device)
        return float(self.engine.loss.value(z, a if self.has_aux else None))

    def extra_record(self) -> dict:
        return {"shards": self.world, "backend": self.group.backend}

    # -- checkpointing ------------------------------------------------------
    def _global(self, t: Tensor) -> Tensor:
        """The global, unpadded rows of a per-rank iterate (a collective:
        every rank calls it)."""
        g = all_gather(t, self.group)
        return g.reshape((-1,) + tuple(t.shape[1:]))[:self.m]

    def state_arrays(self, k: int) -> dict:
        return {"y": self._global(self._y), "lam": self._global(self._lam)}

    def on_checkpointed(self, k: int, state: dict):
        barrier(self.group)          # the others wait for rank 0's commit

    def restore_placements(self) -> dict:
        rows = RowShard(self.rank, self.world, self.device)
        return {"x": self.device, "y": rows, "lam": rows, "d": self.device}

    def restore_state(self, k: int, tree: dict) -> Tensor:
        self._y = tree["y"].to(self.acc)
        self._lam = tree["lam"].to(self.acc)
        self._zero_err()
        return tree["d"]

    def adopt(self, state: dict):
        """Take over iterate state (this rank's ``y``, ``lam`` and ``err``,
        as ``repro_torch.convert.shard_state`` gives them) after
        ``setup``."""
        self._y = state["y"].to(self.device, self.acc)
        self._lam = state["lam"].to(self.device, self.acc)
        self._err = state["err"].to(self.device, torch.float32)

    def final_iterates(self):
        return self._global(self._y)[None], self._global(self._lam)[None]


def fit_rank(calls: Sequence[dict], device: str = "cuda") -> List[dict]:
    """Spawn target (``sharding.compat.spawn``): ``fit_on_executor(...,
    "shard_map")`` on this rank for each call, a dict of ``problem`` (a
    ``make_problem`` name), optional ``params`` and ``rho`` (a ridge
    override), ``D``, ``aux`` and ``fit_on_executor``'s keywords (``x0``,
    ``max_iters``, ``record``, ``checkpoint_dir``, ``compress``, ...).
    Returns one ``{"x", "iters", "objective", "extra"}`` per call."""
    import dataclasses

    from repro_torch.exec.problems import fit_on_executor, make_problem
    group = default_group()
    out = []
    for call in calls:
        kw = dict(call)
        prob = make_problem(kw.pop("problem"), **kw.pop("params", {}))
        rho = kw.pop("rho", None)
        if rho is not None:
            prob = dataclasses.replace(prob, rho=rho)
        res = fit_on_executor(prob, "shard_map", kw.pop("D"),
                              kw.pop("aux", None), group=group,
                              device=device, **kw)
        out.append({"x": res.x, "iters": res.iters,
                    "objective": None if res.history is None
                    else res.history.objective,
                    "extra": {"shards": group.world,
                              "backend": group.backend}})
    return out
