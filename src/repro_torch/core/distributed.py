"""Transpose-reduction ADMM (paper Alg. 2) over the ranks of a
``torch.distributed`` group; port of ``repro/core/distributed.py``.

The paper's cluster roles, mapped onto ranks (one process per device):

  * "node i" = a rank. D's rows are sharded over the ranks (the last
    rank's shard zero-padded); y_i and lam_i live on their rank and never
    move.
  * "send D_i^T(y_i - lam_i) to the central server" = one all-gather of an
    n-vector per iteration, summed in rank order on every rank (the
    paper's O(n)-per-node communication).
  * "the central node computes W = (sum_i W_i)^{-1}" = the n x n Gram
    summed the same way at setup, then a replicated Cholesky on every rank.
  * the composite x-update g(x) = mu |x| runs warm-started proximal
    gradient on the cached Gram, on every rank, with no communication.

Every reduction is an all-gather of the ranks' partials followed by a sum
in rank order, never an all-reduce: the sum's order is then fixed, so
every rank gets the same bits and takes the same stopping decision, and a
rerun gives the same bits again (no float atomics, no reduction tree that
depends on the backend). gloo's all-gather takes CPU tensors only, so under
gloo a CUDA tensor goes through the host (3n + 4 floats an iteration on the
executor's path).

Optional int8 error-feedback compression of the per-iteration d
(``compressed_allreduce``): each rank quantizes its d with the residual it
carries, the int8 codes and scales are gathered, and every rank
dequantizes and sums them in rank order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.cluster.compress import dequantize_int8, ef_compress
from repro_torch.core import gram as gram_lib
from repro_torch.core.prox import ProxLoss
from repro_torch.device import on_device
from repro_torch.sharding.compat import (
    Group,
    current_group,
    rank_device,
    shard_rows,
)

Tensor = torch.Tensor


def all_gather(t: Tensor, group: Group) -> Tensor:
    """Every rank's ``t``, stacked in rank order: (world, *t.shape) on
    ``t``'s device. Under gloo a CUDA tensor is staged through the host;
    over ``SOLO`` (no process group) this is a copy of ``t``."""
    if group.backend == "none":
        return t.detach()[None].clone()
    staged = group.backend == "gloo" and t.device.type == "cuda"
    src = t.detach().cpu() if staged else t.detach().contiguous()
    out = src.new_empty((group.world,) + tuple(src.shape))
    dist.all_gather(list(out.unbind(0)), src)
    return out.to(t.device) if staged else out


def barrier(group: Group):
    """Wait for every rank of ``group`` (nothing to wait for over
    ``SOLO``)."""
    if group.backend != "none":
        dist.barrier()


def rank_sum(parts: Sequence[Tensor]) -> Tensor:
    """sum(parts), added in rank order: the same bits on every rank."""
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


def ordered_allreduce(t: Tensor, group: Group) -> Tensor:
    """The sum of ``t`` over the ranks, in rank order, on every rank."""
    return rank_sum(all_gather(t, group))


def compressed_allreduce(v: Tensor, err: Tensor, group: Group
                         ) -> Tuple[Tensor, Tensor]:
    """Error-feedback int8 all-gather-sum of the n-vector ``v``: returns
    (sum, new_error). The wire carries 1 byte a coordinate plus a scale
    per group instead of 4 bytes."""
    n = v.shape[0]
    q, scale, new_err = ef_compress(v, err)
    qg, sg = all_gather(q, group), all_gather(scale, group)
    return rank_sum([dequantize_int8(qg[r], sg[r], n)
                     for r in range(group.world)]), new_err


# ---------------------------------------------------------------------------
# the distributed solver
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistributedUnwrappedADMM:
    """Paper Alg. 2 with D's rows sharded over the ranks of a group.

    Attributes:
      loss: separable ProxLoss on y (rows follow D's row sharding).
      tau: ADMM stepsize.
      rho: ridge weight on x (SVM).
      l1_mu: if > 0, composite x-update with g(x) = l1_mu * |x|.
      compress: int8 error-feedback compression of the per-iteration d.
      inner_iters: prox-gradient iterations for the composite x-update.
      backend / residency: iteration-engine knobs; the engine body runs on
        each rank's rows (K3 on the card), then only n-vectors cross
        between the ranks.
      device: where each rank computes (``cuda``: the rank's card).
    """

    loss: ProxLoss
    tau: float = 1.0
    rho: float = 0.0
    l1_mu: float = 0.0
    compress: bool = False
    inner_iters: int = 25
    backend: str = "auto"
    residency: Optional[str] = None
    device: str = "cuda"

    @property
    def engine(self):
        from repro_torch.engine import IterationEngine
        return IterationEngine(loss=self.loss, tau=self.tau,
                               backend=self.backend,
                               residency=self.residency, device=self.device)

    def _composite_x(self, G, lmax, d, x_warm):
        from repro_torch.core.prox import soft_threshold
        from repro_torch.exec.base import composite_x_update
        return composite_x_update(
            G, lmax, d, x_warm, self.tau,
            lambda z, step: soft_threshold(z, step * self.l1_mu),
            self.inner_iters)

    def build(self, group: Group, m_global: int, n: int, iters: int):
        """Returns ``solve(D, aux) -> (x, objective, primal_res)``, run by
        every rank of ``group``, for ``iters`` iterations.

        D (m_global, n) and aux (m_global,) are the global arrays (numpy
        or tensors; every rank passes the same); each rank takes its rows
        of the zero-padded arrays (``shard_rows``). Zero rows are exact
        under the transpose reduction (no Gram, d or residual
        contribution), and with zero aux their iterates stay at zero, so
        the only history they touch is the objective's constant f(0) term,
        which ``solve`` subtracts. The histories have one entry per
        iteration; x, objective and primal_res are bitwise equal on every
        rank."""
        world, rank = group.world, group.rank
        pad = -(-m_global // world) * world - m_global
        eng = self.engine
        dev = eng.dev
        pad_obj = 0.0
        if pad:
            z = torch.zeros((pad,), dtype=torch.float32)
            pad_obj = float(self.loss.value(z, z))

        def solve(D, aux):
            D_loc = on_device(shard_rows(D, rank, world), dev)
            aux_loc = on_device(shard_rows(aux, rank, world), dev)
            acc = gram_lib._acc_dtype(D_loc.dtype)
            # setup: the Gram summed over the ranks, factored on each
            G_loc, _ = eng.gram(D_loc)
            G = ordered_allreduce(G_loc, group)
            use_chol = self.l1_mu == 0.0
            if use_chol:
                L = gram_lib.gram_factor(G, ridge=self.rho / self.tau)
            else:
                from repro_torch.exec.base import power_lmax
                lmax = power_lmax(G)
            D_res = eng.prepare(D_loc)
            m_loc = D_loc.shape[0]
            y = torch.zeros((m_loc,), dtype=acc, device=dev)
            lam = torch.zeros_like(y)
            err = torch.zeros((n,), dtype=torch.float32, device=dev)
            x = torch.zeros((n,), dtype=acc, device=dev)
            # cold start: y = lam = 0, so d = 0 on every rank (and its
            # compression is exact), without a reduction
            d = torch.zeros((n,), dtype=acc, device=dev)
            objs: List[Tensor] = []
            r_sqs: List[Tensor] = []
            for _ in range(iters):
                if use_chol:
                    x = gram_lib.gram_solve(L, d)
                else:
                    x = self._composite_x(G, lmax, d, x)
                # one pass over the local rows (Alg. 2 lines 5-8, fused)
                st = eng.iterate(D_res, aux_loc, y, lam, x, want_dual=False)
                Dx = st.lam - lam + st.y
                # the objective is f(Dx), as the single-device solver's
                # history, not f(y): mid-run y != Dx
                scalars = torch.stack([torch.sum((Dx - st.y) ** 2),
                                       self.loss.value(Dx, aux_loc)]
                                      ).to(acc)
                if self.compress:
                    d, err = compressed_allreduce(st.d, err, group)
                else:
                    d = ordered_allreduce(st.d, group)
                r_sq, obj = ordered_allreduce(scalars, group).unbind(0)
                if self.rho:
                    obj = obj + 0.5 * self.rho * torch.sum(x * x)
                if self.l1_mu:
                    obj = obj + self.l1_mu * torch.sum(torch.abs(x))
                objs.append(obj)
                r_sqs.append(r_sq)
                y, lam = st.y, st.lam
            return (x, torch.stack(objs) - pad_obj,
                    torch.sqrt(torch.stack(r_sqs)))

        return solve


def solve_rank(calls: Sequence[dict], device: str = "cuda") -> List[dict]:
    """Spawn target (``sharding.compat.spawn``): run
    ``DistributedUnwrappedADMM(...).build(...)(D, aux)`` on this rank for
    each call, a dict of ``loss`` (a loss spec), ``D``, ``aux``, ``iters``
    and the solver's other fields; returns one ``{"x", "objective",
    "primal_res"}`` per call."""
    from repro_torch.core.prox import loss_from_spec
    group = current_group()
    dev = str(rank_device(device, group.local_rank))
    out = []
    for call in calls:
        kw = dict(call)
        D, aux, iters = kw.pop("D"), kw.pop("aux"), kw.pop("iters")
        solver = DistributedUnwrappedADMM(
            loss=loss_from_spec(kw.pop("loss")), device=dev, **kw)
        x, objs, rs = solver.build(group, D.shape[0], D.shape[-1],
                                   iters)(D, aux)
        out.append({"x": x, "objective": objs, "primal_res": rs})
    return out
