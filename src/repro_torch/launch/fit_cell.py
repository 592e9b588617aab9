"""Dry-run cells for the PAPER'S OWN workload: distributed transpose-
reduction ADMM at production scale, counted for one rank of a production
grid; port of ``repro/launch/fit_cell.py``.

Cells (rows sharded over every grid axis — each card is a paper 'node'):
  star_f32   GSC-II scale: m=950,272,000 rows x n=307 features, f32
             (the paper's 1.8 TB Table-1 dataset; 4.56 GB a card on 16x16)
  star_bf16  beyond-paper: bf16 data residency, f32 Gram/solve accumulation
  fig1_bf16  Fig-1 scale: m=368,640,000 x n=2000, bf16 (5.8 GB a card)

Three programs per cell, each one rank's code on its D_loc (the port's own
row shard, ``compat.RowShard``, of a meta-device D):
  setup:      G = allreduce(D_i^T D_i); Cholesky factor     (one-off)
  iter:       d = allreduce(D_i^T (y_i - lam_i)); x = solve(L, d);
              y, lam = prox update                          (two passes)
  fused_iter: one pass over D a row block at a time         (one pass)

The all-reduces are real ``torch.distributed`` calls on a fake process
group of the grid's size (``fake_group``; ``torch.testing``'s
``FakeProcessGroup``, which moves no data), so the collective recorder
sees them as a rank would issue them. The Gram is the plain one-shot
product (the card runs it through the K2a kernel, same semantics), so the
counter counts its FLOPs.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.core import gram as gram_lib
from repro_torch.core.prox import make_logistic
from repro_torch.sharding.compat import RowShard

META = torch.device("meta")

CELLS = {
    "star_f32": dict(m=950_272_000, n=307, dtype=torch.float32),
    "star_bf16": dict(m=950_272_000, n=307, dtype=torch.bfloat16),
    "fig1_bf16": dict(m=368_640_000, n=2000, dtype=torch.bfloat16),
}


@contextlib.contextmanager
def fake_group(world: int):
    """A default process group of ``world`` ranks in this one process, on
    the fake backend (collectives return at once and move nothing), as
    rank 0; destroyed on leaving."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _psum(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t)
    return t


def build_fit_cell(name, grid, tau: float = 0.1):
    """{phase: (fn, args)} for cell ``name`` (a ``CELLS`` key, or a dict
    with m, n and dtype) on ``grid``: one rank's program and its meta-device
    inputs. Run the programs inside :func:`fake_group` of ``grid.size``."""
    spec = CELLS[name] if isinstance(name, str) else name
    m, n, dtype = spec["m"], spec["n"], spec["dtype"]
    nshards = grid.size                      # every card is a 'node'
    assert m % nshards == 0
    loss = make_logistic()
    acc = torch.float32

    def setup_local(D_loc):
        return gram_lib.gram_factor(_psum(gram_lib.gram(D_loc)))

    def iter_local(D_loc, aux_loc, y, lam, L):
        """Baseline Alg.2 iteration: TWO streaming passes over D
        (d = D^T(y-lam), then Dx)."""
        Da = D_loc.to(acc)
        d = _psum(Da.T @ (y - lam))
        x = gram_lib.gram_solve(L, d)
        Dx = Da @ x
        y_new = loss.prox(Dx + lam, 1.0 / tau, aux_loc)
        lam_new = lam + Dx - y_new
        obj = _psum(loss.value(y_new, aux_loc))
        return x, y_new, lam_new, obj

    def fused_iter_local(D_loc, aux_loc, y, lam, x, n_blocks: int = 8):
        """ONE pass over D per iteration: for each row block (loaded
        once), Dx_b with the incoming x, the y_b / lam_b prox updates, and
        d_b = D_b^T (y_b - lam_b) accumulated; then one all-reduce and the
        solve give the NEXT x. Identical iterates, half the HBM traffic of
        the 2-pass baseline."""
        m_loc = D_loc.shape[0]
        bs = m_loc // n_blocks
        d = torch.zeros((n,), dtype=acc, device=D_loc.device)
        y_out, lam_out = [], []
        obj = torch.zeros((), dtype=acc, device=D_loc.device)
        for b in range(n_blocks):
            Db = D_loc[b * bs:(b + 1) * bs].to(acc)
            yb = y[b * bs:(b + 1) * bs]
            lb = lam[b * bs:(b + 1) * bs]
            ab = aux_loc[b * bs:(b + 1) * bs]
            Dx_b = Db @ x
            y_b = loss.prox(Dx_b + lb, 1.0 / tau, ab)
            l_b = lb + Dx_b - y_b
            d = d + Db.T @ (y_b - l_b)
            obj = obj + loss.value(y_b, ab)
            y_out.append(y_b)
            lam_out.append(l_b)
        d = _psum(d)
        obj = _psum(obj)
        return d, torch.cat(y_out), torch.cat(lam_out), obj

    shard = RowShard(0, nshards)
    D_loc = shard.take(torch.empty((m, n), dtype=dtype, device=META))
    vec = shard.take(torch.empty((m,), dtype=torch.float32, device=META))
    L_in = torch.empty((n, n), dtype=torch.float32, device=META)
    x_in = torch.empty((n,), dtype=torch.float32, device=META)
    return {
        "setup": (setup_local, (D_loc,)),
        "iter": (iter_local, (D_loc, vec, vec, vec, L_in)),
        "fused_iter": (fused_iter_local, (D_loc, vec, vec, vec, x_in)),
    }
