"""Paper section 7.1 — splitting over COLUMNS via the dual; port of
``repro/core/column_split.py``.

When D is wide (m << n) and nodes store column blocks, the lasso
    min_x 0.5||Dx - b||^2 + mu|x|
is solved through its dual
    min_alpha 0.5||alpha + b||^2   s.t.  ||D^T alpha||_inf <= mu
with unwrapped ADMM on D_hat = [I; D^T] and
    f_hat = [ 0.5||. + b||^2 (m rows) ; X_{|.| <= mu} (n rows) ].
Each node forms D_i D_i^T (not D_i^T D_i): the Gram reduction is over
column blocks, sum_i D_i D_i^T, an m x m matrix — the transpose-reduction
trick mirrored. The primal solution is recovered from the scaled multiplier
of the constraint rows: x* = -tau * lambda_2.

On the card the setup Gram of D_hat is one K2a launch at n = m; the
iterations run the engine's reference body, since ``StackedProx`` is not
coordinatewise (its prox depends on the row's position).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.prox import (
    StackedProx,
    make_linf_ball,
    make_shifted_least_squares,
)
from repro_torch.core.unwrapped import UnwrappedADMM
from repro_torch.device import on_device, resolve_device

Tensor = torch.Tensor


class ColumnSplitResult(NamedTuple):
    x: Tensor         # primal lasso solution (n,)
    alpha: Tensor     # dual optimum (m,)
    iters: int


def lasso_column_split(D_cols, b, mu: float, tau: float = 1.0,
                       iters: int = 800,
                       device="cuda") -> ColumnSplitResult:
    """D_cols: (N, m, n_i) — N nodes each holding n_i columns; b: (m,).
    Numpy arrays or tensors; the solve runs on ``device``.

    Emulated-nodes layout (the row-split solvers' convention); a
    distributed version reduces sum_i D_i D_i^T with one all-reduce, as the
    row split does for D_i^T D_i."""
    dev = resolve_device(device)
    D_cols, b = on_device(D_cols, dev), on_device(b, dev)
    N, m, n_i = D_cols.shape
    n = N * n_i
    Dflat = torch.cat([D_cols[i] for i in range(N)], dim=1)       # (m, n)
    # D_hat = [I_m ; D^T]: the stacked operator applied to alpha in R^m
    D_hat = torch.cat([torch.eye(m, dtype=Dflat.dtype, device=dev),
                       Dflat.T], dim=0)[None]
    del Dflat
    sp = StackedProx(
        blocks=(make_shifted_least_squares(), make_linf_ball(mu)),
        sizes=(m, n),
    )
    aux = torch.cat([b, torch.zeros((n,), dtype=b.dtype, device=dev)])[None]
    solver = UnwrappedADMM(loss=sp.as_loss("dual_lasso"), tau=tau,
                           device=dev)
    res = solver.run(D_hat, aux, iters=iters)
    # the multiplier of the ||D^T alpha||_inf <= mu rows, scaled by -tau,
    # is the primal x (sign from lam <- lam + D_hat a - y; alpha* =
    # D x* - b)
    x = -tau * res.lam[0, m:]
    return ColumnSplitResult(x, res.x, int(res.iters))
