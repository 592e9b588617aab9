"""High-level model-fitting API — the paper's contribution as one call;
port of ``repro/core/fit.py``.

``fit()`` dispatches on (problem, method) through the problem registry
(``repro_torch.service.registry``):

  problem: "lasso" | "logistic" | "svm" | "sparse_logistic" | "ridge"
           | "elastic_net" | "huber" | "nnls" | "quantile" | "group_lasso"
           | "multinomial"
  method:  "transpose"  — the paper (unwrapped ADMM with transpose
                          reduction, or the section 4 direct Gram path for
                          quadratic data terms)
           "consensus"  — the Boyd baseline the paper compares against
                          (lasso / logistic / sparse_logistic / svm)
           "fasta"      — single-node forward-backward from the cached
                          Gram (lasso / ridge / elastic_net / nnls)

D is node-stacked (N, m_i, n), aux (N, m_i); numpy arrays or tensors.
The fit runs on ``device`` ("cuda" by default; asking for it without a
GPU raises) and the data are moved there once.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import on_device, resolve_device

Tensor = torch.Tensor


class FitResult(NamedTuple):
    x: Tensor
    iters: int
    objective_history: Optional[Tensor]
    method: str
    problem: str


def _flops_per_iter(problem: str, method: str, N: int, mi: int,
                    n: int) -> float:
    """Analytic per-iteration FLOP model (the scaling benchmarks' paper-
    style 'total compute time' at core counts that are not emulated)."""
    m = N * mi
    if method == "transpose":
        # d = D^T(y-lam): 2mn; Dx: 2mn; solve: 2n^2; prox: ~10m.
        return 4.0 * m * n + 2.0 * n * n + 10.0 * m
    # consensus per outer iter: inner solver dominated.
    if problem == "lasso":
        # cached factor solve per node: 2n^2 + 2 m_i n for rhs
        return N * (2.0 * n * n) + 2.0 * m * n
    if problem in ("logistic", "sparse_logistic"):
        # Newton: per inner iter H build = m_i n^2, solve n^3/3; ~8 inner
        return 8.0 * (m * n * n + N * n**3 / 3.0)
    if problem == "svm":
        # CD pass: O(m_i n) per pass * passes(4) + greedy grad O(m_i n)
        return 8.0 * m * n
    raise ValueError(problem)


def _on(a, dev: torch.device):
    """Arrays and tensors onto the fit's device; other values as given."""
    return on_device(a, dev) if isinstance(a, (np.ndarray, Tensor)) else a


def fit(
    problem: str,
    D,                             # (N, m_i, n) node-stacked
    aux,                           # labels or b, (N, m_i)
    method: str = "transpose",
    mu: Optional[float] = None,    # l1 weight (lasso / sparse_logistic / en)
    C: float = 1.0,                # SVM hinge weight
    tau: Optional[float] = None,
    iters: int = 500,
    record: bool = True,
    device="cuda",
    **params,                      # problem extras: l2=, delta=, x0=, ...
) -> FitResult:
    # imported here: the registry imports the solver modules of
    # repro_torch.core, whose package imports this module
    from repro_torch.service import registry

    dev = resolve_device(device)
    params = {k: _on(v, dev) for k, v in params.items()}
    return registry.solve(
        problem, _on(D, dev), _on(aux, dev), method=method,
        mu=mu, C=C, tau=tau, iters=iters, record=record, **params)
