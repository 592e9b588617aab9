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
