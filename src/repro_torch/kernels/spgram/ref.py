"""Reference semantics for the sparse kernels: densify, then run the
textbook dense ops; port of ``repro/kernels/spgram/ref.py``. Parity
baseline for tests — O(mn), never a hot path."""
from __future__ import annotations

import torch

from repro_torch.core import gram as gram_lib


def gram_ref(bcsr):
    """D^T D via densification."""
    return gram_lib.gram(bcsr.to_dense())


def gram_rhs_ref(bcsr, b):
    """D^T b via densification."""
    return gram_lib.gram_rhs(bcsr.to_dense(), b)


def matvec_ref(bcsr, x):
    D = bcsr.to_dense()
    acc = gram_lib._acc_dtype(D.dtype)
    return D.to(acc) @ x.to(acc)


def admm_iter_ref(bcsr, aux, y, lam, x, *, loss, delta: float):
    """Dense two-pass iteration body on the densified matrix."""
    D = bcsr.to_dense()
    acc = gram_lib._acc_dtype(D.dtype)
    Df = D.to(acc)
    Dx = Df @ x.to(acc)
    y_new = loss.prox(Dx + lam, delta, aux)
    lam_new = lam + Dx - y_new
    dwv = Df.T @ torch.stack([y_new - lam_new, y_new - y, lam_new], dim=1)
    return y_new, lam_new, dwv[:, 0], dwv[:, 1], dwv[:, 2]
