"""Plain-torch oracle for the Gram kernel; port of
``repro/kernels/gram/ref.py``."""
from __future__ import annotations

import torch


def _acc(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def gram_ref(D):
    """D^T D with f32 accumulation (f64 passes through)."""
    Dc = D.to(_acc(D.dtype))
    return Dc.T @ Dc


def gram_with_rhs_ref(D, b):
    """(D^T D, D^T b) — the paper's section 4 cached quantities."""
    acc = _acc(D.dtype)
    Dc = D.to(acc)
    return Dc.T @ Dc, Dc.T @ b.to(acc)
