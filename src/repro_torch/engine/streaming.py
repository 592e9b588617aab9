"""Sweep reductions shared by every solve topology; port of the
``SweepResult`` part of ``repro/engine/streaming.py``. The out-of-core
streaming engine itself is ROADMAP item 7."""
from __future__ import annotations

from typing import NamedTuple

import torch


class SweepResult(NamedTuple):
    """Accumulated over all rows of one sweep — everything the driver
    needs for the x-update and Boyd's stopping rule, all n-sized or
    scalar."""

    d: torch.Tensor          # sum_b D_b^T(y_b' - lam_b')
    w: torch.Tensor          # sum_b D_b^T(y_b' - y_b)
    v: torch.Tensor          # sum_b D_b^T lam_b'
    r_sq: torch.Tensor       # ||lam' - lam||^2 = ||Dx - y'||^2
    dx_sq: torch.Tensor      # ||Dx||^2
    y_sq: torch.Tensor       # ||y'||^2
    obj: torch.Tensor        # f(Dx) (pad-corrected by the driver)
