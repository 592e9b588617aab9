"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking
for ``cuda`` on a machine without a usable GPU raises: nothing falls back
to the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but no CUDA device is "
            "available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run on the CPU")
    return dev


def on_device(a, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` (numpy arrays are
    taken as writable C-ordered copies only where they are not already)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    return a.to(device)
