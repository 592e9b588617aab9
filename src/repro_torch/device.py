"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking
for ``cuda`` on a machine without a usable GPU raises: nothing falls back
to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but no CUDA device is "
            "available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run on the CPU")
    return dev
