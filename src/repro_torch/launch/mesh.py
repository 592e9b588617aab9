"""Production grid definition; port of ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
device and no process group. The reference's layout is TPU pods of 256
chips arranged (data=16, model=16), with a leading 'pod' axis for 2 pods;
here the same shapes describe grids of ranks (one rank a card), which the
dry-run reads as they are: ``make_production_mesh`` returns a description
(:class:`repro_torch.sharding.compat.Grid`) and joins nothing. The 'model'
axis carries TP/EP, ('pod', 'data') carry DP and the ADMM row sharding.
"""
from __future__ import annotations

from repro_torch.sharding import compat


def make_production_mesh(*, multi_pod: bool = False) -> compat.Grid:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.make_grid(shape, axes)


def make_mesh(shape, axes) -> compat.Grid:
    """An arbitrary grid for tests and examples (e.g. (4, 2) on 8 gloo
    ranks); join it with ``compat.join_grid`` inside a group of its size."""
    return compat.make_grid(tuple(shape), tuple(axes))
