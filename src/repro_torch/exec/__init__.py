"""repro_torch.exec — the SolveExecutor contract and the one shared ADMM
driver (DESIGN.md section 14). The local topology is ported; streaming,
shard_map and cluster are ROADMAP items 7-9."""
from repro_torch.exec.base import (
    Regularizer,
    SolveExecutor,
    composite_x_update,
    make_l1_reg,
    power_lmax,
    solve_with_executor,
)
from repro_torch.exec.local import LocalExecutor

__all__ = [
    "LocalExecutor",
    "Regularizer",
    "SolveExecutor",
    "composite_x_update",
    "make_l1_reg",
    "power_lmax",
    "solve_with_executor",
]
