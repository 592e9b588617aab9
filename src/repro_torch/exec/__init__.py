"""repro_torch.exec — the SolveExecutor contract, the one shared ADMM
solve loop (``solve_with_executor``, DESIGN.md section 14) and
problems-on-executors. The local
topology is ported; streaming, shard_map and cluster are ROADMAP items
7-9."""
from repro_torch.exec.base import (
    Regularizer,
    SolveExecutor,
    composite_x_update,
    make_group_lasso_reg,
    make_l1_reg,
    power_lmax,
    solve_with_executor,
)
from repro_torch.exec.local import LocalExecutor
from repro_torch.exec.problems import (
    EXECUTORS,
    ExecProblem,
    fit_on_executor,
    make_executor,
    make_problem,
    synth_data,
)

__all__ = [
    "EXECUTORS",
    "ExecProblem",
    "LocalExecutor",
    "Regularizer",
    "SolveExecutor",
    "composite_x_update",
    "fit_on_executor",
    "make_executor",
    "make_group_lasso_reg",
    "make_l1_reg",
    "make_problem",
    "power_lmax",
    "solve_with_executor",
    "synth_data",
]
