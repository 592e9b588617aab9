"""repro_torch.exec — the SolveExecutor contract, the one shared ADMM
solve loop (``solve_with_executor``, DESIGN.md section 14) and
problems-on-executors. The local,
streaming (out-of-core) and shard_map (rows over the ranks of a process
group) topologies are ported; cluster is ROADMAP item 9."""
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
from repro_torch.exec.shard_map import ShardMapExecutor, default_group
from repro_torch.exec.streaming import StreamingExecutor

__all__ = [
    "EXECUTORS",
    "ExecProblem",
    "LocalExecutor",
    "Regularizer",
    "ShardMapExecutor",
    "SolveExecutor",
    "StreamingExecutor",
    "composite_x_update",
    "default_group",
    "fit_on_executor",
    "make_executor",
    "make_group_lasso_reg",
    "make_l1_reg",
    "make_problem",
    "power_lmax",
    "solve_with_executor",
    "synth_data",
]
