"""repro_torch.exec — the SolveExecutor contract, the one shared ADMM
solve loop (``solve_with_executor``, DESIGN.md section 14) and
problems-on-executors, over four topologies: local (device-resident
data), streaming (out-of-core), shard_map (rows over the ranks of a
process group) and cluster (worker processes behind the fault-tolerant
runtime of :mod:`repro_torch.cluster`)."""
from repro_torch.exec.base import (
    Regularizer,
    SolveExecutor,
    composite_x_update,
    make_group_lasso_reg,
    make_l1_reg,
    power_lmax,
    solve_with_executor,
)
from repro_torch.exec.cluster import ClusterExecutor
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
    "ClusterExecutor",
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
