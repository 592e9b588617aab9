"""Problems-on-executors: register a problem once, run it on any topology;
port of ``repro/exec/problems.py``.

A problem is (picklable loss spec, tau, rho, optional x-space regularizer
factory) — nothing topology-specific. ``fit_on_executor`` builds the
:class:`~repro_torch.exec.base.SolveExecutor` for the requested topology
and hands it to the one shared solve loop, ``solve_with_executor``. The
local, streaming and shard_map topologies are ported; cluster is ROADMAP
item 9 and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.device import on_device, resolve_device
from repro_torch.exec.base import (
    Regularizer,
    SolveExecutor,
    make_group_lasso_reg,
    solve_with_executor,
)

EXECUTORS = ("local", "streaming", "shard_map", "cluster")
# executor -> ROADMAP item that ports it
EXECUTOR_ITEMS = {"cluster": 9}


@dataclasses.dataclass(frozen=True)
class ExecProblem:
    """One solvable problem, topology-free. ``loss_spec`` is picklable;
    ``reg_factory(n)`` builds the x-space penalty, applied by the
    composite x-update of ``solve_with_executor``."""

    name: str
    loss_spec: dict
    tau: float = 1.0
    rho: float = 0.0
    reg_factory: Optional[Callable[[int], Regularizer]] = None

    def loss(self):
        from repro_torch.core.prox import loss_from_spec
        return loss_from_spec(self.loss_spec)

    def reg(self, n: int) -> Optional[Regularizer]:
        return self.reg_factory(n) if self.reg_factory else None


def _group_lasso_factory(mu: float, group_size: int):
    def make(n: int) -> Regularizer:
        groups = np.arange(n) // group_size
        return make_group_lasso_reg(mu, groups, int(groups[-1]) + 1)

    return make


def make_problem(name: str, **params) -> ExecProblem:
    """The problem table — one line per problem, every executor."""
    if name == "logistic":
        return ExecProblem("logistic", {"name": "logistic"},
                           tau=params.get("tau", 0.1))
    if name == "svm":
        return ExecProblem(
            "svm", {"name": "hinge", "C": float(params.get("C", 1.0))},
            tau=params.get("tau", 0.5), rho=float(params.get("rho", 1.0)))
    if name == "least_squares":
        return ExecProblem("least_squares", {"name": "least_squares"},
                           tau=params.get("tau", 1.0))
    if name == "quantile":
        return ExecProblem(
            "quantile",
            {"name": "quantile", "q": float(params.get("q", 0.5))},
            tau=params.get("tau", 1.0))
    if name == "group_lasso":
        return ExecProblem(
            "group_lasso", {"name": "least_squares"},
            tau=params.get("tau", 1.0),
            reg_factory=_group_lasso_factory(
                float(params.get("mu", 0.1)),
                int(params.get("group_size", 4))))
    if name == "multinomial":
        return ExecProblem(
            "multinomial",
            {"name": "multinomial",
             "classes": int(params.get("classes", 3))},
            tau=params.get("tau", 0.5))
    raise ValueError(f"unknown executor problem {name!r}; "
                     f"known: logistic, svm, least_squares, quantile, "
                     f"group_lasso, multinomial")


def make_executor(kind: str, prob: ExecProblem, D, aux=None,
                  backend: str = "auto", device="cuda",
                  **opts) -> SolveExecutor:
    """Build the executor for one topology over in-memory (m, n) data
    (numpy or tensors), on ``device``. ``streaming`` stages the data into
    a host block store (``opts``: ``store=`` a ready
    :class:`~repro_torch.data.store.ShardedMatrixStore`, or ``block_rows=``
    for the one built here). ``shard_map`` runs this rank's part of a
    solve over the ranks of ``opts["group"]`` (default: the current group,
    else a world of one), on the rank's card for an unindexed ``cuda``;
    ``compress=True`` compresses its d reduction. ``cluster`` is not built
    here, as in the reference: it owns worker processes."""
    if kind not in ("local", "streaming", "shard_map"):
        raise ValueError(f"unknown executor kind {kind!r}; "
                         f"expected one of {EXECUTORS}")
    from repro_torch.engine import IterationEngine
    dev = resolve_device(device)
    group = None
    if kind == "shard_map":
        from repro_torch.exec.shard_map import default_group
        from repro_torch.sharding.compat import rank_device
        group = opts.get("group") or default_group()
        dev = rank_device(dev, group.local_rank)
    engine = IterationEngine(loss=prob.loss(), tau=prob.tau,
                             backend=backend, device=str(dev))
    if kind == "shard_map":
        from repro_torch.exec.shard_map import ShardMapExecutor
        return ShardMapExecutor(engine, D, aux, group=group,
                                compress=bool(opts.get("compress", False)))
    if kind == "streaming":
        from repro_torch.data.store import ShardedMatrixStore
        from repro_torch.exec.streaming import StreamingExecutor
        store = opts.get("store")
        if store is None:
            br = opts.get("block_rows")
            store = ShardedMatrixStore.from_arrays(
                D, aux, **({} if br is None else {"block_rows": br}))
        return StreamingExecutor(engine, store)
    from repro_torch.exec.local import LocalExecutor
    D = on_device(D, dev)
    D2 = D.reshape(-1, D.shape[-1])
    return LocalExecutor(engine, D2[None],
                         aux=None if aux is None else on_device(aux, dev))


def fit_on_executor(prob: ExecProblem, executor: str, D, aux=None, *,
                    x0=None, max_iters: int = 300, record: bool = False,
                    eps_rel: float = 1e-3, eps_abs: float = 1e-6,
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_every: int = 0, resume: bool = False,
                    n_workers: int = 2, store_dir: Optional[str] = None,
                    cluster_config=None, obs=None, **opts):
    """Solve ``prob`` over ``D``/``aux`` on the named executor; returns an
    :class:`~repro_torch.core.unwrapped.ADMMResult`."""
    if executor == "cluster":
        raise NotImplementedError("the cluster executor is not ported yet "
                                  "(ROADMAP item 9)")
    n = int(D.shape[-1])
    reg = prob.reg(n)
    ex = make_executor(executor, prob, D, aux, **opts)
    if x0 is not None:
        x0 = on_device(x0, ex.device)
    return solve_with_executor(
        ex, loss=prob.loss(), tau=prob.tau, rho=prob.rho,
        eps_rel=eps_rel, eps_abs=eps_abs, max_iters=max_iters, x0=x0,
        record=record, reg=reg, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, resume=resume, obs=obs)


def synth_data(prob: ExecProblem, m: int = 96, n: int = 12,
               seed: int = 0):
    """Deterministic synthetic numpy (D, aux) matched to the problem's aux
    contract — labels in {-1, +1} (logistic / svm), targets b
    (least-squares family), integer class ids (multinomial); the
    reference's draws, so both packages solve the same arrays."""
    rng = np.random.default_rng(seed)
    D = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    x_true = rng.standard_normal((n,)).astype(np.float32)
    z = D @ x_true
    name = prob.loss_spec["name"]
    if name in ("logistic", "hinge"):
        aux = np.sign(z + 0.1 * rng.standard_normal(m)).astype(np.float32)
        aux[aux == 0] = 1.0
        # flip 15% of labels: separable data has no finite logistic
        # minimizer; noise keeps the optimum finite
        flip = rng.random(m) < 0.15
        aux[flip] = -aux[flip]
        return D, aux
    if name == "multinomial":
        K = int(prob.loss_spec["classes"])
        W = rng.standard_normal((n, K)).astype(np.float32)
        aux = np.argmax(D @ W + 0.1 * rng.standard_normal((m, K)),
                        axis=1).astype(np.float32)
        flip = rng.random(m) < 0.15
        aux[flip] = np.floor(rng.random(flip.sum()) * K).astype(np.float32)
        return D, aux
    # least-squares family (quantile / group_lasso / least_squares)
    aux = (z + 0.1 * rng.standard_normal(m)).astype(np.float32)
    return D, aux
