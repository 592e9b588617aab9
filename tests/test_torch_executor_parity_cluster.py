"""Executor parity of the port, the cluster column of
``tests/test_executor_parity.py``: ``fit_on_executor(..., "cluster")`` on
two worker processes on the CPU, held to the JAX package's converged
LOCAL x at ``PARITY_TOL`` (1e-5, rel sup-norm) on the shared problems of
``tests/exec_fixtures.py``:

  * cold: the five parity problems;
  * warm: the three new problems, warm-started from the JAX package's
    partial iterate, against its local warm solution;
  * resume (in ``tests/test_torch_executor_parity_cluster_resume.py``,
    to keep each file short): the three new problems, checkpointed at 25
    iterations and resumed to convergence, against the JAX package's
    local resumed solution.

The references are the fixtures of ``tests/test_torch_executor_parity.py``
(the local, streaming and shard_map columns). Each solve has the cluster
tests' limits: workers must register within ``register_timeout_s`` and a
silent worker is declared dead after ``heartbeat_timeout_s``."""
import jax

jax.config.update("jax_platform_name", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

from exec_fixtures import (  # noqa: E402
    NEW_PROBLEMS,
    N_WORKERS,
    PARITY_PROBLEMS,
    PARITY_TOL,
    SOLVE_KW,
    rel_gap,
)
from repro_torch.cluster.coordinator import ClusterConfig  # noqa: E402
from repro_torch.exec import problems as tprob  # noqa: E402
from test_torch_executor_parity import (  # noqa: E402,F401  (fixtures)
    _port_problem,
    ref_cache,
    warm_ref,
    warm_x0,
)

torch.set_num_threads(1)


def cluster_fit(name, tmp_path, **kw):
    prob, D, aux = _port_problem(name)
    cfg = ClusterConfig(n_workers=N_WORKERS, device="cpu",
                        heartbeat_timeout_s=30, register_timeout_s=300)
    return tprob.fit_on_executor(prob, "cluster", D, aux,
                                 cluster_config=cfg,
                                 store_dir=str(tmp_path / "store"), **kw)


@pytest.mark.parametrize("problem", PARITY_PROBLEMS)
def test_cluster_cold_parity(problem, ref_cache, tmp_path):
    r = cluster_fit(problem, tmp_path, **SOLVE_KW)
    gap = rel_gap(ref_cache(problem), r.x)
    assert gap <= PARITY_TOL, f"{problem} on cluster: gap {gap:.3e}"


@pytest.mark.parametrize("problem", NEW_PROBLEMS)
def test_cluster_warm_start_parity(problem, warm_x0, warm_ref, tmp_path):
    r = cluster_fit(problem, tmp_path, x0=warm_x0(problem), **SOLVE_KW)
    gap = rel_gap(warm_ref(problem), r.x)
    assert gap <= PARITY_TOL, f"{problem} warm on cluster: gap {gap:.3e}"
