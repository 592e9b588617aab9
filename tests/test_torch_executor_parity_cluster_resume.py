"""Executor parity of the port, the resume leg of the cluster column of
``tests/test_executor_parity.py`` (the cold and warm legs are in
``tests/test_torch_executor_parity_cluster.py``): the three new problems
on two worker processes on the CPU, checkpointed at 25 iterations and
resumed to convergence, held to the JAX package's local resumed x at
``PARITY_TOL``. The solves have the cluster tests' limits (see
``cluster_fit``)."""
import jax

jax.config.update("jax_platform_name", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

from exec_fixtures import (  # noqa: E402
    NEW_PROBLEMS,
    PARITY_TOL,
    SOLVE_KW,
    rel_gap,
)
from test_torch_executor_parity import PARTIAL  # noqa: E402
from test_torch_executor_parity import resume_ref  # noqa: E402,F401
from test_torch_executor_parity_cluster import cluster_fit  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("problem", NEW_PROBLEMS)
def test_cluster_checkpoint_resume_parity(problem, resume_ref, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    cluster_fit(problem, tmp_path, checkpoint_dir=ckpt, **PARTIAL)
    r = cluster_fit(problem, tmp_path, checkpoint_dir=ckpt, resume=True,
                    **SOLVE_KW)
    gap = rel_gap(resume_ref(problem), r.x)
    assert gap <= PARITY_TOL, f"{problem} resume on cluster: gap {gap:.3e}"
