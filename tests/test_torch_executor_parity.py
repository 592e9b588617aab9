"""Executor parity of the port: the local and streaming columns of
``tests/test_executor_parity.py``, run by ``repro_torch.exec`` and held to
the JAX package's converged LOCAL x at ``PARITY_TOL`` (1e-5, rel
sup-norm), on the shared problems of ``tests/exec_fixtures.py``:

  * cold: the five parity problems on the streaming executor;
  * warm: the three new problems on {local, streaming}, warm-started from
    the JAX package's partial iterate, against its local warm solution;
  * resume: the three new problems on {local, streaming}, checkpointed at
    25 iterations and resumed to convergence, against the JAX package's
    local resumed solution.

The shard_map and cluster columns wait for ROADMAP items 8 and 9;
``test_telemetry_stamps_executor`` waits for observability (item 10)."""
import jax

jax.config.update("jax_platform_name", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from exec_fixtures import (  # noqa: E402
    NEW_PROBLEMS,
    PARITY_CONFIGS,
    PARITY_PROBLEMS,
    PARITY_TOL,
    SOLVE_KW,
    parity_problem,
    rel_gap,
)
from repro.exec import fit_on_executor as j_fit  # noqa: E402
from repro_torch.exec import problems as tprob  # noqa: E402

torch.set_num_threads(1)

WARM_ITERS = 30
PARTIAL = dict(max_iters=25, checkpoint_every=10)


def _port_problem(name):
    """The port's twin of ``parity_problem(name)`` on the same arrays."""
    import dataclasses
    kw, rho = PARITY_CONFIGS[name]
    prob = tprob.make_problem(name, **kw)
    if rho is not None:
        prob = dataclasses.replace(prob, rho=rho)
    _, D, aux = parity_problem(name)
    return prob, D, aux


def _fit(name, executor, **kw):
    prob, D, aux = _port_problem(name)
    return tprob.fit_on_executor(prob, executor, D, aux, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref_cache():
    cache = {}

    def get(name):
        if name not in cache:
            prob, D, aux = parity_problem(name)
            cache[name] = np.asarray(j_fit(prob, "local", D, aux,
                                           **SOLVE_KW).x)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def warm_x0():
    cache = {}

    def get(name):
        if name not in cache:
            prob, D, aux = parity_problem(name)
            cache[name] = np.asarray(j_fit(prob, "local", D, aux,
                                           max_iters=WARM_ITERS,
                                           eps_rel=1e-12, eps_abs=1e-15).x)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def warm_ref(warm_x0):
    cache = {}

    def get(name):
        if name not in cache:
            prob, D, aux = parity_problem(name)
            cache[name] = np.asarray(j_fit(prob, "local", D, aux,
                                           x0=warm_x0(name), **SOLVE_KW).x)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def resume_ref(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            ckpt = str(tmp_path_factory.mktemp(f"jresume_{name}") / "ckpt")
            prob, D, aux = parity_problem(name)
            j_fit(prob, "local", D, aux, checkpoint_dir=ckpt, **PARTIAL)
            cache[name] = np.asarray(j_fit(prob, "local", D, aux,
                                           checkpoint_dir=ckpt, resume=True,
                                           **SOLVE_KW).x)
        return cache[name]

    return get


@pytest.mark.parametrize("problem", PARITY_PROBLEMS)
def test_cold_parity(problem, ref_cache):
    r = _fit(problem, "streaming", **SOLVE_KW)
    gap = rel_gap(ref_cache(problem), r.x.numpy())
    assert gap <= PARITY_TOL, f"{problem} on streaming: gap {gap:.3e}"


@pytest.mark.parametrize("executor", ["local", "streaming"])
@pytest.mark.parametrize("problem", NEW_PROBLEMS)
def test_warm_start_parity(problem, executor, warm_x0, warm_ref):
    r = _fit(problem, executor, x0=warm_x0(problem), **SOLVE_KW)
    gap = rel_gap(warm_ref(problem), r.x.numpy())
    assert gap <= PARITY_TOL, f"{problem} warm on {executor}: gap {gap:.3e}"


@pytest.mark.parametrize("executor", ["local", "streaming"])
@pytest.mark.parametrize("problem", NEW_PROBLEMS)
def test_checkpoint_resume_parity(problem, executor, resume_ref, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _fit(problem, executor, checkpoint_dir=ckpt, **PARTIAL)
    r = _fit(problem, executor, checkpoint_dir=ckpt, resume=True,
             **SOLVE_KW)
    gap = rel_gap(resume_ref(problem), r.x.numpy())
    assert gap <= PARITY_TOL, f"{problem} resume on {executor}: gap {gap:.3e}"
