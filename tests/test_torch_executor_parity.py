"""Executor parity of the port: the local, streaming and shard_map columns
of ``tests/test_executor_parity.py``, run by ``repro_torch.exec`` and held
to the JAX package's converged LOCAL x at ``PARITY_TOL`` (1e-5, rel
sup-norm), on the shared problems of ``tests/exec_fixtures.py``:

  * cold: the five parity problems on the streaming and shard_map
    executors;
  * warm: the three new problems on {local, streaming, shard_map},
    warm-started from the JAX package's partial iterate, against its local
    warm solution;
  * resume: the three new problems on {local, streaming, shard_map},
    checkpointed at 25 iterations and resumed to convergence, against the
    JAX package's local resumed solution; for shard_map also resumed at
    another world size, and from the JAX package's ``ShardMapExecutor``
    checkpoint.

The shard_map column runs on gloo ranks on the CPU at world 4 (the
world-size change resumes at world 3); the ranks are spawned once for the
module and run every case, and each case's x and iteration count must be
bitwise equal on every rank. The cluster column (worker processes) is in
``tests/test_torch_executor_parity_cluster.py``; ``test_telemetry_stamps_
executor`` covers all four executors here."""
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
from repro_torch.exec.shard_map import fit_rank  # noqa: E402
from repro_torch.sharding import compat  # noqa: E402

torch.set_num_threads(1)

WARM_ITERS = 30
PARTIAL = dict(max_iters=25, checkpoint_every=10)
WORLD = 4              # the shard_map column's ranks
RESUME_WORLD = 3       # ... and the world a checkpoint of WORLD resumes at
SPAWN_TIMEOUT = 300


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


# ---------------------------------------------------------------------------
# the shard_map column: gloo ranks, spawned once for the module
# ---------------------------------------------------------------------------

def _call(name, **kw):
    kw_prob, rho = PARITY_CONFIGS[name]
    _, D, aux = parity_problem(name)
    return dict(problem=name, params=kw_prob, rho=rho, D=D, aux=aux, **kw)


@pytest.fixture(scope="module")
def shard_runs(warm_x0, tmp_path_factory):
    """case -> the ranks' results. World 4 runs the cold, warm and resume
    cases, and resumes the JAX ShardMapExecutor's checkpoints; world 3
    then resumes world 4's checkpoints."""
    root = tmp_path_factory.mktemp("shard_map")
    cases = {}
    for name in PARITY_PROBLEMS:
        cases["cold", name] = _call(name, **SOLVE_KW)
    for name in NEW_PROBLEMS:
        cases["warm", name] = _call(name, x0=warm_x0(name), **SOLVE_KW)
        ckpt = str(root / f"port_{name}")
        cases["partial", name] = _call(name, checkpoint_dir=ckpt, **PARTIAL)
        cases["resume", name] = _call(name, checkpoint_dir=ckpt,
                                      resume=True, **SOLVE_KW)
        # the JAX package's shard_map solve (one shard: one CPU device
        # here), checkpointed at 10 and 20 iterations
        jckpt = str(root / f"jax_{name}")
        prob, D, aux = parity_problem(name)
        j_fit(prob, "shard_map", D, aux, checkpoint_dir=jckpt, **PARTIAL)
        cases["jax_resume", name] = _call(name, checkpoint_dir=jckpt,
                                          resume=True, **SOLVE_KW)
    keys = list(cases)
    ranks = compat.spawn(fit_rank, WORLD, "gloo",
                         args=([cases[k] for k in keys], "cpu"),
                         device="cpu", threads=1, timeout=SPAWN_TIMEOUT)
    out = {k: [r[i] for r in ranks] for i, k in enumerate(keys)}
    keys = [("world_resume", name) for name in NEW_PROBLEMS]
    ranks = compat.spawn(
        fit_rank, RESUME_WORLD, "gloo",
        args=([cases["resume", name] for _, name in keys], "cpu"),
        device="cpu", threads=1, timeout=SPAWN_TIMEOUT)
    out.update({k: [r[i] for r in ranks] for i, k in enumerate(keys)})
    return out


@pytest.mark.parametrize("problem", PARITY_PROBLEMS)
def test_shard_map_cold_parity(problem, ref_cache, shard_runs):
    r = shard_runs["cold", problem][0]
    gap = rel_gap(ref_cache(problem), r["x"])
    assert gap <= PARITY_TOL, f"{problem} on shard_map: gap {gap:.3e}"
    assert r["extra"] == {"shards": WORLD, "group_backend": "gloo"}


@pytest.mark.parametrize("problem", NEW_PROBLEMS)
def test_shard_map_warm_start_parity(problem, warm_ref, shard_runs):
    gap = rel_gap(warm_ref(problem), shard_runs["warm", problem][0]["x"])
    assert gap <= PARITY_TOL, f"{problem} warm on shard_map: gap {gap:.3e}"


@pytest.mark.parametrize("problem", NEW_PROBLEMS)
def test_shard_map_checkpoint_resume_parity(problem, resume_ref,
                                            shard_runs):
    gap = rel_gap(resume_ref(problem), shard_runs["resume", problem][0]["x"])
    assert gap <= PARITY_TOL, f"{problem} resume on shard_map: gap {gap:.3e}"


@pytest.mark.parametrize("problem", NEW_PROBLEMS)
def test_shard_map_resume_at_another_world_size(problem, resume_ref,
                                                shard_runs):
    """A checkpoint written by 4 ranks resumes on 3: every rank reads the
    global y and lam and takes its rows."""
    r = shard_runs["world_resume", problem][0]
    assert r["extra"]["shards"] == RESUME_WORLD
    gap = rel_gap(resume_ref(problem), r["x"])
    assert gap <= PARITY_TOL, \
        f"{problem} resumed at world {RESUME_WORLD}: gap {gap:.3e}"


@pytest.mark.parametrize("problem", NEW_PROBLEMS)
def test_shard_map_resumes_jax_checkpoint(problem, resume_ref, shard_runs):
    """The JAX package's ShardMapExecutor checkpoint (kind
    ``shard_map_solve``, global unpadded y and lam) resumes in the port."""
    gap = rel_gap(resume_ref(problem),
                  shard_runs["jax_resume", problem][0]["x"])
    assert gap <= PARITY_TOL, \
        f"{problem} from the JAX checkpoint: gap {gap:.3e}"


def test_shard_map_ranks_agree_bitwise(shard_runs):
    """Every rank ends with the same x bits and the same iteration count
    (the stopping rule reads only rank-order sums)."""
    for key, ranks in shard_runs.items():
        for r in ranks[1:]:
            assert r["iters"] == ranks[0]["iters"], key
            assert np.array_equal(r["x"].view(np.uint32),
                                  ranks[0]["x"].view(np.uint32)), key


@pytest.mark.parametrize("executor", ["local", "streaming", "shard_map",
                                      "cluster"])
def test_telemetry_stamps_executor(executor, tmp_path):
    """Every telemetry record carries the executor name + resolved
    engine backend, so mixed-topology runs stay attributable. The
    cluster's coordinator owns its run directory (``obs_dir``), as in the
    reference; its two workers have the cluster tests' limits."""
    from repro_torch.cluster.coordinator import ClusterConfig
    from repro_torch.obs import Observability, read_jsonl
    prob, D, aux = _port_problem("logistic")
    rundir = str(tmp_path / "obs")
    kw = dict(max_iters=5, eps_rel=1e-12, eps_abs=1e-15, device="cpu")
    if executor == "cluster":
        tprob.fit_on_executor(prob, executor, D, aux, cluster_config=(
            ClusterConfig(n_workers=2, device="cpu", obs_dir=rundir,
                          heartbeat_timeout_s=30, register_timeout_s=300)),
            store_dir=str(tmp_path / "store"), **kw)
    else:
        obs = Observability.create(rundir)
        tprob.fit_on_executor(prob, executor, D, aux, obs=obs, **kw)
        obs.finish()
    recs = [r for r in read_jsonl(str(tmp_path / "obs" / "telemetry.jsonl"))
            if "iter" in r]
    assert len(recs) == 5, "no telemetry written"
    for rec in recs:
        assert rec["executor"] == executor
        assert rec["backend"]       # resolved engine backend, non-empty
