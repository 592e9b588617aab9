"""Port parity for the cluster runtime's acceptance soak: the mirror of
``tests/test_chaos.py::test_chaos_soak_elastic_recovery`` on
``repro_torch.cluster`` (the rest of that file is mirrored in
``tests/test_torch_chaos.py``). Four worker processes on the CPU, 40
iterations, a seeded schedule with a mid-solve join, a SIGKILL, a SIGSTOP
hang, delays and a drop; the solve self-heals and lands within 1e-5 of
the JAX package's single-process x. Its limits: the reference's
``register_timeout_s``, a 10 s heartbeat timeout (a SIGSTOP is only seen
by heartbeat age) and ``DegradePolicy(iter_deadline_s=40.0)``."""
import numpy as np
import jax
import torch

from repro.core.prox import make_logistic
from repro.core.unwrapped import UnwrappedADMM
from repro_torch.cluster.chaos import ChaosSchedule

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TAU = 0.1
TINY = dict(eps_rel=1e-9, eps_abs=1e-12)   # fixed-iteration parity runs


def _problem(m=1200, n=20, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n)).astype(np.float32)
    aux = np.sign(rng.standard_normal((m,))).astype(np.float32)
    return D, aux


def _reference(D, aux, iters):
    """The JAX package's single-process x after ``iters`` iterations."""
    solver = UnwrappedADMM(loss=make_logistic(), tau=TAU)
    return np.asarray(solver.run(D[None], aux[None], iters=iters).x)


def _cluster_cfg(**kw):
    from repro_torch.cluster.coordinator import ClusterConfig
    kw.setdefault("device", "cpu")
    kw.setdefault("heartbeat_timeout_s", 30)
    kw.setdefault("register_timeout_s", 300)
    return ClusterConfig(**kw)


def test_chaos_soak_elastic_recovery(tmp_path):
    """THE acceptance soak: 4 workers, 40 iterations, seeded schedule
    with a mid-solve join, a SIGKILL, a SIGSTOP hang, delays and a drop
    — the solve self-heals through all of it and lands within 1e-5 of
    the single-process answer, with full block coverage and recovery
    metrics in the telemetry. Reproducible from the recorded seed."""
    from repro_torch.cluster.coordinator import DegradePolicy, cluster_solve
    SEED = 7
    sched = ChaosSchedule.generate(SEED, n_workers=4, iters=40)
    kinds = sched.counts()
    assert kinds["join"] >= 1 and kinds["kill"] >= 1 \
        and kinds["stop"] >= 1 and kinds["delay"] >= 1 \
        and kinds["drop"] >= 1
    D, aux = _problem()
    ref_x = _reference(D, aux, iters=40)
    res = cluster_solve(
        D, aux, {"name": "logistic"}, tau=TAU, max_iters=40,
        config=_cluster_cfg(
            n_workers=4, chaos=sched,
            heartbeat_timeout_s=10,           # SIGSTOP is only detectable
                                              # by heartbeat age
            degrade=DegradePolicy(iter_deadline_s=40.0,
                                  deadline_retries=4),
            reconnect={"retries": 4, "backoff_s": 0.25,
                       "backoff_max_s": 2.0}),
        store_dir=str(tmp_path / "store"), block_rows=150, **TINY)
    rel = np.linalg.norm(res.x - ref_x) / np.linalg.norm(ref_x)
    assert rel <= 1e-5, rel
    assert res.iters == 40
    assert res.status in ("converged", "max_iters")   # NOT degraded
    t = res.telemetry
    killed = {int(e.target[1:]) for e in sched.for_kind("kill")}
    stopped = {int(e.target[1:]) for e in sched.for_kind("stop")}
    assert killed | stopped <= set(t["deaths"])
    assert t["joins"] >= 1
    assert t["blocks_rebalanced"] >= 1        # the joiner got real work
    assert t["blocks_reassigned"] >= 1        # deaths respread blocks
    rec = t["recovery"]
    assert rec["time_to_recover_s"] is not None \
        and rec["time_to_recover_s"] > 0
    assert rec["join_to_contributing_s"] is not None
    assert any(e["kind"] == "death" for e in rec["events"])
    assert any(e["kind"] == "join" for e in rec["events"])
    # the run is replayable: seed + spec round-trip from the telemetry
    assert t["chaos_seed"] == SEED
    assert ChaosSchedule.generate(SEED, n_workers=4,
                                  iters=40).to_spec() == t["chaos_spec"]
