"""Port parity for the fit service's in-process layers,
``repro_torch.service.batching`` and ``repro_torch.service.server``, on
the CPU (``device="cpu"``).

The mirrors of ``tests/test_service.py`` from the batched solves on
(multi-RHS, the mu path, NNLS lanes, the FitServer cache contract,
coalescing, ingest / retire, the full-solve fallback, rhs gating, LRU
eviction, thread safety, flush poisoning, atomic ingest / retire), and of
the tests before them that no other port file mirrors (the registry's
problem list and errors, ridge, elastic net, NNLS, huber and the warm
start through ``fit()``), with the reference's assertions and
tolerances. The stats tests are in ``tests/test_torch_stats.py``; the
pytree test has no counterpart (the port's stats are a plain dataclass).

Parity: the JAX ``FitServer`` and the port's, fed the same numpy arrays,
give equal fingerprints, equal counter snapshots (latency aside) and x
within the reference tests' tolerances; the lane-batched FASTA is held
lane by lane to JAX's vmapped ``batched_quad_prox`` and to the port's
single solve, on lanes that stop at different iterations.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import lasso_problem
from repro.service import FitRequest as JRequest
from repro.service import FitServer as JServer
from repro.service.batching import batched_quad_prox as j_batched_quad_prox
from repro_torch.core import gram as gram_lib
from repro_torch.core.fasta import transpose_reduction_lasso
from repro_torch.core.fit import fit as tfit
from repro_torch.service import (
    FitRequest,
    FitServer,
    SufficientStats,
    registry,
)
from repro_torch.service.batching import (
    batched_gram_solve,
    batched_quad_prox,
    lasso_mu_path,
    rhs_chunked,
)

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)


def fit(problem, D, aux, **kw):
    return tfit(problem, D, aux, device="cpu", **kw)


def Server(**kw):
    return FitServer(device="cpu", **kw)


def _data(m=300, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)).astype(np.float32),
            rng.standard_normal(m).astype(np.float32))


def _lasso(seed, N=4, m_per_node=100, n=12):
    lp = lasso_problem(jax.random.PRNGKey(seed), N=N, m_per_node=m_per_node,
                       n=n)
    return np.array(lp.D), np.array(lp.b), float(lp.mu)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _x_ref(D, b, ridge=1.0):
    D64, b64 = D.astype(np.float64), b.astype(np.float64)
    return np.linalg.solve(D64.T @ D64 + ridge * np.eye(D.shape[1]),
                           D64.T @ b64)


# ---------------------------------------------------------------------------
# Registry and fit(): the tests of tests/test_service.py before the batched
# solves that no other port file mirrors
# ---------------------------------------------------------------------------

def test_registry_exposes_at_least_seven_problems():
    assert len(registry.problems()) >= 7
    for p in ("lasso", "logistic", "svm", "sparse_logistic", "ridge",
              "elastic_net", "huber", "nnls"):
        assert p in registry.problems(), p


def test_registry_rejects_unknown_combo():
    D = np.zeros((1, 4, 2), np.float32)
    with pytest.raises(ValueError, match="registered problems"):
        fit("isotonic", D, np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError, match="methods"):
        fit("ridge", D, np.zeros((1, 4), np.float32), method="consensus")


def test_ridge_matches_normal_equations():
    D, b = _data()
    r = fit("ridge", D.reshape(4, 75, 16), b.reshape(4, 75), mu=2.0)
    x_ref = np.linalg.solve(D.T @ D + 2.0 * np.eye(16), D.T @ b)
    np.testing.assert_allclose(r.x.numpy(), x_ref, rtol=1e-4, atol=1e-5)


def test_elastic_net_reduces_to_lasso_at_zero_l2():
    D, b, mu = _lasso(0)
    r_en = fit("elastic_net", D, b, mu=mu, l2=0.0, iters=1500)
    r_la = fit("lasso", D, b, mu=mu, iters=1500)
    np.testing.assert_allclose(r_en.x.numpy(), r_la.x.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_nnls_is_nonnegative_and_kkt():
    D, b = _data()
    r = fit("nnls", D.reshape(4, 75, 16), b.reshape(4, 75), iters=2000)
    x = r.x.numpy()
    assert (x >= 0).all()
    # KKT: gradient >= 0 where x == 0, ~0 where x > 0
    g = (D.T @ D) @ x - D.T @ b
    assert g[x > 1e-6].max(initial=-np.inf) < 1e-2
    assert g[x <= 1e-6].min(initial=np.inf) > -1e-2


def test_huber_tracks_least_squares_for_large_delta():
    D, b = _data()
    r = fit("huber", D.reshape(4, 75, 16), b.reshape(4, 75), delta=100.0,
            iters=400)
    x_ls = np.linalg.lstsq(D, b, rcond=None)[0]
    np.testing.assert_allclose(r.x.numpy(), x_ls, rtol=5e-2, atol=5e-3)


def test_warm_start_resumes_at_solution():
    """x0 is honoured: restarting from the solution stays at the solution."""
    D, b = _data()
    Dn, bn = D.reshape(4, 75, 16), b.reshape(4, 75)
    r1 = fit("huber", Dn, bn, delta=1.0, iters=300)
    r2 = fit("huber", Dn, bn, delta=1.0, iters=20, x0=r1.x)
    cold = fit("huber", Dn, bn, delta=1.0, iters=20)
    h1 = float(r1.objective_history[-1])
    assert float(r2.objective_history[0]) < float(cold.objective_history[0])
    assert abs(float(r2.objective_history[-1]) - h1) < 1e-2 * abs(h1)


# ---------------------------------------------------------------------------
# Batched solving
# ---------------------------------------------------------------------------

def test_batched_multi_rhs_matches_per_request():
    D, _ = _data()
    rng = np.random.default_rng(2)
    B = rng.standard_normal((300, 8)).astype(np.float32)
    Dt, Bt = _t(D), _t(B)
    L = gram_lib.gram_factor(Dt.T @ Dt, ridge=1.0)
    C = rhs_chunked(Dt, Bt)                     # (n, 8)
    X = batched_gram_solve(L, C.T)              # (8, n)
    for j in range(8):
        x_j = gram_lib.gram_solve(L, Dt.T @ Bt[:, j])
        np.testing.assert_allclose(X[j].numpy(), x_j.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_rhs_chunked_sums_the_reference_blocks():
    """On the CPU the blocks are the reference's 1024 rows (a ragged
    tail included), summed in block order."""
    rng = np.random.default_rng(9)
    D = _t(rng.standard_normal((2500, 7)).astype(np.float32))
    B = _t(rng.standard_normal((2500, 3)).astype(np.float32))
    want = torch.zeros((7, 3))
    for s in range(0, 2500, 1024):
        want = want + D[s:s + 1024].T @ B[s:s + 1024]
    assert torch.equal(rhs_chunked(D, B), want)
    from repro.service.batching import rhs_chunked as j_rhs
    np.testing.assert_allclose(
        rhs_chunked(D, B).numpy(),
        np.asarray(j_rhs(jnp.asarray(D.numpy()), jnp.asarray(B.numpy()))),
        rtol=1e-5, atol=1e-4)


def test_batched_lasso_matches_per_mu():
    D, b, mu0 = _lasso(1)
    Dflat = _t(D.reshape(-1, 12))
    G, c = gram_lib.gram_and_rhs_chunked(Dflat, _t(b.reshape(-1)))
    mus = np.asarray([0.5, 2.0, 8.0], np.float32) * mu0 / 4.0
    X = lasso_mu_path(G, c, mus, iters=800)
    for j, mu in enumerate(mus):
        x_j = transpose_reduction_lasso(G, c, float(mu), iters=800).x
        np.testing.assert_allclose(X[j].numpy(), x_j.numpy(), rtol=1e-3,
                                   atol=1e-4)


def test_batched_nnls_lanes():
    D, _ = _data()
    rng = np.random.default_rng(3)
    C = _t(rng.standard_normal((4, 16)).astype(np.float32))
    G = _t(D.T @ D)
    X, _ = batched_quad_prox(G, C, torch.zeros((4,)), kind="nnls",
                             iters=500)
    assert (X.numpy() >= 0).all()


@pytest.mark.parametrize("kind", ["lasso", "elastic_net", "nnls"])
def test_lane_fasta_matches_vmapped_reference_and_single_solves(kind):
    """Lanes that stop at different iterations: a finished lane keeps its
    x while the others move (the reference's vmap; the port's masks). Cut
    at 8 iterations, every lane's count and x equal JAX's vmapped solve and
    the port's single solve (lanes stop at 1, 5 and 8). Run to 400, x still
    agrees lane by lane; the counts then follow f32 rounding (FASTA stops
    at an exact fixed point of its own summation order, and the
    reference's vmapped and single solves already differ there)."""
    D, b, mu0 = _lasso(4, n=16)
    D2, b2 = D.reshape(-1, 16), b.reshape(-1)
    rng = np.random.default_rng(5)
    G = (D2.T @ D2).astype(np.float32)
    c = (D2.T @ b2).astype(np.float32)
    C = np.stack([c, 0.5 * c, c + rng.standard_normal(16).astype(
        np.float32), -np.abs(c) - 1.0, -c]).astype(np.float32)
    mus = np.asarray([0.1, 0.5, 1.0, 100.0, 0.02], np.float32) * mu0 * 10
    l2 = 0.3 if kind == "elastic_net" else 0.0
    solver = registry.GRAM_SOLVERS[kind]
    for iters in (8, 400):
        Xt, it_t = batched_quad_prox(_t(G), _t(C), _t(mus), kind=kind,
                                     l2=l2, iters=iters)
        Xj, it_j = j_batched_quad_prox(jnp.asarray(G), jnp.asarray(C),
                                       jnp.asarray(mus), kind=kind, l2=l2,
                                       iters=iters)
        np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-3,
                                   atol=1e-4)
        singles = [solver(_t(G), _t(C[j]), mu=float(mus[j]), l2=l2,
                          iters=iters) for j in range(len(mus))]
        for j, (x1, _, _) in enumerate(singles):
            np.testing.assert_allclose(Xt[j].numpy(), x1.numpy(),
                                       rtol=1e-3, atol=1e-4)
        if iters == 8:
            want = [int(i1) for _, i1, _ in singles]
            assert it_t.tolist() == np.asarray(it_j).tolist() == want
            assert len(set(want)) >= 2 and 1 in want and 8 in want, want
        else:
            assert it_t[3] == 1 and 1 < it_t.max() <= iters


def test_ridge_lanes_loop_over_the_registered_solver():
    D, _ = _data()
    rng = np.random.default_rng(6)
    C = _t(rng.standard_normal((3, 16)).astype(np.float32))
    G = _t(D.T @ D)
    mus = [0.5, 1.0, 4.0]
    X, its = batched_quad_prox(G, C, mus, kind="ridge")
    assert its.tolist() == [1, 1, 1]
    for j, mu in enumerate(mus):
        x1, _, _ = registry.GRAM_SOLVERS["ridge"](G, C[j], mu=mu)
        assert torch.equal(X[j], x1)


# ---------------------------------------------------------------------------
# FitServer: cache contract + coalescing
# ---------------------------------------------------------------------------

def test_server_warm_fit_skips_gram_pass():
    D, b = _data()
    srv = Server(window=1)
    fp = srv.register_dataset(D, b)
    assert srv.counters.gram_passes == 1
    r1 = srv.serve([FitRequest(problem="ridge", fingerprint=fp, mu=1.0)])
    assert srv.counters.gram_passes == 1        # no recompute on first fit
    r2 = srv.serve([FitRequest(problem="ridge", fingerprint=fp, mu=1.0)])
    assert srv.counters.gram_passes == 1        # ...nor on the warm fit
    assert srv.counters.factorizations == 1     # factor cached too
    assert srv.counters.factor_cache_hits >= 1
    np.testing.assert_allclose(r1[0].x, r2[0].x, rtol=1e-6)
    assert r1[0].x.dtype == np.float32 and isinstance(r1[0].x, np.ndarray)


def test_server_batched_solve_matches_single_solves():
    D, b = _data()
    rng = np.random.default_rng(4)
    B = rng.standard_normal((300, 6)).astype(np.float32)
    srv = Server(window=6)
    fp = srv.register_dataset(D)
    reqs = [FitRequest(problem="ridge", fingerprint=fp, b=B[:, j], mu=1.0)
            for j in range(6)]
    resp = srv.serve(reqs)
    assert len(resp) == 6 and resp[0].batch_size == 6
    Dt = _t(D)
    L = gram_lib.gram_factor(Dt.T @ Dt, ridge=1.0)
    for j, r in enumerate(sorted(resp, key=lambda r: r.request_id)):
        x_ref = gram_lib.gram_solve(L, Dt.T @ _t(B[:, j]))
        np.testing.assert_allclose(r.x, x_ref.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_server_lasso_group_vmaps_over_mu():
    D, b, mu0 = _lasso(2)
    srv = Server(window=3)
    fp = srv.register_dataset(D, b)
    mus = [mu0 * s for s in (0.2, 0.5, 1.0)]
    resp = srv.serve([FitRequest(problem="lasso", fingerprint=fp, mu=mu,
                                 iters=800) for mu in mus])
    assert len(resp) == 3 and resp[0].batch_size == 3
    assert srv.counters.gram_passes == 1
    for mu, r in zip(mus, sorted(resp, key=lambda r: r.request_id)):
        ref = fit("lasso", D, b, mu=mu, iters=800)
        np.testing.assert_allclose(r.x, ref.x.numpy(), rtol=1e-3,
                                   atol=1e-4)


def test_server_ingest_updates_factor_in_place():
    D, b = _data()
    srv = Server(window=1)
    fp = srv.register_dataset(D[:250], b[:250])
    srv.serve([FitRequest(problem="ridge", fingerprint=fp, mu=1.0)])
    assert srv.counters.factorizations == 1
    fp2 = srv.ingest_block(fp, D[250:], b[250:])
    assert fp2 != fp
    assert srv.counters.factor_updates == 1     # rank-k, not refactorized
    r = srv.serve([FitRequest(problem="ridge", fingerprint=fp2, mu=1.0)])
    assert srv.counters.factorizations == 1     # still the one factorization
    np.testing.assert_allclose(r[0].x, _x_ref(D, b), rtol=1e-3, atol=1e-3)


def test_server_full_solve_fallback():
    rng = np.random.default_rng(5)
    D = rng.standard_normal((200, 8)).astype(np.float32)
    labels = np.sign(D @ np.ones((8,), np.float32) + 0.1)
    srv = Server(window=1)
    fp = srv.register_dataset(D)
    resp = srv.serve([FitRequest(problem="logistic", fingerprint=fp,
                                 b=labels, iters=100)])
    assert resp[0].from_cache is False
    assert srv.counters.full_solves == 1
    acc = np.mean(np.sign(D @ resp[0].x) == labels)
    assert acc > 0.9


def test_server_rejects_l1_requests_without_mu():
    D, b = _data()
    srv = Server(window=1)
    fp = srv.register_dataset(D, b)
    out = srv.serve([FitRequest(problem="lasso", fingerprint=fp)])
    assert len(out) == 1
    assert out[0].status == "error" and "no mu" in out[0].error


def test_server_full_solve_reuses_registered_labels():
    rng = np.random.default_rng(6)
    D = rng.standard_normal((200, 8)).astype(np.float32)
    labels = np.sign(D @ np.ones((8,), np.float32) + 0.1)
    srv = Server(window=1)
    fp = srv.register_dataset(D, labels)
    resp = srv.serve([FitRequest(problem="logistic", fingerprint=fp,
                                 iters=100)])          # b=None: reuse
    acc = np.mean(np.sign(D @ resp[0].x) == labels)
    assert acc > 0.9


def test_server_unlabeled_ingest_invalidates_registered_rhs():
    """An unlabeled block grows G but not c: serving the stale c would
    silently mix new-rows Gram with old-rows rhs."""
    D, b = _data()
    srv = Server(window=1)
    fp = srv.register_dataset(D[:250], b[:250])
    fp2 = srv.ingest_block(fp, D[250:])          # no labels for the block
    out = srv.serve([FitRequest(problem="ridge", fingerprint=fp2, mu=1.0)])
    assert out[0].status == "error"
    assert "none was registered" in out[0].error
    # fresh-b requests still work: G is consistent, only c went stale
    resp = srv.serve([FitRequest(problem="ridge", fingerprint=fp2, b=b,
                                 mu=1.0)])
    np.testing.assert_allclose(resp[0].x, _x_ref(D, b), rtol=1e-3,
                               atol=1e-3)


def test_register_stats_gates_rhs_on_full_labeling():
    """Partially-labeled stats adopted on a replica must refuse b=None
    solves — fully_labeled travels with the stats."""
    D, b = _data()
    partial = SufficientStats.zero(16, device="cpu").update(D[:200]).update(
        D[200:], b[200:])                       # only the tail is labeled
    assert not partial.fully_labeled
    srv = Server(window=1)
    fp = srv.register_stats(partial)
    out = srv.serve([FitRequest(problem="ridge", fingerprint=fp, mu=1.0)])
    assert out[0].status == "error"
    assert "none was registered" in out[0].error
    full = SufficientStats.from_data(D, b, device="cpu")
    assert full.fully_labeled
    fp2 = srv.register_stats(full)
    assert len(srv.serve([FitRequest(problem="ridge", fingerprint=fp2,
                                     mu=1.0)])) == 1


def test_multi_rhs_stats_single_pass():
    """from_data with stacked (m, r) rhs matches per-column reductions."""
    D, _ = _data()
    rng = np.random.default_rng(7)
    B = rng.standard_normal((300, 3)).astype(np.float32)
    s = SufficientStats.from_data(D, B, device="cpu")
    assert tuple(s.c.shape) == (16, 3)
    np.testing.assert_allclose(s.c.numpy(), D.T @ B, rtol=1e-4, atol=1e-3)


def test_register_dataset_keeps_stacked_rhs_2d():
    """(m, r) stacked right-hand sides must not be flattened against D."""
    D, _ = _data()
    rng = np.random.default_rng(8)
    B = rng.standard_normal((300, 2)).astype(np.float32)
    srv = Server(window=1)
    fp = srv.register_dataset(D, B)
    assert tuple(srv.stats_for(fp).c.shape) == (16, 2)
    np.testing.assert_allclose(srv.stats_for(fp).c.numpy(), D.T @ B,
                               rtol=1e-4, atol=1e-3)
    # a stacked c is not a reusable single rhs
    out = srv.serve([FitRequest(problem="ridge", fingerprint=fp, mu=1.0)])
    assert out[0].status == "error"
    assert "none was registered" in out[0].error
    with pytest.raises(ValueError, match="rows"):
        srv.register_dataset(D, np.zeros((7,), np.float32))
    # node-stacked labels (N, m_i) flatten against node-stacked D
    fp3 = srv.register_dataset(D.reshape(4, 75, 16), B[:, 0].reshape(4, 75))
    assert fp3 == srv.register_dataset(D, B[:, 0])
    assert tuple(srv.stats_for(fp3).c.shape) == (16,)


def test_lasso_honours_l2_as_elastic_net():
    D, b, mu = _lasso(3)
    r_l = fit("lasso", D, b, mu=mu, l2=0.7, iters=1200)
    r_e = fit("elastic_net", D, b, mu=mu, l2=0.7, iters=1200)
    np.testing.assert_allclose(r_l.x.numpy(), r_e.x.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_batched_quad_prox_unknown_kind():
    G = torch.eye(4)
    with pytest.raises(ValueError, match="no gram solver"):
        batched_quad_prox(G, torch.zeros((2, 4)), torch.zeros((2,)),
                          kind="quantile")


def test_server_lru_eviction():
    D, b = _data()
    srv = Server(window=1, factor_cache_size=2)
    fp = srv.register_dataset(D, b)
    for mu in (1.0, 2.0, 3.0):                  # 3 factors, capacity 2
        srv.serve([FitRequest(problem="ridge", fingerprint=fp, mu=mu)])
    assert srv.counters.factorizations == 3
    assert len(srv._factors) == 2
    srv.serve([FitRequest(problem="ridge", fingerprint=fp, mu=1.0)])
    assert srv.counters.factorizations == 4     # mu=1.0 was evicted


# ---------------------------------------------------------------------------
# robustness: thread safety, flush poisoning, atomic ingest/retire
# ---------------------------------------------------------------------------

def test_server_concurrent_submits_lose_nothing():
    """Many threads hammering submit() concurrently: every request gets
    exactly one response, across auto-flushes and the final flush."""
    D, b = _data()
    srv = Server(window=8)
    fp = srv.register_dataset(D, b)
    n_threads, per_thread = 8, 25
    reqs = [[FitRequest(problem="ridge", fingerprint=fp, mu=1.0)
             for _ in range(per_thread)] for _ in range(n_threads)]
    expected = {r.request_id for batch in reqs for r in batch}
    collected = []
    coll_lock = threading.Lock()

    def worker(batch):
        got = []
        for r in batch:
            got.extend(srv.submit(r))
        with coll_lock:
            collected.extend(got)

    threads = [threading.Thread(target=worker, args=(reqs[i],))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    collected.extend(srv.flush())
    got_ids = [r.request_id for r in collected]
    assert len(got_ids) == len(expected)          # nothing lost
    assert len(set(got_ids)) == len(got_ids)      # nothing double-answered
    assert set(got_ids) == expected
    assert all(r.status == "ok" for r in collected)
    assert srv.counters.responses == n_threads * per_thread


def test_flush_isolates_poisoned_groups():
    """One bad group must not cost sibling groups their responses."""
    D, b = _data()
    srv = Server(window=64)
    fp = srv.register_dataset(D, b)
    good1 = FitRequest(problem="ridge", fingerprint=fp, mu=1.0)
    bad_fp = FitRequest(problem="ridge", fingerprint="f" * 64, mu=1.0)
    bad_mu = FitRequest(problem="lasso", fingerprint=fp)    # mu missing
    good2 = FitRequest(problem="ridge", fingerprint=fp, mu=2.0)
    for r in (good1, bad_fp, bad_mu, good2):
        srv.submit(r)
    out = {r.request_id: r for r in srv.flush()}
    assert len(out) == 4
    assert out[good1.request_id].status == "ok"
    assert out[good2.request_id].status == "ok"
    r1 = out[bad_fp.request_id]
    assert r1.status == "error" and r1.x is None
    assert "unknown dataset fingerprint" in r1.error
    r2 = out[bad_mu.request_id]
    assert r2.status == "error" and "no mu" in r2.error
    assert srv.counters.errors == 2
    assert srv.counters.responses == 4
    np.testing.assert_allclose(out[good1.request_id].x, _x_ref(D, b),
                               rtol=1e-3, atol=1e-3)


def test_ingest_block_failure_leaves_dataset_intact():
    D, b = _data()
    srv = Server()
    fp = srv.register_dataset(D, b)
    srv.serve([FitRequest(problem="ridge", fingerprint=fp, mu=1.0)])
    hits_before = srv.counters.factor_cache_hits
    bad_block = np.ones((10, 7), np.float32)      # wrong width
    with pytest.raises(ValueError, match="does not match dataset width"):
        srv.ingest_block(fp, bad_block)
    out = srv.serve([FitRequest(problem="ridge", fingerprint=fp, mu=1.0)])
    assert out[0].status == "ok"
    assert srv.counters.factor_cache_hits == hits_before + 1


def test_ingest_unknown_fingerprint_is_a_clear_error():
    srv = Server()
    with pytest.raises(KeyError, match="unknown dataset fingerprint"):
        srv.ingest_block("a" * 64, np.ones((4, 3), np.float32))
    with pytest.raises(KeyError, match="unknown dataset fingerprint"):
        srv.retire_block("a" * 64, np.ones((4, 3), np.float32))


def test_retire_rejects_more_rows_than_dataset():
    D, b = _data(m=50)
    srv = Server()
    fp = srv.register_dataset(D, b)
    with pytest.raises(ValueError, match="cannot retire"):
        srv.retire_block(fp, np.ones((51, 16), np.float32))
    assert srv.serve([FitRequest(problem="ridge", fingerprint=fp,
                                 mu=1.0)])[0].status == "ok"


def test_retire_never_ingested_block_detected_before_commit():
    """Downdating by rows that were never ingested drives the factor
    indefinite; the server must detect it and keep the old dataset."""
    D, b = _data()
    srv = Server()
    fp = srv.register_dataset(D, b)
    srv.serve([FitRequest(problem="ridge", fingerprint=fp, mu=1.0)])
    alien = 10.0 * D[:50]                         # energy G never held
    with pytest.raises(ValueError, match="not previously ingested"):
        srv.retire_block(fp, alien)
    out = srv.serve([FitRequest(problem="ridge", fingerprint=fp, mu=1.0)])
    assert out[0].status == "ok"
    np.testing.assert_allclose(out[0].x, _x_ref(D, b), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# Parity with the JAX FitServer on the same numpy arrays
# ---------------------------------------------------------------------------

def _counts(srv):
    snap = dict(srv.counters.snapshot())
    snap.pop("fit_latency_ms", None)
    return snap


def _both(window):
    return JServer(window=window), Server(window=window)


def _parity_ridge_fresh_b(js, ts):
    D, b = _data()
    B = np.random.default_rng(11).standard_normal((300, 5)).astype(
        np.float32)
    fps = js.register_dataset(D), ts.register_dataset(D)
    outs = [s.serve([R(problem="ridge", fingerprint=fp, b=B[:, j], mu=1.5)
                     for j in range(5)])
            for s, R, fp in zip((js, ts), (JRequest, FitRequest), fps)]
    return fps, outs, dict(rtol=1e-4, atol=1e-5)


def _parity_lasso_group(js, ts):
    D, b, mu = _lasso(2)
    fps = js.register_dataset(D, b), ts.register_dataset(D, b)
    outs = [s.serve([R(problem=p, fingerprint=fp, mu=mu * f, l2=l2,
                       iters=800)
                     for p, f, l2 in (("lasso", 0.2, 0.0),
                                      ("lasso", 1.0, 0.0),
                                      ("lasso", 4.0, 0.0),
                                      ("elastic_net", 0.5, 0.4),
                                      ("elastic_net", 2.0, 0.4))])
            for s, R, fp in zip((js, ts), (JRequest, FitRequest), fps)]
    return fps, outs, dict(rtol=1e-3, atol=1e-4)


def _parity_nnls_lanes(js, ts):
    D, b = _data()
    B = np.random.default_rng(12).standard_normal((300, 4)).astype(
        np.float32)
    fps = js.register_dataset(D, b), ts.register_dataset(D, b)
    outs = [s.serve([R(problem="nnls", fingerprint=fp,
                       b=None if j == 0 else B[:, j], iters=500)
                     for j in range(4)])
            for s, R, fp in zip((js, ts), (JRequest, FitRequest), fps)]
    return fps, outs, dict(rtol=1e-3, atol=1e-4)


def _parity_logistic_full(js, ts):
    rng = np.random.default_rng(5)
    D = rng.standard_normal((200, 8)).astype(np.float32)
    labels = np.sign(D @ np.ones((8,), np.float32) + 0.1)
    fps = js.register_dataset(D, labels), ts.register_dataset(D, labels)
    outs = [s.serve([R(problem="logistic", fingerprint=fp, iters=100)])
            for s, R, fp in zip((js, ts), (JRequest, FitRequest), fps)]
    return fps, outs, dict(rtol=2e-4, atol=1e-5)


def _parity_ingest_retire(js, ts):
    D, b = _data()
    fps0 = js.register_dataset(D[:250], b[:250]), \
        ts.register_dataset(D[:250], b[:250])
    outs = []
    fps_all = []
    for s, R, fp in zip((js, ts), (JRequest, FitRequest), fps0):
        s.serve([R(problem="ridge", fingerprint=fp, mu=1.0)])
        fp2 = s.ingest_block(fp, D[250:], b[250:])
        r2 = s.serve([R(problem="ridge", fingerprint=fp2, mu=1.0)])
        fp3 = s.retire_block(fp2, D[250:], b[250:])
        r3 = s.serve([R(problem="ridge", fingerprint=fp3, mu=1.0)])
        assert fp3 == fp
        fps_all.append((fp, fp2, fp3))
        outs.append(r2 + r3)
    return tuple(fps_all), outs, dict(rtol=1e-3, atol=1e-4)


PARITY = {"ridge_fresh_b": (5, _parity_ridge_fresh_b),
          "lasso_group": (5, _parity_lasso_group),
          "nnls_lanes": (4, _parity_nnls_lanes),
          "logistic_full": (1, _parity_logistic_full),
          "ingest_retire": (1, _parity_ingest_retire)}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_server_parity_with_jax(case):
    window, fn = PARITY[case]
    js, ts = _both(window)
    fps, (rj, rt), tol = fn(js, ts)
    assert fps[0] == fps[1]                       # the reference's strings
    assert _counts(js) == _counts(ts)             # latency aside
    assert len(rj) == len(rt) > 0
    for a, c in zip(rj, rt):
        assert (a.status, a.problem, a.batch_size, a.from_cache) == \
            (c.status, c.problem, c.batch_size, c.from_cache) == \
            ("ok", a.problem, a.batch_size, a.from_cache)
        assert a.fingerprint == c.fingerprint
        assert isinstance(c.x, np.ndarray) and c.x.dtype == np.float32
        np.testing.assert_allclose(c.x, np.asarray(a.x), **tol)


def test_server_defaults_to_cuda(monkeypatch):
    import inspect
    from repro_torch.service.frontend import FitFrontend
    for cls in (FitServer, FitFrontend):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FitServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FitFrontend()


# ---------------------------------------------------------------------------
# The serve_fit CLI, in process and networked, at a small size
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--rows", "2000", "--features", "24",
       "--iters", "200"]


@pytest.mark.parametrize("mode", ["probes", "mu_path", "networked"])
def test_serve_fit_cli(mode, capsys):
    from repro_torch.launch import serve_fit
    if mode == "probes":
        out = serve_fit.main(CLI + ["--requests", "12", "--window", "4"])
        c = out["counters"]
        assert (c["gram_passes"], c["rhs_passes"], c["factorizations"],
                c["responses"], c["errors"]) == (1, 3, 1, 12, 0)
        assert all(r.status == "ok" for r in out["responses"])
    elif mode == "mu_path":
        out = serve_fit.main(CLI + ["--requests", "6", "--mu-path"])
        assert tuple(out["X"].shape) == (6, 24)
        assert out["counters"]["gram_passes"] == 1
        nnz = (out["X"].abs() > 1e-5).sum(1)
        assert int(nnz[0]) >= int(nnz[-1])       # mu grows along the path
    else:
        out = serve_fit.main(CLI + ["--port", "0", "--requests", "6",
                                    "--deadline-s", "60"])
        assert out["statuses"] == {"ok": 6} and out["zero_lost"]
        assert out["counters"]["gram_passes"] == 1
        assert out["counters"]["full_solves"] == 2   # every third: logistic
    text = capsys.readouterr().out
    assert "registered 2,000 x 24 dataset" in text
