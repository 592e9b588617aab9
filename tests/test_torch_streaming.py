"""Port parity for the out-of-core streaming solve: ``repro_torch.engine.
streaming`` (``staged``, ``StreamingEngine``, ``solve_streaming``) and
``exec.streaming.StreamingExecutor`` against the port's in-memory solve and
the JAX package's ``solve_streaming`` on the same numpy arrays, at the
tolerances of ``tests/test_streaming.py`` (x rel 2e-4, y atol 2e-3; the
objective history rtol 1e-4): every engine backend (``cuda`` runs K3's
plain version on the CPU), overlap on and off bit for bit, the
pad-objective correction, warm starts, a hinge problem with a ragged tail,
an unlabeled store, residency casts at staging time, ``staged``'s error
and abandonment semantics, pad rows that do not leak, a sparse store and
bitwise checkpoint resume bound to the store's fingerprint."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exec_fixtures import classification_fixture
from repro.core.prox import make_hinge as j_hinge
from repro.core.prox import make_logistic as j_logistic
from repro.core.unwrapped import UnwrappedADMM as JADMM
from repro.data import sparse as jsparse
from repro.data.store import ShardedMatrixStore as JStore
from repro_torch.core import prox as tprox
from repro_torch.core.unwrapped import UnwrappedADMM
from repro_torch.data.sparse import BlockCSR
from repro_torch.data.store import ShardedMatrixStore
from repro_torch.engine import IterationEngine, StreamingEngine, autotune
from repro_torch.engine.streaming import staged, store_pad_objective

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flat():
    p = classification_fixture(N=4, m_per_node=300, n=24)
    return (np.array(p.D).reshape(-1, 24),
            np.array(p.labels).reshape(-1))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _solver(**kw):
    kw.setdefault("loss", tprox.make_logistic())
    kw.setdefault("tau", 0.1)
    return UnwrappedADMM(device="cpu", **kw)


@pytest.fixture(scope="module")
def out_of_core(flat):
    """A block height far below D's 115 KB (genuinely out-of-core) and the
    reference's streamed solve at it."""
    D, a = flat
    br = autotune.streaming_block_rows(D.shape[0], D.shape[1], np.float32,
                                       budget_bytes=16 << 10)
    assert br * D.shape[1] * 4 < D.nbytes
    jres = JADMM(loss=j_logistic(), tau=0.1, backend="chunked") \
        .solve_streaming(JStore.from_arrays(D, a, block_rows=br),
                         max_iters=250)
    return br, jres


@pytest.mark.parametrize("backend", ["reference", "chunked", "cuda"])
def test_solve_streaming_matches_in_memory_and_reference(flat, out_of_core,
                                                         backend):
    D, a = flat
    br, jres = out_of_core
    store = ShardedMatrixStore.from_arrays(D, a, block_rows=br)
    solver = _solver(backend=backend)
    mem = solver.solve(D[None], a[None], max_iters=250)
    stream = solver.solve_streaming(store, max_iters=250, record=True)
    assert _rel(stream.x, mem.x) < 2e-4
    assert tuple(stream.y.shape) == (1, D.shape[0])
    np.testing.assert_allclose(stream.y.numpy().ravel(),
                               mem.y.numpy().ravel(), atol=2e-3)
    assert _rel(stream.x, jres.x) < 2e-4
    np.testing.assert_allclose(stream.y.numpy().ravel(),
                               np.asarray(jres.y).ravel(), atol=2e-3)


def test_solve_streaming_overlap_parity(flat):
    """The staged (producer-thread) and naive synchronous sweeps give the
    same bits: same blocks, same bodies, different scheduling."""
    D, a = flat
    store = ShardedMatrixStore.from_arrays(D, a, block_rows=301)
    solver = _solver(backend="cuda")
    db = solver.solve_streaming(store, max_iters=40, record=True)
    sync = solver.solve_streaming(store, max_iters=40, record=True,
                                  overlap=False)
    naive = solver.solve_streaming(store, max_iters=40, record=True,
                                   prefetch=0)
    for other in (sync, naive):
        assert db.iters == other.iters
        for f in ("x", "y", "lam"):
            assert torch.equal(getattr(db, f), getattr(other, f)), f
        assert torch.equal(db.history.objective, other.history.objective)


def test_solve_streaming_objective_matches_in_memory_history(flat):
    """Streamed history == the in-memory recorded history and the
    reference's streamed one, including the pad-objective correction
    (m % block_rows != 0)."""
    D, a = flat
    store = ShardedMatrixStore.from_arrays(D, a, block_rows=352)  # pad 208
    assert store_pad_objective(store, tprox.make_logistic()) == \
        pytest.approx(208 * np.log(2.0), rel=1e-6)
    solver = _solver()
    iters = 30
    ref = solver.run(D[None], a[None], iters=iters)
    stream = solver.solve_streaming(store, max_iters=iters, record=True)
    k = stream.iters
    np.testing.assert_allclose(stream.history.objective.numpy()[:k],
                               ref.history.objective.numpy()[:k], rtol=1e-4)
    np.testing.assert_allclose(stream.history.primal_res.numpy()[:k],
                               ref.history.primal_res.numpy()[:k],
                               atol=1e-3)
    j = JADMM(loss=j_logistic(), tau=0.1, backend="chunked").solve_streaming(
        JStore.from_arrays(D, a, block_rows=352), max_iters=iters,
        record=True)
    kk = min(k, int(j.iters))
    np.testing.assert_allclose(stream.history.objective.numpy()[:kk],
                               np.asarray(j.history.objective)[:kk],
                               rtol=1e-4)


def test_solve_streaming_warm_start(flat):
    D, a = flat
    store = ShardedMatrixStore.from_arrays(D, a, block_rows=256)
    solver = _solver()
    cold = solver.solve_streaming(store, max_iters=300)
    warm = solver.solve_streaming(store, max_iters=300, x0=cold.x)
    assert warm.iters < cold.iters
    assert _rel(warm.x, cold.x) < 5e-3
    jw = JADMM(loss=j_logistic(), tau=0.1, backend="chunked").solve_streaming(
        JStore.from_arrays(D, a, block_rows=256), max_iters=300,
        x0=jnp.asarray(cold.x.numpy()))
    assert _rel(warm.x, jw.x) < 2e-4


def test_solve_streaming_hinge_ragged_tail(flat):
    """Hinge parity with a ragged tail block (pad-row value 1, not 0 — the
    pad-objective correction for a second loss)."""
    D, a = flat
    store = ShardedMatrixStore.from_arrays(D, a, block_rows=389)
    assert store_pad_objective(store, tprox.make_hinge(1.0)) == \
        pytest.approx(4 * 389 - 1200, rel=1e-6)
    solver = _solver(loss=tprox.make_hinge(1.0), tau=0.5, rho=1.0)
    mem = solver.solve(D[None], a[None], max_iters=200)
    stream = solver.solve_streaming(store, max_iters=200)
    assert _rel(stream.x, mem.x) < 1e-3
    j = JADMM(loss=j_hinge(1.0), tau=0.5, rho=1.0,
              backend="chunked").solve_streaming(
        JStore.from_arrays(D, a, block_rows=389), max_iters=200)
    assert _rel(stream.x, j.x) < 1e-3


def test_solve_streaming_unlabeled_store(flat):
    """A store without aux streams through every has_aux=False branch
    (staging, step, pad objective) — the l1 loss needs no labels."""
    from repro_torch.service.stats import SufficientStats
    D, _ = flat
    store = ShardedMatrixStore.from_arrays(D, block_rows=389)
    assert not store.has_aux and store.block(0)[1] is None
    solver = _solver(loss=tprox.make_l1(0.5), tau=1.0)
    mem = solver.solve(D[None], None, max_iters=120)
    stream = solver.solve_streaming(store, max_iters=120, record=True)
    tol = 1e-4 * max(float(torch.linalg.norm(mem.x)), 1.0)
    assert float(torch.linalg.norm(stream.x - mem.x)) < tol
    assert bool(torch.isfinite(stream.history.objective).all())
    s = SufficientStats.from_store(store, device="cpu")
    assert s.rows == store.m and s.labeled_rows == 0
    assert s.fingerprint == store.fingerprint


def test_streaming_device_dtype_residency(flat):
    """An f64 host store with f32 residency: blocks are cast at staging
    time and the results match the f32 solve; bf16 residency lands within
    the JAX suite's bf16 bound."""
    D, a = flat
    store64 = ShardedMatrixStore.from_arrays(D.astype(np.float64),
                                             a.astype(np.float64),
                                             block_rows=256)
    solver = _solver()
    eng = StreamingEngine(engine=solver.engine, device_dtype="float32")
    assert eng.residency_dtype(store64) == torch.float32
    res64 = solver.solve_streaming(store64, max_iters=150,
                                   device_dtype="float32")
    store32 = ShardedMatrixStore.from_arrays(D, a, block_rows=256)
    res32 = solver.solve_streaming(store32, max_iters=150)
    assert res64.x.dtype == torch.float32
    np.testing.assert_allclose(res64.x.numpy(), res32.x.numpy(), atol=1e-5)
    bf = solver.solve_streaming(store32, max_iters=150,
                                device_dtype="bfloat16")
    assert bf.x.dtype == torch.float32
    assert _rel(bf.x, res32.x) < 5e-3


def test_staged_tuple_payloads_errors_and_abandonment(flat):
    """staged() passes 2-tuple payloads whose first element is an array
    (sentinels are found by identity), raises a producer's error in the
    consumer, and unblocks its producer when the consumer walks away."""
    D, a = flat
    store = ShardedMatrixStore.from_arrays(D, a, block_rows=128)
    items = list(staged(range(store.nblocks),
                        lambda k: store.block(k, padded=True), 2))
    assert len(items) == store.nblocks
    np.testing.assert_array_equal(items[0][0], store.block(0, True)[0])

    def bad(k):
        if k == 3:
            raise RuntimeError("stage failed")
        return k

    with pytest.raises(RuntimeError, match="stage failed"):
        list(staged(range(10), bad, 2))
    before = threading.active_count()
    gen = staged(range(store.nblocks),
                 lambda k: store.block(k, padded=True), 2)
    next(gen)
    gen.close()                       # consumer walks away mid-stream
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_sweep_padded_rows_do_not_leak(flat):
    """Zero pad rows of the tail block contribute nothing to d and the
    stopping-rule scalars, and never reach the host iterates."""
    D, a = flat
    eng = IterationEngine(loss=tprox.make_logistic(), tau=0.1,
                          backend="chunked", device="cpu")
    seng = StreamingEngine(engine=eng)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(24)
                         .astype(np.float32)) * 0.1
    results = {}
    for br in (500, 1200):    # ragged tail (pad 300) vs single block
        store = ShardedMatrixStore.from_arrays(D, a, block_rows=br)
        y = np.zeros((store.m,), np.float32)        # numpy, updated in place
        lam = torch.zeros((store.m,))
        sw = seng.sweep(store, x, y, lam)
        results[br] = (sw.d, float(sw.r_sq), float(sw.dx_sq), y.copy(),
                       lam.clone())
    d_r, r_r, dx_r, y_r, lam_r = results[1200]
    d_p, r_p, dx_p, y_p, lam_p = results[500]
    torch.testing.assert_close(d_p, d_r, rtol=1e-5, atol=1e-4)
    assert abs(r_p - r_r) < 1e-3 * max(abs(r_r), 1.0)
    assert abs(dx_p - dx_r) < 1e-3 * max(abs(dx_r), 1.0)
    np.testing.assert_allclose(y_p, y_r, atol=1e-5)
    torch.testing.assert_close(lam_p, lam_r, atol=1e-5, rtol=0)


def test_sparse_store_streams_like_the_in_memory_sparse_solve():
    """A sparse store: one-block BlockCSRs staged per step (K6's plain
    version on the CPU), the Gram a host pass; x against the in-memory
    sparse solve and the reference's streamed solve."""
    rng = np.random.default_rng(5)
    m, n = 2000, 32
    mask = rng.random((m, n)) < 0.1
    rows, cols = np.nonzero(mask)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    a = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    vals = vals + 0.5 * (a[rows] > 0) * (cols < 4)
    tb = BlockCSR.from_coo(rows, cols.astype(np.int32), vals, m, n,
                           block_m=384, device="cpu")
    store = ShardedMatrixStore.from_sparse(tb, a)
    assert store.sparse and store.nblocks == 6
    solver = _solver(backend="cuda")
    mem = solver.solve(tb, torch.from_numpy(a), max_iters=200)
    stream = solver.solve_streaming(store, max_iters=200, record=True)
    assert _rel(stream.x, mem.x) < 2e-4
    assert abs(stream.iters - mem.iters) <= 5
    over = solver.solve_streaming(store, max_iters=200, overlap=False)
    assert torch.equal(over.x, solver.solve_streaming(store,
                                                      max_iters=200).x)
    jb = jsparse.BlockCSR.from_coo(rows, cols.astype(np.int32), vals, m, n,
                                   block_m=384)
    j = JADMM(loss=j_logistic(), tau=0.1, backend="chunked").solve_streaming(
        JStore.from_sparse(jb, a), max_iters=200)
    assert _rel(stream.x, j.x) < 2e-4


@pytest.mark.parametrize("prefetch", [2, 0])
def test_streaming_resume_is_bitwise_and_bound_to_the_store(tmp_path, flat,
                                                            prefetch):
    D, a = flat
    store = ShardedMatrixStore.from_arrays(D, a, block_rows=256)
    solver = _solver(backend="cuda", eps_rel=1e-12, eps_abs=1e-15)
    kw = dict(checkpoint_every=10, prefetch=prefetch)
    full = solver.solve_streaming(store, max_iters=30,
                                  checkpoint_dir=str(tmp_path / "a"), **kw)
    solver.solve_streaming(store, max_iters=20,
                           checkpoint_dir=str(tmp_path / "b"), **kw)
    resumed = solver.solve_streaming(store, max_iters=30, resume=True,
                                     checkpoint_dir=str(tmp_path / "b"),
                                     **kw)
    assert full.iters == resumed.iters == 30
    for f in ("x", "y", "lam"):
        assert torch.equal(getattr(full, f), getattr(resumed, f)), f
    other = ShardedMatrixStore.from_arrays(D[::-1].copy(), a[::-1].copy(),
                                           block_rows=256)
    with pytest.raises(ValueError, match="different store"):
        solver.solve_streaming(other, max_iters=40, resume=True,
                               checkpoint_dir=str(tmp_path / "b"))
    # a local solve's checkpoint is not a streaming one
    solver.solve(D[None], a[None], max_iters=10, checkpoint_every=5,
                 checkpoint_dir=str(tmp_path / "c"))
    with pytest.raises(ValueError, match="not a streaming checkpoint"):
        solver.solve_streaming(store, max_iters=40, resume=True,
                               checkpoint_dir=str(tmp_path / "c"))
