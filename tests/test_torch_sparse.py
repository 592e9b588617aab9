"""Port parity for the sparse data path: ``repro_torch.data.sparse``
(``BlockCSR``, the generators), ``engine.autotune.sparse_block_m``,
``kernels/spgram`` (the torch bodies and K6's plain version), the engine's
sparse dispatch, ``UnwrappedADMM.run`` / ``solve`` on a ``BlockCSR`` and
the CLI's ``--density``, against the JAX package on the CPU, on the same
numpy triples, at the tolerances of ``tests/test_sparse.py``: matvec and
rmatvec rtol 1e-6; one iteration y/lam atol 3e-5, d/w/v rtol 2e-5 with atol
2e-3 of max |d|; the Gram rtol 1e-5 / atol 1e-3; a run's x rel 2e-4 and
objective rtol 1e-4; the lasso through the stats path rtol 1e-4 / atol
1e-6. The ``cuda``-marked test holds K6 against its plain version on the
card (it skips here)."""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import prox as tprox
from repro_torch.core.unwrapped import UnwrappedADMM
from repro_torch.data import sparse as tsparse
from repro_torch.data.sparse import BlockCSR
from repro_torch.engine import IterationEngine, autotune, gram_stats
from repro_torch.kernels.spgram import ops as tops
from repro_torch.kernels.spgram import ref as tref
from repro_torch.kernels.spgram import spgram as tsp
from repro_torch.launch import fit as fit_cli

torch.set_num_threads(1)

KINDS = ("logistic", "hinge", "l1", "least_squares", "quantile")


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX side, imported by the parity tests only: the card's machine,
    which runs the ``cuda``-marked test, has no JAX."""
    import jax
    import jax.numpy as jnp
    from repro.core import prox as jprox
    from repro.core.unwrapped import UnwrappedADMM as JADMM
    from repro.data import sparse as jsparse
    from repro.engine import IterationEngine as JEngine
    from repro.engine import autotune as jautotune
    from repro.engine import gram_stats as j_gram_stats
    from repro.kernels.spgram import ops as jops
    jax.config.update("jax_platform_name", "cpu")
    return SimpleNamespace(jnp=jnp, prox=jprox, ADMM=JADMM, sparse=jsparse,
                           Engine=JEngine, autotune=jautotune,
                           gram_stats=j_gram_stats, ops=jops)


def _np(a):
    return np.asarray(a.float() if a.dtype == torch.bfloat16 else a)


def _same_layout(t, j):
    """The port's BlockCSR holds the reference's arrays exactly."""
    assert (t.m, t.n, t.nnz) == (j.m, j.n, j.nnz)
    for name in ("indices", "values", "col_indices", "col_values"):
        np.testing.assert_array_equal(_np(getattr(t, name)),
                                      np.asarray(getattr(j, name)))
        assert getattr(t, name).dtype in (torch.int32, torch.float32)


@pytest.fixture(scope="module")
def classif():
    """The JAX suite's fixture (m % block_m != 0: every consumer crosses a
    tail block), built by both packages from the same seed."""
    args = (0, 1100, 24, 0.15)
    t = tsparse.sparse_classification_problem(*args, block_m=256,
                                              device="cpu")
    j = _jax().sparse.sparse_classification_problem(*args, block_m=256)
    return t, j


def _state(m, n, seed=7):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(m).astype(np.float32)
    lam = rng.standard_normal(m).astype(np.float32)
    x = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return y, lam, x


def _pair(*arrays):
    J = _jax()
    return ([torch.from_numpy(a) for a in arrays],
            [J.jnp.asarray(a) for a in arrays])


# ---------------------------------------------------------------------------
# the container and its generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,block_m,dups", [
    (137, 23, 48, False),       # tail block
    (300, 8, 100, False),       # zero-nnz blocks
    (3, 4, 2, True),            # duplicates
    (1000, 40, None, True),     # autotuned block height
])
def test_from_coo_matches_reference(m, n, block_m, dups):
    rng = np.random.default_rng(m)
    nnz = m * n // 5
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    if not dups:
        keep = np.unique(rows * n + cols, return_index=True)[1]
        rows, cols = rows[keep], cols[keep]
    if m == 300:
        keep = rows >= 250
        rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    t = BlockCSR.from_coo(rows, cols, vals, m, n, block_m=block_m,
                          device="cpu")
    j = _jax().sparse.BlockCSR.from_coo(rows, cols, vals, m, n,
                                        block_m=block_m)
    _same_layout(t, j)
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))


def test_dense_round_trip_and_properties():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((137, 23)).astype(np.float32)
    D[rng.random((137, 23)) < 0.8] = 0
    b = BlockCSR.from_dense(D, block_m=48, device="cpu")
    _same_layout(b, _jax().sparse.BlockCSR.from_dense(D, block_m=48))
    np.testing.assert_array_equal(b.to_dense().numpy(), D)
    assert b.shape == (137, 23) and b.device.type == "cpu"
    assert b.nnz == int(np.count_nonzero(D))
    assert b.nblocks == 3 and b.block_m == 48
    assert abs(b.density - b.nnz / (137 * 23)) < 1e-12
    assert b.values.shape[0] * b.values.shape[1] == 144
    assert b.nbytes == sum(a.numel() * 4 for a in (
        b.indices, b.values, b.col_indices, b.col_values))
    # a tensor keeps its device; from_dense of a tensor == of its array
    bt = BlockCSR.from_dense(torch.from_numpy(D)[None], block_m=48)
    _same_layout(bt, _jax().sparse.BlockCSR.from_dense(D, block_m=48))
    half = b.astype(torch.bfloat16)
    assert half.values.dtype == half.col_values.dtype == torch.bfloat16
    assert half.indices.dtype == half.col_indices.dtype == torch.int32
    assert b.astype(torch.float32) is b and b.to("cpu") is b


def test_generators_match_reference():
    J = _jax()
    t = tsparse.random_block_csr(3, 700, 40, 0.05, device="cpu")
    _same_layout(t, J.sparse.random_block_csr(3, 700, 40, 0.05))
    assert abs(t.density - 0.05) < 0.01
    tc = tsparse.sparse_classification_problem(1, 900, 32, 0.1, block_m=128,
                                               device="cpu")
    jc = J.sparse.sparse_classification_problem(1, 900, 32, 0.1,
                                                block_m=128)
    _same_layout(tc.D, jc.D)
    np.testing.assert_array_equal(tc.labels.numpy(), np.asarray(jc.labels))
    tl = tsparse.sparse_lasso_problem(2, 800, 32, 0.1, device="cpu")
    jl = J.sparse.sparse_lasso_problem(2, 800, 32, 0.1)
    _same_layout(tl.D, jl.D)
    for a, b in ((tl.b, jl.b), (tl.x_true, jl.x_true), (tl.mu, jl.mu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_duplicate_column_indices_sum():
    """Duplicates are COO semantics: they SUM, in to_dense and in every
    reduction (the gathers add the slots; no scatter anywhere)."""
    rows = np.array([0, 0, 0, 1, 2, 2])
    cols = np.array([1, 1, 3, 0, 2, 2])
    vals = np.array([1.0, 2.0, 4.0, 5.0, 3.0, -1.0], np.float32)
    b = BlockCSR.from_coo(rows, cols, vals, m=3, n=4, block_m=2,
                          device="cpu")
    want = np.array([[0, 3, 0, 4], [5, 0, 0, 0], [0, 0, 2, 0]], np.float32)
    np.testing.assert_array_equal(b.to_dense().numpy(), want)
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    np.testing.assert_allclose(tops.matvec(b, x).numpy(), want @ x.numpy(),
                               rtol=1e-6)
    u = torch.tensor([1.0, -2.0, 0.5])
    np.testing.assert_allclose(tops.rmatvec(b, u).numpy(),
                               want.T @ u.numpy(), rtol=1e-6)
    G, c = gram_stats(b, u)
    np.testing.assert_allclose(G.numpy(), want.T @ want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(c.numpy(), want.T @ u.numpy(), rtol=1e-5,
                               atol=1e-5)
    # one block alone: block_matvec / block_rmatvec
    np.testing.assert_allclose(
        tsp.block_rmatvec(b.col_indices[0], b.col_values[0],
                          u[:2]).numpy(), want[:2].T @ u[:2].numpy(),
        rtol=1e-6)
    np.testing.assert_allclose(
        tsp.block_matvec(b.indices[1], b.values[1], x)[:1].numpy(),
        want[2:] @ x.numpy(), rtol=1e-6)


def test_zero_nnz_blocks_and_empty_matrix():
    """A block of all-zero rows (and a fully empty matrix) must be legal:
    pad slots only, nothing leaks into any reduction."""
    D = np.zeros((300, 8), np.float32)
    D[250:, :2] = 1.0                    # blocks 0 and 1 are zero-nnz
    b = BlockCSR.from_dense(D, block_m=100, device="cpu")
    np.testing.assert_array_equal(b.to_dense().numpy(), D)
    empty = BlockCSR.from_dense(np.zeros((64, 8), np.float32), block_m=32,
                                device="cpu")
    assert empty.nnz == 0
    np.testing.assert_array_equal(empty.to_dense().numpy(), 0)
    G, _ = gram_stats(empty)
    np.testing.assert_array_equal(G.numpy(), 0)
    y, lam, x = _state(300, 8, seed=0)
    (ty, tl, tx), _ = _pair(y, lam, x)
    eng = IterationEngine(loss=tprox.make_l1(0.3), tau=1.0, device="cpu")
    ref = eng.iterate(torch.from_numpy(D), None, ty, tl, tx)
    st = eng.iterate(b, None, ty, tl, tx)
    for got, want in zip(st, ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    est = eng.iterate(empty, None, ty[:64], tl[:64], tx)
    np.testing.assert_array_equal(est.d.numpy(), 0)


def test_reblock_keeps_the_matrix(classif):
    t, j = classif
    r = t.D.reblock(128)
    assert r.block_m == 128 and r.nblocks == -(-t.D.m // 128)
    _same_layout(r, j.D.reblock(128))
    np.testing.assert_array_equal(r.to_dense().numpy(),
                                  t.D.to_dense().numpy())
    h = t.D.astype(torch.bfloat16).reblock(512)
    assert h.dtype == torch.bfloat16 and h.block_m == 512
    np.testing.assert_array_equal(h.to_dense().float().numpy(),
                                  t.D.astype(torch.bfloat16).to_dense()
                                  .float().numpy())


@pytest.mark.parametrize("m", [300, 1 << 17, 1 << 22])
@pytest.mark.parametrize("kp", [4, 26, 128])
def test_sparse_block_m_matches_reference(m, kp):
    J = _jax()
    for n in (64, 512):
        for tdt, jdt in ((torch.float32, J.jnp.float32),
                         (torch.bfloat16, J.jnp.bfloat16),
                         (np.float64, J.jnp.float64)):
            got = autotune.sparse_block_m(m, n, kp, tdt)
            assert got == J.autotune.sparse_block_m(m, n, kp, jdt)
            assert got % 8 == 0 and got <= -(-m // 8) * 8


def test_matvec_rmatvec_match_reference(classif):
    t, j = classif
    J = _jax()
    m, n = t.D.shape
    rng = np.random.default_rng(3)
    x = rng.standard_normal(n).astype(np.float32)
    u = rng.standard_normal(m).astype(np.float32)
    U = rng.standard_normal((m, 3)).astype(np.float32)
    np.testing.assert_allclose(tops.matvec(t.D, torch.from_numpy(x)),
                               np.asarray(J.ops.matvec(j.D, J.jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    for v in (u, U):
        np.testing.assert_allclose(
            tops.rmatvec(t.D, torch.from_numpy(v)),
            np.asarray(J.ops.rmatvec(j.D, J.jnp.asarray(v))),
            rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tref.matvec_ref(t.D, torch.from_numpy(x)),
                               tops.matvec(t.D, torch.from_numpy(x)),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# one iteration: the engine's sparse body and K6's plain version
# ---------------------------------------------------------------------------

LOSSES = {"logistic": (0.5, (), "make_logistic"),
          "hinge": (1.0, (0.7,), "make_hinge"),
          "l1": (1.0, (0.3,), "make_l1"),
          "least_squares": (2.0, (), "make_least_squares"),
          "quantile": (1.0, (0.3,), "make_quantile"),
          "huber": (1.0, (1.5,), "make_huber")}


def _check_step(got, want, atol_yl=3e-5):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               atol=atol_yl)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               atol=atol_yl)
    scale = max(float(np.abs(np.asarray(want[2])).max()), 1.0)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=2e-5,
                                   atol=2e-3 * scale)


@pytest.mark.parametrize("kind", list(LOSSES))
def test_iterate_sparse_parity(classif, kind):
    """The engine's sparse body (the CPU's torch body) against the JAX
    engine's on the same BlockCSR, and the densify oracle
    (backend="reference") against both."""
    t, j = classif
    J = _jax()
    tau, largs, maker = LOSSES[kind]
    m, n = t.D.shape
    (ty, tl, tx), (jy, jl, jx) = _pair(*_state(m, n))
    ta = None if kind == "l1" else t.labels
    ja = None if kind == "l1" else j.labels
    tloss = getattr(tprox, maker)(*largs)
    jloss = getattr(J.prox, maker)(*largs)
    st = IterationEngine(loss=tloss, tau=tau, device="cpu").iterate(
        t.D, ta, ty, tl, tx)
    want = J.Engine(loss=jloss, tau=tau).iterate(j.D, ja, jy, jl, jx)
    _check_step(st, want)
    assert st.y.shape == (m,) and st.d.shape == (n,)
    ref = IterationEngine(loss=tloss, tau=tau, backend="reference",
                          device="cpu").iterate(t.D, ta, ty, tl, tx)
    _check_step(ref, want)
    _check_step(tref.admm_iter_ref(t.D, ta, ty, tl, tx, loss=tloss,
                                   delta=1.0 / tau), want)
    lean = IterationEngine(loss=tloss, tau=tau, device="cpu").iterate(
        t.D, ta, ty, tl, tx, want_dual=False)
    assert lean.w is None and lean.v is None
    np.testing.assert_array_equal(lean.d.numpy(), st.d.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_plain_version_matches_reference(classif, kind):
    """K6's plain version (the kernels' prox, ``_prox``) against the JAX
    sparse body with the kind's loss, bf16 values too; want_dual off
    gives d alone."""
    t, j = classif
    J = _jax()
    tau, largs, maker = LOSSES[kind]
    jloss = getattr(J.prox, maker)(*largs)
    tloss = getattr(tprox, maker)(*largs)
    m, n = t.D.shape
    (ty, tl, tx), (jy, jl, jx) = _pair(*_state(m, n, seed=11))
    ta = None if kind == "l1" else t.labels
    ja = None if kind == "l1" else j.labels
    kw = dict(kind=kind, delta=tloss.kernel_delta_scale / tau,
              param=tloss.kernel_param)
    got = tops.sparse_admm_iter_full(t.D, ta, ty, tl, tx, **kw)
    want = J.ops.sparse_admm_iter_full(j.D, ja, jy, jl, jx, loss=jloss,
                                       delta=1.0 / tau)
    _check_step(got, want)
    lean = tops.sparse_admm_iter_full(t.D, ta, ty, tl, tx, want_dual=False,
                                      **kw)
    assert lean[3] is None and lean[4] is None
    np.testing.assert_array_equal(lean[2].numpy(), got[2].numpy())
    half = tops.sparse_admm_iter_full(t.D.astype(torch.bfloat16), ta, ty,
                                      tl, tx, **kw)
    jhalf = J.ops.sparse_admm_iter_full(j.D.astype(J.jnp.bfloat16), ja, jy,
                                        jl, jx, loss=jloss, delta=1.0 / tau)
    _check_step(half, jhalf)
    assert half[2].dtype == torch.float32


def test_kernel_wrapper_rejects_what_it_does_not_take(classif):
    t, _ = classif
    m, n = t.D.shape
    (ty, tl, tx), _ = _pair(*_state(m, n))
    with pytest.raises(ValueError, match="huber"):
        tops.sparse_admm_iter_full(t.D, None, ty, tl, tx, kind="huber",
                                   delta=1.0)
    meta = _map(t.D, lambda a: a.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tops.sparse_admm_iter_full(meta, None, ty, tl, tx, kind="l1",
                                   delta=1.0)


def _map(bcsr, fn, values_only=False):
    """The BlockCSR with ``fn`` applied to its value arrays (and to its
    index arrays unless ``values_only``)."""
    idx = (lambda a: a) if values_only else fn
    return dataclasses.replace(
        bcsr, indices=idx(bcsr.indices), values=fn(bcsr.values),
        col_indices=idx(bcsr.col_indices), col_values=fn(bcsr.col_values))


# ---------------------------------------------------------------------------
# the Gram
# ---------------------------------------------------------------------------

def test_gram_matches_reference(classif):
    """scipy's host Gram gives the reference's bits (the same product on
    the same arrays); the RHS and the multi-RHS ride the CSC gather; the
    block-densify fallback agrees with the densify oracle."""
    t, j = classif
    J = _jax()
    G, c = gram_stats(t.D, t.labels)
    jG, jc = J.gram_stats(j.D, j.labels)
    np.testing.assert_array_equal(G.numpy(), np.asarray(jG))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(G.numpy(), tref.gram_ref(t.D).numpy(),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(c.numpy(),
                               tref.gram_rhs_ref(t.D, t.labels).numpy(),
                               rtol=1e-5, atol=1e-3)
    B = np.random.default_rng(1).standard_normal((t.D.m, 3)).astype(
        np.float32)
    _, C = gram_stats(t.D, torch.from_numpy(B))
    np.testing.assert_allclose(
        C.numpy(), tref.gram_rhs_ref(t.D, torch.from_numpy(B)).numpy(),
        rtol=1e-5, atol=1e-3)
    Gf = tops._gram_fallback(t.D, torch.float32)
    np.testing.assert_allclose(Gf.numpy(), G.numpy(), rtol=1e-5, atol=1e-3)
    # the engine's reference backend densifies (the oracle)
    Gr, cr = IterationEngine(loss=tprox.make_logistic(), backend="reference",
                             device="cpu").gram(t.D, t.labels)
    np.testing.assert_allclose(Gr.numpy(), G.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(cr.numpy(), c.numpy(), rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------

SOLVERS = {"logistic": (dict(tau=0.1), "make_logistic", ()),
           "svm": (dict(tau=0.5, rho=1.0), "make_hinge", (1.0,)),
           "least_squares": (dict(tau=1.0), "make_least_squares", ())}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("problem", list(SOLVERS))
def test_run_parity_x_and_history(classif, problem):
    """A fixed-iteration run on the BlockCSR: x and history against the
    JAX package's sparse run."""
    t, j = classif
    J = _jax()
    kw, maker, largs = SOLVERS[problem]
    rt = UnwrappedADMM(loss=getattr(tprox, maker)(*largs), device="cpu",
                       **kw).run(t.D, t.labels, iters=40)
    rj = J.ADMM(loss=getattr(J.prox, maker)(*largs), **kw).run(
        j.D, j.labels, iters=40)
    assert _rel(rt.x, rj.x) < 2e-4
    np.testing.assert_allclose(rt.history.objective.numpy(),
                               np.asarray(rj.history.objective), rtol=1e-4)
    np.testing.assert_allclose(rt.history.primal_res.numpy(),
                               np.asarray(rj.history.primal_res), atol=1e-3)
    if problem != "svm":
        # ||D^T grad f||^2 falls to f32 rounding noise near the optimum:
        # held relative to its first value there
        gj = np.asarray(rj.history.grad_sq)
        np.testing.assert_allclose(rt.history.grad_sq.numpy(), gj,
                                   rtol=1e-3, atol=1e-6 * gj[0])
    assert rt.y.shape == (1, t.D.m) and rt.lam.shape == (1, t.D.m)


def test_solve_stop_point_and_warm_start(classif):
    t, j = classif
    J = _jax()
    solver = UnwrappedADMM(loss=tprox.make_logistic(), tau=0.1,
                           device="cpu")
    cold = solver.solve(t.D, t.labels, max_iters=300)
    jcold = J.ADMM(loss=J.prox.make_logistic(), tau=0.1).solve(
        j.D, j.labels, max_iters=300)
    assert cold.iters < 300
    # the same stopping rule; a few iterations of slack (DESIGN.md
    # section 3: the f32 noise floor of the dual residual)
    assert abs(cold.iters - int(jcold.iters)) <= 5
    assert _rel(cold.x, jcold.x) < 1e-4
    assert cold.y.shape == (1, t.D.m)
    # x0 threads through: one warm iteration differs from one cold one,
    # and matches the JAX warm iteration
    w1 = solver.run(t.D, t.labels, iters=1, x0=cold.x, record=False)
    c1 = solver.run(t.D, t.labels, iters=1, record=False)
    assert float(torch.linalg.norm(w1.x - c1.x)) > 1e-3
    jw1 = J.ADMM(loss=J.prox.make_logistic(), tau=0.1).run(
        j.D, j.labels, iters=1, x0=J.jnp.asarray(cold.x.numpy()),
        record=False)
    assert _rel(w1.x, jw1.x) < 2e-4
    warm = solver.solve(t.D, t.labels, max_iters=300, x0=cold.x)
    assert warm.iters <= cold.iters


def test_residency_bf16_values_only(classif):
    t, _ = classif
    eng = IterationEngine(loss=tprox.make_logistic(), tau=0.5,
                          residency="bf16", device="cpu")
    bres = eng.prepare(t.D)
    assert bres.values.dtype == bres.col_values.dtype == torch.bfloat16
    assert bres.indices.dtype == bres.col_indices.dtype == torch.int32
    m, n = t.D.shape
    (ty, tl, tx), _ = _pair(*_state(m, n))
    st = eng.iterate(bres, t.labels, ty, tl, tx)
    assert st.d.dtype == torch.float32 and st.y.dtype == torch.float32
    res = UnwrappedADMM(loss=tprox.make_logistic(), tau=0.1,
                        residency="bf16", device="cpu").solve(
        t.D, t.labels, max_iters=300)
    full = UnwrappedADMM(loss=tprox.make_logistic(), tau=0.1,
                         device="cpu").solve(t.D, t.labels, max_iters=300)
    assert _rel(res.x, full.x) < 5e-3


def test_lasso_through_the_stats_path():
    """The sparse lasso rides (G, c) from ``gram_stats`` and FASTA: the
    JAX package's SufficientStats path, and the densified Gram, give the
    same solution."""
    J = _jax()
    from repro.core.fasta import transpose_reduction_lasso as j_lasso
    from repro.service.stats import SufficientStats
    from repro_torch.core.fasta import transpose_reduction_lasso
    t = tsparse.sparse_lasso_problem(2, 800, 32, 0.1, device="cpu")
    j = J.sparse.sparse_lasso_problem(2, 800, 32, 0.1)
    G, c = gram_stats(t.D, t.b)
    xs = transpose_reduction_lasso(G, c, float(t.mu), iters=800).x
    stats = SufficientStats.from_data(j.D, j.b)
    xj = j_lasso(stats.G, stats.c, float(j.mu), iters=800).x
    np.testing.assert_allclose(xs.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-6)
    Gd, cd = gram_stats(t.D, t.b, backend="reference")      # densified
    xd = transpose_reduction_lasso(Gd, cd, float(t.mu), iters=800).x
    np.testing.assert_allclose(xs.numpy(), xd.numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("problem", ["logistic", "lasso", "svm"])
def test_fit_cli_density(problem, capsys):
    """``--density`` against the JAX CLI on the same seed: x within the
    run / stats tolerances, and the O(nnz) result lines."""
    from repro.launch import fit as j_fit
    argv = ["--density", "0.1", "--problem", problem, "--nodes", "2",
            "--rows-per-node", "400", "--features", "16", "--iters", "60"]
    rt = fit_cli.main(["--device", "cpu"] + argv)
    out = capsys.readouterr().out
    assert "-> blockcsr" in out and "sparse: BlockCSR(" in out
    assert ("KKT violation:" if problem == "lasso" else "objective:") in out
    rj = j_fit.main(argv)
    if problem == "lasso":
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x),
                                   rtol=1e-4, atol=1e-6)
    else:
        assert _rel(rt.x, rj.x) < 2e-4
    # the dense path on the densified matrix gives the same model
    rd = fit_cli.main(["--device", "cpu", "--sparse-format", "dense"]
                      + argv)
    assert "-> dense" in capsys.readouterr().out
    assert _rel(rd.x, rt.x) < (1e-4 if problem == "lasso" else 2e-4)


def test_fit_cli_density_rejects_consensus():
    with pytest.raises(SystemExit, match="transpose only"):
        fit_cli.main(["--device", "cpu", "--density", "0.2", "--method",
                      "consensus", "--nodes", "1", "--rows-per-node", "50",
                      "--features", "4"])


# ---------------------------------------------------------------------------
# K6 on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K6 against its plain version on the card: all five kinds, f32 and
    bf16 values, want_dual on and off, a tail block, zero-nnz rows and an
    all-zero block, duplicate column indices, and block_m small (u in
    shared memory) and large (u outside it); two identical calls bitwise
    equal. Bounds (chip_smoke.py's): y/lam 2e-5 of max(1, max |plain|),
    d/w/v 2e-5 of the sum of |terms|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    dev = torch.device("cuda")
    fn = tops.sparse_admm_iter_full
    rng = np.random.default_rng(0)
    for m, n, block_m, density in ((5000, 64, 1024, 0.05),
                                   (70001, 130, 40000, 0.02),
                                   (3000, 512, None, 0.01)):
        rows, cols = tsparse._random_coo(rng, m, n, density)
        keep = (rows < 1500) | (rows >= 2600)       # an all-zero block
        rows, cols = rows[keep], cols[keep]
        rows = np.concatenate([rows, rows[:50]])    # duplicates
        cols = np.concatenate([cols, cols[:50]])
        vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
        D = BlockCSR.from_coo(rows, cols, vals, m, n, block_m=block_m,
                              device=dev)
        y, lam, x = (torch.from_numpy(v).to(dev) for v in _state(m, n))
        aux = torch.sign(torch.from_numpy(
            rng.standard_normal(m).astype(np.float32))).to(dev)
        absD = _map(D, torch.abs, values_only=True)
        for dt in (torch.float32, torch.bfloat16):
            Dd = D.astype(dt)
            for kind in KINDS:
                a = None if kind == "l1" else aux
                p = 0.3 if kind == "quantile" else 0.0
                for dual in (True, False):
                    kw = dict(kind=kind, delta=2.0, param=p,
                              want_dual=dual)
                    before = fn.launches
                    o1 = fn(Dd, a, y, lam, x, **kw)
                    o2 = fn(Dd, a, y, lam, x, **kw)
                    op = tops.sparse_admm_iter_plain(Dd, a, y, lam, x,
                                                     **kw)
                    torch.cuda.synchronize()
                    assert fn.launches - before == 2
                    assert all(u is v or torch.equal(u, v)
                               for u, v in zip(o1, o2))
                    for u, v in zip(o1[:2], op[:2]):
                        assert float((u - v).abs().max()) <= 2e-5 * max(
                            1.0, float(v.abs().max())), (m, dt, kind)
                    us = [op[0] - op[1]] + ([op[0] - y, op[1]] if dual
                                            else [])
                    for u, v, w in zip(o1[2:], op[2:], us):
                        terms = tops.rmatvec(absD.astype(dt), w.abs())
                        assert bool(((u - v).abs()
                                     <= 2e-5 * terms + 1e-30).all()), \
                            (m, dt, kind, dual)
