"""Port parity: the consensus ADMM baseline (``core/consensus.py``) against
the JAX package on the same numpy inputs: z, the history and ``iters``.

Lasso and logistic are held at 1e-5. The SVM's inner solver orders each
CD pass by decreasing |projected gradient| (a stable sort). Coordinates
at a bound tie at exactly 0 and are taken in index order: the first pass
from alpha = 0 is such a case, and the port matches the reference there
at 1e-5. Coordinates the last pass left optimal have |pg| at the rounding
level, so from the second pass on their place in the order, and with it
the trajectory, follows the rounding of D_i (w + tau v): the reference
itself moves by percents under a change of summation order (ROADMAP
section 3). With the default 4 passes the port is therefore held to that
spread, measured in the test against the same solve in float64.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import consensus as tcons

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax():
    import jax
    import jax.numpy as jnp
    from repro.core import consensus as jcons
    from repro.data.synthetic import classification_problem, lasso_problem
    jax.config.update("jax_platform_name", "cpu")
    return SimpleNamespace(jax=jax, jnp=jnp, cons=jcons,
                           classif=classification_problem,
                           lasso=lasso_problem)


@functools.lru_cache(maxsize=None)
def _data(kind, key, N, m, n):
    J = _jax()
    gen = J.lasso if kind == "lasso" else J.classif
    p = gen(J.jax.random.PRNGKey(key), N=N, m_per_node=m, n=n)
    aux = p.b if kind == "lasso" else p.labels
    mu = float(p.mu) if kind == "lasso" else None
    return np.array(p.D), np.array(aux), mu


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _run_both(jsolver, tsolver, D, aux, iters):
    J = _jax()
    rj = jsolver.run(J.jnp.asarray(D), J.jnp.asarray(aux), iters)
    rt = tsolver.run(torch.from_numpy(D), torch.from_numpy(aux), iters)
    return rj, rt


def _check_close(rj, rt, iters, tol=1e-5):
    assert _rel(rt.z, rj.z) <= tol
    h = rt.history
    assert h.objective.shape == h.primal_res.shape == (iters,)
    np.testing.assert_allclose(h.objective.numpy(),
                               np.asarray(rj.history.objective), rtol=tol)
    for f in ("primal_res", "dual_res"):
        want = np.asarray(getattr(rj.history, f))
        np.testing.assert_allclose(getattr(h, f).numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(h.inner_iters.numpy(),
                                  np.asarray(rj.history.inner_iters))
    assert rt.iters == int(rj.iters)
    assert h.converged_at == int(rj.history.converged_at)


@pytest.mark.parametrize("tau,iters", [(1.0, 200), (4.0, 200)])
def test_consensus_lasso_matches_jax(tau, iters):
    """tau = 4 is the registry's default 1e-2 m at m = 400; it converges
    inside the run, so ``iters`` is the stop point there."""
    D, b, mu = _data("lasso", 0, 4, 100, 12)
    rj, rt = _run_both(_jax().cons.ConsensusLasso(mu=mu, tau=tau),
                       tcons.ConsensusLasso(mu=mu, tau=tau), D, b, iters)
    _check_close(rj, rt, iters)


@pytest.mark.parametrize("mu", [0.0, 2.0])
def test_consensus_logistic_matches_jax(mu):
    D, lab, _ = _data("classif", 1, 4, 100, 12)
    rj, rt = _run_both(_jax().cons.ConsensusLogistic(mu=mu, tau=0.5),
                       tcons.ConsensusLogistic(mu=mu, tau=0.5), D, lab, 60)
    _check_close(rj, rt, 60)


def test_greedy_order_ties_match_jax():
    """Exact zeros (both signs), equal magnitudes of both signs and a
    row of ties only: index order among ties, as the reference's stable
    argsort."""
    jnp = _jax().jnp
    rng = np.random.default_rng(0)
    pg = rng.standard_normal((3, 64)).astype(np.float32)
    pg[0, ::3] = 0.0
    pg[0, 1::7] = -0.0
    pg[1, :32] = 0.5
    pg[1, 32:] = -0.5
    pg[2] = 0.0
    want = np.asarray(jnp.argsort(-jnp.abs(jnp.asarray(pg)), axis=-1))
    got = tcons.greedy_order(torch.from_numpy(pg)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key,iters", [(1, 1), (1, 40), (2, 40)])
def test_consensus_svm_one_pass_matches_jax(key, iters):
    """One CD pass per outer iteration: the first starts at alpha = 0,
    where every key ties; later ones tie at pg = 0 for every coordinate at
    a bound."""
    D, lab, _ = _data("classif", key, 4, 100, 12)
    J = _jax()
    # the ties are there: at alpha = 0, w = 0 and v = 0 every g is -1, so
    # the first pass's keys all tie and it runs in index order
    pg0 = torch.full((4, 100), -1.0)
    assert torch.equal(tcons.greedy_order(pg0),
                       torch.arange(100).expand(4, 100))
    rj, rt = _run_both(J.cons.ConsensusSVM(C=1.0, tau=1.0, cd_passes=1),
                       tcons.ConsensusSVM(C=1.0, tau=1.0, cd_passes=1),
                       D, lab, iters)
    _check_close(rj, rt, iters)


@pytest.mark.parametrize("key", [1, 3])
def test_consensus_svm_within_reference_rounding_spread(key):
    """Default 4 passes: the port's f32 z within 3x the distance between
    the reference's f32 z and the same solve in float64, and the
    objectives within 1e-2; the iteration counts equal."""
    D, lab, _ = _data("classif", key, 4, 100, 12)
    J = _jax()
    iters = 40
    rj, rt = _run_both(J.cons.ConsensusSVM(C=1.0, tau=1.0),
                       tcons.ConsensusSVM(C=1.0, tau=1.0), D, lab, iters)
    r64 = tcons.ConsensusSVM(C=1.0, tau=1.0).run(
        torch.from_numpy(D).double(), torch.from_numpy(lab).double(), iters)
    spread = _rel(rj.z, r64.z)
    assert _rel(rt.z, rj.z) <= 3 * spread + 1e-5, (_rel(rt.z, rj.z), spread)
    oj = np.asarray(rj.history.objective)
    np.testing.assert_allclose(rt.history.objective.numpy(), oj, rtol=1e-2)
    assert rt.iters == int(rj.iters)
    np.testing.assert_array_equal(rt.history.inner_iters.numpy(),
                                  np.asarray(rj.history.inner_iters))


def test_consensus_on_cpu_keeps_dtype_and_shapes():
    D, b, mu = _data("lasso", 0, 4, 100, 12)
    r = tcons.ConsensusLasso(mu=mu).run(torch.from_numpy(D).double(),
                                        torch.from_numpy(b).double(), 5)
    assert r.z.dtype == torch.float64 and r.z.shape == (12,)
    assert r.history.objective.shape == (5,)
    assert r.iters == 5 and r.history.converged_at == -1
