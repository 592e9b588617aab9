"""Port parity: FASTA on the cached Gram (``core/fasta.py``) and the
lasso generator against the JAX package on the same numpy inputs.

Tolerances are ``tests/test_engine.py:163`` (x rtol 1e-3 / atol 1e-5)
and 1e-5 for the power iteration. The reference stops once an exact f32
fixed point is reached (the residual test ``||dx|| / t / ||g|| < 1e-10``
holds only for dx = 0); the step at which that happens is set by float32
rounding (summation order of G x), so ``iters`` is held equal where both
run to the cap, and elsewhere each stop is checked to be a fixed point.
The objective always keeps the length the caller asked for.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import fasta as tfasta
from repro_torch.core.gram import gram_and_rhs_chunked
from repro_torch.data import synthetic
from repro_torch.service import registry as treg

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax():
    import jax
    import jax.numpy as jnp
    from repro.core import fasta as jfasta
    from repro.core import gram as jgram
    from repro.data.synthetic import lasso_problem
    from repro.service import registry as jreg
    jax.config.update("jax_platform_name", "cpu")
    return SimpleNamespace(jax=jax, jnp=jnp, fasta=jfasta, gram=jgram,
                           lasso_problem=lasso_problem, reg=jreg)


@functools.lru_cache(maxsize=None)
def _stats(key, N, m, n):
    """(G, c, mu) of the JAX lasso generator, as numpy."""
    J = _jax()
    p = J.lasso_problem(J.jax.random.PRNGKey(key), N=N, m_per_node=m, n=n)
    G, c = J.gram.gram_and_rhs_chunked(p.D.reshape(-1, n), p.b.reshape(-1))
    return (np.array(G), np.array(c), float(p.mu),
            np.array(p.D).reshape(-1, n), np.array(p.b).reshape(-1))


def _check_run(rj, rt, iters, cap_equal):
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-3,
                               atol=1e-5)
    assert rt.objective.shape == np.asarray(rj.objective).shape == (iters,)
    assert rt.residual.shape == (iters,)
    # g(x) = x'Gx/2 - c'x (+ J) drops ||b||^2/2 and passes through 0:
    # the absolute tolerance is scaled by the history's largest value
    oj = np.asarray(rj.objective)
    np.testing.assert_allclose(rt.objective.numpy(), oj, rtol=1e-5,
                               atol=1e-5 * np.abs(oj).max())
    if cap_equal:
        assert rt.iters == int(rj.iters) == iters
    elif rt.iters < iters:
        # stopped at an exact fixed point: no move, the rest repeats it
        assert float(rt.residual[rt.iters - 1]) == 0.0
        assert bool((rt.objective[rt.iters - 1:]
                     == rt.objective[rt.iters - 1]).all())


# (key, N, m_i, n) — the first is tests/test_engine.py's lasso problem,
# where neither side reaches an exact fixed point in 1500 steps
@pytest.mark.parametrize("case,l2f,iters,cap_equal", [
    ((1, 2, 400, 48), 0.0, 1500, True),
    ((1, 2, 400, 48), 0.5, 200, False),
    ((0, 4, 250, 20), 0.0, 100, False),
    ((2, 4, 300, 40), 0.05, 300, False),
])
def test_transpose_reduction_lasso_matches_jax(case, l2f, iters, cap_equal):
    J = _jax()
    G, c, mu, _, _ = _stats(*case)
    l2 = l2f * mu
    rj = J.fasta.transpose_reduction_lasso(J.jnp.asarray(G),
                                           J.jnp.asarray(c), mu,
                                           iters=iters, l2=l2)
    rt = tfasta.transpose_reduction_lasso(torch.from_numpy(G),
                                          torch.from_numpy(c), mu,
                                          iters=iters, l2=l2)
    _check_run(rj, rt, iters, cap_equal)


def test_short_run_pads_nothing_and_warm_start_matches():
    J = _jax()
    G, c, mu, _, _ = _stats(1, 2, 400, 48)
    x0 = np.linspace(-1, 1, 48).astype(np.float32)
    rj = J.fasta.transpose_reduction_lasso(J.jnp.asarray(G),
                                           J.jnp.asarray(c), mu, iters=7,
                                           x0=J.jnp.asarray(x0))
    rt = tfasta.transpose_reduction_lasso(torch.from_numpy(G),
                                          torch.from_numpy(c), mu, iters=7,
                                          x0=torch.from_numpy(x0))
    _check_run(rj, rt, 7, True)
    # ||dx|| / t is a difference of iterates: scaled like the objective
    rj_res = np.asarray(rj.residual)
    np.testing.assert_allclose(rt.residual.numpy(), rj_res, rtol=1e-4,
                               atol=1e-5 * np.abs(rj_res).max())


@pytest.mark.parametrize("case", [(1, 2, 400, 48), (0, 4, 250, 20)])
def test_nnls_through_fasta_matches_jax(case):
    J = _jax()
    G, c, _, _, _ = _stats(*case)
    xj, itj, hj = J.reg.nnls_from_stats(J.jnp.asarray(G), J.jnp.asarray(c),
                                        iters=400)
    xt, itt, ht = treg.nnls_from_stats(torch.from_numpy(G),
                                       torch.from_numpy(c), iters=400)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3,
                               atol=1e-5)
    assert bool((xt >= 0).all()) and ht.shape == (400,)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(hj)).max())
    # projected-gradient optimality of the port's x
    g = torch.from_numpy(G).double() @ xt.double() - torch.from_numpy(c)
    pg = torch.where(xt > 0, g, torch.clamp(g, max=0.0))
    assert float(pg.abs().max()) <= 1e-3 * float(np.abs(c).max())


@pytest.mark.parametrize("case", [(1, 2, 400, 48), (0, 4, 250, 20)])
def test_power_lmax_and_mu_max_match_jax(case):
    J = _jax()
    G, c, mu, D2, b = _stats(*case)
    lj = float(J.fasta.power_lmax(J.jnp.asarray(G)))
    lt = float(tfasta.power_lmax(torch.from_numpy(G)))
    assert abs(lt - lj) <= 1e-5 * lj
    mj = float(J.fasta.lasso_mu_max(J.jnp.asarray(D2), J.jnp.asarray(b)))
    mt = float(tfasta.lasso_mu_max(torch.from_numpy(D2),
                                   torch.from_numpy(b)))
    assert abs(mt - mj) <= 1e-5 * mj
    # the generator's 10% rule
    assert abs(mu - 0.1 * mj) <= 1e-5 * mu


def test_lasso_problem_properties():
    p = synthetic.lasso_problem(3, 4, 300, 40, heterogeneity=1.0,
                                device="cpu")
    assert tuple(p.D.shape) == (4, 300, 40) and tuple(p.b.shape) == (4, 300)
    # 10 active entries, each +-1
    nz = p.x_true[p.x_true != 0]
    assert nz.numel() == 10 and bool((nz.abs() == 1).all())
    # mu = 0.1 ||D^T b||_inf, accumulated in f32
    D2, b2 = p.D.reshape(-1, 40), p.b.reshape(-1)
    want = 0.1 * float((D2.double().T @ b2.double()).abs().max())
    assert abs(float(p.mu) - want) <= 1e-5 * want
    # one shift per node: each node's mean moves, within a node it is flat
    means = p.D.mean(dim=(1, 2))
    assert float(means.std()) > 0.2
    # b = D x_true + unit noise
    r = b2 - D2 @ p.x_true
    assert 0.8 < float(r.std()) < 1.2
    again = synthetic.lasso_problem(3, 4, 300, 40, heterogeneity=1.0,
                                    device="cpu")
    assert torch.equal(p.D, again.D) and torch.equal(p.b, again.b)
    flat = synthetic.lasso_problem(3, 4, 300, 40, device="cpu")
    assert float(flat.D.mean(dim=(1, 2)).std()) < 0.05


def test_port_lasso_solves_its_own_problem():
    """The port end to end on its own data: x has the KKT certificate of
    the reference's oracle."""
    from repro_torch.core.oracles import lasso_kkt_gap
    p = synthetic.lasso_problem(0, 2, 500, 30, device="cpu")
    D2, b2 = p.D.reshape(-1, 30), p.b.reshape(-1)
    G, c = gram_and_rhs_chunked(D2, b2)
    r = tfasta.transpose_reduction_lasso(G, c, float(p.mu), iters=2000)
    viol, sup = lasso_kkt_gap(D2.numpy(), b2.numpy(), r.x.numpy(),
                              float(p.mu))
    assert viol <= 1e-3 * float(p.mu) and sup <= 1e-2 * float(p.mu)
