"""Port parity for paper section 7.1: ``repro_torch.core.column_split``
(the column-split dual lasso) against the JAX package's
``lasso_column_split`` on ``tests/test_column_split.py``'s wide problems,
the same numpy inputs to both: x and alpha within rel 1e-4 (the two sum in
other orders; measured ~1e-6), the iteration where Boyd's rule first holds
within 2, plus that file's certificates (dual feasibility, the row-split
solution, the KKT certificate)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.column_split import lasso_column_split as j_column_split
from repro_torch.core import gram as gram_lib
from repro_torch.core.column_split import lasso_column_split
from repro_torch.core.fasta import transpose_reduction_lasso
from repro_torch.core.oracles import lasso_kkt_gap, lasso_objective

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)


def _wide_problem(key, m=60, n=160, active=8):
    """``tests/test_column_split.py::_wide_problem``, as numpy arrays."""
    kD, kx, ke = jax.random.split(key, 3)
    D = jax.random.normal(kD, (m, n)) / jnp.sqrt(m * 1.0)
    x_true = jnp.zeros((n,)).at[
        jax.random.permutation(kx, n)[:active]].set(1.0)
    b = D @ x_true + 0.05 * jax.random.normal(ke, (m,))
    mu = 0.1 * float(jnp.max(jnp.abs(D.T @ b)))
    return np.array(D), np.array(b), mu


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("seed,m,n,iters", [(0, 60, 160, 2000),
                                            (1, 40, 100, 3000)])
def test_column_split_matches_reference(seed, m, n, iters):
    D, b, mu = _wide_problem(jax.random.PRNGKey(seed), m=m, n=n)
    D_cols = np.stack(np.split(D, 4, axis=1))
    rt = lasso_column_split(D_cols, b, mu, tau=1.0, iters=iters,
                            device="cpu")
    rj = j_column_split(jnp.asarray(D_cols), jnp.asarray(b), mu, tau=1.0,
                        iters=iters)
    assert rt.x.shape == (n,) and rt.alpha.shape == (m,)
    assert _rel(rt.x, rj.x) < 1e-4
    assert _rel(rt.alpha, rj.alpha) < 1e-4
    assert abs(rt.iters - int(rj.iters)) <= 2


def test_dual_column_split_matches_primal():
    """``test_column_split.py::test_dual_column_split_matches_primal`` on
    the port: the row-split (section 4) FASTA solution's objective, dual
    feasibility and alpha* = D x* - b."""
    D, b, mu = _wide_problem(jax.random.PRNGKey(0))
    Dt, bt = torch.from_numpy(D), torch.from_numpy(b)
    G, c = gram_lib.gram_and_rhs_chunked(Dt, bt, block_rows=32)
    x_ref = transpose_reduction_lasso(G, c, mu, iters=5000).x.numpy()
    obj_ref = lasso_objective(D, b, x_ref, mu)
    res = lasso_column_split(np.stack(np.split(D, 4, axis=1)), b, mu,
                             tau=1.0, iters=2000, device="cpu")
    x = res.x.numpy()
    assert lasso_objective(D, b, x, mu) - obj_ref < 5e-3 * abs(obj_ref) \
        + 1e-6
    assert np.max(np.abs(D.T @ res.alpha.numpy())) <= mu * 1.01
    np.testing.assert_allclose(res.alpha.numpy(), D @ x - b, atol=5e-2)


def test_dual_kkt_certificate():
    D, b, mu = _wide_problem(jax.random.PRNGKey(1), m=40, n=100)
    res = lasso_column_split(torch.from_numpy(np.stack(np.split(D, 4,
                                                                axis=1))),
                             torch.from_numpy(b), mu, tau=1.0, iters=3000,
                             device="cpu")
    viol, sup_err = lasso_kkt_gap(D, b, res.x.numpy(), mu)
    assert viol < 0.02 * mu
    assert sup_err < 0.05 * mu
