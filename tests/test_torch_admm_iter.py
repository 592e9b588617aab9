"""Port parity: the fused iteration body (K3's plain version, returning
y', lam', d, w, v) against the JAX package's ``admm_iter_full`` in
interpret mode, on a subset of ``tests/test_kernels_admm_iter.py`` CASES
(y/lam atol 2e-5) plus the kinds that file leaves out.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.admm_iter import ops as jops
from repro.kernels.admm_iter.ref import admm_iter_ref as j_admm_iter_ref
from repro_torch.kernels.admm_iter import ops as tops
from repro_torch.kernels.admm_iter.ref import admm_iter_ref

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

CASES = [
    (2048, 128, "float32", "logistic", 0.0),
    (3000, 307, "float32", "logistic", 0.0),   # star-cell width, ragged m
    (2048, 256, "bfloat16", "logistic", 0.0),
    (1500, 64, "float32", "hinge", 0.0),
    (777, 33, "float32", "l1", 0.0),
    (1000, 50, "float32", "least_squares", 0.0),
    (1000, 50, "float32", "quantile", 0.3),
]


def _state(m, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n)).astype(np.float32)
    aux = np.sign(rng.standard_normal(m)).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    lam = rng.standard_normal(m).astype(np.float32)
    x = (0.1 * rng.standard_normal(n)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j = (jnp.asarray(D, jd), jnp.asarray(aux), jnp.asarray(y),
         jnp.asarray(lam), jnp.asarray(x))
    t = (torch.from_numpy(D).to(td), torch.from_numpy(aux),
         torch.from_numpy(y), torch.from_numpy(lam), torch.from_numpy(x))
    return j, t


@pytest.mark.parametrize("m,n,dtype,kind,param", CASES)
def test_admm_iter_full_matches_jax(m, n, dtype, kind, param):
    j, t = _state(m, n, dtype)
    out_j = jops.admm_iter_full(*j, kind=kind, delta=2.0, block_m=512,
                                interpret=True, param=param)
    out_t = tops.admm_iter_full(*t, kind=kind, delta=2.0, param=param)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               atol=2e-5)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]),
                               atol=2e-5)
    for got, want in zip(out_t[2:], out_j[2:]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                   atol=2e-3 * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", ["logistic", "hinge"])
def test_admm_iter_three_tuple_and_ref_match_jax_ref(kind):
    j, t = _state(1500, 64, "float32", seed=1)
    yj, lj, dj = j_admm_iter_ref(*j, kind=kind, delta=2.0)
    y3, l3, d3 = tops.admm_iter(*t, kind=kind, delta=2.0)
    yr, lr, dr = admm_iter_ref(*t, kind=kind, delta=2.0)
    for got in ((y3, l3, d3), (yr, lr, dr)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(yj), atol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(lj), atol=2e-5)
        np.testing.assert_allclose(
            got[2].numpy(), np.asarray(dj), rtol=2e-5,
            atol=2e-3 * float(np.abs(np.asarray(dj)).max()))


@pytest.mark.parametrize("block_rows", [1, 100, 777, 5000])
def test_plain_row_blocks_change_nothing(block_rows):
    """The plain version's row blocks are ragged views: any block height
    gives the same result to rounding (the matvec of a block may sum in
    another order)."""
    _, t = _state(777, 33, "float32", seed=2)
    ref = tops.admm_iter_plain(*t, kind="logistic", delta=2.0,
                               block_rows=777)
    got = tops.admm_iter_plain(*t, kind="logistic", delta=2.0,
                               block_rows=block_rows)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6)
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-4)


def test_admm_iter_rejects_unknown_kind():
    _, t = _state(100, 8, "float32")
    with pytest.raises(ValueError, match="huber"):
        tops.admm_iter_full(*t, kind="huber", delta=1.0)
