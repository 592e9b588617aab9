"""Port parity: Gram setup (K2's plain versions, ``core.gram`` and the
Cholesky solve) against the JAX package on the same numpy inputs.

The JAX side runs the Pallas Gram kernels in interpret mode; tolerances
are ``tests/test_kernels.py:24`` (gram), ``:50`` (gram + rhs) and
``tests/test_engine.py:167`` (multi-RHS).
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import gram as tgram
from repro_torch.engine import gram_stats as t_gram_stats
from repro_torch.kernels.gram import ops as tops

torch.set_num_threads(1)

TDTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX side, imported by the parity tests only: the card's machine,
    which runs the ``cuda``-marked test, has no JAX."""
    import jax
    import jax.numpy as jnp
    from repro.core import gram as jgram
    from repro.engine import gram_stats
    from repro.kernels.gram import ops
    jax.config.update("jax_platform_name", "cpu")
    return SimpleNamespace(jnp=jnp, jgram=jgram, gram_stats=gram_stats,
                           ops=ops, dtypes={"float32": jnp.float32,
                                            "bfloat16": jnp.bfloat16})


def _pair(a, dtype="float32"):
    """The same values in both packages (bf16 rounds identically)."""
    jx = _jax()
    return jx.jnp.asarray(a, jx.dtypes[dtype]), \
        torch.from_numpy(a).to(TDTYPES[dtype])


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("m,n", [(256, 128), (1000, 130), (77, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_matches_jax_kernel(m, n, dtype):
    Dj, Dt = _pair(_randn((m, n), 0), dtype)
    Gj = np.asarray(_jax().ops.gram(Dj, block_m=256, block_n=128, interpret=True))
    Gt = tops.gram(Dt).numpy()
    tol = 5e-6 * m if dtype == "bfloat16" else 2e-6 * m
    np.testing.assert_allclose(Gt, Gj, atol=tol * np.abs(Gj).max() / m,
                               rtol=2e-2 if dtype == "bfloat16" else 1e-5)
    np.testing.assert_array_equal(Gt, Gt.T)


@pytest.mark.parametrize("m,n,r,dtype", [(700, 96, 0, "float32"),
                                         (513, 33, 5, "float32"),
                                         (256, 140, 2, "bfloat16"),
                                         (999, 65, 70, "float32")])
def test_gram_and_rhs_matches_jax_kernel(m, n, r, dtype):
    Dj, Dt = _pair(_randn((m, n), 2), dtype)
    b = _randn((m, r) if r else (m,), 3)
    Gj, cj = _jax().ops.gram_and_rhs(Dj, _jax().jnp.asarray(b),
                                     interpret=True)
    Gt, ct = tops.gram_and_rhs(Dt, torch.from_numpy(b))
    tol = dict(rtol=2e-2, atol=1e-2) if dtype == "bfloat16" else dict(
        rtol=3e-5, atol=1e-3)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), **tol)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **tol)
    assert tuple(ct.shape) == ((n, r) if r else (n,))


@pytest.mark.parametrize("m,n,r,dtype", [(700, 96, 0, "float32"),
                                         (513, 33, 5, "float32"),
                                         (256, 140, 2, "bfloat16")])
def test_gram_stats_multi_rhs_matches_jax(m, n, r, dtype):
    """tests/test_engine.py:167 — the fused Gram + RHS path through the
    engine's entry point, the port's cuda backend on a CPU tensor (its
    wrapper runs the plain version) against the JAX interpret kernel."""
    Dj, Dt = _pair(_randn((m, n), 4), dtype)
    b = _randn((m, r) if r else (m,), 5)
    Gj, cj = _jax().gram_stats(Dj, _jax().jnp.asarray(b),
                               backend="pallas_interpret")
    for backend in ("cuda", "chunked", "reference"):
        Gt, ct = t_gram_stats(Dt, torch.from_numpy(b), backend=backend)
        tol = dict(rtol=2e-2, atol=1e-2) if dtype == "bfloat16" else dict(
            rtol=3e-5, atol=1e-3)
        np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), **tol)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **tol)
    G0, c0 = t_gram_stats(Dt, None, backend="cuda")
    assert c0 is None and G0.shape == (n, n)


@pytest.mark.parametrize("block_rows", [64, 1000, 4096])
def test_core_chunked_grams_match_jax(block_rows):
    m, n = 1000, 40
    D = _randn((m, n), 6)
    b = _randn((m, 3), 7)
    jnp, jgram = _jax().jnp, _jax().jgram
    Dj, Dt = jnp.asarray(D), torch.from_numpy(D)
    bj, bt = jnp.asarray(b), torch.from_numpy(b)
    kw = dict(rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tgram.gram_chunked(Dt, block_rows).numpy(),
                               np.asarray(jgram.gram_chunked(Dj, block_rows)),
                               **kw)
    Gt, ct = tgram.gram_and_rhs_chunked(Dt, bt, block_rows)
    Gj, cj = jgram.gram_and_rhs_chunked(Dj, bj, block_rows)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), **kw)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **kw)
    np.testing.assert_allclose(
        tgram.gram_rhs_chunked(Dt, bt[:, 0], block_rows).numpy(),
        np.asarray(jgram.gram_rhs_chunked(Dj, bj[:, 0], block_rows)), **kw)
    np.testing.assert_allclose(tgram.gram(Dt).numpy(),
                               np.asarray(jgram.gram(Dj)), **kw)
    np.testing.assert_allclose(tgram.gram_rhs(Dt, bt).numpy(),
                               np.asarray(jgram.gram_rhs(Dj, bj)), **kw)


@pytest.mark.parametrize("ridge", [0.0, 2.5])
@pytest.mark.parametrize("rhs_cols", [0, 4])
def test_gram_factor_and_solve_match_jax(ridge, rhs_cols):
    m, n = 600, 30
    D = _randn((m, n), 8)
    rhs = _randn((n, rhs_cols) if rhs_cols else (n,), 9)
    G = D.T.astype(np.float64) @ D
    G = G.astype(np.float32)
    jnp, jgram = _jax().jnp, _jax().jgram
    Lj = jgram.gram_factor(jnp.asarray(G), ridge=ridge)
    Lt = tgram.gram_factor(torch.from_numpy(G), ridge=ridge)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=1e-5,
                               atol=1e-4)
    xj = np.asarray(jgram.gram_solve(Lj, jnp.asarray(rhs)))
    xt = tgram.gram_solve(Lt, torch.from_numpy(rhs)).numpy()
    assert xt.shape == rhs.shape
    np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-7)
    # and it solves the (ridged) system
    A = G.astype(np.float64) + ridge * np.eye(n)
    np.testing.assert_allclose(A @ xt, rhs, rtol=1e-3, atol=1e-4)


def test_gram_factor_raises_on_singular():
    """The reference's jnp Cholesky returns NaN for a singular Gram; the
    port raises instead of carrying NaN into the solve."""
    D = _randn((50, 4), 10)
    D = np.concatenate([D, D[:, :1]], axis=1)      # duplicate column
    G = torch.from_numpy(D.T @ D)
    G[4, 4] -= 1e-3                                # push it indefinite
    with pytest.raises(torch.linalg.LinAlgError):
        tgram.gram_factor(G)


def _gram_err(got, want):
    """max |dG_ab| / sqrt(G_aa G_bb): Cauchy-Schwarz scale, as
    chip_smoke.py holds K2 (a column of large entries cannot hide the error
    of a small one)."""
    got, want = got.double(), want.double()
    dg = torch.sqrt(torch.clamp(torch.diagonal(want), min=1e-30))
    return float(((got - want).abs() / (dg[:, None] * dg[None, :])).max())


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K2a (Gram alone) and K2b (Gram + RHS, the same tile kernel with B as
    a second source) against their plain versions on the card: ragged n, m
    not a multiple of the 64-row panel, D aligned and as a row-offset view
    (its base off 16-byte alignment), f32 and bf16, RHS widths 1 and 5
    (riding the diagonal tiles), 64 (RHS tiles of their own) and 70 (two
    groups, the second re-reading D for C alone); two identical calls
    bitwise equal, G exactly symmetric. Bound: chip_smoke.py's 1e-5 on the
    Cauchy-Schwarz scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for m, n in ((1000, 33), (4099, 307), (777, 130), (70001, 307)):
        for dt in (torch.float32, torch.bfloat16):
            base = torch.randn((m + 3, n), generator=g, device=dev).to(dt)
            for D in (base[:m], base[3:]):
                assert D.is_contiguous()
                launched = tops.gram.launches
                G1, G2, Gp = tops.gram(D), tops.gram(D), tops.gram_plain(D)
                torch.cuda.synchronize()
                assert tops.gram.launches == launched + 2
                assert torch.equal(G1, G2) and torch.equal(G1, G1.T)
                assert _gram_err(G1, Gp) <= 1e-5
                for r in (1, 5, 64, 70):
                    b = torch.randn((m, r), generator=g, device=dev)
                    launched = tops.gram_and_rhs.launches
                    (H1, C1), (H2, C2) = tops.gram_and_rhs(D, b), \
                        tops.gram_and_rhs(D, b)
                    Hp, Cp = tops.gram_and_rhs_plain(D, b)
                    torch.cuda.synchronize()
                    assert tops.gram_and_rhs.launches == launched + 2
                    assert torch.equal(H1, H2) and torch.equal(C1, C2)
                    assert torch.equal(H1, G1)
                    assert _gram_err(H1, Hp) <= 1e-5
                    assert C1.shape == Cp.shape == (n, r)
                    assert float((C1 - Cp).abs().max()) \
                        <= 1e-5 * max(1.0, float(Cp.abs().max()))
            # the bits depend on the values and shapes, not on where D
            # starts
            assert torch.equal(tops.gram(base[3:]),
                               tops.gram(base[3:].clone()))
