"""Port parity: ``repro_torch.engine`` against ``repro.engine``, mirroring
``tests/test_engine.py`` — iterate parity (:56, atol 3e-5), bf16 residency
(:75), the resolution rules with ``cuda`` in place of ``pallas`` (:94), pad
rows leak nothing (:196) and ``transpose_d`` makes no dense copy (:217).
The port's ``cuda`` backend on a CPU tensor runs each kernel's plain
version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prox as jprox
from repro.engine import IterationEngine as JEngine
from repro_torch.core import prox as tprox
from repro_torch.engine import IterationEngine, autotune
from repro_torch.engine import engine as engine_mod

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

LOSSES = [("logistic", 0.5), ("hinge", 1.0), ("l1", 1.0),
          ("least_squares", 2.0), ("quantile", 1.0)]


def _losses(name):
    if name == "logistic":
        return jprox.make_logistic(), tprox.make_logistic()
    if name == "hinge":
        return jprox.make_hinge(0.7), tprox.make_hinge(0.7)
    if name == "l1":
        return jprox.make_l1(0.3), tprox.make_l1(0.3)
    if name == "least_squares":
        return jprox.make_least_squares(), tprox.make_least_squares()
    return jprox.make_quantile(0.3), tprox.make_quantile(0.3)


def _state(m, n, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n)).astype(np.float32)
    aux = np.sign(rng.standard_normal(m)).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    lam = rng.standard_normal(m).astype(np.float32)
    x = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return D, aux, y, lam, x


def _j(*arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _engine(loss, tau, **kw):
    return IterationEngine(loss=loss, tau=tau, device="cpu", **kw)


def _assert_step(st, ref, scale):
    np.testing.assert_allclose(st.y.numpy(), np.asarray(ref.y), atol=3e-5)
    np.testing.assert_allclose(st.lam.numpy(), np.asarray(ref.lam),
                               atol=3e-5)
    for got, want in [(st.d, ref.d), (st.w, ref.w), (st.v, ref.v)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-3 * max(scale, 1.0))


@pytest.mark.parametrize("backend", ["reference", "chunked", "cuda"])
@pytest.mark.parametrize("name,tau", LOSSES)
def test_iterate_backend_parity(backend, name, tau):
    m, n = 1234, 40
    D, aux, y, lam, x = _state(m, n)
    a = None if name == "l1" else aux
    jl, tl = _losses(name)
    ref = JEngine(loss=jl, tau=tau, backend="reference").iterate(
        *_j(D, a, y, lam, x))
    st = _engine(tl, tau, backend=backend).iterate(*_t(D, a, y, lam, x))
    _assert_step(st, ref, float(jnp.max(jnp.abs(ref.d))))


@pytest.mark.parametrize("backend", ["chunked", "cuda"])
def test_iterate_bf16_residency_parity(backend):
    m, n = 2048, 64
    D, aux, y, lam, x = _state(m, n, seed=1)
    jl, tl = _losses("logistic")
    ref = JEngine(loss=jl, tau=0.5, backend="reference").iterate(
        *_j(D, aux, y, lam, x))
    eng = _engine(tl, 0.5, backend=backend, residency="bf16")
    Dres = eng.prepare(torch.from_numpy(D))
    assert Dres.dtype == torch.bfloat16
    st = eng.iterate(Dres, *_t(aux, y, lam, x))
    assert st.d.dtype == torch.float32          # f32 accumulation
    np.testing.assert_allclose(st.y.numpy(), np.asarray(ref.y), atol=5e-2)
    np.testing.assert_allclose(
        st.d.numpy(), np.asarray(ref.d),
        atol=2e-2 * float(jnp.max(jnp.abs(ref.d))))


def test_backend_resolution_rules():
    logistic = tprox.make_logistic()
    # a loss with no kernel kind: cuda -> chunked
    huber_like = dataclasses.replace(tprox.make_least_squares(), name="huber")
    assert _engine(huber_like, 1.0, backend="cuda").resolve() == "chunked"
    # not coordinatewise: chunked -> reference (and cuda -> ... -> reference)
    stacked = dataclasses.replace(logistic, name="stacked",
                                  coordinatewise=False)
    assert _engine(stacked, 1.0, backend="chunked").resolve() == "reference"
    assert _engine(stacked, 1.0, backend="cuda").resolve() == "reference"
    # the kernels take f32 and bf16 rows only
    eng = _engine(logistic, 1.0, backend="cuda")
    assert eng.resolve(torch.float32) == "cuda"
    assert eng.resolve(torch.bfloat16) == "cuda"
    assert eng.resolve(torch.float64) == "chunked"
    # auto resolves by the device: a CPU engine streams with chunked
    assert _engine(logistic, 1.0).resolve() == "chunked"
    # residency="auto": bf16 only where the backend is cuda
    assert _engine(logistic, 1.0, residency="auto").resolve_residency() \
        is None
    assert _engine(logistic, 1.0, backend="cuda",
                   residency="auto").resolve_residency() == "bf16"
    assert _engine(huber_like, 1.0, backend="cuda",
                   residency="auto").resolve_residency() is None
    for bad in ("pallas", "pallas_interpret"):
        with pytest.raises(ValueError):
            _engine(logistic, 1.0, backend=bad)
    # "sparse" is a data-format backend: dense data resolve to the default
    assert _engine(logistic, 1.0, backend="sparse").resolve() == "chunked"
    with pytest.raises(ValueError):
        _engine(logistic, 1.0, residency="fp8")


def test_sparse_data_names_roadmap_item():
    """Sparse data (ROADMAP item 6, now ported) go in as a BlockCSR: its
    Gram and one iteration equal the dense engine's on the densified
    matrix; torch's own sparse layouts and other objects raise."""
    from repro_torch.data.sparse import BlockCSR
    eng = _engine(tprox.make_logistic(), 1.0)
    rng = np.random.default_rng(0)
    D = rng.standard_normal((300, 12)).astype(np.float32)
    D[rng.random(D.shape) < 0.7] = 0
    B = BlockCSR.from_dense(D, block_m=64, device="cpu")
    Dt = torch.from_numpy(D)
    np.testing.assert_allclose(eng.gram(B)[0].numpy(),
                               eng.gram(Dt)[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    y, lam, x = (torch.from_numpy(rng.standard_normal(k).astype(np.float32))
                 for k in (300, 300, 12))
    lab = torch.sign(y)
    sb, sd = eng.iterate(B, lab, y, lam, x), eng.iterate(Dt, lab, y, lam, x)
    assert sb.stats is None and sd.stats is None     # torch bodies on the CPU
    for got, want in zip(sb[:5], sd[:5]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)
    with pytest.raises(TypeError, match="BlockCSR"):
        eng.gram(torch.eye(4).to_sparse())
    with pytest.raises(TypeError, match="BlockCSR"):
        eng.iterate(type("BlockCSR", (), {})(), None, torch.zeros(4),
                    torch.zeros(4), torch.zeros(4))


@pytest.mark.parametrize("backend", ["chunked", "cuda"])
@pytest.mark.parametrize("name,tau", [("logistic", 0.5), ("hinge", 1.0)])
@pytest.mark.parametrize("m", [1000, 1023, 1025])
def test_padding_edges_no_leak(backend, name, tau, m):
    n, block = 32, 256                  # never divides any of the m values
    assert m % block != 0
    D, aux, y, lam, x = _state(m, n, seed=m)
    jl, tl = _losses(name)
    ref = JEngine(loss=jl, tau=tau, backend="reference").iterate(
        *_j(D, aux, y, lam, x))
    st = _engine(tl, tau, backend=backend, block_m=block).iterate(
        *_t(D, aux, y, lam, x))
    _assert_step(st, ref, float(jnp.max(jnp.abs(ref.d))))
    assert st.y.shape == (m,) and st.lam.shape == (m,)


def test_transpose_d_streams_without_dense_copy(monkeypatch):
    m, n = 700, 24
    D, _, y, lam, _ = _state(m, n, seed=7)
    want = np.asarray(JEngine(loss=jprox.make_logistic(), tau=1.0,
                              backend="reference").transpose_d(
        *_j(D, y, lam)))
    for backend in ("chunked", "cuda"):
        eng = _engine(tprox.make_logistic(), 1.0, backend=backend)
        np.testing.assert_allclose(eng.transpose_d(*_t(D, y, lam)).numpy(),
                                   want, rtol=1e-5, atol=1e-4)

    def boom(*a, **k):
        raise AssertionError("dense gram_rhs called from a streaming "
                             "backend")

    monkeypatch.setattr(engine_mod.gram_lib, "gram_rhs", boom)
    for backend in ("chunked", "cuda"):
        _engine(tprox.make_logistic(), 1.0, backend=backend).transpose_d(
            *_t(D, y, lam))
    with pytest.raises(AssertionError, match="dense gram_rhs"):
        _engine(tprox.make_logistic(), 1.0,
                backend="reference").transpose_d(*_t(D, y, lam))


def test_make_step_matches_iterate():
    m, n = 600, 16
    D, aux, y, lam, _ = _state(m, n, seed=3)
    Dt, at, yt, lt = _t(D, aux, y, lam)
    eng = _engine(tprox.make_logistic(), 0.5, backend="cuda")
    G, _ = eng.gram(Dt)
    L = torch.linalg.cholesky(G)
    d = eng.transpose_d(Dt, yt, lt)
    y1, l1, d1, x1 = eng.make_step(Dt, at, L)(yt, lt, d)
    st = eng.iterate(Dt, at, yt, lt, x1, want_dual=False)
    assert st.w is None and st.v is None
    assert torch.equal(y1, st.y) and torch.equal(d1, st.d)


def test_autotune_blocks_are_sane():
    # K3, ring route at the main path's shape: one CTA per SM; W warps
    # holding a stage each balanced against the S - W stages in flight
    # (R min(c W, S - W) rows per copy), as many stages as fit
    f32 = autotune.iter_grid(1 << 24, 307, torch.float32)
    assert f32 == ("ring", 20, autotune.SM_COUNT, 9, 5)
    bf16 = autotune.iter_grid(1 << 24, 307, torch.bfloat16)
    assert bf16 == ("ring", 32, autotune.SM_COUNT, 11, 7)
    for grid, dsize in ((f32, 4), (bf16, 2)):
        assert 1 <= grid.warps <= 8 and grid.warps < grid.stages <= 16
        assert grid.rows <= 32 and (grid.rows * 307 * dsize) % 16 == 0
        smem = autotune.ring_smem(307, dsize, grid.stages, grid.warps,
                                  grid.rows)
        assert smem <= autotune.SMEM_PER_BLOCK
        # one stage more would not fit (or the ring is at its 16 stages)
        assert grid.stages == 16 or autotune.ring_smem(
            307, dsize, grid.stages + 1, grid.warps, grid.rows) \
            > autotune.SMEM_PER_BLOCK
        # the warps' accumulators fit the ring at the end of the kernel
        assert smem - autotune.ring_smem(307, dsize, 0, grid.warps) \
            >= grid.warps * 3 * 307 * 4
    # stage = R rows + 16 bytes of slack, rounded to 16 bytes
    assert autotune.ring_smem(307, 4, 1, 0, 20) - autotune.ring_smem(
        307, 4, 0, 0, 20) == -(-(20 * 307 * 4 + 16) // 16) * 16
    assert autotune.iter_grid(100, 307, torch.float32).ctas == 5
    # widths past the ring take the wide route, which still fits
    assert autotune.iter_grid(4096, 512, torch.float32).route == "ring"
    R2 = autotune.iter_grid(4096, 5000, torch.float32)
    assert R2.route == "wide" and 1 <= R2.rows < 32 \
        and (R2.rows * 5000 + 4 * 5000 + 128) * 4 <= autotune.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        autotune.iter_grid(4096, 100_000, torch.float32)
    # K2a: splits fill at most GRAM_CTAS CTAs, in 64-row panels
    s = autotune.gram_splits(1 << 24, 307, torch.float32)
    assert s * 15 <= autotune.GRAM_CTAS < (s + 1) * 15
    assert autotune.gram_splits(40, 307, torch.float32) == 1
    assert autotune.gram_splits(1000, 307, torch.float32) == 16
    assert autotune.chunked_block_rows(1 << 20, 512, torch.float32) % 8 == 0
    assert autotune.chunked_block_rows(300, 64, torch.float32) <= 304
    # memoized, and a pinned entry overrides
    assert ("iter", 1 << 24, 307, "float32") in autotune.CACHE
    autotune.CACHE[("iter", 777, 33, "float32")] = ("wide", 5, 3, 1, 8)
    try:
        assert autotune.iter_grid(777, 33, torch.float32) == (
            "wide", 5, 3, 1, 8)
    finally:
        del autotune.CACHE[("iter", 777, 33, "float32")]
