"""Port parity: the fused iteration body (K3's plain version, returning
y', lam', d, w, v and the four stopping sums) against the JAX package's
``admm_iter_full`` in interpret mode (the first five), on a subset of
``tests/test_kernels_admm_iter.py`` CASES (y/lam atol 2e-5) plus the kinds
that file leaves out.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.engine import autotune
from repro_torch.kernels.admm_iter import ops as tops
from repro_torch.kernels.admm_iter.ref import admm_iter_ref

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX side, imported by the parity tests only: the card's machine,
    which runs the ``cuda``-marked test, has no JAX."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.admm_iter import ops
    from repro.kernels.admm_iter.ref import admm_iter_ref as j_ref
    jax.config.update("jax_platform_name", "cpu")
    return SimpleNamespace(jnp=jnp, ops=ops, ref=j_ref)


CASES = [
    (2048, 128, "float32", "logistic", 0.0),
    (3000, 307, "float32", "logistic", 0.0),   # star-cell width, ragged m
    (2048, 256, "bfloat16", "logistic", 0.0),
    (1500, 64, "float32", "hinge", 0.0),
    (777, 33, "float32", "l1", 0.0),
    (1000, 50, "float32", "least_squares", 0.0),
    (1000, 50, "float32", "quantile", 0.3),
]


def _state(m, n, dtype, seed=0, jax_side=True):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n)).astype(np.float32)
    aux = np.sign(rng.standard_normal(m)).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    lam = rng.standard_normal(m).astype(np.float32)
    x = (0.1 * rng.standard_normal(n)).astype(np.float32)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    t = (torch.from_numpy(D).to(td), torch.from_numpy(aux),
         torch.from_numpy(y), torch.from_numpy(lam), torch.from_numpy(x))
    if not jax_side:
        return None, t
    jnp = _jax().jnp
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j = (jnp.asarray(D, jd), jnp.asarray(aux), jnp.asarray(y),
         jnp.asarray(lam), jnp.asarray(x))
    return j, t


@pytest.mark.parametrize("m,n,dtype,kind,param", CASES)
def test_admm_iter_full_matches_jax(m, n, dtype, kind, param):
    j, t = _state(m, n, dtype)
    out_j = _jax().ops.admm_iter_full(*j, kind=kind, delta=2.0, block_m=512,
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


def _loss(kind, param):
    """The kind's ProxLoss, hinge and l1 with an outer scale != 1."""
    from repro_torch.core import prox
    if kind == "hinge":
        return prox.make_hinge(0.7)
    if kind == "l1":
        return prox.make_l1(0.3)
    if kind == "quantile":
        return prox.make_quantile(param)
    return prox.LOSSES[kind]()


def _torch_stop_terms(loss, aux, y_new, lam_new, lam):
    """``exec/local.py::fused_step``'s torch expressions on given iterates,
    in the order (r_sq, dx_sq, y_sq, obj)."""
    Dx = lam_new - lam + y_new
    return torch.stack([torch.sum((lam_new - lam) ** 2), torch.sum(Dx * Dx),
                        torch.sum(y_new * y_new), loss.value(Dx, aux)])


@pytest.mark.parametrize("m,n,dtype,kind,param", CASES)
def test_plain_stop_sums_match_torch_expressions(m, n, dtype, kind, param):
    """The plain version's fifth output, (r_sq, dx_sq, y_sq, obj), equals
    the stopping rule's torch expressions on its own y' and lam', obj
    scaled by the loss's outer weight (hinge's C, l1's mu)."""
    _, t = _state(m, n, dtype, jax_side=False)
    D, aux, y, lam, x = t
    a = None if kind == "l1" else aux
    loss = _loss(kind, param)
    out = tops.admm_iter_full(D, a, y, lam, x, kind=kind, delta=2.0,
                              param=param, scale=loss.kernel_delta_scale)
    assert len(out) == 6 and out[5].shape == (4,)
    want = _torch_stop_terms(loss, a, out[0], out[1], lam)
    np.testing.assert_allclose(out[5].numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("kind", ["logistic", "hinge"])
def test_admm_iter_three_tuple_and_ref_match_jax_ref(kind):
    j, t = _state(1500, 64, "float32", seed=1)
    yj, lj, dj = _jax().ref(*j, kind=kind, delta=2.0)
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
    _, t = _state(777, 33, "float32", seed=2, jax_side=False)
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
    _, t = _state(100, 8, "float32", jax_side=False)
    with pytest.raises(ValueError, match="huber"):
        tops.admm_iter_full(*t, kind="huber", delta=1.0)


KINDS = ("logistic", "hinge", "l1", "least_squares", "quantile")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K3 against its plain version on the card, on both routes (each
    call's route read from the counters): all five kinds at n = 307, odd
    and even n, a ragged m, D aligned and as a row-offset view (a base off
    16-byte alignment: the ring copies the ragged bytes by hand), f32 and
    bf16, and n = 307 pinned to the wide route; two identical calls
    bitwise equal, the four stopping sums included. Bounds: chip_smoke.py's
    small-shape 2e-5, relative to max(1, max |plain|); the four sums within
    1e-5 relative of the torch expressions on the kernel's own y' and lam'
    and of the plain version's sums (hinge and l1 with an outer scale, l1
    with a null aux)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    fn = tops.admm_iter_full
    cases = [(1000, 307, torch.float32, k, None) for k in KINDS] + [
        (4099, 307, torch.bfloat16, "logistic", None),
        (70001, 307, torch.float32, "hinge", None),
        (1000, 33, torch.float32, "logistic", None),
        (999, 128, torch.float32, "logistic", None),
        (3001, 512, torch.bfloat16, "quantile", None),
        (3000, 2050, torch.float32, "logistic", None),
        (4099, 307, torch.float32, "logistic", "wide"),
        (4099, 307, torch.bfloat16, "l1", "wide")]
    for m, n, dt, kind, pin in cases:
        base = torch.randn((m + 1, n), generator=g, device=dev).to(dt)
        aux = torch.sign(torch.randn(m, generator=g, device=dev))
        y, lam = (torch.randn(m, generator=g, device=dev) for _ in range(2))
        x = 0.1 * torch.randn(n, generator=g, device=dev)
        a = None if kind == "l1" else aux
        p = 0.3 if kind == "quantile" else 0.0
        loss = _loss(kind, p)
        sc = loss.kernel_delta_scale
        key = ("iter", m, n, str(dt).replace("torch.", ""))
        if pin:
            autotune.CACHE[key] = autotune._wide_grid(m, n)
        try:
            want = "wide" if pin else ("ring" if n <= 512 else "wide")
            assert tops.route(m, n, dt) == want
            for D in (base[:m], base[1:]):
                before = (fn.launches_ring, fn.launches_wide)
                o1 = fn(D, a, y, lam, x, kind=kind, delta=2.0, param=p,
                        scale=sc)
                o2 = fn(D, a, y, lam, x, kind=kind, delta=2.0, param=p,
                        scale=sc)
                op = tops.admm_iter_plain(D, a, y, lam, x, kind=kind,
                                          delta=2.0, param=p, scale=sc)
                torch.cuda.synchronize()
                moved = (fn.launches_ring - before[0],
                         fn.launches_wide - before[1])
                assert moved == ((2, 0) if want == "ring" else (0, 2)), \
                    (m, n, dt, kind, pin, moved)
                assert all(torch.equal(u, v) for u, v in zip(o1, o2))
                for u, v in zip(o1, op):
                    scale = max(1.0, float(v.abs().max()))
                    assert float((u - v).abs().max()) <= 2e-5 * scale, \
                        (m, n, dt, kind, pin)
                terms = _torch_stop_terms(loss, a, o1[0], o1[1], lam)
                for ref in (terms, op[5]):
                    rel = ((o1[5] - ref).abs() / ref.abs()).max()
                    assert float(rel) <= 1e-5, (m, n, dt, kind, pin,
                                                o1[5].tolist(), ref.tolist())
        finally:
            if pin:
                del autotune.CACHE[key]
