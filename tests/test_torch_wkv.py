"""Port parity: the WKV kernel's wrapper (K5's plain version on CPU
tensors), its oracle and the model's chunked forms against the JAX package
on the same numpy inputs.

The JAX kernel runs as ``tests/test_kernels_wkv.py`` runs it
(``interpret=True``) at that file's three shapes. Tolerances are that
file's: 2e-5 between two chunked forms of the same math (summation order
only), 2e-4 / rtol 1e-3 against the per-step oracle (a different order of
the same recurrence over up to 64 steps).
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.wkv import ops as tops
from repro_torch.kernels.wkv.ref import wkv_ref as t_wkv_ref
from repro_torch.models import rwkv6 as trwkv

torch.set_num_threads(1)

# tests/test_kernels_wkv.py:12-16
SHAPES = [(1, 2, 32, 16, 8), (2, 4, 64, 32, 16), (1, 1, 48, 64, 16)]


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX side, imported by the parity tests only: the card's machine,
    which runs the ``cuda``-marked test, has no JAX."""
    import jax
    from repro.kernels.wkv.ops import wkv
    from repro.kernels.wkv.ref import wkv_ref
    from repro.models.rwkv6 import _wkv_chunked, _wkv_chunked_matmul
    jax.config.update("jax_platform_name", "cpu")
    return SimpleNamespace(
        wkv=wkv, wkv_ref=jax.jit(wkv_ref),
        chunked=jax.jit(_wkv_chunked, static_argnums=5),
        matmul=jax.jit(_wkv_chunked_matmul, static_argnums=5))


def _inputs(B, H, T, hd, seed=0, decay=None):
    """r, k, v, w_log (B, H, T, hd) and u (H, hd) as numpy f32: the
    reference test's scales and its realistic decay -exp(N(-2, 1)), or a
    constant log-decay ``decay``."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, H, T, hd)) for _ in range(3))
    w_log = -np.exp(rng.standard_normal((B, H, T, hd)) - 2.0) \
        if decay is None else np.full((B, H, T, hd), decay)
    u = 0.3 * rng.standard_normal((H, hd))
    return [a.astype(np.float32) for a in (r, k, v, w_log, u)]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("B,H,T,hd,chunk", SHAPES)
def test_wkv_matches_jax_kernel(B, H, T, hd, chunk):
    arrs = _inputs(B, H, T, hd)
    want = np.asarray(_jax().wkv(*arrs, chunk=chunk, interpret=True))
    # CPU tensors: the wrapper runs the kernel's plain version
    got = tops.wkv(*_t(arrs), chunk=chunk, impl="cuda")
    assert got.dtype == torch.float32 and got.shape == (B, H, T, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    plain, _ = tops.wkv_plain(*_t(arrs), chunk=chunk)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("B,H,T,hd,chunk", SHAPES)
def test_wkv_matches_step_oracles(B, H, T, hd, chunk):
    r, k, v, w_log, u = arrs = _inputs(B, H, T, hd, seed=1)
    y, S = tops.wkv(*_t(arrs), chunk=chunk, return_state=True)
    w_clamped = np.maximum(w_log, tops.WKV_LOG_CLAMP)
    jx = _jax()
    for b in range(B):
        for h in range(H):
            one = (r[b, h], k[b, h], v[b, h], w_clamped[b, h], u[h])
            j_y, j_S = jx.wkv_ref(*one)
            t_y, t_S = t_wkv_ref(*_t(one))
            for want_y, want_S in ((np.asarray(j_y), np.asarray(j_S)),
                                   (t_y.numpy(), t_S.numpy())):
                np.testing.assert_allclose(y[b, h].numpy(), want_y,
                                           atol=2e-4, rtol=1e-3)
                np.testing.assert_allclose(S[b, h].numpy(), want_S,
                                           atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("B,H,T,hd,chunk", SHAPES)
def test_wkv_state_matches_chunked_forms(B, H, T, hd, chunk):
    """``return_state``'s S against the reference ``_wkv_chunked_matmul``'s
    S_final (per head), and the port's two chunked forms against the
    reference's, batched over (B, H)."""
    r, k, v, w_log, u = arrs = _inputs(B, H, T, hd, seed=2)
    w_log = np.maximum(w_log, tops.WKV_LOG_CLAMP)
    y, S = tops.wkv(*_t(arrs), chunk=chunk, return_state=True)
    jx = _jax()
    forms = {"matmul": (jx.matmul, trwkv._wkv_chunked_matmul),
             "einsum": (jx.chunked, trwkv._wkv_chunked)}
    for name, (jfn, tfn) in forms.items():
        t_y, t_S = tfn(*_t([r, k, v, w_log, u]), chunk)
        np.testing.assert_allclose(t_y.numpy(), y.numpy(), atol=2e-5,
                                   err_msg=name)
        np.testing.assert_allclose(t_S.numpy(), S.numpy(), atol=2e-5,
                                   err_msg=name)
        for b in range(B):
            for h in range(H):
                j_y, j_S = jfn(r[b, h], k[b, h], v[b, h], w_log[b, h], u[h],
                               chunk)
                np.testing.assert_allclose(S[b, h].numpy(), np.asarray(j_S),
                                           atol=2e-5, err_msg=name)
                np.testing.assert_allclose(t_y[b, h].numpy(),
                                           np.asarray(j_y), atol=2e-5,
                                           err_msg=name)


def test_wkv_hard_decay_stable():
    """tests/test_kernels_wkv.py:56: instant forgetting, clamped at -5."""
    r, k, v, w_log, u = _inputs(1, 1, 32, 16, seed=3, decay=-50.0)
    rng = np.random.default_rng(4)
    r, k, v = (rng.standard_normal(a.shape).astype(np.float32)
               for a in (r, k, v))
    u = np.ones_like(u)
    y, S = tops.wkv(*_t([r, k, v, w_log, u]), chunk=8, return_state=True)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    want = np.asarray(_jax().wkv(r, k, v, w_log, u, chunk=8, interpret=True))
    np.testing.assert_allclose(y.numpy(), want, atol=2e-5)


def test_wkv_longest_chunk_stays_finite_and_longer_raises():
    """At the clamp the reference's kernel returns NaN from chunk 18 on
    (ROADMAP section 3); the port takes chunks up to 17, finite, against
    the per-step oracle, and raises beyond."""
    r, k, v, w_log, u = _inputs(1, 1, 34, 16, seed=8, decay=-50.0)
    y, S = tops.wkv(*_t([r, k, v, w_log, u]), chunk=17, return_state=True)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    y_ref, S_ref = t_wkv_ref(*_t([r[0, 0], k[0, 0], v[0, 0],
                                  np.maximum(w_log[0, 0], -5.0), u[0]]))
    np.testing.assert_allclose(y[0, 0].numpy(), y_ref.numpy(), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(S[0, 0].numpy(), S_ref.numpy(), atol=2e-4,
                               rtol=1e-3)
    for chunk in (0, 18, 34):
        with pytest.raises(ValueError, match="overflow f32"):
            tops.wkv(*_t([r, k, v, w_log, u]), chunk=chunk)


def test_wkv_takes_strided_views_and_bf16():
    """The model's (B, T, H, hd) layout viewed as (B, H, T, hd): y comes
    back in the same layout; bf16 r/k/v give the f32 result of their
    values."""
    arrs = _inputs(2, 3, 24, 16, seed=5)
    dense = _t(arrs)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in dense[:4]] + [dense[4]]
    y_dense = tops.wkv(*dense, chunk=8)
    y_view = tops.wkv(*views, chunk=8)
    assert y_view.stride() == views[0].stride()
    assert torch.equal(y_view, y_dense)
    bf = [t.bfloat16() for t in dense[:3]]
    y_bf = tops.wkv(*bf, dense[3], dense[4], chunk=8)
    y_up = tops.wkv(*(t.float() for t in bf), dense[3], dense[4], chunk=8)
    assert y_bf.dtype == torch.float32 and torch.equal(y_bf, y_up)


def test_wkv_ragged_length_and_impl_raise():
    arrs = _t(_inputs(1, 2, 20, 16, seed=6))
    with pytest.raises(ValueError, match="multiple of chunk"):
        tops.wkv(*arrs, chunk=8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tops.wkv_plain(*arrs, chunk=8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        trwkv._wkv_chunked_matmul(*(t[0] for t in arrs[:4]), arrs[4], 8)
    for impl in ("pallas", "pallas_interpret"):
        with pytest.raises(ValueError, match="'cuda'"):
            tops.wkv(*arrs, chunk=4, impl=impl)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.wkv(*arrs, chunk=4, impl="triton")


def test_wkv_routes_by_device_and_checks_inputs():
    arrs = _t(_inputs(1, 2, 16, 16, seed=7))
    before = tops.wkv.launches
    tops.wkv(*arrs, chunk=4)                      # CPU: plain, no launch
    assert tops.wkv.launches == before
    meta = [t.to("meta") for t in arrs]           # neither CPU nor CUDA
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tops.wkv(*meta, chunk=4)
    odd = [torch.zeros((1, 2, 16, 24), device="meta")] * 4 \
        + [torch.zeros((2, 24), device="meta")]
    with pytest.raises(ValueError, match="head dim 24"):
        tops.wkv(*odd, chunk=4)
    with pytest.raises(ValueError, match="do not match"):
        tops.wkv(*meta[:4], meta[4][:1], chunk=4)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        tops.wkv(meta[0].half(), *meta[1:], chunk=4)
    with pytest.raises(ValueError, match="chunk 18 is not in 1..17"):
        tops.wkv(*[torch.zeros((1, 2, 36, 16), device="meta")] * 4,
                 meta[4], chunk=18)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K5 against its plain version on the card: the reference test's
    shapes, chunk 4 and 17, chunk 1, T of one chunk, the realistic and the
    hard decay (w_log = -50, clamped to -5), the model's (B, S, H, hd) view,
    the (B, H, T, hd) contiguous layout and a view off 16-byte alignment
    (staged by plain loads), f32 and bf16; two identical
    calls bitwise equal. Bound: 2e-5 absolute."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [(*s, "data") for s in SHAPES + [(2, 3, 64, 64, 4),
                                              (1, 2, 272, 64, 17),
                                              (2, 3, 48, 64, 1),
                                              (2, 3, 16, 64, 16),
                                              (1, 2, 17, 32, 17)]]
    shapes += [(1, 2, 64, 64, 16, "hard"), (1, 2, 34, 16, 17, "hard")]
    for (B, H, T, hd, chunk, decay) in shapes:
        for dt in (torch.float32, torch.bfloat16):
            for layout in ("model", "bhtd", "offset"):
                def make(scale, dtype=torch.float32):
                    if layout == "bhtd":
                        t = torch.randn((B, H, T, hd), generator=g,
                                        device=dev)
                        return (scale * t).to(dtype)
                    # the model's (B, S, H, hd) view; "offset" starts one
                    # element in, off 16-byte alignment
                    extra = int(layout == "offset")
                    t = torch.randn((B, T, H, hd + extra), generator=g,
                                    device=dev)
                    return (scale * t).to(dtype)[..., extra:].transpose(1, 2)
                r, k, v = (make(0.5, dt) for _ in range(3))
                w_log = -torch.exp(make(1.0) - 2.0) if decay == "data" \
                    else make(0.0) - 50.0
                u = 0.3 * torch.randn((H, hd), generator=g, device=dev)
                launched = tops.wkv.launches
                y, S = tops.wkv(r, k, v, w_log, u, chunk=chunk,
                                return_state=True)
                y2, S2 = tops.wkv(r, k, v, w_log, u, chunk=chunk,
                                  return_state=True)
                yp, Sp = tops.wkv_plain(r, k, v, w_log, u, chunk=chunk)
                torch.cuda.synchronize()
                assert tops.wkv.launches == launched + 2
                assert torch.equal(y, y2) and torch.equal(S, S2)
                assert y.stride() == torch.empty_like(
                    r, dtype=torch.float32).stride()
                assert float((y - yp).abs().max()) < 2e-5
                assert float((S - Sp).abs().max()) < 2e-5
