"""Port parity: flash attention (K4's wrapper and plain version, the chunked
path and the oracle) against the JAX package on the same numpy inputs.

The JAX kernel runs as ``tests/test_kernels.py:106-117`` runs it
(``impl="pallas_interpret"``, 128-row blocks) and through ``mha_ref``.
Tolerances are that test's: 2e-5 for f32, 2e-2 for bf16 (one bf16 rounding
of an O(1) output).
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn import ops as tops
from repro_torch.kernels.flash_attn.ref import mha_ref as t_mha_ref

torch.set_num_threads(1)

TDTYPES = {"float32": (torch.float32, 2e-5),
           "bfloat16": (torch.bfloat16, 2e-2)}

# tests/test_kernels.py:98-103
CASES = [
    (2, 4, 2, 256, 256, 64, "float32", True),
    (1, 8, 1, 512, 512, 128, "float32", True),
    (2, 4, 4, 256, 256, 64, "bfloat16", True),
    (1, 2, 2, 256, 512, 64, "float32", False),
]


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX side, imported by the parity tests only: the card's machine,
    which runs the ``cuda``-marked test, has no JAX."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attn.ops import chunked_attention_xla
    from repro.kernels.flash_attn.ops import flash_attention
    from repro.kernels.flash_attn.ref import mha_ref
    jax.config.update("jax_platform_name", "cpu")
    return SimpleNamespace(
        jnp=jnp, flash=flash_attention, chunked=chunked_attention_xla,
        # jitted: one compile per shape instead of one per primitive
        mha_ref=jax.jit(mha_ref, static_argnames=("causal", "scale")),
        dtypes={"float32": jnp.float32, "bfloat16": jnp.bfloat16})


def _qkv(B, Hq, Hkv, Sq, Skv, D, dtype, seed=0, jax_side=True):
    """The same q, k, v in both packages (bf16 rounds identically)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    td = TDTYPES[dtype][0]
    tq = [torch.from_numpy(a).to(td) for a in arrs]
    if not jax_side:
        return None, tq
    jx = _jax()
    return [jx.jnp.asarray(a, jx.dtypes[dtype]) for a in arrs], tq


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,dtype,causal", CASES)
def test_flash_attention_matches_jax_kernel(B, Hq, Hkv, Sq, Skv, D, dtype,
                                            causal):
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, Hq, Hkv, Sq, Skv, D, dtype)
    tol = TDTYPES[dtype][1]
    jx = _jax()
    j_kernel = _f32(jx.flash(jq, jk, jv, causal=causal,
                             impl="pallas_interpret", block_q=128,
                             block_k=128))
    j_ref = _f32(jx.mha_ref(jq, jk, jv, causal=causal))
    outs = {
        # a CPU tensor: the wrapper runs the kernel's plain version
        "cuda-on-cpu": tops.flash_attention(tq, tk, tv, causal=causal,
                                            block_q=128, block_k=128),
        "plain": tops.flash_attention_plain(tq, tk, tv, causal=causal),
        "xla": tops.flash_attention(tq, tk, tv, causal=causal, impl="xla",
                                    block_q=128, block_k=128),
        "mha_ref": t_mha_ref(tq, tk, tv, causal=causal),
    }
    for name, o in outs.items():
        assert o.dtype == tq.dtype and o.shape == tq.shape, name
        for want in (j_kernel, j_ref):
            assert np.abs(_f32(o) - want).max() < tol, name


@pytest.mark.parametrize("causal,window", [(True, 16), (False, 0),
                                           (False, 24)])
def test_chunked_attention_matches_jax(causal, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 4, 2, 96, 96, 32, "float32", 1)
    want = np.asarray(_jax().chunked(jq, jk, jv, causal=causal,
                                     window=window, chunk_q=32))
    got = tops.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                 chunk_q=32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("Sq,Skv,causal", [(200, 200, True),
                                           (100, 300, True),
                                           (130, 70, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_lengths_match_oracle(Sq, Skv, causal, dtype):
    """Lengths that are no multiple of any tile (the TPU kernel asserted
    them away): the plain version against both packages' oracles."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 4, 2, Sq, Skv, 16, dtype, 2)
    tol = TDTYPES[dtype][1]
    want = _f32(_jax().mha_ref(jq, jk, jv, causal=causal))
    for bq, bk in ((64, 64), (48, 80)):
        got = tops.flash_attention_plain(tq, tk, tv, causal=causal,
                                         block_q=bq, block_k=bk)
        assert np.abs(_f32(got) - want).max() < tol
    assert np.abs(_f32(t_mha_ref(tq, tk, tv, causal=causal))
                  - want).max() < tol


def test_plain_version_is_repeatable_and_scaled():
    _, (tq, tk, tv) = _qkv(1, 2, 1, 70, 70, 16, "float32", 3, False)
    a = tops.flash_attention_plain(tq, tk, tv, causal=True, scale=0.3)
    b = tops.flash_attention_plain(tq, tk, tv, causal=True, scale=0.3)
    assert torch.equal(a, b)
    want = t_mha_ref(tq, tk, tv, causal=True, scale=0.3)
    assert float((a - want).abs().max()) < 2e-5


def test_wrapper_routes_by_impl_and_device():
    _, (tq, tk, tv) = _qkv(1, 2, 1, 64, 64, 16, "float32", 4, False)
    for impl in ("pallas", "pallas_interpret"):
        with pytest.raises(ValueError, match="'cuda'"):
            tops.flash_attention(tq, tk, tv, impl=impl)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.flash_attention(tq, tk, tv, impl="triton")
    before = tops.flash_attention.launches
    tops.flash_attention(tq, tk, tv)               # CPU: plain, no launch
    assert tops.flash_attention.launches == before
    meta = [t.to("meta") for t in (tq, tk, tv)]    # neither CPU nor CUDA
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tops.flash_attention(*meta)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for (B, Hq, Hkv, Sq, Skv, D, causal) in (
            (2, 4, 2, 256, 256, 64, True), (1, 8, 2, 1000, 1000, 128, True),
            (1, 4, 1, 100, 300, 16, True), (2, 2, 2, 130, 70, 64, False)):
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q = torch.randn((B, Hq, Sq, D), generator=g, device=dev).to(dt)
            k = torch.randn((B, Hkv, Skv, D), generator=g, device=dev).to(dt)
            v = torch.randn((B, Hkv, Skv, D), generator=g, device=dev).to(dt)
            o = tops.flash_attention(q, k, v, causal=causal)
            o2 = tops.flash_attention(q, k, v, causal=causal)
            p = tops.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert torch.equal(o, o2)
            assert float((o.float() - p.float()).abs().max()) < tol
    with pytest.raises(ValueError, match="head dim 32"):
        tops.flash_attention(*(torch.zeros((1, 1, 8, 32), device=dev),) * 3)
