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
    # head dim 8: the arctic-480b and command-r-35b smoke configs
    (2, 8, 2, 256, 256, 8, "bfloat16", True),
    (1, 4, 4, 256, 256, 8, "float32", False),
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


# bf16 cases of the reference (tests/test_kernels.py:98-103) and the model's
# head dim 128 with GQA group 2, causal and not
P_BF16_CASES = [c for c in CASES if c[6] == "bfloat16"] + [
    (1, 4, 2, 256, 256, 128, "bfloat16", True),
    (1, 4, 2, 128, 256, 128, "bfloat16", False),
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,dtype,causal", P_BF16_CASES)
def test_bf16_p_plain_matches_jax_kernel(B, Hq, Hkv, Sq, Skv, D, dtype,
                                         causal):
    """The plain version with P rounded to bf16 (the tensor-core kernel's
    arithmetic) against the JAX kernel, at the reference's bf16 bound."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, Hq, Hkv, Sq, Skv, D, dtype, 5)
    want = _f32(_jax().flash(jq, jk, jv, causal=causal,
                             impl="pallas_interpret", block_q=128,
                             block_k=128))
    got = tops.flash_attention_plain(tq, tk, tv, causal=causal,
                                     block_q=128, block_k=128,
                                     p_dtype=torch.bfloat16)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert np.abs(_f32(got) - want).max() < TDTYPES[dtype][1]


@pytest.mark.parametrize("Sq,Skv,D,causal", [(256, 256, 128, True),
                                             (100, 300, 64, True),
                                             (130, 70, 64, False)])
def test_bf16_p_plain_is_within_one_p_rounding_of_f32_p(Sq, Skv, D, causal):
    """Rounding P to bf16 moves each weight p_j by at most 2^-8 p_j (bf16's
    unit roundoff) while the denominator keeps the unrounded sum, so the
    output moves by at most 2^-8 sum_j p_j |v_j| / l <= 2^-8 max |v|. Held
    on f32 inputs, where no rounding of the output hides it; 1e-6 covers
    the f32 sums."""
    _, (tq, tk, tv) = _qkv(2, 4, 2, Sq, Skv, D, "float32", 6, False)
    f32_p = tops.flash_attention_plain(tq, tk, tv, causal=causal)
    bf16_p = tops.flash_attention_plain(tq, tk, tv, causal=causal,
                                        p_dtype=torch.bfloat16)
    diff = float((bf16_p - f32_p).abs().max())
    assert 0 < diff <= 2.0 ** -8 * float(tv.abs().max()) + 1e-6


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 16, "fma"), (torch.float32, 128, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 16, "fma"),
    (torch.bfloat16, 8, "fma"), (torch.float32, 8, "fma")])
def test_route_rule(dtype, D, want):
    """bf16 at head dims 64 and 128 takes the tensor-core kernel; f32 at
    any head dim and bf16 at head dims 8 and 16 the FP32-FMA kernel."""
    assert tops.route(dtype, D) == want


def test_wrapper_routes_by_impl_and_device():
    _, (tq, tk, tv) = _qkv(1, 2, 1, 64, 64, 16, "float32", 4, False)
    for impl in ("pallas", "pallas_interpret"):
        with pytest.raises(ValueError, match="'cuda'"):
            tops.flash_attention(tq, tk, tv, impl=impl)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.flash_attention(tq, tk, tv, impl="triton")
    counts = lambda: (tops.flash_attention.launches,
                      tops.flash_attention.launches_tc,
                      tops.flash_attention.launches_fma)
    before = counts()
    tops.flash_attention(tq, tk, tv)               # CPU: plain, no launch
    tops.flash_attention(tq.bfloat16(), tk.bfloat16(), tv.bfloat16())
    assert counts() == before
    meta = [t.to("meta") for t in (tq, tk, tv)]    # neither CPU nor CUDA
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tops.flash_attention(*meta)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    fa = tops.flash_attention
    for (B, Hq, Hkv, Sq, Skv, D, causal) in (
            (2, 4, 2, 256, 256, 64, True), (1, 8, 2, 1000, 1000, 128, True),
            (1, 4, 1, 100, 300, 16, True), (2, 2, 2, 130, 70, 64, False),
            (2, 8, 2, 77, 77, 8, True), (1, 8, 8, 70, 130, 8, False),
            # tensor-core shapes: Sq < Skv, ragged Skv, GQA group 2, one
            # row, Sq > Skv, a tile and a row
            (2, 4, 1, 300, 1000, 128, True), (1, 4, 2, 200, 333, 64, False),
            (1, 32, 16, 384, 384, 128, True), (1, 2, 1, 1, 1, 64, True),
            (1, 4, 2, 1000, 300, 128, True), (3, 6, 3, 129, 129, 64, False)):
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q = torch.randn((B, Hq, Sq, D), generator=g, device=dev).to(dt)
            k = torch.randn((B, Hkv, Skv, D), generator=g, device=dev).to(dt)
            v = torch.randn((B, Hkv, Skv, D), generator=g, device=dev).to(dt)
            kernel = tops.route(dt, D)
            before = (fa.launches_tc, fa.launches_fma)
            o = fa(q, k, v, causal=causal)
            o2 = fa(q, k, v, causal=causal)
            p = tops.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert torch.equal(o, o2)
            assert float((o.float() - p.float()).abs().max()) < tol
            moved = (fa.launches_tc - before[0], fa.launches_fma - before[1])
            assert moved == ((2, 0) if kernel == "tc" else (0, 2))
            if kernel == "tc":
                # chip_smoke.py's bound: one output ulp plus 2e-3
                pb = tops.flash_attention_plain(q, k, v, causal=causal,
                                                p_dtype=torch.bfloat16)
                extra = (o.float() - pb.float()).abs() \
                    - 2.0 ** -7 * pb.float().abs()
                assert float(extra.max()) <= 2e-3
    with pytest.raises(ValueError, match="head dim 32"):
        tops.flash_attention(*(torch.zeros((1, 1, 8, 32), device=dev),) * 3)
    # the tensor-core kernel's TMA needs strides in multiples of 8
    x = torch.zeros((1, 1, 8, 68), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tops.flash_attention(*(x[..., :64],) * 3)
