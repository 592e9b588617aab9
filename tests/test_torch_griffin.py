"""Port parity: the Griffin recurrent block (``repro_torch.models.griffin``)
against the JAX package on the same weights (``convert.lm_params``) and
numpy inputs, and the mirrors of ``tests/test_moe_rwkv_griffin.py``'s three
griffin tests.

Tolerances: the mirrors keep the reference's 1e-4 (scan against steps) and
its bounds. Against JAX in f32: 1e-5 for ``rg_lru`` and the block, whose
scans (XLA's associative_scan, the port's doubling scan) compose the affine
maps in other trees, so values agree to f32 rounding of O(1) states; in
bf16 2e-2 (a bf16 rounding of O(1) outputs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import griffin as jg
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.models import griffin as tg
from repro_torch.models.config import ModelConfig as TConfig

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TDTYPE = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}

# tests/test_moe_rwkv_griffin.py:102-105
GRIF_CFG = JConfig(
    name="t", family="griffin", num_layers=3, d_model=64, num_heads=4,
    num_kv_heads=1, d_ff=128, vocab_size=100, lru_width=96,
    pattern=("rec", "rec", "attn_local"), compute_dtype=jnp.float32)


def to_torch_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["param_dtype"] = TDTYPE[jnp.dtype(jcfg.param_dtype)]
    kw["compute_dtype"] = TDTYPE[jnp.dtype(jcfg.compute_dtype)]
    return TConfig(**kw)


CFG = to_torch_config(GRIF_CFG)


def _pair(jcfg=GRIF_CFG, seed=0):
    jp = jg.init_recurrent_block(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed=1, scale=0.5):
    return scale * np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _own(seed=0):
    return tg.init_recurrent_block(torch.Generator().manual_seed(seed), CFG)


# -- mirrors of tests/test_moe_rwkv_griffin.py:108-140 -----------------------

def test_griffin_scan_equals_step():
    p = _own()
    B, S = 2, 17
    x = torch.from_numpy(_x((B, S, 64)))
    out_seq, _ = tg.recurrent_block(p, CFG, x)
    st = (torch.zeros((B, 96)), torch.zeros((B, 3, 96)))
    outs = []
    for t in range(S):
        o, st = tg.recurrent_block_step(p, CFG, x[:, t], st)
        outs.append(o)
    np.testing.assert_allclose(out_seq.numpy(),
                               torch.stack(outs, 1).numpy(), atol=1e-4)


def test_griffin_state_carry_continuity():
    p = _own()
    B, S = 2, 16
    x = torch.from_numpy(_x((B, S, 64), seed=2))
    full, _ = tg.recurrent_block(p, CFG, x)
    o1, s1 = tg.recurrent_block(p, CFG, x[:, :9])
    o2, _ = tg.recurrent_block(p, CFG, x[:, 9:], s1)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), full.numpy(),
                               atol=1e-4)


def test_rg_lru_is_contraction():
    """|a_t| < 1 by construction: long-run state stays bounded."""
    p = _own()
    x = torch.ones((1, 512, 64))
    out, (h, _) = tg.recurrent_block(p, CFG, x)
    assert bool(torch.isfinite(out).all())
    assert float(h.abs().max()) < 1e3


# -- against the JAX package -------------------------------------------------

def test_init_tree_matches_reference():
    jp, _ = _pair()
    own = _own()
    assert sorted(own) == sorted(jp)
    for k, leaf in jp.items():
        assert tuple(own[k].shape) == leaf.shape, k
        assert own[k].dtype == TDTYPE[leaf.dtype], k
    np.testing.assert_array_equal(own["lru_lambda"].numpy(),
                                  np.asarray(jp["lru_lambda"]))


@pytest.mark.parametrize("S", [1, 2, 17, 64])
def test_scan_affine_equals_sequential_recurrence(S):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, S, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, S, 5)).astype(np.float32))
    h, want = torch.zeros((2, 5)), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(tg.scan_affine(a, b).numpy(),
                               torch.stack(want, 1).numpy(), atol=1e-6)


def test_causal_conv_matches_jax():
    x = _x((2, 9, 96), seed=3)
    w, bias = _x((4, 96), seed=4), _x((96,), seed=5)
    tail = _x((2, 3, 96), seed=6)
    for t in (None, tail):
        jo, jt = jg._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(bias),
                                 None if t is None else jnp.asarray(t))
        to, tt = tg._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias),
                                 None if t is None else torch.from_numpy(t))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_matches_jax(with_h0):
    jp, tp = _pair()
    x = _x((2, 33, 96), seed=7)
    h0 = _x((2, 96), seed=8) if with_h0 else None
    jy, jh = jax.jit(jg.rg_lru)(jp, jnp.asarray(x),
                                None if h0 is None else jnp.asarray(h0))
    ty, th = tg.rg_lru(tp, torch.from_numpy(x),
                       None if h0 is None else torch.from_numpy(h0))
    assert th.dtype == torch.float32 and th.shape == (2, 96)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_recurrent_block_matches_jax(with_state):
    jp, tp = _pair(seed=1)
    x = _x((2, 20, 64), seed=9)
    st = (_x((2, 96), seed=10), _x((2, 3, 96), seed=11)) if with_state \
        else None
    jst = None if st is None else tuple(jnp.asarray(s) for s in st)
    tst = None if st is None else tuple(torch.from_numpy(s) for s in st)
    jo, (jh, jt) = jax.jit(jg.recurrent_block, static_argnums=1)(
        jp, GRIF_CFG, jnp.asarray(x), jst)
    to, (th, tt) = tg.recurrent_block(tp, CFG, torch.from_numpy(x), tst)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    assert th.dtype == tt.dtype == torch.float32
    # one decode step
    jo1, _ = jg.recurrent_block_step(jp, GRIF_CFG, jnp.asarray(x[:, 0]),
                                     (jh, jt))
    to1, _ = tg.recurrent_block_step(tp, CFG, torch.from_numpy(x[:, 0]),
                                     (th, tt))
    np.testing.assert_allclose(to1.numpy(), np.asarray(jo1), atol=1e-5)


def test_recurrent_block_matches_jax_bf16():
    jcfg = dataclasses.replace(GRIF_CFG, compute_dtype=jnp.bfloat16)
    tcfg = to_torch_config(jcfg)
    jp, tp = _pair(jcfg, seed=2)
    x = _x((2, 24, 64), seed=12)
    jo, _ = jax.jit(jg.recurrent_block, static_argnums=1)(
        jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    to, (th, _) = tg.recurrent_block(tp, tcfg,
                                     torch.from_numpy(x).bfloat16())
    assert to.dtype == torch.bfloat16 and th.dtype == torch.float32
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=2e-2)
