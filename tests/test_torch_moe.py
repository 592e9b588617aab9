"""Port parity: the MoE FFN (``repro_torch.models.moe``) against the JAX
package on the same weights (carried by ``convert.lm_params``) and the same
numpy inputs, and the mirrors of ``tests/test_moe_rwkv_griffin.py``'s four
MoE tests.

Tolerances: the mirrors keep the reference's 2e-6 (f32, dispatch against
the dense oracle). Against JAX in f32 2e-6 (the same sums in another
order); in bf16 2e-2 on O(1) outputs (a bf16 rounding or two of the expert
products, which torch's CPU matmul rounds at other places than XLA's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TConfig

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TDTYPE = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}

# tests/test_moe_rwkv_griffin.py:15-18
MOE_CFG = JConfig(
    name="t", family="moe", num_layers=1, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=100, num_experts=8,
    experts_per_token=2, capacity_factor=8.0, compute_dtype=jnp.float32)


def to_torch_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["param_dtype"] = TDTYPE[jnp.dtype(jcfg.param_dtype)]
    kw["compute_dtype"] = TDTYPE[jnp.dtype(jcfg.compute_dtype)]
    return TConfig(**kw)


def _pair(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _own(cfg, seed=0):
    """The port's own weights (the mirrors run on the port alone)."""
    return tmoe.init_moe(torch.Generator().manual_seed(seed), cfg)


# -- mirrors of tests/test_moe_rwkv_griffin.py:20-62 -------------------------

def test_moe_matches_dense_reference():
    cfg = to_torch_config(MOE_CFG)
    p = _own(cfg)
    x = torch.from_numpy(_x((2, 16, 64)))
    out, aux = tmoe.moe_ffn(p, cfg, x)
    ref = tmoe.moe_ffn_dense_ref(p, cfg, x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-6)
    assert float(aux) > 0


def test_moe_capacity_drops_are_silent_zero():
    cfg = to_torch_config(MOE_CFG)
    tight = dataclasses.replace(cfg, capacity_factor=0.25)
    p = _own(cfg)
    x = torch.from_numpy(_x((2, 16, 64)))
    out, _ = tmoe.moe_ffn(p, tight, x)
    full, _ = tmoe.moe_ffn(p, cfg, x)
    assert bool(torch.isfinite(out).all())
    # dropped tokens -> smaller output norm than uncapped
    assert float(out.norm()) < float(full.norm()) + 1e-3


def test_moe_deterministic():
    cfg = to_torch_config(MOE_CFG)
    p = _own(cfg)
    x = torch.from_numpy(_x((2, 16, 64)))
    o1, _ = tmoe.moe_ffn(p, cfg, x)
    o2, _ = tmoe.moe_ffn(p, cfg, x)
    assert torch.equal(o1, o2)


def test_moe_dense_residual_branch():
    cfg = dataclasses.replace(to_torch_config(MOE_CFG),
                              moe_dense_residual=True)
    p = _own(cfg)
    assert set(p["dense"]) == {"w1", "w2", "w3"}
    x = torch.from_numpy(_x((2, 16, 64)))
    out, _ = tmoe.moe_ffn(p, cfg, x)
    ref = tmoe.moe_ffn_dense_ref(p, cfg, x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-6)


# -- against the JAX package -------------------------------------------------

def test_init_moe_tree_matches_reference():
    for residual in (False, True):
        jcfg = dataclasses.replace(MOE_CFG, moe_dense_residual=residual)
        jp, _ = _pair(jcfg)
        own = _own(to_torch_config(jcfg))
        assert sorted(own) == sorted(jp)
        for key, leaf in jax.tree_util.tree_leaves_with_path(jp):
            o = own
            for k in key:
                o = o[k.key]
            assert tuple(o.shape) == leaf.shape
            assert o.dtype == TDTYPE[leaf.dtype]
        assert own["router"].dtype == torch.float32


def test_route_topk_matches_jax():
    logits = 2.0 * _x((64, 8), seed=3)
    # exact ties: lax.top_k puts the lower index first
    logits[0, 2] = logits[0, 5] = logits[0].max() + 1.0
    logits[1, :] = 0.0
    jw, ji, jaux = jmoe.route_topk(jnp.asarray(logits), 2)
    tw, ti, taux = tmoe.route_topk(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [2, 5] and ti[1].tolist() == [0, 1]
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def _routing(cfg, p, x):
    logits = x.reshape(-1, x.shape[-1]).float() @ p["router"]
    return tmoe.route_topk(logits, cfg.experts_per_token)[1]


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.25])
def test_moe_ffn_matches_jax_f32(capacity_factor):
    """Same experts for every token first (a routing flip shows as itself),
    then the outputs; at 1.25 and 0.25 capacity drops pairs, the same in
    both packages; the combine repeats bit for bit."""
    jcfg = dataclasses.replace(MOE_CFG, capacity_factor=capacity_factor)
    tcfg = to_torch_config(jcfg)
    jp, tp = _pair(jcfg)
    x = _x((2, 16, 64))
    jx = jnp.asarray(x)
    jlogits = jx.reshape(-1, 64) @ jp["router"]
    ji = np.asarray(jmoe.route_topk(jlogits, 2)[1])
    np.testing.assert_array_equal(
        _routing(tcfg, tp, torch.from_numpy(x)).numpy(), ji)
    jout, jaux = jax.jit(jmoe.moe_ffn, static_argnums=1)(jp, jcfg, jx)
    tmoe.DROP_STATS = []
    try:
        tout, taux = tmoe.moe_ffn(tp, tcfg, torch.from_numpy(x))
        (kept, routed), = tmoe.DROP_STATS
    finally:
        tmoe.DROP_STATS = None
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    C = tmoe.capacity(tcfg, 32)
    assert routed == 64 and int(kept) == int(
        np.minimum(np.bincount(ji.reshape(-1), minlength=8), C).sum())
    assert (int(kept) < routed) == (capacity_factor < 8.0)
    again, _ = tmoe.moe_ffn(tp, tcfg, torch.from_numpy(x))
    assert torch.equal(tout, again)


def test_moe_ffn_matches_jax_bf16():
    jcfg = dataclasses.replace(MOE_CFG, compute_dtype=jnp.bfloat16,
                               moe_dense_residual=True)
    tcfg = to_torch_config(jcfg)
    jp, tp = _pair(jcfg)
    x = _x((2, 16, 64))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    jout, _ = jax.jit(jmoe.moe_ffn, static_argnums=1)(jp, jcfg, jx)
    tout, _ = tmoe.moe_ffn(tp, tcfg, tx)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32), atol=2e-2)
    again, _ = tmoe.moe_ffn(tp, tcfg, tx)
    assert torch.equal(tout, again)


def test_capacity_override_and_dense_ref_match_jax():
    tcfg = to_torch_config(MOE_CFG)
    jp, tp = _pair(MOE_CFG, seed=2)
    x = _x((1, 24, 64), seed=4)
    jout, _ = jmoe.moe_ffn(jp, MOE_CFG, jnp.asarray(x), capacity_override=2)
    tout, _ = tmoe.moe_ffn(tp, tcfg, torch.from_numpy(x),
                           capacity_override=2)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-6)
    jref = jmoe.moe_ffn_dense_ref(jp, MOE_CFG, jnp.asarray(x))
    tref = tmoe.moe_ffn_dense_ref(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), atol=2e-6)
    assert tmoe.capacity(tcfg, 24) == int(max(1, round(24 * 2 / 8 * 8.0)))
