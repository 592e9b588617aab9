"""Port parity: the rwkv6 family (``models/rwkv6.py``, the ``"rwkv"`` layer
kind of ``forward`` / ``loss_fn`` and of the serving path) against the JAX
package on the same weights (carried by ``convert.lm_params``) and the
same numpy inputs.

The layers run at ``tests/test_moe_rwkv_griffin.py``'s ``RWKV_CFG`` (f32),
through both WKV paths: ``wkv_impl="cuda"`` (K5's plain version on CPU
tensors) and ``"xla"`` (the reference's chunked form, ``cfg.wkv_impl``
``"matmul"`` or ``"einsum"``). The bounds are ``tests/test_torch_models.py``'s:
2e-5 in f32 (summation order only); 6e-2 on hidden states and 1e-2
relative on the loss for the bf16 smoke config; serving as
``tests/test_decode_parity.py``'s rwkv row, 2e-4 with f32 caches.

In bf16 the per-head GroupNorm (epsilon 64e-5) multiplies a head whose
outputs are nearly equal by up to 1 / sqrt(64e-5) ~ 40, so a bf16 rounding
that differs between the packages can grow past the bf16 bound at such a
position (with token seed 5 both packages' bf16 runs lie 0.28-0.37 from
their own f32 runs at position 1). The bf16 case runs at
``tests/test_torch_models.py``'s token seed (1), where the largest
difference is 0.039.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import decode as jd
from repro.models import model as jm
from repro.models import rwkv6 as jr
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.models import decode as td
from repro_torch.models import model as tm
from repro_torch.models import rwkv6 as tr
from test_torch_models import to_torch_config

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

# tests/test_moe_rwkv_griffin.py:59-62
RWKV_CFG = JConfig(
    name="t", family="rwkv6", num_layers=1, d_model=128, num_heads=2,
    num_kv_heads=2, d_ff=256, vocab_size=100, rwkv_head_dim=32,
    rwkv_lora_rank=8, wkv_chunk=8, compute_dtype=jnp.float32)
# a two-layer f32 model (tests/test_decode_parity.py:14-22, rwkv row, at
# two layers)
RWKV_F32 = dict(name="rwkv", family="rwkv6", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                compute_dtype=jnp.float32, rwkv_head_dim=16,
                rwkv_lora_rank=4, wkv_chunk=4)
PATHS = [("cuda", "matmul"), ("xla", "matmul"), ("xla", "einsum")]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _randn(shape, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mixers(seed=0):
    """One time-mix and one channel-mix of RWKV_CFG, in both packages."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jp = {"tmix": jr.init_time_mix(k1, RWKV_CFG),
          "cmix": jr.init_channel_mix(k2, RWKV_CFG)}
    # random mix biases and bonus (the init's are zero), so that every
    # term of the ddlerp and the bonus diagonal is exercised
    jp["tmix"] = dict(jp["tmix"],
                      maa_base=jnp.asarray(_randn((5, 128), 11, 0.3)),
                      bonus=jnp.asarray(_randn((4, 32), 12, 0.3)))
    jp["cmix"] = dict(jp["cmix"], mu_k=jnp.asarray(_randn((128,), 13, 0.3)),
                      mu_r=jnp.asarray(_randn((128,), 14, 0.3)))
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("wkv_impl,form", PATHS)
def test_time_mix_matches(wkv_impl, form):
    jcfg = dataclasses.replace(RWKV_CFG, wkv_impl=form)
    tcfg = to_torch_config(jcfg)
    jp, tp = _mixers()
    x = _randn((2, 32, 128), 1)
    prev = _randn((2, 128), 2)
    for last in (None, prev):
        j_out, (j_last, j_S) = jax.jit(jr.time_mix, static_argnums=1)(
            jp["tmix"], jcfg, jnp.asarray(x),
            None if last is None else jnp.asarray(last))
        t_out, (t_last, t_S) = tr.time_mix(
            tp["tmix"], tcfg, torch.from_numpy(x),
            None if last is None else torch.from_numpy(last),
            wkv_impl=wkv_impl)
        np.testing.assert_allclose(_np(t_out), _np(j_out), atol=2e-5)
        np.testing.assert_allclose(_np(t_S), _np(j_S), atol=2e-5)
        np.testing.assert_allclose(_np(t_last), _np(j_last), atol=0)
        assert t_S.shape == (2, 4, 32, 32)


def test_channel_mix_matches():
    tcfg = to_torch_config(RWKV_CFG)
    jp, tp = _mixers()
    x, prev = _randn((2, 12, 128), 3), _randn((2, 128), 4)
    for last in (None, prev):
        j_out, j_last = jr.channel_mix(
            jp["cmix"], RWKV_CFG, jnp.asarray(x),
            None if last is None else jnp.asarray(last))
        t_out, t_last = tr.channel_mix(
            tp["cmix"], tcfg, torch.from_numpy(x),
            None if last is None else torch.from_numpy(last))
        np.testing.assert_allclose(_np(t_out), _np(j_out), atol=2e-5)
        np.testing.assert_allclose(_np(t_last), _np(j_last), atol=0)


def test_step_forms_match():
    """time_mix_step and channel_mix_step, one step from a random state."""
    tcfg = to_torch_config(RWKV_CFG)
    jp, tp = _mixers()
    x, last = _randn((2, 128), 5), _randn((2, 128), 6)
    S = _randn((2, 4, 32, 32), 7)
    j_out, j_last, j_S = jax.jit(jr.time_mix_step, static_argnums=1)(
        jp["tmix"], RWKV_CFG, jnp.asarray(x), jnp.asarray(last),
        jnp.asarray(S))
    t_out, t_last, t_S = tr.time_mix_step(
        tp["tmix"], tcfg, torch.from_numpy(x), torch.from_numpy(last),
        torch.from_numpy(S))
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=2e-5)
    np.testing.assert_allclose(_np(t_S), _np(j_S), atol=2e-5)
    np.testing.assert_allclose(_np(t_last), _np(j_last), atol=0)
    j_out, j_last = jr.channel_mix_step(jp["cmix"], RWKV_CFG,
                                        jnp.asarray(x), jnp.asarray(last))
    t_out, t_last = tr.channel_mix_step(tp["cmix"], tcfg,
                                        torch.from_numpy(x),
                                        torch.from_numpy(last))
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=2e-5)
    np.testing.assert_allclose(_np(t_last), _np(j_last), atol=0)


def test_time_mix_chunked_equals_step_and_hard_decay_is_finite():
    """The port's own invariants, as tests/test_moe_rwkv_griffin.py:65 and
    :93 state them for the reference."""
    tcfg = to_torch_config(RWKV_CFG)
    _, tp = _mixers()
    x = torch.from_numpy(_randn((2, 32, 128), 8))
    out, (last, S_fin) = tr.time_mix(tp["tmix"], tcfg, x)
    S = torch.zeros((2, 4, 32, 32))
    lastx = torch.zeros((2, 128))
    outs = []
    for t in range(32):
        o, lastx, S = tr.time_mix_step(tp["tmix"], tcfg, x[:, t], lastx, S)
        outs.append(o)
    np.testing.assert_allclose(out.numpy(), torch.stack(outs, 1).numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(S_fin.numpy(), S.numpy(), atol=1e-4)
    hard = dict(tp["tmix"], decay_base=torch.full((128,), 2.0))
    for impl in ("cuda", "xla"):
        out, _ = tr.time_mix(hard, tcfg, 4 * x, wkv_impl=impl)
        assert bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="unknown wkv_impl"):
        tr.time_mix(tp["tmix"], tcfg, x, wkv_impl="pallas")
    with pytest.raises(ValueError, match="multiple of chunk"):
        tr.time_mix(tp["tmix"], tcfg, x[:, :30])


# -- configuration, forward and loss ----------------------------------------

def test_rwkv6_1p6b_config_matches_reference():
    for getter in ("get", "get_smoke"):
        j = getattr(jconfigs, getter)("rwkv6-1.6b")
        t = getattr(tconfigs, getter)("rwkv6-1.6b")
        assert to_torch_config(j) == t
        assert t.param_count() == j.param_count()
    full = tconfigs.get("rwkv6-1.6b")
    assert (full.num_layers, full.d_model, full.d_model // full.rwkv_head_dim,
            full.d_ff, full.vocab_size, full.rwkv_lora_rank,
            full.wkv_chunk) == (24, 2048, 32, 7168, 65536, 32, 16)
    assert tm.layer_kinds(full) == ("rwkv",) * 24


@functools.lru_cache(maxsize=None)
def _model(jcfg, seed=0):
    jp = jax.jit(jm.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(seed))
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")


CONFIGS = {
    "rwkv-f32": (lambda: JConfig(**RWKV_F32), 2e-5, 1e-5),
    "rwkv6-1.6b-smoke": (lambda: jconfigs.get_smoke("rwkv6-1.6b"), 6e-2,
                         1e-2),
}


def _tokens(B, S, V, seed=1):
    t = np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t).long()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_and_loss_match(name):
    make, tol_h, tol_loss = CONFIGS[name]
    jcfg = make()
    tcfg = to_torch_config(jcfg)
    jp, tp = _model(jcfg)
    assert tp["blocks"][0]["tmix"]["wr"].shape == (2, 64, 64)
    B, S = 2, 32
    jt, tt = _tokens(B, S, jcfg.vocab_size)
    jlab, tlab = _tokens(B, S, jcfg.vocab_size, seed=2)
    jh, _ = jax.jit(lambda p, t: jm.forward(p, jcfg, tokens=t))(jp, jt)
    for impl in ("cuda", "xla"):
        th, taux = tm.forward(tp, tcfg, tokens=tt, wkv_impl=impl)
        assert th.dtype == tcfg.compute_dtype and th.shape == (B, S, 64)
        np.testing.assert_allclose(_np(th), _np(jh), atol=tol_h,
                                   err_msg=impl)
        assert float(taux) == 0.0
    jloss, jmet = jax.jit(lambda p, b: jm.loss_fn(p, jcfg, b))(
        jp, {"tokens": jt, "labels": jlab})
    for impl in ("cuda", "xla"):
        tloss, tmet = tm.loss_fn(tp, tcfg, {"tokens": tt, "labels": tlab},
                                 wkv_impl=impl)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=tol_loss)
        np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]),
                                   rtol=tol_loss)


# -- serving -----------------------------------------------------------------

B, S, SMAX = 2, 12, 20


@pytest.mark.parametrize("wkv_impl", ["cuda", "xla"])
def test_prefill_and_decode_match_jax_and_forward(wkv_impl):
    """tests/test_decode_parity.py's rwkv row (four layers), against the
    JAX package's serving path and against the port's own forward."""
    jcfg = JConfig(**dict(RWKV_F32, num_layers=4))
    tcfg = to_torch_config(jcfg)
    jp, tp = _model(jcfg)
    tok = np.random.default_rng(3).integers(0, 128, (B, S + 4)).astype(
        np.int32)
    h, _ = tm.forward(tp, tcfg, tokens=torch.from_numpy(tok).long(),
                      wkv_impl=wkv_impl)
    full = h.float() @ tp["lm_head"].float()
    jlg, jc = jax.jit(lambda p, t: jd.prefill(
        p, jcfg, tokens=t, s_max=SMAX, cache_dtype=jnp.float32))(
        jp, jnp.asarray(tok[:, :S]))
    tlg, tc = td.prefill(tp, tcfg, tokens=torch.from_numpy(tok[:, :S]).long(),
                         s_max=SMAX, wkv_impl=wkv_impl)
    assert sorted(tc[0]) == ["S", "cmix_x", "tmix_x"]
    assert all(c.dtype == torch.float32 for c in tc[0].values())
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=2e-4)
    np.testing.assert_allclose(tlg.numpy(), full[:, S - 1].numpy(),
                               atol=2e-4)
    for key in tc[0]:
        np.testing.assert_allclose(tc[0][key].numpy(),
                                   np.asarray(jc[0][key]), atol=2e-4,
                                   err_msg=key)
    j_step = jax.jit(lambda p, c, t, pos: jd.decode_step(
        p, jcfg, c, tokens=t, pos=pos))
    for t in range(S, S + 4):
        jlg, jc = j_step(jp, jc, jnp.asarray(tok[:, t]), jnp.asarray(t))
        tlg, tc = td.decode_step(tp, tcfg, tc,
                                 tokens=torch.from_numpy(tok[:, t]).long(),
                                 pos=t)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=2e-4)
        np.testing.assert_allclose(tlg.numpy(), full[:, t].numpy(),
                                   atol=2e-4)
    for key in tc[0]:
        np.testing.assert_allclose(tc[0][key].numpy(),
                                   np.asarray(jc[0][key]), atol=2e-4,
                                   err_msg=key)
