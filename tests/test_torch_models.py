"""Port parity: the dense LM layers, ``forward`` and ``loss_fn`` against the
JAX package on the same weights (carried by ``convert.lm_params``) and the
same numpy inputs.

Two configurations: an f32-compute dense ``qk_norm`` config (the dense row
of ``tests/test_decode_parity.py``, two layers), where the bound is tight
(2e-5 on O(1) activations: summation order only), and the qwen3-8b smoke
config, whose bf16 compute rounds at other places in torch's CPU matmul
than in XLA's, with a bf16 bound (6e-2 on unit-RMS hidden states, a few
bf16 roundings of O(1) values; 1e-2 relative on the loss).
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
from repro.models import layers as jl
from repro.models import model as jm
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models.config import ModelConfig as TConfig

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TDTYPE = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}

DENSE_F32 = dict(name="dense", family="dense", num_layers=2, d_model=64,
                 num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                 compute_dtype=jnp.float32, qk_norm=True)


def to_torch_config(jcfg):
    """The port's ModelConfig with the same fields as a JAX one."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["param_dtype"] = TDTYPE[jnp.dtype(jcfg.param_dtype)]
    kw["compute_dtype"] = TDTYPE[jnp.dtype(jcfg.compute_dtype)]
    return TConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg, seed):
    return jax.jit(jm.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))


def _pair_params(jcfg, seed=0):
    jp = _jax_params(jcfg, seed)
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(B, S, V, seed=1):
    t = np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t).long()


# -- configuration and conversion ------------------------------------------

def test_qwen3_8b_config_matches_reference():
    for getter in ("get", "get_smoke"):
        j = getattr(jconfigs, getter)("qwen3-8b")
        t = getattr(tconfigs, getter)("qwen3-8b")
        assert to_torch_config(j) == t
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    full = tconfigs.get("qwen3-8b")
    assert (full.kv_heads_eff, full.head_dim, full.num_layers) == (16, 128,
                                                                    36)


@pytest.mark.parametrize("family,extra", [
    ("moe", dict(num_experts=4, experts_per_token=2)),
    ("rwkv6", {}), ("griffin", dict(pattern=("rec", "rec", "attn"))),
    ("encdec", dict(encoder_layers=2))])
def test_param_count_of_every_family_matches(family, extra):
    kw = dict(DENSE_F32, family=family, **extra)
    j = JConfig(**kw)
    t = to_torch_config(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_unported_archs_and_kinds_raise():
    with pytest.raises(NotImplementedError, match="item 11"):
        tconfigs.get("recurrentgemma-9b")
    with pytest.raises(NotImplementedError, match="item 11"):
        tconfigs.get_smoke("olmoe-1b-7b")
    with pytest.raises(KeyError):
        tconfigs.get("gpt-2")
    cfg = to_torch_config(JConfig(**dict(DENSE_F32, family="moe",
                                         num_experts=4)))
    with pytest.raises(NotImplementedError, match="item 11"):
        tm.init_params(cfg, torch.Generator().manual_seed(0))
    grif = to_torch_config(JConfig(**dict(DENSE_F32, family="griffin",
                                          pattern=("rec", "attn"))))
    with pytest.raises(NotImplementedError, match="layer kind 'rec'"):
        tm.init_params(grif, torch.Generator().manual_seed(0))


def test_lm_params_keeps_tree_shapes_and_dtypes():
    jcfg = jconfigs.get_smoke("qwen3-8b")
    jp, tp = _pair_params(jcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    own = tm.init_params(to_torch_config(jcfg),
                         torch.Generator().manual_seed(0))
    for path, leaf in jleaves:
        t, o = tp, own
        for key in path:
            k = key.key if hasattr(key, "key") else key.idx
            t, o = t[k], o[k]
        assert tuple(t.shape) == leaf.shape == tuple(o.shape)
        assert t.dtype == TDTYPE[leaf.dtype] == o.dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert len(tp["blocks"]) == 1 and tp["blocks"][0]["ln1"].shape == (2, 64)
    bf = convert.lm_params({"w": np.asarray(jnp.ones((3,), jnp.bfloat16))},
                           device="cpu")
    assert bf["w"].dtype == torch.bfloat16


# -- layers -----------------------------------------------------------------

def test_rmsnorm_matches():
    x, w = _randn((2, 5, 64), 0), 0.1 * _randn((64,), 1)
    want = jl.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("mrope", [False, True])
def test_apply_rope_matches(mrope):
    B, S, H, hd = 2, 12, 3, 16
    x = _randn((B, S, H, hd), 2)
    rng = np.random.default_rng(3)
    shape = (3, B, S) if mrope else (B, S)
    pos = rng.integers(0, 64, shape).astype(np.int32)
    sections = (2, 3, 3) if mrope else None
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, sections)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                        1e4, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    if mrope:   # identical t/h/w streams reduce M-RoPE to 1-D RoPE
        same = torch.from_numpy(pos[0]).long()
        np.testing.assert_allclose(
            tl.apply_rope(torch.from_numpy(x), same.expand(3, B, S), 1e4,
                          sections).numpy(),
            tl.apply_rope(torch.from_numpy(x), same, 1e4).numpy(), atol=0)


def test_mlp_matches():
    jcfg = JConfig(**DENSE_F32)
    jp, tp = _pair_params(jcfg)
    x = _randn((2, 7, 64), 4)
    jmlp = jax.tree.map(lambda a: a[0], jp["blocks"][0]["mlp"])
    tmlp = {k: v[0] for k, v in tp["blocks"][0]["mlp"].items()}
    want = jax.jit(jl.mlp, static_argnums=2)(jmlp, jnp.asarray(x),
                                             jnp.float32)
    got = tl.mlp(tmlp, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _layer_attn(jp, tp):
    ja = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])
    ta = {k: v[0] for k, v in tp["blocks"][0]["attn"].items()}
    return ja, ta


@pytest.mark.parametrize("window", [0, 5])
def test_attention_matches_both_impls(window):
    jcfg = JConfig(**DENSE_F32)
    tcfg = to_torch_config(jcfg)
    ja, ta = _layer_attn(*_pair_params(jcfg))
    B, S = 2, 24
    x = 0.5 * _randn((B, S, 64), 5)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    j_attention = jax.jit(jl.attention, static_argnums=1,
                          static_argnames="window")
    want = _np(j_attention(ja, jcfg, jnp.asarray(x), jnp.asarray(pos),
                           window=window))
    for impl in ("cuda", "xla"):
        got = tl.attention(ta, tcfg, torch.from_numpy(x),
                           torch.from_numpy(pos.copy()).long(),
                           window=window, attn_impl=impl)
        np.testing.assert_allclose(_np(got), want, atol=2e-5, err_msg=impl)
    with pytest.raises(ValueError, match="'cuda'"):
        tl.attention(ta, tcfg, torch.from_numpy(x),
                     torch.from_numpy(pos.copy()).long(),
                     attn_impl="pallas")


def test_attention_decode_matches():
    jcfg = JConfig(**DENSE_F32)
    tcfg = to_torch_config(jcfg)
    ja, ta = _layer_attn(*_pair_params(jcfg))
    B, Smax, pos = 2, 10, 6
    x = _randn((B, 1, 64), 6)
    ck, cv = _randn((B, Smax, 2, 16), 7), _randn((B, Smax, 2, 16), 8)
    jo, jk, jv = jax.jit(jl.attention_decode, static_argnums=1)(ja, jcfg, jnp.asarray(x),
                                     jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(pos))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    to, tk2, tv2 = tl.attention_decode(ta, tcfg, torch.from_numpy(x), tk,
                                       tv, pos)
    np.testing.assert_allclose(_np(to), _np(jo), atol=2e-5)
    np.testing.assert_allclose(_np(tk2), _np(jk), atol=2e-6)
    np.testing.assert_allclose(_np(tv2), _np(jv), atol=2e-6)
    assert tk2 is tk       # written in place


# -- forward and loss --------------------------------------------------------

CONFIGS = {
    "dense-f32": (lambda: JConfig(**DENSE_F32), 2e-5, 1e-5),
    "qwen3-8b-smoke": (lambda: jconfigs.get_smoke("qwen3-8b"), 6e-2, 1e-2),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_and_loss_match(name):
    make, tol_h, tol_loss = CONFIGS[name]
    jcfg = make()
    tcfg = to_torch_config(jcfg)
    jp, tp = _pair_params(jcfg)
    B, S = 2, 32
    jt, tt = _tokens(B, S, jcfg.vocab_size)
    jlab, tlab = _tokens(B, S, jcfg.vocab_size, seed=2)
    jh, jaux = jm.forward(jp, jcfg, tokens=jt)
    for impl in ("cuda", "xla"):
        th, taux = tm.forward(tp, tcfg, tokens=tt, attn_impl=impl)
        assert th.dtype == tcfg.compute_dtype and th.shape == (B, S, 64)
        np.testing.assert_allclose(_np(th), _np(jh), atol=tol_h, err_msg=impl)
        assert float(taux) == float(jaux) == 0.0
    jloss, jmet = jm.loss_fn(jp, jcfg, {"tokens": jt, "labels": jlab})
    tloss, tmet = tm.loss_fn(tp, tcfg, {"tokens": tt, "labels": tlab})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol_loss)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]),
                               rtol=tol_loss)


def test_forward_matches_jax_flash_kernel():
    """One JAX forward through its Pallas kernel (interpret mode) at
    S = 256, the kernel's block size, against the port's default path."""
    jcfg = JConfig(**DENSE_F32)
    tcfg = to_torch_config(jcfg)
    jp, tp = _pair_params(jcfg, seed=3)
    jt, tt = _tokens(1, 256, jcfg.vocab_size, seed=4)
    jh, _ = jm.forward(jp, jcfg, tokens=jt, attn_impl="pallas_interpret")
    th, _ = tm.forward(tp, tcfg, tokens=tt)
    np.testing.assert_allclose(_np(th), _np(jh), atol=2e-5)


def test_chunked_cross_entropy_matches_with_ragged_chunks():
    h = _randn((2, 48, 16), 9)
    head = 0.3 * _randn((16, 40), 10)
    lab = np.random.default_rng(11).integers(0, 40, (2, 48))
    for chunk in (16, 20):      # 20 does not divide 48: one chunk of 48
        want = jm.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(head),
                                        jnp.asarray(lab), chunk=chunk,
                                        dp_axes=None, vocab_axis=None)
        got = tm.chunked_cross_entropy(torch.from_numpy(h),
                                       torch.from_numpy(head),
                                       torch.from_numpy(lab), chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
