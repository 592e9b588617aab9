"""Port parity: the LM configs, layers, ``forward`` and ``loss_fn`` against
the JAX package on the same weights (carried by ``convert.lm_params``) and
the same numpy inputs.

Every architecture's config field for field; the layers on an f32-compute
dense ``qk_norm`` config (the dense row of ``tests/test_decode_parity.py``,
two layers), where the bound is tight (2e-5 on O(1) activations: summation
order only); ``forward`` / ``loss_fn`` on every smoke config in f32
compute (the same tight bound) and as published in bf16, which torch's CPU
matmul rounds at other places than XLA's (6e-2 on unit-RMS hidden states,
a few bf16 roundings of O(1) values; 1e-2 relative on the loss).
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


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_matches_reference(arch):
    """Every architecture: ``get`` and ``get_smoke`` equal the reference's
    configs field for field (dtypes mapped), dashed names included."""
    name = {v: k for k, v in jconfigs.ALIASES.items()}[arch]
    assert tconfigs.ALIASES == jconfigs.ALIASES
    for getter in ("get", "get_smoke"):
        for key in (arch, name):
            j = getattr(jconfigs, getter)(key)
            t = getattr(tconfigs, getter)(key)
            assert to_torch_config(j) == t, (getter, key)
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()


def test_unknown_arch_raises_key_error():
    for getter in (tconfigs.get, tconfigs.get_smoke):
        with pytest.raises(KeyError, match="unknown arch"):
            getter("gpt-2")
    with pytest.raises(ValueError):
        tm.layer_kinds(dataclasses.replace(tconfigs.get_smoke("qwen3-8b"),
                                           family="mamba"))


def test_full_configs_match_nameplate_param_counts():
    """tests/test_models_smoke.py:82-98 on the port's configs."""
    expect = {
        "arctic-480b": (430e9, 530e9),
        "olmoe-1b-7b": (6e9, 8e9),
        "rwkv6-1.6b": (1.3e9, 1.9e9),
        "qwen3-14b": (13e9, 16e9),
        "command-r-35b": (30e9, 38e9),
        "phi3-medium-14b": (13e9, 16e9),
        "qwen3-8b": (7e9, 9e9),
        "seamless-m4t-large-v2": (1.5e9, 2.6e9),
        "qwen2-vl-72b": (68e9, 78e9),
        "recurrentgemma-9b": (8.5e9, 11e9),
    }
    for arch, (lo, hi) in expect.items():
        n = tconfigs.get(arch).param_count()
        assert lo <= n <= hi, (arch, n)


def test_moe_active_params():
    """tests/test_models_smoke.py:101-105 on the port's configs."""
    arctic = tconfigs.get("arctic-480b")
    assert arctic.active_param_count() < 0.05 * arctic.param_count()
    olmoe = tconfigs.get("olmoe-1b-7b")
    assert 0.1 < olmoe.active_param_count() / olmoe.param_count() < 0.3


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_init_params_tree_matches_reference(arch):
    """The port's own ``init_params`` tree of each smoke config has the
    reference's keys, segments, shapes and dtypes, and
    ``convert.lm_params`` carries the reference's tree leaf for leaf."""
    jcfg = jconfigs.get_smoke(arch)
    jp, tp = _pair_params(jcfg)
    own = tm.init_params(to_torch_config(jcfg),
                         torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    n = 0
    for path, leaf in jleaves:
        t, o = tp, own
        for key in path:
            k = key.key if hasattr(key, "key") else key.idx
            t, o = t[k], o[k]
        assert tuple(t.shape) == leaf.shape == tuple(o.shape), path
        assert t.dtype == TDTYPE[leaf.dtype] == o.dtype, path
        n += 1
    sizes = []
    tm.tree_map(lambda a: sizes.append(a.numel()), own)
    assert len(sizes) == n
    assert sum(sizes) == sum(leaf.size for _, leaf in jleaves)
    assert len(own["blocks"]) == len(tm.segment_structure(
        tm.layer_kinds(to_torch_config(jcfg))))
    assert ("enc_blocks" in own) == bool(jcfg.encoder_layers)


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


def _batch(cfg, B, S, seed=1):
    """Tokens and labels, plus stub frames for an encoder-decoder and
    three distinct M-RoPE streams (a t x h x w grid of 4 x 2 x 4) for the
    VLM: the same numpy arrays for both packages."""
    rng = np.random.default_rng(seed)
    arrs = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.encoder_layers:
        arrs["enc_embeds"] = 0.02 * rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        i = np.arange(S)
        arrs["positions"] = np.broadcast_to(
            np.stack([i // 8, i % 8 // 4 + i // 8, i % 4 + i // 8])[:, None],
            (3, B, S))
    jb = {k: jnp.asarray(v.astype(np.float32 if v.dtype.kind == "f"
                                  else np.int32)) for k, v in arrs.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)).float()
          if v.dtype.kind == "f" else torch.from_numpy(
              np.ascontiguousarray(v)).long() for k, v in arrs.items()}
    return jb, tb


def _smoke(arch, cdt):
    return dataclasses.replace(jconfigs.get_smoke(arch), compute_dtype=cdt)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_smoke_forward_and_loss_match_f32(arch):
    """Every family's smoke config in f32 compute, both attention paths,
    against the reference: 2e-5 on O(1) hidden states (summation order;
    MoE routing agrees, so the same experts run), 1e-5 on the loss and
    the router aux loss."""
    jcfg = _smoke(arch, jnp.float32)
    tcfg = to_torch_config(jcfg)
    jp, tp = _pair_params(jcfg)
    jb, tb = _batch(jcfg, 2, 32)
    fw = lambda b: {k: v for k, v in b.items() if k != "labels"}
    jh, jaux = jax.jit(functools.partial(jm.forward, cfg=jcfg))(jp, **fw(jb))
    for impl in ("cuda", "xla"):
        th, taux = tm.forward(tp, tcfg, attn_impl=impl, **fw(tb))
        assert th.shape == (2, 32, tcfg.d_model)
        np.testing.assert_allclose(_np(th), _np(jh), atol=2e-5, err_msg=impl)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                                   atol=1e-7)
    assert (float(jaux) > 0) == (jcfg.family == "moe")
    jloss, _ = jm.loss_fn(jp, jcfg, jb)
    tloss, tmet = tm.loss_fn(tp, tcfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_smoke_forward_and_loss_match_bf16(arch):
    """The smoke configs as published (bf16 compute) against the
    reference: 6e-2 on unit-RMS hidden states (a few bf16 roundings that
    torch's CPU matmul takes at other places than XLA's), 1e-2 relative on
    the loss. MoE configs are held on the loss and the aux loss only: a
    bf16 rounding upstream can move a token's k-th router probability past
    its (k+1)-th and send it to another expert, an O(1) change of that
    token's output (the f32 test holds their hidden states)."""
    jcfg = jconfigs.get_smoke(arch)
    tcfg = to_torch_config(jcfg)
    jp, tp = _pair_params(jcfg)
    jb, tb = _batch(jcfg, 2, 32)
    fw = lambda b: {k: v for k, v in b.items() if k != "labels"}
    jh, jaux = jax.jit(functools.partial(jm.forward, cfg=jcfg))(jp, **fw(jb))
    th, taux = tm.forward(tp, tcfg, **fw(tb))
    assert th.dtype == torch.bfloat16 and bool(torch.isfinite(th).all())
    if jcfg.family == "moe":
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-2)
    else:
        np.testing.assert_allclose(_np(th), _np(jh), atol=6e-2)
    jloss, _ = jm.loss_fn(jp, jcfg, jb)
    tloss, _ = tm.loss_fn(tp, tcfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-2)


def test_encoder_runs_full_attention_through_flash_path():
    """The encoder and the cross attention (Sq != Skv) take K4's plain
    version under attn_impl='cuda' on the CPU and agree with the chunked
    path; a decoder-only config ignores no encoder (none is built)."""
    jcfg = _smoke("seamless-m4t-large-v2", jnp.float32)
    tcfg = to_torch_config(jcfg)
    _, tp = _pair_params(jcfg)
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(0, 256, (2, 12))).long()
    enc = torch.from_numpy(rng.standard_normal((2, 20, 64)).astype(
        np.float32))
    out = tm.encode(tp, tcfg, enc)
    assert out.shape == (2, 20, 64)
    assert tm.encode(tp, tcfg, enc, attn_impl="xla").shape == out.shape
    h1, _ = tm.forward(tp, tcfg, tokens=tok, enc_embeds=enc)
    h2, _ = tm.forward(tp, tcfg, tokens=tok, enc_embeds=enc, attn_impl="xla")
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="enc_embeds"):
        tm.forward(tp, tcfg, tokens=tok)
    assert tm.encode({}, to_torch_config(JConfig(**DENSE_F32)), None) is None


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
