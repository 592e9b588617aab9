"""Port parity: the serving path (``prefill`` then ``decode_step``) against
the JAX package on the same weights and tokens, and the port's own
serving-against-forward invariant, as ``tests/test_decode_parity.py``
states it for every family: 2e-4 with f32 caches (an f32-compute config,
so only summation order differs), 5e-2 with bf16 caches (k/v rounded to
bf16). The ``serve`` CLI on the CPU for every family's smoke config.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import decode as jd
from repro.models import model as jm
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import decode as td
from repro_torch.models import model as tm
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.runtime.steps import make_serve_step

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

# tests/test_decode_parity.py:13-30, every row; and the rwkv6-1.6b,
# olmoe-1b-7b and recurrentgemma-9b smoke configs in f32 (olmoe at the
# rows' capacity factor 8: decode's T = B tokens get C = round(2 * 4 / 8 *
# 1.25) = 1 slot an expert and drop pairs that forward keeps)
COMMON = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
              vocab_size=128, compute_dtype=jnp.float32)
GRIF = dict(lru_width=64, window_size=8)
CFGS = {
    "dense": JConfig(name="dense", family="dense", qk_norm=True, **COMMON),
    "moe": JConfig(name="moe", family="moe", num_experts=4,
                   experts_per_token=2, capacity_factor=8.0, **COMMON),
    "grif": JConfig(name="grif", family="griffin",
                    pattern=("rec", "rec", "attn_local"), **GRIF, **COMMON),
    "encdec": JConfig(name="encdec", family="encdec", encoder_layers=2,
                      **COMMON),
    "vlm": JConfig(name="vlm", family="dense", mrope=True,
                   mrope_sections=(2, 3, 3), **COMMON),
    "rwkv": JConfig(name="rwkv", family="rwkv6", rwkv_head_dim=16,
                    rwkv_lora_rank=4, wkv_chunk=4, **COMMON),
    "rwkv6-1.6b-smoke": dataclasses.replace(
        jconfigs.get_smoke("rwkv6-1.6b"), compute_dtype=jnp.float32),
    "olmoe-1b-7b-smoke": dataclasses.replace(
        jconfigs.get_smoke("olmoe-1b-7b"), compute_dtype=jnp.float32,
        capacity_factor=8.0),
    "recurrentgemma-9b-smoke": dataclasses.replace(
        jconfigs.get_smoke("recurrentgemma-9b"), compute_dtype=jnp.float32),
}
B, S, SMAX = 2, 12, 20


def to_torch_config(jcfg):
    """The port's ModelConfig with the same fields as a JAX one."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["param_dtype"] = torch.float32
    kw["compute_dtype"] = torch.float32
    return TConfig(**kw)


@functools.lru_cache(maxsize=None)
def _setup(name):
    jcfg = CFGS[name]
    jp = jax.jit(jm.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    tok = np.random.default_rng(1).integers(0, 128, (B, S + 4)).astype(
        np.int32)
    return jcfg, to_torch_config(jcfg), jp, tp, tok


ENC = np.random.default_rng(2).standard_normal((B, 8, 64)).astype(np.float32)


def _positions(cfg, n, lib):
    """The extra inputs of a family: text positions as three equal M-RoPE
    streams for the VLM, stub frames (B, 8, d) for the encoder-decoder."""
    kw = {}
    if cfg.mrope:
        kw["positions"] = jnp.broadcast_to(
            jnp.arange(n, dtype=jnp.int32), (3, B, n)) if lib is jnp \
            else torch.arange(n).expand(3, B, n)
    if cfg.encoder_layers:
        kw["enc_embeds"] = jnp.asarray(ENC) if lib is jnp \
            else torch.from_numpy(ENC)
    return kw


@pytest.mark.parametrize("name", sorted(CFGS))
def test_prefill_and_decode_match_jax(name):
    jcfg, tcfg, jp, tp, tok = _setup(name)
    jlg, jc = jax.jit(lambda p, t: jd.prefill(
        p, jcfg, tokens=t, s_max=SMAX, cache_dtype=jnp.float32,
        **_positions(jcfg, S, jnp)))(jp, jnp.asarray(tok[:, :S]))
    tlg, tc = td.prefill(tp, tcfg, tokens=torch.from_numpy(tok[:, :S]).long(),
                         s_max=SMAX, cache_dtype=torch.float32,
                         **_positions(tcfg, S, torch))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=2e-4)
    _caches_match(tc, jc)
    j_step = jax.jit(lambda p, c, t, pos: jd.decode_step(
        p, jcfg, c, tokens=t, pos=pos))
    step = make_serve_step(tcfg)
    for t in range(S, S + 4):
        jlg, jc = j_step(jp, jc, jnp.asarray(tok[:, t]), jnp.asarray(t))
        tlg, tc = step(tp, tc, torch.from_numpy(tok[:, t]).long(), t)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=2e-4)
    _caches_match(tc, jc)


def _caches_match(tc, jc):
    """Every segment's cache: the same keys, shapes and values."""
    assert len(tc) == len(jc)
    for seg, (t, j) in enumerate(zip(tc, jc)):
        assert sorted(t) == sorted(j), seg
        for key in t:
            assert tuple(t[key].shape) == j[key].shape, (seg, key)
            np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]),
                                       atol=2e-4, err_msg=f"{seg} {key}")


def _forward_logits(tp, tcfg, tok, n):
    h, _ = tm.forward(tp, tcfg, tokens=torch.from_numpy(tok[:, :n]).long(),
                      **_positions(tcfg, n, torch))
    return h.float() @ tp["lm_head"].float()


@pytest.mark.parametrize("impl", ["xla", "jax"])
def test_local_attn_ring_buffer_wraps(impl):
    """Decode past the window must equal a fresh forward (ring reuse):
    tests/test_decode_parity.py:79-98 against the port's own forward
    ("xla": its chunked path) and against the reference's decode steps."""
    jcfg = JConfig(name="g", family="griffin", pattern=("attn_local",),
                   lru_width=64, window_size=6, **COMMON)
    tcfg = to_torch_config(jcfg)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(3))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    n = 16   # > 2x window
    tok = np.random.default_rng(4).integers(0, 128, (1, n)).astype(np.int32)
    full = _forward_logits(tp, tcfg, tok, n)
    caches = td.init_caches(tcfg, 1, s_max=n, dtype=torch.float32,
                            device="cpu")
    assert caches[0]["k"].shape == (4, 1, 6, 2, 16)
    if impl == "jax":
        jc = jd.init_caches(jcfg, 1, s_max=n, dtype=jnp.float32)
    errs = []
    for t in range(n):
        lg, caches = td.decode_step(tp, tcfg, caches,
                                    tokens=torch.from_numpy(tok[:, t]).long(),
                                    pos=t)
        if impl == "jax":
            want, jc = jd.decode_step(jp, jcfg, jc, tokens=jnp.asarray(
                tok[:, t]), pos=jnp.asarray(t))
            errs.append(float(np.abs(lg.numpy() - np.asarray(want)).max()))
        else:
            errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, errs
    if impl == "jax":
        _caches_match(caches, jc)


def test_local_attn_prefill_fills_the_ring():
    """A prompt longer than the window leaves the keys of its last W
    positions p in ring slots p mod W, as the reference's prefill lays
    them (one attn_local layer, whose input is the embedding)."""
    from repro_torch.models.layers import _project_qkv, rmsnorm
    jcfg = JConfig(name="g", family="griffin", pattern=("attn_local",),
                   lru_width=64, window_size=6, **dict(COMMON, num_layers=1))
    tcfg = to_torch_config(jcfg)
    tp = tm.init_params(tcfg, torch.Generator().manual_seed(5))
    n, W = 14, 6
    tok = torch.from_numpy(np.random.default_rng(6).integers(0, 128, (B, n)))
    _, caches = td.prefill(tp, tcfg, tokens=tok, s_max=n + 2,
                           cache_dtype=torch.float32)
    lp = tm.tree_map(lambda a: a[0], tp["blocks"][0])
    x = rmsnorm(tm.embed_tokens(tp, tcfg, tok), lp["ln1"], tcfg.norm_eps)
    _, k, _ = _project_qkv(lp["attn"], tcfg, x,
                           torch.arange(n).expand(B, n))
    ring = caches[0]["k"][0]
    assert ring.shape == (B, W, 2, 16)
    for p in range(n - W, n):
        torch.testing.assert_close(ring[:, p % W], k[:, p], rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_prefill_decode_matches_forward(name):
    """The port's own invariant: serving continues exactly where the full
    forward (through K4's or K5's plain version here) would."""
    _, tcfg, _, tp, tok = _setup(name)
    full = _forward_logits(tp, tcfg, tok, S + 4)
    lg, caches = td.prefill(tp, tcfg,
                            tokens=torch.from_numpy(tok[:, :S]).long(),
                            s_max=SMAX, cache_dtype=torch.float32,
                            **_positions(tcfg, S, torch))
    errs = [float((lg - full[:, S - 1]).abs().max())]
    for t in range(S, S + 4):
        lg, caches = td.decode_step(tp, tcfg, caches,
                                    tokens=torch.from_numpy(tok[:, t]).long(),
                                    pos=t)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, errs


def test_bf16_cache_drift_bounded():
    _, tcfg, _, tp, tok = _setup("dense")
    full = _forward_logits(tp, tcfg, tok, S + 2)
    lg, caches = td.prefill(tp, tcfg,
                            tokens=torch.from_numpy(tok[:, :S]).long(),
                            s_max=S + 2)
    assert caches[0]["k"].dtype == torch.bfloat16
    lg, caches = td.decode_step(tp, tcfg, caches,
                                tokens=torch.from_numpy(tok[:, S]).long(),
                                pos=S)
    assert float((lg - full[:, S]).abs().max()) < 5e-2


def test_serve_main_returns_generated_tokens(capsys):
    gen = tserve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert gen.shape == (2, 4) and gen.dtype == torch.long
    assert int(gen.min()) >= 0 and int(gen.max()) < 256
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "tok/s" in out and "ms/step" in out
    again = tserve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "16", "--gen", "4",
                         "--temperature", "0.8", "--seed", "1"])
    assert again.shape == (2, 4)
    assert torch.equal(again, tserve.main([
        "--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--batch", "2",
        "--prompt-len", "16", "--gen", "4", "--temperature", "0.8",
        "--seed", "1"]))


def test_serve_main_runs_rwkv6(capsys):
    gen = tserve.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert gen.shape == (2, 4) and gen.dtype == torch.long
    assert int(gen.min()) >= 0 and int(gen.max()) < 256
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "tok/s" in out and "ms/step" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2", "qwen2-vl-72b",
                                  "arctic-480b"])
def test_serve_main_runs_every_family(capsys, arch):
    """The CLI for the other families' smoke configs: MoE, griffin past
    its window (8), the encoder-decoder with stub frames, the M-RoPE VLM,
    MoE with a dense residual at head dim 8."""
    gen = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert gen.shape == (2, 4) and gen.dtype == torch.long
    assert int(gen.min()) >= 0 and int(gen.max()) < 256
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "tok/s" in out and "ms/step" in out


def test_serve_main_is_seeded_for_every_family():
    """The same seed gives the same tokens (weights, prompt, stub frames)."""
    argv = ["--arch", "seamless-m4t-large-v2", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "3", "--seed", "2"]
    assert torch.equal(tserve.main(argv), tserve.main(argv))


def test_cross_attention_q_norm_follows_reference():
    """The reference's forward normalises the cross attention's q
    (``qk_norm``), its prefill and decode step do not; the port mirrors
    all three, so with ``qk_norm`` an encoder-decoder serves apart from its
    forward in both packages, by the same amount (ROADMAP section 3)."""
    jcfg = JConfig(name="e", family="encdec", encoder_layers=2, qk_norm=True,
                   **dict(COMMON, num_layers=2))
    tcfg = to_torch_config(jcfg)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    tok = np.random.default_rng(1).integers(0, 128, (B, S)).astype(np.int32)
    jh, _ = jm.forward(jp, jcfg, tokens=jnp.asarray(tok),
                       enc_embeds=jnp.asarray(ENC))
    jlg, _ = jd.prefill(jp, jcfg, tokens=jnp.asarray(tok),
                        enc_embeds=jnp.asarray(ENC), s_max=S,
                        cache_dtype=jnp.float32)
    th, _ = tm.forward(tp, tcfg, tokens=torch.from_numpy(tok).long(),
                       enc_embeds=torch.from_numpy(ENC))
    tlg, _ = td.prefill(tp, tcfg, tokens=torch.from_numpy(tok).long(),
                        enc_embeds=torch.from_numpy(ENC), s_max=S,
                        cache_dtype=torch.float32)
    jgap = np.asarray(jlg) - np.asarray(jh[:, -1] @ jp["lm_head"])
    tgap = tlg.numpy() - (th[:, -1] @ tp["lm_head"]).numpy()
    assert np.abs(jgap).max() > 1e-2          # the gap is real
    np.testing.assert_allclose(tgap, jgap, atol=2e-4)
