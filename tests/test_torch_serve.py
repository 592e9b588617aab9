"""Port parity: the serving path (``prefill`` then ``decode_step``) against
the JAX package on the same weights and tokens, and the port's own
serving-against-forward invariant, as ``tests/test_decode_parity.py``
states it: 2e-4 with f32 caches (an f32-compute config, so only summation
order differs), 5e-2 with bf16 caches (k/v rounded to bf16).
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

# tests/test_decode_parity.py:13-30, the two dense-family rows and the rwkv
# row; and the rwkv6-1.6b smoke config in f32
COMMON = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
              vocab_size=128, compute_dtype=jnp.float32)
CFGS = {
    "dense": JConfig(name="dense", family="dense", qk_norm=True, **COMMON),
    "vlm": JConfig(name="vlm", family="dense", mrope=True,
                   mrope_sections=(2, 3, 3), **COMMON),
    "rwkv": JConfig(name="rwkv", family="rwkv6", rwkv_head_dim=16,
                    rwkv_lora_rank=4, wkv_chunk=4, **COMMON),
    "rwkv6-1.6b-smoke": dataclasses.replace(
        jconfigs.get_smoke("rwkv6-1.6b"), compute_dtype=jnp.float32),
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


def _positions(cfg, n, lib):
    if not cfg.mrope:
        return {}
    if lib is jnp:
        return {"positions": jnp.broadcast_to(
            jnp.arange(n, dtype=jnp.int32), (3, B, n))}
    return {"positions": torch.arange(n).expand(3, B, n)}


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
    assert sorted(tc[0]) == sorted(jc[0])
    for key in tc[0]:
        np.testing.assert_allclose(tc[0][key].numpy(), np.asarray(jc[0][key]),
                                   atol=2e-4, err_msg=key)
    j_step = jax.jit(lambda p, c, t, pos: jd.decode_step(
        p, jcfg, c, tokens=t, pos=pos))
    step = make_serve_step(tcfg)
    for t in range(S, S + 4):
        jlg, jc = j_step(jp, jc, jnp.asarray(tok[:, t]), jnp.asarray(t))
        tlg, tc = step(tp, tc, torch.from_numpy(tok[:, t]).long(), t)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=2e-4)
    for key in tc[0]:
        np.testing.assert_allclose(tc[0][key].numpy(), np.asarray(jc[0][key]),
                                   atol=2e-4, err_msg=key)


def _forward_logits(tp, tcfg, tok, n):
    h, _ = tm.forward(tp, tcfg, tokens=torch.from_numpy(tok[:, :n]).long(),
                      **_positions(tcfg, n, torch))
    return h.float() @ tp["lm_head"].float()


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
