"""Serving path, attention and rwkv subset: prefill (build caches) +
single-token decode steps; port of ``repro/models/decode.py``.

Cache layouts (per homogeneous segment, leading L axis):
  attn : k,v (L,B,Smax,Hkv_eff,hd) — rotated keys cached
  rwkv : S (L,B,H,hd,hd), tmix_x/cmix_x (L,B,d), f32 — O(1) state

The kinds ``"attn"`` and ``"rwkv"`` are ported (ROADMAP section 1, item
11). Prefill runs attention layers through the chunked attention path, as
the reference does, not through the flash kernel; rwkv layers run
``time_mix`` with ``wkv_impl`` (the WKV kernel K5 by default), which also
returns the state the decode steps continue from. The caches are allocated
once per prefill and written in place by prefill and by every decode step.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.flash_attn.ops import chunked_attention
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _project_qkv, attention_decode, \
    mlp, rmsnorm
from repro_torch.models.model import (
    PORTED_KINDS,
    _unported,
    embed_tokens,
    layer_kinds,
    segment_structure,
    tree_map,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, kind: str, count: int, B: int, s_max: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, Tensor]:
    if kind not in PORTED_KINDS:
        raise _unported(f"the {kind!r} cache")
    if kind == "rwkv":
        H = cfg.d_model // cfg.rwkv_head_dim
        rhd = cfg.rwkv_head_dim
        f32 = dict(dtype=torch.float32, device=device)
        return {"S": torch.zeros((count, B, H, rhd, rhd), **f32),
                "tmix_x": torch.zeros((count, B, cfg.d_model), **f32),
                "cmix_x": torch.zeros((count, B, cfg.d_model), **f32)}
    shape = (count, B, s_max, cfg.kv_heads_eff, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_caches(cfg: ModelConfig, B: int, s_max: int, dtype=torch.bfloat16,
                device="cuda"):
    return [
        init_cache(cfg, kind, count, B, s_max, dtype, device)
        for kind, count in segment_structure(layer_kinds(cfg))
    ]


# ---------------------------------------------------------------------------
# Per-layer decode step
# ---------------------------------------------------------------------------

def _block_step(params, cfg: ModelConfig, kind: str, x: Tensor,
                cache: Dict[str, Tensor], pos) -> Tensor:
    """x: (B, 1, d) -> x'. cache holds ONE layer (no L axis) and is
    updated in place (the reference returns a new one)."""
    if kind not in PORTED_KINDS:
        raise _unported(f"layer kind {kind!r}")
    eps = cfg.norm_eps
    if kind == "rwkv":
        xt = rmsnorm(x[:, 0], params["ln1"], eps)
        h, last_t, S = rwkv_lib.time_mix_step(
            params["tmix"], cfg, xt, cache["tmix_x"], cache["S"])
        x = x + h[:, None]
        xc = rmsnorm(x[:, 0], params["ln2"], eps)
        h, last_c = rwkv_lib.channel_mix_step(params["cmix"], cfg, xc,
                                              cache["cmix_x"])
        _store(cache, S=S, tmix_x=last_t, cmix_x=last_c)
        return x + h[:, None]
    h, _, _ = attention_decode(params["attn"], cfg,
                               rmsnorm(x, params["ln1"], eps),
                               cache["k"], cache["v"], pos)
    x = x + h
    return x + mlp(params["mlp"], rmsnorm(x, params["ln2"], eps),
                   cfg.compute_dtype)


def _store(cache: Dict[str, Tensor], **new: Tensor):
    """Write a layer's new state into its cache views, in place."""
    for key, value in new.items():
        cache[key].copy_(value)


def _head(params):
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def decode_step(params, cfg: ModelConfig, caches, *, tokens: Tensor,
                pos) -> Tuple[Tensor, list]:
    """tokens: (B,) int; pos: int position. -> (logits (B,V), caches).
    The caches are updated in place and returned."""
    x = embed_tokens(params, cfg, tokens[:, None])
    seg_meta = segment_structure(layer_kinds(cfg))
    for (kind, count), stacked, cache in zip(seg_meta, params["blocks"],
                                             caches):
        for li in range(count):
            lp = tree_map(lambda a: a[li], stacked)
            lc = {key: c[li] for key, c in cache.items()}
            x = _block_step(lp, cfg, kind, x, lc, pos)
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = h[:, 0].float() @ _head(params).float()
    return logits, caches


# ---------------------------------------------------------------------------
# Prefill: forward that also fills the attention caches
# ---------------------------------------------------------------------------

def _block_prefill(params, cfg: ModelConfig, kind: str, x: Tensor,
                   positions, cache: Dict[str, Tensor],
                   wkv_impl: str = "cuda") -> Tensor:
    """Full-sequence block that also writes this layer's cache content
    into ``cache`` (ONE layer, no L axis)."""
    if kind not in PORTED_KINDS:
        raise _unported(f"layer kind {kind!r}")
    eps = cfg.norm_eps
    cdt = cfg.compute_dtype
    if kind == "rwkv":
        h, (last_t, S_final) = rwkv_lib.time_mix(
            params["tmix"], cfg, rmsnorm(x, params["ln1"], eps),
            wkv_impl=wkv_impl)
        x = x + h
        h, last_c = rwkv_lib.channel_mix(params["cmix"], cfg,
                                         rmsnorm(x, params["ln2"], eps))
        _store(cache, S=S_final, tmix_x=last_t, cmix_x=last_c)
        return x + h
    B, S, d = x.shape
    h_in = rmsnorm(x, params["ln1"], eps)
    q, k, v = _project_qkv(params["attn"], cfg, h_in, positions)
    o = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True,
                          unroll=cfg.unroll_inner)
    o = o.transpose(1, 2).reshape(B, S, -1)
    x = x + o @ params["attn"]["wo"].to(cdt)
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return x + mlp(params["mlp"], rmsnorm(x, params["ln2"], eps), cdt)


def prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None, s_max: int, cache_dtype=torch.bfloat16,
            wkv_impl: str = "cuda"):
    """Run the prompt, return (last-token logits (B,V), caches). The
    reference's ``enc_embeds`` / ``attn_impl`` reach only the encoder,
    which the port does not have yet. ``wkv_impl`` as in
    ``model.forward``; the reference's prefill takes its chunked form. The
    rwkv caches are f32 whatever ``cache_dtype`` says, as in the
    reference."""
    if cfg.encoder_layers:
        raise _unported("the encoder-decoder family")
    if embeds is None:
        embeds = embed_tokens(params, cfg, tokens)
    B, S, d = embeds.shape
    if positions is None:
        base = torch.arange(S, device=embeds.device).expand(B, S)
        positions = base.expand(3, B, S) if cfg.mrope else base
    caches = init_caches(cfg, B, s_max, dtype=cache_dtype,
                         device=embeds.device)
    x = embeds
    seg_meta = segment_structure(layer_kinds(cfg))
    for (kind, count), stacked, cache in zip(seg_meta, params["blocks"],
                                             caches):
        for li in range(count):
            lp = tree_map(lambda a: a[li], stacked)
            lc = {key: c[li] for key, c in cache.items()}
            x = _block_prefill(lp, cfg, kind, x, positions, lc, wkv_impl)
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = h[:, -1].float() @ _head(params).float()
    return logits, caches
