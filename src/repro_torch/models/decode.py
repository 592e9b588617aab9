"""Serving path: prefill (build caches) + single-token decode steps; port of
``repro/models/decode.py``.

Cache layouts (per homogeneous segment, leading L axis):
  attn / moe / cross : k,v (L,B,Smax,Hkv_eff,hd) — rotated keys cached
                       cross adds xk,xv (L,B,Senc,Hkv_eff,hd), built once
  attn_local         : ring buffers k,v (L,B,window,Hkv_eff,hd); a slot s at
                       step pos holds position p = pos - ((pos - s) % window)
                       (validity derived, nothing stored)
  rwkv               : S (L,B,H,hd,hd), tmix_x/cmix_x (L,B,d), f32 — O(1) state
  rec (RG-LRU)       : h (L,B,lw), conv tail (L,B,W-1,lw), f32

Prefill runs the decoder's attention layers through the chunked attention
path, as the reference does, not through the flash kernel; the encoder of
an encoder-decoder runs through ``attn_impl`` (K4 by default, as the
reference's encoder takes its ``attn_impl``). rwkv layers run ``time_mix``
with ``wkv_impl`` (the WKV kernel K5 by default), which also returns the
state the decode steps continue from. The caches are allocated once per
prefill and written in place by prefill and by every decode step.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.flash_attn.ops import chunked_attention
from repro_torch.models import griffin as griffin_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import moe_a2a
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _project_qkv, attend_cache, \
    attention_decode, mlp, rmsnorm
from repro_torch.models.model import (
    cross_kv,
    embed_tokens,
    encode,
    layer_kinds,
    segment_structure,
    tree_map,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, kind: str, count: int, B: int, s_max: int,
               s_enc: int = 0, dtype=torch.bfloat16,
               device="cuda") -> Dict[str, Tensor]:
    hd = cfg.head_dim
    Hkv = cfg.kv_heads_eff
    f32 = dict(dtype=torch.float32, device=device)
    kv = lambda s: torch.zeros((count, B, s, Hkv, hd), dtype=dtype,
                               device=device)
    if kind in ("attn", "moe"):
        return {"k": kv(s_max), "v": kv(s_max)}
    if kind == "cross":
        return {"k": kv(s_max), "v": kv(s_max), "xk": kv(s_enc),
                "xv": kv(s_enc)}
    if kind == "attn_local":
        w = min(cfg.window_size, s_max)
        return {"k": kv(w), "v": kv(w)}
    if kind == "rwkv":
        H = cfg.d_model // cfg.rwkv_head_dim
        rhd = cfg.rwkv_head_dim
        return {"S": torch.zeros((count, B, H, rhd, rhd), **f32),
                "tmix_x": torch.zeros((count, B, cfg.d_model), **f32),
                "cmix_x": torch.zeros((count, B, cfg.d_model), **f32)}
    if kind == "rec":
        return {"h": torch.zeros((count, B, cfg.lru_width), **f32),
                "conv": torch.zeros((count, B, cfg.conv_width - 1,
                                     cfg.lru_width), **f32)}
    raise ValueError(kind)


def init_caches(cfg: ModelConfig, B: int, s_max: int, s_enc: int = 0,
                dtype=torch.bfloat16, device="cuda"):
    return [
        init_cache(cfg, kind, count, B, s_max, s_enc, dtype, device)
        for kind, count in segment_structure(layer_kinds(cfg))
    ]


# ---------------------------------------------------------------------------
# Per-layer decode step
# ---------------------------------------------------------------------------

def _local_attn_decode(params, cfg: ModelConfig, x, cache_k, cache_v, pos):
    """Ring-buffer windowed decode. cache_k/v: (B, W, Hkv, hd), written in
    place at slot pos mod W."""
    B = x.shape[0]
    W = cache_k.shape[1]
    dev = x.device
    positions = torch.full((B, 1), pos, dtype=torch.long, device=dev)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    slot = pos % W
    cache_k[:, slot:slot + 1] = k_new.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v_new.to(cache_v.dtype)
    # slot s holds position p = pos - ((pos - s) mod W); valid iff p >= 0.
    s_idx = torch.arange(W, device=dev)
    valid = pos - torch.remainder(pos - s_idx, W) >= 0
    o = attend_cache(cfg, q, cache_k, cache_v, valid)
    return o @ params["wo"].to(cfg.compute_dtype)


def _block_step(params, cfg: ModelConfig, kind: str, x: Tensor,
                cache: Dict[str, Tensor], pos) -> Tensor:
    """x: (B, 1, d) -> x'. cache holds ONE layer (no L axis) and is
    updated in place (the reference returns a new one)."""
    eps = cfg.norm_eps
    cdt = cfg.compute_dtype
    pos = int(pos)
    if kind in ("attn", "moe", "cross", "attn_local"):
        h_in = rmsnorm(x, params["ln1"], eps)
        if kind == "attn_local":
            h = _local_attn_decode(params["attn"], cfg, h_in, cache["k"],
                                   cache["v"], pos)
        else:
            h, _, _ = attention_decode(params["attn"], cfg, h_in,
                                       cache["k"], cache["v"], pos)
        x = x + h
        if kind == "cross":
            # q from ln_x through wq (no q_norm, no RoPE, as in the
            # reference's step) against the cached encoder keys
            xa = params["xattn"]
            q = rmsnorm(x, params["ln_x"], eps) @ xa["wq"].to(cdt)
            q = q.reshape(x.shape[0], 1, cfg.num_heads, cfg.head_dim)
            o = attend_cache(cfg, q, cache["xk"], cache["xv"])
            x = x + o @ xa["wo"].to(cdt)
        ff_in = rmsnorm(x, params["ln2"], eps)
        if kind == "moe":
            h, _ = moe_lib.moe_ffn(params["moe"], cfg, ff_in)
        else:
            h = mlp(params["mlp"], ff_in, cdt)
        return x + h
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
    if kind == "rec":
        h, (hl, tail) = griffin_lib.recurrent_block_step(
            params["rec"], cfg, rmsnorm(x[:, 0], params["ln1"], eps),
            (cache["h"], cache["conv"]))
        x = x + h[:, None]
        _store(cache, h=hl, conv=tail)
        return x + mlp(params["mlp"], rmsnorm(x, params["ln2"], eps), cdt)
    raise ValueError(kind)


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
# Prefill: forward that also fills the caches
# ---------------------------------------------------------------------------

def _block_prefill(params, cfg: ModelConfig, kind: str, x: Tensor,
                   positions, cache: Dict[str, Tensor], enc_out=None,
                   wkv_impl: str = "cuda") -> Tensor:
    """Full-sequence block that also writes this layer's cache content
    into ``cache`` (ONE layer, no L axis)."""
    eps = cfg.norm_eps
    cdt = cfg.compute_dtype
    B, S, d = x.shape
    if kind in ("attn", "moe", "cross", "attn_local"):
        h_in = rmsnorm(x, params["ln1"], eps)
        q, k, v = _project_qkv(params["attn"], cfg, h_in, positions)
        window = cfg.window_size if kind == "attn_local" else 0
        o = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, window=window,
                              unroll=cfg.unroll_inner)
        o = o.transpose(1, 2).reshape(B, S, -1)
        x = x + o @ params["attn"]["wo"].to(cdt)
        if kind == "attn_local":
            # ring layout: slot = pos % W for the last W positions
            W = cache["k"].shape[1]
            first = max(0, S - W)
            slots = torch.arange(first, S, device=x.device) % W
            cache["k"][:, slots] = k[:, first:].to(cache["k"].dtype)
            cache["v"][:, slots] = v[:, first:].to(cache["v"].dtype)
        else:
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
        if kind == "cross":
            xa = params["xattn"]
            xk, xv = cross_kv(xa, cfg, enc_out)
            hq = rmsnorm(x, params["ln_x"], eps) @ xa["wq"].to(cdt)
            hq = hq.reshape(B, S, cfg.num_heads, cfg.head_dim)
            o = chunked_attention(hq.transpose(1, 2), xk.transpose(1, 2),
                                  xv.transpose(1, 2), causal=False,
                                  unroll=cfg.unroll_inner)
            o = o.transpose(1, 2).reshape(B, S, -1)
            x = x + o @ xa["wo"].to(cdt)
            _store(cache, xk=xk, xv=xv)
        ff_in = rmsnorm(x, params["ln2"], eps)
        if kind == "moe" and cfg.moe_impl == "a2a":
            # prefill takes the a2a path (the decode step, S = 1, keeps
            # moe_ffn, as the reference's does)
            h, _ = moe_a2a.moe_ffn_a2a(params["moe"], cfg, ff_in)
        elif kind == "moe":
            h, _ = moe_lib.moe_ffn(params["moe"], cfg, ff_in)
        else:
            h = mlp(params["mlp"], ff_in, cdt)
        return x + h
    if kind == "rwkv":
        h, (last_t, S_final) = rwkv_lib.time_mix(
            params["tmix"], cfg, rmsnorm(x, params["ln1"], eps),
            wkv_impl=wkv_impl)
        x = x + h
        h, last_c = rwkv_lib.channel_mix(params["cmix"], cfg,
                                         rmsnorm(x, params["ln2"], eps))
        _store(cache, S=S_final, tmix_x=last_t, cmix_x=last_c)
        return x + h
    if kind == "rec":
        h, (hl, tail) = griffin_lib.recurrent_block(
            params["rec"], cfg, rmsnorm(x, params["ln1"], eps))
        x = x + h
        _store(cache, h=hl, conv=tail)
        return x + mlp(params["mlp"], rmsnorm(x, params["ln2"], eps), cdt)
    raise ValueError(kind)


def prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None, enc_embeds=None, s_max: int,
            attn_impl: str = "cuda", cache_dtype=torch.bfloat16,
            wkv_impl: str = "cuda"):
    """Run the prompt, return (last-token logits (B,V), caches).
    ``attn_impl`` reaches only the encoder (``model.forward``'s choice);
    ``wkv_impl`` as in ``model.forward``, where the reference's prefill
    takes its chunked form. The rwkv and rec caches are f32 whatever
    ``cache_dtype`` says, as in the reference."""
    if embeds is None:
        embeds = embed_tokens(params, cfg, tokens)
    B, S, d = embeds.shape
    if positions is None:
        base = torch.arange(S, device=embeds.device).expand(B, S)
        positions = base.expand(3, B, S) if cfg.mrope else base
    enc_out = encode(params, cfg, enc_embeds, attn_impl=attn_impl)
    s_enc = 0 if enc_out is None else enc_out.shape[1]
    caches = init_caches(cfg, B, s_max, s_enc, dtype=cache_dtype,
                         device=embeds.device)
    x = embeds
    seg_meta = segment_structure(layer_kinds(cfg))
    for (kind, count), stacked, cache in zip(seg_meta, params["blocks"],
                                             caches):
        for li in range(count):
            lp = tree_map(lambda a: a[li], stacked)
            lc = {key: c[li] for key, c in cache.items()}
            x = _block_prefill(lp, cfg, kind, x, positions, lc, enc_out,
                               wkv_impl)
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = h[:, -1].float() @ _head(params).float()
    return logits, caches
