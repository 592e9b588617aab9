"""Shared transformer layers: RMSNorm, RoPE/M-RoPE, SwiGLU, GQA attention
(train: flash / chunked online-softmax; serve: KV-cache decode step); port of
``repro/models/layers.py``.

Parameters are plain dicts of tensors; init functions take a
``torch.Generator`` and return tensors in ``param_dtype`` on the generator's
device. Compute is in ``compute_dtype`` with f32 for norms/softmax
statistics. As in the reference, each matmul casts its weight to the
compute type on every call (``x @ w.to(cdt)``); nothing caches the cast.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attn.ops import chunked_attention, \
    flash_attention
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> Tensor:
    fan_in = shape[0] if len(shape) == 2 else shape[-2]
    if scale is None:
        scale = 1.0 / fan_in ** 0.5
    w = torch.randn(shape, generator=gen, device=gen.device)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> Tensor:
    """x: (B, S, H, hd). positions: (B, S) int, or (3, B, S) for M-RoPE.

    M-RoPE (qwen2-vl): the hd/2 rotary frequencies are split into
    (temporal, height, width) sections; each section takes its angle from the
    corresponding position stream. Text tokens carry identical t/h/w
    positions, reducing M-RoPE to 1-D RoPE exactly.
    """
    B, S, H, hd = x.shape
    inv = rope_freqs(hd, theta, x.device)             # (hd/2,)
    if positions.dim() == 3:
        assert mrope_sections is not None
        assert sum(mrope_sections) == hd // 2, (mrope_sections, hd)
        sec = torch.cat([
            torch.full((s,), i, dtype=torch.long, device=x.device)
            for i, s in enumerate(mrope_sections)
        ])                                            # (hd/2,) section id
        pos = positions.float()                       # (3, B, S)
        angle = pos[sec].permute(1, 2, 0) * inv[None, None, :]
    else:
        angle = positions.float()[..., None] * inv[None, None, :]
    cos = torch.cos(angle)[:, :, None, :]             # (B, S, 1, hd/2)
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int, dtype):
    return {
        "w1": dense_init(gen, (d, ff), dtype),
        "w3": dense_init(gen, (d, ff), dtype),
        "w2": dense_init(gen, (ff, d), dtype),
    }


def mlp(params, x: Tensor, cdt) -> Tensor:
    h = torch.nn.functional.silu(x @ params["w1"].to(cdt)) \
        * (x @ params["w3"].to(cdt))
    return h @ params["w2"].to(cdt)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   d: Optional[int] = None):
    d = d or cfg.d_model
    hd = cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.num_heads * hd), cfg.param_dtype),
        "wk": dense_init(gen, (d, cfg.kv_heads_eff * hd), cfg.param_dtype),
        "wv": dense_init(gen, (d, cfg.kv_heads_eff * hd), cfg.param_dtype),
        "wo": dense_init(gen, (cfg.num_heads * hd, d), cfg.param_dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=cfg.param_dtype,
                                  device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=cfg.param_dtype,
                                  device=gen.device)
    return p


def _project_qkv(params, cfg: ModelConfig, x: Tensor, positions: Tensor):
    B, S, _ = x.shape
    hd = cfg.head_dim
    cdt = cfg.compute_dtype
    q = (x @ params["wq"].to(cdt)).reshape(B, S, cfg.num_heads, hd)
    k = (x @ params["wk"].to(cdt)).reshape(B, S, cfg.kv_heads_eff, hd)
    v = (x @ params["wv"].to(cdt)).reshape(B, S, cfg.kv_heads_eff, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    sections = cfg.mrope_sections if cfg.mrope else None
    q = apply_rope(q, positions, cfg.rope_theta, sections)
    k = apply_rope(k, positions, cfg.rope_theta, sections)
    return q, k, v


def attention(params, cfg: ModelConfig, x: Tensor, positions: Tensor, *,
              causal: bool = True, window: int = 0,
              kv_override: Optional[Tuple[Tensor, Tensor]] = None,
              attn_impl: str = "cuda") -> Tensor:
    """Full-sequence attention (train / prefill / encoder).

    kv_override: (k, v) already projected — used by cross-attention.
    window > 0: local attention |q - k| < window (griffin).
    attn_impl: "cuda" runs the flash kernel (K4) when window == 0, "xla"
    the chunked path; the reference's "pallas" names raise in K4's wrapper.
    """
    B, S, _ = x.shape
    if kv_override is None:
        q, k, v = _project_qkv(params, cfg, x, positions)
    else:
        # Cross-attention: no RoPE on q/k (positions are heterogeneous).
        cdt = cfg.compute_dtype
        hd = cfg.head_dim
        q = (x @ params["wq"].to(cdt)).reshape(B, S, cfg.num_heads, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k, v = kv_override
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if attn_impl != "xla" and window == 0:
        o = flash_attention(qt, kt, vt, causal=causal, impl=attn_impl)
    else:
        o = chunked_attention(qt, kt, vt, causal=causal, window=window,
                              chunk_q=2048 if cfg.unroll_inner else 512,
                              unroll=cfg.unroll_inner)
    o = o.transpose(1, 2).reshape(B, S, -1)
    return o @ params["wo"].to(cfg.compute_dtype)


def attention_decode(params, cfg: ModelConfig, x: Tensor, cache_k: Tensor,
                     cache_v: Tensor, pos, *, window: int = 0):
    """One decode step. x: (B, 1, d); cache_k/v: (B, Smax, Hkv_eff, hd);
    pos: int — current position (same for the whole batch).

    Returns (out, cache_k, cache_v) with the caches updated at ``pos``.
    Unlike the reference, the caches are written in place (a copy of the
    whole cache per layer and step is what the in-place write saves); the
    returned tensors are the ones passed in.
    """
    B = x.shape[0]
    hd = cfg.head_dim
    pos = int(pos)
    dev = x.device
    if cfg.mrope:
        positions = torch.full((3, B, 1), pos, dtype=torch.long, device=dev)
    else:
        positions = torch.full((B, 1), pos, dtype=torch.long, device=dev)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)
    Smax = cache_k.shape[1]
    Hkv = cfg.kv_heads_eff
    rep = cfg.num_heads // Hkv
    qg = q.reshape(B, 1, Hkv, rep, hd).float()
    kf = cache_k.float()
    vf = cache_v.float()
    s = torch.einsum("bqhrd,bshd->bhrqs", qg, kf) / (1.0 * hd) ** 0.5
    idx = torch.arange(Smax, device=dev)
    mask = idx[None, :] <= pos
    if window:
        mask = mask & (idx[None, :] > pos - window)
    s = torch.where(mask[None, None, None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrqs,bshd->bqhrd", p, vf)
    o = o.reshape(B, 1, cfg.num_heads * hd).to(cfg.compute_dtype)
    return o @ params["wo"].to(cfg.compute_dtype), cache_k, cache_v
