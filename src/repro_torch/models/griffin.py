"""Griffin / RecurrentGemma (arXiv:2402.19427) — RG-LRU + local attention;
port of ``repro/models/griffin.py``.

Recurrent block: gated branch (GeLU) x (conv1d width-4 -> RG-LRU) -> out proj.
RG-LRU:  r_t = sigmoid(W_a x_t); i_t = sigmoid(W_i x_t)
         a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
The reference's sequence form is ``jax.lax.associative_scan`` over the
affine maps h -> a h + b. Here it is a log-depth doubling scan in f32 torch
ops (:func:`scan_affine`): ceil(log2 S) steps of a few elementwise passes
each, where a Python loop over the steps would launch ~3 S kernels a layer.
The two trees sum in other orders, so they agree to f32 rounding. Decode is
a single affine step, O(1) state (+ width-4 conv tail, + the local-attention
window's ring buffer in ``decode.py``).

``jax.nn.gelu`` defaults to the tanh approximation, so the gate uses
``approximate="tanh"``; ``jax.nn.softplus`` is ``logaddexp(x, 0)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

Tensor = torch.Tensor
LRU_C = 8.0


def init_recurrent_block(gen: torch.Generator, cfg: ModelConfig):
    d, lw = cfg.d_model, cfg.lru_width
    dt = cfg.param_dtype
    dev = gen.device
    return {
        "w_gate": dense_init(gen, (d, lw), dt),
        "w_x": dense_init(gen, (d, lw), dt),
        "conv_w": dense_init(gen, (cfg.conv_width, lw), dt, scale=0.5),
        "conv_b": torch.zeros((lw,), dtype=dt, device=dev),
        # softplus -> a ~ decay
        "lru_lambda": torch.full((lw,), 0.7, dtype=dt, device=dev),
        "w_a": dense_init(gen, (lw, lw), dt),
        "w_i": dense_init(gen, (lw, lw), dt),
        "w_out": dense_init(gen, (lw, d), dt),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 tail: Optional[Tensor] = None):
    """Depthwise causal conv, width W. x: (B,S,lw); w: (W,lw).
    tail: (B, W-1, lw) previous context (decode) or None (zeros)."""
    B, S, lw = x.shape
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((B, W - 1, lw))
    # caches store the tail in f32; keep the conv in compute dtype
    xp = torch.cat([tail.to(x.dtype), x], dim=1)      # (B, S+W-1, lw)
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W)) \
        + b[None, None, :]
    return out, xp[:, -(W - 1):, :]


def scan_affine(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0: the inclusive
    scan of the maps (a_t, b_t) under (a1, b1) then (a2, b2) ->
    (a1 a2, a2 b1 + b2). Hillis-Steele doubling: after the step of shift s
    each position holds the composition of the last 2s maps up to it."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        if 2 * shift < S:        # the last step needs no new a
            a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]],
                          dim=1)
        shift *= 2
    return b


def rg_lru(p, x: Tensor, h0: Optional[Tensor] = None):
    """x: (B,S,lw) conv output. Returns (y, h_last). f32 scan math."""
    B, S, lw = x.shape
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float())
    i = torch.sigmoid(xf @ p["w_i"].float())
    lam = p["lru_lambda"].float()
    log_a = -LRU_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    if h0 is not None:
        # Fold the carried state in as a virtual step 0.
        aa = torch.cat([a.new_ones((B, 1, lw)), a], dim=1)
        bb = torch.cat([h0.float()[:, None], gated], dim=1)
    else:
        aa, bb = a, gated
    h = scan_affine(aa, bb)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(x.dtype), h[:, -1]


def recurrent_block(p, cfg: ModelConfig, x: Tensor,
                    state: Optional[Tuple[Tensor, Tensor]] = None):
    """x: (B,S,d). state = (h_lru (B,lw), conv_tail (B,W-1,lw)) or None.
    Returns (out, new_state)."""
    cdt = cfg.compute_dtype
    gate = torch.nn.functional.gelu(x @ p["w_gate"].to(cdt),
                                    approximate="tanh")
    u = x @ p["w_x"].to(cdt)
    h0, tail = state if state is not None else (None, None)
    u, new_tail = _causal_conv(u, p["conv_w"].to(cdt), p["conv_b"].to(cdt),
                               tail)
    y, h_last = rg_lru(p, u, h0)
    out = (gate * y) @ p["w_out"].to(cdt)
    # states are carried in f32 across steps (cache dtype), output in cdt
    return out, (h_last.float(), new_tail.float())


def recurrent_block_step(p, cfg: ModelConfig, x: Tensor,
                         state: Tuple[Tensor, Tensor]):
    """One-token decode. x: (B, d); state as above with conv tail (B,W-1,lw)."""
    out, new_state = recurrent_block(p, cfg, x[:, None, :], state)
    return out[:, 0], new_state
