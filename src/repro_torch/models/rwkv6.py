"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free, data-dependent decay;
port of ``repro/models/rwkv6.py``.

Time-mix: per-head matrix-valued state S in R^{hd x hd} evolving as
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
with per-channel data-dependent decay w_t in (0,1) produced by a low-rank MLP
(ddlerp token-shift mixing for r/k/v/g/w as in the paper).

The sequence form is chunked (GLA-style): within a chunk of length Lc the
intra-chunk part is a masked score contraction with per-channel decay
factors exp(cum_{t-1} - cum_s), and the inter-chunk part flows through the
carried state. ``time_mix(..., wkv_impl="cuda")`` (the default) runs it
through the WKV kernel K5 (``kernels/wkv``: the kernel for CUDA tensors,
its plain version for CPU tensors); ``wkv_impl="xla"`` runs the reference's
own chunked form named by ``cfg.wkv_impl`` (``"matmul"`` or ``"einsum"``)
as a torch loop over chunks. Decode (``time_mix_step``) is the per-step
recurrence in torch ops, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv.ops import wkv
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

Tensor = torch.Tensor

# Per-step log-decay floor. exp factors inside a chunk are bounded by
# exp(chunk * |log w|); with chunk=16 and floor -5 the worst factor is e^80
# < f32 max. Semantically free: w < e^-5 retains 0.7% per step.
WKV_LOG_CLAMP = -5.0
GN_EPS = 64e-5                   # the per-head GroupNorm's epsilon


def init_time_mix(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    r = cfg.rwkv_lora_rank
    H = d // cfg.rwkv_head_dim
    dt = cfg.param_dtype
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    return {
        "maa_base": full((5, d), 0.0),                  # w,k,v,r,g mix biases
        "maa_w1": dense_init(gen, (d, 5 * r), dt),
        "maa_w2": dense_init(gen, (5, r, d), dt, scale=1.0 / r ** 0.5),
        "decay_base": full((d,), -2.0),
        "decay_w1": dense_init(gen, (d, 2 * r), dt),
        "decay_w2": dense_init(gen, (2 * r, d), dt, scale=1.0 / r ** 0.5),
        "bonus": full((H, cfg.rwkv_head_dim), 0.0),     # u
        "wr": dense_init(gen, (d, d), dt),
        "wk": dense_init(gen, (d, d), dt),
        "wv": dense_init(gen, (d, d), dt),
        "wg": dense_init(gen, (d, d), dt),
        "wo": dense_init(gen, (d, d), dt),
        "gn_scale": full((d,), 1.0),
        "gn_bias": full((d,), 0.0),
    }


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig):
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    zeros = lambda: torch.zeros((d,), dtype=dt, device=gen.device)
    return {
        "mu_k": zeros(),
        "mu_r": zeros(),
        "wk": dense_init(gen, (d, ff), dt),
        "wv": dense_init(gen, (ff, d), dt),
        "wr": dense_init(gen, (d, d), dt),
    }


def _chunks(r, k, v, w_log, chunk):
    """Per-chunk (r, k, v, w) slices along T of (..., T, hd) tensors."""
    T = r.shape[-2]
    if T % chunk:
        raise ValueError(f"wkv: T={T} is not a multiple of chunk={chunk}")
    for c0 in range(0, T, chunk):
        yield tuple(t[..., c0:c0 + chunk, :] for t in (r, k, v, w_log))


def _wkv_chunked(r, k, v, w_log, u, chunk: int, unroll: bool = False):
    """Chunked WKV, einsum form. r/k/v/w_log: (..., T, hd) f32 (w_log =
    log w < 0); u: (..., hd) broadcast against the leading dims. Returns
    (y (..., T, hd), S_final (..., hd, hd)). ``unroll`` is the reference's
    cost-extraction switch and changes nothing here (a Python loop)."""
    del unroll
    hd = r.shape[-1]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    S = r.new_zeros(r.shape[:-2] + (hd, hd))
    ys = []
    for rc, kc, vc, wc in _chunks(r, k, v, w_log, chunk):
        cum = torch.cumsum(wc, dim=-2)                     # inclusive
        cum_prev = cum - wc                                # cum_{t-1}
        # intra: A[t,s] = sum_d r[t]k[s] exp(cum_prev[t]-cum[s]), s<t
        expo = cum_prev[..., :, None, :] - cum[..., None, :, :]
        expo = torch.where(mask[:, :, None], expo, -torch.inf)
        A = torch.sum(rc[..., :, None, :] * kc[..., None, :, :]
                      * torch.exp(expo), dim=-1)
        diag = torch.sum(rc * u[..., None, :] * kc, dim=-1)
        y = A @ vc + diag[..., None] * vc
        ys.append(y + (rc * torch.exp(cum_prev)) @ S)
        last = cum[..., -1:, :]
        kk = kc * torch.exp(last - cum)
        S = torch.exp(last).transpose(-1, -2) * S + kk.transpose(-1, -2) @ vc
    return torch.cat(ys, dim=-2), S


def _wkv_chunked_matmul(r, k, v, w_log, u, chunk: int, unroll: bool = False):
    """Chunked WKV, separable-decay matmul form: because
        A[t,s] = sum_d (r[t,d] e^{cum[t-1,d]}) (k[s,d] e^{-cum[s,d]}),
    the intra-chunk part is one (Lc,hd)x(hd,Lc) product after scaling r and
    k by per-chunk decay factors. Shapes as :func:`_wkv_chunked`."""
    del unroll
    hd = r.shape[-1]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    S = r.new_zeros(r.shape[:-2] + (hd, hd))
    ys = []
    for rc, kc, vc, wc in _chunks(r, k, v, w_log, chunk):
        cum = torch.cumsum(wc, dim=-2)                     # inclusive, <= 0
        cum_prev = cum - wc
        r_t = rc * torch.exp(cum_prev)                     # <= |r|
        k_t = kc * torch.exp(-cum)                         # bounded e^{5Lc}
        A = torch.where(mask, r_t @ k_t.transpose(-1, -2), 0.0)
        diag = torch.sum(rc * u[..., None, :] * kc, dim=-1)
        ys.append(A @ vc + diag[..., None] * vc + r_t @ S)
        last = cum[..., -1:, :]
        kk = kc * torch.exp(last - cum)
        S = torch.exp(last).transpose(-1, -2) * S + kk.transpose(-1, -2) @ vc
    return torch.cat(ys, dim=-2), S


def _decay_log(p, xw):
    """log w = max(-exp(decay_base + tanh(xw @ w1) @ w2), clamp), f32."""
    w_log = -torch.exp(p["decay_base"].float()
                       + torch.tanh(xw @ p["decay_w1"].float())
                       @ p["decay_w2"].float())
    return torch.clamp(w_log, min=WKV_LOG_CLAMP)


def _sigmoid(x: Tensor) -> Tensor:
    """The logistic as the reference computes it in a narrow type: 1 / (1 +
    e^-x) with each step rounded to x's type (``jax.nn.sigmoid`` and
    ``jax.nn.silu`` on bf16 on the JAX package's CPU backend, bit for
    bit); torch's fused sigmoid rounds once."""
    return 1 / (1 + torch.exp(-x))


def _group_norm_gate(p, cfg: ModelConfig, y: Tensor, g: Tensor) -> Tensor:
    """Per-head GroupNorm of y (..., H, hd) f32, then the silu(g) gate and
    the output projection in the compute type."""
    cdt = cfg.compute_dtype
    mean = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    yh = (y - mean) * torch.rsqrt(var + GN_EPS)
    yd = yh.reshape(*y.shape[:-2], -1) * p["gn_scale"] + p["gn_bias"]
    return (yd.to(cdt) * (g * _sigmoid(g))) @ p["wo"].to(cdt)


def time_mix(p, cfg: ModelConfig, x: Tensor, x_prev_last: Tensor | None = None,
             wkv_impl: str = "cuda"):
    """x: (B, S, d). Token shift uses the previous position (zero/state at 0).
    Returns (out, (last_x, S_final)), the carries used by decode."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    cdt = cfg.compute_dtype
    xf = x.float()
    prev0 = xf.new_zeros((B, 1, d)) if x_prev_last is None \
        else x_prev_last[:, None, :].float()
    x_prev = torch.cat([prev0, xf[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp_simple(p, xf, x_prev)

    r = (xr.to(cdt) @ p["wr"].to(cdt)).reshape(B, S, H, hd)
    k = (xk.to(cdt) @ p["wk"].to(cdt)).reshape(B, S, H, hd)
    v = (xv.to(cdt) @ p["wv"].to(cdt)).reshape(B, S, H, hd)
    g = xg.to(cdt) @ p["wg"].to(cdt)
    w_log = _decay_log(p, xw).reshape(B, S, H, hd)
    u = p["bonus"].float()
    # (B, H, S, hd) views of the (B, S, H, hd) projections
    heads = [t.transpose(1, 2) for t in (r, k, v, w_log)]
    if wkv_impl == "cuda":
        y, S_final = wkv(*heads, u, chunk=cfg.wkv_chunk, return_state=True)
    elif wkv_impl == "xla":
        fn = _wkv_chunked_matmul if cfg.wkv_impl == "matmul" \
            else _wkv_chunked
        y, S_final = fn(*(t.float() for t in heads), u, cfg.wkv_chunk,
                        unroll=cfg.unroll_inner)
    else:
        raise ValueError(f"unknown wkv_impl {wkv_impl!r}: 'cuda' or 'xla'")
    out = _group_norm_gate(p, cfg, y.transpose(1, 2), g)
    return out, (xf[:, -1, :], S_final)


def _ddlerp_simple(p, x, x_prev):
    """ddlerp as in RWKV6: shared tanh bottleneck, per-stream low-rank out."""
    dx = x_prev - x
    base = p["maa_base"].float()                             # (5, d)
    w1 = p["maa_w1"].float()                                 # (d, 5r)
    w2 = p["maa_w2"].float()                                 # (5, r, d)
    r5 = w1.shape[1] // 5
    xx = x + dx * base[0]                                    # shift seed
    z = torch.tanh(xx @ w1).reshape(*x.shape[:-1], 5, r5)    # (B,S,5,r)
    mod = torch.einsum("bsir,ird->bsid", z, w2)              # (B,S,5,d)
    mix = base + mod
    return tuple(x + dx * mix[:, :, i] for i in range(5))


def channel_mix(p, cfg: ModelConfig, x: Tensor,
                x_prev_last: Tensor | None = None):
    B, S, d = x.shape
    xf = x.float()
    prev0 = xf.new_zeros((B, 1, d)) if x_prev_last is None \
        else x_prev_last[:, None, :].float()
    x_prev = torch.cat([prev0, xf[:, :-1]], dim=1)
    return _channel_mix_out(p, cfg, xf, x_prev - xf), xf[:, -1, :]


def _channel_mix_out(p, cfg: ModelConfig, xf: Tensor, dx: Tensor) -> Tensor:
    cdt = cfg.compute_dtype
    xk = (xf + dx * p["mu_k"]).to(cdt)
    xr = (xf + dx * p["mu_r"]).to(cdt)
    kk = torch.square(torch.relu(xk @ p["wk"].to(cdt)))
    return _sigmoid(xr @ p["wr"].to(cdt)) * (kk @ p["wv"].to(cdt))


# ---------------------------------------------------------------------------
# Decode (single step): O(1) state (last_x_tmix, last_x_cmix, S (H,hd,hd))
# ---------------------------------------------------------------------------

def time_mix_step(p, cfg: ModelConfig, x: Tensor, last_x: Tensor,
                  S: Tensor):
    """x: (B, d); last_x: (B, d); S: (B, H, hd, hd). Returns (out, last, S')."""
    B, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    cdt = cfg.compute_dtype
    xf = x.float()
    xw, xk, xv, xr, xg = (
        t[:, 0] for t in _ddlerp_simple(p, xf[:, None, :],
                                        last_x.float()[:, None, :]))
    r = (xr.to(cdt) @ p["wr"].to(cdt)).reshape(B, H, hd)
    k = (xk.to(cdt) @ p["wk"].to(cdt)).reshape(B, H, hd)
    v = (xv.to(cdt) @ p["wv"].to(cdt)).reshape(B, H, hd)
    g = xg.to(cdt) @ p["wg"].to(cdt)
    w = torch.exp(_decay_log(p, xw)).reshape(B, H, hd)
    u = p["bonus"].float()
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = kf[..., :, None] * vf[..., None, :]                 # (B,H,hd,hd)
    y = torch.einsum("bhk,bhkv->bhv", rf, S + u[None, :, :, None] * kv)
    S_new = w[..., None] * S + kv
    return _group_norm_gate(p, cfg, y, g), xf, S_new


def channel_mix_step(p, cfg: ModelConfig, x: Tensor, last_x: Tensor):
    xf = x.float()
    return _channel_mix_out(p, cfg, xf, last_x.float() - xf), xf
