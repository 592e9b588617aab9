"""K5 wrapper: the RWKV-6 WKV recurrence with the state resident on chip;
port of ``repro/kernels/wkv/ops.py`` and ``wkv.py``.

``impl="cuda"`` takes the place of the reference's Pallas kernel: CUDA
tensors go to ``csrc/wkv.cu`` and count ``wkv.launches``; CPU tensors run
the plain version (:func:`wkv_plain`); any other device raises.
``"pallas"`` and ``"pallas_interpret"`` have no counterpart and raise. The
model's own chunked forms live in ``repro_torch/models/rwkv6.py``.

As in the reference, T must be a multiple of ``chunk`` (a ``ValueError``
here) and the initial state is zero. Unlike the reference, a chunk longer
than ``MAX_CHUNK`` raises: the separable decay factors reach
e^{chunk * 5} under the clamp, past f32's range above 17, where the
reference's kernel returns NaN (ROADMAP section 3). Beyond the
reference, the wrapper takes r, k, v and w_log as strided views (the model
hands over its (B, S, H, hd) projections transposed, and no copy is made),
returns y in r's layout, and returns the final state when asked. Like K4,
it has no backward and raises under grad when an input requires grad
(``flash_attn.ops.no_backward``); the model trains through its chunked form.

The kernel (one CTA per (b, h), the next chunk's rows in flight by 16-byte
``cp.async``) takes each of r, k, v and w_log by that copy when its base
and its batch, head and time strides are multiples of 16 bytes, as the
model's projections are; a tensor that is not (a view offset along hd, an
odd stride) is copied into the kernel's next stage by plain loads
instead: the same result, with the load latency exposed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn.ops import no_backward

WKV_LOG_CLAMP = -5.0            # keep in sync with repro_torch.models.rwkv6
# e^{chunk * |clamp|} must stay below f32's largest value, e^88.7
MAX_CHUNK = 17
HEAD_DIMS = (16, 32, 64)        # head dims the kernel is built for
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        w_log: torch.Tensor, u: torch.Tensor, *, chunk: int = 16,
        impl: str = "cuda", return_state: bool = False):
    """r/k/v/w_log: (B, H, T, hd); u: (H, hd). The log-decay is clamped at
    ``WKV_LOG_CLAMP``. Returns y (B, H, T, hd) f32 and, with
    ``return_state``, also the final state S (B, H, hd, hd) f32."""
    if impl in ("pallas", "pallas_interpret"):
        raise ValueError(f"impl={impl!r} is the JAX package's TPU kernel; "
                         "the port's kernel is impl='cuda'")
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}: 'cuda'")
    no_backward("wkv", (r, k, v, w_log, u), "wkv_impl='xla'")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"wkv: chunk {chunk} is not in 1..{MAX_CHUNK} "
                         "(the decay factors e^(5 chunk) overflow f32)")
    if r.dim() != 4 or r.shape[2] % chunk:
        raise ValueError(f"wkv: T of r {tuple(r.shape)} (B, H, T, hd) must "
                         f"be a multiple of chunk={chunk}")
    if r.device.type == "cpu":
        y, S = wkv_plain(r, k, v, w_log, u, chunk=chunk)
    else:
        y, S = _launch(r, k, v, w_log, u, chunk, return_state)
        wkv.launches += 1
    return (y, S) if return_state else y


wkv.launches = 0


def wkv_plain(r, k, v, w_log, u, *, chunk: int = 16):
    """The kernel's plain version: the reference ``_wkv_kernel`` chunk by
    chunk, batched over (B, H), with the wrapper's clamp. Entries of the
    score tile above the diagonal are selected away, not multiplied by 0.
    Returns (y in r's layout, S_final (B, H, hd, hd)), f32."""
    B, H, T, hd = r.shape
    if T % chunk:
        raise ValueError(f"wkv: T={T} is not a multiple of chunk={chunk}")
    dev = r.device
    y = torch.empty_like(r, dtype=torch.float32)
    S = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dev), diagonal=-1)
    uf = u.float()[:, None, :]                          # (H, 1, hd)
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        rc, kc, vc = (t[:, :, sl].float() for t in (r, k, v))
        wc = torch.clamp(w_log[:, :, sl].float(), min=WKV_LOG_CLAMP)
        cum = torch.cumsum(wc, dim=2)                   # inclusive
        cum_prev = cum - wc
        r_t = rc * torch.exp(cum_prev)
        k_t = kc * torch.exp(-cum)
        A = torch.where(mask, r_t @ k_t.transpose(-1, -2), 0.0)
        diag = torch.sum(rc * uf * kc, dim=-1)
        yc = A @ vc + diag[..., None] * vc
        y[:, :, sl] = yc + r_t @ S
        last = cum[:, :, -1:]                           # (B, H, 1, hd)
        kk = kc * torch.exp(last - cum)
        S = torch.exp(last).transpose(-1, -2) * S \
            + kk.transpose(-1, -2) @ vc
    return y, S


def _launch(r, k, v, w_log, u, chunk, return_state):
    B, H, T, hd = r.shape
    if k.shape != r.shape or v.shape != r.shape or w_log.shape != r.shape \
            or tuple(u.shape) != (H, hd):
        raise ValueError(f"wkv: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w_log "
                         f"{tuple(w_log.shape)}, u {tuple(u.shape)} do not "
                         "match (B, H, T, hd) and (H, hd)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv: head dim {hd} is not supported by the "
                         f"kernel (one of {HEAD_DIMS})")
    if r.dtype not in DTYPE_IDS or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv: r, k, v must all be float32 or all "
                         f"bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    w = w_log.float()
    uf = u.float().contiguous()
    if not all(t.device == r.device and t.stride(-1) == 1
               for t in (r, k, v, w, uf)):
        raise ValueError("wkv: r, k, v, w_log, u must be on one device "
                         "with a unit stride along hd")
    if r.device.type != "cuda":
        raise ValueError(f"wkv: no kernel for device {r.device}")
    y = torch.empty_like(r, dtype=torch.float32)   # r's layout
    S = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device) \
        if return_state else None
    lib = build.library()
    rc = lib.repro_wkv(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        uf.data_ptr(), y.data_ptr(), build.ptr(S), DTYPE_IDS[r.dtype], B, H,
        T, hd, chunk, *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *w.stride()[:3], *y.stride()[:3], WKV_LOG_CLAMP,
        build.stream_ptr(r))
    build.check(rc, "wkv")
    return y, S
