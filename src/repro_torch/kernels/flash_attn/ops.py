"""K4 wrapper: causal / GQA flash attention forward; port of
``repro/kernels/flash_attn/ops.py``.

``impl="cuda"`` takes the place of the reference's ``"pallas"``: CUDA
tensors go to one of K4's two kernels, CPU tensors run the plain version
(:func:`flash_attention_plain`), and any other device raises. The kernel is
picked by :func:`route`, by dtype and head dim alone:

* bf16 at head dims 64 and 128 (every bf16 call on qwen3-8b's path) ->
  ``"tc"``, ``csrc/flash_attn_sm90.cu``: wgmma on the bf16 tensor cores
  with TMA loads, P rounded to bf16 for the second product (as FA2 and
  SDPA do; ``flash_attention_plain(p_dtype=torch.bfloat16)`` repeats that);
  it also needs strides that are multiples of 8 elements and 16-byte
  aligned addresses (TMA's rule), and raises otherwise;
* f32 at any supported head dim, and bf16 at head dims 8 and 16 ->
  ``"fma"``,
  ``csrc/flash_attn.cu``: FP32 FMA, P kept in f32 (TF32 would miss the f32
  tolerance).

Each launch adds one to ``flash_attention.launches`` and to its route's
count, ``flash_attention.launches_tc`` or ``launches_fma``. A build or
launch error raises; nothing falls back. ``impl="xla"`` is the chunked
online-softmax path (:func:`chunked_attention`, the reference's
``chunked_attention_xla``). ``"pallas"`` and ``"pallas_interpret"`` have no
counterpart and raise.

The TPU wrapper asserted Sq and Skv to be multiples of the block sizes; the
CUDA kernels mask the ragged edges of both. Their tiles are fixed (64 rows
in the FMA kernel, 128 in the tensor-core one) whatever ``block_q`` /
``block_k`` say: those set the tiles of the plain version and the query
chunk of the ``xla`` path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
TILE = 64                       # q and kv tile rows in flash_attn.cu
HEAD_DIMS = (8, 16, 64, 128)    # head dims the kernels are built for
TC_HEAD_DIMS = (64, 128)        # head dims of the tensor-core kernel
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call goes to: ``"tc"`` (bf16 tensor cores,
    flash_attn_sm90.cu) for bf16 at head dims 64 and 128, else ``"fma"``
    (FP32 FMA, flash_attn.cu)."""
    return "tc" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS \
        else "fma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    block_q: int = 256, block_k: int = 256,
                    impl: str = "cuda") -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D), f32 or bf16; returns
    (B, Hq, Sq, D) in q.dtype. kv head = q head // (Hq / Hkv)."""
    if impl in ("pallas", "pallas_interpret"):
        raise ValueError(f"impl={impl!r} is the JAX package's TPU kernel; "
                         "the port's kernel is impl='cuda'")
    if impl == "xla":
        return chunked_attention(q, k, v, causal=causal, scale=scale,
                                 chunk_q=block_q)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}: 'cuda' or 'xla'")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k)
    kernel = route(q.dtype, q.shape[-1])
    out = _launch(q, k, v, causal, scale, kernel)
    flash_attention.launches += 1
    if kernel == "tc":
        flash_attention.launches_tc += 1
    else:
        flash_attention.launches_fma += 1
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_fma = 0


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None, block_q: int = TILE,
                          block_k: int = TILE,
                          p_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernels' plain version: the reference ``_flash_kernel`` step by
    step — per q block, a sweep over kv blocks (those wholly above the
    diagonal skipped) with f32 running max, denominator and accumulator,
    masked scores at NEG_INF, and the final divide by max(l, 1e-30).

    ``p_dtype=None`` keeps P in f32, as the JAX kernel and the FMA kernel
    do. ``p_dtype=torch.bfloat16`` rounds P to bf16 just before ``P V``,
    where the tensor-core kernel does; the denominator still sums the
    unrounded P."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    dev = q.device
    qf = q.float().reshape(B, Hkv, rep, Sq, D)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    out = torch.empty((B, Hkv, rep, Sq, D), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, block_q):
        qb = qf[..., q0:q0 + block_q, :]
        nq = qb.shape[-2]
        q_end = q0 + nq - 1
        q_pos = torch.arange(q0, q0 + nq, device=dev)
        m = torch.full((B, Hkv, rep, nq, 1), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, rep, nq, 1), device=dev)
        acc = torch.zeros((B, Hkv, rep, nq, D), device=dev)
        for k0 in range(0, Skv, block_k):
            if causal and k0 > q_end:
                break
            kb = kf[..., k0:k0 + block_k, :]
            vb = vf[..., k0:k0 + block_k, :]
            s = (qb @ kb.transpose(-1, -2)) * scale
            if causal:
                k_pos = torch.arange(k0, k0 + kb.shape[-2], device=dev)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1, keepdim=True)
            pv = p if p_dtype is None else p.to(p_dtype).float()
            acc = corr * acc + pv @ vb
            m = m_new
        out[..., q0:q0 + nq, :] = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, scale: float | None = None,
                      chunk_q: int = 512, window: int = 0,
                      unroll: bool = False) -> torch.Tensor:
    """Query-chunked softmax attention in torch ops: O(Sq/ck * Sk) peak
    score memory instead of O(Sq*Sk). GQA by head grouping. window > 0
    adds a local band: q attends to k in (q_pos-window, q_pos]. ``unroll``
    is the reference's cost-extraction switch and changes nothing here."""
    del unroll
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if Sq % chunk_q:
        chunk_q = Sq  # degenerate small case
    dev = q.device
    qf = q.reshape(B, Hkv, rep, Sq, D)
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(Skv, device=dev)
    out = torch.empty((B, Hkv, rep, Sq, D), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, chunk_q):
        qc = qf[..., q0:q0 + chunk_q, :].float()
        s = torch.einsum("bhrqd,bhkd->bhrqk", qc, kf) * scale
        if causal or window:
            q_pos = q0 + torch.arange(chunk_q, device=dev)
            mask = torch.ones((chunk_q, Skv), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask, s, -torch.inf)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("bhrqk,bhkd->bhrqd", p, vf)
        out[..., q0:q0 + chunk_q, :] = o / p.sum(dim=-1, keepdim=True)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _launch(q, k, v, causal, scale, kernel):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D "
                         "(B, H, S, D)")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape
            or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match (B, Hq, Sq, D) / (B, Hkv, Skv, D), "
                         "Hq % Hkv == 0")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not supported "
                         f"by the kernel (one of {HEAD_DIMS})")
    if q.dtype not in DTYPE_IDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not all(t.device == q.device and t.stride(3) == 1 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be on one device "
                         "with a unit stride along D")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    o = torch.empty_like(q)       # q's layout: a transposed view stays one
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3])
    lib = build.library()
    if kernel == "tc":
        if Skv == 0 or any(st % 8 for st in strides) or any(
                t.data_ptr() % 16 for t in (q, k, v, o)):
            raise ValueError("flash_attention: the tensor-core kernel needs "
                             "Skv > 0, strides that are multiples of 8 "
                             "elements and 16-byte aligned tensors (TMA), "
                             f"got strides {strides}")
        rc = lib.repro_flash_attn_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Sq, Skv, D, *strides, float(scale),
            int(bool(causal)), build.stream_ptr(q))
    else:
        rc = lib.repro_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            DTYPE_IDS[q.dtype], B, Hq, Hkv, Sq, Skv, D, *strides,
            float(scale), int(bool(causal)), build.stream_ptr(q))
    build.check(rc, f"flash_attention ({kernel})")
    return o
