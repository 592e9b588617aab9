"""Plain-torch oracle for causal/GQA flash attention; port of
``repro/kernels/flash_attn/ref.py``."""
from __future__ import annotations

import torch


def mha_ref(q, k, v, *, causal: bool, scale: float | None = None):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D); GQA via head repeat.

    f32 softmax math; returns (B, Hq, Sq, D) in q.dtype.
    """
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    assert Hq % Hkv == 0
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kf = torch.repeat_interleave(k, rep, dim=1).float()
    vf = torch.repeat_interleave(v, rep, dim=1).float()
    qf = q.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        Skv = k.shape[2]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = torch.where(mask, s, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
