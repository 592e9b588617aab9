"""Plain-torch oracle for the WKV kernel: the exact per-step recurrence;
port of ``repro/kernels/wkv/ref.py``."""
from __future__ import annotations

import torch


def wkv_ref(r, k, v, w_log, u):
    """r/k/v/w_log: (T, hd) single head; u: (hd,). Per-step form:
        y_t = r_t (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    Returns (y (T, hd), S_final (hd, hd)). f32."""
    T, hd = r.shape
    r, k, v, u = r.float(), k.float(), v.float(), u.float()
    S = torch.zeros((hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    w = torch.exp(w_log.float())
    for t in range(T):
        kv = torch.outer(k[t], v[t])
        ys.append(r[t] @ (S + u[:, None] * kv))
        S = w[t][:, None] * S + kv
    return torch.stack(ys), S
