"""Plain-torch oracle for the fused prox/lambda update (paper Alg. 2 lines
7-8); port of ``repro/kernels/prox/ref.py``."""
from __future__ import annotations

import torch


def _prox(kind, z, delta, aux, newton_iters=3, bisect_iters=40, param=0.0):
    if kind == "logistic":
        # bisection on the monotone phi' over [z-d, z+d], Newton polish
        # (mirrors repro_torch.core.prox.logistic_prox_newton).
        lo, hi = z - delta, z + delta
        for _ in range(bisect_iters):
            mid = 0.5 * (lo + hi)
            pos = (-aux * torch.sigmoid(-aux * mid) + (mid - z) / delta) > 0
            lo = torch.where(pos, lo, mid)
            hi = torch.where(pos, mid, hi)
        y = 0.5 * (lo + hi)
        for _ in range(newton_iters):
            s = torch.sigmoid(-aux * y)
            g = -aux * s + (y - z) / delta
            h = s * (1.0 - s) + 1.0 / delta
            y = y - torch.clamp(g / h, -delta, delta)
        return y
    if kind == "hinge":
        return z + aux * torch.clamp(torch.clamp(1.0 - aux * z, max=delta),
                                     min=0.0)
    if kind == "l1":
        return torch.sign(z) * torch.clamp(torch.abs(z) - delta, min=0.0)
    if kind == "least_squares":
        return (z + delta * aux) / (1.0 + delta)
    if kind == "quantile":
        # pinball at level q = param: asymmetric soft-threshold on z - aux
        q = param
        r0 = z - aux
        r = torch.where(r0 > delta * q, r0 - delta * q,
                        torch.where(r0 < -delta * (1.0 - q),
                                    r0 + delta * (1.0 - q),
                                    torch.zeros_like(r0)))
        return aux + r
    raise ValueError(kind)


def prox_update_ref(kind, Dx, lam, aux, delta, newton_iters=8, param=0.0):
    """y = prox_f(Dx + lam, delta); lam' = lam + Dx - y. f32 math."""
    Dxf = Dx.float()
    lamf = lam.float()
    auxf = aux.float() if aux is not None else None
    z = Dxf + lamf
    y = _prox(kind, z, float(delta), auxf, newton_iters, param=param)
    return y, lamf + Dxf - y
