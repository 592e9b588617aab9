"""Plain-torch oracle for the fused prox/lambda update (paper Alg. 2 lines
7-8); port of ``repro/kernels/prox/ref.py``.

``logistic_prox_bracketed`` is a float32 mirror of the kernels' shorter
logistic chain (``csrc/prox.cuh``), for the tests and ``chip_smoke.py``;
the plain versions keep the reference's 40 bisection steps.
"""
from __future__ import annotations

import numpy as np
import torch

# csrc/prox.cuh: kLogisticNewtonSteps
LOGISTIC_NEWTON_STEPS = 5


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


def logistic_bracket(z, delta, aux):
    """Steps 1-2 of ``logistic_root`` (``csrc/prox.cuh``) in float32: the
    bracket [min(z, y1), max(z, y1)] with y1 = z + delta a sigmoid(-a z),
    cut to [z - delta, z + delta], then bisected until its width is at
    most 1. Returns (lo, hi)."""
    z, a = z.float(), aux.float()
    d = float(np.float32(delta))
    da = d * a
    y1 = z + da * (1.0 / (1.0 + torch.exp(a * z)))
    lo = torch.maximum(torch.minimum(z, y1), z - d)
    hi = torch.minimum(torch.maximum(z, y1), z + d)
    w, nb = np.float32(delta), 0
    while w > 1 and nb < 128:
        w, nb = w * np.float32(0.5), nb + 1
    for _ in range(nb):
        mid = 0.5 * (lo + hi)
        pos = (mid - z) * (1.0 + torch.exp(a * mid)) > da
        lo = torch.where(pos, lo, mid)
        hi = torch.where(pos, mid, hi)
    return lo, hi


def logistic_prox_bracketed(z, delta, aux, newton_iters=3):
    """The logistic prox as ``prox_body<kLogistic>`` computes it, step for
    step in float32: ``logistic_bracket``, Newton steps from the side of
    monotone convergence, then the reference's clamped Newton steps.
    Exact division where the kernel takes the fast one; torch's exp where
    it takes expf."""
    z, a = z.float(), aux.float()
    d = float(np.float32(delta))
    lo, hi = logistic_bracket(z, delta, a)
    y = torch.where(z > -0.5 * (d * a), torch.clamp(lo, min=0.0),
                    torch.clamp(hi, max=0.0))
    inv = float(np.float32(1) / np.float32(delta))
    a2 = a * a
    for _ in range(max(2, LOGISTIC_NEWTON_STEPS - newton_iters)):
        s = 1.0 / (1.0 + torch.exp(a * y))
        g = -a * s + (y - z) * inv
        h = a2 * s * (1.0 - s) + inv
        y = y - g / h
    for _ in range(newton_iters):
        s = 1.0 / (1.0 + torch.exp(a * y))
        g = -a * s + (y - z) / d
        h = s * (1.0 - s) + 1.0 / d
        y = y - torch.clamp(g / h, -d, d)
    return y


def logistic_root_band(z, delta, aux, steps=200):
    """The root y* of phi' by bisection in float64, and the float32
    rounding band around it: 2^-24 (max(1, |y*|) + 2 |a s| / phi''(y*)),
    s = sigmoid(-a y*): the spacing of floats at y* plus how far one
    rounding of each of the two terms of phi' moves the root. Returns
    (y*, band), float64."""
    z, a = z.double(), aux.double()
    lo, hi = z - delta, z + delta
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        pos = (-a * torch.sigmoid(-a * mid) + (mid - z) / delta) > 0
        lo = torch.where(pos, lo, mid)
        hi = torch.where(pos, mid, hi)
    y = 0.5 * (lo + hi)
    s = torch.sigmoid(-a * y)
    band = 2.0 ** -24 * (y.abs().clamp(min=1.0) + 2 * (a * s).abs()
                         / (a * a * s * (1 - s) + 1.0 / delta))
    return y, band


def prox_update_ref(kind, Dx, lam, aux, delta, newton_iters=8, param=0.0):
    """y = prox_f(Dx + lam, delta); lam' = lam + Dx - y. f32 math."""
    Dxf = Dx.float()
    lamf = lam.float()
    auxf = aux.float() if aux is not None else None
    z = Dxf + lamf
    y = _prox(kind, z, float(delta), auxf, newton_iters, param=param)
    return y, lamf + Dxf - y
