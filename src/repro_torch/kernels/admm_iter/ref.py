"""Plain-torch oracle for the fused ADMM iteration kernel; port of
``repro/kernels/admm_iter/ref.py``."""
from __future__ import annotations

from repro_torch.kernels.prox.ref import _prox


def admm_iter_ref(D, aux, y, lam, x, *, kind: str, delta: float):
    """One unwrapped-ADMM iteration body (paper Alg. 2 lines 5-8, local
    part), given the incoming solve result x:
        Dx   = D @ x
        y'   = prox_f(Dx + lam, delta)
        lam' = lam + Dx - y'
        d    = D^T (y' - lam')
    Returns (y', lam', d). f32 math regardless of D's dtype.
    """
    Df = D.float()
    Dx = Df @ x.float()
    z = Dx + lam
    y_new = _prox(kind, z, float(delta), aux)
    lam_new = lam + Dx - y_new
    d = Df.T @ (y_new - lam_new)
    return y_new, lam_new, d
