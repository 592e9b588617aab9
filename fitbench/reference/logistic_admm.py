"""Plain reference for the logistic fits: unwrapped ADMM with transpose
reduction (paper Alg. 1 / 2) in float64, written from the paper, with no
code of the program.

    x^{k+1}   = (D^T D)^{-1} D^T (y^k - lam^k)
    y^{k+1}   = prox_f(D x^{k+1} + lam^k, 1 / tau)
    lam^{k+1} = lam^k + D x^{k+1} - y^{k+1}

with f(y) = sum log(1 + exp(-l y)) and Boyd's stopping rule (eps_rel,
eps_abs) on r = ||lam^{k+1} - lam^k|| and s = tau ||D^T (y^{k+1} - y^k)||.
D stays in the benchmark's float32 tensor and is read in row blocks, each
block widened to float64 alone, so the reference fits beside the data.
Where a ``torch.distributed`` group is up, each rank takes its share of
the rows and the sums are all-reduced in float64. The result is x^k of the
iteration at which the rule first holds, or of ``max_iters``.
"""
from __future__ import annotations

import math

import torch

BLOCK_ROWS = 1 << 21


def prox_logistic(z, labels, delta, bisect_steps: int = 4,
                  newton_steps: int = 5):
    """argmin_y log(1 + exp(-l y)) + (y - z)^2 / (2 delta), elementwise:
    the root of phi'(y) = -l sigmoid(-l y) + (y - z) / delta, which is
    increasing and changes sign on [z - delta, z + delta]. Bisection first,
    then Newton steps clamped to the bracket, which each step narrows."""
    lo, hi = z - delta, z + delta

    def dphi(y):
        return -labels * torch.sigmoid(-labels * y) + (y - z) / delta

    for _ in range(bisect_steps):
        mid = 0.5 * (lo + hi)
        pos = dphi(mid) > 0
        lo, hi = torch.where(pos, lo, mid), torch.where(pos, mid, hi)
    y = 0.5 * (lo + hi)
    for _ in range(newton_steps):
        s = torch.sigmoid(-labels * y)
        g = -labels * s + (y - z) / delta
        pos = g > 0
        lo, hi = torch.where(pos, lo, y), torch.where(pos, y, hi)
        y = torch.clamp(y - g / (s * (1.0 - s) + 1.0 / delta), lo, hi)
    return y


def _blocks(lo, hi):
    return [(s, min(hi, s + BLOCK_ROWS)) for s in range(lo, hi, BLOCK_ROWS)]


def _summed(t):
    """``t`` summed over the ranks of the default group, if one is up."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.all_reduce(t)
    return t


def _share(m):
    """This rank's rows [lo, hi) of m."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 0, m
    w, r = dist.get_world_size(), dist.get_rank()
    per = -(-m // w)
    return min(m, r * per), min(m, (r + 1) * per)


def solve(cfg: dict, inputs: dict, device) -> dict:
    """{"x": float64 (n,) on the CPU, "G": the float64 Gram of all the rows
    on the CPU, "iters": the iteration at which the rule first holds, else
    max_iters, "stopped": whether it held, "cond": cond(G)}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D = inputs["D"].reshape(-1, inputs["D"].shape[-1])
    lab = inputs["labels"].reshape(-1)
    m, n = D.shape
    f64 = torch.float64
    tau = float(cfg["tau"])
    delta = 1.0 / tau
    eps_rel, eps_abs = float(cfg["eps_rel"]), float(cfg["eps_abs"])
    max_iters = int(cfg["max_iters"])
    lo, hi = _share(m)
    blocks = _blocks(lo, hi)
    G = torch.zeros((n, n), dtype=f64, device=device)
    for s, e in blocks:
        Db = D[s:e].to(f64)
        G += Db.T @ Db
    G = _summed(G)
    L = torch.linalg.cholesky(G)
    y = torch.zeros(hi - lo, dtype=f64, device=device)
    lam = torch.zeros(hi - lo, dtype=f64, device=device)
    d = torch.zeros(n, dtype=f64, device=device)
    x = d
    stopped, k = False, 0
    for k in range(1, max_iters + 1):
        x = torch.cholesky_solve(d[:, None], L)[:, 0]
        acc = torch.zeros(3 * n + 3, dtype=f64, device=device)
        dwv, sq = acc[:3 * n].view(n, 3), acc[3 * n:]
        for s, e in blocks:
            Db = D[s:e].to(f64)
            dx = Db @ x
            lam_old, y_old = lam[s - lo:e - lo], y[s - lo:e - lo]
            z = dx + lam_old
            y_new = prox_logistic(z, lab[s:e].to(f64), delta)
            lam_new = z - y_new
            dwv += Db.T @ torch.stack(
                [y_new - lam_new, y_new - y_old, lam_new], dim=1)
            sq += torch.stack([((lam_new - lam_old) ** 2).sum(),
                               (dx * dx).sum(), (y_new * y_new).sum()])
            y[s - lo:e - lo], lam[s - lo:e - lo] = y_new, lam_new
        _summed(acc)
        d = dwv[:, 0]
        r, ndx, ny = torch.sqrt(sq).tolist()
        s_dual = tau * float(torch.linalg.norm(dwv[:, 1]))
        eps_pri = math.sqrt(m) * eps_abs + eps_rel * max(ndx, ny)
        eps_dual = math.sqrt(n) * eps_abs + \
            eps_rel * tau * float(torch.linalg.norm(dwv[:, 2]))
        if r <= eps_pri and s_dual <= eps_dual:
            stopped = True
            break
    ev = torch.linalg.eigvalsh(G)
    return {"x": x.cpu(), "G": G.cpu(), "iters": k, "stopped": stopped,
            "cond": float(ev[-1] / ev[0])}


def judge(cfg: dict, ref: dict, answers) -> list:
    """Per answer ({"x", "iters"}, x on the CPU), in the space of the fitted
    margins D x, where the float64 Gram G gives the norm ||D v||^2 =
    v^T G v, and e = x - x_ref:

    - ``fit_err`` = ||D e|| / ||D x_ref||, the margins' error;
    - ``dir_err`` = min_c ||D (x - c x_ref)|| / ||D x_ref||, the margins'
      error once their scale is matched: the fitted direction's error;
    - ``scale_err`` = |e^T G x_ref| / x_ref^T G x_ref, the part of e along
      x_ref (fit_err^2 = dir_err^2 + scale_err^2);
    - ``x_err`` = ||e|| / ||x_ref||;
    - ``iters_gap``, the distance of the iteration count from the
      reference's.

    A NaN in x reads NaN in every norm."""
    xr, G = ref["x"], ref["G"]
    g_xr = G @ xr
    ref_sq = float(xr @ g_xr)
    nr = float(torch.linalg.norm(xr))
    out = []
    for a in answers:
        e = torch.as_tensor(a["x"]).to(torch.float64) - xr
        fit_sq = float(e @ G @ e) / ref_sq
        along = float(e @ g_xr) / ref_sq
        # a negative rounding of a square reads 0; NaN stays NaN
        out.append({"fit_err": math.sqrt(fit_sq) if fit_sq > 0 else
                    fit_sq if fit_sq != fit_sq else 0.0,
                    "dir_err": math.sqrt(max(fit_sq - along * along, 0.0))
                    if fit_sq == fit_sq else fit_sq,
                    "scale_err": abs(along),
                    "x_err": float(torch.linalg.norm(e)) / nr,
                    "iters_gap": abs(int(a["iters"]) - ref["iters"])})
    return out
