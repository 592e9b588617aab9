"""K3 wrappers: the fused iteration body returning (y', lam', d, w, v,
stats); port of ``repro/kernels/admm_iter/ops.py``, whose body returns the
first five. ``stats`` is the stopping rule's four sums over the rows, in
the order (r_sq, dx_sq, y_sq, obj), with Dx' = (lam' - lam) + y':
sum (lam' - lam)^2, sum Dx'^2, sum y'^2 and ``scale`` * sum f(Dx'), f the
kind's bare loss value (``csrc/prox.cuh::value_body``).

CUDA tensors go to one of K3's two kernels in ``csrc/admm_iter.cu``; CPU
tensors run the plain version :func:`admm_iter_plain`; any other device
raises. The kernel is picked by :func:`route`, by n and dtype alone
(``engine/autotune.py::iter_grid``):

* ``"ring"`` for n <= 512 (the main path's n = 307): a producer thread
  streams panels of up to 32 rows through a ring of shared-memory stages
  with bulk copies, and every consumer warp runs Dx, the prox and the
  sweep with a lane per row;
* ``"wide"`` for larger n: panels staged by the whole CTA, the prox on one
  warp, up to n ~ 11k.

Each launch adds one to ``admm_iter_full.launches`` and to its route's
count, ``admm_iter_full.launches_ring`` or ``launches_wide``. A build or
launch error raises; nothing falls back. The TPU wrapper zero-padded the
rows to a block multiple; the CUDA kernels mask the ragged end of m, so no
pad row exists.
"""
from __future__ import annotations

import torch

from repro_torch.core.prox import loss_from_spec
from repro_torch.kernels import build
from repro_torch.kernels.prox.ops import KIND_IDS
from repro_torch.kernels.prox.ref import _prox

DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def admm_iter_plain(D, aux, y, lam, x, *, kind: str, delta: float,
                    param: float = 0.0, scale: float = 1.0,
                    block_rows: int | None = None):
    """The kernel's plain version. Rows go in blocks, each upcast to f32
    on its own (a bf16 D is never upcast whole); the three transpose
    reductions of a block are one product against the stacked
    (y'-lam', y'-y, lam'), and its four stopping sums are the torch
    expressions of ``engine/engine.py::stop_sums`` with the kind's bare
    loss (C and mu 1), obj times ``scale``."""
    m, n = D.shape
    if not block_rows:
        from repro_torch.engine import autotune
        block_rows = autotune.chunked_block_rows(m, n, D.dtype, D.device)
    xf = x.float()
    y_new = torch.empty((m,), dtype=torch.float32, device=D.device)
    lam_new = torch.empty_like(y_new)
    dwv = torch.zeros((n, 3), dtype=torch.float32, device=D.device)
    stats = torch.zeros((4,), dtype=torch.float32, device=D.device)
    value = loss_from_spec({"name": kind, "q": param}).value
    for s in range(0, m, block_rows):
        e = min(m, s + block_rows)
        Db = D[s:e].float()
        Dx = Db @ xf
        lb = lam[s:e]
        ab = aux[s:e] if aux is not None else torch.zeros_like(lb)
        yb = _prox(kind, Dx + lb, float(delta), ab, newton_iters=3,
                   param=param)
        nb = lb + Dx - yb
        y_new[s:e] = yb
        lam_new[s:e] = nb
        dwv += Db.T @ torch.stack([yb - nb, yb - y[s:e], nb], dim=1)
        Dxr = nb - lb + yb
        stats += torch.stack([torch.sum((nb - lb) ** 2), torch.sum(Dxr * Dxr),
                              torch.sum(yb * yb),
                              value(Dxr, ab)])
    stats[3] = scale * stats[3]
    return y_new, lam_new, dwv[:, 0], dwv[:, 1], dwv[:, 2], stats


def admm_iter_full(D, aux, y, lam, x, *, kind: str, delta: float,
                   param: float = 0.0, scale: float = 1.0):
    """Fused iteration body returning (y', lam', d, w, v, stats).

    d = D^T(y' - lam') feeds the next x-update (paper Alg. 2 line 6);
    w = D^T(y' - y) and v = D^T lam' feed Boyd's dual residual and
    tolerance without a second pass over D. Differences are formed in
    registers before the reduction. ``stats`` (4,) is (r_sq, dx_sq, y_sq,
    obj), each lane's rows Kahan-summed, then in a fixed order over the
    lanes, warps and CTAs; ``scale`` multiplies obj (hinge's C, l1's mu).
    d, w, v and stats are views of one (3n + 4,) tensor."""
    if kind not in KIND_IDS:
        raise ValueError(f"no fused iteration kernel for kind {kind!r}")
    if D.device.type == "cpu":
        return admm_iter_plain(D, aux, y, lam, x, kind=kind, delta=delta,
                               param=param, scale=scale)
    _check(D, aux, y, lam, x)
    m, n = D.shape
    from repro_torch.engine import autotune
    grid = autotune.iter_grid(m, n, D.dtype)
    rows_per_cta = -(-m // grid.ctas)
    rows_per_cta = -(-rows_per_cta // grid.rows) * grid.rows
    nctas = -(-m // rows_per_cta)
    dev = D.device
    y_new = torch.empty((m,), dtype=torch.float32, device=dev)
    lam_new = torch.empty_like(y_new)
    part = torch.empty((nctas, 3 * n + 4), dtype=torch.float32, device=dev)
    out = torch.empty((3 * n + 4,), dtype=torch.float32, device=dev)
    lib = build.library()
    args = (D.data_ptr(), DTYPE_IDS[D.dtype], x.data_ptr(), y.data_ptr(),
            lam.data_ptr(), build.ptr(aux), y_new.data_ptr(),
            lam_new.data_ptr(), part.data_ptr(), out.data_ptr(), m, n)
    tail = (KIND_IDS[kind], float(delta), float(param), float(scale),
            build.stream_ptr(D))
    if grid.route == "ring":
        rc = lib.repro_admm_iter_ring(*args, rows_per_cta, grid.rows, nctas,
                                      grid.stages, grid.warps, *tail)
    else:
        rc = lib.repro_admm_iter(*args, grid.rows, rows_per_cta, nctas,
                                 *tail)
    build.check(rc, "admm_iter_full")
    admm_iter_full.launches += 1
    if grid.route == "ring":
        admm_iter_full.launches_ring += 1
    else:
        admm_iter_full.launches_wide += 1
    d, w, v, stats = out.split((n, n, n, 4))
    return y_new, lam_new, d, w, v, stats


admm_iter_full.launches = 0
admm_iter_full.launches_ring = 0
admm_iter_full.launches_wide = 0


def route(m: int, n: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call on an (m, n) D goes to: ``"ring"`` for
    n <= 512, else ``"wide"`` (or what a pinned grid says)."""
    from repro_torch.engine import autotune
    return autotune.iter_grid(m, n, dtype).route


def admm_iter(D, aux, y, lam, x, *, kind: str, delta: float):
    """Back-compat 3-tuple surface: (y', lam', d)."""
    y_new, lam_new, d = admm_iter_full(D, aux, y, lam, x, kind=kind,
                                       delta=delta)[:3]
    return y_new, lam_new, d


def _check(D, aux, y, lam, x):
    if D.device.type != "cuda":
        raise ValueError(f"admm_iter: no kernel for device {D.device}")
    if D.dtype not in DTYPE_IDS or D.dim() != 2 or not D.is_contiguous():
        raise ValueError(f"admm_iter: expects a contiguous 2-D float32 or "
                         f"bfloat16 D, got {D.dtype} {tuple(D.shape)}")
    m, n = D.shape
    if m == 0:
        raise ValueError("admm_iter: D has no rows")
    for name, v, size in (("y", y, m), ("lam", lam, m), ("aux", aux, m),
                          ("x", x, n)):
        if v is None:
            if name != "aux":
                raise ValueError(f"admm_iter: {name} is required")
            continue
        if v.device != D.device or v.dtype != torch.float32 \
                or v.dim() != 1 or v.numel() != size \
                or not v.is_contiguous():
            raise ValueError(
                f"admm_iter: {name} must be a contiguous float32 ({size},) "
                f"tensor on {D.device}, got {v.dtype} {tuple(v.shape)} on "
                f"{v.device}")
