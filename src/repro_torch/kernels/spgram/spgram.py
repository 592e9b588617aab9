"""Sparse transpose-reduction bodies over padded block-CSR, in plain torch;
port of ``repro/kernels/spgram/spgram.py``.

The sparse analogue of the fused dense bodies (``kernels/admm_iter``,
``kernels/gram``): the accumulation side of every transpose reduction is a
GATHER over the per-block local CSC, never a scatter-add (a scatter adds
with float atomics on the card, in an order that changes from run to run).
Per block:

  * ``Dx``  — gather ``x`` at the CSR column ids, multiply, row-sum;
  * prox / lam-update — elementwise on the (block_m,) vectors;
  * d/w/v  — gather the block's u vectors (y'-lam', y'-y, lam') at the
              local-CSC row ids, multiply by the CSC values, column-sum: a
              full (n,) partial per block, the partials added in block
              order, as the reference's ``lax.scan`` adds them.

Everything accumulates in f32 (f64 for f64 data) whatever the values'
residency dtype; the w/v differences are formed on the block vectors BEFORE
the reduction (the anti-cancellation rule of the dense kernels).

The reference scanned one block at a time; these bodies take a chunk of
blocks per torch call (``_chunks``), so a chunk's gathers stay within
``autotune.DEVICE_BLOCK_BUDGET`` bytes. The engine's kernel path on the
card is K6 (``kernels/spgram/ops.py``, ``csrc/spgram.cu``); these bodies are
its plain version and the engine's body for the other loss kinds.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _acc(dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _gather(src: Tensor, idx: Tensor) -> Tensor:
    """``src[idx]`` along dim 0 for an int32 or int64 ``idx`` of any
    shape; ``src`` (L,) or (L, r) gives idx.shape or idx.shape + (r,)."""
    out = src.index_select(0, idx.reshape(-1))
    return out.reshape(tuple(idx.shape) + tuple(src.shape[1:]))


def block_matvec(indices: Tensor, values: Tensor, x: Tensor) -> Tensor:
    """D_b @ x by CSR gather: (..., bm, kp) -> (..., bm)."""
    acc = _acc(values.dtype)
    return torch.sum(values.to(acc) * _gather(x.to(acc), indices), dim=-1)


def block_rmatvec(col_indices: Tensor, col_values: Tensor,
                  u: Tensor) -> Tensor:
    """One block's D_b^T u_b by local-CSC gather: (n, kc) x (bm,) -> (n,);
    ``u`` may also be (bm, r) stacked — returns (n, r)."""
    acc = _acc(col_values.dtype)
    g = _gather(u.to(acc), col_indices)              # (n, kc[, r])
    if u.dim() == 1:
        return torch.sum(col_values.to(acc) * g, dim=-1)
    return torch.einsum("nk,nkr->nr", col_values.to(acc), g)


def _chunk_rmatvec(col_indices: Tensor, col_values: Tensor,
                   us: Tensor) -> Tensor:
    """``block_rmatvec`` of each block of a chunk: (cb, n, kc) CSC and
    (cb, bm, r) vectors -> (cb, n, r) partials."""
    cb, bm, r = us.shape
    acc = _acc(col_values.dtype)
    offs = torch.arange(cb, device=us.device).view(cb, 1, 1) * bm
    g = _gather(us.reshape(cb * bm, r).to(acc), col_indices.long() + offs)
    return torch.einsum("bnk,bnkr->bnr", col_values.to(acc), g)


def blocked_vector(x: Tensor, nb: int, bm: int) -> Tensor:
    """(m,) or (m, r) -> (nb, bm[, r]) zero-padded — the iterate layout of
    the blocks."""
    pad = nb * bm - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x.reshape((nb, bm) + tuple(x.shape[1:]))


def _chunks(bcsr, per_row_bytes: int):
    """Block ranges [s, e) whose gathers take at most
    ``autotune.DEVICE_BLOCK_BUDGET`` bytes (at least one block each)."""
    from repro_torch.engine import autotune
    nb, bm, kp = bcsr.indices.shape
    per_block = 4 * (2 * bm * kp + 2 * bcsr.n * bcsr.kc) + bm * per_row_bytes
    cb = max(1, autotune.DEVICE_BLOCK_BUDGET // max(1, per_block))
    return [(s, min(nb, s + cb)) for s in range(0, nb, cb)]


def _add_in_order(acc: Tensor, parts: Tensor) -> Tensor:
    """acc + parts[0] + parts[1] + ..., in block order."""
    for p in parts:
        acc = acc + p
    return acc


def sparse_iterate(loss, delta, bcsr, aux: Optional[Tensor], y: Tensor,
                   lam: Tensor, x: Tensor, want_dual: bool = True
                   ) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor],
                              Optional[Tensor]]:
    """The full fused iteration: Dx, ``loss.prox``, the lam-update and the
    gather-based d (and w, v when ``want_dual``) over every block.
    Returns (y', lam', d, w, v), w/v None when ``want_dual`` is False."""
    m, n = bcsr.m, bcsr.n
    nb, bm, _ = bcsr.indices.shape
    acc = _acc(bcsr.dtype)
    xc = x.to(acc)
    ys = blocked_vector(y, nb, bm)
    lams = blocked_vector(lam, nb, bm)
    auxs = blocked_vector(aux, nb, bm) if aux is not None else None
    y_out = torch.empty((nb, bm), dtype=acc, device=y.device)
    lam_out = torch.empty_like(y_out)
    r = 3 if want_dual else 1
    dwv = torch.zeros((n, r), dtype=acc, device=y.device)
    for s, e in _chunks(bcsr, 4 * r * 4):
        Dx = block_matvec(bcsr.indices[s:e], bcsr.values[s:e], xc)
        lb = lams[s:e]
        y_nb = loss.prox(Dx + lb, delta,
                         auxs[s:e] if auxs is not None else None)
        l_nb = lb + Dx - y_nb
        y_out[s:e] = y_nb
        lam_out[s:e] = l_nb
        us = [y_nb - l_nb] + ([y_nb - ys[s:e], l_nb] if want_dual else [])
        parts = _chunk_rmatvec(bcsr.col_indices[s:e], bcsr.col_values[s:e],
                               torch.stack(us, dim=-1))
        dwv = _add_in_order(dwv, parts)
    y_new, lam_new = y_out.reshape(-1)[:m], lam_out.reshape(-1)[:m]
    if not want_dual:
        return y_new, lam_new, dwv[:, 0], None, None
    return y_new, lam_new, dwv[:, 0], dwv[:, 1], dwv[:, 2]


def sparse_matvec(bcsr, x: Tensor) -> Tensor:
    """D @ x over the blocks — warm starts and result lines."""
    xc = x.to(_acc(bcsr.dtype))
    out = [block_matvec(bcsr.indices[s:e], bcsr.values[s:e], xc)
           for s, e in _chunks(bcsr, 0)]
    return torch.cat(out).reshape(-1)[:bcsr.m]


def sparse_rmatvec(bcsr, u: Tensor) -> Tensor:
    """D^T u over the blocks, partials added in block order; ``u`` is
    (m,) or (m, r)."""
    nb, bm, _ = bcsr.indices.shape
    us = blocked_vector(u, nb, bm)
    vec = u.dim() == 1
    if vec:
        us = us.unsqueeze(-1)
    r = us.shape[-1]
    c = torch.zeros((bcsr.n, r), dtype=_acc(bcsr.dtype), device=u.device)
    for s, e in _chunks(bcsr, 4 * r * 2):
        c = _add_in_order(c, _chunk_rmatvec(bcsr.col_indices[s:e],
                                            bcsr.col_values[s:e], us[s:e]))
    return c[:, 0] if vec else c
