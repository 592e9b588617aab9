"""Public surface of the sparse transpose-reduction kernels; port of
``repro/kernels/spgram/ops.py``.

  * :func:`sparse_admm_iter_full` — K6, the fused sparse iteration body
    (y', lam', d, w, v) over a :class:`~repro_torch.data.sparse.BlockCSR`.
    CUDA data go to the hand-written kernel in ``csrc/spgram.cu``; CPU data
    run the plain version :func:`sparse_admm_iter_plain`; any other device
    raises. Each launch adds one to ``sparse_admm_iter_full.launches``. A
    build or launch error raises; nothing falls back.
  * :func:`matvec` / :func:`rmatvec` — D x and D^T u (torch bodies).
  * :func:`sparse_gram_rhs` — the Gram + RHS setup pass. The Gram is a HOST
    pass through scipy's compiled CSR matmul, as in the reference, so G has
    the reference's bits; the RHS is the CSC gather of ``rmatvec`` on the
    data's device. Without scipy the Gram is densified block by block and
    multiplied (``_gram_fallback``), on the data's device.
"""
from __future__ import annotations

import importlib.util
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.prox.ops import KIND_IDS
from repro_torch.kernels.prox.ref import _prox
from repro_torch.kernels.spgram import spgram

DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
SMEM_PER_BLOCK = 227 * 1024


class _KernelProx:
    """The kernels' prox for ``kind`` (``kernels/prox/ref.py::_prox``,
    the arithmetic ``prox_body<KIND>`` repeats), as a loss's ``prox``."""

    def __init__(self, kind: str, param: float):
        self.kind, self.param = kind, param

    def prox(self, z, delta, aux):
        a = aux if aux is not None else torch.zeros_like(z)
        return _prox(self.kind, z, float(delta), a, newton_iters=3,
                     param=self.param)


def sparse_admm_iter_plain(bcsr, aux, y, lam, x, *, kind: str,
                           delta: float, param: float = 0.0,
                           want_dual: bool = True):
    """K6's plain version: ``spgram.sparse_iterate`` with the kernels'
    prox for ``kind``."""
    return spgram.sparse_iterate(_KernelProx(kind, param), delta, bcsr, aux,
                                 y, lam, x, want_dual=want_dual)


def u_in_shared(bcsr, want_dual: bool = True) -> bool:
    """Whether K6 keeps the block's u vectors in shared memory (else it
    gathers them from y' and lam' in global memory / L2)."""
    r = 3 if want_dual else 1
    return 4 * (bcsr.n + r * bcsr.block_m) <= SMEM_PER_BLOCK


def sparse_admm_iter_full(bcsr, aux, y, lam, x, *, kind: str, delta: float,
                          param: float = 0.0, want_dual: bool = True):
    """Fused sparse iteration body returning (y', lam', d, w, v), w/v None
    when ``want_dual`` is False: Dx, the prox of ``kind`` at ``delta``,
    lam' = lam + Dx - y', and d = D^T(y' - lam'), w = D^T(y' - y),
    v = D^T lam' by gathers over each block's local CSC. f32 values or
    bf16, f32 iterates and accumulation."""
    if kind not in KIND_IDS:
        raise ValueError(f"no fused sparse iteration kernel for kind "
                         f"{kind!r}")
    if bcsr.device.type == "cpu":
        return sparse_admm_iter_plain(bcsr, aux, y, lam, x, kind=kind,
                                      delta=delta, param=param,
                                      want_dual=want_dual)
    _check(bcsr, aux, y, lam, x)
    m, n = bcsr.m, bcsr.n
    nb, bm, kp = bcsr.indices.shape
    if 4 * n > SMEM_PER_BLOCK:
        raise ValueError(f"sparse_admm_iter: n={n} columns do not fit the "
                         f"kernel's shared memory ({SMEM_PER_BLOCK} bytes)")
    dev = bcsr.device
    r = 3 if want_dual else 1
    y_new = torch.empty((m,), dtype=torch.float32, device=dev)
    lam_new = torch.empty_like(y_new)
    part = torch.empty((nb, 3, n), dtype=torch.float32, device=dev)
    out = torch.empty((r, n), dtype=torch.float32, device=dev)
    rc = build.library().repro_spgram_iter(
        bcsr.indices.data_ptr(), bcsr.values.data_ptr(),
        bcsr.col_indices.data_ptr(), bcsr.col_values.data_ptr(),
        DTYPE_IDS[bcsr.dtype], x.data_ptr(), y.data_ptr(), lam.data_ptr(),
        build.ptr(aux), y_new.data_ptr(), lam_new.data_ptr(),
        part.data_ptr(), out.data_ptr(), m, n, nb, bm, kp, bcsr.kc,
        KIND_IDS[kind], float(delta), float(param), int(want_dual),
        int(u_in_shared(bcsr, want_dual)), build.stream_ptr(y_new))
    build.check(rc, "sparse_admm_iter_full")
    sparse_admm_iter_full.launches += 1
    if not want_dual:
        return y_new, lam_new, out[0], None, None
    return y_new, lam_new, out[0], out[1], out[2]


sparse_admm_iter_full.launches = 0


def _check(bcsr, aux, y, lam, x):
    """Device, types, shapes and contiguity; the index ranges are the
    layout's own (``BlockCSR.from_coo``) and are not re-read per call."""
    dev = bcsr.device
    if dev.type != "cuda":
        raise ValueError(f"sparse_admm_iter: no kernel for device {dev}")
    nb, bm, kp = bcsr.indices.shape
    for name, a, shape, dts in (
            ("indices", bcsr.indices, (nb, bm, kp), (torch.int32,)),
            ("values", bcsr.values, (nb, bm, kp), tuple(DTYPE_IDS)),
            ("col_indices", bcsr.col_indices, (nb, bcsr.n, bcsr.kc),
             (torch.int32,)),
            ("col_values", bcsr.col_values, (nb, bcsr.n, bcsr.kc),
             (bcsr.dtype,))):
        if a.device != dev or a.dtype not in dts \
                or tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(
                f"sparse_admm_iter: {name} must be a contiguous {shape} "
                f"tensor of {dts} on {dev}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
    if nb * bm < bcsr.m:
        raise ValueError(f"sparse_admm_iter: {nb} blocks of {bm} rows do "
                         f"not hold m={bcsr.m} rows")
    for name, v, size in (("y", y, bcsr.m), ("lam", lam, bcsr.m),
                          ("aux", aux, bcsr.m), ("x", x, bcsr.n)):
        if v is None:
            if name != "aux":
                raise ValueError(f"sparse_admm_iter: {name} is required")
            continue
        if v.device != dev or v.dtype != torch.float32 or v.dim() != 1 \
                or v.numel() != size or not v.is_contiguous():
            raise ValueError(
                f"sparse_admm_iter: {name} must be a contiguous float32 "
                f"({size},) tensor on {dev}, got {v.dtype} "
                f"{tuple(v.shape)} on {v.device}")


def matvec(bcsr, x):
    """D @ x."""
    return spgram.sparse_matvec(bcsr, x)


def rmatvec(bcsr, u):
    """D^T u in accumulation precision; u is (m,) or (m, r)."""
    return spgram.sparse_rmatvec(bcsr, u)


def _gram_scipy(bcsr, acc):
    """D^T D through scipy's compiled CSR matmul on the host — O(nnz *
    nnz/row). Pad slots (and stored zeros) are stripped before the matmul:
    a zero value adds nothing to any Gram entry, and at low density the
    padding would multiply scipy's work by kp / mean-row-nnz."""
    import scipy.sparse
    nb, bm, kp = bcsr.indices.shape
    rows = nb * bm
    vals = bcsr.values.reshape(rows, kp).cpu()
    if vals.dtype not in (torch.float32, torch.float64):
        vals = vals.float()                     # scipy has no bf16
    data = vals.numpy()
    mask = data != 0
    counts = np.count_nonzero(mask, axis=1)
    indptr = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
    A = scipy.sparse.csr_matrix(
        (data[mask], bcsr.indices.reshape(rows, kp).cpu().numpy()[mask],
         indptr), shape=(rows, bcsr.n))
    G = (A.T @ A).toarray()
    return torch.from_numpy(G).to(device=bcsr.device, dtype=acc)


def _gram_fallback(bcsr, acc):
    """D^T D without scipy: each block densified on the data's device (one
    slot column at a time, distinct (row, column) pairs per write, no
    accumulating scatter) and multiplied, the block Grams added in block
    order."""
    nb, bm, kp = bcsr.indices.shape
    n = bcsr.n
    G = torch.zeros((n, n), dtype=acc, device=bcsr.device)
    rows = torch.arange(bm, device=bcsr.device)
    for b in range(nb):
        Db = torch.zeros((bm, n), dtype=acc, device=bcsr.device)
        idx = bcsr.indices[b].long()
        val = bcsr.values[b].to(acc)
        for k in range(kp):
            Db[rows, idx[:, k]] += val[:, k]
        G = G + Db.T @ Db
    return G


def sparse_gram_rhs(bcsr, b: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused sparse (D^T D, D^T b) setup pass; ``b`` may be None, (m,) or
    (m, r). The Gram is computed on the host (scipy) and lands on the
    data's device."""
    acc = spgram._acc(bcsr.dtype)
    if importlib.util.find_spec("scipy") is not None:
        G = _gram_scipy(bcsr, acc)
    else:
        G = _gram_fallback(bcsr, acc)
    c = None if b is None else rmatvec(bcsr, b)
    return G, c
