"""K1 wrapper: the fused prox/lambda update on 1-D streams of any length.

``prox_update`` launches the CUDA kernel (``csrc/prox.cu``) for CUDA
tensors and runs its plain version, :func:`prox_update_plain`, for CPU
tensors; any other device raises. Port of ``repro/kernels/prox/ops.py``:
the TPU kernel's (rows, 1024) lane padding is gone, the kernel masks the
ragged tail itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.prox.ref import prox_update_ref

KIND_IDS = {"logistic": 0, "hinge": 1, "l1": 2, "least_squares": 3,
            "quantile": 4}
THREADS = 256          # a block (csrc/prox.cu)
BLOCKS_PER_SM = 32     # the grid-stride launch's blocks, per SM of 132


def prox_update_plain(Dx, lam, aux, *, kind: str, delta: float,
                      newton_iters: int = 3, param: float = 0.0):
    """The kernel's plain-torch version (same arithmetic, f32)."""
    aux = aux if aux is not None else torch.zeros_like(Dx)
    return prox_update_ref(kind, Dx, lam, aux, delta,
                           newton_iters=newton_iters, param=param)


def prox_update(Dx: torch.Tensor, lam: torch.Tensor,
                aux: torch.Tensor | None, *, kind: str, delta: float,
                newton_iters: int = 3, param: float = 0.0):
    """y = prox_f(Dx + lam, delta); lam' = lam + Dx - y, fused. 1-D f32."""
    if kind not in KIND_IDS:
        raise ValueError(f"no prox kernel for kind {kind!r}")
    if Dx.device.type == "cpu":
        return prox_update_plain(Dx, lam, aux, kind=kind, delta=delta,
                                 newton_iters=newton_iters, param=param)
    vecs = [Dx, lam] + ([aux] if aux is not None else [])
    _check_vectors(vecs, Dx)
    y = torch.empty_like(Dx)
    lam_out = torch.empty_like(Dx)
    m = Dx.numel()
    blocks = max(1, min(-(-m // THREADS), 132 * BLOCKS_PER_SM))
    rc = build.library().repro_prox_update(
        Dx.data_ptr(), lam.data_ptr(), build.ptr(aux), y.data_ptr(),
        lam_out.data_ptr(), m, KIND_IDS[kind], float(delta),
        int(newton_iters), float(param), blocks, build.stream_ptr(Dx))
    build.check(rc, "prox_update")
    prox_update.launches += 1
    return y, lam_out


prox_update.launches = 0


def _check_vectors(vecs, like):
    for v in vecs:
        if v.device != like.device or v.device.type != "cuda":
            raise ValueError(f"prox_update: tensors must share one CUDA "
                             f"device, got {v.device} and {like.device}")
        if v.dtype != torch.float32 or v.dim() != 1 \
                or not v.is_contiguous() or v.numel() != like.numel():
            raise ValueError("prox_update: expects contiguous 1-D float32 "
                             f"tensors of one length, got {v.dtype} "
                             f"{tuple(v.shape)}")
