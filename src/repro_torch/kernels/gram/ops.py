"""K2 wrappers: G = D^T D (``gram``, K2a) and (D^T D, D^T B) in one read
of D (``gram_and_rhs``, K2b); port of ``repro/kernels/gram/ops.py``.

CUDA tensors go to ``csrc/gram.cu``: one tile kernel (8x4 outputs per
thread, a cp.async ring of 64-row panels) for both; ``gram_and_rhs``
hands it B as a second source, which rides the diagonal tiles' spare warp
for up to 16 columns and gets RHS tiles of its own past that. CPU
tensors run the plain versions
(:func:`gram_plain`, :func:`gram_and_rhs_plain`), which upcast one row
block at a time; any other device raises. The TPU wrapper padded D to
block multiples and mirrored the skipped lower blocks afterwards; the CUDA
kernel masks the ragged edges and writes the mirrored G itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

TILE = 64          # output tile edge in gram.cu
RMAX = 64          # RHS columns per launch in gram.cu
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def _acc(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _block_rows(D, block_rows):
    if block_rows:
        return block_rows
    from repro_torch.engine import autotune
    return autotune.chunked_block_rows(D.shape[0], D.shape[1], D.dtype,
                                       D.device)


def gram_plain(D: torch.Tensor, block_rows: int | None = None
               ) -> torch.Tensor:
    """The kernels' plain version: D^T D in accumulation precision,
    upcasting one row block at a time."""
    m, n = D.shape
    block_rows = _block_rows(D, block_rows)
    acc = _acc(D.dtype)
    G = torch.zeros((n, n), dtype=acc, device=D.device)
    for s in range(0, m, block_rows):
        blk = D[s:s + block_rows].to(acc)
        G += blk.T @ blk
    return G


def gram_and_rhs_plain(D: torch.Tensor, b: torch.Tensor,
                       block_rows: int | None = None):
    """(D^T D, D^T b), ``b`` (m,) or (m, r); c comes back (n,) or (n, r)."""
    m, n = D.shape
    block_rows = _block_rows(D, block_rows)
    acc = _acc(D.dtype)
    G = torch.zeros((n, n), dtype=acc, device=D.device)
    c = torch.zeros((n,) + tuple(b.shape[1:]), dtype=acc, device=D.device)
    for s in range(0, m, block_rows):
        blk = D[s:s + block_rows].to(acc)
        G += blk.T @ blk
        c += blk.T @ b[s:s + block_rows].to(acc)
    return G, c


def gram(D: torch.Tensor) -> torch.Tensor:
    """D^T D, f32, any (m, n) f32 or bf16 D."""
    if D.device.type == "cpu":
        return gram_plain(D)
    G, _ = _launch(D, None)
    gram.launches += 1
    return G


gram.launches = 0


def gram_and_rhs(D: torch.Tensor, b: torch.Tensor):
    """Fused (D^T D, D^T b) — one read of D, any (m, n). ``b`` may be
    (m,) or (m, r) stacked right-hand sides; c comes back (n,) or (n, r).
    B is taken in f32 whatever D's type."""
    if D.device.type == "cpu":
        return gram_and_rhs_plain(D, b)
    G, C = _launch(D, b)
    gram_and_rhs.launches += 1
    return G, C


gram_and_rhs.launches = 0


def _launch(D, b):
    if D.device.type != "cuda":
        raise ValueError(f"gram: no kernel for device {D.device}")
    if D.dtype not in DTYPE_IDS or D.dim() != 2 or not D.is_contiguous():
        raise ValueError(f"gram: expects a contiguous 2-D float32 or "
                         f"bfloat16 D, got {D.dtype} {tuple(D.shape)}")
    m, n = D.shape
    if b is not None:
        if b.device != D.device or b.shape[0] != m or b.dim() > 2:
            raise ValueError(f"gram_and_rhs: b must be (m,) or (m, r) on "
                             f"{D.device}, got {tuple(b.shape)} on "
                             f"{b.device}")
    nt = -(-n // TILE)
    ntiles = nt * (nt + 1) // 2
    from repro_torch.engine import autotune
    splits = autotune.gram_splits(m, n, D.dtype)
    rows_per_split = max(1, -(-m // splits))
    rows_per_split = -(-rows_per_split // autotune.GRAM_PANEL) \
        * autotune.GRAM_PANEL
    splits = max(1, -(-m // rows_per_split))
    dev = D.device
    G = torch.empty((n, n), dtype=torch.float32, device=dev)
    gpart = torch.empty((splits, ntiles, TILE, TILE), dtype=torch.float32,
                        device=dev)
    lib = build.library()
    stream = build.stream_ptr(D)
    dt = DTYPE_IDS[D.dtype]
    if b is None:
        rc = lib.repro_gram(D.data_ptr(), dt, None, m, n, 0, 1,
                            rows_per_split, splits, gpart.data_ptr(), None,
                            G.data_ptr(), None, 0, 0, stream)
        build.check(rc, "gram")
        return G, None
    squeeze = b.dim() == 1
    B = b.reshape(m, -1).to(torch.float32)
    r = B.shape[1]
    C = torch.empty((n, r), dtype=torch.float32, device=dev)
    cpart = torch.empty((splits, nt, TILE, RMAX), dtype=torch.float32,
                        device=dev)
    # RHS columns go in groups of RMAX; the first group's launch also
    # builds G, later groups (r > 64 only) re-read D for C alone.
    for g0 in range(0, max(r, 1), RMAX):
        Bg = B[:, g0:g0 + RMAX].contiguous()
        rc = lib.repro_gram(D.data_ptr(), dt, Bg.data_ptr(), m, n,
                            Bg.shape[1], int(g0 == 0), rows_per_split,
                            splits, gpart.data_ptr(), cpart.data_ptr(),
                            G.data_ptr(), C.data_ptr(), r, g0, stream)
        build.check(rc, "gram_and_rhs")
    return G, (C[:, 0] if squeeze else C)
