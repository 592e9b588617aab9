"""Block-size model for the iteration engine; port of
``repro/engine/autotune.py`` with the budgets re-derived for the card.

Model-driven, not search-driven: shapes are picked from the budget math
below and memoized per ``(kind, m, n, dtype)`` so every caller of the
engine agrees on them. The cache is a plain dict: inspectable in tests and
overridable by pinning an entry before the first resolve.

Budgets:

  * CUDA fused iteration (K3, ``csrc/admm_iter.cu``): a CTA stages an
    (R, n) f32 panel plus x and the (3, n) accumulators in shared memory,
    ``(R n + 4 n + 128) * 4`` bytes. A block may use 227 KB
    (``SMEM_PER_BLOCK``); the model keeps a CTA under ``SMEM_TARGET`` so
    that four fit on one SM and the loads of one overlap the prox of
    another, and takes R = 32 (one prox lane per row of warp 0) where that
    fits. The grid is ``CTAS_PER_SM * SM_COUNT`` CTAs; it depends on the
    shapes only, so the order of the reductions, and hence the bits, do
    not depend on the card.
  * CUDA Gram (K2, ``csrc/gram.cu``): 64x64 output tiles of 256 threads,
    4x4 per thread (16 accumulators + 16 partials + 16 RHS registers,
    well inside 65,536 registers per SM at 255 a thread), 24 KB of static
    shared memory. m is split so that tiles x splits is about
    ``GRAM_CTAS`` CTAs.
  * chunked backend (a Python loop of torch ops over row blocks): on the
    CPU, ``CACHE_BUDGET`` stands for the last-level-cache slice one core
    keeps hot between the Dx and D^T products of a block; on the card,
    ``DEVICE_BLOCK_BUDGET`` bounds the f32 upcast of one block while
    keeping the loop to tens of launches.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

SMEM_PER_BLOCK = 227 * 1024        # bytes of shared memory a block may use
SM_COUNT = 132                     # H100 SXM
SMEM_TARGET = 56 * 1024            # per K3 CTA: four CTAs per SM
CTAS_PER_SM = 4
GRAM_CTAS = 8 * SM_COUNT
# Last-level-cache slice assumed hot per chunked stream on the CPU.
CACHE_BUDGET = 2 * 1024 * 1024
# f32 bytes of one upcast row block for torch-op loops over a CUDA D.
DEVICE_BLOCK_BUDGET = 256 * 1024 * 1024

# (kind, m, n, dtype_name[, device]) -> chosen block size(s); pin to override.
CACHE: Dict[Tuple, Tuple] = {}


def _dsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _clamp_multiple(value: int, mult: int, lo: int, hi: int) -> int:
    v = max(lo, min(hi, value))
    return max(mult, (v // mult) * mult)


def _row_cap(m: int, mult: int) -> int:
    """Never pick a row block taller than m rounded up to the tile size."""
    return -(-m // mult) * mult


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def iter_grid(m: int, n: int, dtype) -> Tuple[int, int]:
    """(rows per panel R, CTAs) for the fused CUDA iteration kernel."""
    key = ("iter", int(m), int(n), _name(dtype))
    if key not in CACHE:
        fixed = (4 * n + 128) * 4
        budget = SMEM_TARGET if fixed + n * 4 <= SMEM_TARGET \
            else SMEM_PER_BLOCK
        R = min(32, (budget - fixed) // (4 * n))
        if R < 1:
            raise ValueError(
                f"n={n} columns do not fit the fused iteration kernel's "
                f"shared memory ({SMEM_PER_BLOCK} bytes per block)")
        CACHE[key] = (R, max(1, min(CTAS_PER_SM * SM_COUNT, -(-m // R))))
    return CACHE[key]


def gram_splits(m: int, n: int, dtype) -> int:
    """Row splits of the CUDA Gram kernel (grid = upper tiles x splits)."""
    key = ("gram", int(m), int(n), _name(dtype))
    if key not in CACHE:
        nt = -(-n // 64)
        tiles = nt * (nt + 1) // 2
        CACHE[key] = (max(1, min(-(-GRAM_CTAS // tiles), -(-m // 32))),)
    return CACHE[key][0]


def chunked_block_rows(m: int, n: int, dtype, device="cpu") -> int:
    """Row-block length for the torch-op row loops (chunked backend,
    streaming rmatvec)."""
    dev = torch.device(device).type
    key = ("chunked", int(m), int(n), _name(dtype), dev)
    if key not in CACHE:
        if dev == "cpu":
            rows = CACHE_BUDGET // max(1, n * _dsize(dtype))
            hi = 8192
        else:
            rows = DEVICE_BLOCK_BUDGET // max(1, n * 4)
            hi = 1 << 22
        cap = _row_cap(m, 8)
        CACHE[key] = (_clamp_multiple(rows, 8, min(128, cap),
                                      min(hi, cap)),)
    return CACHE[key][0]
