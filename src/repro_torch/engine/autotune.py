"""Block-size model for the iteration engine; port of
``repro/engine/autotune.py`` with the budgets re-derived for the card.

Model-driven, not search-driven: shapes are picked from the budget math
below and memoized per ``(kind, m, n, dtype)`` so every caller of the
engine agrees on them. The cache is a plain dict: inspectable in tests and
overridable by pinning an entry before the first resolve.

Budgets:

  * CUDA fused iteration (K3, ``csrc/admm_iter.cu``), two routes picked by
    n and dtype alone (``iter_grid``):
      - ``"ring"`` for n <= ``RING_MAX_N``: one CTA per SM of W consumer
        warps and one producer warp; panels of R <= 32 rows (a lane per
        row) stream through a ring of S shared-memory stages of
        ``R n dsize + 16`` bytes each, beside x and the warps' row weights
        (``ring_smem``), within one block's 227 KB (``SMEM_PER_BLOCK``).
        W warps hold a stage each while S - W stages are in flight; W and
        R balance the two rates (``_ring_grid``) with S as large as fits,
        at most 16 (n = 307: W 5, R 20, S 9 in f32; W 7, R 32, S 11 in
        bf16);
      - ``"wide"`` for larger n: 256 threads stage an (R, n) f32 panel plus
        x and the (3, n) accumulators, ``(R n + 4 n + 128) * 4`` bytes; the
        model keeps a CTA under ``WIDE_SMEM_TARGET`` where R = 1 fits, so
        that four share an SM, and takes R = 32 where that fits; n past
        ~11k does not fit even at R = 1 and raises.
    The grid depends on the shapes only (``SM_COUNT`` is a constant, not
    the card's), so the order of the reductions, and hence the bits, do
    not depend on the card.
  * CUDA Gram (K2a and K2b, ``csrc/gram.cu``): 64x64 output tiles of 128
    threads, 8x4 per thread (32 accumulators + 32 partials), and a ring of
    two 64-row panels of two 64-column stripes, 64 KB: three CTAs per SM.
    m is split in multiples of ``GRAM_PANEL`` rows so that tiles x splits
    is at most ``GRAM_CTAS``, four full waves of three CTAs per SM. K2b
    (Gram + RHS) takes the same splits; past 16 RHS columns its grid adds
    one RHS tile per column stripe and split.
  * sparse data (``BlockCSR``, ``sparse_block_m``): the reference's
    2 MB budget for a block's CSR and CSC bytes, so the layout, and with it
    the order of every block sum, is the reference's on both devices.
  * chunked backend (a Python loop of torch ops over row blocks): on the
    CPU, ``CACHE_BUDGET`` stands for the last-level-cache slice one core
    keeps hot between the Dx and D^T products of a block; on the card,
    ``DEVICE_BLOCK_BUDGET`` bounds the f32 upcast of one block while
    keeping the loop to tens of launches.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

SMEM_PER_BLOCK = 227 * 1024        # bytes of shared memory a block may use
SM_COUNT = 132                     # H100 SXM
RING_ROWS = 32                     # K3 ring: rows per stage, one per lane
RING_MAX_N = 512                   # K3 ring: 16 columns per lane
RING_MAX_STAGES = 16
RING_MAX_WARPS = 8
RING_BAR_BYTES = 2 * RING_MAX_STAGES * 8
# K3 ring: a stage's copy time over a consumer warp's time on it, by the
# bytes of D's element; fitted to chip_smoke.py's sweep of every ring grid
# at n = 307 on an H100 (PERF.md), where they put the fastest grids first
RING_COPY_RATIO = {4: 0.8, 2: 0.57}
WIDE_SMEM_TARGET = 56 * 1024       # per K3 wide CTA: four CTAs per SM
WIDE_CTAS_PER_SM = 4
GRAM_PANEL = 64                    # K2a rows per staged panel
GRAM_CTAS = 4 * 3 * SM_COUNT       # four waves of three K2a CTAs per SM
# Last-level-cache slice assumed hot per chunked stream on the CPU.
CACHE_BUDGET = 2 * 1024 * 1024
# f32 bytes of one upcast row block for torch-op loops over a CUDA D.
DEVICE_BLOCK_BUDGET = 256 * 1024 * 1024
# Default device-memory budget of the out-of-core streaming path (DESIGN.md
# section 9): the D blocks in flight (the reference's value).
STREAM_BUDGET = 256 * 1024 * 1024


class IterGrid(NamedTuple):
    """K3's launch shape: route ``"ring"`` or ``"wide"``, rows per panel,
    CTAs, ring stages and consumer warps (the wide route: 1 and 8)."""
    route: str
    rows: int
    ctas: int
    stages: int
    warps: int


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


def ring_smem(n: int, dsize: int, stages: int, warps: int,
              rows: int = RING_ROWS) -> int:
    """Shared-memory bytes of the K3 ring kernel (``csrc/admm_iter.cu``:
    ``ring_fixed_bytes`` + stages x ``ring_stage_bytes``)."""
    stage = -(-(rows * n * dsize + 16) // 16) * 16
    fixed = RING_BAR_BYTES + -(-n // 4) * 16 + warps * 3 * RING_ROWS * 4
    return fixed + stages * stage


def iter_grid(m: int, n: int, dtype) -> IterGrid:
    """K3's route and grid for an (m, n) D of ``dtype``."""
    key = ("iter", int(m), int(n), _name(dtype))
    if key not in CACHE:
        CACHE[key] = _ring_grid(m, n, _dsize(dtype)) \
            or _wide_grid(m, n)
    return IterGrid(*CACHE[key])


def ring_grids(m, n, dsize):
    """Every shape the ring kernel takes for an (m, n) D of ``dsize``-byte
    elements: W consumer warps, R rows a stage (a multiple of the rows that
    make 16 bytes), and S the most stages that fit beside them, at most 16,
    which must outnumber the warps and hold their accumulators at the end.
    Empty when n is past the ring."""
    if n > RING_MAX_N:
        return []
    unit = 16 // dsize
    grids = []
    for warps in range(1, RING_MAX_WARPS + 1):
        for rows in range(unit, RING_ROWS + 1, unit):
            fixed = ring_smem(n, dsize, 0, warps, rows)
            stage = ring_smem(n, dsize, 1, 0, rows) \
                - ring_smem(n, dsize, 0, 0, rows)
            stages = min(RING_MAX_STAGES, (SMEM_PER_BLOCK - fixed) // stage)
            if stages > warps and stages * stage >= warps * 3 * n * 4:
                grids.append(("ring", rows, max(1, min(SM_COUNT,
                                                       -(-m // rows))),
                              stages, warps))
    return grids


def _ring_grid(m, n, dsize):
    """The ring's shape, or None when n is past it. A consumer warp holds
    its stage from the Dx through the prox to the sweep; the producer's
    copies need the other S - W stages. With a stage's copy taking c times
    as long as a warp's pass over it (``RING_COPY_RATIO``), the ring moves
    R min(c W, S - W) rows in the time of one copy: W warps bound the
    consumers' rate, S - W stages in flight the copies'. Of
    ``ring_grids``, the one that maximises that rate, ties going to more
    rows."""
    c = RING_COPY_RATIO[dsize]
    return max(ring_grids(m, n, dsize), default=None,
               key=lambda g: (g[1] * min(c * g[4], g[3] - g[4]), g[1],
                              g[4]))


def _wide_grid(m, n):
    fixed = (4 * n + 128) * 4
    budget = WIDE_SMEM_TARGET if fixed + n * 4 <= WIDE_SMEM_TARGET \
        else SMEM_PER_BLOCK
    R = min(32, (budget - fixed) // (4 * n))
    if R < 1:
        raise ValueError(
            f"n={n} columns do not fit the fused iteration kernel's "
            f"shared memory ({SMEM_PER_BLOCK} bytes per block)")
    return ("wide", R, max(1, min(WIDE_CTAS_PER_SM * SM_COUNT, -(-m // R))),
            1, 8)


def gram_splits(m: int, n: int, dtype) -> int:
    """Row splits of the CUDA Gram kernel (grid = upper tiles x splits)."""
    key = ("gram", int(m), int(n), _name(dtype))
    if key not in CACHE:
        nt = -(-n // 64)
        tiles = nt * (nt + 1) // 2
        CACHE[key] = (max(1, min(GRAM_CTAS // tiles,
                                 -(-m // GRAM_PANEL))),)
    return CACHE[key][0]


def _size_and_name(dtype):
    """(bytes per element, name) of a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return _dsize(dtype), _name(dtype)
    return np.dtype(dtype).itemsize, np.dtype(dtype).name


def streaming_block_rows(m: int, n: int, dtype,
                         budget_bytes: int = None) -> int:
    """Store block height for the out-of-core streaming path (DESIGN.md
    section 9), the reference's rule: the tallest block whose worst-case
    in-flight set fits the device-memory budget. At the default prefetch
    depth of 2 the pipeline holds FOUR D blocks at once (one computing,
    two staged, one in copy; ``engine/streaming.py``), plus the per-row
    vector traffic. ``dtype`` is a torch or numpy dtype (or its name)."""
    budget = int(budget_bytes) if budget_bytes else STREAM_BUDGET
    dsize, name = _size_and_name(dtype)
    key = ("stream", int(m), int(n), name, budget)
    if key not in CACHE:
        rows = budget // max(1, 4 * n * dsize + 6 * 4)
        cap = _row_cap(m, 8)
        # prefer >= 128-row blocks, but honor a tight budget (huge n /
        # small budget) down to the 8-row tile floor rather than
        # silently overshooting the caller's device memory
        lo = min(128, cap) if rows >= 128 else 8
        CACHE[key] = (_clamp_multiple(rows, 8, lo, cap),)
    return CACHE[key][0]


def sparse_block_m(m: int, n: int, kp: int, dtype) -> int:
    """Row-block height for the padded block-CSR path (DESIGN.md section
    10), the reference's rule and budget, so that a ``BlockCSR`` has the
    reference's layout on every device; ``dtype`` is a torch or numpy
    dtype of the values.

    nnz-budgeted, not (m x n)-budgeted: a block's live bytes are its CSR
    slice ``bm * kp * (4 + dsize)`` plus the same nonzeros again in the
    local-CSC companion (padding slack rides in the 2x), plus the five
    (bm,) iterate vectors — so the block height scales with 1/density.
    Tall floor (1024): the local CSC pads each column to the block's
    largest per-column count, and that Poisson slack shrinks as blocks
    grow. K6 (``csrc/spgram.cu``) takes any height."""
    kp = max(int(kp), 1)
    dsize, name = _size_and_name(dtype)
    key = ("sparse", int(m), int(n), kp, name)
    if key not in CACHE:
        rows = CACHE_BUDGET // max(1, 2 * kp * (4 + dsize) + 20)
        cap = _row_cap(m, 8)
        CACHE[key] = (_clamp_multiple(rows, 8, min(1024, cap),
                                      min(16384, cap)),)
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
