"""Padded block-CSR — the sparse data path's container (DESIGN.md section
10); port of ``repro/data/sparse.py``.

The paper's headline regime (terabytes of rows on thousands of cores) is
SPARSE: the transpose reductions ``D^T D`` and ``D^T(y - lam)`` then cost
O(nnz), not O(mn). :class:`BlockCSR` stores a tall (m, n) matrix so that
every solver pass keeps that asymptotic:

  * rows are grouped into ``block_m``-row blocks; each block stores per-row
    column indices and values padded to the matrix's largest row count
    ``kp`` (pad slots are ``(index 0, value 0)``: a zero VALUE kills the
    padded contribution under every gather-multiply, whatever it gathers);
  * each block ALSO carries its local transpose: a per-block CSC with
    block-LOCAL row ids, ``(n, kc)`` per block. The d/w/v reductions
    ``D_b^T u_b`` become GATHERS from the block's (block_m,) vector u_b
    instead of scatter-adds into the (n,) accumulator. On the card a
    scatter would add with float atomics, in an order that changes from run
    to run; the gathers keep every sum in a fixed order;
  * duplicate column indices within a row are legal and SUM (``to_dense``
    and every reduction treat the entries as COO triples).

The layout is built on the host with numpy, as in the reference, and gives
the reference's arrays for the same triples and ``block_m``; the four
arrays then move to ``device`` (``"cuda"`` by default). The generators
mirror the reference's bit for bit for the same seed (they draw with
numpy); the dense matrix never materializes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

Tensor = torch.Tensor

_SLOT_MULT = 4            # pad kp / kc up to a multiple of this


def _round_up(v: int, mult: int) -> int:
    return -(-max(int(v), 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class BlockCSR:
    """Padded block-CSR + per-block local CSC for a tall (m, n) matrix.

    ``indices/values``: (nblocks, block_m, kp) — per-row padded CSR.
    ``col_indices/col_values``: (nblocks, n, kc) — per-block padded CSC
    with block-local row ids in [0, block_m). Rows beyond ``m`` in the
    tail block have no nonzeros. Indices are int32; the values are f32,
    f64 or (after ``astype``) bf16.
    """

    indices: Tensor       # (nb, bm, kp) int32 column ids
    values: Tensor        # (nb, bm, kp)
    col_indices: Tensor   # (nb, n, kc) int32 block-local row ids
    col_values: Tensor    # (nb, n, kc)
    m: int
    n: int
    nnz: int

    # -- shape surface ------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nblocks(self) -> int:
        return self.indices.shape[0]

    @property
    def block_m(self) -> int:
        return self.indices.shape[1]

    @property
    def kp(self) -> int:
        return self.indices.shape[2]

    @property
    def kc(self) -> int:
        return self.col_indices.shape[2]

    @property
    def density(self) -> float:
        return self.nnz / float(max(self.m * self.n, 1))

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in
                   (self.indices, self.values, self.col_indices,
                    self.col_values))

    # -- residency ----------------------------------------------------------
    def astype(self, dtype) -> "BlockCSR":
        """Cast the VALUE arrays (indices stay int32) — the engine's
        residency hook (bf16 values, f32 accumulation)."""
        if dtype == self.dtype:
            return self
        return dataclasses.replace(self, values=self.values.to(dtype),
                                   col_values=self.col_values.to(dtype))

    def to(self, device) -> "BlockCSR":
        """The same matrix with its four arrays on ``device``."""
        dev = torch.device(device)
        if self.device == dev:
            return self
        return dataclasses.replace(
            self, indices=self.indices.to(dev), values=self.values.to(dev),
            col_indices=self.col_indices.to(dev),
            col_values=self.col_values.to(dev))

    def reblock(self, block_m: int) -> "BlockCSR":
        """Rebuild with a different block height. Extracts the nonzero
        slots on the host and re-runs the COO builder; explicit STORED
        zeros are dropped (exact under every reduction), duplicates
        survive."""
        nb, bm, kp = self.indices.shape
        val, dtype = _host_values(self.values.reshape(nb * bm, kp))
        idx = self.indices.reshape(nb * bm, kp).cpu().numpy()
        rows, slots = np.nonzero(val)
        out = BlockCSR.from_coo(rows.astype(np.int64), idx[rows, slots],
                                val[rows, slots], self.m, self.n,
                                block_m=block_m, device=self.device)
        return out.astype(dtype)

    # -- conversion ---------------------------------------------------------
    def to_dense(self) -> Tensor:
        """Dense (m, n) on the matrix's device — duplicates SUM (COO
        semantics); pad slots are value-0, so they contribute nothing.

        One slot column at a time: within a slot every row appears once,
        so each write hits distinct (row, column) pairs and the sum is a
        fixed order of plain adds (no accumulating scatter, which adds with
        float atomics on the card)."""
        nb, bm, kp = self.indices.shape
        idx = self.indices.reshape(nb * bm, kp).long()
        val = self.values.reshape(nb * bm, kp)
        rows = torch.arange(nb * bm, device=self.device)
        out = torch.zeros((nb * bm, self.n), dtype=self.dtype,
                          device=self.device)
        for k in range(kp):
            out[rows, idx[:, k]] += val[:, k]
        return out[:self.m]

    @classmethod
    def from_dense(cls, D, block_m: Optional[int] = None,
                   device=None) -> "BlockCSR":
        """Extract the nonzeros of a dense (m, n) or node-stacked
        (N, m_i, n) matrix (numpy or tensor; on the tensor's device unless
        ``device`` says otherwise). Exact: ``to_dense(from_dense(D)) ==
        D``."""
        dtype = None
        if isinstance(D, Tensor):
            device = D.device if device is None else device
            D, dtype = _host_values(D)
        D = np.asarray(D)
        if D.ndim == 3:
            D = D.reshape(-1, D.shape[-1])
        m, n = D.shape
        rows, cols = np.nonzero(D)
        out = cls.from_coo(rows.astype(np.int64), cols.astype(np.int32),
                           D[rows, cols], m, n, block_m=block_m,
                           device="cuda" if device is None else device)
        return out if dtype is None else out.astype(dtype)

    @classmethod
    def from_coo(cls, rows, cols, vals, m: int, n: int,
                 block_m: Optional[int] = None, kp: Optional[int] = None,
                 device="cuda") -> "BlockCSR":
        """Build from COO triples (duplicates kept — they sum), on the host,
        then move the arrays to ``device``."""
        dev = resolve_device(device)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int32)
        vals = np.asarray(vals)
        order = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        counts = np.bincount(rows, minlength=m).astype(np.int64)
        kp = kp or _round_up(counts.max() if m else 1, _SLOT_MULT)
        if block_m is None:
            # lazy: repro_torch.engine imports this module
            from repro_torch.engine import autotune
            block_m = autotune.sparse_block_m(m, n, kp, vals.dtype)
        bm = int(min(block_m, _round_up(max(m, 1), 8)))
        nb = max(1, -(-m // bm))
        mp = nb * bm

        idx = np.zeros((mp, kp), np.int32)
        val = np.zeros((mp, kp), vals.dtype)
        starts = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(rows.shape[0], dtype=np.int64) - starts[rows]
        idx[rows, slot] = cols
        val[rows, slot] = vals

        # per-block local CSC: sort triples by (block, col, row)
        blocks = rows // bm
        local = (rows % bm).astype(np.int32)
        key = blocks * n + cols
        corder = np.argsort(key, kind="stable")     # row-major in, so
        bkey = key[corder]                          # rows stay sorted
        ccnt = np.bincount(bkey, minlength=nb * n).astype(np.int64)
        kc = _round_up(ccnt.max() if ccnt.size else 1, _SLOT_MULT)
        cstarts = np.concatenate([[0], np.cumsum(ccnt)])
        cslot = np.arange(bkey.shape[0], dtype=np.int64) - cstarts[bkey]
        cidx = np.zeros((nb * n, kc), np.int32)
        cval = np.zeros((nb * n, kc), vals.dtype)
        cidx[bkey, cslot] = local[corder]
        cval[bkey, cslot] = vals[corder]

        def put(a, shape):
            return torch.from_numpy(a.reshape(shape)).to(dev)

        return cls(indices=put(idx, (nb, bm, kp)),
                   values=put(val, (nb, bm, kp)),
                   col_indices=put(cidx, (nb, n, kc)),
                   col_values=put(cval, (nb, n, kc)),
                   m=int(m), n=int(n), nnz=int(vals.shape[0]))

    def __repr__(self) -> str:
        return (f"BlockCSR(m={self.m}, n={self.n}, nnz={self.nnz}, "
                f"density={self.density:.4f}, block_m={self.block_m}, "
                f"kp={self.kp}, kc={self.kc}, dtype={self.dtype}, "
                f"device={self.device})")


def host_blocks(bcsr: BlockCSR):
    """Per-block host numpy arrays ``(indices, values, col_indices,
    col_values)`` — the store's write path. numpy has no bf16 here, so bf16
    values raise (store the f32 matrix; the streaming engine casts at
    staging time)."""
    if bcsr.dtype == torch.bfloat16:
        raise TypeError("bfloat16 values have no numpy dtype to store; "
                        "store the float32 matrix and stream it with "
                        "device_dtype='bfloat16'")
    return tuple(a.detach().cpu().numpy() for a in
                 (bcsr.indices, bcsr.values, bcsr.col_indices,
                  bcsr.col_values))


def _host_values(t: Tensor):
    """(numpy copy on the host, original dtype); numpy has no bf16, so
    bf16 goes through f32 (exact)."""
    dtype = t.dtype
    t = t.detach().cpu()
    if dtype == torch.bfloat16:
        t = t.float()
    return t.numpy(), dtype


# ---------------------------------------------------------------------------
# sparse synthetic generators (data/synthetic.py analogues, O(nnz) build)
# ---------------------------------------------------------------------------

class SparseLassoProblem(NamedTuple):
    D: BlockCSR
    b: Tensor         # (m,)
    x_true: Tensor    # (n,)
    mu: Tensor


class SparseClassifProblem(NamedTuple):
    D: BlockCSR
    labels: Tensor    # (m,) in {-1, +1}


def _random_coo(rng, m: int, n: int, density: float, chunk: int = 1 << 15):
    """Bernoulli(density) sparsity pattern, built row-chunk by row-chunk
    so the dense mask never exceeds ``chunk * n`` — O(nnz) output."""
    rows, cols = [], []
    for s in range(0, m, chunk):
        e = min(m, s + chunk)
        mask = rng.random((e - s, n), dtype=np.float32) < density
        r, c = np.nonzero(mask)
        rows.append((r + s).astype(np.int64))
        cols.append(c.astype(np.int32))
    rows = np.concatenate(rows) if rows else np.zeros((0,), np.int64)
    cols = np.concatenate(cols) if cols else np.zeros((0,), np.int32)
    return rows, cols


def random_block_csr(seed: int, m: int, n: int, density: float,
                     block_m: Optional[int] = None, dtype=np.float32,
                     device="cuda") -> BlockCSR:
    """Gaussian values on a Bernoulli(density) pattern."""
    rng = np.random.default_rng(seed)
    rows, cols = _random_coo(rng, m, n, density)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return BlockCSR.from_coo(rows, cols, vals, m, n, block_m=block_m,
                             device=device)


def sparse_classification_problem(
    seed: int, m: int, n: int, density: float,
    informative: int = 5, mean_shift: float = 1.0,
    block_m: Optional[int] = None, dtype=np.float32, device="cuda",
) -> SparseClassifProblem:
    """Sparse two-class problem (paper section 10.1 analogue): +1 rows get
    a ``mean_shift`` added to their entries in the first ``informative``
    columns — signal only where the sparsity pattern touches those
    columns, so classes stay non-separable."""
    rng = np.random.default_rng(seed)
    rows, cols = _random_coo(rng, m, n, density)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    labels = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(dtype)
    boost = (labels[rows] > 0) & (cols < informative)
    vals = vals + mean_shift * boost.astype(dtype)
    D = BlockCSR.from_coo(rows, cols, vals, m, n, block_m=block_m,
                          device=device)
    return SparseClassifProblem(D, torch.from_numpy(labels).to(D.device))


def sparse_lasso_problem(
    seed: int, m: int, n: int, density: float, active: int = 10,
    noise_sigma: float = 1.0, block_m: Optional[int] = None,
    dtype=np.float32, device="cuda",
) -> SparseLassoProblem:
    """Sparse lasso problem: b = D x_true + noise, mu = 10% of
    ||D^T b||_inf (the paper's rule) — both computed in O(nnz)."""
    rng = np.random.default_rng(seed)
    rows, cols = _random_coo(rng, m, n, density)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    x_true = np.zeros((n,), dtype)
    idx = rng.permutation(n)[:active]
    x_true[idx] = np.where(rng.random(active) < 0.5, 1.0, -1.0)
    Dx = np.bincount(rows, weights=(vals * x_true[cols]).astype(np.float64),
                     minlength=m).astype(dtype)
    b = Dx + noise_sigma * rng.standard_normal(m).astype(dtype)
    Dtb = np.bincount(cols, weights=(vals * b[rows]).astype(np.float64),
                      minlength=n)
    mu = 0.1 * float(np.abs(Dtb).max() or 1.0)
    D = BlockCSR.from_coo(rows, cols, vals, m, n, block_m=block_m,
                          device=device)
    dev = D.device
    return SparseLassoProblem(D, torch.from_numpy(b).to(dev),
                              torch.from_numpy(x_true).to(dev),
                              torch.tensor(mu, dtype=D.dtype, device=dev))
