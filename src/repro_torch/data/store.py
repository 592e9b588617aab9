"""ShardedMatrixStore — host-RAM / memory-mapped row-block data store; a
copy of ``repro/data/store.py`` (numpy only, as the reference), which the
port may not import.

The out-of-core half of the paper's regime (DESIGN.md section 9): the 5 Tb
datasets of section 10 never fit an accelerator, but every solver object is
a reduction over ROW BLOCKS of D — Gram setup, the d/w/v transpose
reductions, the prox. This store holds the rows where they fit (host RAM,
or on disk behind ``numpy`` memory maps) and hands the streaming engine a
uniform iterator of ``(D_block, aux_block)`` pairs; device memory is then
bounded by a few blocks regardless of m.

Layout contract:

  * rows are split into fixed-height blocks of ``block_rows``; the tail
    block is stored UNPADDED (logical length) and zero-padded on read when
    ``padded=True`` — zero rows are exact under every transpose reduction,
    so padded reads need no masks;
  * ``aux`` (labels / right-hand sides) rides along row-aligned, optional;
  * every block carries a content fingerprint computed at WRITE time, so
    downstream ingestion (``SufficientStats.from_store``) folds the
    store's fingerprints instead of re-hashing gigabytes on every pass.
    The fingerprints are the reference's strings for the same arrays.

On-disk format (``save`` / ``open``): a directory of ``block_*.npy`` (+
``aux_*.npy``) files and ``store_meta.json``, loaded back with
``mmap_mode="r"``; a store either package saved opens in the other. A
store whose dtype numpy cannot name here (bfloat16 without ml_dtypes)
raises on ``open``.

SPARSE stores (:meth:`from_sparse`) hold padded block-CSR blocks: each
block is its four index/value arrays, so store bytes scale with nnz.
``block()`` returns the port's one-block
:class:`~repro_torch.data.sparse.BlockCSR` (CPU tensors over the store's
arrays) in place of the dense array.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

ZERO_FINGERPRINT = "0" * 64

_META_NAME = "store_meta.json"


def _host_array(a) -> np.ndarray:
    """A numpy array of ``a`` (numpy, or a tensor brought to the host)."""
    if hasattr(a, "detach"):                     # a torch tensor
        t = a.detach().cpu()
        if str(t.dtype) == "torch.bfloat16":
            raise TypeError("a bfloat16 tensor has no numpy dtype to "
                            "fingerprint or store; cast it to float32")
        return t.numpy()
    return np.asarray(a)


def fingerprint_array(*arrays) -> str:
    """sha256 content fingerprint of host-backed arrays (shape + dtype +
    bytes); tensors are hashed as their numpy arrays, so a tensor and the
    array it came from fingerprint alike."""
    h = hashlib.sha256()
    for a in arrays:
        if a is None:
            h.update(b"none")
            continue
        a = np.ascontiguousarray(_host_array(a))
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def combine_fingerprints(fp_a: str, fp_b: str, sign: int = 1) -> str:
    """Commutative, associative, multiplicity-sensitive fold.

    Addition mod 2^256 (not XOR): ingest order cannot matter, but ingesting
    the same block twice must NOT cancel back to the original fingerprint —
    the stats really do contain it twice. ``sign=-1`` is the downdate
    inverse, so retiring a block restores the prior fingerprint exactly.
    """
    return format((int(fp_a, 16) + sign * int(fp_b, 16)) % (1 << 256),
                  "064x")


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad the leading axis up to ``rows`` (no-op when already there)."""
    k = a.shape[0]
    if k == rows:
        return a
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[:k] = a
    return out


def _numpy_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError as e:
        raise TypeError(
            f"the store's dtype {name!r} has no numpy dtype here (a "
            "bfloat16 store needs ml_dtypes, which this installation "
            "lacks); save the store in float32") from e


class ShardedMatrixStore:
    """Row-block store for a tall (m, n) design matrix + row-aligned aux.

    Blocks are host ``numpy`` arrays — plain RAM when built with
    :meth:`from_arrays`, read-only memory maps when opened from disk with
    :meth:`open`. The solver never sees more than a few blocks at a time.
    """

    def __init__(self, blocks_D: Sequence,
                 blocks_aux: Optional[Sequence[np.ndarray]],
                 block_rows: int,
                 fingerprints: Sequence[str],
                 path: Optional[str] = None,
                 sparse_meta: Optional[dict] = None):
        if not blocks_D:
            raise ValueError("store needs at least one block")
        if blocks_aux is not None and len(blocks_aux) != len(blocks_D):
            raise ValueError("aux block count != D block count")
        if len(fingerprints) != len(blocks_D):
            raise ValueError("fingerprint count != block count")
        self._blocks_D = list(blocks_D)
        self._blocks_aux = list(blocks_aux) if blocks_aux is not None else None
        self.block_rows = int(block_rows)
        self.fingerprints = list(fingerprints)
        self.path = path
        self.sparse_meta = dict(sparse_meta) if sparse_meta else None
        if self.sparse_meta:
            # blocks are (indices, values, col_indices, col_values) tuples
            self.n = int(self.sparse_meta["n"])
            self.m = int(self.sparse_meta["m"])
            self.dtype = _numpy_dtype(self.sparse_meta["dtype"])
        else:
            self.n = int(blocks_D[0].shape[1])
            self.m = int(sum(b.shape[0] for b in blocks_D))
            self.dtype = np.dtype(blocks_D[0].dtype)

    @property
    def sparse(self) -> bool:
        return self.sparse_meta is not None

    # -- construction -------------------------------------------------------
    @classmethod
    def from_arrays(cls, D, aux=None,
                    block_rows: int = 4096) -> "ShardedMatrixStore":
        """Split host arrays (numpy, or tensors brought to the host) into
        row blocks (tail unpadded) and fingerprint each block once at build
        time."""
        D = _host_array(D)
        if D.ndim == 3:                       # node-stacked (N, m_i, n)
            D = D.reshape(-1, D.shape[-1])
        if aux is not None:
            aux = _host_array(aux).reshape(-1)
            if aux.shape[0] != D.shape[0]:
                raise ValueError(
                    f"aux rows {aux.shape[0]} != D rows {D.shape[0]}")
        m = D.shape[0]
        block_rows = int(min(block_rows, m))
        starts = range(0, m, block_rows)
        blocks_D = [np.ascontiguousarray(D[s:s + block_rows]) for s in starts]
        blocks_aux = (None if aux is None else
                      [np.ascontiguousarray(aux[s:s + block_rows])
                       for s in starts])
        fps = [fingerprint_array(bd, None if blocks_aux is None
                                 else blocks_aux[i])
               for i, bd in enumerate(blocks_D)]
        return cls(blocks_D, blocks_aux, block_rows, fps)

    @classmethod
    def from_sparse(cls, bcsr, aux=None) -> "ShardedMatrixStore":
        """Store a :class:`repro_torch.data.sparse.BlockCSR`: one store
        block per CSR block (``block_rows = bcsr.block_m``), bytes scaling
        with nnz. Fingerprints hash each block's (indices, values, aux) at
        write time, like the dense path."""
        from repro_torch.data.sparse import host_blocks
        idx, val, cidx, cval = host_blocks(bcsr)
        nb = idx.shape[0]
        if aux is not None:
            aux = _host_array(aux).reshape(-1)
            if aux.shape[0] != bcsr.m:
                raise ValueError(
                    f"aux rows {aux.shape[0]} != D rows {bcsr.m}")
        blocks, blocks_aux, fps = [], [], []
        for k in range(nb):
            blocks.append((np.ascontiguousarray(idx[k]),
                           np.ascontiguousarray(val[k]),
                           np.ascontiguousarray(cidx[k]),
                           np.ascontiguousarray(cval[k])))
            a_b = None
            if aux is not None:
                s = k * bcsr.block_m
                a_b = np.ascontiguousarray(
                    aux[s:s + min(bcsr.block_m, bcsr.m - s)])
                blocks_aux.append(a_b)
            fps.append(fingerprint_array(blocks[-1][0], blocks[-1][1],
                                         a_b))
        meta = {"m": bcsr.m, "n": bcsr.n, "nnz": bcsr.nnz,
                "kp": bcsr.kp, "kc": bcsr.kc,
                "dtype": np.dtype(val.dtype).name}
        return cls(blocks, blocks_aux if aux is not None else None,
                   bcsr.block_m, fps, sparse_meta=meta)

    # -- persistence (memory-mapped reopen) ---------------------------------
    _SPARSE_PARTS = ("idx", "val", "cidx", "cval")

    def save(self, path: str) -> str:
        """Write blocks as .npy files + a JSON manifest; reopen with
        :meth:`open` for memory-mapped (out-of-RAM) access."""
        os.makedirs(path, exist_ok=True)
        for i, b in enumerate(self._blocks_D):
            if self.sparse:
                for part, arr in zip(self._SPARSE_PARTS, b):
                    np.save(os.path.join(path,
                                         f"block_{i:06d}_{part}.npy"), arr)
            else:
                np.save(os.path.join(path, f"block_{i:06d}.npy"), b)
            if self._blocks_aux is not None:
                np.save(os.path.join(path, f"aux_{i:06d}.npy"),
                        self._blocks_aux[i])
        meta = {"m": self.m, "n": self.n, "block_rows": self.block_rows,
                "nblocks": self.nblocks, "dtype": self.dtype.name,
                "has_aux": self._blocks_aux is not None,
                "fingerprints": self.fingerprints,
                "sparse": self.sparse_meta}
        with open(os.path.join(path, _META_NAME), "w") as f:
            json.dump(meta, f, indent=1)
        return path

    @classmethod
    def open(cls, path: str) -> "ShardedMatrixStore":
        """Memory-map a saved store; blocks page in lazily on first touch,
        so opening a multi-terabyte store costs only the manifest read."""
        with open(os.path.join(path, _META_NAME)) as f:
            meta = json.load(f)
        _numpy_dtype(meta["dtype"])
        sparse_meta = meta.get("sparse")
        if sparse_meta:
            blocks_D = [tuple(
                np.load(os.path.join(path, f"block_{i:06d}_{part}.npy"),
                        mmap_mode="r") for part in cls._SPARSE_PARTS)
                for i in range(meta["nblocks"])]
        else:
            blocks_D = [np.load(os.path.join(path, f"block_{i:06d}.npy"),
                                mmap_mode="r")
                        for i in range(meta["nblocks"])]
        blocks_aux = None
        if meta["has_aux"]:
            blocks_aux = [np.load(os.path.join(path, f"aux_{i:06d}.npy"),
                                  mmap_mode="r")
                          for i in range(meta["nblocks"])]
        return cls(blocks_D, blocks_aux, meta["block_rows"],
                   meta["fingerprints"], path=path,
                   sparse_meta=sparse_meta)

    # -- block access -------------------------------------------------------
    @property
    def nblocks(self) -> int:
        return len(self._blocks_D)

    @property
    def has_aux(self) -> bool:
        return self._blocks_aux is not None

    @property
    def nbytes(self) -> int:
        if self.sparse:
            return sum(a.nbytes for b in self._blocks_D for a in b)
        return sum(b.nbytes for b in self._blocks_D)

    @property
    def fingerprint(self) -> str:
        """Order-independent fold of the per-block fingerprints — equals the
        fingerprint of ingesting every block through
        ``SufficientStats.update``."""
        fp = ZERO_FINGERPRINT
        for b in self.fingerprints:
            fp = combine_fingerprints(fp, b)
        return fp

    def block_slice(self, k: int) -> slice:
        """Logical row range [start, stop) of block k (tail may be short)."""
        start = k * self.block_rows
        if self.sparse:
            stop = min(start + self.block_rows, self.m)
        else:
            stop = start + self._blocks_D[k].shape[0]
        return slice(start, stop)

    def raw_block(self, k: int):
        """Block k as stored: the dense (rows, n) array, or a sparse
        block's (indices, values, col_indices, col_values) arrays, and its
        aux (None for an unlabeled store), all unpadded host arrays — the
        streaming engine's staging source."""
        a_b = self._blocks_aux[k] if self._blocks_aux is not None else None
        return self._blocks_D[k], a_b

    def block(self, k: int, padded: bool = False):
        """Block k as host arrays. ``padded=True`` zero-pads the tail block
        to the uniform (block_rows, n) shape, exact per the zero-row
        argument above. Sparse stores return a one-block
        :class:`~repro_torch.data.sparse.BlockCSR` of CPU tensors whose
        arrays are ALWAYS full-shape (pad rows are zero-nnz); ``padded``
        only selects whether its logical ``m`` is the uniform block_rows
        or the tail's true row count."""
        D_b, a_b = self.raw_block(k)
        if self.sparse:
            import torch

            from repro_torch.data.sparse import BlockCSR
            sl = self.block_slice(k)
            rows = self.block_rows if padded else sl.stop - sl.start

            def t(a):
                # a read-only memory map is copied (torch takes writable
                # arrays only); a RAM block is shared
                return torch.from_numpy(
                    np.require(a, requirements=["C", "W"]))[None]

            idx, val, cidx, cval = D_b
            # nnz is the block's slot capacity (block-independent), as in
            # the reference, so a scan of the values is never needed
            D_b = BlockCSR(indices=t(idx), values=t(val),
                           col_indices=t(cidx), col_values=t(cval),
                           m=int(rows), n=self.n,
                           nnz=int(self.block_rows) * int(idx.shape[-1]))
            if padded and a_b is not None and a_b.shape[0] != self.block_rows:
                a_b = _pad_rows(np.asarray(a_b), self.block_rows)
            return D_b, a_b
        if padded and D_b.shape[0] != self.block_rows:
            D_b = _pad_rows(np.asarray(D_b), self.block_rows)
            if a_b is not None:
                a_b = _pad_rows(np.asarray(a_b), self.block_rows)
        return D_b, a_b

    def verify_block(self, k: int) -> bool:
        """Re-hash block k's CONTENT and compare against its write-time
        fingerprint: what guarantees that a store reopened elsewhere still
        holds the rows it was written with (a stale or torn mmap fails here
        instead of corrupting a solve). Hashes exactly what write time
        hashed: the UNPADDED dense block (or the sparse index/value arrays)
        plus aux."""
        D_b, a_b = self.raw_block(k)
        if self.sparse:
            idx, val, _, _ = D_b
            fp = fingerprint_array(np.ascontiguousarray(idx),
                                   np.ascontiguousarray(val), a_b)
        else:
            fp = fingerprint_array(D_b, a_b)
        return fp == self.fingerprints[k]

    def verify_blocks(self, blocks: Sequence[int]) -> List[int]:
        """Check several blocks; return the block indices whose content
        does NOT match (empty = all verified)."""
        return [int(k) for k in blocks if not self.verify_block(int(k))]

    def iter_blocks(self, padded: bool = False
                    ) -> Iterator[Tuple[object, Optional[np.ndarray]]]:
        """The store's contract with the streaming engine: ``(D_block,
        aux_block)`` pairs in row order (aux_block is None for unlabeled
        stores)."""
        for k in range(self.nblocks):
            yield self.block(k, padded=padded)

    def __repr__(self) -> str:
        where = f"mmap:{self.path}" if self.path else "ram"
        kind = (f"sparse nnz={self.sparse_meta['nnz']}, "
                if self.sparse else "")
        return (f"ShardedMatrixStore(m={self.m}, n={self.n}, "
                f"block_rows={self.block_rows}, nblocks={self.nblocks}, "
                f"{kind}dtype={self.dtype.name}, {where})")
