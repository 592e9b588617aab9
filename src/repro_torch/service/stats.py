"""Sufficient statistics as the unit of serving (paper section 4); port of
``repro/service/stats.py``.

Transpose reduction collapses a tall dataset D (m x n, m >> n) into
G = D^T D and c = D^T b — an n x n / n-vector *sufficient statistic* for
every quadratic-data-term fit (lasso, ridge, elastic net, NNLS).
:class:`SufficientStats` makes that object first-class:

  * streaming ``update(block)``     — ingest row blocks without ever
                                      materializing D (one pass, O(k n^2);
                                      K2b on the card for a labeled dense
                                      block, K2a for an unlabeled one);
  * cross-shard ``merge()``         — an n^2 add (the paper's all-reduce);
  * content fingerprinting          — per-block sha256 folded by addition
                                      mod 2^256: independent of ingest
                                      order, sensitive to multiplicity,
                                      the reference's strings;
  * checkpoint save/restore         — via repro_torch.checkpoint;
  * Cholesky rank-k up/downdate     — appending or retiring a k-row block
                                      updates a cached factor in O(n^2 k).

The reference registered the class as a JAX pytree (for jit / vmap); the
port runs eagerly and has no counterpart: the arrays are plain tensors on
one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import gram as gram_lib
from repro_torch.data.sparse import BlockCSR
# Content fingerprinting lives with the data layer (the block store
# fingerprints at write time); re-exported here as in the reference.
from repro_torch.data.store import (  # noqa: F401  (re-export)
    ZERO_FINGERPRINT,
    combine_fingerprints,
    fingerprint_array,
)
from repro_torch.device import resolve_device
from repro_torch.engine.engine import gram_stats

Tensor = torch.Tensor


def _content_fingerprint(block_D, block_b) -> str:
    """One definition of content identity for both formats: BlockCSR
    hashes its index/value arrays, dense hashes the matrix — used by
    from_data, update and downdate alike. The sparse arrays are
    CANONICALIZED to 2-D (rows, kp) before hashing, so a one-block view
    hashes like the store's per-block arrays."""
    if isinstance(block_D, BlockCSR):
        kp = block_D.kp
        return fingerprint_array(block_D.indices.reshape(-1, kp),
                                 block_D.values.reshape(-1, kp), block_b)
    return fingerprint_array(block_D, block_b)


def _on(a, device):
    """A numpy array, tensor or BlockCSR on ``device`` (None: a tensor
    stays where it is, numpy goes to the card)."""
    if a is None:
        return None
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.require(a, requirements=["C", "W"]))
        device = "cuda" if device is None else device
    if device is None:
        return a
    return a.to(resolve_device(device))


@dataclasses.dataclass(frozen=True)
class SufficientStats:
    """(G = sum_i D_i^T D_i, c = sum_i D_i^T b_i, row count, fingerprint)."""

    G: Tensor                     # (n, n) accumulation precision
    c: Tensor                     # (n,) or (n, r) for stacked right-hand sides
    rows: int = 0
    fingerprint: str = ZERO_FINGERPRINT
    labeled_rows: int = 0         # rows ingested WITH a rhs; c covers these

    @property
    def n(self) -> int:
        return self.G.shape[0]

    @property
    def device(self) -> torch.device:
        return self.G.device

    @property
    def fully_labeled(self) -> bool:
        """True iff every ingested row carried a rhs — i.e. c is the rhs
        statistic of the WHOLE dataset and solves may reuse it."""
        return self.rows > 0 and self.labeled_rows == self.rows

    @classmethod
    def zero(cls, n: int, rhs: int = 0, dtype=torch.float32,
             device="cuda") -> "SufficientStats":
        """Empty accumulator on ``device``; ``rhs > 0`` tracks stacked
        right-hand sides."""
        dev = resolve_device(device)
        c = torch.zeros((n, rhs) if rhs else (n,), dtype=dtype, device=dev)
        return cls(G=torch.zeros((n, n), dtype=dtype, device=dev), c=c)

    @classmethod
    def from_data(cls, D, b=None, block_rows: Optional[int] = None,
                  backend: str = "auto", device=None) -> "SufficientStats":
        """One pass over (D, b), dispatched through ``engine.gram_stats``:
        K2b (K2a without b) on the card, the chunked loop on the CPU, the
        host Gram plus the CSC gather for a :class:`BlockCSR`
        (fingerprinted over its index/value arrays). ``D`` stays on its
        device unless ``device`` says otherwise (numpy goes to the
        card)."""
        D, b = _on(D, device), _on(b, device if device is not None
                                   else D.device)
        m, n = D.shape
        acc = gram_lib._acc_dtype(D.dtype)
        G, c = gram_stats(D, b, backend=backend, block_rows=block_rows)
        if c is None:
            c = torch.zeros((n,), dtype=acc, device=G.device)
        return cls(G=G, c=c, rows=int(m),
                   fingerprint=_content_fingerprint(D, b),
                   labeled_rows=int(m) if b is not None else 0)

    @classmethod
    def from_store(cls, store, dtype=torch.float32,
                   device="cuda") -> "SufficientStats":
        """Ingest a :class:`repro_torch.data.store.ShardedMatrixStore`: one
        pass over its row blocks (one K2b launch per labeled dense block on
        the card), REUSING the store's per-block write-time fingerprints
        instead of re-hashing the data. The resulting fingerprint equals
        folding the same blocks through :meth:`update` (and
        ``store.fingerprint``). The block statistics are summed in block
        order in float64 and rounded to ``dtype`` once: a store has
        thousands of blocks, and a float32 running sum of 51 blocks at
        4,194,304 x 200 already cost the lasso most of its 1e-3 mu KKT
        margin on an H100 (PERF.md, section 6)."""
        dev = resolve_device(device)
        G = torch.zeros((store.n, store.n), dtype=torch.float64, device=dev)
        c = torch.zeros((store.n,), dtype=torch.float64, device=dev)
        rows = labeled = 0
        fp = ZERO_FINGERPRINT
        for k, (D_b, b_b) in enumerate(store.iter_blocks(padded=False)):
            D_b, b_b = _on(D_b, dev), _on(b_b, dev)
            if not isinstance(D_b, BlockCSR):
                D_b = D_b.to(dtype)
            Gb, cb = gram_stats(D_b, b_b)
            G += Gb.double()
            if cb is not None:
                c += cb.double()
            rows += int(D_b.shape[0])
            labeled += int(D_b.shape[0]) if b_b is not None else 0
            fp = combine_fingerprints(fp, store.fingerprints[k])
        return cls(G=G.to(dtype), c=c.to(dtype), rows=rows,
                   fingerprint=fp, labeled_rows=labeled)

    def update(self, block_D, block_b=None,
               block_fingerprint: Optional[str] = None
               ) -> "SufficientStats":
        """Fold a (k, n) row block in: G += B^T B, c += B^T b, rows += k.
        The block (numpy, a tensor or a BlockCSR) moves to the stats'
        device; ``block_fingerprint`` skips hashing it."""
        return self._fold(block_D, block_b, block_fingerprint, 1)

    def downdate(self, block_D, block_b=None,
                 block_fingerprint: Optional[str] = None
                 ) -> "SufficientStats":
        """Retire a previously-ingested block (subtracts its fingerprint)."""
        return self._fold(block_D, block_b, block_fingerprint, -1)

    def _fold(self, block_D, block_b, block_fingerprint, sign):
        block_D = _on(block_D, self.device)
        block_b = _on(block_b, self.device)
        k, n = block_D.shape
        if n != self.n:
            raise ValueError(f"block width {n} != stats width {self.n}")
        if block_fingerprint is None:
            block_fingerprint = _content_fingerprint(block_D, block_b)
        G, c = _accumulate(self.G, self.c, block_D, block_b, sign)
        return SufficientStats(
            G=G, c=c, rows=self.rows + sign * int(k),
            fingerprint=combine_fingerprints(self.fingerprint,
                                             block_fingerprint, sign=sign),
            labeled_rows=self.labeled_rows
            + sign * (int(k) if block_b is not None else 0))

    def merge(self, other: "SufficientStats") -> "SufficientStats":
        """Cross-shard reduce: stats of the union of the two row sets."""
        if self.n != other.n:
            raise ValueError(f"widths differ: {self.n} != {other.n}")
        return SufficientStats(
            G=self.G + other.G, c=self.c + other.c,
            rows=self.rows + other.rows,
            fingerprint=combine_fingerprints(self.fingerprint,
                                             other.fingerprint),
            labeled_rows=self.labeled_rows + other.labeled_rows)

    # -- wire transfer ------------------------------------------------------
    def to_payload(self) -> dict:
        """Picklable host representation for cross-process shipment."""
        return {"G": self.G.detach().cpu().numpy(),
                "c": self.c.detach().cpu().numpy(),
                "rows": int(self.rows), "fingerprint": self.fingerprint,
                "labeled_rows": int(self.labeled_rows)}

    @classmethod
    def from_payload(cls, payload: dict, device="cuda") -> "SufficientStats":
        dev = resolve_device(device)
        return cls(G=torch.from_numpy(np.array(payload["G"])).to(dev),
                   c=torch.from_numpy(np.array(payload["c"])).to(dev),
                   rows=int(payload["rows"]),
                   fingerprint=payload["fingerprint"],
                   labeled_rows=int(payload["labeled_rows"]))

    def factor(self, ridge: float = 0.0) -> Tensor:
        """Cholesky factor of (G + ridge I) — O(n^3), done once then cached."""
        return gram_lib.gram_factor(self.G, ridge=ridge)

    # -- checkpointing ------------------------------------------------------
    def save(self, manager, step: int, background: bool = False):
        """Persist through repro_torch.checkpoint.CheckpointManager (the
        reference's layout and extra keys)."""
        manager.save(step, {"G": self.G, "c": self.c},
                     extra={"kind": "sufficient_stats", "rows": self.rows,
                            "fingerprint": self.fingerprint,
                            "labeled_rows": self.labeled_rows},
                     background=background)

    @classmethod
    def restore(cls, manager, n: int, rhs: int = 0,
                step: Optional[int] = None, dtype=torch.float32,
                device="cuda") -> "SufficientStats":
        dev = resolve_device(device)
        like = {"G": torch.zeros((n, n), dtype=dtype, device=dev),
                "c": torch.zeros((n, rhs) if rhs else (n,), dtype=dtype,
                                 device=dev)}
        tree, extra = manager.restore(like, step=step)
        if extra.get("kind") != "sufficient_stats":
            raise ValueError(f"not a sufficient_stats checkpoint: {extra}")
        return cls(G=tree["G"], c=tree["c"], rows=int(extra["rows"]),
                   fingerprint=extra["fingerprint"],
                   labeled_rows=int(extra.get("labeled_rows", 0)))


def _accumulate(G, c, block_D, block_b, sign):
    """Fold one block's (B^T B, B^T b) into the running stats — the same
    engine pass the bulk ingest uses, signed for downdates. A dense block
    is cast to the accumulation dtype first, as in the reference; a
    BlockCSR folds through the host Gram (kernels/spgram/ops.py)."""
    if not isinstance(block_D, BlockCSR):
        block_D = block_D.to(G.dtype)
    Gb, cb = gram_stats(block_D, block_b)
    G = G.add(Gb.to(G.dtype), alpha=sign)
    if cb is not None:
        c = c.add(cb.to(c.dtype), alpha=sign)
    return G, c


# ---------------------------------------------------------------------------
# Cholesky rank-k up/downdate (Golub & Van Loan section 12.5 / LINPACK
# dchud-dchdd)
# ---------------------------------------------------------------------------

def _chol_rank1(L: Tensor, x: Tensor, sign: float):
    """In place: L' with L' L'^T = L L^T + sign * x x^T, in O(n^2); x is
    consumed. Column sweep of Givens (update) / hyperbolic (downdate)
    rotations: each column update is vectorized over the rows below the
    diagonal, the sweep itself is sequential (column k feeds column k+1),
    as in the reference's fori_loop."""
    n = L.shape[0]
    for k in range(n):
        Lkk, xk = L[k, k], x[k]
        r = torch.sqrt(torch.clamp(Lkk * Lkk + sign * xk * xk, min=1e-30))
        cth = r / Lkk
        sth = xk / Lkk
        col = (L[k + 1:, k] + sign * sth * x[k + 1:]) / cth
        x[k + 1:] = cth * x[k + 1:] - sth * col
        L[k + 1:, k] = col
        L[k, k] = r


def _chol_rank_k(L: Tensor, block, sign: float) -> Tensor:
    B = torch.atleast_2d(torch.as_tensor(block)).to(device=L.device,
                                                   dtype=L.dtype)
    L = L.clone()
    for row in B:
        _chol_rank1(L, row.clone(), sign)
    return L


def chol_update(L: Tensor, block) -> Tensor:
    """Rank-k Cholesky update: factor of (L L^T + B^T B) for a (k, n) block
    (or one (n,) row). Appending k rows costs O(n^2 k) here vs O(n^3) for a
    fresh factorization — the serving layer's ingest path. L is not
    modified."""
    return _chol_rank_k(L, block, 1.0)


def chol_downdate(L: Tensor, block) -> Tensor:
    """Rank-k Cholesky downdate: factor of (L L^T - B^T B). Retiring rows
    (data deletion / sliding-window serving); valid while the downdated
    matrix stays positive definite — rows previously ingested (plus any
    ridge) satisfy that by construction."""
    return _chol_rank_k(L, block, -1.0)
