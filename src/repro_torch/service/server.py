"""Batched multi-problem fit serving over cached sufficient statistics;
port of ``repro/service/server.py``.

The serving contract (paper section 4 turned into a subsystem): a dataset
is registered ONCE — one pass builds its
:class:`~repro_torch.service.stats.SufficientStats` (K2b on the card, K2a
without b) — and every subsequent fit request against that dataset
fingerprint is answered from cache:

  * quadratic-data-term problems (ridge / lasso / elastic_net / nnls) solve
    straight from (G, c): no Gram pass, no data pass when the request
    reuses the registered b; requests carrying fresh label vectors share
    ONE D^T B pass per micro-batch;
  * Cholesky factors are LRU-cached per (fingerprint, ridge); appending or
    retiring data blocks up/downdates both the stats and every live factor
    in O(n^2 k) (repro_torch.service.stats.chol_update) instead of
    refactorizing;
  * other registered problems (logistic, svm, huber, ...) fall back to the
    full registry solver on the stored data (K3 on the card, the prox of
    K1 inlined) — still one entry point.

Requests queue in a micro-batching window and are coalesced by
(problem, fingerprint, solver parameters) into stacked solves
(repro_torch.service.batching). ``ServerCounters`` makes the cache
behaviour assertable: a warm second fit on the same fingerprint performs
zero additional Gram passes.

The server keeps its data and statistics on one device (``device``, the
card unless the caller asks for the CPU); numpy inputs move there, and
every response carries x as a float32 numpy array, so the wire never
carries a tensor. Each solve runs under ``torch.cuda.device`` of the
server's card: the front end calls in from its own threads, and the
current CUDA device is per thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import on_device, resolve_device
from repro_torch.obs.metrics import MetricsRegistry, summarize_histogram
from repro_torch.service import batching, registry
from repro_torch.service.stats import SufficientStats, chol_downdate, \
    chol_update

Tensor = torch.Tensor

_req_ids = itertools.count()


@dataclasses.dataclass
class FitRequest:
    """One fit against a registered dataset.

    ``b`` overrides the dataset's own right-hand side (a linear probe's
    label vector); None reuses the c ingested at registration time.
    """

    problem: str
    fingerprint: str
    b: Optional[np.ndarray] = None
    mu: Optional[float] = None
    l2: float = 0.0
    C: float = 1.0
    delta: float = 1.0
    iters: int = 1000
    request_id: int = dataclasses.field(
        default_factory=lambda: next(_req_ids))


@dataclasses.dataclass
class FitResponse:
    request_id: int
    problem: str
    fingerprint: str
    x: Optional[np.ndarray]
    iters: int
    batch_size: int            # how many requests shared this solve
    from_cache: bool           # True iff no Gram pass was spent on this
    # terminal status taxonomy (DESIGN.md section 15): "ok" | "error" here;
    # the networked front end adds "degraded" / "deadline" / "rejected"
    status: str = "ok"
    error: Optional[str] = None


_LATENCY_HIST = "server.fit_latency_s"


class ServerCounters:
    """Observable cost accounting — the serving layer's acceptance surface.

    Backed by a :class:`~repro_torch.obs.metrics.MetricsRegistry`: the
    counters are ordinary ``server.*`` registry series (thread-safe), plus
    a submit→response latency histogram labelled warm/cold. Counter fields
    stay readable as plain attributes (``counters.gram_passes``) and
    :meth:`snapshot` keeps the flat ``{field: int}`` shape, with latency
    percentile summaries."""

    _FIELDS = (
        "requests",            # fits submitted
        "responses",           # fit responses returned
        "batches",             # coalesced group solves executed
        "gram_passes",         # full O(m n^2) passes over a dataset
        "rhs_passes",          # O(m n k) D^T B micro-batch passes
        "factorizations",      # fresh O(n^3) Cholesky factorizations
        "factor_updates",      # O(n^2 k) rank-k factor up/downdates
        "factor_cache_hits",
        "factor_cache_misses",
        "full_solves",         # non-gram-path fallbacks to registry.solve
        "errors",              # requests answered status="error"
    )

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()

    def inc(self, field: str, value: int = 1):
        assert field in self._FIELDS, f"unknown server counter {field!r}"
        self.registry.inc(f"server.{field}", value)

    def observe_latency(self, kind: str, seconds: float):
        """submit→response wall time; ``kind`` is warm (served from
        cache) or cold."""
        self.registry.observe(_LATENCY_HIST, seconds, kind=kind)

    def __getattr__(self, name: str) -> int:
        # only called when normal lookup misses: counter-field reads.
        # registry via __dict__ so a half-constructed instance cannot
        # recurse back into __getattr__
        if name in type(self)._FIELDS:
            reg = self.__dict__.get("registry")
            if reg is not None:
                return int(reg.counter_value(f"server.{name}"))
        raise AttributeError(name)

    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = {f: getattr(self, f)
                                  for f in self._FIELDS}
        lat = {}
        for kind in ("warm", "cold"):
            h = self.registry.histogram_snapshot(_LATENCY_HIST, kind=kind)
            if h is not None:
                lat[kind] = summarize_histogram(h, scale=1e3)  # ms
        if lat:
            out["fit_latency_ms"] = lat
        return out


@dataclasses.dataclass
class _Dataset:
    D: Optional[Tensor]           # (m, n) row-major data; None = stats-only
    stats: SufficientStats        # stats.fully_labeled gates rhs reuse
    b: Optional[Tensor] = None    # registered rhs rows (full solves reuse it)


def _host_x(x: Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy()


class FitServer:
    """Micro-batching fit server with an LRU Cholesky-factor cache.

    ``window``: max queued requests before ``submit`` auto-flushes.
    ``factor_cache_size``: live (fingerprint, ridge) factors; least recently
    used factors are evicted first. ``device``: where the data, the stats
    and every solve live (the card unless the caller asks for the CPU).

    Thread safety: every mutation of the queue, the dataset registry,
    and the factor LRU happens under one reentrant lock, so concurrent
    ``submit``/``flush``/``ingest_block`` callers (the networked front
    end's handler threads) can never lose a queued request, double-
    answer one, or corrupt the LRU ordering. Group solves run under the
    lock too — the server is a single logical solver; concurrency is
    the front end's job, consistency is this class's.
    """

    def __init__(self, window: int = 16, factor_cache_size: int = 8,
                 device="cuda"):
        self.window = int(window)
        self.factor_cache_size = int(factor_cache_size)
        self.device = resolve_device(device)
        self.counters = ServerCounters()
        self._lock = threading.RLock()
        self._datasets: Dict[str, _Dataset] = {}
        self._factors: "OrderedDict[Tuple[str, float], Tensor]" = \
            OrderedDict()
        self._queue: List[FitRequest] = []
        self._submit_t: Dict[int, float] = {}   # request_id -> submit time

    def _on_card(self):
        """The server's card as the calling thread's current device."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _tensor(self, a) -> Tensor:
        """An input on the server's device; float64 comes in as float32,
        as the reference's ``jnp.asarray`` takes it (so the fingerprints
        of the same input agree)."""
        t = on_device(a, self.device)
        return t.float() if t.dtype == torch.float64 else t

    # -- dataset lifecycle --------------------------------------------------
    def register_dataset(self, D, b=None, keep_data: bool = True) -> str:
        """One pass -> stats; returns the dataset fingerprint.

        ``keep_data=False`` drops the raw rows after the reduction (stats-
        only serving: quadratic problems with registered b keep working;
        fresh-b and non-gram problems will refuse).
        """
        with self._on_card():
            D = self._tensor(D)
            node_shape = tuple(D.shape[:2]) if D.dim() == 3 else None
            if node_shape is not None:       # accept node-stacked layout
                D = D.reshape(-1, D.shape[-1])
            if b is not None:
                b = self._tensor(b)
                # a 2-D b is node-stacked labels when it matches D's node
                # layout, else stacked (m, r) right-hand sides (kept 2-D —
                # flattening would interleave columns against D's rows)
                if b.dim() == 2 and tuple(b.shape) == node_shape:
                    b = b.reshape(-1)
                if b.shape[0] != D.shape[0]:
                    raise ValueError(
                        f"rhs has {b.shape[0]} rows but data has "
                        f"{D.shape[0]}")
            stats = SufficientStats.from_data(D, b)
        self.counters.inc("gram_passes")
        with self._lock:
            self._datasets[stats.fingerprint] = _Dataset(
                D=D if keep_data else None, stats=stats,
                b=b if keep_data else None)
        return stats.fingerprint

    def register_stats(self, stats: SufficientStats) -> str:
        """Adopt pre-reduced stats (e.g. merged from remote shards or
        checkpoint-restored), moved to the server's device: rhs reuse is
        gated by stats.fully_labeled, which travels with the stats through
        merge and checkpointing."""
        stats = dataclasses.replace(stats, G=stats.G.to(self.device),
                                    c=stats.c.to(self.device))
        with self._lock:
            self._datasets[stats.fingerprint] = _Dataset(D=None, stats=stats)
        return stats.fingerprint

    def _dataset_for_edit(self, fingerprint: str) -> _Dataset:
        ds = self._datasets.get(fingerprint)
        if ds is None:
            raise KeyError(
                f"unknown dataset fingerprint {fingerprint[:12]}...; "
                "register_dataset() first (or the dataset already moved "
                "to a new fingerprint via ingest/retire)")
        return ds

    def ingest_block(self, fingerprint: str, block_D,
                     block_b=None) -> str:
        """Append rows to a registered dataset.

        Stats stream-update in O(k n^2) (one K2b launch on the card, K2a
        for an unlabeled block); every live factor for the dataset rank-k
        *updates* in O(n^2 k) — no refactorization, and the dataset moves
        to its new content fingerprint.

        Atomic: every derived object (stats, concatenated rows, updated
        factors) is computed BEFORE the registry is touched, so a failing
        block (shape mismatch, bad rhs) leaves the dataset serving under
        its old fingerprint instead of silently dropping it.
        """
        with self._lock, self._on_card():
            ds = self._dataset_for_edit(fingerprint)
            block_D = self._tensor(block_D)
            block_b = None if block_b is None else self._tensor(block_b)
            if block_D.dim() != 2 or block_D.shape[1] != ds.stats.n:
                raise ValueError(
                    f"ingest block shape {tuple(block_D.shape)} does not "
                    f"match dataset width {ds.stats.n}")
            new_stats = ds.stats.update(block_D, block_b)
            new_D = (torch.cat([ds.D, block_D.to(ds.D.dtype)], 0)
                     if ds.D is not None else None)
            if ds.b is not None and block_b is not None:
                new_b = torch.cat([ds.b, block_b.reshape(-1).to(ds.b.dtype)])
            else:
                new_b = None      # raw rhs no longer aligns with the rows
            new_factors = self._rekeyed_factors(fingerprint, block_D,
                                                chol_update)
            # -- commit point: nothing below can fail ---------------------
            self._commit_rekey(new_stats.fingerprint, new_factors)
            del self._datasets[fingerprint]
            self._datasets[new_stats.fingerprint] = _Dataset(
                D=new_D, stats=new_stats, b=new_b)
            return new_stats.fingerprint

    def retire_block(self, fingerprint: str, block_D,
                     block_b=None) -> str:
        """Remove previously-ingested rows (sliding-window serving).

        Stats downdate; live factors rank-k *downdate*. The raw row cache
        (if any) is dropped — exact row removal is the stats' job.

        Atomic like :meth:`ingest_block`; additionally validates that the
        downdate is well-posed (row count stays nonnegative, downdated
        factors stay finite) before committing, since retiring rows that
        were never ingested would silently poison G.
        """
        with self._lock, self._on_card():
            ds = self._dataset_for_edit(fingerprint)
            block_D = self._tensor(block_D)
            block_b = None if block_b is None else self._tensor(block_b)
            if block_D.dim() != 2 or block_D.shape[1] != ds.stats.n:
                raise ValueError(
                    f"retire block shape {tuple(block_D.shape)} does not "
                    f"match dataset width {ds.stats.n}")
            if block_D.shape[0] > ds.stats.rows:
                raise ValueError(
                    f"cannot retire {block_D.shape[0]} rows from a "
                    f"{ds.stats.rows}-row dataset")
            new_stats = ds.stats.downdate(block_D, block_b)
            new_factors = self._rekeyed_factors(fingerprint, block_D,
                                                chol_downdate)
            for (fp, ridge), L in new_factors.items():
                # an indefinite downdate (rows never ingested) yields
                # NaN/Inf in the hyperbolic rotations — detect it here,
                # before the commit, instead of serving garbage factors
                if not bool(torch.isfinite(L).all()):
                    raise ValueError(
                        "downdate left the cached factor indefinite "
                        f"(fingerprint {fp[:12]}..., ridge {ridge}) — "
                        "the block was not previously ingested")
            # -- commit point ---------------------------------------------
            self._commit_rekey(new_stats.fingerprint, new_factors)
            del self._datasets[fingerprint]
            self._datasets[new_stats.fingerprint] = _Dataset(
                D=None, stats=new_stats)
            return new_stats.fingerprint

    def _rekeyed_factors(self, old_fp: str, block_D: Tensor, op
                         ) -> "OrderedDict[Tuple[str, float], Tensor]":
        """Updated factors for every live (old_fp, ridge) key — computed
        eagerly so the caller can validate them before committing."""
        out: "OrderedDict[Tuple[str, float], Tensor]" = OrderedDict()
        for (fp, ridge), L in self._factors.items():
            if fp == old_fp:
                out[(fp, ridge)] = op(L, block_D)
        return out

    def _commit_rekey(self, new_fp: str, new_factors):
        """Swap pre-validated factors in under the dataset's new
        fingerprint (pure dict surgery — cannot fail)."""
        for (fp, ridge), L in new_factors.items():
            del self._factors[(fp, ridge)]
            self._factors[(new_fp, ridge)] = L
            self.counters.inc("factor_updates")

    def stats_for(self, fingerprint: str) -> SufficientStats:
        with self._lock:
            return self._datasets[fingerprint].stats

    # -- factor cache -------------------------------------------------------
    def _factor(self, fingerprint: str, ridge: float) -> Tensor:
        with self._lock:
            key = (fingerprint, float(ridge))
            if key in self._factors:
                self._factors.move_to_end(key)
                self.counters.inc("factor_cache_hits")
                return self._factors[key]
            self.counters.inc("factor_cache_misses")
            L = self._datasets[fingerprint].stats.factor(ridge=ridge)
            self.counters.inc("factorizations")
            self._factors[key] = L
            while len(self._factors) > self.factor_cache_size:
                self._factors.popitem(last=False)
            return L

    # -- request path -------------------------------------------------------
    def submit(self, request: FitRequest) -> List[FitResponse]:
        """Queue a request; auto-flush when the window fills."""
        self.counters.inc("requests")
        with self._lock:
            self._submit_t[request.request_id] = time.perf_counter()
            self._queue.append(request)
            if len(self._queue) >= self.window:
                return self.flush()
        return []

    def flush(self) -> List[FitResponse]:
        """Coalesce the queue into per-(problem, dataset, params) batches.

        Failure containment: one bad group (unknown fingerprint, missing
        mu/b, stats-only dataset asked for raw rows) is answered with
        per-request ``status="error"`` responses and the REMAINING groups
        still solve — the queue was already swapped out, so aborting
        mid-flush would silently lose every sibling request's response.
        """
        with self._lock:
            queue, self._queue = self._queue, []
            groups: "OrderedDict[tuple, List[FitRequest]]" = OrderedDict()
            for req in queue:
                # ridge shares one factor per mu, so it groups by mu (None
                # normalizes to the solver default); FASTA-path problems
                # batch over per-request mus and coalesce freely.
                mu_key = ((req.mu if req.mu is not None else 1.0)
                          if req.problem == "ridge" else None)
                key = (req.problem, req.fingerprint, req.l2, req.iters,
                       mu_key)
                groups.setdefault(key, []).append(req)
            out: List[FitResponse] = []
            for reqs in groups.values():
                try:
                    out.extend(self._solve_group(reqs))
                except Exception as e:          # noqa: BLE001 — isolate
                    self.counters.inc("errors", len(reqs))
                    err = f"{type(e).__name__}: {e}"
                    out.extend(
                        FitResponse(request_id=r.request_id,
                                    problem=r.problem,
                                    fingerprint=r.fingerprint, x=None,
                                    iters=0, batch_size=len(reqs),
                                    from_cache=False, status="error",
                                    error=err)
                        for r in reqs)
            self.counters.inc("responses", len(out))
            now = time.perf_counter()
            for resp in out:
                # warm = answered from cached stats (no Gram pass spent);
                # requests that bypassed submit() have no stamp and
                # observe nothing; error responses carry no latency sample
                t0 = self._submit_t.pop(resp.request_id, None)
                if t0 is not None and resp.status == "ok":
                    self.counters.observe_latency(
                        "warm" if resp.from_cache else "cold", now - t0)
            out.sort(key=lambda r: r.request_id)
            return out

    def solve_one(self, request: FitRequest) -> FitResponse:
        """One synchronous solve OUTSIDE the micro-batch queue — the
        network front end's cold/fallback path. Gram-path problems are
        answered under the server lock (they are cached-factor fast);
        full solves only hold the lock for the dataset lookup and run
        the O(iters · m n) solver outside it, so a long cold solve can
        never stall concurrent warm flushes. Raises on failure (the
        caller owns error containment and breaker accounting)."""
        if request.problem in registry.GRAM_SOLVERS:
            with self._lock:
                return self._solve_group([request])[0]
        with self._lock:
            if request.fingerprint not in self._datasets:
                raise KeyError(
                    f"unknown dataset fingerprint "
                    f"{request.fingerprint[:12]}...; register_dataset() "
                    "first")
        return self._solve_full(request)

    def serve(self, requests: Sequence[FitRequest],
              window_s: float = 0.0) -> List[FitResponse]:
        """Drive a request stream through the micro-batching loop.

        ``window_s`` emulates an arrival window: requests accumulate until
        the window closes (or the queue hits ``window``), then flush.
        """
        out: List[FitResponse] = []
        deadline = time.monotonic() + window_s
        for req in requests:
            out.extend(self.submit(req))
            if window_s and time.monotonic() >= deadline:
                out.extend(self.flush())
                deadline = time.monotonic() + window_s
        out.extend(self.flush())
        return out

    # -- group solvers ------------------------------------------------------
    def _solve_group(self, reqs: List[FitRequest]) -> List[FitResponse]:
        problem = reqs[0].problem
        fp = reqs[0].fingerprint
        if fp not in self._datasets:
            raise KeyError(f"unknown dataset fingerprint {fp[:12]}...; "
                           "register_dataset() first")
        # the registry's stats-path solvers define what serves from cache
        if problem in registry.GRAM_SOLVERS:
            with self._on_card():
                return self._solve_gram_group(problem, fp, reqs)
        return [self._solve_full(req) for req in reqs]

    def _group_rhs(self, fp: str, reqs: List[FitRequest]) -> Tensor:
        """(k, n) right-hand sides: ONE D^T B pass for fresh labels."""
        ds = self._datasets[fp]
        fresh = [r for r in reqs if r.b is not None]
        if fresh:
            if ds.D is None:
                raise ValueError(
                    "request carries fresh b but dataset was registered "
                    "stats-only (keep_data=False)")
            B = torch.stack([self._tensor(r.b).reshape(-1).to(ds.D.dtype)
                             for r in fresh], 1)
            C_fresh = batching.rhs_chunked(ds.D, B)          # (n, k_fresh)
            self.counters.inc("rhs_passes")
        cols, j = [], 0
        for r in reqs:
            if r.b is None:
                # fully_labeled: c covers every row in G — a mixed ingest
                # (some blocks unlabeled) must not serve its partial c.
                if not (ds.stats.fully_labeled and ds.stats.c.dim() == 1):
                    raise ValueError(
                        "request reuses the dataset rhs but none was "
                        "registered — pass b on the request or register "
                        "the dataset with b")
                cols.append(ds.stats.c)
            else:
                cols.append(C_fresh[:, j])
                j += 1
        return torch.stack(cols, 0)                          # (k, n)

    def _solve_gram_group(self, problem: str, fp: str,
                          reqs: List[FitRequest]) -> List[FitResponse]:
        self.counters.inc("batches")
        if problem in ("lasso", "elastic_net"):
            missing = [r.request_id for r in reqs if r.mu is None]
            if missing:
                raise ValueError(
                    f"{problem} requests {missing} have no mu — an l1 "
                    "weight is required (mu=0 would silently serve "
                    "unregularized least squares)")
        C = self._group_rhs(fp, reqs)
        k = len(reqs)
        if problem == "ridge":
            mu = reqs[0].mu if reqs[0].mu is not None else 1.0
            L = self._factor(fp, ridge=mu)
            X = batching.batched_gram_solve(L, C)
            iters = np.ones((k,), np.int32)
        else:
            G = self._datasets[fp].stats.G
            mus = [r.mu if r.mu is not None else 0.0 for r in reqs]
            X, iters = batching.batched_quad_prox(
                G, C, mus, kind=problem, l2=reqs[0].l2,
                iters=reqs[0].iters)
            iters = iters.cpu().numpy()
        X = _host_x(X)
        return [
            FitResponse(request_id=r.request_id, problem=problem,
                        fingerprint=fp, x=X[i], iters=int(iters[i]),
                        batch_size=k, from_cache=True)
            for i, r in enumerate(reqs)
        ]

    def _solve_full(self, req: FitRequest) -> FitResponse:
        """Non-quadratic data terms need the rows: registry fallback."""
        ds = self._datasets[req.fingerprint]
        if ds.D is None:
            raise ValueError(
                f"problem {req.problem!r} needs raw data but dataset "
                "was registered stats-only")
        b = req.b if req.b is not None else ds.b
        if b is None:
            raise ValueError(
                f"problem {req.problem!r} needs labels/targets: pass b on "
                "the request or register the dataset with b")
        self.counters.inc("full_solves")
        m, n = ds.D.shape
        with self._on_card():
            D = ds.D.reshape(1, m, n)
            aux = self._tensor(b).reshape(1, m)
            res = registry.solve(
                req.problem, D, aux, method="transpose", mu=req.mu, C=req.C,
                delta=req.delta, iters=req.iters, record=False)
            x = _host_x(res.x)
        return FitResponse(
            request_id=req.request_id, problem=req.problem,
            fingerprint=req.fingerprint, x=x,
            iters=int(res.iters), batch_size=1, from_cache=False)
