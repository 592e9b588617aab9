"""Out-of-core streaming backend — the fused iteration body over a
:class:`~repro_torch.data.store.ShardedMatrixStore` (DESIGN.md section 9);
port of ``repro/engine/streaming.py``.

The in-memory engine (``engine.engine``) assumes D is device-resident.
This module removes that assumption: each solver pass walks the store's
row blocks, runs the SAME fused body (``IterationEngine.iterate``: K3 on
the card for dense blocks, K6 for a sparse store) on one device-resident
block at a time, and persists the m-sized iterates ``(y, lam)`` back to
host per block — device memory is bounded by a few blocks regardless of m.

The pipeline on the card (the reference's prefetch thread of
``jax.device_put`` calls, rebuilt on CUDA streams):

  * a host thread (:func:`staged`) copies block k+1.. of the store into a
    fixed pool of ``prefetch + 2`` PINNED staging slots (casting to the
    residency dtype as it copies, so the H2D moves residency bytes), then
    enqueues the H2D on a COPY stream and records one event per block; a
    slot is overwritten only after its last H2D event has completed;
  * the compute stream (the consumer's current stream, on which the
    kernels launch) waits on the block's event, and each block tensor,
    allocated on the copy stream, ``record_stream``-s the compute stream
    so the caching allocator cannot hand its memory out while a kernel
    still reads it;
  * the m-sized iterates and labels stay on the host in pinned tensors;
    each block's slices go up on the compute stream right before its step
    and its y', lam' come back by non-blocking D2H copies enqueued right
    behind the step, so the write-back of block k lands while later blocks
    are staged and computed. ``sweep`` synchronises before it returns:
    nothing reads a host iterate whose D2H is still in flight.

At most ``prefetch + 2`` D blocks are on the card at once (one computing,
``prefetch`` staged, one in copy), which is what
``autotune.streaming_block_rows`` budgets for. ``prefetch=0`` (or
``overlap=False``) is the naive synchronous baseline: stage, wait for the
H2D, compute, wait. On the CPU the same pipeline runs without streams,
pinning or events.

Tail-block padding is exact (zero D rows contribute nothing to any
reduction); the one non-exact quantity, the objective's value on pad
rows, is a constant (pad iterates stay at zero) subtracted by the driver.

The per-block partials (G, d, w, v and the stopping-rule scalars) are
summed in block order in float64 and rounded to the accumulation dtype
once, at the end of the pass. That keeps them as accurate as the
in-memory kernels' own block sums (K6 compensates its block partials): in
float32, the d of a 171-block sparse store carried enough rounding noise
to hold the dual residual above Boyd's tolerance on an H100 (PERF.md,
section 6).
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import itertools
import time
from typing import Callable, Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import gram as gram_lib
from repro_torch.data.store import ShardedMatrixStore

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# staged iteration: the double-buffer primitive
# ---------------------------------------------------------------------------

def staged(items: Iterable, stage: Callable, depth: int) -> Iterator:
    """Yield ``stage(item)`` for each item, running ``stage`` up to
    ``depth`` items ahead (plus the one it is working on) on a host
    thread. ``depth=0`` degrades to the naive synchronous loop (the
    benchmark baseline). A producer's error is raised in the consumer when
    it reaches that item; a consumer that abandons the generator cancels
    the stages not yet started, and the thread exits after the one it is
    running."""
    if depth <= 0:
        for it in items:
            yield stage(it)
        return
    items = iter(items)
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="staged")
    with contextlib.ExitStack() as stack:
        stack.callback(pool.shutdown, wait=False, cancel_futures=True)
        ahead = collections.deque(
            pool.submit(stage, it) for it in itertools.islice(items,
                                                              depth + 1))
        while ahead:
            got = ahead.popleft().result()
            for it in itertools.islice(items, 1):
                ahead.append(pool.submit(stage, it))
            yield got
            got = None     # hold no staged block while waiting for the next


# ---------------------------------------------------------------------------
# per-block bodies
# ---------------------------------------------------------------------------

class SweepResult(NamedTuple):
    """Accumulated over all blocks of one sweep — everything the driver
    needs for the x-update and Boyd's stopping rule, all n-sized or
    scalar (nothing m-sized survives a sweep on the device)."""

    d: Tensor          # sum_b D_b^T(y_b' - lam_b')
    w: Tensor          # sum_b D_b^T(y_b' - y_b)
    v: Tensor          # sum_b D_b^T lam_b'
    r_sq: Tensor       # ||lam' - lam||^2 = ||Dx - y'||^2
    dx_sq: Tensor      # ||Dx||^2
    y_sq: Tensor       # ||y'||^2
    obj: Tensor        # f(Dx) (pad-corrected by the driver)


def _zero_sweep(n: int, dtype, ycols: int = 1,
                device="cpu") -> SweepResult:
    """Zero accumulators; ``ycols > 1`` (multinomial) widens the
    n-vectors to (n, ycols)."""
    shape = (n,) if ycols == 1 else (n, ycols)
    return SweepResult(
        *(torch.zeros(shape, dtype=dtype, device=device) for _ in range(3)),
        *(torch.zeros((), dtype=dtype, device=device) for _ in range(4)))


def _block_fns(engine, has_aux: bool, want_dual: bool = True,
               sparse: bool = False):
    """Per-block ``(step, init, gram)`` bodies for one engine config.

    ``step(D_b, aux_b, y_b, lam_b, x, acc) -> (y', lam', acc')`` folds one
    block's fused iteration into the sweep accumulators; ``want_dual=False``
    is the lean body (d only, the other accumulators stay as they came).
    ``init(D_b, x0) -> (y_b, d_b)`` is the warm start (y_b = D_b x0, lam =
    0). ``gram(G, D_b) -> G + D_b^T D_b`` (K2a on the card). A sparse
    store's blocks are one-block BlockCSRs; the step is the engine's own
    format dispatch (K6 on the card), only the warm start differs."""

    def step(D_b, aux_b, y_b, lam_b, x, acc):
        st = engine.iterate(D_b, aux_b if has_aux else None, y_b, lam_b, x,
                            want_dual=want_dual)
        if not want_dual:
            return st.y, st.lam, acc._replace(d=acc.d + st.d)
        Dx = st.lam - lam_b + st.y
        obj = engine.loss.value(Dx, aux_b if has_aux else None)
        new = SweepResult(
            acc.d + st.d, acc.w + st.w, acc.v + st.v,
            acc.r_sq + torch.sum((st.lam - lam_b) ** 2),
            acc.dx_sq + torch.sum(Dx * Dx),
            acc.y_sq + torch.sum(st.y * st.y), acc.obj + obj)
        return st.y, st.lam, new

    def init(D_b, x0):
        acc = gram_lib._acc_dtype(D_b.dtype)
        if sparse:
            from repro_torch.kernels.spgram import ops as spgram_ops
            y_b = spgram_ops.matvec(D_b, x0.to(acc))
            return y_b, spgram_ops.rmatvec(D_b, y_b)
        Df = D_b.to(acc)
        y_b = Df @ x0.to(acc)
        if y_b.dim() > 1:                  # matrix iterates (multinomial)
            return y_b, Df.T @ y_b
        return y_b, y_b @ Df

    def gram(G, D_b):
        Gb, _ = engine.gram(D_b)
        return G + Gb

    return step, init, gram


# Public alias: the cluster worker drives the same per-block fused body
# over its owned blocks.
block_step_fns = _block_fns


def store_pad_objective(store: ShardedMatrixStore, loss) -> float:
    """f's value on the tail block's pad rows. Pad iterates stay at zero
    (zero D rows, zero aux), so this is a CONSTANT the driver subtracts
    from each sweep's objective — the only pad quantity that is not
    exactly zero (e.g. logistic: log 2 per pad row)."""
    pad = store.nblocks * store.block_rows - store.m
    if pad == 0:
        return 0.0
    ycols = getattr(loss, "ycols", 1)
    z = torch.zeros((pad,) if ycols == 1 else (pad, ycols),
                    dtype=torch.float32)
    a = torch.zeros((pad,), dtype=torch.float32)
    return float(loss.value(z, a if store.has_aux else None))


def _torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    name = np.dtype(name).name if not isinstance(name, str) else name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch dtype named {name!r}")
    return dt


def _host_tensor(a) -> Tensor:
    """A host iterate buffer as a tensor sharing its memory."""
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _copy_in(dst: Tensor, src: np.ndarray):
    """dst[:rows] = src (cast to dst's dtype), zeros past it. A writable
    array goes through torch's threaded copy; a read-only memory map
    through numpy where dst's dtype has a numpy twin (torch takes writable
    arrays only), else through a writable copy."""
    rows = src.shape[0]
    if src.flags.writeable:
        dst[:rows].copy_(torch.from_numpy(np.ascontiguousarray(src)))
    elif dst.dtype != torch.bfloat16:
        np.copyto(dst[:rows].numpy(), src, casting="unsafe")
    else:
        dst[:rows].copy_(torch.from_numpy(np.array(src)))
    if rows < dst.shape[0]:
        dst[rows:].zero_()


@dataclasses.dataclass
class StreamingEngine:
    """Block-streaming driver around an :class:`IterationEngine`.

    ``prefetch`` is the staging depth (blocks staged ahead of the one
    computing); ``prefetch=0`` is the naive synchronous baseline.
    ``device_dtype`` is the device-residency dtype (None: the store's);
    the cast happens AT STAGING TIME on the host, into the pinned slot, so
    the H2D moves residency bytes and the store keeps the data as
    collected. Labels and iterates stay in accumulation precision (f32, or
    f64 for f64 residency), also under bf16 residency. ``stage_seconds``
    sums the host staging copies (the producer thread's time in them)."""

    engine: object
    prefetch: int = 2
    device_dtype: Optional[str] = None
    stage_seconds: float = dataclasses.field(default=0.0, init=False)
    _pool: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False)

    @property
    def dev(self) -> torch.device:
        return self.engine.dev

    @property
    def _cuda(self) -> bool:
        return self.dev.type == "cuda"

    def residency_dtype(self, store: ShardedMatrixStore) -> torch.dtype:
        """dtype of the blocks the device actually sees."""
        return _torch_dtype(self.device_dtype or store.dtype.name)

    def acc_dtype(self, store: ShardedMatrixStore) -> torch.dtype:
        return gram_lib._acc_dtype(self.residency_dtype(store))

    def host_buffer(self, shape, dtype) -> Tensor:
        """A zeroed host buffer for m-sized iterates: pinned when the
        engine computes on the card (the D2H write-back lands there)."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self._cuda)

    # -- staging ------------------------------------------------------------
    def _slot(self, s: int, specs):
        """Pinned staging slot ``s`` for arrays of ``specs`` ((shape,
        dtype), ...), allocated once and reused while the shapes hold."""
        key = ("slot", s)
        got = self._pool.get(key)
        if got is None or got[0] != specs:
            got = (specs, [torch.empty(sh, dtype=dt, pin_memory=True)
                           for sh, dt in specs], None)
            self._pool[key] = got
        return got

    def _copy_stream(self):
        if "stream" not in self._pool:
            self._pool["stream"] = torch.cuda.Stream(self.dev)
        return self._pool["stream"]

    def _stage(self, store: ShardedMatrixStore):
        """The producer's stage: block k -> (k, device block, H2D event or
        None). Dense blocks are (block_rows, n) tensors, the tail
        zero-padded; sparse blocks are one-block BlockCSRs of block_rows
        logical rows."""
        res = self.residency_dtype(store)
        br = store.block_rows
        if not self._cuda:
            def stage_cpu(k):
                D_b, _ = store.block(k, padded=True)
                if store.sparse:
                    return k, D_b.astype(res), None
                D_b = np.require(D_b, requirements=["C", "W"])
                return k, torch.from_numpy(D_b).to(res), None
            return stage_cpu

        nslots = max(self.prefetch, 0) + 2
        dev, copy_stream = self.dev, self._copy_stream()
        if store.sparse:
            meta = store.sparse_meta
            specs = (((1, br, meta["kp"]), torch.int32),
                     ((1, br, meta["kp"]), res),
                     ((1, store.n, meta["kc"]), torch.int32),
                     ((1, store.n, meta["kc"]), res))
        else:
            specs = (((br, store.n), res),)

        def stage(k):
            s = k % nslots
            spec, bufs, last = self._slot(s, specs)
            if last is not None:
                last.synchronize()          # the slot's previous H2D
            raw, _ = store.raw_block(k)
            t0 = time.perf_counter()
            for buf, arr in zip(bufs, raw if store.sparse else (raw,)):
                _copy_in(buf[0] if store.sparse else buf, arr)
            self.stage_seconds += time.perf_counter() - t0
            with torch.cuda.device(dev), torch.cuda.stream(copy_stream):
                out = [b.to(dev, non_blocking=True) for b in bufs]
                ev = torch.cuda.Event()
                ev.record(copy_stream)
            self._pool[("slot", s)] = (spec, bufs, ev)
            if store.sparse:
                from repro_torch.data.sparse import BlockCSR
                return k, BlockCSR(*out, m=br, n=store.n,
                                   nnz=br * meta["kp"]), ev
            return k, out[0], ev

        return stage

    def stream_blocks(self, store: ShardedMatrixStore,
                      overlap: Optional[bool] = None) -> Iterator:
        """``(k, D_b)`` for every block, each ready for use on the compute
        stream (the caller's current stream). The caller must drop its
        reference to a block before asking for the next one: that is what
        bounds the blocks in flight."""
        depth = self.prefetch if overlap in (None, True) else 0
        for item in staged(range(store.nblocks), self._stage(store), depth):
            k, D_b, ev = item
            item = None
            self._on_compute(D_b, ev, wait_host=depth == 0)
            yield k, D_b
            D_b = None

    def stage_block(self, store: ShardedMatrixStore, k: int):
        """Block ``k`` alone, staged and ready on the compute stream: the
        cluster worker's path, which visits the blocks it owns one at a
        time and reads its results back before the next one (so the
        pinned slots are free again by then)."""
        _, D_b, ev = self._stage(store)(k)
        self._on_compute(D_b, ev, wait_host=False)
        return D_b

    def _on_compute(self, D_b, ev, wait_host: bool):
        """Make a staged block safe to use on the compute stream: wait for
        its H2D there (and on the host too when ``wait_host``), and tell the
        caching allocator which stream reads its memory."""
        if ev is None:
            return
        if wait_host:
            ev.synchronize()
        compute = torch.cuda.current_stream(self.dev)
        compute.wait_event(ev)
        for t in _tensors(D_b):
            t.record_stream(compute)

    def _aux(self, store: ShardedMatrixStore, dtype) -> Optional[Tensor]:
        """The store's labels as one host tensor (pinned on the card),
        built once per store: m-sized like the iterates."""
        if not store.has_aux:
            return None
        got = self._pool.get("aux")
        if got is None or got[0] is not store or got[1].dtype != dtype:
            a = self.host_buffer((store.m,), dtype)
            for k in range(store.nblocks):
                _, a_b = store.raw_block(k)
                _copy_in(a[store.block_slice(k)], np.asarray(a_b))
            got = (store, a)
            self._pool["aux"] = got
        return got[1]

    def _up(self, host: Tensor, sl: slice, rows: int) -> Tensor:
        """Rows ``sl`` of a host vector on the device, zero-padded to
        ``rows`` (an H2D on the compute stream)."""
        part = host[sl]
        if part.shape[0] == rows:
            return part.to(self.dev, non_blocking=True)
        out = torch.zeros((rows,) + tuple(host.shape[1:]), dtype=host.dtype,
                          device=self.dev)
        out[:part.shape[0]].copy_(part, non_blocking=True)
        return out

    def _down(self, host: Tensor, sl: slice, dev_vec: Tensor):
        """Rows ``sl`` of a device vector back into the host buffer (a
        non-blocking D2H on the compute stream)."""
        host[sl].copy_(dev_vec[:sl.stop - sl.start], non_blocking=True)

    def _sync(self):
        if self._cuda:
            torch.cuda.current_stream(self.dev).synchronize()

    # -- setup: Gram over the store, a few blocks resident at a time -------
    def gram_from_store(self, store: ShardedMatrixStore) -> Tensor:
        if store.sparse:
            # the sparse Gram is a HOST pass (scipy, kernels/spgram/ops.py):
            # the blocks are host arrays already, nothing is staged, and no
            # residency cast (quantizing a host-only pass only degrades G)
            from repro_torch.engine.engine import gram_stats
            backend = "reference" if self.engine.backend == "reference" \
                else "auto"
            G = None
            for k in range(store.nblocks):
                D_b, _ = store.block(k, padded=True)
                Gb, _ = gram_stats(D_b, backend=backend)
                G = Gb.double() if G is None else G + Gb.double()
            return G.to(device=self.dev, dtype=Gb.dtype)
        _, _, gram = _block_fns(self.engine, store.has_aux)
        G = torch.zeros((store.n, store.n), dtype=torch.float64,
                        device=self.dev)
        for _, D_b in self.stream_blocks(store):
            G = gram(G, D_b)
            D_b = None
        return G.to(self.acc_dtype(store))

    # -- warm start: y = D x0 per block, d = D^T y in the same pass --------
    def init_from_x0(self, store: ShardedMatrixStore, x0: Tensor,
                     y) -> Tensor:
        _, init, _ = _block_fns(self.engine, store.has_aux,
                                sparse=store.sparse)
        y = _host_tensor(y)
        x0 = x0.to(self.dev)
        d = None
        for k, D_b in self.stream_blocks(store):
            y_b, d_b = init(D_b, x0)
            D_b = None
            d = d_b.double() if d is None else d + d_b
            self._down(y, store.block_slice(k), y_b)
            y_b = None
        self._sync()
        return d.to(d_b.dtype)

    # -- one full iteration sweep ------------------------------------------
    def sweep(self, store: ShardedMatrixStore, x: Tensor, y, lam,
              overlap: Optional[bool] = None,
              want_dual: bool = True) -> SweepResult:
        """Stream every block through the fused body once: updates the
        host-resident (y, lam) (tensors, or numpy arrays updated through a
        shared view) in place and returns the n-sized / scalar
        accumulators. ``overlap=False`` forces the synchronous baseline
        whatever the prefetch depth. ``want_dual=False`` runs the lean body
        (d only; the other accumulators come back as their zero init)."""
        step, _, _ = _block_fns(self.engine, store.has_aux, want_dual,
                                sparse=store.sparse)
        y, lam = _host_tensor(y), _host_tensor(lam)
        acc_dt = self.acc_dtype(store)
        aux = self._aux(store, acc_dt)
        x = x.to(self.dev)
        acc = _zero_sweep(store.n, torch.float64,
                          getattr(self.engine.loss, "ycols", 1), self.dev)
        br = store.block_rows
        sync_each = overlap is False or self.prefetch <= 0
        for k, D_b in self.stream_blocks(store, overlap):
            sl = store.block_slice(k)
            y_b, lam_b = self._up(y, sl, br), self._up(lam, sl, br)
            a_b = self._up(aux, sl, br) if aux is not None else None
            y_new, lam_new, acc = step(D_b, a_b, y_b, lam_b, x, acc)
            D_b = y_b = lam_b = a_b = None
            self._down(y, sl, y_new)
            self._down(lam, sl, lam_new)
            y_new = lam_new = None
            if sync_each:
                self._sync()
        self._sync()
        return SweepResult(*(t.to(acc_dt) for t in acc))

    # -- pad-objective correction ------------------------------------------
    def pad_objective(self, store: ShardedMatrixStore) -> float:
        """See :func:`store_pad_objective`."""
        return store_pad_objective(store, self.engine.loss)


def _tensors(D_b):
    """The device tensors of a staged block (dense or one-block CSR)."""
    if isinstance(D_b, Tensor):
        return (D_b,)
    return (D_b.indices, D_b.values, D_b.col_indices, D_b.col_values)


# ---------------------------------------------------------------------------
# the out-of-core solve driver (UnwrappedADMM.solve_streaming delegates here)
# ---------------------------------------------------------------------------

def solve_streaming(solver, store: ShardedMatrixStore, max_iters: int = 500,
                    x0: Optional[Tensor] = None, record: bool = False,
                    overlap: bool = True, prefetch: int = 2,
                    device_dtype: Optional[str] = None,
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_every: int = 0, resume: bool = False,
                    obs=None):
    """Out-of-core unwrapped ADMM over a row-block store.

    Same semantics as ``UnwrappedADMM.solve`` (Boyd stopping rule, warm
    start) but D is never device-resident: setup is one Gram sweep, each
    iteration one fused sweep, and the m-sized iterates live in host
    buffers. Returns an ``ADMMResult`` with ``y``/``lam`` shaped (1, m);
    ``history`` is populated when ``record``.

    ``checkpoint_dir`` + ``checkpoint_every = K`` persist the loop state
    (x, y, lam, d, iter) every K iterations through
    :class:`repro_torch.checkpoint.manager.CheckpointManager`, and
    ``resume=True`` restores the newest step and continues BITWISE: the
    restored state is exactly the live state, so the remaining iterations
    replay the same operations. ``record`` history restarts from the
    resume point. The checkpoint is bound to the store's content
    fingerprint — resuming against different data refuses.
    """
    from repro_torch.exec import StreamingExecutor, solve_with_executor

    ex = StreamingExecutor(solver.engine, store, overlap=overlap,
                           prefetch=prefetch, device_dtype=device_dtype)
    return solve_with_executor(
        ex, loss=solver.loss, tau=solver.tau, rho=solver.rho,
        eps_rel=solver.eps_rel, eps_abs=solver.eps_abs,
        max_iters=max_iters, x0=x0, record=record,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        resume=resume, obs=obs)
