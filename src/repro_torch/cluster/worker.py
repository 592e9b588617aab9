"""The cluster worker process — owns row blocks, ships n-vector reductions.

One worker = one OS process (spawned by the coordinator, or launched by
hand pointing at the coordinator's address). It:

  * opens the shared :class:`~repro_torch.data.store.ShardedMatrixStore`
    READ-ONLY (mmap) and verifies every assigned block's content against
    the store's write-time fingerprints before touching it;
  * keeps the m_i-sized iterates (y, lam) of its blocks in HOST numpy
    buffers and runs the per-iteration body through the SAME fused step
    the streaming engine uses (``engine.streaming.block_step_fns`` ->
    ``IterationEngine.iterate``: K3 for a dense block, K6 for a sparse
    one on the card) — one device-resident block at a time, so worker
    device memory is bounded by one block;
  * per iteration ships ONE :class:`~repro_torch.cluster.reduction
    .Contribution` (three n-vectors + scalars) up the reduce tree —
    merging its children's partials first — optionally int8-compressed
    with per-sender error feedback;
  * heartbeats the coordinator and dies loudly (any exception is
    reported upstream as an ``error`` message before exit).

Recovery contract: a worker's iterates are a deterministic function of
(block content, x_1..x_k), so the coordinator never backs them up — an
``assign`` mid-solve carries a base state (possibly empty) plus the
x-history since, and the new owner REPLAYS the fused body over just
those blocks to reconstruct (y, lam) exactly. Per-block iteration
counters make retried broadcasts idempotent: a block already at
iteration k answers from its cached contribution instead of applying
the prox twice.

Fault injection: the legacy per-worker knobs ``die_at_iter`` (SIGKILL on
that iteration's broadcast) and ``slow_ms`` (per-iteration delay) remain,
and a ``chaos`` spec string (see :mod:`repro_torch.cluster.chaos`) schedules
seeded kill/stop/slow process faults plus wire faults on the data plane.

Self-healing: when the coordinator link drops and ``reconnect`` is
configured, the worker does NOT exit — it discards all block state
(everything is reconstructible from the store + the coordinator's base
state and x-history), dials the coordinator with exponential backoff +
jitter, re-registers, re-verifies its assigned blocks, and rejoins the
solve. This is both halves of DESIGN.md §13's recovery loop: a worker
the coordinator force-retired (blown deadline, dropped contribution)
comes back as a mid-solve JOIN, and a relaunched coordinator finds its
old workers dialing the same port.

Port of ``repro/cluster/worker.py``. The worker computes on the device
its config names (``"cuda"`` by default: card ``wid`` modulo the card
count, so workers share cards when there are fewer cards than workers;
``"cpu"`` on ask). A worker that cannot get its device fails at start and
reports the traceback upstream; nothing falls back to the CPU. Each block
is staged from the (memory-mapped, read-only) store into a reusable
pinned slot and copied to the card from there
(:meth:`~repro_torch.engine.streaming.StreamingEngine.stage_block`), the
block's (y, lam) go up with it, and one transfer per block brings back
the new iterates and one the contribution. Contributions carry numpy
float32 vectors, never tensors. Before its final ``bye`` the worker folds
the kernel wrappers' launch counters (K2a, K2b, K3 by route, K6), its
host staging time and bytes and its peak device memory into its registry.
"""
from __future__ import annotations

import os
import queue
import signal
import threading
import time
import traceback
from typing import Dict, Optional

from repro_torch.cluster.chaos import NOOP, make_injector
from repro_torch.cluster.transport import (
    ByteCounter,
    Connection,
    ConnectionClosed,
    Listener,
    connect,
)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

_THREAD_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")

_HEARTBEAT_TYPES = ("heartbeat",)


def make_loss(spec: dict):
    """ProxLoss from a picklable spec — the coordinator cannot ship the
    ProxLoss itself (closures don't pickle), so both ends build it from
    ``{"name": ..., **params}`` through the one registry-backed factory
    in :mod:`repro_torch.core.prox` (every registered loss is cluster-capable
    with zero per-topology code)."""
    from repro_torch.core.prox import loss_from_spec
    return loss_from_spec(spec)


def _setup_env(config: dict):
    """Thread knobs BEFORE torch is imported. Many worker processes
    timeshare the host's cores; unbounded per-process OpenMP/BLAS pools
    thrash, so workers default to single-threaded host compute (the
    coordinator overrides via config on big hosts)."""
    if config.get("limit_threads", True):
        for var in _THREAD_ENV:
            os.environ.setdefault(var, "1")


class WorkerRuntime:
    """Single-threaded state machine over one inbox; receiver threads
    (coordinator link + one per peer connection) only enqueue."""

    def __init__(self, wid: int, coord_addr, config: dict):
        import torch

        from repro_torch.data.store import ShardedMatrixStore
        from repro_torch.device import resolve_device
        from repro_torch.sharding.compat import rank_device

        if config.get("limit_threads", True):
            torch.set_num_threads(1)
        # card wid % card count for an unindexed cuda; raises without the
        # device (no fallback to the CPU)
        self.dev = rank_device(resolve_device(config.get("device", "cuda")),
                               wid)
        if self.dev.type == "cuda":
            torch.cuda.set_device(self.dev)

        self.wid = wid
        self.config = config
        # one registry backs everything the worker measures: wire bytes
        # (via ByteCounter), block-step / iteration latency histograms,
        # replay and retry counters. Heartbeats ship its snapshot; the
        # coordinator folds it per-worker (DESIGN.md §12).
        self.metrics = MetricsRegistry()
        self.counter = ByteCounter(registry=self.metrics)
        self.tracer = Tracer(enabled=bool(config.get("obs")),
                             process_name=f"worker-{wid}")
        self.store = ShardedMatrixStore.open(config["store_path"])
        self.loss = make_loss(config["loss"])
        self.tau = float(config.get("tau", 1.0))
        self.compress = bool(config.get("compress", False))
        self.staleness = bool(config.get("staleness", False))
        self._ef_err = None               # error-feedback residual for d

        from repro_torch.engine import IterationEngine
        from repro_torch.engine.streaming import (
            StreamingEngine,
            block_step_fns,
        )

        self.engine = IterationEngine(
            loss=self.loss, tau=self.tau,
            backend=config.get("backend", "auto"), device=str(self.dev))
        # one block staged at a time: pinned slots reused across blocks
        self._stager = StreamingEngine(engine=self.engine, prefetch=0)
        self._staged_s = 0.0              # stager seconds already observed
        self._folded: Dict[str, int] = {}  # launch counts already folded
        self._step, _, _ = block_step_fns(
            self.engine, self.store.has_aux, True,
            sparse=self.store.sparse)
        self._step_lean, _, _ = block_step_fns(
            self.engine, self.store.has_aux, False,
            sparse=self.store.sparse)

        # per-block state: padded host iterates + iteration counter +
        # cached last contribution (idempotent retries)
        self.blocks: Dict[int, dict] = {}

        self.inbox: "queue.Queue" = queue.Queue()
        self.peers = Listener()           # children connect here
        self.coord_addr = tuple(coord_addr)
        # seeded fault injection (no-op singleton when unconfigured)
        self.chaos = make_injector(config.get("chaos"), f"w{wid}")
        self._conn_chaos = self.chaos if self.chaos.enabled else None
        # reconnect knobs: {} disables (lose the coordinator -> exit);
        # retries/backoff_s/backoff_max_s feed transport.connect
        self.reconnect = dict(config.get("reconnect") or {})
        self._gen = 0                     # coordinator-link generation
        self._registrations = 0
        self._parent_conns: Dict[tuple, Connection] = {}
        self.topology = {"epoch": -1, "parent": None, "nchildren": 0}
        self._task = None                 # in-flight tree reduce
        self._peer_buf = []               # children ahead of our own iter
        self._stop = threading.Event()
        self.coord: Connection = None
        self._attach(retries=int(self.reconnect.get("retries", 3)))

    # -- coordinator link --------------------------------------------------
    def _attach(self, retries: int):
        """Dial the coordinator (with backoff), register, and start this
        link's receiver + heartbeat threads. Each attach bumps the link
        generation so a stale thread's death notice cannot tear down a
        newer link.

        A register that fails on a link that just connected counts as a
        failed dial and is retried within the same budget: a listening
        socket that is being closed can still complete a handshake (its
        backlog lives until the last reference to it goes) and then
        resets the link, which is what a crashed coordinator's port does
        for a moment. The reference gave up on that first reset
        (``repro/cluster/worker.py:160-178``, ROADMAP section 3)."""
        self._gen += 1
        gen = self._gen
        backoff = float(self.reconnect.get("backoff_s", 0.5))
        backoff_max = float(self.reconnect.get("backoff_max_s", 5.0))
        attempt = 0
        while True:
            self.coord = connect(
                self.coord_addr, counter=self.counter,
                chaos=self._conn_chaos, retries=retries - attempt,
                backoff_s=backoff, backoff_max_s=backoff_max)
            try:
                self.coord.send("register", wid=self.wid,
                                peer_addr=self.peers.address,
                                store_fingerprint=self.store.fingerprint,
                                pid=os.getpid(),
                                rejoin=self._registrations > 0)
                break
            except ConnectionClosed:
                self.coord.close()
                if attempt >= retries:
                    raise
                time.sleep(min(backoff * 2.0 ** attempt, backoff_max))
                attempt += 1
        self._registrations += 1
        threading.Thread(target=self._coord_rx,
                         args=(self.coord, gen), daemon=True).start()
        threading.Thread(target=self._heartbeat,
                         args=(self.coord,), daemon=True).start()

    def _reset_state(self):
        """Drop everything tied to the lost coordinator: block iterates,
        in-flight reduce, buffered peer partials, parent links. All of it
        is reconstructible from (store, base state, x-history) at the
        next assignment — keeping any of it risks folding a dead epoch's
        state into the new coordinator's solve."""
        self.blocks.clear()
        self._task = None
        self._peer_buf = []
        self._ef_err = None
        for conn in self._parent_conns.values():
            try:
                conn.close()
            except OSError:
                pass
        self._parent_conns = {}
        self.topology = {"epoch": -1, "parent": None, "nchildren": 0}
        self.metrics.inc("worker.reconnects")

    # -- threads -----------------------------------------------------------
    def _coord_rx(self, conn: Connection, gen: int):
        try:
            while not self._stop.is_set():
                msg = conn.recv()
                self.inbox.put(("cmd", msg))
        except ConnectionClosed:
            self.inbox.put(("cmd_closed", gen))

    def _peer_rx(self, conn: Connection):
        try:
            while not self._stop.is_set():
                msg = conn.recv()
                if msg.get("type") == "contrib":
                    self.inbox.put(("peer", msg))
        except ConnectionClosed:
            pass

    def _peer_accept(self):
        while not self._stop.is_set():
            conn = self.peers.accept(timeout=0.5, counter=self.counter)
            if conn is not None:
                threading.Thread(target=self._peer_rx, args=(conn,),
                                 daemon=True).start()

    def _heartbeat(self, conn: Connection):
        interval = float(self.config.get("heartbeat_interval", 0.5))
        while not self._stop.is_set():
            try:
                conn.send("heartbeat", wid=self.wid,
                          t=time.monotonic(),
                          metrics=self.metrics.snapshot())
            except ConnectionClosed:
                return                    # link died; a reattach starts
                                          # its own heartbeat thread
            self._stop.wait(interval)

    # -- block state -------------------------------------------------------
    def _init_block(self, bid: int, base_iter: int, base=None,
                    verified: bool = False):
        import numpy as np
        if not verified and not self.store.verify_block(bid):
            raise RuntimeError(
                f"worker {self.wid}: store block {bid} content does not "
                f"match its write-time fingerprint — refusing assignment")
        br = self.store.block_rows
        ycols = getattr(self.loss, "ycols", 1)
        shape = (br,) if ycols == 1 else (br, ycols)
        y = np.zeros(shape, np.float32)
        lam = np.zeros(shape, np.float32)
        if base is not None:
            y_l, lam_l = base
            y[: len(y_l)] = y_l
            lam[: len(lam_l)] = lam_l
        self.blocks[bid] = {"y": y, "lam": lam, "iter": int(base_iter),
                            "contrib": None}

    def _apply_block(self, bid: int, x_dev, k: int, want_dual: bool):
        """Advance one block's iterates by one fused step; cache its
        contribution for iteration k."""
        import numpy as np
        import torch

        from repro_torch.cluster.reduction import Contribution
        from repro_torch.engine.streaming import _zero_sweep

        st = self.blocks[bid]
        t0 = time.perf_counter()
        with self.tracer.span("block_step", block=bid, k=k):
            D_b, a_b = self._device_block(bid)
            step = self._step if want_dual else self._step_lean
            acc = _zero_sweep(self.store.n, torch.float32,
                              getattr(self.loss, "ycols", 1),
                              device=self.dev)
            y_new, lam_new, acc = step(
                D_b, a_b, torch.from_numpy(st["y"]).to(self.dev),
                torch.from_numpy(st["lam"]).to(self.dev), x_dev, acc)
            D_b = a_b = None
            # one transfer back for the iterates, one for the reductions
            y_lam = torch.stack([y_new, lam_new]).cpu().numpy()
            st["y"], st["lam"] = y_lam[0], y_lam[1]
            st["iter"] = k
            if want_dual:
                n = acc.d.numel()
                red = torch.cat([acc.d.reshape(-1), acc.w.reshape(-1),
                                 acc.v.reshape(-1),
                                 torch.stack([acc.r_sq, acc.dx_sq,
                                              acc.y_sq, acc.obj])])
                red = red.cpu().numpy()
        self.metrics.observe("worker.block_step_s",
                             time.perf_counter() - t0)
        if want_dual:
            sl = self.store.block_slice(bid)
            # wire format: reductions travel FLAT — (n, K) ravels to
            # (n*K,) so tree merge + int8 compression stay shape-blind
            st["contrib"] = Contribution(
                iteration=k, workers=(self.wid,),
                rows=sl.stop - sl.start,
                d=red[:n], w=red[n:2 * n], v=red[2 * n:3 * n],
                scalars={"r_sq": float(red[3 * n]),
                         "dx_sq": float(red[3 * n + 1]),
                         "y_sq": float(red[3 * n + 2]),
                         "obj": float(red[3 * n + 3])})

    def _device_block(self, bid: int):
        """Block ``bid`` and its labels on the worker's device, zero-padded
        to the uniform block height. The dense rows go through a pinned
        staging slot (host copy timed into ``worker.stage_s``)."""
        import numpy as np
        import torch

        D_b = self._stager.stage_block(self.store, bid)
        spent = self._stager.stage_seconds - self._staged_s
        if spent:
            self._staged_s = self._stager.stage_seconds
            self.metrics.observe("worker.stage_s", spent)
            self.metrics.inc("worker.stage_bytes", int(D_b.nbytes))
        if not self.store.has_aux:
            return D_b, None
        _, a_b = self.store.raw_block(bid)
        a = np.zeros((self.store.block_rows,), np.float32)
        a[: a_b.shape[0]] = a_b
        return D_b, torch.from_numpy(a).to(self.dev)

    def fold_kernel_counts(self):
        """Fold the kernel wrappers' launch counters (process-wide, since
        this process started) into the registry as
        ``worker.kernel_launches{kernel=...}``, plus the peak device
        memory as a gauge."""
        import torch

        from repro_torch.kernels.admm_iter import ops as admm_ops
        from repro_torch.kernels.gram import ops as gram_ops
        from repro_torch.kernels.spgram import ops as sp_ops
        it = admm_ops.admm_iter_full
        counts = {"K2a": gram_ops.gram.launches,
                  "K2b": gram_ops.gram_and_rhs.launches,
                  "K3_ring": it.launches_ring, "K3_wide": it.launches_wide,
                  "K6": sp_ops.sparse_admm_iter_full.launches}
        for name, total in counts.items():
            delta = total - self._folded.get(name, 0)
            if delta:
                self.metrics.inc("worker.kernel_launches", delta,
                                 kernel=name)
            self._folded[name] = total
        if self.dev.type == "cuda":
            self.metrics.set_gauge("worker.peak_device_bytes",
                                   torch.cuda.max_memory_allocated(self.dev))

    def _replay(self, bids, x_history):
        """Reconstruct (y, lam) for newly assigned blocks: the lean body
        over just these blocks, once per historical x."""
        import numpy as np
        import torch
        with self.tracer.span("replay", blocks=len(bids),
                              steps=len(x_history)):
            for x in np.asarray(x_history, np.float32):
                x_dev = torch.from_numpy(x).to(self.dev)
                for bid in bids:
                    self._apply_block(bid, x_dev,
                                      self.blocks[bid]["iter"] + 1,
                                      want_dual=False)
                self.metrics.inc("worker.replayed_steps", len(bids))

    # -- message handlers ---------------------------------------------------
    def _on_assign(self, msg):
        base_iter = int(msg.get("base_iter", 0))
        base_state = msg.get("base_state") or {}
        force = bool(msg.get("force", False))   # resume: overwrite state
        incoming = [bid for bid in msg["blocks"]
                    if force or bid not in self.blocks]
        # one batched content check so a bad assignment reports EVERY
        # mismatched block (join path: the joiner mmap-opened the store
        # cold and must prove it holds the same rows)
        bad = self.store.verify_blocks(incoming)
        if bad:
            raise RuntimeError(
                f"worker {self.wid}: store blocks {bad} do not match "
                "their write-time fingerprints — refusing assignment")
        fresh = []
        for bid in incoming:
            self._init_block(bid, base_iter, base_state.get(bid),
                             verified=True)
            fresh.append(bid)
        hist = msg.get("x_history")
        if hist is not None and len(hist) and fresh:
            self._replay(fresh, hist)
        self.coord.send("assigned", wid=self.wid, blocks=list(self.blocks),
                        at_iter={b: self.blocks[b]["iter"]
                                 for b in self.blocks})

    def _on_stats(self, msg):
        """Sufficient statistics of the asked blocks on the worker's
        device: K2b for a labeled dense block, K2a for an unlabeled one
        (on the card). Dense blocks are staged like the iteration's and
        cut back to their true rows; sparse blocks go up as they are."""
        from repro_torch.service.stats import SufficientStats
        bids = msg.get("blocks")
        if bids is None:
            bids = sorted(self.blocks)
        stats = SufficientStats.zero(self.store.n, device=self.dev)
        for bid in bids:
            sl = self.store.block_slice(bid)
            rows = sl.stop - sl.start
            if self.store.sparse:
                D_b, a_b = self.store.block(bid, padded=False)
            else:
                D_b, a_b = self._device_block(bid)
                D_b = D_b[:rows]
                a_b = a_b[:rows] if a_b is not None else None
            stats = stats.update(
                D_b, a_b, block_fingerprint=self.store.fingerprints[bid])
        # to_payload() hands numpy arrays: no tensor goes on the wire
        self.coord.send("stats", wid=self.wid, blocks=list(bids),
                        **stats.to_payload())

    def _on_topology(self, msg):
        self.topology = {"epoch": int(msg["epoch"]),
                         "parent": (tuple(msg["parent"])
                                    if msg["parent"] else None),
                         "nchildren": int(msg["nchildren"])}
        if self._task and self._task["epoch"] < self.topology["epoch"]:
            self._task = None             # partials of a dead topology

    def _on_iter(self, msg):
        import numpy as np
        import torch

        from repro_torch.cluster.reduction import Contribution

        k = int(msg["k"])
        if (not self.staleness
                and int(msg["epoch"]) != self.topology["epoch"]):
            # a broadcast from a topology that died before we got to it;
            # the coordinator has already re-issued this iteration under
            # the new epoch (FIFO per link makes this purely defensive)
            return
        die_at = self.config.get("die_at_iter")
        if die_at is not None and k >= int(die_at):
            os.kill(os.getpid(), 9)       # fault injection: SIGKILL
        slow = float(self.config.get("slow_ms", 0.0))
        if slow:
            time.sleep(slow / 1e3)
        for kind, param in self.chaos.process_actions(k):
            if kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            elif kind == "stop":
                # a hang, not a death: the process keeps its sockets but
                # stops heartbeating — only the coordinator's staleness
                # detector can retire it (and only SIGKILL can reap it)
                os.kill(os.getpid(), signal.SIGSTOP)
            elif kind == "slow":
                time.sleep(param / 1e3)
        t_iter = time.perf_counter()
        x_dev = torch.from_numpy(
            np.array(msg["x"], np.float32)).to(self.dev)
        own = Contribution.zero(
            k, self.store.n * getattr(self.loss, "ycols", 1))
        with self.tracer.span("worker_iter", k=k):
            for bid in sorted(self.blocks):
                st = self.blocks[bid]
                if st["iter"] < k:
                    self._apply_block(bid, x_dev, k, want_dual=True)
                else:
                    # retried broadcast: answered from the cached
                    # contribution, no prox re-applied
                    self.metrics.inc("worker.retry_cached_answers")
                c = st["contrib"]
                assert c is not None and c.iteration == k, \
                    f"block {bid} at iter {st['iter']}, contrib for {k}?"
                own = own.merge(c)
        self.metrics.inc("worker.iters")
        self.metrics.observe("worker.iter_s", time.perf_counter() - t_iter)
        own = Contribution(iteration=k, workers=(self.wid,),
                           rows=own.rows, d=own.d, w=own.w, v=own.v,
                           scalars=own.scalars)
        self._task = {"k": k, "epoch": int(msg["epoch"]),
                      "partial": own, "from": {self.wid},
                      "need": self.topology["nchildren"]}
        # children may have delivered before our own broadcast arrived
        buf, self._peer_buf = self._peer_buf, []
        for pending in buf:
            self._on_peer(pending)
        self._maybe_transmit()

    def _on_peer(self, msg):
        from repro_torch.cluster.reduction import decode
        t = self._task
        ep, it = msg["epoch"], msg["payload"]["iteration"]
        if t is None or ep > t["epoch"] or (ep == t["epoch"]
                                            and it > t["k"]):
            # AHEAD of us (fast child beat our own iter broadcast):
            # buffer — dropping it would deadlock the parent's wait.
            # Each child sends once per (k, epoch), so the live window
            # is bounded by the child count; the cap only sheds entries
            # from topologies that died before we processed them.
            if ep >= self.topology["epoch"]:
                self._peer_buf.append(msg)
                cap = 2 * max(1, self.topology["nchildren"]) + 8
                del self._peer_buf[:-cap]
            return
        if ep < t["epoch"] or it < t["k"]:
            return                        # partial of a dead topology
        try:
            c = decode(msg["payload"])
        except ValueError:
            return                        # malformed partial: dropped;
                                          # the deadline retry recovers it
        if set(c.workers) & t["from"]:
            # a duplicated (chaos) or retried child partial that already
            # folded into this task — merging it again would double-count
            return
        t["from"] |= set(c.workers)
        t["partial"] = t["partial"].merge(c)
        t["need"] -= 1
        self._maybe_transmit()

    def _maybe_transmit(self):
        from repro_torch.cluster.reduction import encode
        t = self._task
        if t is None or t["need"] > 0:
            return
        payload, self._ef_err = encode(t["partial"], self.compress,
                                       self._ef_err)
        parent = self.topology["parent"]
        self._task = None
        if parent is None:
            self.coord.send("contrib", wid=self.wid, epoch=t["epoch"],
                            payload=payload)
            return
        try:
            conn = self._parent_conns.get(parent)
            if conn is None or conn.closed:
                conn = connect(parent, counter=self.counter,
                               chaos=self._conn_chaos,
                               retries=2, backoff_s=0.1)
                self._parent_conns[parent] = conn
            conn.send("contrib", wid=self.wid, epoch=t["epoch"],
                      payload=payload)
        except (ConnectionClosed, OSError):
            # parent died: the coordinator's failure detector will
            # rebuild the topology and re-issue this iteration; our
            # cached per-block contributions make the retry cheap.
            self._parent_conns.pop(parent, None)

    def _on_unassign(self, msg):
        """Mid-solve rebalance: blocks move to a joiner. Drop their
        state (the new owner replays it) — keeping it would answer a
        retried broadcast for a block we no longer own."""
        dropped = [bid for bid in msg["blocks"]
                   if self.blocks.pop(bid, None) is not None]
        self.metrics.inc("worker.blocks_unassigned", len(dropped))
        self.coord.send("unassigned", wid=self.wid, blocks=dropped)

    def _on_checkpoint(self, msg):
        state = {}
        for bid, st in self.blocks.items():
            sl = self.store.block_slice(bid)
            valid = sl.stop - sl.start
            state[bid] = (st["y"][:valid].copy(), st["lam"][:valid].copy(),
                          st["iter"])
        self.coord.send("ckpt", wid=self.wid, blocks=state)

    # -- main loop ----------------------------------------------------------
    def run(self):
        threading.Thread(target=self._peer_accept, daemon=True).start()
        while True:
            reason = self._serve()
            if reason == "stop" or not self.reconnect:
                break
            # coordinator link lost and self-healing configured: shed
            # state and re-register (covers both a worker the failure
            # detector retired and a relaunched coordinator)
            self._reset_state()
            try:
                self._attach(retries=int(self.reconnect.get("retries", 8)))
            except ConnectionClosed:
                break                     # coordinator truly gone
        self._stop.set()
        try:
            self.coord.close()
        except OSError:
            pass

    def _serve(self) -> str:
        """Pump the inbox until the solve stops ("stop") or the current
        coordinator link dies ("lost")."""
        handlers = {"assign": self._on_assign, "stats": self._on_stats,
                    "topology": self._on_topology, "iter": self._on_iter,
                    "unassign": self._on_unassign,
                    "checkpoint": self._on_checkpoint}
        while True:
            kind, msg = self.inbox.get()
            if kind == "cmd_closed":
                if msg == self._gen:
                    return "lost"
                continue                  # a previous link's obituary
            if kind == "peer":
                self._on_peer(msg)
                continue
            mtype = msg.get("type")
            if mtype == "stop":
                # every link (coordinator, peer server, parent hops)
                # shares self.counter, so one snapshot covers them all;
                # metrics + trace events ride along so the coordinator
                # can fold a final per-worker registry and render the
                # cluster solve as one timeline
                self.fold_kernel_counts()
                try:
                    self.coord.send("bye", wid=self.wid,
                                    counters=self.counter.snapshot(),
                                    metrics=self.metrics.snapshot(),
                                    trace=self.tracer.events(),
                                    pid=os.getpid())
                except ConnectionClosed:
                    pass
                return "stop"
            if mtype in _HEARTBEAT_TYPES:
                continue
            if mtype == "iter" and self.staleness:
                # bounded-staleness drain: a slow worker computes against
                # the NEWEST broadcast x rather than queueing up history
                msg = self._drain_to_newest(msg)
            handler = handlers.get(mtype)
            if handler is None:
                continue                  # unknown command: ignore
            try:
                handler(msg)
            except ConnectionClosed:
                # the coordinator link died mid-handler (chaos reset, or
                # a send into a closed socket): same as cmd_closed
                return "lost"

    def _drain_to_newest(self, msg):
        while True:
            try:
                kind, nxt = self.inbox.get_nowait()
            except queue.Empty:
                return msg
            if kind == "peer":
                self._on_peer(nxt)
            elif kind == "cmd" and nxt.get("type") == "iter":
                msg = nxt                 # supersedes the queued one
            elif kind == "cmd" and nxt.get("type") in _HEARTBEAT_TYPES:
                continue
            else:
                self.inbox.put((kind, nxt))   # non-iter cmd: keep order
                return msg


def worker_entry(wid: int, coord_host: str, coord_port: int, config: dict):
    """multiprocessing spawn target. Sets the thread env BEFORE torch is
    imported, then hands off to the runtime; any failure (a device that
    is not there included) is reported to the coordinator as an
    ``error`` message."""
    _setup_env(config)
    rt = None
    try:
        rt = WorkerRuntime(wid, (coord_host, coord_port), config)
        rt.run()
    except Exception:
        tb = traceback.format_exc()
        try:
            if rt is not None:
                rt.coord.send("error", wid=wid, traceback=tb)
            else:
                conn = connect((coord_host, coord_port))
                conn.send("error", wid=wid, traceback=tb)
        except Exception:
            pass
        raise
