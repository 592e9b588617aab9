"""The cluster coordinator — the paper's "central server", productionized.

Drives a fault-tolerant unwrapped-ADMM solve over worker PROCESSES
(DESIGN.md §11). Per iteration the coordinator does exactly what Alg. 2
assigns the central node: solve the cached-Gram system for x from the
summed n-vector reduction d, broadcast x, wait for the next reduction.
Everything m-sized stays at the workers; the coordinator's working set
is O(n^2) (the factor) + O(n) per iteration + the x-history it keeps
for recovery.

Fault tolerance (strict mode): worker death is detected by link EOF
(one socket read after a SIGKILL) or heartbeat age. Recovery marks the
worker dead, spreads its orphaned blocks over the least-loaded
survivors (store fingerprints verify content at the new owner), ships
the x-history so the new owner REPLAYS the fused body to reconstruct
the orphans' iterates exactly, bumps the topology epoch, and re-issues
the in-flight iteration — survivors answer the retry from their cached
per-block contributions, so a retry costs one pass over the orphaned
blocks only. The solve then continues to the same answer as an
undisturbed run.

Bounded staleness (``staleness S > 0``): star topology; the coordinator
proceeds once a quorum of workers has contributed at the current
iteration AND no live worker lags more than S iterations; missing
workers are represented by their latest cached reduction, and a late
arrival REPLACES its stale cache entry — coordinator-side error
feedback: the stale estimate's error is corrected the moment the true
reduction lands, rather than lost. Inexact per-iteration reductions of
this kind are exactly what consensus-ADMM theory tolerates (Chang et
al. 2014), and the transpose reduction is partition-insensitive (Wu et
al. 2024), which is what makes elastic membership sound here.

Checkpoint/resume: every ``checkpoint_every`` iterations the
coordinator gathers (y, lam) slices from the workers, assembles the
full iterate, and persists (x, y, lam, d, iter) through
``repro_torch.checkpoint.manager.CheckpointManager``; ``resume=True``
restores the newest step and continues. The gathered state also
becomes the recovery base, truncating the replayed x-history.

Port of ``repro/cluster/coordinator.py``. ``ClusterConfig.device`` (the
reference's ``jax_platforms``) names where the coordinator and its
workers compute: ``"cuda"`` by default, ``"cpu"`` on ask. The coordinator
keeps its Gram factor and x-update on that device (through the shared
driver); workers are spawned with the ``spawn`` start method, which CUDA
requires, so a script that starts a cluster must guard its entry point
with ``if __name__ == "__main__":``.
"""
from __future__ import annotations

import dataclasses
import queue
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cluster import compress
from repro_torch.cluster.chaos import ChaosSchedule, FaultInjector
from repro_torch.cluster.membership import DeadCluster, Membership, WorkerInfo
from repro_torch.cluster.reduction import Contribution, TreeTopology, decode
from repro_torch.cluster.transport import (
    ByteCounter,
    ConnectionClosed,
    Listener,
)
from repro_torch.cluster.worker import make_loss, worker_entry
from repro_torch.obs import Observability
from repro_torch.obs.metrics import (
    merged_histogram,
    snapshot_counters,
    snapshot_histograms,
    summarize_histogram,
)

REDUCTION_TAGS = ("contrib",)            # what counts as reduction wire
BROADCAST_TAGS = ("iter",)


class ClusterError(RuntimeError):
    pass


@dataclasses.dataclass
class DegradePolicy:
    """Graceful degradation instead of an indefinite hang (DESIGN.md §13).

    ``iter_deadline_s`` bounds how long one iteration may wait for its
    reduction. On expiry the coordinator first RETRIES (strict mode:
    reset the accumulator and re-broadcast — survivors answer from their
    cached contributions, so a lost/dropped message costs one cheap
    round trip; staleness mode: relax the quorum to ``min_quorum`` and
    the bound to ``max_staleness`` for that round). After
    ``deadline_retries`` fruitless extensions — or when deaths shrink
    the live set below ``min_quorum`` of the spawned workers — the solve
    STOPS and returns the best-so-far x with ``status="degraded"``
    rather than hanging forever. Without a policy the previous behavior
    (wait indefinitely, raise on total death) is unchanged."""

    iter_deadline_s: float = 60.0
    deadline_retries: int = 2
    min_quorum: float = 0.25
    max_staleness: int = 8

    def __post_init__(self):
        if not 0.0 < self.min_quorum <= 1.0:
            raise ValueError(
                f"min_quorum must be in (0, 1], got {self.min_quorum}")
        if self.iter_deadline_s <= 0:
            raise ValueError("iter_deadline_s must be positive")
        if self.deadline_retries < 0 or self.max_staleness < 0:
            raise ValueError("retries/staleness must be >= 0")


@dataclasses.dataclass
class ClusterConfig:
    """Runtime shape. ``staleness == 0`` is the strict mode: tree reduce,
    every block in every iteration, retries on failure. ``staleness =
    S > 0`` switches to star + quorum with the bound S."""

    n_workers: int = 2
    compress: bool = False
    fanout: int = 2
    staleness: int = 0
    quorum: float = 1.0
    heartbeat_interval_s: float = 0.5
    heartbeat_timeout_s: float = 15.0
    register_timeout_s: float = 180.0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False
    backend: str = "auto"
    limit_threads: bool = True
    device: str = "cuda"                 # coordinator + workers; a worker
                                         # takes card wid % device_count
    obs_dir: Optional[str] = None        # observability run directory:
                                         # trace.json / metrics.json /
                                         # telemetry.jsonl (DESIGN.md §12)
    worker_overrides: Dict[int, dict] = dataclasses.field(
        default_factory=dict)
    port: int = 0                        # fixed listen port (0 = OS pick);
                                         # a relaunched coordinator reuses
                                         # the old port so workers find it
    spawn: bool = True                   # False: adopt re-registering
                                         # workers instead of spawning
                                         # (the coordinator-relaunch path)
    degrade: Optional[DegradePolicy] = None
    chaos: Optional[object] = None       # ChaosSchedule or its spec string
    reconnect: Optional[dict] = None     # worker self-heal knobs shipped
                                         # in every worker config, e.g.
                                         # {"retries": 8, "backoff_s": 0.3}

    def __post_init__(self):
        if self.staleness > 0 and self.checkpoint_every > 0:
            # a checkpoint needs every block at ONE iteration; quorum
            # mode holds workers at mixed iterations by design, so the
            # gather would skip every round — refuse loudly instead of
            # silently never writing a checkpoint the user relies on
            raise ValueError(
                "checkpointing requires the strict synchronous mode "
                "(staleness=0): bounded-staleness iterates are never "
                "at a single consistent iteration")
        if not 0.0 < self.quorum <= 1.0:
            raise ValueError(f"quorum must be in (0, 1], got {self.quorum}")
        if isinstance(self.chaos, str):
            self.chaos = ChaosSchedule.parse(self.chaos)
        if not self.spawn and self.n_workers < 1:
            raise ValueError("spawn=False still needs n_workers >= 1 "
                             "expected re-registrations")


@dataclasses.dataclass
class ClusterResult:
    x: np.ndarray
    iters: int
    converged: bool
    history: Optional[dict]              # objective/primal_res/dual_res lists
    telemetry: dict
    status: str = "ok"                   # converged | max_iters | degraded


class ClusterCoordinator:
    def __init__(self, store_path: str, loss: dict, tau: float = 1.0,
                 rho: float = 0.0, eps_rel: float = 1e-3,
                 eps_abs: float = 1e-6,
                 config: Optional[ClusterConfig] = None):
        from repro_torch.data.store import ShardedMatrixStore
        from repro_torch.device import resolve_device

        self.cfg = config or ClusterConfig()
        self.dev = resolve_device(self.cfg.device)
        self.store_path = store_path
        self.store = ShardedMatrixStore.open(store_path)
        self.loss_spec = dict(loss)
        self.loss = make_loss(self.loss_spec)
        # reductions travel as FLAT f32 vectors; multi-column iterates
        # (ycols=K) ravel to n*K on the wire (repro_torch.exec.cluster)
        self._red_n = self.store.n * getattr(self.loss, "ycols", 1)
        self.tau, self.rho = float(tau), float(rho)
        self.eps_rel, self.eps_abs = float(eps_rel), float(eps_abs)
        self.members = Membership()
        # the coordinator's wire accounting lives in the obs registry
        # (ByteCounter is registry-backed), so metrics.json and the
        # legacy telemetry counters come from one source of truth
        self.obs = Observability(dir=self.cfg.obs_dir,
                                 process_name="coordinator")
        self.counter = ByteCounter(registry=self.obs.registry)
        self.listener = Listener(port=self.cfg.port)
        self._events: "queue.Queue" = queue.Queue()
        self._epoch = 0
        self._topology: Optional[TreeTopology] = None
        self._started = False
        self._stats = None
        # recovery base: iterates at _base_iter (None = zeros) + x since
        self._base_iter = 0
        self._base_y: Optional[np.ndarray] = None
        self._base_lam: Optional[np.ndarray] = None
        self._x_hist: List[np.ndarray] = []   # [i] -> x of iter _base+i+1
        self._latest: Dict[int, Contribution] = {}   # staleness cache
        self._iters_run = 0
        self._retries = 0
        self._shutdown_result: Optional[dict] = None
        # elasticity / chaos / degradation state (DESIGN.md §13)
        self._procs: Dict[int, object] = {}        # every spawned Process
        self._pending_joins: List[Tuple[int, dict]] = []
        self._join_t0: Dict[int, float] = {}       # wid -> register time
        self._joins = 0
        self._accept_stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._recovery_log: List[dict] = []        # closed events
        self._open_recovery: List[dict] = []       # awaiting next collect
        self._degraded_rounds = 0
        self._status = "ok"
        self._crashed = False
        sched: Optional[ChaosSchedule] = self.cfg.chaos
        self._chaos_spec = sched.to_spec() if sched is not None else None
        self._chaos_joins = list(sched.for_kind("join")) if sched else []
        inj_events = sched.for_target("coord") if sched else ()
        self._coord_injector = (FaultInjector(inj_events)
                                if inj_events else None)

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def _worker_config(self, wid: int) -> dict:
        cfg = {"store_path": self.store_path, "loss": self.loss_spec,
               "tau": self.tau, "backend": self.cfg.backend,
               "compress": self.cfg.compress,
               "staleness": self.cfg.staleness > 0,
               "heartbeat_interval": self.cfg.heartbeat_interval_s,
               "limit_threads": self.cfg.limit_threads,
               "device": self.cfg.device,
               "obs": bool(self.cfg.obs_dir),
               "chaos": self._chaos_spec,
               "reconnect": self.cfg.reconnect}
        cfg.update(self.cfg.worker_overrides.get(wid, {}))
        return cfg

    def spawn_worker(self, wid: Optional[int] = None) -> int:
        """Launch one worker process against this coordinator's port —
        used at startup, by scheduled chaos ``join`` events, and by
        anything else that wants to grow the cluster mid-solve. The
        worker registers itself; the register lands in the event queue
        and (mid-solve) becomes a pending join."""
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        if wid is None:
            taken = set(self._procs) | set(self.members.workers)
            wid = max(taken, default=-1) + 1
        host, port = self.listener.address
        p = ctx.Process(target=worker_entry,
                        args=(wid, host, port, self._worker_config(wid)),
                        daemon=True)
        p.start()
        self._procs[wid] = p
        return wid

    def start(self):
        """Spawn workers (or, with ``spawn=False``, wait for the old
        ones to re-register), collect registrations, assign blocks."""
        if self._started:
            return
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        if self.cfg.spawn:
            for wid in range(self.cfg.n_workers):
                self.spawn_worker(wid)
        try:
            self._await_registrations()
        except BaseException:
            # a failed start must not leak spawned processes into a
            # long-lived host (daemon=True only reaps at interpreter
            # exit) — __exit__ never runs when __enter__ raises
            for p in self._procs.values():
                if p.is_alive():
                    p.terminate()
            self._accept_stop.set()
            self.listener.close()
            raise
        plan = self.members.initial_assignment(self.store.nblocks)
        for wid, blocks in plan.items():
            self._send_assign(wid, blocks, upto_iter=self._base_iter)
        self._broadcast_topology()
        self._started = True

    def _accept_loop(self):
        """Persistent accept thread: reads each new connection's first
        frame (the registration) and posts it into the event queue. This
        is what makes joins possible MID-solve — registration is no
        longer a startup-only phase."""
        while not self._accept_stop.is_set():
            try:
                conn = self.listener.accept(timeout=0.5,
                                            counter=self.counter)
            except OSError:
                return                   # listener closed: shutdown/crash
            if conn is None:
                continue
            try:
                msg = conn.recv(timeout=30.0)
            except ConnectionClosed:
                conn.close()
                continue
            if msg is None or msg.get("type") != "register":
                conn.close()
                continue
            msg["_conn"] = conn
            self._events.put((int(msg["wid"]), msg))

    def _admit(self, wid: int, msg, strict: bool = True) -> bool:
        """Turn a register message into a live member + receiver thread.
        ``strict`` raises on a store-fingerprint mismatch (startup);
        mid-solve joins reject the bad joiner instead of killing a
        healthy solve."""
        conn = msg["_conn"]
        if msg["store_fingerprint"] != self.store.fingerprint:
            if strict:
                raise ClusterError(
                    f"worker {wid} opened a store with fingerprint "
                    f"{msg['store_fingerprint'][:12]}… != coordinator's "
                    f"{self.store.fingerprint[:12]}…")
            conn.close()
            return False
        old = self.members.workers.get(wid)
        if old is not None and old.alive:
            # a rejoining wid the failure detector has not retired yet:
            # retire the stale incarnation first (its blocks respread)
            self._mark_and_recover([wid], None, None)
        info = WorkerInfo(wid=wid, conn=conn,
                          peer_addr=tuple(msg["peer_addr"]),
                          process=self._procs.get(wid))
        if self._coord_injector is not None:
            conn.chaos = self._coord_injector
        self.members.add(info)
        threading.Thread(target=self._rx, args=(wid, conn),
                         daemon=True).start()
        return True

    def _await_registrations(self):
        expected = self.cfg.n_workers
        deadline = time.monotonic() + self.cfg.register_timeout_s
        while len(self.members.workers) < expected:
            dead_early = [w for w, p in self._procs.items()
                          if not p.is_alive()
                          and w not in self.members.workers]
            if dead_early:
                raise ClusterError(
                    f"workers {dead_early} exited before registering "
                    "(exitcodes "
                    f"{[self._procs[w].exitcode for w in dead_early]}); if "
                    "launching from a script, guard the entry point "
                    "with `if __name__ == '__main__':` — the spawn "
                    "start method re-imports __main__")
            if time.monotonic() > deadline:
                raise ClusterError(
                    f"only {len(self.members.workers)} of "
                    f"{expected} workers registered in "
                    f"{self.cfg.register_timeout_s:.0f}s")
            try:
                wid, msg = self._events.get(timeout=1.0)
            except queue.Empty:
                continue
            if msg is None or msg.get("type") != "register":
                continue                 # stale obituary pre-membership
            self._admit(int(msg["wid"]), msg, strict=True)

    def shutdown(self) -> dict:
        """Stop workers, fold their byte counters in, reap processes.
        Returns the aggregate counter snapshot. Idempotent."""
        if self._shutdown_result is not None:
            return self._shutdown_result
        worker_counters = ByteCounter()
        alive = self.members.alive()
        for w in alive:
            try:
                w.conn.send("stop")
            except ConnectionClosed:
                w.alive = False
        waiting = {w.wid for w in alive if w.alive}
        deadline = time.monotonic() + 10.0
        while waiting and time.monotonic() < deadline:
            try:
                wid, msg = self._events.get(timeout=0.5)
            except queue.Empty:
                continue
            if msg is None:
                waiting.discard(wid)
            elif msg.get("type") == "bye":
                worker_counters.merge(msg["counters"])
                w = self.members.workers.get(wid)
                if w is not None and msg.get("metrics") is not None:
                    w.metrics = msg["metrics"]
                if self.obs.enabled:
                    # fold the worker's registry (relabelled so series
                    # stay per-worker) and its trace events, so the run
                    # directory renders the whole cluster as ONE
                    # metrics.json + one Perfetto timeline
                    if msg.get("metrics") is not None:
                        self.obs.registry.merge(
                            msg["metrics"],
                            extra_labels={"worker": str(wid)})
                    if msg.get("trace"):
                        self.obs.tracer.add_events(
                            msg["trace"],
                            process_name=f"worker-{wid}",
                            pid=msg.get("pid"))
                waiting.discard(wid)
        self._accept_stop.set()
        for w in self.members.workers.values():
            if w.conn is not None:
                w.conn.close()
        for p in self._procs.values():
            if p is None:
                continue
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()            # SIGTERM first...
                p.join(timeout=2.0)
            if p.is_alive():
                # ...but a SIGSTOPped worker holds SIGTERM pending
                # forever; SIGKILL is the only reaper that works on a
                # stopped process
                p.kill()
                p.join(timeout=2.0)
        self.listener.close()
        self._started = False
        self._shutdown_result = {"coordinator": self.counter.snapshot(),
                                 "workers": worker_counters.snapshot()}
        self.obs.finish()
        return self._shutdown_result

    def crash(self):
        """Abandon the cluster WITHOUT the shutdown handshake — the
        test harness's stand-in for a coordinator process dying. Every
        link drops (workers with ``reconnect`` configured start dialing
        the port back); worker processes are left running and tracked so
        a relaunched coordinator on the same port can adopt them (pass
        the handles via ``adopt_processes``)."""
        self._crashed = True
        self._accept_stop.set()
        self.listener.close()
        # a listening socket closed while the accept thread polls it stays
        # open (and completes handshakes) until that poll returns: wait for
        # the thread, as a dead process's port would be gone at once
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        for w in self.members.workers.values():
            if w.conn is not None:
                try:
                    w.conn.close()
                except OSError:
                    pass
        self._started = False
        self._shutdown_result = {"coordinator": self.counter.snapshot(),
                                 "workers": {}}

    def adopt_processes(self, procs: Dict[int, object]):
        """Give a relaunched coordinator the previous incarnation's
        process handles so its shutdown can reap them."""
        for wid, p in procs.items():
            self._procs.setdefault(wid, p)

    # -- plumbing -----------------------------------------------------------
    def _rx(self, wid: int, conn):
        try:
            while True:
                self._events.put((wid, conn.recv()))
        except ConnectionClosed:
            self._events.put((wid, None))

    def _send(self, wid: int, msg_type: str, **payload) -> bool:
        w = self.members.get(wid)
        try:
            w.conn.send(msg_type, **payload)
            return True
        except ConnectionClosed:
            self._events.put((wid, None))
            return False

    def _send_assign(self, wid: int, blocks: List[int], upto_iter: int,
                     force: bool = False):
        """Ship ownership of ``blocks``: recovery base slices (if any)
        plus the x-history needed to replay up to ``upto_iter``.
        ``force`` overwrites iterates the worker already holds (the
        resume path)."""
        base_state = None
        if self._base_y is not None:
            base_state = {}
            for bid in blocks:
                sl = self.store.block_slice(bid)
                base_state[bid] = (self._base_y[sl].copy(),
                                   self._base_lam[sl].copy())
        hist = self._x_hist[: max(0, upto_iter - self._base_iter)]
        self._send(wid, "assign", blocks=list(blocks),
                   base_iter=self._base_iter, base_state=base_state,
                   force=force,
                   x_history=(np.stack(hist) if hist else
                              np.zeros((0, self.store.n), np.float32)))

    def _broadcast_topology(self):
        wids = self.members.alive_ids()
        if self.cfg.staleness > 0:
            self._topology = None        # star: everyone reports directly
            for wid in wids:
                self._send(wid, "topology", epoch=self._epoch, parent=None,
                           nchildren=0)
            return
        topo = TreeTopology.build(wids, fanout=self.cfg.fanout,
                                  epoch=self._epoch)
        self._topology = topo
        for wid in wids:
            parent = topo.parent(wid)
            self._send(wid, "topology", epoch=self._epoch,
                       parent=(self.members.get(parent).peer_addr
                               if parent is not None else None),
                       nchildren=len(topo.children(wid)))

    def _broadcast_iter(self, k: int, x: np.ndarray):
        for wid in self.members.alive_ids():
            self._send(wid, "iter", k=k, x=np.asarray(x, np.float32),
                       epoch=self._epoch)

    # -- failure handling ---------------------------------------------------
    def _mark_and_recover(self, dead_wids, current_iter: Optional[int],
                          x_k: Optional[np.ndarray]):
        # duplicate death events are routine (EOF from the receiver
        # thread AND a failed send both post one): only newly-dead wids
        # trigger recovery, or every duplicate would cost an epoch bump
        # and an iteration retry
        newly = [wid for wid in dead_wids
                 if (w := self.members.workers.get(wid)) is not None
                 and w.alive]
        if not newly:
            return
        orphans = set()
        for wid in newly:
            w = self.members.workers[wid]
            if w.conn is not None:
                # sever the link: a live-but-retired worker (blown
                # deadline, zombie incarnation) sees its sends fail and
                # — with reconnect configured — comes back as a join
                try:
                    w.conn.close()
                except OSError:
                    pass
            orphans |= self.members.mark_dead(wid)
        self._open_recovery.append({
            "kind": "death", "wids": list(newly),
            "iter": current_iter, "blocks_moved": len(orphans),
            "t0": time.monotonic()})
        plan = self.members.reassignment_plan(sorted(orphans))
        # replay target: the state BEFORE the in-flight iteration — the
        # retry (strict) or the next broadcast (staleness) advances the
        # orphans onward from there
        upto = (current_iter - 1) if current_iter is not None else (
            self._base_iter + len(self._x_hist))
        for wid, blocks in plan.items():
            self._send_assign(wid, blocks, upto_iter=upto)
        if self.cfg.staleness > 0:
            for wid in newly:
                self._latest.pop(wid, None)
            return                       # star: epoch stays, late msgs fold
        self._epoch += 1
        self._broadcast_topology()
        if current_iter is not None:
            self._retries += 1
            self._broadcast_iter(current_iter, x_k)

    # -- elastic membership -------------------------------------------------
    def _spawn_due_joins(self, k: int):
        """Fire scheduled chaos ``join`` events whose iteration is due:
        spawn the worker process now; its registration arrives whenever
        process + torch startup completes and is applied at a later
        iteration boundary by :meth:`_apply_joins`."""
        due = [e for e in self._chaos_joins if e.iteration <= k]
        for e in due:
            self._chaos_joins.remove(e)
            wid = int(e.target.lstrip("w")) if e.target.startswith("w") \
                else None
            self.spawn_worker(wid)

    def _apply_joins(self):
        """Fold pending registrations into the membership at an
        iteration boundary: admit, level block load off the most-loaded
        survivors (``Membership.rebalance_plan``), ship the base state +
        x-history so joiners replay to the last COMPLETED iteration, and
        rebuild the topology under a new epoch — the same machinery the
        death path uses, pointed the other way."""
        if not self._pending_joins:
            return
        joins, self._pending_joins = self._pending_joins, []
        admitted = []
        for wid, msg in joins:
            if self._admit(wid, msg, strict=False):
                admitted.append(wid)
        if not admitted:
            return
        upto = self._base_iter + len(self._x_hist)   # last completed iter
        gains, losses = self.members.rebalance_plan()
        moved = 0
        for wid in set(gains) | set(losses):
            g = set(gains.get(wid, ()))
            l = set(losses.get(wid, ()))
            net_loss = sorted(l - g)
            if net_loss:
                self._send(wid, "unassign", blocks=net_loss)
            net_gain = sorted(g - l)
            if net_gain:
                self._send_assign(wid, net_gain, upto_iter=upto)
                moved += len(net_gain)
        if self.cfg.staleness > 0:
            # donors' cached reductions still cover their OLD blocks;
            # merging them alongside the joiner's fresh ones would
            # double-count the moved rows — everyone touched must
            # contribute fresh before being counted again
            for wid in set(gains) | set(losses):
                self._latest.pop(wid, None)
        self._joins += len(admitted)
        self._epoch += 1
        self._broadcast_topology()
        now = time.monotonic()
        for wid in admitted:
            t0 = self._join_t0.pop(wid, now)
            self._open_recovery.append({
                "kind": "join", "wid": wid, "iter": upto,
                "blocks_moved": moved, "t0": t0,
                "register_to_assign_s": round(now - t0, 3)})

    def _close_recovery(self, k: int):
        """A collect for iteration k completed with full coverage — any
        open death/join recovery is now proven healed; stamp durations
        into the log (the benchmark's time-to-recover / join-to-
        contributing metrics)."""
        if not self._open_recovery:
            return
        now = time.monotonic()
        for e in self._open_recovery:
            e["recovered_at_iter"] = k
            e["recover_s"] = round(now - e.pop("t0"), 3)
            self._recovery_log.append(e)
        self._open_recovery = []

    def _poll_failures(self) -> List[int]:
        """Heartbeat-age check. MUST run on every wait-loop pass, not
        only when the event queue idles: live workers heartbeat every
        interval, so a busy queue would otherwise starve the check and
        a HUNG (not dead) worker — open link, no EOF — would never be
        declared dead."""
        return self.members.stale(self.cfg.heartbeat_timeout_s)

    def _handle_common(self, wid: int, msg) -> Optional[Tuple[int, dict]]:
        """Events any wait-loop must absorb; returns the message back
        when the caller should interpret it."""
        if msg is None:
            return (wid, None)           # death, caller recovers
        t = msg.get("type")
        if t == "heartbeat":
            self.members.beat(wid)
            w = self.members.workers.get(wid)
            if w is not None and msg.get("metrics") is not None:
                w.metrics = msg["metrics"]
            return None
        if t == "error":
            raise ClusterError(
                f"worker {wid} failed:\n{msg['traceback']}")
        if t == "register":
            # a mid-solve join (fresh worker or a self-healed one
            # re-registering): queue it — membership only changes at
            # iteration boundaries, where the epoch bump is safe
            self._pending_joins.append((wid, msg))
            self._join_t0.setdefault(wid, time.monotonic())
            return None
        if t in ("assigned", "unassigned", "bye"):
            return None
        return (wid, msg)

    # -- setup reduction: sufficient stats ----------------------------------
    def stats(self):
        """Merged :class:`SufficientStats` over all blocks — the setup
        all-reduce of Alg. 2 lines 2-3 (and the WHOLE solve for
        quadratic-data-term fits, paper §4). The merged fingerprint must
        equal the store's, proving every block was folded exactly once
        across whatever membership survived."""
        from repro_torch.service.stats import SufficientStats
        if self._stats is not None:
            return self._stats
        if not self._started:
            self.start()
        pending: Dict[int, List[int]] = {}
        for w in self.members.alive():
            blocks = sorted(w.blocks)
            pending[w.wid] = blocks
            self._send(w.wid, "stats", blocks=blocks)
        merged = SufficientStats.zero(self.store.n, device=self.dev)
        folded: set = set()
        while len(folded) < self.store.nblocks:
            dead = self._poll_failures()
            if dead:
                self._stats_recover(dead, pending, folded)
            try:
                wid, msg = self._events.get(
                    timeout=self.cfg.heartbeat_interval_s)
            except queue.Empty:
                continue
            ev = self._handle_common(wid, msg)
            if ev is None:
                continue
            wid, msg = ev
            if msg is None:
                self._stats_recover([wid], pending, folded)
                continue
            if msg.get("type") != "stats":
                continue
            blocks = set(msg["blocks"])
            if blocks & folded:
                continue                 # re-request already covered
            merged = merged.merge(SufficientStats.from_payload(
                msg, device=self.dev))
            folded |= blocks
            # drop only the ANSWERED blocks: a re-requested orphan may
            # still be outstanding at this worker, and forgetting it
            # would strand the block if this worker dies too
            left = [b for b in pending.get(wid, []) if b not in folded]
            if left:
                pending[wid] = left
            else:
                pending.pop(wid, None)
        if merged.fingerprint != self.store.fingerprint:
            raise ClusterError(
                "merged stats fingerprint != store fingerprint: some "
                "block was folded zero or twice across the membership")
        self._stats = merged
        return merged

    def _stats_recover(self, dead, pending, folded):
        self._mark_and_recover(dead, None, None)
        for wid in dead:
            lost = [b for b in pending.pop(wid, []) if b not in folded]
            for bid in lost:
                owner = self.members.owner_of(bid)
                pending.setdefault(owner, []).append(bid)
                self._send(owner, "stats", blocks=[bid])

    # -- the solve ----------------------------------------------------------
    def solve(self, max_iters: int = 500, record: bool = True,
              x0: Optional[np.ndarray] = None,
              reg=None) -> ClusterResult:
        """Run the solve through the shared executor driver
        (DESIGN.md §14): the coordinator contributes the three cluster
        primitives via :class:`repro_torch.exec.ClusterExecutor`; the stopping
        rule, warm start, checkpoint cadence and history all live in
        ``repro_torch.exec.base.solve_with_executor`` — the same code path the
        local, streaming and shard_map topologies run."""
        from repro_torch.exec import ClusterExecutor, solve_with_executor

        if self._iters_run:
            # worker iterates persist across calls but d/x/history here
            # restart from zero — a second solve would silently diverge
            # from any single-process run. One coordinator, one solve.
            raise ClusterError(
                "this coordinator already ran a solve; create a new "
                "ClusterCoordinator (or use checkpoint_dir + resume "
                "to continue a solve across runs)")
        if not self._started:
            self.start()
        ex = ClusterExecutor(self)
        t0 = time.monotonic()
        res = solve_with_executor(
            ex, loss=self.loss, tau=self.tau, rho=self.rho,
            eps_rel=self.eps_rel, eps_abs=self.eps_abs,
            max_iters=max_iters, x0=x0, record=record, reg=reg,
            checkpoint_dir=self.cfg.checkpoint_dir,
            checkpoint_every=self.cfg.checkpoint_every,
            resume=self.cfg.resume, obs=self.obs)
        k = int(res.iters)
        history = None
        if record and res.history is not None:
            history = {
                "objective": res.history.objective.tolist(),
                "primal_res": res.history.primal_res.tolist(),
                "dual_res": res.history.dual_res.tolist()}
        return ClusterResult(x=res.x.detach().cpu().numpy().astype(
                                 np.float32), iters=k,
                             converged=ex.converged, history=history,
                             telemetry=self._telemetry(
                                 k - ex.resume_iter,
                                 time.monotonic() - t0),
                             status=self._status)

    def _below_min_quorum(self) -> bool:
        pol = self.cfg.degrade
        if pol is None:
            return False
        floor = max(1, int(np.ceil(pol.min_quorum * self.cfg.n_workers)))
        return len(self.members.alive()) < floor

    # -- collection: strict (tree) ------------------------------------------
    def _collect_strict(self, k: int, x_k: np.ndarray
                        ) -> Optional[Contribution]:
        """Wait for full coverage of iteration k at the current epoch;
        recover + retry on any death. In tree mode that is ONE message
        (the root's merged partial) per attempt. With a
        :class:`DegradePolicy`, a blown per-iteration deadline first
        RETRIES (reset + re-broadcast: recovers dropped/corrupted
        messages for one cheap cached-answer round trip) and then gives
        up — returning None, which the solve loop reports as
        ``degraded`` — instead of waiting forever."""
        pol = self.cfg.degrade
        deadline = (time.monotonic() + pol.iter_deadline_s
                    if pol is not None else None)
        rebroadcasts = 0
        acc = Contribution.zero(k, self._red_n)
        seen: set = set()
        while True:
            if deadline is not None and time.monotonic() > deadline:
                if rebroadcasts >= pol.deadline_retries:
                    return None
                rebroadcasts += 1
                self._retries += 1
                self._recovery_log.append({
                    "kind": "deadline_retry", "iter": k,
                    "attempt": rebroadcasts})
                acc = Contribution.zero(k, self._red_n)
                seen = set()
                deadline = time.monotonic() + pol.iter_deadline_s
                self._broadcast_iter(k, x_k)
            try:
                dead = self._poll_failures()
                if dead:
                    acc = Contribution.zero(k, self._red_n)
                    seen = set()
                    self._mark_and_recover(dead, k, x_k)
                if self._below_min_quorum():
                    return None
                try:
                    wid, msg = self._events.get(
                        timeout=self.cfg.heartbeat_interval_s)
                except queue.Empty:
                    continue
                ev = self._handle_common(wid, msg)
                if ev is None:
                    continue
                wid, msg = ev
                if msg is None:
                    acc = Contribution.zero(k, self._red_n)
                    seen = set()
                    self._mark_and_recover([wid], k, x_k)
                    continue
            except DeadCluster:
                if pol is not None:
                    return None          # degraded beats an exception
                raise
            if msg.get("type") != "contrib":
                continue
            if msg["epoch"] != self._epoch:
                continue                 # partial of a dead topology
            try:
                c = decode(msg["payload"])
            except ValueError:
                continue                 # malformed: the retry recovers it
            if c.iteration != k or set(c.workers) & seen:
                continue
            self.members.beat(wid)
            acc = acc.merge(c)
            seen |= set(c.workers)
            if acc.rows >= self.store.m:
                assert acc.rows == self.store.m, \
                    f"row overcount: {acc.rows} > {self.store.m}"
                return acc

    # -- collection: bounded staleness (star) -------------------------------
    def _collect_stale(self, k: int) -> Optional[Contribution]:
        """Proceed once >= quorum of live workers contributed at k and
        nobody lags more than ``staleness``; absent workers are
        represented by their newest cached reduction (replaced — not
        lost — when the late message lands). With a
        :class:`DegradePolicy`, a blown deadline RELAXES the round to
        (min_quorum, max_staleness) — counting only workers that have
        contributed at all — and a second blown deadline returns None
        (degraded)."""
        S, q = self.cfg.staleness, self.cfg.quorum
        pol = self.cfg.degrade
        deadline = (time.monotonic() + pol.iter_deadline_s
                    if pol is not None else None)
        relaxed = False
        while True:
            alive = self.members.alive_ids()
            haves = [w for w in alive if self._latest.get(w) is not None]
            fresh = sum(1 for w in haves
                        if self._latest[w].iteration == k)
            oldest = min((self._latest[w].iteration for w in haves),
                         default=0)
            if relaxed:
                # degraded round: merge whoever has EVER contributed,
                # provided a min_quorum of them is fresh and none of
                # them is older than the widened bound
                satisfied = (haves
                             and fresh >= max(1, int(np.ceil(
                                 pol.min_quorum * len(alive))))
                             and oldest >= k - pol.max_staleness)
                merge_over = haves
            else:
                satisfied = (len(haves) == len(alive)
                             and fresh >= max(1, int(np.ceil(
                                 q * len(alive))))
                             and oldest >= k - S)
                merge_over = alive
            if satisfied:
                if relaxed:
                    self._degraded_rounds += 1
                acc = Contribution.zero(k, self._red_n)
                for w in merge_over:
                    # stale entries merge AS IF current — the (bounded)
                    # inexactness the mode accepts by construction
                    acc = acc.merge(dataclasses.replace(
                        self._latest[w], iteration=k))
                return acc
            if deadline is not None and time.monotonic() > deadline:
                if relaxed:
                    return None
                relaxed = True
                self._recovery_log.append({
                    "kind": "quorum_relax", "iter": k,
                    "min_quorum": pol.min_quorum,
                    "max_staleness": pol.max_staleness})
                deadline = time.monotonic() + pol.iter_deadline_s
                continue
            try:
                dead = self._poll_failures()
                if dead:
                    self._mark_and_recover(dead, k, None)
                if self._below_min_quorum():
                    return None
            except DeadCluster:
                if pol is not None:
                    return None
                raise
            try:
                wid, msg = self._events.get(
                    timeout=self.cfg.heartbeat_interval_s)
            except queue.Empty:
                continue
            ev = self._handle_common(wid, msg)
            if ev is None:
                continue
            wid, msg = ev
            if msg is None:
                try:
                    self._mark_and_recover([wid], k, None)
                except DeadCluster:
                    if pol is not None:
                        return None
                    raise
                continue
            if msg.get("type") != "contrib":
                continue
            try:
                c = decode(msg["payload"])
            except ValueError:
                continue
            w = c.workers[0]
            prev = self._latest.get(w)
            if prev is None or c.iteration > prev.iteration:
                self._latest[w] = c
                self.members.get(w).last_iteration = c.iteration
                self.members.beat(w)

    # -- checkpoint / resume ------------------------------------------------
    def _gather_iterates(self, k: int
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Assemble full (y, lam) from worker slices; None if membership
        changed mid-gather (caller skips this checkpoint round)."""
        for wid in self.members.alive_ids():
            if not self._send(wid, "checkpoint"):
                return None
        ycols = getattr(self.loss, "ycols", 1)
        shape = ((self.store.m,) if ycols == 1
                 else (self.store.m, ycols))
        y = np.zeros(shape, np.float32)
        lam = np.zeros(shape, np.float32)
        covered: set = set()
        deadline = time.monotonic() + self.cfg.heartbeat_timeout_s
        while covered != set(range(self.store.nblocks)):
            if time.monotonic() > deadline:
                return None
            try:
                wid, msg = self._events.get(timeout=0.5)
            except queue.Empty:
                continue
            ev = self._handle_common(wid, msg)
            if ev is None:
                continue
            wid, msg = ev
            if msg is None:
                self._mark_and_recover([wid], None, None)
                return None
            if msg.get("type") != "ckpt":
                continue
            for bid, (y_b, lam_b, b_iter) in msg["blocks"].items():
                if b_iter != k:
                    return None          # raced a retry; skip this round
                sl = self.store.block_slice(int(bid))
                y[sl], lam[sl] = y_b, lam_b
                covered.add(int(bid))
        return y, lam

    # -- telemetry ----------------------------------------------------------
    def _pad_objective(self) -> float:
        # one pad-row objective contract for the streaming AND cluster
        # drivers (engine.streaming.store_pad_objective)
        from repro_torch.engine.streaming import store_pad_objective
        return store_pad_objective(self.store, self.loss)

    def _per_worker_telemetry(self) -> dict:
        """Per-worker timing breakdown from the newest registry snapshot
        each worker shipped (heartbeat or bye): iteration counts and
        wall time, block-step latency percentiles, replay/retry work."""
        out: Dict[str, dict] = {}
        for w in self.members.workers.values():
            snap = w.metrics
            if snap is None:
                continue
            iter_h = merged_histogram(
                snapshot_histograms(snap, "worker.iter_s"))
            steps = merged_histogram(
                snapshot_histograms(snap, "worker.block_step_s"))
            out[str(w.wid)] = {
                "alive": w.alive,
                "iters": int(snapshot_counters(snap, "worker.iters")),
                "iter_wall_s": round(iter_h.sum, 6),
                "block_step_ms": summarize_histogram(
                    steps.to_snapshot(), scale=1e3),
                "replayed_steps": int(
                    snapshot_counters(snap, "worker.replayed_steps")),
                "retry_cached_answers": int(snapshot_counters(
                    snap, "worker.retry_cached_answers")),
                # the port's device-side account (shipped with ``bye``):
                # kernel launches by kernel, host staging of the blocks,
                # the worker's peak device memory
                "kernel_launches": {
                    e["labels"]["kernel"]: int(e["value"])
                    for e in snap.get("counters", [])
                    if e["name"] == "worker.kernel_launches"},
                "stage_s": round(merged_histogram(snapshot_histograms(
                    snap, "worker.stage_s")).sum, 6),
                "stage_bytes": int(snapshot_counters(
                    snap, "worker.stage_bytes")),
                "peak_device_bytes": next(
                    (int(e["value"]) for e in snap.get("gauges", [])
                     if e["name"] == "worker.peak_device_bytes"), None),
            }
        return out

    def _telemetry(self, iters: int, wall_s: float) -> dict:
        n = self.store.n
        coord = self.counter.snapshot()
        reduction_rx = sum(coord["received_bytes"].get(t, 0)
                           for t in REDUCTION_TAGS)
        bcast_tx = sum(coord["sent_bytes"].get(t, 0)
                       for t in BROADCAST_TAGS)
        deaths_rec = [e for e in self._recovery_log
                      if e["kind"] == "death"]
        joins_rec = [e for e in self._recovery_log if e["kind"] == "join"]
        return {
            "workers_spawned": self.cfg.n_workers,
            "workers_alive": len(self.members.alive()),
            "deaths": list(self.members.deaths),
            "blocks_reassigned": self.members.reassignments,
            "iteration_retries": self._retries,
            "status": self._status,
            "joins": self._joins,
            "blocks_rebalanced": self.members.rebalances,
            "degraded_rounds": self._degraded_rounds,
            "chaos_spec": self._chaos_spec,
            "chaos_seed": (self.cfg.chaos.seed
                           if self.cfg.chaos is not None else None),
            "recovery": {
                "events": list(self._recovery_log),
                "time_to_recover_s": (
                    round(max(e["recover_s"] for e in deaths_rec), 3)
                    if deaths_rec else None),
                "iterations_retried": self._retries,
                "join_to_contributing_s": (
                    round(max(e["recover_s"] for e in joins_rec), 3)
                    if joins_rec else None),
            },
            "iters": iters,
            "wall_s": round(wall_s, 3),
            "epoch": self._epoch,
            "tree_depth": (self._topology.depth()
                           if self._topology else 1),
            "coordinator_reduction_rx_bytes": reduction_rx,
            "coordinator_broadcast_tx_bytes": bcast_tx,
            "reduction_rx_bytes_per_iter": (
                round(reduction_rx / iters, 1) if iters else 0.0),
            "payload_bytes_per_nvec": compress.wire_bytes(
                n, self.cfg.compress),
            "payload_bytes_per_nvec_uncompressed": compress.wire_bytes(
                n, False),
            "counters": coord,
            "per_worker": self._per_worker_telemetry(),
        }


# ---------------------------------------------------------------------------
# convenience drivers (launch/fit.py, benchmarks, tests)
# ---------------------------------------------------------------------------

def _ensure_store(D, aux, store_dir: Optional[str], n_workers: int,
                  block_rows: Optional[int] = None) -> Tuple[str, bool]:
    """Stage host arrays (or pass through an existing store dir).
    Returns (path, created): ``created`` stores are the convenience
    drivers' to delete after shutdown — a dataset-sized temp directory
    must not outlive the solve."""
    from repro_torch.data.store import ShardedMatrixStore
    if isinstance(D, str):
        return D, False
    created = store_dir is None
    if created:
        store_dir = tempfile.mkdtemp(prefix="cluster_store_")
    D = np.asarray(D)
    if D.ndim == 3:
        D = D.reshape(-1, D.shape[-1])
    if block_rows is None:
        # >= 2 blocks per worker so a death has something to spread
        block_rows = max(1, -(-D.shape[0] // (2 * max(n_workers, 1))))
    store = ShardedMatrixStore.from_arrays(
        D, None if aux is None else np.asarray(aux).reshape(-1),
        block_rows=block_rows)
    store.save(store_dir)
    return store_dir, created


def cluster_solve(D, aux, loss: dict, tau: float, rho: float = 0.0,
                  max_iters: int = 300, store_dir: Optional[str] = None,
                  config: Optional[ClusterConfig] = None,
                  block_rows: Optional[int] = None,
                  eps_rel: float = 1e-3, eps_abs: float = 1e-6,
                  record: bool = True, x0=None, reg=None) -> ClusterResult:
    """One-call multi-process solve: stage the store, run the cluster,
    tear it down. ``D`` may be host arrays or a saved store path."""
    config = config or ClusterConfig()
    path, created = _ensure_store(D, aux, store_dir, config.n_workers,
                                  block_rows)
    try:
        with ClusterCoordinator(path, loss, tau=tau, rho=rho,
                                eps_rel=eps_rel, eps_abs=eps_abs,
                                config=config) as coord:
            res = coord.solve(max_iters=max_iters, record=record,
                              x0=x0, reg=reg)
            res.telemetry["shutdown_counters"] = coord.shutdown()
            # bye messages carry each worker's FINAL registry snapshot;
            # refresh the breakdown solve() built from (periodic, hence
            # lagging) heartbeats
            res.telemetry["per_worker"] = coord._per_worker_telemetry()
        return res
    finally:
        if created:
            shutil.rmtree(path, ignore_errors=True)


def cluster_stats(D, aux, store_dir: Optional[str] = None,
                  config: Optional[ClusterConfig] = None,
                  block_rows: Optional[int] = None):
    """Distributed sufficient-stats ingest (the paper-§4 regression
    path: lasso/ridge solves never iterate over the cluster — one
    stats reduction, then the coordinator solves locally)."""
    config = config or ClusterConfig()
    path, created = _ensure_store(D, aux, store_dir, config.n_workers,
                                  block_rows)
    try:
        with ClusterCoordinator(path, {"name": "least_squares"},
                                config=config) as coord:
            st = coord.stats()
            telemetry = coord.shutdown()
        return st, telemetry
    finally:
        if created:
            shutil.rmtree(path, ignore_errors=True)
