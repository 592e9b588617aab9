"""Worker registry: liveness, block ownership, reassignment plans.

Liveness has two signals, and the faster one wins:

  * EOF on the worker's coordinator link (SIGKILL, crash — detected
    within one socket read by the receiver thread);
  * heartbeat age > ``timeout`` (hung process, network partition — the
    worker's heartbeat thread stamps every ``interval`` seconds).

Block ownership is the unit of both work and recovery: a worker owns a
set of store block indices; when it dies its blocks are orphaned and
:meth:`Membership.reassignment_plan` spreads them over the least-loaded
survivors. The STORE is the ground truth for what a block is — owners
re-open it read-only (mmap) and verify content against the write-time
fingerprints, so a reassignment can never silently feed a different
block's rows into the solve; the orphans' ITERATES are reconstructed by
the new owner from the coordinator's x-history (see worker.replay), not
copied from the dead process.

Copy of ``repro/cluster/membership.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set


@dataclasses.dataclass
class WorkerInfo:
    wid: int
    conn: object = None                  # transport.Connection
    peer_addr: Optional[tuple] = None    # (host, port) of its peer server
    blocks: Set[int] = dataclasses.field(default_factory=set)
    last_heartbeat: float = dataclasses.field(default_factory=time.monotonic)
    alive: bool = True
    last_iteration: int = 0              # newest contribution seen from it
    process: object = None               # multiprocessing.Process handle
    metrics: Optional[dict] = None       # newest registry snapshot
                                         # (heartbeat / bye payload)


class DeadCluster(RuntimeError):
    """No live workers remain — the solve cannot make progress."""


class Membership:
    def __init__(self):
        self.workers: Dict[int, WorkerInfo] = {}
        self.deaths: List[int] = []          # wids, in death order
        self.reassignments: int = 0          # blocks moved post-death
        self.rebalances: int = 0             # blocks moved post-join

    # -- registry ----------------------------------------------------------
    def add(self, info: WorkerInfo):
        self.workers[info.wid] = info

    def alive(self) -> List[WorkerInfo]:
        return [w for w in self.workers.values() if w.alive]

    def alive_ids(self) -> List[int]:
        return sorted(w.wid for w in self.alive())

    def get(self, wid: int) -> WorkerInfo:
        return self.workers[wid]

    def owner_of(self, block: int) -> Optional[int]:
        for w in self.alive():
            if block in w.blocks:
                return w.wid
        return None

    # -- liveness ----------------------------------------------------------
    def beat(self, wid: int):
        w = self.workers.get(wid)
        if w is not None:
            w.last_heartbeat = time.monotonic()

    def stale(self, timeout: float) -> List[int]:
        now = time.monotonic()
        return [w.wid for w in self.alive()
                if now - w.last_heartbeat > timeout]

    def mark_dead(self, wid: int) -> Set[int]:
        """Retire a worker; returns its orphaned blocks."""
        w = self.workers.get(wid)
        if w is None or not w.alive:
            return set()
        w.alive = False
        self.deaths.append(wid)
        orphans, w.blocks = set(w.blocks), set()
        return orphans

    # -- block ownership ---------------------------------------------------
    def initial_assignment(self, nblocks: int) -> Dict[int, List[int]]:
        """Contiguous row-order split over registration order — each
        worker's blocks are adjacent, matching the paper's "node i holds
        rows m_i" layout (and mmap read locality)."""
        wids = self.alive_ids()
        if not wids:
            raise DeadCluster("no workers registered")
        per = -(-nblocks // len(wids))
        plan: Dict[int, List[int]] = {}
        for i, wid in enumerate(wids):
            blocks = list(range(i * per, min((i + 1) * per, nblocks)))
            plan[wid] = blocks
            self.workers[wid].blocks = set(blocks)
        return plan

    def reassignment_plan(self, orphans: Sequence[int]
                          ) -> Dict[int, List[int]]:
        """Spread orphaned blocks over the least-loaded survivors."""
        live = self.alive()
        if not live:
            raise DeadCluster(
                f"all workers dead; {len(orphans)} blocks orphaned")
        plan: Dict[int, List[int]] = {}
        for b in sorted(orphans):
            w = min(live, key=lambda w: len(w.blocks))
            w.blocks.add(b)
            plan.setdefault(w.wid, []).append(b)
            self.reassignments += 1
        return plan

    def rebalance_plan(self) -> "tuple[Dict[int, List[int]], Dict[int, List[int]]]":
        """Level block load across the live set — the dual of
        :meth:`reassignment_plan`, run when a worker JOINS mid-solve:
        blocks migrate one at a time from the most-loaded survivor to
        the least-loaded worker (the empty joiner) until every pair of
        loads is within one block. Returns ``(gains, losses)`` keyed by
        wid. Deterministic: ties break toward the smaller wid and the
        highest block index moves first. Exactness is the
        partition-insensitivity argument (PAPERS.md, Wu et al. 2024) —
        the solve's answer does not depend on which worker holds which
        rows, so ownership can move between iterations freely; the new
        owner reconstructs iterates by x-history replay."""
        live = self.alive()
        if not live:
            raise DeadCluster("no live workers to rebalance over")
        gains: Dict[int, List[int]] = {}
        losses: Dict[int, List[int]] = {}
        while True:
            donor = max(live, key=lambda w: (len(w.blocks), -w.wid))
            recip = min(live, key=lambda w: (len(w.blocks), w.wid))
            if len(donor.blocks) - len(recip.blocks) <= 1:
                break
            b = max(donor.blocks)
            donor.blocks.discard(b)
            recip.blocks.add(b)
            gains.setdefault(recip.wid, []).append(b)
            losses.setdefault(donor.wid, []).append(b)
            self.rebalances += 1
        return gains, losses

    def coverage(self) -> Set[int]:
        out: Set[int] = set()
        for w in self.alive():
            out |= w.blocks
        return out
