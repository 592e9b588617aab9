"""Deterministic fault injection for the cluster runtime (DESIGN.md §13).

The paper's deployment story is thousands of commodity cores, where
workers joining, dying, hanging, and flaking mid-solve is the steady
state.  This module generates a *seeded, reproducible* schedule of such
faults and injects them at exact (iteration, target) points, so every
recovery path in the coordinator/worker runtime can be exercised by a
test that fails the same way twice.

Three layers:

  * ``FaultEvent`` — one scheduled fault: ``kind @ iteration : target``
    with an optional numeric parameter (milliseconds for delay/slow).
  * ``ChaosSchedule`` — an immutable, sorted collection of events with a
    compact string form (``kill@13:w2,join@20:w4,delay@5:w1:50``) that
    round-trips through ``parse``/``to_spec`` and a seeded ``generate``
    (same seed → byte-identical schedule).  The schedule is shipped to
    workers as its spec string; each side slices out its own target.
  * ``FaultInjector`` — consumes one target's slice.  Disabled injectors
    follow the ``obs`` no-op pattern: a single attribute check and an
    empty tuple, nothing else, so production paths pay nothing.

Fault taxonomy (see DESIGN.md §13 for the recovery each one exercises):

  wire    delay / drop / dup / corrupt / reset — applied inside
          ``Connection.send`` for data-plane frames (contrib, iter).
  process kill (SIGKILL) / stop (SIGSTOP, a hang that still owns the
          socket) / slow (sleep before the block step) — applied by the
          worker when it receives the scheduled iteration's broadcast.
  cluster join — consumed by the coordinator: spawn a fresh worker
          process at the scheduled iteration boundary.

Copy of ``repro/cluster/chaos.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

WIRE_KINDS = ("delay", "drop", "dup", "corrupt", "reset")
PROCESS_KINDS = ("kill", "stop", "slow")
CLUSTER_KINDS = ("join",)
KINDS = WIRE_KINDS + PROCESS_KINDS + CLUSTER_KINDS

# wire faults only touch data-plane frames; control traffic (register,
# heartbeats, topology, shutdown) stays clean so a "dropped contribution"
# cannot masquerade as a dead worker at the transport level
DATA_PLANE = ("contrib", "iter")


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    """One scheduled fault: ``kind`` fires at ``iteration`` on ``target``
    (``"w<wid>"`` or ``"coord"``).  ``param`` is milliseconds for
    delay/slow and ignored elsewhere."""
    iteration: int
    target: str
    kind: str
    param: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.iteration < 0:
            raise ValueError("fault iteration must be >= 0")

    def to_token(self) -> str:
        tok = f"{self.kind}@{self.iteration}:{self.target}"
        if self.param:
            tok += f":{self.param:g}"
        return tok

    @classmethod
    def from_token(cls, token: str) -> "FaultEvent":
        try:
            kind, rest = token.strip().split("@", 1)
            parts = rest.split(":")
            iteration, target = int(parts[0]), parts[1]
            param = float(parts[2]) if len(parts) > 2 else 0.0
        except (ValueError, IndexError) as e:
            raise ValueError(f"bad fault token {token!r} "
                             "(want kind@iter:target[:param])") from e
        return cls(iteration=iteration, target=target, kind=kind,
                   param=param)


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A sorted, immutable fault schedule with a recorded seed."""
    events: Tuple[FaultEvent, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(sorted(self.events)))

    # -- serialization ------------------------------------------------
    def to_spec(self) -> str:
        return ",".join(e.to_token() for e in self.events)

    @classmethod
    def parse(cls, spec: str, seed: Optional[int] = None) -> "ChaosSchedule":
        tokens = [t for t in str(spec).split(",") if t.strip()]
        return cls(events=tuple(FaultEvent.from_token(t) for t in tokens),
                   seed=seed)

    # -- seeded generation --------------------------------------------
    @classmethod
    def generate(cls, seed: int, n_workers: int, iters: int, *,
                 kills: int = 1, stops: int = 1, joins: int = 1,
                 delays: int = 2, drops: int = 1, dups: int = 0,
                 corrupts: int = 0, resets: int = 0,
                 delay_ms: Tuple[float, float] = (10.0, 120.0),
                 ) -> "ChaosSchedule":
        """Deterministic schedule: same arguments → identical events.

        Kill/stop victims are distinct workers so the schedule cannot
        fault a process twice; at least one original worker survives.
        Joins spawn fresh wids above ``n_workers``.  Wire faults land on
        any original worker.  Iterations are placed in the middle of the
        solve so detection + recovery complete inside it.
        """
        if kills + stops >= n_workers:
            raise ValueError("kill+stop victims must leave a survivor")
        if iters < 8:
            raise ValueError("need >= 8 iterations to schedule recovery")
        rng = np.random.default_rng(seed)
        victims = [int(w) for w in rng.permutation(n_workers)]
        lo, hi = 2, max(3, iters - 5)
        events: List[FaultEvent] = []

        def it():
            return int(rng.integers(lo, hi))

        for _ in range(kills):
            events.append(FaultEvent(it(), f"w{victims.pop(0)}", "kill"))
        for _ in range(stops):
            events.append(FaultEvent(it(), f"w{victims.pop(0)}", "stop"))
        for j in range(joins):
            # join early enough that process spawn + registration lands
            # inside the solve even on a loaded single-core host
            events.append(FaultEvent(int(rng.integers(1, max(2, iters // 4))),
                                     f"w{n_workers + j}", "join"))
        for kind, count in (("delay", delays), ("drop", drops),
                            ("dup", dups), ("corrupt", corrupts),
                            ("reset", resets)):
            for _ in range(count):
                w = int(rng.integers(0, n_workers))
                # quantize so the schedule round-trips exactly through
                # to_spec()/parse() (the %g token keeps 6 significant
                # digits; whole milliseconds are plenty for a delay)
                param = (float(round(rng.uniform(*delay_ms), 1))
                         if kind == "delay" else 0.0)
                events.append(FaultEvent(it(), f"w{w}", kind, param))
        return cls(events=tuple(events), seed=int(seed))

    # -- slicing ------------------------------------------------------
    def for_target(self, target: str) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.target == target)

    def for_kind(self, *kinds: str) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind in kinds)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out


class FaultInjector:
    """Consumes one target's slice of a schedule.

    Mirrors the ``obs`` no-op pattern: when disabled every hook is a
    single attribute check returning an empty tuple, so the runtime can
    call the hooks unconditionally.  Each event fires exactly once
    (process faults fire at the first iteration >= their schedule point,
    wire faults only at the exact iteration, so a fault aimed at a
    window the target never saw does not detonate arbitrarily later).

    ``data_plane`` names the frame types wire faults may touch.  The
    cluster default is :data:`DATA_PLANE` (contrib/iter); the fit
    service front end passes its own tags (fit/fit_result) so the SAME
    injector and schedule grammar drive service-connection chaos while
    control frames stay clean in both runtimes.
    """

    __slots__ = ("enabled", "_events", "_fired", "_iteration",
                 "_data_plane")

    def __init__(self, events: Iterable[FaultEvent] = (),
                 enabled: Optional[bool] = None,
                 data_plane: Sequence[str] = DATA_PLANE):
        self._events = tuple(sorted(events))
        self.enabled = (bool(self._events) if enabled is None
                        else bool(enabled))
        self._fired: set = set()
        self._iteration = -1
        self._data_plane = tuple(data_plane)

    def set_iteration(self, k: int) -> None:
        self._iteration = int(k)

    def process_actions(self, k: int) -> Tuple[Tuple[str, float], ...]:
        """(kind, param_ms) process faults due at iteration ``k``."""
        if not self.enabled:
            return ()
        self._iteration = int(k)
        out = []
        for i, e in enumerate(self._events):
            if (i not in self._fired and e.kind in PROCESS_KINDS
                    and e.iteration <= k):
                self._fired.add(i)
                out.append((e.kind, e.param))
        return tuple(out)

    def on_send(self, msg_type: str) -> Tuple[Tuple[str, float], ...]:
        """(kind, param_ms) wire faults for a frame being sent now."""
        if not self.enabled:
            return ()
        if msg_type not in self._data_plane:
            return ()
        out = []
        for i, e in enumerate(self._events):
            if (i not in self._fired and e.kind in WIRE_KINDS
                    and e.iteration == self._iteration):
                self._fired.add(i)
                out.append((e.kind, e.param))
        return tuple(out)

    def corrupt(self, frame: bytes) -> bytes:
        """Deterministically mangle a frame body.  The first bytes are
        the pickle protocol header — flipping them guarantees the
        receiver's decode fails (detected corruption) rather than
        silently altering array payload."""
        b = bytearray(frame)
        for off in (0, 1, len(b) // 2):
            if off < len(b):
                b[off] ^= 0xFF
        return bytes(b)

    def pending(self) -> Tuple[FaultEvent, ...]:
        return tuple(e for i, e in enumerate(self._events)
                     if i not in self._fired)


#: shared disabled injector — the no-op fast path
NOOP = FaultInjector(events=(), enabled=False)


def make_injector(spec: Optional[str], target: str,
                  data_plane: Sequence[str] = DATA_PLANE) -> FaultInjector:
    """Build a target's injector from a schedule spec string (the form
    shipped inside worker configs); ``None``/empty → the NOOP singleton."""
    if not spec:
        return NOOP
    sched = spec if isinstance(spec, ChaosSchedule) else ChaosSchedule.parse(spec)
    events = sched.for_target(target)
    return (FaultInjector(events, data_plane=data_plane) if events
            else NOOP)
