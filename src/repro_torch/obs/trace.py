"""Low-overhead tracing spans -> Chrome-trace/Perfetto JSON (DESIGN.md §12).

``Tracer.span("gram_pass", attrs=...)`` is a context manager that records
one complete ("ph": "X") event; ``@tracer.traced()`` wraps a function.
Events carry real OS pid/tid plus ``process_name`` / ``thread_name``
metadata, so a multi-process cluster solve — coordinator + N workers,
each exporting its own event list — merges into ONE timeline: load the
exported JSON in ``chrome://tracing`` or https://ui.perfetto.dev and
every process renders as its own track.

Clock contract: one clock, ``time.time_ns`` (Unix time), the one clock
the processes of a host share and the one ``torch.profiler``'s host and
device events are stamped on, so merged cross-process events align and a
span can be laid over the profiler's timeline. ``ts`` is the start in
whole microseconds (the Chrome-trace unit), ``ts_ns`` the same start in
nanoseconds, and ``dur`` the length in microseconds from the two
nanosecond readings.

Disabled fast path: ``span`` on a disabled tracer returns a reused no-op
context manager — no event dict, no timestamp read, no allocation — so
instrumented code costs one attribute check when observability is off.
``iter_span(name, k)`` is the solve loop's form: its arguments are
positional, so the disabled path builds no keyword dict either. A span
opened without ``k`` takes the iteration of the last ``iter_span`` that
named one on its thread, so code below the solve loop stamps the loop's
iteration without being handed it. Loop spans are kept as tuples and
become event dicts only when ``events()`` is read, and they join no
request's trace tree (no context push): a solve opens several an
iteration, and the loop between the device's kernels is what they time.

Trace-context integration (DESIGN.md §16): when a request-scoped
:class:`~repro_torch.obs.context.TraceContext` is active (contextvar), each
span pushes a *child* context for its dynamic extent and stamps
``trace_id``/``span_id``/``parent_id`` into its event args.  Nested
spans therefore form a parent chain, and anything sent over the
transport from inside a span carries that span's context — which is how
a client span becomes the ancestor of a frontend/executor span in
another process.  ``complete_at`` records a span retroactively from
stored timestamps (queue wait: nobody is "in" the span while a request
sits in the queue).

Copy of ``repro/obs/trace.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import List, Optional

from repro_torch.obs.context import TraceContext, current_context, use_context


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_attrs", "_t0", "_ctx", "_cm")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        parent = current_context()
        if parent is not None:
            # This span is a new node in the request's trace: push a child
            # context so nested spans (and frames sent from inside) chain
            # under it.
            self._ctx = parent.child()
            self._cm = use_context(self._ctx)
            self._cm.__enter__()
        else:
            self._ctx = None
            self._cm = None
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self._cm is not None:
            self._cm.__exit__(None, None, None)
        attrs = self._attrs
        if self._ctx is not None:
            attrs = dict(attrs)
            attrs["trace_id"] = self._ctx.trace_id
            attrs["span_id"] = self._ctx.span_id
            if self._ctx.parent_id is not None:
                attrs["parent_id"] = self._ctx.parent_id
        self._tracer._emit(self._name, self._t0, t1, attrs)
        return False

    @property
    def context(self) -> Optional[TraceContext]:
        """The child TraceContext this span pushed (None untraced)."""
        return self._ctx


class _IterSpan:
    __slots__ = ("_tracer", "_name", "_k", "_t0")

    def __init__(self, tracer: "Tracer", name: str, k):
        self._tracer = tracer
        self._name = name
        self._k = k

    def __enter__(self):
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        tracer = self._tracer
        tid = threading.get_ident()
        if tid not in tracer._named_tids:
            with tracer._lock:
                tracer._maybe_name_thread(tid)
        tracer._loop.append((self._name, self._t0, t1, tid, self._k))
        return False


class Tracer:
    def __init__(self, enabled: bool = False,
                 process_name: Optional[str] = None):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._pid = os.getpid()
        self._named_tids: set = set()
        self._iter = threading.local()     # the thread's iteration
        self._loop: list = []              # iter_span records, as tuples
        if process_name and self.enabled:
            self.set_process_name(process_name)

    # -- recording -----------------------------------------------------------
    def set_process_name(self, name: str, pid: Optional[int] = None):
        with self._lock:
            self._events.append({"ph": "M", "name": "process_name",
                                 "pid": pid if pid is not None else self._pid,
                                 "tid": 0, "args": {"name": name}})

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def iter_span(self, name: str, k: Optional[int] = None):
        """A span of the solve loop's iteration ``k`` (``args`` {"k": k});
        without ``k``, the iteration of this thread's last ``iter_span``
        that named one."""
        if not self.enabled:
            return _NULL_SPAN
        if k is None:
            k = getattr(self._iter, "k", None)
        else:
            self._iter.k = k
        return _IterSpan(self, name, k)

    def traced(self, name: Optional[str] = None):
        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                if not self.enabled:
                    return fn(*args, **kwargs)
                with self.span(label):
                    return fn(*args, **kwargs)

            return wrapper

        return deco

    def complete_at(self, name: str, t0_us: int, dur_s: float,
                    ctx: Optional[TraceContext] = None, **attrs):
        """Record a complete span retroactively from stored timestamps.

        Used for intervals with no live frame on any stack — queue wait
        is the canonical one: the request sat in the pending map between
        ``t0_us`` (wall-clock µs at enqueue) and now.  ``ctx`` parents
        the emitted span under a request's trace; a fresh span id is
        minted so sibling retro-spans don't collide.
        """
        if not self.enabled:
            return
        if ctx is not None:
            node = ctx.child()
            attrs = dict(attrs)
            attrs["trace_id"] = node.trace_id
            attrs["span_id"] = node.span_id
            if node.parent_id is not None:
                attrs["parent_id"] = node.parent_id
        t0_ns = int(t0_us) * 1000
        self._emit(name, t0_ns, t0_ns + round(max(dur_s, 0.0) * 1e9),
                   attrs)

    def instant(self, name: str, **attrs):
        if not self.enabled:
            return
        tid = threading.get_ident()
        ev = {"ph": "i", "name": name, "ts": time.time_ns() // 1000,
              "pid": self._pid, "tid": tid, "s": "p"}
        if attrs:
            ev["args"] = attrs
        with self._lock:
            self._maybe_name_thread(tid)
            self._events.append(ev)

    def _emit(self, name: str, t0_ns: int, t1_ns: int, attrs: dict):
        tid = threading.get_ident()
        ev = {"ph": "X", "name": name, "ts": t0_ns // 1000,
              "ts_ns": t0_ns, "dur": (t1_ns - t0_ns) / 1000,
              "pid": self._pid, "tid": tid}
        if attrs:
            ev["args"] = attrs
        with self._lock:
            self._maybe_name_thread(tid)
            self._events.append(ev)

    def _maybe_name_thread(self, tid: int):
        # caller holds the lock
        if tid in self._named_tids:
            return
        self._named_tids.add(tid)
        self._events.append({"ph": "M", "name": "thread_name",
                             "pid": self._pid, "tid": tid,
                             "args": {"name": threading.current_thread().name}})

    # -- merge / export ------------------------------------------------------
    def add_events(self, events: List[dict],
                   process_name: Optional[str] = None,
                   pid: Optional[int] = None):
        """Fold another process's event list in (cluster workers ship
        theirs to the coordinator at shutdown). ``process_name``/``pid``
        add the process metadata track when the shipped list lacks it."""
        with self._lock:
            if process_name is not None and pid is not None:
                if not any(e.get("ph") == "M"
                           and e.get("name") == "process_name"
                           and e.get("pid") == pid for e in events):
                    self._events.append(
                        {"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "args": {"name": process_name}})
            self._events.extend(events)

    def events(self) -> List[dict]:
        with self._lock:
            out = list(self._events)
        pid = self._pid
        out += [{"ph": "X", "name": name, "ts": t0 // 1000, "ts_ns": t0,
                 "dur": (t1 - t0) / 1000, "pid": pid, "tid": tid,
                 "args": {"k": k}}
                for name, t0, t1, tid, k in list(self._loop)]
        return out

    def export(self, path: str):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events(),
                       "displayTimeUnit": "ms"}, f)
            f.write("\n")


def load_trace(path: str) -> List[dict]:
    """Load a trace.json; tolerates a truncated file (killed writer).

    A SIGKILL mid-``export`` leaves a prefix of the JSON document on
    disk.  Rather than fail, salvage every complete event object from
    the ``traceEvents`` array — the crash-safe-artifacts contract
    (DESIGN.md §16): partially-written artifacts still load.
    """
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        return _recover_truncated_trace(text)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def _recover_truncated_trace(text: str) -> List[dict]:
    start = text.find("[")
    if start < 0:
        return []
    dec = json.JSONDecoder()
    events: List[dict] = []
    pos = start + 1
    n = len(text)
    while pos < n:
        while pos < n and text[pos] in ", \t\r\n":
            pos += 1
        if pos >= n or text[pos] == "]":
            break
        try:
            ev, pos = dec.raw_decode(text, pos)
        except json.JSONDecodeError:
            break  # truncated mid-object: keep what we have
        if isinstance(ev, dict):
            events.append(ev)
    return events


def span_tree(events: List[dict]) -> dict:
    """Index context-stamped spans: {span_id: event} for one trace set.

    Helper for connectivity checks ("is the client span an ancestor of
    the executor span?") over merged multi-process events.
    """
    by_id: dict = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        sid = args.get("span_id")
        if isinstance(sid, str):
            by_id[sid] = e
    return by_id


def is_ancestor(events: List[dict], ancestor_span_id: str,
                span_id: str) -> bool:
    """True if ``ancestor_span_id`` is on ``span_id``'s parent chain
    (walked through the stamped args of context-carrying spans)."""
    by_id = span_tree(events)
    seen = set()
    cur = by_id.get(span_id)
    while cur is not None:
        pid = (cur.get("args") or {}).get("parent_id")
        if pid == ancestor_span_id:
            return True
        if not isinstance(pid, str) or pid in seen:
            return False
        seen.add(pid)
        cur = by_id.get(pid)
    return False


def span_hotspots(events: List[dict]) -> List[dict]:
    """Aggregate complete ("X") events by name: count, total/mean ms —
    the obs_report 'where did the time go' table."""
    agg: dict = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        a = agg.setdefault(e["name"], {"name": e["name"], "count": 0,
                                       "total_ms": 0.0})
        a["count"] += 1
        a["total_ms"] += e.get("dur", 0.0) / 1e3
    out = sorted(agg.values(), key=lambda a: -a["total_ms"])
    for a in out:
        a["total_ms"] = round(a["total_ms"], 3)
        a["mean_ms"] = round(a["total_ms"] / max(a["count"], 1), 3)
    return out
