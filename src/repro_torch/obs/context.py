"""Request-scoped trace context, carried by contextvars and across the wire.

A :class:`TraceContext` names one node in a request's span tree:
``trace_id`` groups every span of one request, ``span_id`` names this
node, ``parent_id`` points at the node that caused it.  The current
context rides a :mod:`contextvars` ContextVar, so it follows the request
through nested spans in one thread for free; crossing a thread or a
process boundary is explicit — the sender serializes ``to_wire()`` into
the frame (transport does this automatically when a context is active)
and the receiver re-activates it with :func:`use_context`.

IDs are short random hex (no central allocator): 16 hex chars for the
trace, 8 for spans.  Collisions within one trace are what matters and at
8 hex chars they are negligible for the span counts a request produces.

Copy of ``repro/obs/context.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import contextlib
import contextvars
import secrets
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

__all__ = [
    "TraceContext",
    "new_trace",
    "current_context",
    "use_context",
]


@dataclass(frozen=True)
class TraceContext:
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None

    def child(self) -> "TraceContext":
        """A new span node under this one (same trace)."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=secrets.token_hex(4),
            parent_id=self.span_id,
        )

    def to_wire(self) -> Dict[str, Any]:
        """Plain-dict form for embedding in a transport frame."""
        d: Dict[str, Any] = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id is not None:
            d["parent_id"] = self.parent_id
        return d

    @classmethod
    def from_wire(cls, d: Any) -> Optional["TraceContext"]:
        """Decode a frame's context field; None for absent/malformed.

        Malformed contexts are dropped, never raised: a bad peer must not
        be able to break request handling by sending garbage trace state.
        """
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not isinstance(tid, str) or not isinstance(sid, str):
            return None
        pid = d.get("parent_id")
        if pid is not None and not isinstance(pid, str):
            pid = None
        return cls(trace_id=tid, span_id=sid, parent_id=pid)


_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = contextvars.ContextVar(
    "repro_trace_context", default=None
)


def new_trace() -> TraceContext:
    """Mint a fresh root context (new trace_id, no parent)."""
    return TraceContext(trace_id=secrets.token_hex(8), span_id=secrets.token_hex(4))


def current_context() -> Optional[TraceContext]:
    """The context active in this thread's execution context, if any."""
    return _CURRENT.get()


@contextlib.contextmanager
def use_context(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Activate ``ctx`` for the dynamic extent of the with-block.

    Accepts None as a no-op so call sites can write
    ``with use_context(maybe_ctx):`` without branching.
    """
    if ctx is None:
        yield None
        return
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)
