"""Socket transport for the cluster runtime — framing, counters, failure.

Stdlib-only (``socket`` + ``pickle``; no MPI, no grpc): messages are
length-prefixed pickles of ``{"type": str, ...}`` dicts whose values are
plain Python and numpy arrays. The framing is deliberately boring — the
interesting contract is the ACCOUNTING: every connection counts frame
bytes per message type, because "what crosses the wire per iteration"
is the paper's headline quantity and BENCH_cluster.json records it
(n-vector reductions vs the O(m) a consensus scheme would move).

Failure model: a peer death surfaces as EOF/ECONNRESET on ``recv``
(raised as :class:`ConnectionClosed`) — the coordinator's per-worker
receiver threads translate that into a death event, which is how a
SIGKILLed worker is detected within one read rather than one heartbeat
timeout.

Trust model: pickle over a socket means the transport must only ever be
pointed at the coordinator's own spawned workers (localhost by default).
This is a cluster runtime for a solver you launched, not a public
endpoint — do not expose the listener beyond hosts you control.

Copy of ``repro/cluster/transport.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import pickle
import random
import socket
import struct
import threading
import time
from typing import Optional, Tuple

from repro_torch.obs.context import current_context
from repro_torch.obs.metrics import MetricsRegistry

_LEN = struct.Struct(">Q")

# A corrupted (or hostile) 8-byte header must not drive _recv_exact into
# an arbitrary multi-GB allocation: any decoded frame length above this
# cap is treated as a desynchronized/corrupt stream and the connection
# dies. Real frames are n-vector contributions and x broadcasts — MBs at
# the very largest — so 1 GiB is generous by orders of magnitude.
MAX_FRAME_BYTES = 1 << 30

# Once the first header byte has arrived the peer is mid-send and the
# rest of the frame is read under this completion deadline rather than
# fully blocking: a peer SIGSTOPped mid-send (socket open, stream
# frozen) must not pin the receiver thread forever.
FRAME_DEADLINE_S = 120.0

# registry series the counter writes: transport.{tx,rx}_{bytes,msgs}
# labelled by message type — the wire-accounting schema every other
# registry consumer (telemetry deltas, obs_report) reads back.
_SECTIONS = (("sent_bytes", "transport.tx_bytes"),
             ("sent_msgs", "transport.tx_msgs"),
             ("received_bytes", "transport.rx_bytes"),
             ("received_msgs", "transport.rx_msgs"))


class ConnectionClosed(Exception):
    """Peer went away (EOF / reset) — the transport-level death signal."""


#: sentinel distinguishing "no per-accept override" from an explicit None
_UNSET = object()


class ByteCounter:
    """Per-message-type frame byte/count totals, backed by a
    :class:`~repro_torch.obs.metrics.MetricsRegistry` (DESIGN.md §12): the
    transport's accounting is ordinary labelled counters, so a worker's
    wire bytes ship, merge, and report through the same snapshot schema
    as every other metric. The legacy dict shape of :meth:`snapshot` /
    :meth:`merge` (sent_bytes/sent_msgs/received_*) is preserved — it is
    the cluster telemetry and BENCH_cluster.json surface."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()

    def add(self, direction: str, tag: str, nbytes: int):
        d = "tx" if direction == "tx" else "rx"
        self.registry.inc(f"transport.{d}_bytes", nbytes, type=tag)
        self.registry.inc(f"transport.{d}_msgs", 1, type=tag)

    def snapshot(self) -> dict:
        return {key: {t: int(v)
                      for t, v in self.registry.labeled(name, "type").items()}
                for key, name in _SECTIONS}

    def merge(self, other: dict):
        """Fold another counter's :meth:`snapshot` into this one (the
        coordinator aggregates worker-reported counters at shutdown)."""
        for key, name in _SECTIONS:
            for tag, v in other.get(key, {}).items():
                self.registry.inc(name, v, type=tag)

    def total(self, direction: str = "tx") -> int:
        d = "tx" if direction == "tx" else "rx"
        return int(sum(
            self.registry.labeled(f"transport.{d}_bytes", "type").values()))


class Connection:
    """One framed duplex channel. ``send`` is locked (multiple threads —
    main loop + heartbeat — share the coordinator link); ``recv`` must
    stay single-threaded per connection (one receiver thread each)."""

    def __init__(self, sock: socket.socket,
                 counter: Optional[ByteCounter] = None,
                 chaos=None,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 frame_deadline_s: float = FRAME_DEADLINE_S):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass                     # non-TCP socket (tests, AF_UNIX)
        self._sock = sock
        self._send_lock = threading.Lock()
        self.counter = counter or ByteCounter()
        self.closed = False
        # optional FaultInjector (repro_torch.cluster.chaos) consulted on send;
        # None (the default) costs one attribute check per frame
        self.chaos = chaos
        self.max_frame_bytes = max_frame_bytes
        self.frame_deadline_s = frame_deadline_s

    @property
    def peer(self) -> Tuple[str, int]:
        return self._sock.getpeername()

    def send(self, msg_type: str, **payload):
        # Trace propagation (DESIGN.md §16): when a request-scoped
        # TraceContext is active in this thread, stamp it into the frame
        # as the optional "_ctx" field. Frames are plain dicts, so peers
        # that predate the field ignore the extra key, and frames
        # without it decode exactly as before — compatible both ways.
        ctx = current_context()
        if ctx is not None and "_ctx" not in payload:
            payload["_ctx"] = ctx.to_wire()
        frame = pickle.dumps({"type": msg_type, **payload},
                             protocol=pickle.HIGHEST_PROTOCOL)
        copies = 1
        if self.chaos is not None:
            for kind, param in self.chaos.on_send(msg_type):
                if kind == "drop":
                    self.counter.add("tx", msg_type,
                                     _LEN.size + len(frame))
                    return           # vanished on the wire
                if kind == "delay":
                    time.sleep(param / 1e3)
                elif kind == "dup":
                    copies = 2
                elif kind == "corrupt":
                    frame = self.chaos.corrupt(frame)
                elif kind == "reset":
                    self.close()
                    raise ConnectionClosed("chaos: connection reset")
        header = _LEN.pack(len(frame))
        try:
            with self._send_lock:
                for _ in range(copies):
                    self._sock.sendall(header + frame)
        except OSError as e:
            self.closed = True
            raise ConnectionClosed(str(e)) from e
        self.counter.add("tx", msg_type, copies * (len(header) + len(frame)))

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except socket.timeout:
                raise
            except OSError as e:
                self.closed = True
                raise ConnectionClosed(str(e)) from e
            if not chunk:
                self.closed = True
                raise ConnectionClosed("EOF")
            buf.extend(chunk)
        return bytes(buf)

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Next message, or None on IDLE timeout. Raises
        ConnectionClosed on peer death. Only a timeout with ZERO bytes
        read returns None: once the first header byte has arrived the
        peer is alive and mid-send, so the rest of the frame is read
        under ``frame_deadline_s`` — a mid-header timeout must never
        drop buffered bytes and desynchronize the length-prefixed
        stream, but a peer frozen mid-send (SIGSTOP) must not pin this
        thread forever either. A blown deadline, an absurd decoded
        length, or an undecodable frame all kill the connection: once
        any of those happens the stream cannot be trusted again."""
        try:
            # settimeout itself can race a close() from another thread
            # (recovery severing a retired worker's link): that is a
            # dead connection, not a crash in the receiver thread
            self._sock.settimeout(timeout)
            first = self._recv_exact(1)
        except socket.timeout:
            return None
        except OSError as e:
            self.closed = True
            raise ConnectionClosed(str(e)) from e
        try:
            # finish the frame under a completion deadline
            self._sock.settimeout(self.frame_deadline_s)
            header = first + self._recv_exact(_LEN.size - 1)
            length = _LEN.unpack(header)[0]
            if length > self.max_frame_bytes:
                self.close()
                raise ConnectionClosed(
                    f"frame length {length} exceeds cap "
                    f"{self.max_frame_bytes} (corrupt stream)")
            frame = self._recv_exact(length)
        except socket.timeout:
            self.close()
            raise ConnectionClosed(
                f"frame stalled mid-receive for {self.frame_deadline_s}s "
                "(peer hung mid-send)") from None
        except ConnectionClosed:
            raise
        except OSError as e:                  # settimeout raced a close()
            self.closed = True
            raise ConnectionClosed(str(e)) from e
        try:
            msg = pickle.loads(frame)
            if not isinstance(msg, dict):
                raise ValueError("frame is not a message dict")
        except ConnectionClosed:
            raise
        except Exception as e:
            self.close()
            raise ConnectionClosed(f"undecodable frame: {e}") from e
        self.counter.add("rx", msg.get("type", "?"),
                         _LEN.size + len(frame))
        return msg

    def close(self):
        self.closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class Listener:
    """Bound server socket (port 0 -> OS-assigned; workers report theirs
    back to the coordinator at registration).

    ``chaos`` / ``max_frame_bytes`` / ``frame_deadline_s`` set here become
    the defaults every accepted :class:`Connection` inherits — the fit
    service front end accepts from untrusted-ish clients and needs a much
    smaller frame cap and a short frame-completion deadline (a slow-loris
    client that sends half a header and stalls must be severed, not
    allowed to pin a handler thread for the cluster default of 120 s)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 chaos=None,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 frame_deadline_s: float = FRAME_DEADLINE_S):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address: Tuple[str, int] = self._sock.getsockname()
        self.chaos = chaos
        self.max_frame_bytes = max_frame_bytes
        self.frame_deadline_s = frame_deadline_s

    def accept(self, timeout: Optional[float] = None,
               counter: Optional[ByteCounter] = None, *,
               chaos=_UNSET,
               max_frame_bytes: Optional[int] = None,
               frame_deadline_s: Optional[float] = None
               ) -> Optional[Connection]:
        """Accept one connection; keyword overrides beat the listener
        defaults per accepted connection (``chaos=None`` explicitly
        disables injection for this connection even when the listener
        carries an injector)."""
        self._sock.settimeout(timeout)
        try:
            sock, _ = self._sock.accept()
        except socket.timeout:
            return None
        return Connection(
            sock, counter=counter,
            chaos=self.chaos if chaos is _UNSET else chaos,
            max_frame_bytes=(self.max_frame_bytes if max_frame_bytes is None
                             else max_frame_bytes),
            frame_deadline_s=(self.frame_deadline_s if frame_deadline_s is None
                             else frame_deadline_s))

    def close(self):
        self._sock.close()


def connect(address: Tuple[str, int], timeout: float = 10.0,
            counter: Optional[ByteCounter] = None, *,
            retries: int = 0, backoff_s: float = 0.5,
            backoff_max_s: float = 10.0, jitter: float = 0.25,
            chaos=None) -> Connection:
    """Dial ``address``, retrying with exponential backoff + jitter.

    ``retries`` extra attempts follow a failed dial, sleeping
    ``min(backoff_s * 2**attempt, backoff_max_s) * (1 + U[0,jitter])``
    between them — the jitter keeps a herd of workers re-registering
    against a relaunched coordinator from dialing in lockstep. The
    default ``retries=0`` preserves the old single-attempt behavior.
    Failure raises :class:`ConnectionClosed` (the caller-facing "peer
    unreachable" signal) rather than a raw ``OSError``."""
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            sock = socket.create_connection(address, timeout=timeout)
            sock.settimeout(None)
            return Connection(sock, counter=counter, chaos=chaos)
        except OSError as e:
            last = e
            if attempt == retries:
                break
            delay = min(backoff_s * (2.0 ** attempt), backoff_max_s)
            time.sleep(delay * (1.0 + jitter * random.random()))
    raise ConnectionClosed(
        f"connect to {address} failed after {retries + 1} attempt(s): "
        f"{last}") from last
