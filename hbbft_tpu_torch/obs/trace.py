"""Bounded protocol-event rings + the thread-local tracer.

Event model: a :class:`TraceEvent` is ``(ts, name, args)`` — wall-clock
seconds (``time.time()``, comparable across every node/thread on one
box, and with the engine's ``CLOCK_REALTIME`` stamps), a dotted
milestone name from the taxonomy in docs/OBSERVABILITY.md
(``epoch.open``, ``rbc.deliver``, ``ba.coin``, ...), and a small args
dict (era/epoch/proposer/round/...).

Cost model: events fire at MILESTONE rate (once per epoch phase
transition per proposer — tens per epoch), never per message, so the
ring can afford a lock and a timestamp.  The protocol modules emit via
the module-level :func:`emit`, which is a no-op costing one
thread-local attribute read when no tracer is installed — VirtualNet
simulations, unit tests, and the simulated-net benchmarks
(``NativeQhbNet``) never install one and stay unperturbed.

Memory model: the ring is a preallocated fixed-size list; overflow
drops the OLDEST event and counts it (``dropped``).  A reader that
polls often enough (the native node drains its engine ring every
sweep; the exporter snapshots on demand) sees everything; a reader
that does not still gets the newest ``capacity`` events and an honest
drop count — bounded memory under any flood (pinned by
tests/test_obs.py).

Copy of ``hbbft_tpu/obs/trace.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional


class TraceEvent(NamedTuple):
    ts: float        # wall-clock seconds (time.time() / CLOCK_REALTIME)
    name: str        # milestone name ("epoch.open", "ba.coin", ...)
    args: Dict[str, Any]


class TraceBuffer:
    """One node's (or the cluster's) bounded event ring.

    Thread-safe: a node's protocol thread and its transport's selector
    thread share one buffer (different milestones, same timeline).
    """

    __slots__ = ("track", "capacity", "_ring", "_head", "_tail",
                 "dropped", "_lock")

    def __init__(self, track: str = "", capacity: int = 8192) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.track = track
        self.capacity = capacity
        self._ring: List[Optional[TraceEvent]] = [None] * capacity
        self._head = 0  # total emitted (next write index, unwrapped)
        self._tail = 0  # oldest retained (unwrapped)
        self.dropped = 0
        self._lock = threading.Lock()

    def emit(self, name: str, **args: Any) -> None:
        ev = TraceEvent(time.time(), name, args)
        with self._lock:
            if self._head - self._tail == self.capacity:
                self._tail += 1
                self.dropped += 1
            self._ring[self._head % self.capacity] = ev
            self._head += 1

    def __len__(self) -> int:
        return self._head - self._tail

    def snapshot(self) -> List[TraceEvent]:
        """Copy of the retained events, oldest first (emit order — the
        exporter's bracketing relies on per-buffer order; cross-buffer
        alignment is by timestamp)."""
        with self._lock:
            return [
                self._ring[i % self.capacity]  # type: ignore[misc]
                for i in range(self._tail, self._head)
            ]

    def extend(self, events: List[TraceEvent]) -> None:
        """Append pre-stamped events (the native node's engine-ring
        drain path: stamps were taken in C at emit time)."""
        with self._lock:
            for ev in events:
                if self._head - self._tail == self.capacity:
                    self._tail += 1
                    self.dropped += 1
                self._ring[self._head % self.capacity] = ev
                self._head += 1


class _Tracer(threading.local):
    """Per-thread tracer state: the installed buffer plus a small
    context dict (era/epoch/proposer) the owning protocol layers keep
    current so leaf protocols (Broadcast, BinaryAgreement) can emit
    attributable milestones without API changes."""

    buf: Optional[TraceBuffer] = None

    def __init__(self) -> None:  # fresh ctx per thread
        self.ctx: Dict[str, Any] = {}
        # Saved contexts for swap(): single-thread simulators interleave
        # many nodes on one thread, and each node's accumulated ctx
        # (era, set at construction / era change) must survive the
        # interleaving.  Keyed by the buffer object (alive for the sim's
        # lifetime); install() clears it.
        self.saved: Dict[Any, Dict[str, Any]] = {}


_TLS = _Tracer()


def install(buf: Optional[TraceBuffer]) -> None:
    """Install ``buf`` as this thread's tracer (None uninstalls).  The
    context starts fresh; any swap() save-space is dropped."""
    _TLS.buf = buf
    _TLS.ctx = {}
    _TLS.saved = {}


def swap(buf: Optional[TraceBuffer]) -> None:
    """Switch this thread's tracer to ``buf``, PRESERVING each buffer's
    accumulated context across switches (unlike :func:`install`, which
    resets it).  This is the simulator hand-off: VirtualNet runs every
    node on one thread and swaps the matching buffer in around each
    handler call, so a node's era ctx (set once at construction or era
    change) keeps attributing its later emits."""
    t = _TLS
    if t.buf is buf:
        return
    if t.buf is not None:
        t.saved[t.buf] = t.ctx
    t.buf = buf
    t.ctx = t.saved.pop(buf, {}) if buf is not None else {}


def emit(name: str, **args: Any) -> None:
    """Emit a milestone through the thread's tracer; merges the current
    context under the explicit args.  No-op (one attribute read) when
    no tracer is installed."""
    buf = _TLS.buf
    if buf is None:
        return
    if _TLS.ctx:
        merged = dict(_TLS.ctx)
        merged.update(args)
        args = merged
    buf.emit(name, **args)


def set_ctx(**kw: Any) -> None:
    """Update the thread's tracer context (no-op without a tracer)."""
    if _TLS.buf is None:
        return
    _TLS.ctx.update(kw)


def clear_ctx(*keys: str) -> None:
    """Drop context keys (no-op without a tracer).  Epoch-level emits
    use this so a leaf-level key (proposer) set by an earlier message
    does not leak onto events that have no such attribution."""
    if _TLS.buf is None:
        return
    for k in keys:
        _TLS.ctx.pop(k, None)
