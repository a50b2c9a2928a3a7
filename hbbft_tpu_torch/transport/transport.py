"""Non-blocking TCP transport: one node's socket plane.

Design (patterned after thetacrypt's networked
threshold-service deployments, PAPERS.md):

* One ``selectors``-based event loop per node, running on its own
  thread.  All socket state is owned by that thread; other threads talk
  to it through a control deque + self-pipe wakeup (``send``,
  ``set_offline``, ``stop``).
* **Connection topology:** each node *dials* every peer it sends to and
  *accepts* from every peer that sends to it — two unidirectional TCP
  connections per talking pair.  The dialer writes frames; the acceptor
  only reads.  This removes the simultaneous-connect dedupe dance
  entirely (both sides dialing each other is the normal state, not a
  conflict).
* **Handshake:** the dialer's first frame is ``HELLO(version,
  cluster_id, node_id)``; the acceptor learns the sender's identity
  from it and drops version/cluster mismatches.  Protocol frames on a
  connection before its HELLO are a protocol violation (dropped
  connection).
* **Outbound queues + backpressure:** per-peer FIFO of encoded frames,
  capped in frames and bytes (``max_queue_frames`` /
  ``max_queue_bytes``).  Overflow drops the NEWEST frame and counts it
  (``queue_overflow``) — HoneyBadger tolerates message loss to f nodes,
  and the sender queue re-gates per-epoch traffic, so bounded loss
  under backpressure is protocol-safe; unbounded buffering toward a
  dead peer is not memory-safe.  Queues survive disconnects: frames not
  yet written when a connection dies are re-sent on the next connect
  (bytes already in the kernel buffer of a dead peer are gone — that is
  the loss window a mid-epoch crash produces).
* **Vectored egress (round 14):** when the platform has
  ``socket.sendmsg``, outbound bursts
  leave as ONE gather syscall over the queue's own frame bytes instead
  of a per-frame copy into ``sendbuf``; partial sends fall back to the
  buffered path with identical ``pending_write``/``write_prog``/ACK
  accounting (see :meth:`TcpTransport._flush_outbound_vectored`).
* **Reconnect:** failed dials retry with exponential backoff + jitter
  (``backoff_base_s * 2^attempts`` capped at ``backoff_cap_s``, times
  ``1 + jitter * u``), seeded per node for reproducible tests.
* **Fault injection:** an optional
  :class:`~hbbft_tpu_torch.transport.faults.FaultInjector` sits exactly at
  the send boundary (encoded frame -> list of delayed/mangled copies).
* **Observability:** per-peer :class:`PeerStats` (bytes/frames in+out,
  queue depth, drops, reconnects, frame errors) exported into
  :class:`~hbbft_tpu_torch.utils.metrics.Metrics` as counters + gauges.
* **Misbehavior accounting (round 11):** frame-level violations on an
  identified inbound connection charge the announced peer a strike;
  every ``ban_threshold`` strikes earn a deterministic escalating
  reconnect ban (:func:`ban_duration`), refusing the peer's HELLOs
  until it lapses — a Byzantine peer can no longer corrupt one frame
  per reconnect forever at zero cost.  Exported as ``peer.*`` gauges.

Read-path safety: every ``recv`` is bounded by ``RECV_CHUNK`` and every
received byte goes through a :class:`FrameDecoder` capped at
``max_frame_len`` *before* any parsing (lint rule HBT006 machine-checks
both).  A frame error never crashes the node: the connection is
dropped, the fault is counted, and reconnect recovers.

Copy of ``hbbft_tpu/transport/transport.py``.  The ``injector`` hook
takes the port's :class:`~hbbft_tpu_torch.transport.faults.FaultInjector`
(or anything with its ``start``/``on_send``).  The reference's environment A/B
switches are arguments here: vectored egress is on wherever
``socket.sendmsg`` exists, and coalescing is the ``coalesce=``
constructor argument.  The native-engine hooks (``on_wire_batch``,
:meth:`TcpTransport.send_msgb`, :meth:`TcpTransport.send_wire`) are the
reference's.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import random
import selectors
import socket
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from hbbft_tpu_torch.transport.framing import (
    KIND_ACK,
    KIND_HELLO,
    KIND_MSG,
    KIND_MSGB,
    MAX_FRAME_LEN,
    RECV_CHUNK,
    FrameDecoder,
    FrameError,
    decode_ack,
    decode_hello,
    decode_msgb,
    encode_ack,
    encode_frame,
    encode_hello,
    frame_message_count,
    msgb_body,
    validate_msgb,
)
from hbbft_tpu_torch.utils.metrics import Metrics


@dataclass
class PeerStats:
    """One peer's transport counters (single-writer: the loop thread)."""

    bytes_out: int = 0
    frames_out: int = 0
    bytes_in: int = 0
    frames_in: int = 0
    # Coalescing efficiency (round 20): protocol messages carried by
    # the frames above — an MSG frame counts 1, an MSGB frame counts
    # its batch size.  msgs/frames is the msgs-per-frame ratio the
    # config6/config7 JSON lines surface, so A/B arms self-describe
    # how much the wire actually coalesced.
    msgs_out: int = 0
    msgs_in: int = 0
    queue_frames: int = 0
    queue_bytes: int = 0
    queue_overflow: int = 0
    dials: int = 0
    connects: int = 0
    reconnects: int = 0
    accepts: int = 0
    frame_errors: int = 0
    # Byzantine accounting (round 11): protocol violations on an
    # IDENTIFIED inbound connection (frame errors after a valid HELLO)
    # are misbehavior strikes; every ``ban_threshold`` strikes earn an
    # escalating reconnect ban, and HELLOs refused during a ban count
    # as ban_rejects.  Without the ban, a peer could corrupt one frame
    # per reconnect forever at zero cost (the corrupt-frame/reconnect
    # loop): each violation costs only the attacker's own connection,
    # which backoff restores in milliseconds.
    misbehavior: int = 0
    bans: int = 0
    ban_rejects: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


def ban_duration(offense: int, base_s: float, cap_s: float) -> float:
    """Length of a peer's ``offense``-th reconnect ban (0-based): pure
    exponential escalation with NO jitter, so the schedule is a
    deterministic function of the strike count alone — the chaos tier
    pins this (seed-deterministic ban escalation).  The exponent is
    clamped: 2.0**offense overflows float at offense >= 1024, and a
    sustained corrupt-frame loop reaches that many bans in under an
    hour — an OverflowError here would tear down the VICTIM's whole
    transport loop (the attack the ban exists to price)."""
    return min(cap_s, base_s * (2.0 ** min(offense, 64)))


class _BanReject(FrameError):
    """HELLO refused because the announced peer is under an active
    reconnect ban.  A distinct type so the read path's FrameError
    handler can close the connection WITHOUT counting a frame error:
    ban rejects are the defense working, not channel corruption, and
    conflating them would inflate ``transport.frame_errors`` by one
    per refused redial for the whole ban window."""


class _BanState:
    """Per-peer misbehavior ledger (loop thread only)."""

    __slots__ = ("strikes", "bans", "until")

    def __init__(self) -> None:
        self.strikes = 0   # violations since the last ban
        self.bans = 0      # escalation level (total bans issued)
        self.until = 0.0   # monotonic deadline of the active ban


#: Outbound write-coalescing bound: frames are packed into the write
#: buffer up to this size before ONE send() syscall covers them all.
#: With the native-engine node the per-frame syscall (plus its selector
#: churn) was the measured socket-plane bound once decode moved to C;
#: matching RECV_CHUNK keeps one write ~= one peer read burst.
SEND_COALESCE = RECV_CHUNK

#: ACK coalescing: a cumulative ACK is written immediately once this
#: many frames are unacknowledged, else a short timer batches it.  One
#: ACK per read burst was the next measured socket-plane bound after
#: write coalescing (2 syscalls + a wakeup on EACH side per burst);
#: cumulative counts make delay harmless — a reconnect's initial ACK is
#: always the receiver's authoritative count, so resume never double-
#: delivers, and the sender just retains the unacked tail a little
#: longer (bounded by the queue caps, which inflight counts toward).
ACK_EVERY = 64
ACK_DELAY_S = 0.02

#: Vectored egress (round 14): one ``sendmsg()`` over the pending frame
#: list replaces the per-frame copy into ``sendbuf`` — MSG bursts leave
#: as a gather array of the frame bytes the queue already holds.  The
#: buffered ``sendbuf`` path remains the fallback for partial sends
#: (the unsent tail is retained there, byte-identical accounting) and
#: for platforms without ``socket.sendmsg``.
SENDMSG_AVAILABLE = hasattr(socket.socket, "sendmsg")

#: Gather-array length cap per sendmsg call.  Linux UIO_MAXIOV is 1024;
#: half that leaves headroom for any platform with a smaller limit
#: while still covering a whole SEND_COALESCE window of small frames.
SENDMSG_MAX_BUFS = 512


class _Outbound:
    """Dialer-side state toward one peer.

    The resume layer: ``queue`` holds frames not yet written, as
    ``(orig, wire)`` pairs (``wire`` is a fault-injector-mangled copy to
    put on the wire ONCE; retransmissions always send ``orig`` — a
    corrupted transmission models a transient channel fault, not a
    poisoned message).  ``inflight`` holds originals fully written but
    not yet covered by the peer's cumulative ACK; after a reconnect the
    un-acked tail is retransmitted ahead of new traffic, so a surviving
    peer misses nothing across a disconnect.  ``await_ack`` gates MSG
    writes on a fresh connection until the acceptor's initial ACK tells
    us where to resume.

    Writes are coalesced: ``pending_write`` tracks the frames currently
    inside ``sendbuf`` as ``(wire_len, orig)`` in order, and
    ``write_prog`` counts bytes of the FIRST of them already accepted by
    the kernel — fully-covered frames graduate to ``inflight``; on a
    drop, every not-fully-written frame's original re-queues at the head
    (the peer never consumed them).
    """

    __slots__ = (
        "addr", "sock", "state", "queue", "queue_bytes", "sendbuf",
        "attempts", "next_dial", "inflight", "inflight_bytes", "acked",
        "await_ack", "pending_write", "pending_write_bytes", "write_prog",
        "decoder", "want_w",
    )

    def __init__(self, addr: Tuple[str, int]) -> None:
        self.addr = addr
        self.sock: Optional[socket.socket] = None
        self.state = "idle"  # idle | connecting | connected
        self.queue: collections.deque = collections.deque()  # (orig, wire)
        self.queue_bytes = 0
        self.sendbuf = bytearray()
        self.attempts = 0
        self.next_dial = 0.0  # monotonic deadline for the next dial try
        self.inflight: collections.deque = collections.deque()  # orig bytes
        self.inflight_bytes = 0
        self.acked = 0
        self.await_ack = False
        # frames currently in sendbuf: (wire_len, orig), write progress
        self.pending_write: collections.deque = collections.deque()
        self.pending_write_bytes = 0  # sum of ORIG lens (cap accounting)
        self.write_prog = 0
        self.decoder: Optional[FrameDecoder] = None  # ACK stream parser
        self.want_w = False  # selector write-interest memo (syscall dedup)

    def pending_frames(self) -> int:
        return len(self.queue) + len(self.inflight) + len(self.pending_write)

    def pending_bytes(self) -> int:
        return self.queue_bytes + self.inflight_bytes + self.pending_write_bytes

    def has_pending(self) -> bool:
        return self.pending_frames() > 0


class _Inbound:
    """Acceptor-side state for one accepted connection."""

    __slots__ = ("sock", "decoder", "peer_id", "sendbuf", "last_ack",
                 "ack_timer", "want_w")

    def __init__(self, sock: socket.socket, max_frame_len: int) -> None:
        self.sock = sock
        self.decoder = FrameDecoder(max_frame_len)
        self.peer_id: Any = None
        self.sendbuf = bytearray()  # pending ACK frames
        self.last_ack = 0       # cumulative count last written as an ACK
        self.ack_timer = False  # a coalescing ack flush is scheduled
        self.want_w = False     # selector write-interest memo


class _ConsumerOverload(Exception):
    """on_message refused a frame (consumer queue full): drop the
    connection WITHOUT acking, so the dialer resumes from the acked
    prefix — the cumulative count means "first n frames consumed" and
    skipping one frame mid-stream would misalign it forever."""


class TcpTransport:
    def __init__(
        self,
        node_id: Any,
        cluster_id: bytes,
        peers: Optional[Dict[Any, Tuple[str, int]]] = None,
        on_message: Optional[Callable[[Any, bytes], None]] = None,
        on_batch: Optional[Callable[[Any, List[bytes]], int]] = None,
        on_wire_batch: Optional[
            Callable[[Any, List[Tuple[int, bytes]]], int]
        ] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_frame_len: int = MAX_FRAME_LEN,
        max_queue_frames: int = 20_000,
        max_queue_bytes: int = 64 << 20,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        backoff_jitter: float = 0.3,
        metrics: Optional[Metrics] = None,
        injector: Any = None,
        seed: int = 0,
        accept_unknown_peers: bool = False,
        ban_threshold: int = 3,
        ban_base_s: float = 0.25,
        ban_cap_s: float = 2.0,
        coalesce: bool = True,
    ) -> None:
        self.node_id = node_id
        self.cluster_id = cluster_id
        self.on_message = on_message
        # Burst consumer (round 9): when set, all MSG frames of one read
        # burst are handed over in a single call — ``on_batch(peer,
        # payloads) -> frames consumed`` — instead of one ``on_message``
        # per frame.  A return short of the full burst means the
        # consumer stopped at a prefix (inbox full): the connection is
        # dropped WITHOUT acking the remainder, exactly the per-frame
        # path's _ConsumerOverload semantics, and the peer's resume
        # layer retransmits.  This is what lets a native-engine node
        # move a whole RECV_CHUNK of frames per Python call.
        # Wire-burst consumer (round 20): like ``on_batch`` but frames
        # arrive in WIRE form — ``on_wire_batch(peer, records) ->
        # frames consumed`` with each record ``(nmsg, data)``: nmsg ==
        # 0 is a plain MSG payload, nmsg >= 1 a validated raw MSGB body
        # (grammar-checked here, NOT sliced — the native engine walks
        # the body in C, which is the whole point).  Precedence:
        # on_wire_batch > on_batch > on_message.
        self.on_wire_batch = on_wire_batch
        self.on_batch = on_batch
        self.max_frame_len = max_frame_len
        self.max_queue_frames = max_queue_frames
        self.max_queue_bytes = max_queue_bytes
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.backoff_jitter = backoff_jitter
        self.metrics = metrics if metrics is not None else Metrics()
        self.injector = injector
        # Per-peer acceptor state (PeerStats, _rx_counts) is keyed by the
        # HELLO-announced id; without this gate one unauthenticated local
        # client could grow both maps without bound by announcing fresh
        # ids.  True is for topologies where inbound peers are not known
        # up front (joining nodes); the in-process clusters never need it.
        self.accept_unknown_peers = accept_unknown_peers
        # Misbehavior/ban policy (round 11).  ban_threshold <= 0
        # disables banning (strikes are still counted).  The ban caps
        # at ban_cap_s per offense, so an honest peer on a corrupting
        # CHANNEL (injector corrupt_p) is delayed, never locked out —
        # its dialer retries past the ban and the resume layer replays
        # the clean originals (losslessness is test-pinned).
        self.ban_threshold = ban_threshold
        self.ban_base_s = ban_base_s
        self.ban_cap_s = ban_cap_s
        # Vectored egress (round 14) wherever the platform has sendmsg;
        # the two paths are output-identical by construction.
        self.vectored = SENDMSG_AVAILABLE
        # Message coalescing (round 20): False sends one MSG frame per
        # message.  Gates egress packing only — ingress accepts MSGB
        # unconditionally (accept-both interop).
        self.coalesce = bool(coalesce)
        self._bans: Dict[Any, _BanState] = {}
        # Flight recorder (round 12): an optional TraceBuffer the owner
        # (LocalCluster) installs; connect/disconnect/ban milestones land
        # on the same per-node timeline as the protocol events.
        self.tracer: Any = None
        self._rng = random.Random(f"transport|{seed}|{node_id}")
        self._host = host
        self._sel = selectors.DefaultSelector()
        self._listener: Optional[socket.socket] = None
        self._port = 0
        self._bind(host, port)
        self._out: Dict[Any, _Outbound] = {}
        for pid, addr in (peers or {}).items():
            self._out[pid] = _Outbound(tuple(addr))
        # accepted-connection cap: every peer may hold a live connection
        # plus a few churning replacements; beyond that is abuse
        self.max_inbound = 4 * max(1, len(self._out)) + 8
        self.peer_stats: Dict[Any, PeerStats] = collections.defaultdict(PeerStats)
        self._inbound: List[_Inbound] = []
        # Cumulative MSG frames consumed per sending peer, across
        # reconnects — the number the resume layer ACKs back.  Dies with
        # the process (a restarted node ACKs 0; dialers adopt the reset).
        self._rx_counts: Dict[Any, int] = collections.defaultdict(int)
        # control plane: any thread appends + wakes; loop thread drains
        self._control: collections.deque = collections.deque()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None))
        self._timers: List[Tuple[float, int, str, Any]] = []
        self._timer_seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self.offline = False
        self._desired_offline = False  # last requested state (rebind retry)

    # -- lifecycle -----------------------------------------------------
    @property
    def port(self) -> int:
        return self._port

    @property
    def addr(self) -> Tuple[str, int]:
        return (self._host, self._port)

    def _bind(self, host: str, port: int) -> None:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((host, port))
        ls.listen(128)
        ls.setblocking(False)
        self._listener = ls
        self._port = ls.getsockname()[1]
        self._sel.register(ls, selectors.EVENT_READ, ("listen", None))

    def set_peers(self, peers: Dict[Any, Tuple[str, int]]) -> None:
        """Install the peer address map (before start())."""
        assert self._thread is None, "set_peers before start"
        for pid, addr in peers.items():
            if pid == self.node_id:
                continue
            self._out[pid] = _Outbound(tuple(addr))
        self.max_inbound = 4 * max(1, len(self._out)) + 8

    def start(self) -> None:
        assert self._thread is None
        if self.injector is not None:
            self.injector.start()
        self._thread = threading.Thread(
            target=self._run, name=f"transport-{self.node_id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._post(("stop", None))
        self._thread.join(timeout=10)
        self._thread = None

    def set_offline(self, offline: bool) -> None:
        """Sever all connections and stop listening/dialing (True), or
        rebind the same port and resume (False).  Outbound queues are
        preserved — this simulates a network outage around a live
        process, the sender-queue churn scenario."""
        self._post(("offline", bool(offline)))

    # -- data plane (any thread) ---------------------------------------
    def send(self, dest: Any, payload: bytes) -> None:
        """Frame + queue one protocol message toward ``dest``.

        Each injector-planned copy becomes its own logical frame; a
        mangled copy keeps its original alongside so a retransmission
        (after the receiver drops the corrupted connection) carries the
        clean bytes — the channel is faulty, the message is not.
        """
        frame = encode_frame(KIND_MSG, payload, self.max_frame_len)
        if self.injector is not None:
            plan = self.injector.on_send(self.node_id, dest, frame)
        else:
            plan = [(0.0, frame)]
        for delay_s, data in plan:
            wire = data if data != frame else None
            self._post(("enqueue", (dest, delay_s, frame, wire)))

    def send_many(self, items: List[Tuple[Any, bytes]]) -> None:
        """Frame + queue a batch of ``(dest, payload)`` messages with ONE
        control-plane hand-off (one wakeup byte and one loop-thread drain
        op instead of one per message).  With coalescing on (round 20,
        the default) each destination's run leaves as the fewest frames
        the caps allow — MSGB batches bounded by ``max_frame_len``,
        singletons as plain MSG — making the FRAME the ACK/resume unit
        for the whole batch; ``coalesce=False`` sends one MSG frame
        per message.  Either way the fault injector still
        plans each *frame* individually, and per-dest FIFO order — the
        only order the transport guarantees — is preserved (grouping by
        dest never reorders within a dest)."""
        by_dest: Dict[Any, List[bytes]] = {}
        for dest, payload in items:
            by_dest.setdefault(dest, []).append(payload)
        batch: List[Tuple[Any, float, bytes, Optional[bytes]]] = []
        for dest, payloads in by_dest.items():
            for frame in self._pack_frames(payloads):
                if self.injector is not None:
                    plan = self.injector.on_send(self.node_id, dest, frame)
                else:
                    plan = ((0.0, frame),)
                for delay_s, data in plan:
                    wire = data if data != frame else None
                    batch.append((dest, delay_s, frame, wire))
        if batch:
            self._post(("enqueue_many", batch))

    def _pack_frames(self, payloads: List[bytes]) -> List[bytes]:
        """Encode one destination's payload run as wire frames.  With
        coalescing off: one MSG frame per payload.  On: greedy MSGB
        groups bounded by ``max_frame_len``; a group that ends up with
        a single payload stays a plain MSG frame (byte-identical to the
        uncoalesced arm — no count/length overhead for singletons)."""
        limit = self.max_frame_len
        if not self.coalesce or len(payloads) == 1:
            return [encode_frame(KIND_MSG, p, limit) for p in payloads]
        frames: List[bytes] = []
        group: List[bytes] = []
        group_len = 5  # frame length counts the kind byte + count field

        def close() -> None:
            if len(group) == 1:
                frames.append(encode_frame(KIND_MSG, group[0], limit))
            elif group:
                frames.append(encode_frame(KIND_MSGB, msgb_body(group), limit))

        for p in payloads:
            need = 4 + len(p)  # element length header + bytes
            if group and group_len + need > limit:
                close()
                group = []
                group_len = 5
            group.append(p)
            group_len += need
        close()
        return frames

    def send_msgb(self, dest: Any, body: bytes, count: int) -> None:
        """Frame + queue a pre-built MSGB body of ``count`` messages
        toward ``dest``.  The native engine's egress drain emits bodies
        already in the wire grammar (framing.py "msgb-grammar"), so the
        hot path is ONE ``encode_frame`` per (peer, sweep) — no
        per-message Python at all.  With coalescing off (or a
        degenerate count) the body is unpacked and routed through
        :meth:`send_many`, so ``coalesce`` governs the wire uniformly;
        the chaos plane wraps this method to keep its per-message
        egress seam (chaos/nodes.py)."""
        if count <= 1 or not self.coalesce:
            self.send_many([(dest, p) for p in decode_msgb(body)])
            return
        frame = encode_frame(KIND_MSGB, body, self.max_frame_len)
        if self.injector is not None:
            plan = self.injector.on_send(self.node_id, dest, frame)
        else:
            plan = ((0.0, frame),)
        batch = []
        for delay_s, data in plan:
            wire = data if data != frame else None
            batch.append((dest, delay_s, frame, wire))
        self._post(("enqueue_many", batch))

    def send_wire(
        self, records: List[Tuple[Any, int, bytes]]
    ) -> None:
        """Frame + queue a whole egress sweep of pre-packed wire records
        with ONE control-plane hand-off.  Each record is ``(dest, count,
        data)``: a plain MSG payload when ``count <= 1``, else a
        pre-built MSGB body of ``count`` messages (the native drain's
        output shape — see :meth:`send_msgb`).  Emission order is
        preserved end to end (one ``enqueue_many`` op), so per-dest
        FIFO holds with no caller-side buffering; the drain's per-dest
        grouping also keeps same-dest records adjacent, which the loop
        thread's run-batching exploits.  With coalescing off, MSGB
        records are unpacked and the whole sweep routes through
        :meth:`send_many` — ``coalesce`` governs the wire uniformly.
        The chaos plane wraps this method alongside send/send_many/
        send_msgb (chaos/nodes.py)."""
        if not self.coalesce:
            flat: List[Tuple[Any, bytes]] = []
            for dest, count, data in records:
                if count <= 1:
                    flat.append((dest, data))
                else:
                    flat.extend((dest, p) for p in decode_msgb(data))
            if flat:
                self.send_many(flat)
            return
        limit = self.max_frame_len
        batch: List[Tuple[Any, float, bytes, Optional[bytes]]] = []
        for dest, count, data in records:
            kind = KIND_MSG if count <= 1 else KIND_MSGB
            frame = encode_frame(kind, data, limit)
            if self.injector is not None:
                plan = self.injector.on_send(self.node_id, dest, frame)
            else:
                plan = ((0.0, frame),)
            for delay_s, d in plan:
                wire = d if d != frame else None
                batch.append((dest, delay_s, frame, wire))
        if batch:
            self._post(("enqueue_many", batch))

    def _post(self, item: Tuple[str, Any]) -> None:
        self._control.append(item)
        try:
            self._wake_w.send(b"\x00")
        except BlockingIOError:
            pass  # a wakeup byte is already pending
        except OSError:
            pass  # loop already torn down

    # -- stats ---------------------------------------------------------
    def stats(self) -> Dict[Any, Dict[str, int]]:
        # list(): the loop thread inserts new peers concurrently
        return {pid: st.as_dict() for pid, st in list(self.peer_stats.items())}

    def export_metrics(self) -> Metrics:
        """Refresh per-peer gauges/counters in :attr:`metrics`."""
        m = self.metrics
        for pid, st in list(self.peer_stats.items()):
            base = f"transport.{self.node_id}->{pid}"
            m.gauge(f"{base}.queue_frames", st.queue_frames)
            m.gauge(f"{base}.queue_bytes", st.queue_bytes)
            m.gauge(f"{base}.bytes_out", st.bytes_out)
            m.gauge(f"{base}.frames_out", st.frames_out)
            m.gauge(f"{base}.bytes_in", st.bytes_in)
            m.gauge(f"{base}.frames_in", st.frames_in)
            # coalescing efficiency (round 20): msgs/frames per
            # direction is the msgs-per-frame ratio of the MSGB plane
            m.gauge(f"{base}.msgs_out", st.msgs_out)
            m.gauge(f"{base}.msgs_in", st.msgs_in)
            m.gauge(f"{base}.reconnects", st.reconnects)
            m.gauge(f"{base}.frame_errors", st.frame_errors)
            # peer.* misbehavior gauges (round 11): the <- direction
            # marks these as judgements about INBOUND traffic from pid,
            # exported next to the faults.* injector gauges so one
            # Prometheus dump carries both sides of the Byzantine story
            peer = f"peer.{self.node_id}<-{pid}"
            m.gauge(f"{peer}.misbehavior", st.misbehavior)
            m.gauge(f"{peer}.bans", st.bans)
            m.gauge(f"{peer}.ban_rejects", st.ban_rejects)
        return m

    # -- event loop ----------------------------------------------------
    def _run(self) -> None:
        try:
            while True:
                timeout = self._next_timeout()
                for key, events in self._sel.select(timeout):
                    kind, data = key.data
                    if kind == "wake":
                        try:
                            while self._wake_r.recv(RECV_CHUNK):
                                pass
                        except BlockingIOError:
                            pass
                    elif kind == "listen":
                        self._accept()
                    elif kind == "in":
                        if events & selectors.EVENT_READ:
                            self._read_inbound(data)
                        if data.sock is not None and events & selectors.EVENT_WRITE:
                            self._flush_inbound(data)
                    elif kind == "out":
                        self._service_outbound(data, events)
                if self._drain_control():
                    return  # stop requested
                self._fire_timers()
        finally:
            self._teardown()

    def _next_timeout(self) -> Optional[float]:
        if self._control:
            return 0.0
        if not self._timers:
            return 0.5
        return max(0.0, min(0.5, self._timers[0][0] - time.monotonic()))

    def _drain_control(self) -> bool:
        while self._control:
            op, arg = self._control.popleft()
            if op == "stop":
                return True
            if op == "enqueue":
                dest, delay_s, orig, wire = arg
                if delay_s > 0:
                    self._add_timer(delay_s, "enqueue", (dest, orig, wire))
                else:
                    self._enqueue(dest, orig, wire)
            elif op == "enqueue_many":
                # runs of a common dest share one state lookup + one
                # dial/arm decision (the per-frame _enqueue body was a
                # measured slice of the loop thread at native-node rates)
                run_dest: Any = None
                run: List[Tuple[bytes, Optional[bytes]]] = []
                for dest, delay_s, orig, wire in arg:
                    if delay_s > 0:
                        self._add_timer(delay_s, "enqueue", (dest, orig, wire))
                        continue
                    if dest != run_dest and run:
                        self._enqueue_run(run_dest, run)
                        run = []
                    run_dest = dest
                    run.append((orig, wire))
                if run:
                    self._enqueue_run(run_dest, run)
            elif op == "offline":
                self._desired_offline = bool(arg)
                self._go_offline() if arg else self._go_online()
        return False

    def _add_timer(self, delay_s: float, kind: str, arg: Any) -> None:
        heapq.heappush(
            self._timers,
            (time.monotonic() + delay_s, next(self._timer_seq), kind, arg),
        )

    def _fire_timers(self) -> None:
        now = time.monotonic()
        while self._timers and self._timers[0][0] <= now:
            _, _, kind, arg = heapq.heappop(self._timers)
            if kind == "enqueue":
                self._enqueue(*arg)
            elif kind == "dial":
                ob = self._out.get(arg)
                if (
                    ob is not None
                    and ob.state == "idle"
                    and not self.offline
                    and ob.has_pending()
                ):
                    self._dial(arg, ob)
            elif kind == "rebind":
                if self.offline and not self._desired_offline:
                    self._go_online()
            elif kind == "ack":
                conn = arg
                conn.ack_timer = False
                if (
                    conn.sock is not None
                    and conn.peer_id is not None
                    and self._rx_counts[conn.peer_id] > conn.last_ack
                ):
                    self._send_ack(conn)

    # -- outbound ------------------------------------------------------
    def _enqueue_run(
        self, dest: Any, items: List[Tuple[bytes, Optional[bytes]]]
    ) -> None:
        """Queue a run of frames toward one dest: same admission rules
        as :meth:`_enqueue` per frame, but the peer-state lookups, stat
        writes, and the dial/write-arm decision happen once."""
        ob = self._out.get(dest)
        if ob is None:
            self.metrics.count("transport.unknown_dest", len(items))
            return
        st = self.peer_stats[dest]
        pending_frames = ob.pending_frames()
        pending_bytes = ob.pending_bytes()
        overflow = 0
        for orig, wire in items:
            if (
                pending_frames >= self.max_queue_frames
                or pending_bytes + len(orig) > self.max_queue_bytes
            ):
                overflow += 1
                continue
            ob.queue.append((orig, wire))
            ob.queue_bytes += len(orig)
            pending_frames += 1
            pending_bytes += len(orig)
        if overflow:
            st.queue_overflow += overflow
            self.metrics.count("transport.queue_overflow", overflow)
        st.queue_frames = len(ob.queue)
        st.queue_bytes = ob.queue_bytes
        if ob.state == "idle" and not self.offline:
            if time.monotonic() >= ob.next_dial:
                self._dial(dest, ob)
        elif ob.state == "connected":
            # opportunistic flush: the socket is almost always writable,
            # so sending NOW (one syscall for the whole run) beats
            # arming write interest and paying a full select cycle plus
            # a per-peer event dispatch; _flush_outbound re-arms by
            # itself when the kernel buffer pushes back
            self._flush_outbound(dest, ob)

    def _enqueue(self, dest: Any, orig: bytes, wire: Optional[bytes]) -> None:
        ob = self._out.get(dest)
        if ob is None:
            self.metrics.count("transport.unknown_dest")
            return
        st = self.peer_stats[dest]
        # inflight counts toward BOTH caps: the resume layer retains
        # unacked frames, and retention must stay bounded too (a peer
        # that reads but stops ACKing must not grow memory past the cap)
        if (
            ob.pending_frames() >= self.max_queue_frames
            or ob.pending_bytes() + len(orig) > self.max_queue_bytes
        ):
            st.queue_overflow += 1
            self.metrics.count("transport.queue_overflow")
            return
        ob.queue.append((orig, wire))
        ob.queue_bytes += len(orig)
        st.queue_frames = len(ob.queue)
        st.queue_bytes = ob.queue_bytes
        if ob.state == "idle" and not self.offline:
            now = time.monotonic()
            if now >= ob.next_dial:
                self._dial(dest, ob)
            # else: a backoff timer is already pending
        elif ob.state == "connected":
            self._want_write(ob, True)

    def _dial(self, dest: Any, ob: _Outbound) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.peer_stats[dest].dials += 1
        try:
            sock.connect_ex(ob.addr)
        except OSError:
            sock.close()
            self._schedule_redial(dest, ob)
            return
        ob.sock = sock
        ob.state = "connecting"
        ob.want_w = True  # registered with write interest below
        self._sel.register(
            sock, selectors.EVENT_WRITE | selectors.EVENT_READ, ("out", dest)
        )

    def _schedule_redial(self, dest: Any, ob: _Outbound) -> None:
        ob.attempts += 1
        delay = min(
            self.backoff_cap_s, self.backoff_base_s * (2 ** (ob.attempts - 1))
        )
        delay *= 1.0 + self.backoff_jitter * self._rng.random()
        ob.next_dial = time.monotonic() + delay
        self._add_timer(delay, "dial", dest)

    def _service_outbound(self, dest: Any, events: int) -> None:
        ob = self._out.get(dest)
        if ob is None or ob.sock is None:
            return
        st = self.peer_stats[dest]
        if ob.state == "connecting":
            err = ob.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                self._drop_outbound(dest, ob, redial=True)
                return
            ob.state = "connected"
            ob.attempts = 0
            ob.await_ack = True  # resume point comes from the peer's ACK
            ob.decoder = FrameDecoder(self.max_frame_len)
            st.connects += 1
            if st.connects > 1:
                st.reconnects += 1
                self.metrics.count("transport.reconnects")
            self._trace(
                "transport.connect", peer=dest, reconnect=st.connects > 1
            )
            # handshake first, then whatever queued up.  The HELLO gets
            # a pending_write SENTINEL (orig None) so write_prog stays
            # frame-aligned: without it the handshake bytes inflate
            # write_prog for the connection's lifetime and a later
            # partial send() can graduate a frame to inflight while its
            # tail is still in sendbuf.  A sentinel is never retained or
            # retransmitted — each connection regenerates its HELLO.
            hello = encode_hello(
                self.node_id, self.cluster_id, self.max_frame_len
            )
            ob.sendbuf += hello
            ob.pending_write.append((len(hello), None))
        if events & selectors.EVENT_READ and ob.state == "connected":
            # the reverse direction carries only cumulative ACKs
            try:
                got = ob.sock.recv(RECV_CHUNK)
            except BlockingIOError:
                got = None  # spurious readable wakeup: NOT an EOF
            except OSError:
                got = b""
            if got == b"":
                self._drop_outbound(dest, ob, redial=True)
                return
            try:
                ob.decoder.feed(got or b"")
                for kind, payload in ob.decoder.frames():
                    if kind != KIND_ACK:
                        raise FrameError("only ACK frames flow dialer-ward")
                    self._handle_ack(dest, ob, decode_ack(payload))
            except FrameError:
                self.metrics.count("transport.frame_errors")
                st.frame_errors += 1
                self._drop_outbound(dest, ob, redial=True)
                return
        self._flush_outbound(dest, ob)

    def _handle_ack(self, dest: Any, ob: _Outbound, n: int) -> None:
        """Apply a cumulative consumed-count from the acceptor."""
        while ob.inflight and ob.acked < n:
            ob.inflight_bytes -= len(ob.inflight.popleft())
            ob.acked += 1
        if n < ob.acked:
            # peer lost its counter (process restart): adopt its origin;
            # we can only replay what we still hold
            ob.acked = n
        elif n > ob.acked:
            # WE lost our counter (our restart, their surviving count):
            # resync so future ACKs pop exactly the frames they cover —
            # leaving acked behind would make `acked < n` drain frames
            # the peer never consumed
            ob.acked = n
        if ob.await_ack:
            ob.await_ack = False
            # retransmit the unacked tail ahead of new traffic (originals
            # only — any corruption belonged to the dead connection)
            if ob.inflight:
                retrans = [(data, None) for data in ob.inflight]
                ob.inflight.clear()
                ob.inflight_bytes = 0
                ob.queue.extendleft(reversed(retrans))
                ob.queue_bytes += sum(len(d) for d, _ in retrans)

    def _flush_outbound(self, dest: Any, ob: _Outbound) -> None:
        if ob.state != "connected" or ob.sock is None:
            return
        if self.vectored:
            self._flush_outbound_vectored(dest, ob)
            return
        st = self.peer_stats[dest]
        while ob.sendbuf or (ob.queue and not ob.await_ack):
            # Pack a burst of frames into the write buffer before the
            # syscall (SEND_COALESCE): one send() per frame was the
            # measured socket-plane bound once decode moved native.
            while (
                ob.queue
                and not ob.await_ack
                and len(ob.sendbuf) < SEND_COALESCE
            ):
                orig, wire = ob.queue.popleft()
                ob.queue_bytes -= len(orig)
                data = wire if wire is not None else orig
                ob.sendbuf += data
                ob.pending_write.append((len(data), orig))
                ob.pending_write_bytes += len(orig)
                st.frames_out += 1
                # msgs carried (1 per MSG, batch count per MSGB) read
                # straight off the clean frame bytes: no extra state
                # threads through queue/inflight/retransmit tuples, and
                # retransmits recount exactly like frames_out does
                st.msgs_out += frame_message_count(orig)
            try:
                n = ob.sock.send(ob.sendbuf)
            except BlockingIOError:
                break
            except OSError:
                self._drop_outbound(dest, ob, redial=True)
                return
            if n == 0:
                break
            st.bytes_out += n
            del ob.sendbuf[:n]
            # graduate fully-written frames to the unacked retention
            ob.write_prog += n
            while ob.pending_write and ob.write_prog >= ob.pending_write[0][0]:
                wire_len, orig = ob.pending_write.popleft()
                ob.write_prog -= wire_len
                if orig is None:  # handshake sentinel: nothing to retain
                    continue
                ob.pending_write_bytes -= len(orig)
                ob.inflight.append(orig)
                ob.inflight_bytes += len(orig)
        st.queue_frames = len(ob.queue)
        st.queue_bytes = ob.queue_bytes
        self._want_write(ob, bool(ob.sendbuf or (ob.queue and not ob.await_ack)))

    def _flush_outbound_vectored(self, dest: Any, ob: _Outbound) -> None:
        """sendmsg gather egress: frames go on the wire straight from
        the queue's bytes objects — no per-frame copy into ``sendbuf``.

        Accounting is IDENTICAL to the buffered path: each gathered
        frame appends ``(wire_len, orig)`` to ``pending_write`` before
        the syscall, ``write_prog`` counts accepted bytes, and the
        graduate loop promotes fully-covered frames to ``inflight``.
        The one structural difference is where unsent bytes live: the
        kernel accepting a PARTIAL gather leaves the tail with no
        backing buffer, so the remainder is copied into ``sendbuf`` and
        the next flush (still this method) drains ``sendbuf`` first —
        the copy only happens on kernel pushback, where the buffered
        path would have paid it up front on every frame.
        """
        st = self.peer_stats[dest]
        while ob.sendbuf or (ob.queue and not ob.await_ack):
            bufs: List[Any] = []
            total = 0
            if ob.sendbuf:
                bufs.append(ob.sendbuf)
                total = len(ob.sendbuf)
            while (
                ob.queue
                and not ob.await_ack
                and total < SEND_COALESCE
                and len(bufs) < SENDMSG_MAX_BUFS
            ):
                orig, wire = ob.queue.popleft()
                ob.queue_bytes -= len(orig)
                data = wire if wire is not None else orig
                bufs.append(data)
                total += len(data)
                ob.pending_write.append((len(data), orig))
                ob.pending_write_bytes += len(orig)
                st.frames_out += 1
                st.msgs_out += frame_message_count(orig)
            try:
                n = ob.sock.sendmsg(bufs)
            except BlockingIOError:
                n = 0
            except OSError:
                self._drop_outbound(dest, ob, redial=True)
                return
            if n:
                st.bytes_out += n
                ob.write_prog += n
                while (
                    ob.pending_write
                    and ob.write_prog >= ob.pending_write[0][0]
                ):
                    wire_len, orig = ob.pending_write.popleft()
                    ob.write_prog -= wire_len
                    if orig is None:  # handshake sentinel
                        continue
                    ob.pending_write_bytes -= len(orig)
                    ob.inflight.append(orig)
                    ob.inflight_bytes += len(orig)
            if n < total:
                # Kernel pushback: retain the unsent tail in sendbuf so
                # the resume accounting sees exactly the bytes a
                # buffered flush would still be holding, then stop and
                # arm write interest.
                rem = n
                tail = bytearray()
                for b in bufs:
                    if rem >= len(b):
                        rem -= len(b)
                        continue
                    tail += memoryview(b)[rem:]
                    rem = 0
                ob.sendbuf = tail
                break
            ob.sendbuf = bytearray()
        st.queue_frames = len(ob.queue)
        st.queue_bytes = ob.queue_bytes
        self._want_write(ob, bool(ob.sendbuf or (ob.queue and not ob.await_ack)))

    def _want_write(self, ob: _Outbound, want: bool) -> None:
        if ob.sock is None or ob.state != "connected":
            return
        if ob.want_w == want:
            return  # already armed as requested: skip the epoll_ctl
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if want else 0)
        try:
            self._sel.modify(ob.sock, events, self._sel.get_key(ob.sock).data)
        except (KeyError, ValueError):
            return
        ob.want_w = want

    def _trace(self, name: str, **args: Any) -> None:
        t = self.tracer
        if t is not None:
            t.emit(name, **args)

    def _drop_outbound(self, dest: Any, ob: _Outbound, redial: bool) -> None:
        if ob.sock is not None:
            try:
                self._sel.unregister(ob.sock)
            except (KeyError, ValueError):
                pass
            ob.sock.close()
            ob.sock = None
        if ob.state == "connected":
            self._trace("transport.disconnect", peer=dest)
        ob.state = "idle"
        ob.decoder = None
        ob.await_ack = False
        ob.want_w = False
        # partially-written frames die with their connection (the wire
        # remainder would desync the peer), but their ORIGINALS go back
        # to the queue head in order — the peer never consumed them
        ob.sendbuf.clear()
        if ob.pending_write:
            retrans = [
                (orig, None) for _, orig in ob.pending_write if orig is not None
            ]
            ob.pending_write.clear()
            ob.pending_write_bytes = 0
            ob.queue.extendleft(reversed(retrans))
            ob.queue_bytes += sum(len(o) for o, _ in retrans)
        ob.write_prog = 0
        if redial and not self.offline and ob.has_pending():
            self._schedule_redial(dest, ob)

    # -- inbound -------------------------------------------------------
    def _accept(self) -> None:
        if self._listener is None:
            return
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            # bound accepted-connection state: each connection can buffer
            # up to max_frame_len before any frame completes, so an
            # unbounded accept loop is an easy local memory DoS
            if len(self._inbound) >= self.max_inbound:
                self.metrics.count("transport.accept_overflow")
                sock.close()
                continue
            sock.setblocking(False)
            conn = _Inbound(sock, self.max_frame_len)
            self._inbound.append(conn)
            self._sel.register(sock, selectors.EVENT_READ, ("in", conn))

    def _read_inbound(self, conn: _Inbound) -> None:
        if conn.sock is None:
            return
        try:
            data = conn.sock.recv(RECV_CHUNK)
        except BlockingIOError:
            return
        except OSError:
            data = b""
        if data == b"":
            self._close_inbound(conn)
            return
        if conn.peer_id is not None:
            self.peer_stats[conn.peer_id].bytes_in += len(data)
        consumed_before = (
            self._rx_counts[conn.peer_id] if conn.peer_id is not None else 0
        )
        try:
            conn.decoder.feed(data)
            burst: List[bytes] = []
            burst_frames: List[int] = []  # msgs per batched frame, in order
            wire_burst: List[Tuple[int, bytes]] = []
            batching = self.on_batch is not None or self.on_wire_batch is not None
            # Parse + dispatch one frame at a time (NOT decoder.frames(),
            # which would collect the whole burst before any dispatch):
            # a violation mid-burst must not void the frames before it —
            # in particular, a HELLO followed by a corrupt frame in the
            # SAME recv must identify the peer first, so the violation
            # is charged to its misbehavior account (round 11) instead
            # of dying anonymously.
            while True:
                frame = conn.decoder.next_frame()
                if frame is None:
                    break
                kind, payload = frame
                if (
                    batching
                    and conn.peer_id is not None
                    and kind in (KIND_MSG, KIND_MSGB)
                ):
                    # Batch path: queue the read burst's MSG/MSGB frames
                    # for ONE consumer call.  MSGB bodies are grammar-
                    # checked HERE (validate_msgb raises FrameError →
                    # the uniform drop/strike/ban response, identical on
                    # both node impls) but only the wire path skips the
                    # slicing.  Kind violations in the same burst still
                    # raise below; frames batched before the violation
                    # are simply never consumed or acked (the resume
                    # layer covers them).
                    nmsg = 0 if kind == KIND_MSG else validate_msgb(payload)
                    if self.on_wire_batch is not None:
                        wire_burst.append((nmsg, payload))
                    elif kind == KIND_MSG:
                        burst.append(payload)
                        burst_frames.append(1)
                    else:
                        burst.extend(decode_msgb(payload))
                        burst_frames.append(nmsg)
                    continue
                self._handle_frame(conn, kind, payload)
            if wire_burst:
                self._dispatch_wire_burst(conn, wire_burst)
            elif burst:
                self._dispatch_burst(conn, burst, burst_frames)
        except FrameError as exc:
            if isinstance(exc, _BanReject):
                # The defense firing, not a framing violation: counted
                # as ban_rejects at the raise site, never frame_errors.
                self._close_inbound(conn)
                return
            self.metrics.count("transport.frame_errors")
            if conn.peer_id is not None:
                self.peer_stats[conn.peer_id].frame_errors += 1
                # A violation on an IDENTIFIED connection is this
                # peer's misbehavior (a pre-HELLO violation has no one
                # to charge).  Channel corruption is indistinguishable
                # from Byzantine framing here by design — the ban is
                # short either way, and resume keeps honest peers
                # lossless across it.
                self._note_misbehavior(conn.peer_id)
            self._close_inbound(conn)
            return
        except _ConsumerOverload:
            # receive-side backpressure: the consumer queue is full, so
            # stop consuming at a prefix point; the peer's reconnect +
            # retransmit (paced by dial backoff) delivers the rest later
            self.metrics.count("transport.consumer_overflow")
            self._close_inbound(conn)
            return
        # coalesced cumulative ACK: immediate past ACK_EVERY unacked
        # frames, else one short timer batches bursts into one ACK
        if (
            conn.peer_id is not None
            and self._rx_counts[conn.peer_id] != consumed_before
        ):
            self._maybe_ack(conn)

    def _maybe_ack(self, conn: _Inbound) -> None:
        unacked = self._rx_counts[conn.peer_id] - conn.last_ack
        if unacked >= ACK_EVERY:
            self._send_ack(conn)
        elif unacked > 0 and not conn.ack_timer:
            conn.ack_timer = True
            self._add_timer(ACK_DELAY_S, "ack", conn)

    # -- misbehavior accounting (round 11) -----------------------------
    def _banned(self, pid: Any) -> bool:
        b = self._bans.get(pid)
        return b is not None and time.monotonic() < b.until

    def _note_misbehavior(self, pid: Any) -> None:
        """Charge one protocol-violation strike to ``pid``; every
        ``ban_threshold`` strikes issue an escalating reconnect ban
        (:func:`ban_duration` — deterministic, no jitter)."""
        st = self.peer_stats[pid]
        st.misbehavior += 1
        self.metrics.count("transport.peer_misbehavior")
        if self.ban_threshold <= 0:
            return
        b = self._bans.setdefault(pid, _BanState())
        b.strikes += 1
        if b.strikes >= self.ban_threshold:
            b.strikes = 0
            dur = ban_duration(b.bans, self.ban_base_s, self.ban_cap_s)
            b.bans += 1
            b.until = time.monotonic() + dur
            st.bans = b.bans
            self.metrics.count("transport.peer_bans")
            self._trace(
                "transport.ban", peer=pid, offense=b.bans, duration_s=dur
            )

    def _send_ack(self, conn: _Inbound) -> None:
        count = self._rx_counts[conn.peer_id]
        conn.last_ack = count
        conn.sendbuf += encode_ack(count)
        self._flush_inbound(conn)

    def _handle_frame(self, conn: _Inbound, kind: int, payload: bytes) -> None:
        if conn.peer_id is None:
            if kind != KIND_HELLO:
                raise FrameError("first frame must be HELLO")
            announced = decode_hello(payload, self.cluster_id)
            if announced not in self._out and not self.accept_unknown_peers:
                raise FrameError(f"HELLO from unconfigured peer {announced!r}")
            if self._banned(announced):
                # Escalating reconnect ban: the peer's recent frame
                # violations crossed ban_threshold, so its reconnects
                # are refused until the ban lapses — the corrupt-frame/
                # reconnect loop is no longer free.  A ban reject is
                # NOT itself a strike (it would self-extend forever).
                self.peer_stats[announced].ban_rejects += 1
                self.metrics.count("transport.ban_rejects")
                raise _BanReject(f"HELLO from banned peer {announced!r}")
            # A fresh HELLO supersedes any stale connection from the same
            # peer: close it WITHOUT consuming its buffered frames.  The
            # cumulative count is shared per peer id — draining a dead
            # connection after ACKing the new one would double-count
            # frames the dialer retransmits (it treats them as unacked),
            # over-acknowledging and breaking the lossless-resume
            # guarantee.  Unconsumed frames are covered by retransmit.
            for stale in list(self._inbound):
                if stale is not conn and stale.peer_id == announced:
                    self._close_inbound(stale)
            conn.peer_id = announced
            self.peer_stats[conn.peer_id].accepts += 1
            self.metrics.count("transport.accepts")
            # initial ACK = the dialer's resume point (always immediate:
            # MSG writes are gated on it)
            self._send_ack(conn)
            return
        if kind == KIND_HELLO:
            raise FrameError("duplicate HELLO")
        if kind == KIND_ACK:
            raise FrameError("ACK frames only flow acceptor->dialer")
        st = self.peer_stats[conn.peer_id]
        st.frames_in += 1
        if kind == KIND_MSGB:
            # Per-frame consumer path for a batch frame: unpack (grammar
            # violations raise FrameError — uniform strike/ban response)
            # and feed each message through on_message; the ack unit
            # stays the FRAME, granted only once every message was
            # offered.  An overload mid-frame leaves the whole frame
            # unacked (batch-atomic) — the in-repo burst consumers are
            # all-or-nothing, and protocol dedup covers re-delivery.
            msgs = decode_msgb(payload)
            st.msgs_in += len(msgs)
            if self.on_message is not None:
                for p in msgs:
                    try:
                        res = self.on_message(conn.peer_id, p)
                    except Exception:
                        self.metrics.count("transport.on_message_errors")
                        res = None
                    if res is False:
                        raise _ConsumerOverload()
            self._rx_counts[conn.peer_id] += 1
            return
        st.msgs_in += 1
        if self.on_message is not None:
            try:
                res = self.on_message(conn.peer_id, payload)
            except Exception:
                # the consumer's problem must not kill the socket plane;
                # a poison frame is counted and acked (never retransmit
                # what deterministically explodes)
                self.metrics.count("transport.on_message_errors")
                res = None
            if res is False:
                raise _ConsumerOverload()
        # consumed == handed to the node's inbox; the frame now survives
        # a disconnect on our side, so it is safe to acknowledge
        self._rx_counts[conn.peer_id] += 1

    def _dispatch_burst(
        self, conn: _Inbound, burst: List[bytes], frame_counts: List[int]
    ) -> None:
        """Hand one read burst's MSG/MSGB messages to ``on_batch``; ack
        exactly the fully-consumed FRAME prefix (the cumulative count
        stays frame-aligned).  ``frame_counts`` maps the flat message
        list back to frames; a frame whose messages were only partially
        consumed is NOT acked — batch-atomic consumption.  (The in-repo
        consumers are all-or-nothing whole-burst inbox puts, so a
        partial prefix only ever re-delivers whole frames on resume;
        protocol-level dedup covers the theoretical partial case.)"""
        st = self.peer_stats[conn.peer_id]
        st.frames_in += len(frame_counts)
        st.msgs_in += len(burst)
        try:
            consumed = self.on_batch(conn.peer_id, burst)
        except Exception:
            # same stance as the per-frame path: a consumer bug must not
            # kill the socket plane, and deterministic poison must never
            # be retransmitted — count, ack the burst, move on
            self.metrics.count("transport.on_message_errors")
            consumed = len(burst)
        consumed = max(0, min(int(consumed), len(burst)))
        frames_done = 0
        covered = 0
        for c in frame_counts:
            if covered + c > consumed:
                break
            covered += c
            frames_done += 1
        self._rx_counts[conn.peer_id] += frames_done
        if consumed < len(burst):
            raise _ConsumerOverload()

    def _dispatch_wire_burst(
        self, conn: _Inbound, records: List[Tuple[int, bytes]]
    ) -> None:
        """Hand one read burst's frames to ``on_wire_batch`` in wire
        form — ``(nmsg, data)`` per frame, nmsg == 0 a plain MSG
        payload, nmsg >= 1 a validated raw MSGB body.  The return value
        counts FRAMES consumed (all-or-nothing per frame by contract),
        which is exactly the ack unit."""
        st = self.peer_stats[conn.peer_id]
        st.frames_in += len(records)
        st.msgs_in += sum(n if n else 1 for n, _ in records)
        try:
            consumed = self.on_wire_batch(conn.peer_id, records)
        except Exception:
            self.metrics.count("transport.on_message_errors")
            consumed = len(records)
        consumed = max(0, min(int(consumed), len(records)))
        self._rx_counts[conn.peer_id] += consumed
        if consumed < len(records):
            raise _ConsumerOverload()

    def _flush_inbound(self, conn: _Inbound) -> None:
        if conn.sock is None:
            return
        try:
            while conn.sendbuf:
                n = conn.sock.send(conn.sendbuf)
                if n == 0:
                    break
                del conn.sendbuf[:n]
        except BlockingIOError:
            pass
        except OSError:
            self._close_inbound(conn)
            return
        want = bool(conn.sendbuf)
        if want == conn.want_w:
            return  # interest unchanged: skip the epoll_ctl
        events = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if want else 0
        )
        try:
            self._sel.modify(conn.sock, events, ("in", conn))
        except (KeyError, ValueError):
            return
        conn.want_w = want

    def _close_inbound(self, conn: _Inbound) -> None:
        if conn.sock is None:
            return
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conn.sock.close()
        conn.sock = None
        if conn in self._inbound:
            self._inbound.remove(conn)

    # -- offline / teardown --------------------------------------------
    def _go_offline(self) -> None:
        if self.offline:
            return
        self.offline = True
        if self._listener is not None:
            try:
                self._sel.unregister(self._listener)
            except (KeyError, ValueError):
                pass
            self._listener.close()
            self._listener = None
        for conn in list(self._inbound):
            self._close_inbound(conn)
        for dest, ob in self._out.items():
            if ob.sock is not None:
                self._drop_outbound(dest, ob, redial=False)
            ob.attempts = 0
            ob.next_dial = 0.0

    def _go_online(self) -> None:
        if not self.offline:
            return
        try:
            self._bind(self._host, self._port)
        except OSError:
            # the freed port can be transiently taken (another process
            # raced it, or lingering TIME_WAIT states on some stacks);
            # stay offline and retry — an escaped exception here would
            # silently kill the whole selector thread
            self.metrics.count("transport.rebind_errors")
            self._add_timer(0.5, "rebind", None)
            return
        self.offline = False
        for dest, ob in self._out.items():
            if ob.has_pending():  # queued OR unacked-inflight frames
                self._dial(dest, ob)

    def _teardown(self) -> None:
        self._stopping = True
        for conn in list(self._inbound):
            self._close_inbound(conn)
        for dest, ob in self._out.items():
            if ob.sock is not None:
                self._drop_outbound(dest, ob, redial=False)
        if self._listener is not None:
            try:
                self._sel.unregister(self._listener)
            except (KeyError, ValueError):
                pass
            self._listener.close()
            self._listener = None
        self._wake_r.close()
        self._wake_w.close()
        self._sel.close()
