"""Length-prefixed frames over the serde codec: the TCP trust boundary.

A peer socket delivers an untrusted byte stream.  This module slices it
into bounded frames before any of those bytes reach object construction:

    frame   := len:u32  crc:u32  kind:u8  payload[len-1]

``len`` counts the kind byte plus the payload and is hard-capped by
``max_frame_len`` — a declared length past the cap is rejected from the
4-byte prefix alone, so a malicious peer can never make a node buffer
(let alone parse) an unbounded message.  The cap is deliberately far
below serde's own 256 MiB per-field bound (``serde._MAX_LEN``, enforced
byte-identically by the C token scanner ``hbe_serde_scan``): serde
bounds any *one* length field, the frame cap bounds the *whole* message
— both limits apply on the read path, framing first.

``crc`` is CRC32 over ``kind || payload``.  It is NOT an integrity MAC
(a Byzantine peer computes valid CRCs for garbage); it pins down
*channel* corruption — without it, a bit flip inside the payload could
still frame-parse (or, worse, a flipped length prefix could re-frame
the remainder into bogus frames that get consumed and ACKed, desyncing
the resume layer's cumulative count and silently discarding a clean
frame).  With the CRC, any flipped transmission dies at the framing
layer: connection dropped un-ACKed, and the resume layer retransmits
the CLEAN original — which is exactly the channel-fault model
:mod:`hbbft_tpu_torch.transport.faults` injects.

Frame kinds:

* ``KIND_HELLO`` — connection handshake.  Payload is the serde encoding
  of ``(PROTO_VERSION, cluster_id, node_id)``; the acceptor learns who
  is talking and rejects version/cluster mismatches (a node from a
  different cluster config speaks a disjoint session id, so its
  protocol messages must never reach a handler).
* ``KIND_MSG`` — one protocol message; payload is the serde encoding of
  an :class:`~hbbft_tpu_torch.protocols.sender_queue.SqMessage` tree, decoded
  with the cluster's suite pin.
* ``KIND_ACK`` — cumulative delivery acknowledgement, payload a fixed
  8-byte big-endian count of MSG/MSGB frames the acceptor has consumed
  on this link *ever* (across reconnects).  Flows acceptor -> dialer on
  the otherwise-unused reverse direction of a connection; the dialer
  retains unacked frames and retransmits them after a reconnect, which
  is what makes a mid-epoch disconnect lossless for a surviving process
  (transport.py "resume layer").
* ``KIND_MSGB`` — one frame carrying a BATCH of protocol messages for
  the same destination (round 20 coalescing: the per-message frame
  header, CRC, ACK-accounting, and Python dispatch costs were the
  measured message-plane bound once decode moved native).  The body
  grammar is :func:`msgb_body`; the ACK unit stays the FRAME, consumed
  batch-atomically — a receiver never acknowledges an MSGB it only
  partially consumed, so the resume layer's cumulative count is
  unchanged.  Every decoder accepts MSGB whatever the sender's
  ``coalesce`` setting (accept-both interop: it gates EMISSION only,
  so mixed clusters never desync).

Decode errors raise :class:`FrameError`; the transport's uniform
response is: count the fault in metrics, drop the connection (the
stream is unsynchronized garbage from that point), and let reconnect
establish a fresh one (tests/test_transport.py pins this never crashes
a node).

Copy of ``hbbft_tpu/transport/framing.py``: the same bytes on the wire
(tests/test_torch_transport.py), so nodes of both packages can share a
cluster id and a frame grammar.
"""

from __future__ import annotations

import zlib
from typing import Any, List, Optional, Tuple

from hbbft_tpu_torch.utils import serde

#: Default whole-frame cap (16 MiB).  An N=1024 DKG-era contribution is
#: ~1 MB; nothing the current stack emits approaches this.  Configurable
#: per transport, but every read path MUST enforce *some* cap (lint rule
#: HBT006 pins the recv plumbing).
MAX_FRAME_LEN = 1 << 24

#: Bounded socket read size.  recv() callers use this constant so a
#: single syscall can never hand us more than 64 KiB to buffer before
#: the frame-length check applies (HBT006).
RECV_CHUNK = 1 << 16

PROTO_VERSION = 1

KIND_HELLO = 0x01
KIND_MSG = 0x02
KIND_ACK = 0x03
KIND_MSGB = 0x04

_KINDS = (KIND_HELLO, KIND_MSG, KIND_ACK, KIND_MSGB)

#: Crypto-plane RPC kinds (hbbft_tpu_torch.cryptoplane.proc_service).  They
#: share the frame grammar (same length/CRC slicing, same caps) but are
#: a DISJOINT kind set passed explicitly via ``kinds=`` — the consensus
#: transport keeps rejecting them, so a crypto-service socket
#: accidentally pointed at a node port (or vice versa) dies at the
#: framing layer instead of smuggling frames across trust boundaries.
KIND_CRYPTO_HELLO = 0x21
KIND_CRYPTO_REQ = 0x22
KIND_CRYPTO_RESP = 0x23

CRYPTO_KINDS = (KIND_CRYPTO_HELLO, KIND_CRYPTO_REQ, KIND_CRYPTO_RESP)


def encode_ack(count: int) -> bytes:
    """Cumulative-consumed ACK frame (fixed 17 bytes on the wire)."""
    return encode_frame(KIND_ACK, count.to_bytes(8, "big"))


def decode_ack(payload: bytes) -> int:
    if len(payload) != 8:
        raise FrameError("ACK payload must be 8 bytes")
    return int.from_bytes(payload, "big")


# MSGB body grammar (csrc/native/engine.cpp emits and consumes the
# identical layout in hbe_node_egress_drain_msgb / hbe_node_ingest_wire):
#
#     body := count:u32  ( len:u32  bytes[len] ) * count
#
# Both u32 fields are big-endian like the frame header.  The element
# lengths must sum EXACTLY to the body: trailing bytes, a short
# element, or count == 0 are FrameErrors — a Byzantine batch never
# partially parses, so the frame-unit ACK can treat MSGB consumption as
# all-or-nothing.  A bogus count dies on arithmetic alone (each element
# needs at least its 4-byte length header) before any walking.

_MSGB_COUNT_BYTES = 4
_MSGB_LEN_BYTES = 4


def msgb_body(payloads: List[bytes]) -> bytes:
    """The MSGB body carrying ``payloads`` in order (trusted input: our
    own egress path; peers go through :func:`validate_msgb`)."""
    parts = [len(payloads).to_bytes(_MSGB_COUNT_BYTES, "big")]
    for p in payloads:
        parts.append(len(p).to_bytes(_MSGB_LEN_BYTES, "big"))
        parts.append(p)
    return b"".join(parts)


def encode_msgb(
    payloads: List[bytes], max_frame_len: int = MAX_FRAME_LEN
) -> bytes:
    """One MSGB frame carrying ``payloads`` in order."""
    return encode_frame(KIND_MSGB, msgb_body(payloads), max_frame_len)


def validate_msgb(body: bytes) -> int:
    """Bounds-check an MSGB body without slicing any element; returns
    the message count.  Raises :class:`FrameError` on any grammar
    violation (peer-authored input: never a crash)."""
    n = len(body)
    if n < _MSGB_COUNT_BYTES:
        raise FrameError("MSGB body shorter than its count field")
    count = int.from_bytes(body[:_MSGB_COUNT_BYTES], "big")
    if count < 1:
        raise FrameError("MSGB with zero messages")
    if _MSGB_COUNT_BYTES + _MSGB_LEN_BYTES * count > n:
        raise FrameError(f"MSGB count {count} exceeds body size {n}")
    # Single-accumulator walk (this runs once per MSGB element on the
    # ingress hot path): the final exactness check alone rejects every
    # violation.  An overlong element or truncated header pushes ``off``
    # strictly past ``n`` — a short/empty length slice yields ln parsed
    # from k < 4 bytes, and off + 4 + ln > n whenever off + 4 > n — and
    # once past, off only grows, so it can never land back on n; a
    # trailing-bytes violation leaves off < n.  Loop length is bounded
    # by the count pre-check above (count <= n/4).
    off = _MSGB_COUNT_BYTES
    for _ in range(count):
        off += _MSGB_LEN_BYTES + int.from_bytes(
            body[off : off + _MSGB_LEN_BYTES], "big"
        )
    if off != n:
        raise FrameError("malformed MSGB element layout")
    return count


def decode_msgb(body: bytes) -> List[bytes]:
    """The payload list of an MSGB body (validates first; raises
    :class:`FrameError` on violation)."""
    count = validate_msgb(body)
    out: List[bytes] = []
    off = _MSGB_COUNT_BYTES
    for _ in range(count):
        ln = int.from_bytes(body[off : off + _MSGB_LEN_BYTES], "big")
        off += _MSGB_LEN_BYTES
        out.append(body[off : off + ln])
        off += ln
    return out


def frame_message_count(frame: bytes) -> int:
    """Protocol messages a fully-encoded wire frame carries: 1 for MSG,
    the count field for MSGB, 0 for anything else.  Trusted input (the
    egress path's own encoder output) — no validation."""
    if len(frame) <= _HDR_BYTES:
        return 0
    kind = frame[_HDR_BYTES]
    if kind == KIND_MSG:
        return 1
    if kind == KIND_MSGB:
        start = _HDR_BYTES + 1
        return int.from_bytes(frame[start : start + _MSGB_COUNT_BYTES], "big")
    return 0


_LEN_BYTES = 4
_CRC_BYTES = 4
_HDR_BYTES = _LEN_BYTES + _CRC_BYTES


class FrameError(ValueError):
    """Malformed, oversized, corrupted, or version-mismatched frame."""


def encode_frame(
    kind: int,
    payload: bytes,
    max_frame_len: int = MAX_FRAME_LEN,
    kinds: Tuple[int, ...] = _KINDS,
) -> bytes:
    """One wire frame.  Raises :class:`FrameError` if the frame would
    exceed ``max_frame_len`` (the local cap: never emit what a peer
    honoring the same limits would have to reject).  ``kinds`` is the
    plane's accepted kind set (transport default; the crypto-plane RPC
    passes :data:`CRYPTO_KINDS`)."""
    if kind not in kinds:
        raise FrameError(f"unknown frame kind 0x{kind:02x}")
    length = 1 + len(payload)
    if length > max_frame_len:
        raise FrameError(
            f"frame of {length} bytes exceeds max_frame_len={max_frame_len}"
        )
    body = bytes([kind]) + payload
    return (
        length.to_bytes(_LEN_BYTES, "big")
        + zlib.crc32(body).to_bytes(_CRC_BYTES, "big")
        + body
    )


class FrameDecoder:
    """Incremental frame slicer over an untrusted byte stream.

    ``feed(data)`` buffers; ``next_frame()`` returns ``(kind, payload)``
    or ``None`` when the buffer holds no complete frame.  Any violation
    raises :class:`FrameError` and poisons the decoder (the stream has
    no recoverable sync point) — callers drop the connection.
    """

    __slots__ = ("max_frame_len", "kinds", "_buf", "_pos", "_poisoned")

    def __init__(
        self,
        max_frame_len: int = MAX_FRAME_LEN,
        kinds: Tuple[int, ...] = _KINDS,
    ) -> None:
        self.max_frame_len = max_frame_len
        self.kinds = kinds
        self._buf = bytearray()
        # Consumed-prefix cursor: deleting each frame's bytes off the
        # buffer head (`del buf[:n]`) was quadratic over a large read
        # burst — every frame moved the whole remainder.  The cursor
        # just advances; the consumed prefix is dropped in ONE compaction
        # when parsing stops (no complete frame left), so a burst costs
        # one move total regardless of how many frames it held.
        self._pos = 0
        self._poisoned = False

    def feed(self, data: bytes) -> None:
        if self._poisoned:
            raise FrameError("decoder poisoned by an earlier frame error")
        if self._pos and self._pos == len(self._buf):
            # fully drained: reset instead of growing behind the cursor
            self._buf.clear()
            self._pos = 0
        self._buf += data

    def buffered(self) -> int:
        return len(self._buf) - self._pos

    def _compact(self) -> None:
        if self._pos:
            del self._buf[: self._pos]
            self._pos = 0

    def next_frame(self) -> Optional[Tuple[int, bytes]]:
        if self._poisoned:
            raise FrameError("decoder poisoned by an earlier frame error")
        buf, pos = self._buf, self._pos
        avail = len(buf) - pos
        if avail < _LEN_BYTES:
            self._compact()
            return None
        length = int.from_bytes(buf[pos : pos + _LEN_BYTES], "big")
        if length < 1 or length > self.max_frame_len:
            self._poisoned = True
            raise FrameError(
                f"declared frame length {length} outside [1, {self.max_frame_len}]"
            )
        if avail < _HDR_BYTES + length:
            self._compact()
            return None
        crc = int.from_bytes(buf[pos + _LEN_BYTES : pos + _HDR_BYTES], "big")
        body = bytes(buf[pos + _HDR_BYTES : pos + _HDR_BYTES + length])
        if zlib.crc32(body) != crc:
            self._poisoned = True
            raise FrameError("frame CRC mismatch (channel corruption)")
        kind = body[0]
        if kind not in self.kinds:
            self._poisoned = True
            raise FrameError(f"unknown frame kind 0x{kind:02x}")
        self._pos = pos + _HDR_BYTES + length
        return kind, body[1:]

    def frames(self) -> List[Tuple[int, bytes]]:
        out = []
        while True:
            f = self.next_frame()
            if f is None:
                return out
            out.append(f)


# -- handshake ---------------------------------------------------------------


def encode_hello(
    node_id: Any, cluster_id: bytes, max_frame_len: int = MAX_FRAME_LEN
) -> bytes:
    return encode_frame(
        KIND_HELLO,
        serde.dumps((PROTO_VERSION, cluster_id, node_id)),
        max_frame_len,
    )


def decode_hello(payload: bytes, cluster_id: bytes) -> Any:
    """Validate a HELLO payload; returns the announced node id.

    Raises :class:`FrameError` on malformed serde, version mismatch, or
    foreign cluster id (never a crash: this is peer-authored input).
    """
    obj = serde.try_loads(payload)
    if (
        not isinstance(obj, tuple)
        or len(obj) != 3
        or type(obj[0]) is not int
        or type(obj[1]) is not bytes
    ):
        raise FrameError("malformed HELLO")
    version, cid, node_id = obj
    if version != PROTO_VERSION:
        raise FrameError(f"protocol version {version} != {PROTO_VERSION}")
    if cid != cluster_id:
        raise FrameError("HELLO from a different cluster")
    if type(node_id) not in (int, str, bytes):
        raise FrameError("bad node id in HELLO")
    return node_id
