"""The port's socket transport (``hbbft_tpu_torch.transport``) against the
reference's bytes and behaviour.

* Frame identity: ``encode_frame``, HELLO, ACK and MSGB frames of the port
  are the reference's bytes; ``FrameDecoder`` splits the same seeded chunk
  stream (mixed frame kinds, random cut points, a corrupted tail) into the
  same frames and fails at the same frame with the same error.
* ``ban_duration`` is the reference's escalation.
* Two ``TcpTransport`` s on localhost: every message arrives in order and
  the dialer's frames are all acknowledged; the MSGB coalescing carries a
  burst in fewer frames than messages.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

from hbbft_tpu.transport import framing as ref_framing
from hbbft_tpu.transport import transport as ref_transport
from hbbft_tpu_torch.transport import framing
from hbbft_tpu_torch.transport import transport
from hbbft_tpu_torch.transport.transport import TcpTransport, ban_duration
from hbbft_tpu_torch.utils.metrics import Metrics

CONSTANTS = ("MAX_FRAME_LEN", "RECV_CHUNK", "PROTO_VERSION", "KIND_HELLO", "KIND_MSG",
             "KIND_ACK", "KIND_MSGB", "KIND_CRYPTO_HELLO", "KIND_CRYPTO_REQ",
             "KIND_CRYPTO_RESP", "CRYPTO_KINDS")


@pytest.mark.parametrize("name", CONSTANTS)
def test_framing_constants_are_the_reference(name):
    assert getattr(framing, name) == getattr(ref_framing, name)


def _payloads(seed: int, n: int):
    rng = random.Random(seed)
    return [bytes(rng.getrandbits(8) for _ in range(rng.choice((0, 1, 7, 100, 3000))))
            for _ in range(n)]


def _frames(mod, seed: int):
    """A seeded mix of every consensus-plane frame kind, built by ``mod``."""
    ps = _payloads(seed, 12)
    out = [mod.encode_hello(3, b"hbbft-tpu/cluster/v1"), mod.encode_ack(41)]
    out += [mod.encode_frame(mod.KIND_MSG, p) for p in ps[:6]]
    out += [mod.encode_msgb(ps[6:9]), mod.encode_msgb(ps[9:])]
    out.append(mod.encode_frame(mod.KIND_CRYPTO_REQ, ps[0], kinds=mod.CRYPTO_KINDS))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_are_the_reference_bytes(seed):
    ours, theirs = _frames(framing, seed), _frames(ref_framing, seed)
    assert ours == theirs
    ps = _payloads(seed, 5)
    assert framing.msgb_body(ps) == ref_framing.msgb_body(ps)
    body = framing.msgb_body(ps)
    assert framing.decode_msgb(body) == ref_framing.decode_msgb(body) == ps
    for f in ours:
        assert framing.frame_message_count(f) == ref_framing.frame_message_count(f)
    assert framing.decode_hello(ours[0][9:], b"hbbft-tpu/cluster/v1") == 3


def _split(decoder_cls, error_cls, stream: bytes, cuts, kinds):
    dec = decoder_cls(kinds=kinds) if kinds else decoder_cls()
    got, err = [], None
    prev = 0
    for c in list(cuts) + [len(stream)]:
        try:
            dec.feed(stream[prev:c])
            got.extend(dec.frames())
        except error_cls as exc:
            err = (len(got), str(exc))
            break
        prev = c
    return got, err, (dec.buffered() if err is None else None)


@pytest.mark.parametrize("seed", range(4))
def test_decoder_splits_chunks_as_the_reference(seed):
    rng = random.Random(100 + seed)
    stream = b"".join(_frames(framing, seed)[:-1])
    if seed % 2:  # flip one byte past the middle: a CRC or length error
        pos = rng.randrange(len(stream) // 2, len(stream))
        stream = stream[:pos] + bytes([stream[pos] ^ 0x40]) + stream[pos + 1:]
    cuts = sorted(rng.sample(range(1, len(stream)), 25))
    ours = _split(framing.FrameDecoder, framing.FrameError, stream, cuts, None)
    theirs = _split(ref_framing.FrameDecoder, ref_framing.FrameError, stream, cuts, None)
    assert ours == theirs
    if seed % 2 == 0:
        assert ours[1] is None and len(ours[0]) == 10
    # the crypto plane's kind set refuses consensus frames alike
    ours = _split(framing.FrameDecoder, framing.FrameError, stream, cuts, framing.CRYPTO_KINDS)
    theirs = _split(ref_framing.FrameDecoder, ref_framing.FrameError, stream, cuts,
                    ref_framing.CRYPTO_KINDS)
    assert ours == theirs and ours[1] is not None


def test_ban_duration_is_the_reference_escalation():
    for base, cap in ((0.25, 2.0), (0.01, 60.0), (1.0, 1e9)):
        for offense in (0, 1, 2, 5, 30, 64, 65, 1023, 1024, 5000):
            assert ban_duration(offense, base, cap) == ref_transport.ban_duration(
                offense, base, cap)
    assert transport.ACK_EVERY == ref_transport.ACK_EVERY
    assert transport.SEND_COALESCE == ref_transport.SEND_COALESCE


def _until(cond, timeout_s: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("coalesce", [True, False])
def test_two_transports_exchange_and_acknowledge(coalesce):
    got = {"a": [], "b": []}
    lock = threading.Lock()

    def sink(name):
        def on_batch(sender, payloads):
            with lock:
                got[name].extend((sender, p) for p in payloads)
            return len(payloads)
        return on_batch

    cid = b"hbbft-tpu/cluster/v1"
    a = TcpTransport(node_id=0, cluster_id=cid, metrics=Metrics(), coalesce=coalesce,
                     on_batch=sink("a"))
    b = TcpTransport(node_id=1, cluster_id=cid, metrics=Metrics(), coalesce=coalesce,
                     on_batch=sink("b"))
    a.set_peers({1: b.addr})
    b.set_peers({0: a.addr})
    a.start()
    b.start()
    try:
        to_b = _payloads(7, 200)
        to_a = _payloads(8, 50)
        for k in range(0, 200, 20):  # bursts of 20 messages
            a.send_many([(1, p) for p in to_b[k:k + 20]])
        for p in to_a:
            b.send(0, p)
        assert _until(lambda: len(got["b"]) == 200 and len(got["a"]) == 50), \
            (len(got["b"]), len(got["a"]))
        assert got["b"] == [(0, p) for p in to_b]  # in order, from node 0
        assert got["a"] == [(1, p) for p in to_a]
        # every frame the dialers wrote is covered by the peer's ACK
        assert _until(lambda: a._out[1].acked == a.stats()[1]["frames_out"]
                      and b._out[0].acked == b.stats()[0]["frames_out"]
                      and not a._out[1].has_pending() and not b._out[0].has_pending())
        sa, sb = a.stats()[1], b.stats()[0]
        assert sa["msgs_out"] == 200 and sb["msgs_in"] == 200
        assert sb["msgs_out"] == 50 and sa["msgs_in"] == 50
        if coalesce:
            assert sa["frames_out"] < 200  # bursts rode MSGB frames
        else:
            assert sa["frames_out"] == 200
        assert sa["frame_errors"] == sb["frame_errors"] == 0
    finally:
        a.stop()
        b.stop()
