"""Byzantine strategies: adversary arms that speak the real wire.

Every strategy operates at the WIRE boundary of one cluster node — the
serde-encoded ``SqMessage`` payloads the node hands its (untouched)
:class:`~hbbft_tpu_torch.transport.transport.TcpTransport` — so one strategy
implementation serves both ``node_impl`` arms: the Python node's
per-message ``transport.send`` and the native node's batched
``transport.send_many`` are wrapped identically
(:func:`hbbft_tpu_torch.chaos.nodes.install_byzantine`).  The one exception
is the corrupt-share sender on the NATIVE arm, which reuses the
engine's tamper hooks (``hbe_set_tamper`` / ``hbe_set_tampered``, the
round-7 :class:`~hbbft_tpu_torch.net.adversary.TamperingAdversary` mirror)
so the rewrite happens before the C encoder, exactly like the
in-process tampering runs.

The strategy catalog:

* **crash-stop** — behaves honestly, then falls silent forever at a
  deadline (the weakest Byzantine class; the cluster must not notice
  beyond f-tolerance).
* **equivocate** — splits the peers into two fixed halves and sends
  CONFLICTING protocol messages per half: one gets the honest
  message, the other a :class:`TamperingAdversary`-rewritten variant
  (flipped BVal/Aux, corrupted Echo proofs/roots...).  Safety is the
  target: honest nodes must still commit identical batches.
* **corrupt-share** — wrong-but-well-formed COIN/DECRYPT threshold
  shares (doubled scalars, or doubled points over BLS), the class the
  share-verification plane must detect AND attribute (fault logs name
  the sender).  Over BLS with ``crypto="service"`` these shares reach
  the crypto service, fail its random-linear-combination check and are
  bisected out.
* **stale-replay** — re-sends its own old traffic (earlier epochs);
  peers' epoch gates must drop it without damage.
* **flood** — garbage at two layers: framing-valid serde garbage
  through its own transport (the ``cluster.bad_payload`` path) and
  raw-socket CRC-corrupt frames under its own HELLO identity (the
  ``transport.frame_errors`` -> misbehavior-strike -> escalating-ban
  path).

Determinism: each strategy draws every decision from a
``random.Random`` seeded by ``(cluster seed, node id, strategy name)``
(:class:`StrategyContext`), so a strategy's decision stream is a pure
function of its own egress order.  The chaos plane adds NO new serde
structs or frame kinds — everything it emits is either existing
registered wire traffic or deliberately-invalid bytes.

Thread-safety: a strategy instance belongs to ONE node and is only
ever called from that node's protocol thread.  All mutable state is
created in :meth:`ByzantineStrategy.bind` so a restarted node re-arms
from a clean slate.

Copy of ``hbbft_tpu/chaos/strategies.py``.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import socket
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from hbbft_tpu_torch.net.adversary import TamperingAdversary
from hbbft_tpu_torch.protocols.sender_queue import SqMessage
from hbbft_tpu_torch.transport.framing import KIND_MSG, encode_frame, encode_hello
from hbbft_tpu_torch.utils import serde
from hbbft_tpu_torch.utils.metrics import Metrics

#: Leaf message types whose rewrite yields a *conflicting* (equivocating)
#: variant — the BVAL/Echo family plus the root/proof carriers.
EQUIVOCABLE_KINDS = frozenset(
    {
        "BValMsg", "AuxMsg", "ConfMsg", "TermMsg",
        "ReadyMsg", "EchoHashMsg", "CanDecodeMsg", "ValueMsg", "EchoMsg",
    }
)

#: Leaf message types carrying threshold shares (COIN / DECRYPT).
SHARE_KINDS = frozenset({"SignMessage", "DecryptMessage"})

_VARIANT_CACHE_MAX = 4096


def _cache_put(cache: Dict[Any, Any], key: Any, value: Any) -> None:
    cache[key] = value
    if len(cache) > _VARIANT_CACHE_MAX:
        cache.pop(next(iter(cache)))


def _rewrite(obj: Any, rng: Any, adv: TamperingAdversary,
             kinds: frozenset) -> Any:
    """Recurse into the envelope chain like TamperingAdversary._tamper,
    but rewrite ONLY leaves whose type name is in ``kinds`` (the stock
    adversary rewrites the first leaf of any type it knows)."""
    if type(obj).__name__ in kinds:
        return adv._tamper(obj, rng)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            nv = _rewrite(v, rng, adv, kinds)
            if nv is not v:
                changes[f.name] = nv
        if changes:
            return dataclasses.replace(obj, **changes)
    return obj


def tamper_payload(
    data: bytes, rng: Any, suite: Any, kinds: Iterable[str]
) -> Optional[bytes]:
    """Decode one wire payload, rewrite its innermost protocol content
    with the stock :class:`TamperingAdversary` mutations (restricted to
    leaf types named in ``kinds``), and re-encode.  Returns None when
    the payload is not an SqMessage or carries none of the targeted
    leaves — the variant, when returned, is VALID wire traffic (well-
    formed, wrong contents): the hardest Byzantine class."""
    msg = serde.try_loads(data, suite=suite)
    if not isinstance(msg, SqMessage):
        return None
    adv = TamperingAdversary(tamper_p=1.0)
    out = _rewrite(msg, rng, adv, frozenset(kinds))
    if out is msg:
        return None
    return serde.dumps(out)


@dataclass
class StrategyContext:
    """Everything a strategy may touch, handed over at bind time."""

    node_id: Any
    peer_ids: List[Any]
    peer_addrs: Dict[Any, Tuple[str, int]]
    cluster_id: bytes
    suite: Any
    rng: random.Random
    metrics: Metrics = field(default_factory=Metrics)
    impl: str = "python"


class ByzantineStrategy:
    """Base: an honest node (identity mapping on egress)."""

    name = "byzantine"
    #: True = on the native arm, install the engine tamper hooks
    #: instead of the wire-level wrapper (corrupt-share only).
    native_tamper = False

    def bind(self, ctx: StrategyContext) -> None:
        """(Re)arm against one node instance; all mutable state is
        created here so restart() starts clean."""
        self.ctx = ctx

    def on_egress(
        self, dest: Any, payload: bytes
    ) -> Iterable[Tuple[Any, bytes]]:
        """Map one outgoing ``(dest, payload)`` to the frames actually
        sent (empty = suppressed)."""
        return ((dest, payload),)

    def extra_frames(self) -> Iterable[Tuple[Any, bytes]]:
        """Additional frames to inject this egress sweep (the strategy
        rate-limits itself)."""
        return ()


class CrashStop(ByzantineStrategy):
    """Honest until ``after_s`` past its first emission, then silent
    forever (still receives and ACKs — a zombie, which is the harder
    variant of crash for the peers' resume layers)."""

    name = "crash-stop"

    def __init__(self, after_s: float = 0.75) -> None:
        self.after_s = after_s

    def bind(self, ctx: StrategyContext) -> None:
        super().bind(ctx)
        self._deadline: Optional[float] = None
        self._crashed = False

    def on_egress(self, dest, payload):
        now = time.monotonic()
        if self._deadline is None:
            self._deadline = now + self.after_s
        if now >= self._deadline:
            if not self._crashed:
                self._crashed = True
                self.ctx.metrics.count("chaos.crash_stopped")
            return ()
        return ((dest, payload),)


class Equivocator(ByzantineStrategy):
    """Conflicting messages per peer: a fixed half of the peers gets
    the honest payload, the other half a tampered-but-well-formed
    variant of the SAME logical message.  The variant is computed once
    per distinct payload (a broadcast is one logical message however
    many ``send`` calls carry it)."""

    name = "equivocate"

    def __init__(self, eq_p: float = 1.0) -> None:
        self.eq_p = eq_p

    def bind(self, ctx: StrategyContext) -> None:
        super().bind(ctx)
        ids = list(ctx.peer_ids)
        ctx.rng.shuffle(ids)
        self._flip = frozenset(ids[: max(1, len(ids) // 2)])
        self._variants: Dict[bytes, Optional[bytes]] = {}

    def _variant(self, payload: bytes) -> Optional[bytes]:
        if payload not in self._variants:
            rng = self.ctx.rng
            v = None
            if rng.random() < self.eq_p:
                v = tamper_payload(
                    payload, rng, self.ctx.suite, EQUIVOCABLE_KINDS
                )
            _cache_put(self._variants, payload, v)
            if v is not None:
                self.ctx.metrics.count("chaos.equivocated")
        return self._variants[payload]

    def on_egress(self, dest, payload):
        v = self._variant(payload)
        if v is not None and dest in self._flip:
            return ((dest, v),)
        return ((dest, payload),)


class CorruptShareSender(ByzantineStrategy):
    """Wrong-but-well-formed COIN/DECRYPT shares with probability
    ``tamper_p`` per logical message — the TamperingAdversary share
    mutations (doubled scalar/point), applied at the wire boundary on
    the Python arm and through the engine tamper hooks on the native
    arm (``native_tamper``).  All peers see the SAME corrupt share, so
    honest fault logs must converge on this sender."""

    name = "corrupt-share"
    native_tamper = True

    #: engine MsgType values (csrc/native/engine.cpp): BA_COIN / HB_DECRYPT
    _MT_COIN, _MT_DECRYPT = 8, 10

    def __init__(self, tamper_p: float = 0.5) -> None:
        self.tamper_p = tamper_p

    def bind(self, ctx: StrategyContext) -> None:
        super().bind(ctx)
        self._variants: Dict[bytes, Optional[bytes]] = {}

    def on_egress(self, dest, payload):
        if payload not in self._variants:
            rng = self.ctx.rng
            v = None
            if rng.random() < self.tamper_p:
                v = tamper_payload(payload, rng, self.ctx.suite, SHARE_KINDS)
            _cache_put(self._variants, payload, v)
            if v is not None:
                self.ctx.metrics.count("chaos.tampered_shares")
        v = self._variants[payload]
        return ((dest, v if v is not None else payload),)

    def native_tamper_cb(self, engine: Any):
        """Build the engine tamper callback (shares are 32-byte
        big-endian scalars — NativeNodeEngine is scalar-suite-only by
        contract, so the ``ln != 32`` guard below is defensive, not a
        reachable silent no-op; the rewrite is the sanitizer driver's
        ``2*s mod r``).  Must never raise across ctypes."""
        import ctypes

        lib, h = engine.lib, engine.handle
        rng = self.ctx.rng
        mod = engine._suite.scalar_modulus
        metrics = self.ctx.metrics

        def cb(sender, mtype, era, epoch, proposer, rnd):
            try:
                if mtype not in (self._MT_COIN, self._MT_DECRYPT):
                    return
                if rng.random() >= self.tamper_p:
                    return
                ln = int(lib.hbe_tamper_share_len(h))
                if ln != 32:
                    return
                buf = (ctypes.c_uint8 * 32)()
                lib.hbe_tamper_share(h, buf)
                s = int.from_bytes(bytes(buf), "big")
                out = (2 * s % mod).to_bytes(32, "big")
                ob = (ctypes.c_uint8 * 32).from_buffer_copy(out)
                lib.hbe_tamper_set_share(h, ob, 32)
                metrics.count("chaos.tampered_shares")
            except Exception:  # pragma: no cover - defensive
                metrics.count("chaos.strategy_errors")

        return cb


class StaleReplayer(ByzantineStrategy):
    """Re-sends its own recorded traffic from earlier epochs: replayed
    frames are consumed and ACKed like any frame, then must die at the
    peers' epoch gates (``dropped_stale`` / protocol dedup) without
    disturbing agreement."""

    name = "stale-replay"

    def __init__(self, replay_p: float = 0.3, history: int = 512) -> None:
        self.replay_p = replay_p
        self.history = history

    def bind(self, ctx: StrategyContext) -> None:
        super().bind(ctx)
        self._hist: "collections.deque" = collections.deque(
            maxlen=self.history
        )

    def on_egress(self, dest, payload):
        self._hist.append((dest, payload))
        return ((dest, payload),)

    def extra_frames(self):
        if len(self._hist) < 64:
            return ()
        rng = self.ctx.rng
        if rng.random() >= self.replay_p:
            return ()
        # oldest half of the window = the stalest epochs we still hold
        dest, payload = self._hist[rng.randrange(len(self._hist) // 2)]
        self.ctx.metrics.count("chaos.replayed")
        return ((dest, payload),)


class GarbageFlooder(ByzantineStrategy):
    """Garbage at both layers of the read path:

    * framing-VALID serde garbage through its own transport — lands in
      the peers' ``cluster.bad_payload`` codec rejections;
    * raw-socket CRC-corrupt frames under its own HELLO identity — the
      frame decoder drops the connection, charges a misbehavior strike,
      and the escalating reconnect ban prices the loop
      (``max_raw`` bounds it so the strategy's own honest-traffic
      identity is not banned into uselessness forever).
    """

    name = "flood"

    def __init__(
        self, garbage_p: float = 0.3, raw_p: float = 0.05, max_raw: int = 8
    ) -> None:
        self.garbage_p = garbage_p
        self.raw_p = raw_p
        self.max_raw = max_raw

    def bind(self, ctx: StrategyContext) -> None:
        super().bind(ctx)
        self._raw_sent = 0

    def extra_frames(self):
        rng = self.ctx.rng
        out: List[Tuple[Any, bytes]] = []
        if rng.random() < self.garbage_p:
            dest = self.ctx.peer_ids[rng.randrange(len(self.ctx.peer_ids))]
            mode = rng.randrange(3)
            if mode == 0:  # valid serde, not an SqMessage
                junk = serde.dumps(rng.randrange(1 << 30))
            elif mode == 1:  # valid serde tree, still not an SqMessage
                junk = serde.dumps((b"chaos", [rng.randrange(255)]))
            else:  # not serde at all
                junk = bytes(
                    rng.randrange(256) for _ in range(rng.randrange(1, 48))
                )
            out.append((dest, junk))
            self.ctx.metrics.count("chaos.garbage_payloads")
        if self._raw_sent < self.max_raw and rng.random() < self.raw_p:
            self._send_raw_corrupt_frame(rng)
        return out

    def _send_raw_corrupt_frame(self, rng: random.Random) -> None:
        dest = self.ctx.peer_ids[rng.randrange(len(self.ctx.peer_ids))]
        addr = self.ctx.peer_addrs[dest]
        frame = bytearray(encode_frame(KIND_MSG, b"chaos-junk"))
        # flip a body bit: the CRC check fails at the peer's decoder
        frame[8 + rng.randrange(len(frame) - 8)] ^= 1 << rng.randrange(8)
        try:
            with socket.create_connection(addr, timeout=0.5) as s:
                s.sendall(
                    encode_hello(self.ctx.node_id, self.ctx.cluster_id)
                    + bytes(frame)
                )
        except OSError:
            return  # peer offline/banned us: the loop being priced IS the point
        self._raw_sent += 1
        self.ctx.metrics.count("chaos.raw_corrupt_frames")


STRATEGIES = {
    CrashStop.name: CrashStop,
    Equivocator.name: Equivocator,
    CorruptShareSender.name: CorruptShareSender,
    StaleReplayer.name: StaleReplayer,
    GarbageFlooder.name: GarbageFlooder,
}


def make_strategy(spec: Any) -> ByzantineStrategy:
    """Resolve a LocalCluster ``byzantine`` spec: a registry name, a
    strategy instance (bind() re-arms it), or a zero-arg factory."""
    if isinstance(spec, ByzantineStrategy):
        return spec
    if isinstance(spec, str):
        cls = STRATEGIES.get(spec)
        if cls is None:
            raise ValueError(
                f"unknown Byzantine strategy {spec!r} "
                f"(known: {sorted(STRATEGIES)})"
            )
        return cls()
    if callable(spec):
        s = spec()
        if not isinstance(s, ByzantineStrategy):
            raise ValueError("strategy factory must return a ByzantineStrategy")
        return s
    raise ValueError(f"bad Byzantine strategy spec: {spec!r}")
