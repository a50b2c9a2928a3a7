"""SenderQueue: epoch-aware outbox for real (lossless, ordered) links.

Reference: upstream ``src/sender_queue/{mod,message,honey_badger,
dynamic_honey_badger,queueing_honey_badger}.rs`` (SURVEY.md §2 #13).

The wrapped protocol's messages are only valid within an (era, epoch)
window; sending one to a peer that is far behind would make the peer
flag us as a flooder, and sending to a peer that has moved on wastes
bandwidth.  ``SenderQueue``:

* broadcasts ``EpochStarted(era, epoch)`` whenever our own protocol
  advances;
* tracks every peer's last announced (era, epoch);
* expands ``Target::All``-style messages into per-peer sends and holds
  each until the peer's announced window admits it (ahead-of-window
  messages buffer; behind-of-window messages drop);
* implements ``ConsensusProtocol`` itself, so the caller's event loop
  sees one protocol.

Adapters: any wrapped protocol works given an ``epoch_of(message) ->
(era, epoch)`` and a ``current_epoch(protocol) -> (era, epoch)``; the
standard ones for HoneyBadger / DynamicHoneyBadger /
QueueingHoneyBadger are provided (upstream's
``SenderQueueableConsensusProtocol`` impls).

Copy of ``hbbft_tpu/protocols/sender_queue.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from hbbft_tpu_torch.protocols.dynamic_honey_badger import DhbMessage, DynamicHoneyBadger
from hbbft_tpu_torch.protocols.honey_badger import HbMessage, HoneyBadger
from hbbft_tpu_torch.protocols.queueing_honey_badger import QueueingHoneyBadger
from hbbft_tpu_torch.protocols.traits import ConsensusProtocol, Step

FAULT_MALFORMED = "sender_queue:malformed-message"

EpochId = Tuple[int, int]  # (era, epoch), lexicographic


@dataclass(frozen=True)
class SqMessage:
    kind: str  # "epoch_started" | "algo" | "join_plan"
    value: Any

    @staticmethod
    def epoch_started(epoch: EpochId) -> "SqMessage":
        return SqMessage("epoch_started", epoch)

    @staticmethod
    def algo(inner: Any) -> "SqMessage":
        return SqMessage("algo", inner)

    @staticmethod
    def join_plan(plan: Any) -> "SqMessage":
        return SqMessage("join_plan", plan)


def _hb_epoch_of(message: HbMessage) -> EpochId:
    return (0, message.epoch)


def _hb_current(hb: HoneyBadger) -> EpochId:
    return (0, hb.epoch)


def _dhb_epoch_of(message: DhbMessage) -> EpochId:
    return (message.era, message.inner.epoch)


def _dhb_current(dhb: DynamicHoneyBadger) -> EpochId:
    return (dhb.era, dhb._hb.epoch)


def _qhb_current(qhb: QueueingHoneyBadger) -> EpochId:
    return _dhb_current(qhb.dhb)


class SenderQueue(ConsensusProtocol):
    def __init__(
        self,
        inner: ConsensusProtocol,
        peers: List[Any],
        epoch_of: Optional[Callable[[Any], EpochId]] = None,
        current_epoch: Optional[Callable[[Any], EpochId]] = None,
        max_future_epochs: int = 3,
    ) -> None:
        self.inner = inner
        self.max_future_epochs = max_future_epochs
        self._epoch_of = epoch_of or _default_epoch_of(inner)
        self._current = current_epoch or _default_current(inner)
        self._peers = [p for p in peers if p != inner.our_id]
        self._peer_epochs: Dict[Any, EpochId] = {p: (0, 0) for p in self._peers}
        self._outbox: Dict[Any, List[Tuple[EpochId, Any]]] = {p: [] for p in self._peers}
        self._last_announced: Optional[EpochId] = None
        # Membership-change duties (upstream ``src/sender_queue/
        # dynamic_honey_badger.rs``): current validator set (for diffing
        # era changes), peers already handed a JoinPlan, and departing
        # validators with the era whose announcement releases them.
        self._validator_ids = set(_validator_ids_of(inner))
        self._join_plan_sent: set = set()
        self._departing: Dict[Any, int] = {}
        self._removed: set = set()

    @classmethod
    def wrap(
        cls,
        inner_factory: Callable[[Any], ConsensusProtocol],
        sink: Any,
        peers: List[Any],
        **kwargs: Any,
    ) -> "SenderQueue":
        """Build the inner protocol with a sink scoped through this
        SenderQueue, so steps surfacing from deferred-verification
        flushes are epoch-gated and wrapped exactly like ordinary ones.

        ``inner_factory(scoped_sink) -> protocol``.
        """
        box: List["SenderQueue"] = []
        scoped = sink.scoped(lambda step: box[0]._post(step) if box else step)
        inner = inner_factory(scoped)
        sq = cls(inner, peers, **kwargs)
        box.append(sq)
        return sq

    # -- ConsensusProtocol --------------------------------------------
    @property
    def our_id(self) -> Any:
        return self.inner.our_id

    @property
    def terminated(self) -> bool:
        return self.inner.terminated

    def handle_input(self, input: Any, rng: Any) -> Step:
        return self._post(self.inner.handle_input(input, rng))

    def handle_message(self, sender: Any, message: Any, rng: Any) -> Step:
        if not isinstance(message, SqMessage):
            return Step.empty().fault(sender, FAULT_MALFORMED)
        if message.kind == "epoch_started":
            return self._on_epoch_started(sender, message.value)
        if message.kind == "algo":
            return self._post(self.inner.handle_message(sender, message.value, rng))
        if message.kind == "join_plan":
            return Step.empty()  # already joined: nothing to do
        return Step.empty().fault(sender, FAULT_MALFORMED)

    # -- internals -----------------------------------------------------
    def _on_epoch_started(self, peer: Any, epoch: Any) -> Step:
        step = Step.empty()
        if (
            not isinstance(epoch, tuple)
            or len(epoch) != 2
            or not all(isinstance(x, int) and not isinstance(x, bool) for x in epoch)
        ):
            return step.fault(peer, FAULT_MALFORMED)
        dep_era = self._departing.get(peer)
        if dep_era is not None and epoch[0] >= dep_era:
            # Deferred removal completes: the departing validator has
            # announced the era past its membership, i.e. it observed
            # the change-complete batch — its last epoch's messages have
            # drained and we stop serving it.
            self._departing.pop(peer, None)
            self._peer_epochs.pop(peer, None)
            self._outbox.pop(peer, None)
            if peer in self._peers:
                self._peers.remove(peer)
            self._removed.add(peer)
            return step
        if peer in self._removed:
            return step  # gone until a future change re-adds it
        if peer not in self._peer_epochs:
            self._peer_epochs[peer] = (0, 0)
            self._outbox[peer] = []
            self._peers.append(peer)
        if epoch <= self._peer_epochs[peer]:
            return step
        self._peer_epochs[peer] = epoch
        held, self._outbox[peer] = self._outbox[peer], []
        for msg_epoch, msg in held:
            self._route(step, peer, msg_epoch, msg)
        return step

    # The send/hold/drop window decision is part of what every peer
    # must agree on: a second implementation of SenderQueue that decided
    # it differently would deliver a different message set.
    def _admits(self, peer_epoch: EpochId, msg_epoch: EpochId) -> str:
        """'send' | 'hold' | 'drop' for a message vs a peer's window."""
        if msg_epoch[0] < peer_epoch[0]:
            return "drop"  # stale era
        if msg_epoch[0] > peer_epoch[0]:
            return "hold"  # future era: wait for the peer to get there
        if msg_epoch[1] < peer_epoch[1]:
            return "drop"  # stale epoch
        if msg_epoch[1] > peer_epoch[1] + self.max_future_epochs:
            return "hold"
        return "send"

    def _route(self, step: Step, peer: Any, msg_epoch: EpochId, msg: Any) -> None:
        verdict = self._admits(self._peer_epochs[peer], msg_epoch)
        if verdict == "send":
            step.send(peer, SqMessage.algo(msg))
        elif verdict == "hold":
            self._outbox[peer].append((msg_epoch, msg))

    def _post(self, inner_step: Step) -> Step:
        """Expand + gate the inner step's messages; announce our epoch."""
        step = Step(
            output=inner_step.output, messages=[], fault_log=inner_step.fault_log
        )
        for out in inner_step.output:
            self._on_batch(step, out)
        for tm in inner_step.messages:
            recipients = tm.target.recipients(self._peers, None)
            msg_epoch = self._epoch_of(tm.message)
            for peer in recipients:
                if peer == self.our_id:
                    continue
                self._route(step, peer, msg_epoch, tm.message)
        cur = self._current(self.inner)
        if cur != self._last_announced:
            self._last_announced = cur
            step.broadcast(SqMessage.epoch_started(cur))
        return step

    def _on_batch(self, step: Step, out: Any) -> None:
        """Membership-change duties on a change-complete batch (upstream
        ``src/sender_queue/dynamic_honey_badger.rs``): hand the
        ``JoinPlan`` to newly-added peers through the queue, and mark
        removed validators as *departing* — they keep receiving their
        final era's messages and are only dropped once they announce the
        new era (deferred removal)."""
        plan = getattr(out, "join_plan", None)
        change = getattr(out, "change", None)
        if plan is None or change is None or change.kind != "complete":
            return
        new_ids = set(plan.validator_map())
        added = new_ids - self._validator_ids
        removed = self._validator_ids - new_ids
        self._validator_ids = new_ids
        # Era expiry for departing peers that never announced (crashed
        # before observing their removal): once a LATER era completes,
        # they have missed a whole era — stop serving them, else their
        # outbox grows without bound for the lifetime of the network.
        for peer, dep_era in list(self._departing.items()):
            if dep_era < plan.era:
                self._departing.pop(peer, None)
                self._peer_epochs.pop(peer, None)
                self._outbox.pop(peer, None)
                if peer in self._peers:
                    self._peers.remove(peer)
                self._removed.add(peer)
        for peer in removed:
            if peer != self.our_id and peer in self._peer_epochs:
                self._departing[peer] = plan.era
            # A removed validator re-added by a LATER change must get
            # that change's JoinPlan again.
            self._join_plan_sent.discard(peer)
        for peer in sorted(added, key=str):
            if peer == self.our_id:
                continue
            self._removed.discard(peer)
            self._departing.pop(peer, None)
            if peer not in self._peer_epochs:
                self._peer_epochs[peer] = (plan.era, 0)
                self._outbox[peer] = []
                self._peers.append(peer)
            if peer not in self._join_plan_sent:
                self._join_plan_sent.add(peer)
                step.send(peer, SqMessage.join_plan(plan))


class JoiningSenderQueue(ConsensusProtocol):
    """A node that is not yet a participant: it waits for a
    :class:`~hbbft_tpu_torch.protocols.dynamic_honey_badger.JoinPlan` handed
    through a peer's SenderQueue, then constructs its protocol from the
    plan and becomes a live :class:`SenderQueue` — no manual plumbing.

    ``make_inner(join_plan, sink) -> protocol`` builds the inner
    protocol (default: ``DynamicHoneyBadger.from_join_plan``; pass a
    QHB-building factory for the queueing stack).  Messages arriving
    before the plan are buffered (bounded) and replayed after joining.

    Trust: ``join_quorum`` distinct peers must deliver value-identical
    plans before joining (default 1 — first valid plan wins, the
    reference's application-trusted stance; set it to f+1 so no
    coalition of <= f Byzantine peers can feed a forged plan).
    """

    _MAX_BUFFER = 4096

    def __init__(
        self,
        our_id: Any,
        secret_key: Any,
        sink: Any,
        peers: List[Any],
        make_inner: Optional[Callable[[Any, Any], ConsensusProtocol]] = None,
        max_future_epochs: int = 3,
        session_id: bytes = b"dhb",
        join_quorum: int = 1,
    ) -> None:
        self._our_id = our_id
        self._secret_key = secret_key
        self._sink = sink
        self._peers = list(peers)
        self._max_future_epochs = max_future_epochs
        self._session_id = session_id
        self._make_inner = make_inner
        self._join_quorum = max(1, join_quorum)
        # One endorsed plan per configured peer: a peer re-sending a
        # different plan replaces its previous vote, so at most
        # len(peers) candidate plans are ever retained (Byzantine peers
        # cannot grow memory with novel forged plans), and votes from
        # senders outside the configured peer set never count toward
        # the quorum.
        self._plan_vote_by_peer: Dict[Any, bytes] = {}
        self._plan_votes: Dict[bytes, set] = {}
        self._plan_by_digest: Dict[bytes, Any] = {}
        self._sq: Optional[SenderQueue] = None
        self._buffer: List[Tuple[Any, Any]] = []

    @property
    def our_id(self) -> Any:
        return self._our_id

    @property
    def terminated(self) -> bool:
        return False

    @property
    def joined(self) -> bool:
        return self._sq is not None

    @property
    def inner(self) -> Optional[ConsensusProtocol]:
        return self._sq.inner if self._sq is not None else None

    def handle_input(self, input: Any, rng: Any) -> Step:
        if self._sq is None:
            return Step.empty()  # not a participant yet
        return self._sq.handle_input(input, rng)

    def handle_message(self, sender: Any, message: Any, rng: Any) -> Step:
        if self._sq is not None:
            return self._sq.handle_message(sender, message, rng)
        if not isinstance(message, SqMessage):
            return Step.empty().fault(sender, FAULT_MALFORMED)
        if message.kind == "join_plan":
            return self._join(message.value, sender, rng)
        if len(self._buffer) < self._MAX_BUFFER:
            self._buffer.append((sender, message))
        return Step.empty()

    def _join(self, plan: Any, sender: Any, rng: Any) -> Step:
        from hbbft_tpu_torch.protocols.dynamic_honey_badger import JoinPlan
        from hbbft_tpu_torch.utils import serde

        if not isinstance(plan, JoinPlan):
            return Step.empty().fault(sender, FAULT_MALFORMED)
        if self._join_quorum > 1:
            if sender not in self._peers:
                # Only configured peers vote: transport-level spoofing /
                # unexpected senders must not weaken the f+1 quorum.
                return Step.empty().fault(sender, FAULT_MALFORMED)
            try:
                digest = serde.dumps(plan)
            except serde.EncodeError:
                return Step.empty().fault(sender, FAULT_MALFORMED)
            prev = self._plan_vote_by_peer.get(sender)
            if prev is not None and prev != digest:
                votes = self._plan_votes.get(prev)
                if votes is not None:
                    votes.discard(sender)
                    if not votes:
                        del self._plan_votes[prev]
                        del self._plan_by_digest[prev]
            self._plan_vote_by_peer[sender] = digest
            self._plan_votes.setdefault(digest, set()).add(sender)
            self._plan_by_digest[digest] = plan
            if len(self._plan_votes[digest]) < self._join_quorum:
                return Step.empty()
            plan = self._plan_by_digest[digest]

        def default_make(p: Any, sink: Any) -> ConsensusProtocol:
            return DynamicHoneyBadger.from_join_plan(
                self._our_id,
                self._secret_key,
                p,
                sink,
                session_id=self._session_id,
                max_future_epochs=self._max_future_epochs,
            )

        make = self._make_inner or default_make
        self._sq = SenderQueue.wrap(
            lambda scoped: make(plan, scoped),
            self._sink,
            peers=self._peers,
            max_future_epochs=self._max_future_epochs,
        )
        # Announce where we are and replay anything that arrived early.
        step = self._sq._post(Step.empty())
        buffered, self._buffer = self._buffer, []
        for peer, msg in buffered:
            step.extend(self._sq.handle_message(peer, msg, rng))
        return step


def _validator_ids_of(inner: ConsensusProtocol) -> Tuple[Any, ...]:
    ni = getattr(inner, "netinfo", None)
    if ni is None:
        return ()
    return tuple(getattr(ni, "all_ids", ()))


def _default_epoch_of(inner: ConsensusProtocol) -> Callable[[Any], EpochId]:
    if isinstance(inner, (DynamicHoneyBadger, QueueingHoneyBadger)):
        return _dhb_epoch_of
    if isinstance(inner, HoneyBadger):
        return _hb_epoch_of
    raise TypeError(f"no SenderQueue adapter for {type(inner)!r}")


def _default_current(inner: ConsensusProtocol) -> Callable[[Any], EpochId]:
    if isinstance(inner, QueueingHoneyBadger):
        return _qhb_current
    if isinstance(inner, DynamicHoneyBadger):
        return _dhb_current
    if isinstance(inner, HoneyBadger):
        return _hb_current
    raise TypeError(f"no SenderQueue adapter for {type(inner)!r}")
