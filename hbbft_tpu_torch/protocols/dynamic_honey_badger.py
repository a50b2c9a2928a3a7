"""DynamicHoneyBadger: HoneyBadger with validator-set change (era system).

Reference: upstream ``src/dynamic_honey_badger/{dynamic_honey_badger,
votes,change,batch,builder}.rs`` (SURVEY.md §2 #10, BASELINE.json:10
"validator churn").  Capability surface preserved:

* validators cast **signed votes** for a :class:`Change` (a full new
  id -> public-key map, or a new encryption schedule);
* votes and DKG messages ride **inside HoneyBadger contributions**
  (``InternalContrib``), so every node processes them in the same agreed
  order — the one ordering guarantee everything else builds on.  (The
  reference additionally gossips them peer-to-peer as a latency
  optimization; the agreed-order path is the correctness-bearing one and
  is what this implementation uses.)
* on a strict majority of current validators' latest votes, an embedded
  :class:`~hbbft_tpu_torch.protocols.sync_key_gen.SyncKeyGen` runs among the
  NEW validator set, its Part/Ack messages threaded through consensus as
  signed key-gen messages;
* when the DKG is ready, the node switches to the new
  :class:`NetworkInfo`, restarts its inner HoneyBadger, and bumps the
  **era**; the emitted :class:`DhbBatch` carries
  ``ChangeState.complete`` and a :class:`JoinPlan` for joining observers.

Messages are (era, epoch)-tagged; previous-era messages are dropped,
next-era messages are buffered (bounded).

Copy of ``hbbft_tpu/protocols/dynamic_honey_badger.py``.  The inner
HoneyBadger's share checks go through the node's ``VerifySink`` (on the
card with ``TorchBackend``) in every era; the signatures of votes and
key-gen messages are checked here on the host, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.crypto.pool import VerifySink
from hbbft_tpu_torch.obs import trace as _trace
from hbbft_tpu_torch.protocols.honey_badger import (
    Batch,
    EncryptionSchedule,
    HbMessage,
    HoneyBadger,
)
from hbbft_tpu_torch.protocols.errors import ContributionNotEncodable
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.sync_key_gen import Ack, Part, SyncKeyGen
from hbbft_tpu_torch.protocols.traits import ConsensusProtocol, Step
from hbbft_tpu_torch.utils import canonical_bytes, serde

FAULT_MALFORMED = "dynamic_honey_badger:malformed-message"
FAULT_BAD_CONTRIB = "dynamic_honey_badger:malformed-contribution"
FAULT_BAD_VOTE_SIG = "dynamic_honey_badger:invalid-vote-signature"
FAULT_BAD_KG_SIG = "dynamic_honey_badger:invalid-keygen-signature"
FAULT_FUTURE_ERA = "dynamic_honey_badger:message-beyond-next-era"
FAULT_BAD_KG_MSG = "dynamic_honey_badger:invalid-keygen-message"

_FUTURE_ERA_BUFFER_PER_SENDER = 4096


# ---------------------------------------------------------------------------
# Change / votes / join plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Change:
    """A proposed reconfiguration.

    kind == "node_change": ``new_validators`` is the COMPLETE new
    id -> regular-public-key map (upstream ``Change::NodeChange``).
    kind == "encryption_schedule": ``schedule`` replaces the inner HB's
    schedule (upstream ``Change::EncryptionSchedule``).
    """

    kind: str
    new_validators: Tuple[Tuple[Any, Any], ...] = ()
    schedule: Optional[EncryptionSchedule] = None

    @staticmethod
    def node_change(pub_keys: Dict[Any, Any]) -> "Change":
        return Change(
            "node_change",
            tuple(sorted(pub_keys.items(), key=lambda kv: str(kv[0]))),
        )

    @staticmethod
    def encryption_schedule(schedule: EncryptionSchedule) -> "Change":
        return Change("encryption_schedule", (), schedule)

    def validator_map(self) -> Dict[Any, Any]:
        return dict(self.new_validators)

    def digest(self) -> bytes:
        parts: List[Any] = [b"change", self.kind]
        for node, pk in self.new_validators:
            parts.append(str(node))
            parts.append(pk.to_bytes())
        if self.schedule is not None:
            parts.append(self.schedule.kind)
            parts.append(self.schedule.n)
        return canonical_bytes(*parts)


@dataclass(frozen=True)
class ChangeState:
    """none | in_progress(change) | complete(change)."""

    kind: str = "none"
    change: Optional[Change] = None

    @staticmethod
    def none() -> "ChangeState":
        return ChangeState("none", None)

    @staticmethod
    def in_progress(change: Change) -> "ChangeState":
        return ChangeState("in_progress", change)

    @staticmethod
    def complete(change: Change) -> "ChangeState":
        return ChangeState("complete", change)


@dataclass(frozen=True)
class JoinPlan:
    """Everything a new observer needs to join at an era boundary."""

    era: int
    public_key_set: Any
    validators: Tuple[Tuple[Any, Any], ...]  # id -> regular public key
    encryption_schedule: EncryptionSchedule

    def validator_map(self) -> Dict[Any, Any]:
        return dict(self.validators)


def _memo_signed_payload(obj: Any, build) -> bytes:
    """Payload bytes are a pure function of the (frozen) object; committed
    messages are decode-cache-shared across all N nodes, so caching on the
    object turns N identical serializations into one."""
    cached = obj.__dict__.get("_sp_bytes")
    if cached is None:
        cached = build()
        object.__setattr__(obj, "_sp_bytes", cached)
    return cached


def _memo_sig_verdict(obj: Any, pk: Any, check) -> bool:
    """Signature verdicts are pure functions of (pk, payload, signature);
    key the per-object memo by the pk's canonical bytes so nodes with
    diverging validator maps can never share a wrong verdict."""
    try:
        key = pk.to_bytes()
    except Exception:
        return bool(check())
    memo = obj.__dict__.get("_sig_ok")
    if memo is None:
        memo = {}
        object.__setattr__(obj, "_sig_ok", memo)
    ok = memo.get(key)
    if ok is None:
        ok = bool(check())
        memo[key] = ok
    return ok


@dataclass(frozen=True)
class SignedVote:
    voter: Any
    era: int
    num: int  # per-voter sequence number; the highest committed one wins
    change: Change
    signature: Any

    def signed_payload(self) -> bytes:
        return _memo_signed_payload(
            self,
            lambda: canonical_bytes(
                b"dhb-vote", str(self.voter), self.era, self.num, self.change.digest()
            ),
        )


@dataclass(frozen=True)
class SignedKeyGenMsg:
    """A DKG Part/Ack, signed by its sender, threaded through consensus."""

    era: int
    sender: Any
    payload: Any  # Part | Ack
    signature: Any

    def signed_payload(self) -> bytes:
        return _memo_signed_payload(
            self,
            lambda: canonical_bytes(
                b"dhb-kg", str(self.sender), self.era, _kg_payload_bytes(self.payload)
            ),
        )


def _kg_payload_bytes(payload: Any) -> bytes:
    """Canonical (collision-free) bytes of a Part/Ack for signing.

    Memoized on the (frozen) payload object: every node recomputes this
    for every committed key-gen message otherwise — with shared decoded
    objects that is N^2 serializations of multi-kilobyte Parts per
    churn epoch."""
    cached = payload.__dict__.get("_kg_bytes") if hasattr(payload, "__dict__") else None
    if cached is not None:
        return cached
    if isinstance(payload, Part):
        out = canonical_bytes(
            b"part", payload.commitment.to_bytes(), *[c.to_bytes() for c in payload.rows]
        )
    elif isinstance(payload, Ack):
        out = canonical_bytes(
            b"ack", str(payload.proposer), *[c.to_bytes() for c in payload.values]
        )
    else:
        raise TypeError(f"not a key-gen payload: {type(payload)!r}")
    object.__setattr__(payload, "_kg_bytes", out)
    return out


@dataclass(frozen=True)
class InternalContrib:
    """What actually rides through the inner HoneyBadger each epoch."""

    contribution: Any
    key_gen_messages: Tuple[SignedKeyGenMsg, ...] = ()
    votes: Tuple[SignedVote, ...] = ()


@dataclass(frozen=True)
class DhbMessage:
    era: int
    inner: HbMessage


@dataclass(frozen=True)
class DhbBatch:
    """One committed epoch at the DHB layer."""

    era: int
    epoch: int
    contributions: Tuple[Tuple[Any, Any], ...]  # user contributions only
    change: ChangeState = ChangeState.none()
    join_plan: Optional[JoinPlan] = None

    def contribution_map(self) -> Dict[Any, Any]:
        return dict(self.contributions)


# ---------------------------------------------------------------------------
# Vote counting
# ---------------------------------------------------------------------------


class VoteCounter:
    """Latest committed vote per validator; winner = strict majority.

    Reference: upstream ``src/dynamic_honey_badger/votes.rs``.
    """

    def __init__(self) -> None:
        self.committed: Dict[Any, SignedVote] = {}

    def add(self, vote: SignedVote) -> None:
        cur = self.committed.get(vote.voter)
        if cur is None or vote.num > cur.num:
            self.committed[vote.voter] = vote

    def winner(self, validators: Tuple[Any, ...]) -> Optional[Change]:
        tally: Dict[bytes, Tuple[int, Change]] = {}
        for node in validators:
            vote = self.committed.get(node)
            if vote is None:
                continue
            d = vote.change.digest()
            cnt, _ = tally.get(d, (0, vote.change))
            tally[d] = (cnt + 1, vote.change)
        for cnt, change in tally.values():
            if 2 * cnt > len(validators):
                return change
        return None


# ---------------------------------------------------------------------------
# Key-generation state (one validator-set change in flight)
# ---------------------------------------------------------------------------


class _KeyGenState:
    def __init__(
        self, change: Change, key_gen: SyncKeyGen, threshold: int
    ) -> None:
        self.change = change
        self.key_gen = key_gen
        self.threshold = threshold
        self.parts_handled: Dict[Any, bool] = {}
        # change.validator_map() builds a fresh dict per call; the kg
        # signature path asks once per committed Part/Ack (N^2 per churn).
        self.val_map: Dict[Any, Any] = (
            change.validator_map() if change.kind == "node_change" else {}
        )

    @property
    def ready(self) -> bool:
        return self.key_gen.is_ready()


# ---------------------------------------------------------------------------
# DynamicHoneyBadger
# ---------------------------------------------------------------------------


class DynamicHoneyBadger(ConsensusProtocol):
    """Era-structured HoneyBadger with embedded DKG for membership change.

    ``sink`` is the node-level :class:`VerifySink`; child protocols get
    scoped views so verification callbacks re-enter through this layer
    exactly like ordinary messages.
    """

    def __init__(
        self,
        netinfo: NetworkInfo,
        sink: VerifySink,
        session_id: bytes = b"dhb",
        era: int = 0,
        max_future_epochs: int = 3,
        encryption_schedule: EncryptionSchedule = EncryptionSchedule.always(),
        suite: Any = None,
        subset_handling: str = "incremental",
    ) -> None:
        self._netinfo = netinfo
        self._sink = sink
        self._session_id = bytes(session_id)
        self._era = era
        self.max_future_epochs = max_future_epochs
        self.encryption_schedule = encryption_schedule
        self.subset_handling = subset_handling
        self._suite = suite if suite is not None else _suite_of(netinfo)
        self._hb: HoneyBadger = self._make_hb()
        self._vote_counter = VoteCounter()
        self._our_vote: Optional[SignedVote] = None
        self._vote_num = 0
        self._key_gen: Optional[_KeyGenState] = None
        self._outgoing_kg: List[SignedKeyGenMsg] = []
        self._next_era_buffer: List[Tuple[Any, DhbMessage]] = []
        self._rng: Any = None  # last rng seen; used for era restarts

    # -- construction helpers -----------------------------------------
    @staticmethod
    def from_join_plan(
        our_id: Any,
        secret_key: Any,
        join_plan: JoinPlan,
        sink: VerifySink,
        session_id: bytes = b"dhb",
        max_future_epochs: int = 3,
        suite: Any = None,
    ) -> "DynamicHoneyBadger":
        """Join as an observer at the era boundary described by the plan."""
        netinfo = NetworkInfo(
            our_id,
            tuple(join_plan.validator_map()),
            join_plan.public_key_set,
            None,
            join_plan.validator_map(),
            secret_key,
        )
        return DynamicHoneyBadger(
            netinfo,
            sink,
            session_id=session_id,
            era=join_plan.era,
            max_future_epochs=max_future_epochs,
            encryption_schedule=join_plan.encryption_schedule,
            suite=suite,
        )

    def _make_hb(self) -> HoneyBadger:
        # The scoped sink pins this HB's era: verification callbacks of a
        # finished era keep only their fault reports.
        era = self._era
        # Tracer era ctx must advance HERE, not only at handle_message
        # entry: an era change runs inside a batch's processing, and the
        # new HoneyBadger's _EpochState(0) emits epoch.open immediately —
        # with a stale ctx the new era's first epoch would be keyed to
        # the OLD era and corrupt both eras' phase spans.
        _trace.set_ctx(era=era)
        return HoneyBadger(
            self._netinfo,
            self._sink.scoped(lambda s, e=era: self._on_hb_step_era(e, s)),
            session_id=canonical_bytes(self._session_id, self._era),
            max_future_epochs=self.max_future_epochs,
            encryption_schedule=self.encryption_schedule,
            subset_handling=self.subset_handling,
        )

    # -- ConsensusProtocol --------------------------------------------
    @property
    def our_id(self) -> Any:
        return self._netinfo.our_id

    @property
    def terminated(self) -> bool:
        return False

    @property
    def era(self) -> int:
        return self._era

    @property
    def netinfo(self) -> NetworkInfo:
        return self._netinfo

    @property
    def has_input(self) -> bool:
        return self._hb.has_input

    def handle_input(self, input: Any, rng: Any) -> Step:
        """Propose a user contribution this epoch.

        Encodability is validated BEFORE ``_make_contrib`` drains the
        outgoing key-gen queue, so a bad input cannot destroy queued DKG
        messages on its way to raising."""
        self._rng = rng
        try:
            serde.dumps(input)
        except serde.EncodeError as e:
            raise ContributionNotEncodable(str(e)) from e
        return self._lift(self._hb.handle_input(self._make_contrib(input), rng))

    def vote_for(self, change: Change, rng: Any) -> Step:
        """Cast (or replace) our signed vote; rides in contributions."""
        if not self._netinfo.is_validator():
            return Step.empty()
        self._vote_num += 1
        vote = SignedVote(self.our_id, self._era, self._vote_num, change, None)
        sig = self._netinfo.secret_key.sign(vote.signed_payload())
        self._our_vote = SignedVote(self.our_id, self._era, self._vote_num, change, sig)
        return Step.empty()

    def vote_to_add(self, node_id: Any, pub_key: Any, rng: Any) -> Step:
        keys = self._netinfo.public_key_map
        keys[node_id] = pub_key
        return self.vote_for(Change.node_change(keys), rng)

    def vote_to_remove(self, node_id: Any, rng: Any) -> Step:
        keys = self._netinfo.public_key_map
        keys.pop(node_id, None)
        return self.vote_for(Change.node_change(keys), rng)

    def handle_message(self, sender: Any, message: Any, rng: Any) -> Step:
        self._rng = rng
        step = Step.empty()
        if not isinstance(message, DhbMessage) or not isinstance(
            message.era, int
        ) or isinstance(message.era, bool):
            return step.fault(sender, FAULT_MALFORMED)
        if message.era < self._era:
            return step  # previous era: stale, drop
        if message.era > self._era + 1:
            return step.fault(sender, FAULT_FUTURE_ERA)
        if message.era == self._era + 1:
            if len(self._next_era_buffer) < _FUTURE_ERA_BUFFER_PER_SENDER:
                self._next_era_buffer.append((sender, message))
            return step
        # Tracer context: epoch-level milestones below HB carry the era
        # they belong to (era changes restart HB's epoch counter at 0).
        _trace.set_ctx(era=self._era)
        return step.extend(self._lift(self._hb.handle_message(sender, message.inner, rng)))

    # -- internals -----------------------------------------------------
    def _make_contrib(self, input: Any) -> InternalContrib:
        kg, self._outgoing_kg = tuple(self._outgoing_kg), []
        votes = (self._our_vote,) if self._our_vote is not None else ()
        return InternalContrib(input, kg, votes)

    def _lift(self, hb_step: Step) -> Step:
        """Wrap inner-HB messages with the era tag; process batches."""
        step = hb_step.map_messages(lambda m: DhbMessage(self._era, m))
        outputs, step.output = step.output, []
        for batch in outputs:
            step.extend(self._process_batch(batch))
        return step

    def _on_hb_step_era(self, era: int, hb_step: Step) -> Step:
        if era != self._era:
            return Step(output=[], messages=[], fault_log=hb_step.fault_log)
        return self._lift(hb_step)

    def _process_batch(self, batch: Batch) -> Step:
        step = Step.empty()
        user_contribs: List[Tuple[Any, Any]] = []
        kg_msgs: List[Tuple[Any, SignedKeyGenMsg]] = []
        for proposer, contrib in batch.contributions:
            if not isinstance(contrib, InternalContrib):
                step.fault(proposer, FAULT_BAD_CONTRIB)
                continue
            user_contribs.append((proposer, contrib.contribution))
            for vote in contrib.votes:
                step.extend(self._commit_vote(proposer, vote))
            for kg in contrib.key_gen_messages:
                if not isinstance(kg, SignedKeyGenMsg):
                    step.fault(proposer, FAULT_BAD_CONTRIB)
                    continue
                kg_msgs.append((proposer, kg))
        # Process key-gen messages in the batch's deterministic order.
        for proposer, kg in kg_msgs:
            step.extend(self._handle_kg_message(proposer, kg))
        change_state = ChangeState.none()
        join_plan: Optional[JoinPlan] = None
        if self._key_gen is None:
            winner = self._vote_counter.winner(self._netinfo.all_ids)
            if winner is not None:
                step.extend(self._start_key_gen(winner))
                if self._key_gen is not None:
                    change_state = ChangeState.in_progress(winner)
        era_before = self._era
        if self._key_gen is not None:
            if self._key_gen.change.kind == "encryption_schedule":
                change_state, join_plan = self._complete_schedule_change()
            elif self._key_gen.ready:
                change_state, join_plan = self._complete_node_change()
            else:
                change_state = ChangeState.in_progress(self._key_gen.change)
        step.with_output(
            DhbBatch(
                era_before,
                batch.epoch,
                tuple(user_contribs),
                change_state,
                join_plan,
            )
        )
        if self._era != era_before:
            step.extend(self._replay_next_era())
        return step

    def _commit_vote(self, proposer: Any, vote: Any) -> Step:
        step = Step.empty()
        if (
            not isinstance(vote, SignedVote)
            or not isinstance(vote.change, Change)
            or vote.era != self._era
            or not self._netinfo.is_node_validator(vote.voter)
        ):
            return step.fault(proposer, FAULT_BAD_VOTE_SIG)
        try:
            pk = self._netinfo.public_key(vote.voter)
            ok = _memo_sig_verdict(
                vote, pk, lambda: pk.verify(vote.signed_payload(), vote.signature)
            )
        except Exception:
            ok = False
        if not ok:
            return step.fault(proposer, FAULT_BAD_VOTE_SIG)
        self._vote_counter.add(vote)
        return step

    def _start_key_gen(self, change: Change) -> Step:
        step = Step.empty()
        if change.kind == "encryption_schedule":
            self._key_gen = _KeyGenState(change, None, 0)  # type: ignore[arg-type]
            return step
        new_map = change.validator_map()
        threshold = (len(new_map) - 1) // 3
        key_gen, part = SyncKeyGen.new(
            self.our_id,
            self._netinfo.secret_key,
            new_map,
            threshold,
            self._rng,
            self._suite,
        )
        self._key_gen = _KeyGenState(change, key_gen, threshold)
        if part is not None and self._netinfo.is_validator():
            self._queue_kg(part)
        return step

    def _queue_kg(self, payload: Any) -> None:
        msg = SignedKeyGenMsg(self._era, self.our_id, payload, None)
        sig = self._netinfo.secret_key.sign(msg.signed_payload())
        self._outgoing_kg.append(
            SignedKeyGenMsg(self._era, self.our_id, payload, sig)
        )

    def _handle_kg_message(self, proposer: Any, kg: SignedKeyGenMsg) -> Step:
        step = Step.empty()
        state = self._key_gen
        if state is None or state.key_gen is None or kg.era != self._era:
            return step  # no change in flight (or stale): ignore
        sender = kg.sender
        # Signature check: the sender must be a CURRENT-era validator
        # (only they deal/ack) or a NEW-set member for acks.
        pk = self._netinfo.public_key_map.get(sender) or state.val_map.get(sender)
        try:
            ok = pk is not None and _memo_sig_verdict(
                kg, pk, lambda: pk.verify(kg.signed_payload(), kg.signature)
            )
        except Exception:
            ok = False
        if not ok:
            return step.fault(proposer, FAULT_BAD_KG_SIG)
        if isinstance(kg.payload, Part):
            outcome = state.key_gen.handle_part(sender, kg.payload, self._rng)
            if not outcome.is_valid:
                step.fault(sender, FAULT_BAD_KG_MSG)
            elif outcome.ack is not None:
                self._queue_kg(outcome.ack)
        elif isinstance(kg.payload, Ack):
            outcome = state.key_gen.handle_ack(sender, kg.payload)
            if not outcome.is_valid:
                step.fault(sender, FAULT_BAD_KG_MSG)
        else:
            step.fault(proposer, FAULT_BAD_CONTRIB)
        return step

    def _complete_schedule_change(self) -> Tuple[ChangeState, Optional[JoinPlan]]:
        change = self._key_gen.change
        self.encryption_schedule = change.schedule
        return self._restart_era(change, self._netinfo)

    def _complete_node_change(self) -> Tuple[ChangeState, Optional[JoinPlan]]:
        state = self._key_gen
        pub_key_set, sk_share = state.key_gen.generate()
        new_map = state.change.validator_map()
        netinfo = NetworkInfo(
            self.our_id,
            tuple(new_map),
            pub_key_set,
            sk_share if self.our_id in new_map else None,
            new_map,
            self._netinfo.secret_key,
        )
        return self._restart_era(state.change, netinfo)

    def _restart_era(
        self, change: Change, netinfo: NetworkInfo
    ) -> Tuple[ChangeState, Optional[JoinPlan]]:
        self._era += 1
        self._netinfo = netinfo
        self._key_gen = None
        self._vote_counter = VoteCounter()
        self._our_vote = None
        self._outgoing_kg = []
        self._hb = self._make_hb()
        join_plan = JoinPlan(
            self._era,
            netinfo.public_key_set,
            tuple(sorted(netinfo.public_key_map.items(), key=lambda kv: str(kv[0]))),
            self.encryption_schedule,
        )
        return ChangeState.complete(change), join_plan

    def _replay_next_era(self) -> Step:
        step = Step.empty()
        buffered, self._next_era_buffer = self._next_era_buffer, []
        for sender, msg in buffered:
            step.extend(self.handle_message(sender, msg, self._rng))
        return step


def _suite_of(netinfo: NetworkInfo) -> Any:
    pks = netinfo.public_key_set
    suite = getattr(pks, "suite", None)
    if suite is None:
        raise ValueError("cannot infer crypto suite from NetworkInfo")
    return suite
