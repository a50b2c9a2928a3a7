"""HoneyBadger: epoch-structured atomic broadcast (Miller et al. 2016).

Reference: upstream ``src/honey_badger/{honey_badger,epoch_state,batch,
builder}.rs`` + ``encryption_schedule.rs`` (SURVEY.md §2 #9,
BASELINE.json:9).  Per epoch: serialize own contribution, threshold-
encrypt it under the master public key (censorship resistance: agree on
ciphertexts *before* anyone can see the contents), run Subset over the
ciphertexts, then one ThresholdDecrypt per accepted ciphertext; the
decrypted contributions form the epoch's ``Batch``.

``EncryptionSchedule`` can skip the encryption layer on configured epochs
(upstream ``EncryptionSchedule::{Always,Never,EveryNthEpoch,TickTock}``).
``max_future_epochs`` bounds buffering for peers who are ahead.

HoneyBadger never terminates on its own — it produces a batch per epoch
for as long as it is driven (as in the reference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

from hbbft_tpu_torch.crypto.keys import Ciphertext
from hbbft_tpu_torch.crypto.pool import VerifySink
from hbbft_tpu_torch.obs import trace as _trace
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.subset import Subset, SubsetOutput
from hbbft_tpu_torch.protocols.threshold_decrypt import ThresholdDecrypt
from hbbft_tpu_torch.protocols.errors import ContributionNotEncodable
from hbbft_tpu_torch.protocols.traits import ConsensusProtocol, Step
from hbbft_tpu_torch.utils import canonical_bytes, serde

FAULT_FUTURE_EPOCH = "honey_badger:message-beyond-max-future-epochs"
FAULT_MALFORMED = "honey_badger:malformed-message"
FAULT_FLOOD = "honey_badger:future-epoch-flood"

# Per-sender cap on buffered future-epoch messages.  An honest node sends
# O(N) Subset messages plus a bounded number of ABA/decrypt messages per
# epoch; the multiplier is generous so slow-but-honest peers never hit it,
# while a Byzantine flooder cannot grow memory without bound.
_FUTURE_BUFFER_PER_SENDER_FACTOR = 64
FAULT_BAD_CIPHERTEXT = "honey_badger:invalid-ciphertext"
FAULT_BAD_CONTRIBUTION = "honey_badger:undecodable-contribution"

SUBSET = "subset"
DECRYPT = "decrypt"

# SubsetHandlingStrategy (upstream ``src/honey_badger/`` builder option):
# "incremental" starts decrypting each accepted contribution as Subset
# emits it; "all_at_end" defers until Subset completes, then processes
# the whole set at once.  Final batches are identical either way — the
# strategy only trades decryption-latency overlap against doing one
# batched pass (which also gives the verify pool a bigger flush batch).
INCREMENTAL = "incremental"
ALL_AT_END = "all_at_end"


# ---------------------------------------------------------------------------
# Encryption schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EncryptionSchedule:
    """Which epochs use threshold encryption.

    kind: "always" | "never" | "every_nth" | "tick_tock"
    ``every_nth``: encrypt on epochs divisible by n.
    ``tick_tock``: alternate n encrypted / n plaintext epochs.
    """

    kind: str = "always"
    n: int = 1

    @staticmethod
    def always() -> "EncryptionSchedule":
        return EncryptionSchedule("always")

    @staticmethod
    def never() -> "EncryptionSchedule":
        return EncryptionSchedule("never")

    @staticmethod
    def every_nth(n: int) -> "EncryptionSchedule":
        return EncryptionSchedule("every_nth", n)

    @staticmethod
    def tick_tock(n: int) -> "EncryptionSchedule":
        return EncryptionSchedule("tick_tock", n)

    def encrypt_on(self, epoch: int) -> bool:
        if self.kind == "always":
            return True
        if self.kind == "never":
            return False
        if self.kind == "every_nth":
            return epoch % self.n == 0
        if self.kind == "tick_tock":
            return (epoch // self.n) % 2 == 0
        raise ValueError(self.kind)


@dataclass(frozen=True)
class Batch:
    """One committed epoch: every accepted node's contribution."""

    epoch: int
    contributions: Tuple[Tuple[Any, Any], ...]  # sorted (proposer, contribution)

    def contribution_map(self) -> Dict[Any, Any]:
        return dict(self.contributions)

    def __repr__(self) -> str:
        return f"Batch(epoch={self.epoch}, from={[p for p, _ in self.contributions]})"


@dataclass(frozen=True)
class HbMessage:
    epoch: int
    kind: str  # SUBSET | DECRYPT
    proposer: Any  # None for SUBSET
    inner: Any


# ---------------------------------------------------------------------------
# Per-epoch state
# ---------------------------------------------------------------------------


class _EpochState:
    """Reference: upstream ``src/honey_badger/epoch_state.rs``."""

    def __init__(self, hb: "HoneyBadger", epoch: int) -> None:
        # Flight-recorder milestone (no-op without an installed tracer;
        # leaf milestones below epoch level are BRACKETED by these
        # open/commit events — obs/export.py).  Epoch-level events carry
        # no proposer: drop any leaf ctx left by the previous message.
        _trace.clear_ctx("proposer")
        _trace.emit("epoch.open", epoch=epoch)
        self.hb = hb
        self.epoch = epoch
        self.encrypted = hb.encryption_schedule.encrypt_on(epoch)
        sink = hb._sink.scoped(lambda s, e=epoch: hb._guard_epoch(e, self._on_subset_step, s))
        self.subset = Subset(
            hb._netinfo, canonical_bytes(hb._session_id, epoch), sink
        )
        self.decrypts: Dict[Any, ThresholdDecrypt] = {}
        self.accepted: Dict[Any, bytes] = {}  # proposer -> subset payload
        self.pending_payloads: List[Tuple[Any, bytes]] = []  # all_at_end buffer
        self.subset_done = False
        self.decrypted: Dict[Any, Any] = {}
        self.faulty_proposers: Set[Any] = set()
        self.proposed = False
        self.batch_emitted = False

    # -- child-step lifting -------------------------------------------
    def _on_subset_step(self, sub_step: Step) -> Step:
        step = sub_step.map_messages(
            lambda m: HbMessage(self.epoch, SUBSET, None, m)
        )
        outputs, step.output = step.output, []
        for out in outputs:
            step.extend(self._on_subset_output(out))
        return step

    def _on_subset_output(self, out: SubsetOutput) -> Step:
        step = Step.empty()
        if out.kind == "contribution":
            self.accepted[out.proposer] = out.value
            if self.hb.subset_handling == ALL_AT_END:
                self.pending_payloads.append((out.proposer, out.value))
            else:
                step.extend(self._start_decrypt(out.proposer, out.value))
        elif out.kind == "done":
            self.subset_done = True
            pending, self.pending_payloads = self.pending_payloads, []
            for proposer, value in pending:
                step.extend(self._start_decrypt(proposer, value))
            step.extend(self._try_batch())
        return step

    def _start_decrypt(self, proposer: Any, payload: bytes) -> Step:
        step = Step.empty()
        if not self.encrypted:
            return step.extend(self._accept_plaintext(proposer, payload))
        _trace.emit("decrypt.start", proposer=proposer)
        ct = serde.try_loads(payload, suite=self.hb._suite())
        if not isinstance(ct, Ciphertext):
            self.faulty_proposers.add(proposer)
            step.fault(proposer, FAULT_BAD_CIPHERTEXT)
            return step.extend(self._try_batch())
        td = self._get_decrypt(proposer)
        step.extend(
            self.hb._guard_epoch(
                self.epoch,
                lambda s, p=proposer: self._on_decrypt_step(p, s),
                td.handle_input(ct, None),
            )
        )
        return step

    def _get_decrypt(self, proposer: Any) -> ThresholdDecrypt:
        if proposer not in self.decrypts:
            sink = self.hb._sink.scoped(
                lambda s, e=self.epoch, p=proposer: self.hb._guard_epoch(
                    e, lambda cs: self._on_decrypt_step(p, cs), s
                )
            )
            self.decrypts[proposer] = ThresholdDecrypt(self.hb._netinfo, sink)
        return self.decrypts[proposer]

    def _on_decrypt_step(self, proposer: Any, td_step: Step) -> Step:
        step = td_step.map_messages(
            lambda m: HbMessage(self.epoch, DECRYPT, proposer, m)
        )
        outputs, step.output = step.output, []
        td = self.decrypts.get(proposer)
        if td is not None and td.ciphertext_invalid and proposer not in self.faulty_proposers:
            self.faulty_proposers.add(proposer)
            step.fault(proposer, FAULT_BAD_CIPHERTEXT)
            step.extend(self._try_batch())
        if outputs:
            _trace.emit("decrypt.done", proposer=proposer)
        for plaintext in outputs:
            step.extend(self._accept_plaintext(proposer, plaintext))
        return step

    def _accept_plaintext(self, proposer: Any, data: bytes) -> Step:
        step = Step.empty()
        if proposer in self.decrypted or proposer in self.faulty_proposers:
            return step
        # loads (not try_loads): a legitimate None contribution must be
        # distinguishable from malformed bytes.
        try:
            self.decrypted[proposer] = serde.loads(data, suite=self.hb._suite())
        except serde.DecodeError:
            self.faulty_proposers.add(proposer)
            step.fault(proposer, FAULT_BAD_CONTRIBUTION)
        return step.extend(self._try_batch())

    # -- message routing ----------------------------------------------
    def handle_message(self, sender: Any, msg: HbMessage, rng: Any) -> Step:
        if msg.kind == SUBSET:
            return self._on_subset_step(
                self.subset.handle_message(sender, msg.inner, rng)
            )
        if msg.kind == DECRYPT:
            if not self.encrypted:
                return Step.empty().fault(sender, FAULT_BAD_CIPHERTEXT)
            try:
                known = self.hb._netinfo.is_node_validator(msg.proposer)
            except TypeError:  # unhashable garbage from a faulty peer
                known = False
            if not known:
                return Step.empty().fault(sender, FAULT_BAD_CIPHERTEXT)
            td = self._get_decrypt(msg.proposer)
            return self._on_decrypt_step(
                msg.proposer, td.handle_message(sender, msg.inner, rng)
            )
        return Step.empty()

    # -- completion ----------------------------------------------------
    def _try_batch(self) -> Step:
        step = Step.empty()
        if self.batch_emitted or not self.subset_done:
            return step
        pending = [
            p
            for p in self.accepted
            if p not in self.decrypted and p not in self.faulty_proposers
        ]
        if pending:
            return step
        self.batch_emitted = True
        batch = Batch(
            self.epoch,
            tuple(sorted(self.decrypted.items(), key=lambda kv: str(kv[0]))),
        )
        _trace.clear_ctx("proposer")  # epoch events carry no proposer
        _trace.emit(
            "epoch.commit", epoch=self.epoch, contribs=len(batch.contributions)
        )
        step.with_output(batch)
        return step


# ---------------------------------------------------------------------------
# HoneyBadger proper
# ---------------------------------------------------------------------------


class HoneyBadger(ConsensusProtocol):
    def __init__(
        self,
        netinfo: NetworkInfo,
        sink: VerifySink,
        session_id: bytes = b"hb",
        max_future_epochs: int = 3,
        encryption_schedule: EncryptionSchedule = EncryptionSchedule.always(),
        subset_handling: str = INCREMENTAL,
    ) -> None:
        if subset_handling not in (INCREMENTAL, ALL_AT_END):
            raise ValueError(f"bad subset_handling: {subset_handling!r}")
        self._netinfo = netinfo
        self._sink = sink
        self._session_id = bytes(session_id)
        self.max_future_epochs = max_future_epochs
        self.encryption_schedule = encryption_schedule
        self.subset_handling = subset_handling
        self._epoch = 0
        self._state = _EpochState(self, 0)
        self._future: Dict[int, List[Tuple[Any, HbMessage]]] = {}
        self._future_per_sender: Dict[Any, int] = {}
        self._pending_proposal: Optional[Tuple[Any, Any, bytes]] = None

    def _suite(self) -> Any:
        """The network's crypto suite — pins serde decoding so committed
        bytes cannot select a different (e.g. the insecure test) suite."""
        return self._netinfo.public_key_set.suite

    # -- ConsensusProtocol --------------------------------------------
    @property
    def our_id(self) -> Any:
        return self._netinfo.our_id

    @property
    def terminated(self) -> bool:
        return False  # HB is a service: one batch per epoch, forever

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def has_input(self) -> bool:
        """Whether we have proposed in the current epoch."""
        return self._state.proposed

    def handle_input(self, input: Any, rng: Any) -> Step:
        """Propose ``input`` (any codec-encodable contribution) this
        epoch: primitives, containers, and the registered wire types
        (see :mod:`hbbft_tpu_torch.wire`).  Raises
        :class:`~hbbft_tpu_torch.protocols.errors.ContributionNotEncodable`
        for anything else — at the boundary, before any state changes.

        A proposal made while the current epoch already has one is held
        and submitted at the next epoch start.
        """
        if not self._netinfo.is_validator():
            return Step.empty()
        try:
            data = serde.dumps(input)
        except serde.EncodeError as e:
            raise ContributionNotEncodable(str(e)) from e
        if self._state.proposed:
            # Hold (with its rng — the epoch may roll over inside a
            # verify-pool flush, where no caller rng is in scope).
            self._pending_proposal = (input, rng, data)
            return Step.empty()
        return self._propose_now(input, rng, data)

    def _propose_now(self, input: Any, rng: Any, data: Optional[bytes] = None) -> Step:
        self._state.proposed = True
        if data is None:
            data = serde.dumps(input)
        if self._state.encrypted:
            pk = self._netinfo.public_key_set.public_key()
            data = serde.dumps(pk.encrypt(data, rng))
        return self._guard_epoch(
            self._epoch, self._state._on_subset_step, self._state.subset.handle_input(data, rng)
        )

    def handle_message(self, sender: Any, message: HbMessage, rng: Any) -> Step:
        step = Step.empty()
        if (
            not isinstance(message, HbMessage)
            or not isinstance(message.epoch, int)
            or isinstance(message.epoch, bool)
            or message.kind not in (SUBSET, DECRYPT)
        ):
            return step.fault(sender, FAULT_MALFORMED)
        if message.epoch < self._epoch:
            return step  # stale epoch: drop
        if message.epoch > self._epoch + self.max_future_epochs:
            return step.fault(sender, FAULT_FUTURE_EPOCH)
        if message.epoch > self._epoch:
            cap = (
                _FUTURE_BUFFER_PER_SENDER_FACTOR
                * (self.max_future_epochs + 1)
                * max(1, self._netinfo.num_nodes)
            )
            buffered = self._future_per_sender.get(sender, 0)
            if buffered >= cap:
                return step.fault(sender, FAULT_FLOOD)
            self._future_per_sender[sender] = buffered + 1
            self._future.setdefault(message.epoch, []).append((sender, message))
            return step
        step.extend(self._state.handle_message(sender, message, rng))
        return step.extend(self._advance(rng))

    # -- epoch transitions --------------------------------------------
    def _guard_epoch(self, epoch: int, fn, child_step: Step) -> Step:
        """Run a child-step lift only if ``epoch`` is still current; late
        verification results of completed epochs keep only their faults."""
        if epoch != self._epoch:
            return Step(output=[], messages=[], fault_log=child_step.fault_log)
        step = fn(child_step)
        return step.extend(self._advance(None))

    def _advance(self, rng: Any) -> Step:
        step = Step.empty()
        while self._state.batch_emitted:
            self._epoch += 1
            self._state = _EpochState(self, self._epoch)
            if self._pending_proposal is not None:
                (proposal, prop_rng, data), self._pending_proposal = (
                    self._pending_proposal,
                    None,
                )
                step.extend(self._propose_now(proposal, prop_rng, data))
            replay = self._future.pop(self._epoch, [])
            for sender, msg in replay:
                remaining = self._future_per_sender.get(sender, 1) - 1
                if remaining > 0:
                    self._future_per_sender[sender] = remaining
                else:
                    self._future_per_sender.pop(sender, None)
                step.extend(self._state.handle_message(sender, msg, rng))
        return step
