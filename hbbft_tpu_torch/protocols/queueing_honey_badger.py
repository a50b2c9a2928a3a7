"""QueueingHoneyBadger: DynamicHoneyBadger + automatic transaction queue.

Reference: upstream ``src/queueing_honey_badger/{mod,builder}.rs``
(SURVEY.md §2 #11).  Maintains a :class:`TransactionQueue`; each epoch
proposes a random sample of up to ``batch_size / N`` pending
transactions, removes committed ones, and re-proposes across era
changes.  Input is either a user transaction or a :class:`Change` vote.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

from hbbft_tpu_torch.crypto.pool import VerifySink
from hbbft_tpu_torch.protocols.dynamic_honey_badger import (
    Change,
    DhbBatch,
    DynamicHoneyBadger,
    JoinPlan,
)
from hbbft_tpu_torch.protocols.errors import ContributionNotEncodable
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.traits import ConsensusProtocol, Step
from hbbft_tpu_torch.utils import serde
from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule
from hbbft_tpu_torch.protocols.transaction_queue import TransactionQueue


@dataclass(frozen=True)
class Input:
    """User(txn) or Change(vote) — upstream ``Input::{User,Change}``."""

    kind: str  # "user" | "change"
    value: Any

    @staticmethod
    def user(txn: Any) -> "Input":
        return Input("user", txn)

    @staticmethod
    def change(change: Change) -> "Input":
        return Input("change", change)


class QueueingHoneyBadger(ConsensusProtocol):
    def __init__(
        self,
        netinfo: NetworkInfo,
        sink: VerifySink,
        batch_size: int = 100,
        session_id: bytes = b"qhb",
        max_future_epochs: int = 3,
        encryption_schedule: EncryptionSchedule = EncryptionSchedule.always(),
        dhb: Optional[DynamicHoneyBadger] = None,
        subset_handling: str = "incremental",
    ) -> None:
        self.batch_size = batch_size
        self.queue = TransactionQueue()
        self._rng: Any = None
        # Scope the sink: batches surfacing from deferred-verification
        # flushes must pass through _absorb (txn removal + re-propose)
        # exactly like batches from ordinary message handling.
        scoped = sink.scoped(lambda step: self._absorb(step, self._rng))
        self.dhb = dhb or DynamicHoneyBadger(
            netinfo,
            scoped,
            session_id=session_id,
            max_future_epochs=max_future_epochs,
            encryption_schedule=encryption_schedule,
            subset_handling=subset_handling,
        )

    @staticmethod
    def from_join_plan(
        our_id: Any,
        secret_key: Any,
        join_plan: JoinPlan,
        sink: VerifySink,
        batch_size: int = 100,
        session_id: bytes = b"qhb",
        max_future_epochs: int = 3,
    ) -> "QueueingHoneyBadger":
        dhb = DynamicHoneyBadger.from_join_plan(
            our_id, secret_key, join_plan, sink,
            session_id=session_id, max_future_epochs=max_future_epochs,
        )
        qhb = QueueingHoneyBadger(dhb.netinfo, sink, batch_size=batch_size, dhb=dhb)
        return qhb

    # -- ConsensusProtocol --------------------------------------------
    @property
    def our_id(self) -> Any:
        return self.dhb.our_id

    @property
    def terminated(self) -> bool:
        return False

    @property
    def netinfo(self) -> NetworkInfo:
        return self.dhb.netinfo

    def handle_input(self, input: Any, rng: Any) -> Step:
        self._rng = rng
        if not isinstance(input, Input):
            input = Input.user(input)  # convenience: bare txn
        if input.kind == "change":
            step = self.dhb.vote_for(input.value, rng)
        else:
            # Validate at push: a bad transaction must fail HERE, not
            # epochs later when the queue happens to sample it.
            try:
                serde.dumps(input.value)
            except serde.EncodeError as e:
                raise ContributionNotEncodable(str(e)) from e
            self.queue.push(input.value)
            step = Step.empty()
        return step.extend(self._propose(rng))

    def push_transaction(self, txn: Any, rng: Any) -> Step:
        return self.handle_input(Input.user(txn), rng)

    def vote_for(self, change: Change, rng: Any) -> Step:
        return self.handle_input(Input.change(change), rng)

    def handle_message(self, sender: Any, message: Any, rng: Any) -> Step:
        self._rng = rng
        return self._absorb(self.dhb.handle_message(sender, message, rng), rng)

    # -- internals -----------------------------------------------------
    def _amount(self) -> int:
        n = max(1, self.dhb.netinfo.num_nodes)
        return max(1, self.batch_size // n)

    def _propose(self, rng: Any) -> Step:
        """Propose a fresh random sample unless this epoch already has one."""
        if not self.dhb.netinfo.is_validator() or self.dhb.has_input:
            return Step.empty()
        sample = self.queue.choose(rng, self._amount())
        return self._absorb(self.dhb.handle_input(sample, rng), rng)

    def _absorb(self, dhb_step: Step, rng: Any) -> Step:
        """Lift DHB batches: drop committed txns, re-propose if needed."""
        step = dhb_step
        batches: List[DhbBatch] = [o for o in step.output if isinstance(o, DhbBatch)]
        for batch in batches:
            committed: List[Any] = []
            for _, contrib in batch.contributions:
                if isinstance(contrib, (list, tuple)):
                    committed.extend(contrib)
            self.queue.remove_multiple(committed)
        if batches:
            # Always re-propose (an empty sample if the queue is drained):
            # Subset needs N-f proposals per epoch, so a node going quiet
            # would stall everyone (upstream QHB proposes every epoch too).
            step = step.extend(self._propose(rng))
        return step
