"""Subset (ACS): agree on a common subset of proposers' contributions.

Reference: upstream ``src/subset/{subset,proposal_state,message}.rs``
(SURVEY.md §2 #8).  One :class:`Broadcast` instance per proposer plus one
:class:`BinaryAgreement` per proposer, cross-wired:

* RBC delivery of proposer p's value => input True into BA_p.
* Once N - f BAs have decided True => input False into every undecided BA.
* Output = the contributions of every proposer whose BA decided True
  (emitted incrementally as ``SubsetOutput.contribution``; a final
  ``SubsetOutput.done`` marks termination).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from hbbft_tpu_torch.crypto.pool import VerifySink
from hbbft_tpu_torch.obs import trace as _trace
from hbbft_tpu_torch.protocols.binary_agreement import BinaryAgreement
from hbbft_tpu_torch.protocols.broadcast import Broadcast
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.traits import ConsensusProtocol, Step
from hbbft_tpu_torch.utils import canonical_bytes

FAULT_UNKNOWN_PROPOSER = "subset:unknown-proposer"
FAULT_BAD_MESSAGE = "subset:bad-message"

BC = "bc"
BA = "ba"


@dataclass(frozen=True)
class SubsetMessage:
    proposer: Any
    kind: str  # BC | BA
    inner: Any


@dataclass(frozen=True)
class SubsetOutput:
    """Incremental ACS output."""

    kind: str  # "contribution" | "done"
    proposer: Any = None
    value: Optional[bytes] = None

    @staticmethod
    def contribution(proposer: Any, value: bytes) -> "SubsetOutput":
        return SubsetOutput("contribution", proposer, value)

    @staticmethod
    def done() -> "SubsetOutput":
        return SubsetOutput("done")


class _Proposal:
    """Per-proposer state: the RBC + BA pair and its progress."""

    __slots__ = ("broadcast", "ba", "value", "decision", "emitted")

    def __init__(self, broadcast: Broadcast, ba: BinaryAgreement) -> None:
        self.broadcast = broadcast
        self.ba = ba
        self.value: Optional[bytes] = None
        self.decision: Optional[bool] = None
        self.emitted = False


class Subset(ConsensusProtocol):
    def __init__(
        self, netinfo: NetworkInfo, session_id: bytes, sink: VerifySink
    ) -> None:
        self._netinfo = netinfo
        self._session_id = bytes(session_id)
        self._sink = sink
        self._proposals: Dict[Any, _Proposal] = {}
        self._terminated = False
        self._done_emitted = False
        for pid in netinfo.all_ids:
            ba_sink = sink.scoped(lambda s, p=pid: self._on_ba_step(p, s))
            self._proposals[pid] = _Proposal(
                Broadcast(netinfo, pid),
                BinaryAgreement(
                    netinfo,
                    canonical_bytes(b"subset-ba", self._session_id, str(pid)),
                    ba_sink,
                ),
            )

    # -- ConsensusProtocol --------------------------------------------
    @property
    def our_id(self) -> Any:
        return self._netinfo.our_id

    @property
    def terminated(self) -> bool:
        return self._terminated

    def handle_input(self, input: bytes, rng: Any) -> Step:
        """Propose our contribution (any bytes)."""
        if not self._netinfo.is_validator() or self._terminated:
            return Step.empty()
        prop = self._proposals[self.our_id]
        return self._on_bc_step(self.our_id, prop.broadcast.handle_input(input, rng))

    def handle_message(self, sender: Any, message: SubsetMessage, rng: Any) -> Step:
        step = Step.empty()
        if self._terminated:
            return step
        if not isinstance(message, SubsetMessage):
            return step.fault(sender, FAULT_BAD_MESSAGE)
        try:
            known = message.proposer in self._proposals
        except TypeError:  # unhashable garbage proposer
            known = False
        if not known:
            return step.fault(sender, FAULT_UNKNOWN_PROPOSER)
        # Tracer context: leaf milestones (BA coin flips/rounds) emit
        # without knowing which proposer's instance they serve.
        _trace.set_ctx(proposer=message.proposer)
        prop = self._proposals[message.proposer]
        if message.kind == BC:
            return self._on_bc_step(
                message.proposer,
                prop.broadcast.handle_message(sender, message.inner, rng),
            )
        if message.kind == BA:
            return self._on_ba_step(
                message.proposer,
                prop.ba.handle_message(sender, message.inner, rng),
            )
        return step.fault(sender, FAULT_BAD_MESSAGE)

    # -- child-step processing ----------------------------------------
    def _on_bc_step(self, proposer: Any, bc_step: Step) -> Step:
        step = bc_step.map_messages(lambda m: SubsetMessage(proposer, BC, m))
        outputs, step.output = step.output, []
        prop = self._proposals[proposer]
        for value in outputs:
            if prop.value is None:
                prop.value = value
                _trace.emit("rbc.deliver", proposer=proposer)
                # Deliver => vote to include this proposer.
                step.extend(self._input_ba(proposer, True))
        step.extend(self._progress(proposer))
        return step

    def _on_ba_step(self, proposer: Any, ba_step: Step) -> Step:
        step = ba_step.map_messages(lambda m: SubsetMessage(proposer, BA, m))
        outputs, step.output = step.output, []
        prop = self._proposals[proposer]
        for decision in outputs:
            if prop.decision is None:
                prop.decision = bool(decision)
                step.extend(self._after_decision())
        step.extend(self._progress(proposer))
        return step

    def _input_ba(self, proposer: Any, value: bool) -> Step:
        prop = self._proposals[proposer]
        _trace.set_ctx(proposer=proposer)
        return self._on_ba_step(proposer, prop.ba.handle_input(value, None))

    def _after_decision(self) -> Step:
        """Apply the N - f rule and check completion."""
        step = Step.empty()
        accepted = sum(1 for p in self._proposals.values() if p.decision is True)
        if accepted >= self._netinfo.num_correct:
            for pid, prop in list(self._proposals.items()):
                if prop.decision is None and not prop.ba.terminated:
                    step.extend(self._input_ba(pid, False))
        return step

    def _progress(self, proposer: Any) -> Step:
        """Emit newly available contributions; emit done when complete."""
        step = Step.empty()
        if self._terminated:
            return step
        prop = self._proposals[proposer]
        if prop.decision is True and prop.value is not None and not prop.emitted:
            prop.emitted = True
            step.with_output(SubsetOutput.contribution(proposer, prop.value))
        if all(p.decision is not None for p in self._proposals.values()) and all(
            p.emitted or p.decision is False for p in self._proposals.values()
        ):
            if not self._done_emitted:
                self._done_emitted = True
                self._terminated = True
                step.with_output(SubsetOutput.done())
        return step
