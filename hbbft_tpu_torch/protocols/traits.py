"""The universal state-machine contract.

Reference: upstream ``src/traits.rs`` + ``src/lib.rs`` (``ConsensusProtocol``
trait with associated types ``NodeId/Input/Output/Message/FaultKind``,
``Step`` as the sole side-effect channel, ``Target``/``TargetedMessage``
routing).  Fork checkout was empty at survey time; see SURVEY.md §2 #1.

Design deviations (batch-first, per SURVEY.md §7):

* ``Step`` is a plain dataclass with an explicit ``merge``; protocols build
  steps functionally.
* Cryptographic verification is *deferred*: protocols submit
  ``VerifyRequest``s to a :class:`hbbft_tpu_torch.crypto.pool.VerifyPool` and
  receive results through ``on_verified`` callbacks, so an epoch's worth of
  pairing checks can be flushed to the card as one batch (the north star in
  BASELINE.json:5).  With an eager flush policy the observable behavior is
  identical to the reference's inline verification.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Callable, FrozenSet, Generic, Iterable, List, TypeVar

from hbbft_tpu_torch.protocols.fault_log import FaultLog

N = TypeVar("N")  # NodeId type


@dataclass(frozen=True)
class Target:
    """Message routing directive without a transport.

    Reference: upstream ``Target::{All, AllExcept(set), Nodes(set)}``.
    (No ``slots=True`` here: the ``nodes`` field's slot descriptor would
    shadow the ``nodes()`` constructor.)
    """

    kind: str  # "all" | "all_except" | "nodes"
    nodes: FrozenSet[Any] = frozenset()

    ALL = "all"
    ALL_EXCEPT = "all_except"
    NODES = "nodes"

    @staticmethod
    def all() -> "Target":
        return _TARGET_ALL

    @staticmethod
    def all_except(nodes: Iterable[Any]) -> "Target":
        return Target(Target.ALL_EXCEPT, frozenset(nodes))

    @staticmethod
    def nodes(nodes: Iterable[Any]) -> "Target":
        return Target(Target.NODES, frozenset(nodes))

    @staticmethod
    def node(node: Any) -> "Target":
        return Target(Target.NODES, frozenset([node]))

    def recipients(self, all_ids: Iterable[Any], our_id: Any) -> List[Any]:
        """Expand to a concrete recipient list (excluding ourselves)."""
        if self.kind == Target.ALL:
            return [n for n in all_ids if n != our_id]
        if self.kind == Target.ALL_EXCEPT:
            return [n for n in all_ids if n != our_id and n not in self.nodes]
        return [n for n in self.nodes if n != our_id]


_TARGET_ALL = Target(Target.ALL)


@dataclass(frozen=True, slots=True)
class TargetedMessage:
    """An outgoing message with its routing directive."""

    target: Target
    message: Any


@dataclass(frozen=True, slots=True)
class SourcedMessage:
    """An incoming message tagged with its sender."""

    sender: Any
    message: Any


@dataclass(slots=True)
class Step:
    """The sole side-effect channel of every protocol handler.

    Reference: upstream ``Step{output, fault_log, messages}``.
    """

    output: List[Any] = field(default_factory=list)
    messages: List[TargetedMessage] = field(default_factory=list)
    fault_log: FaultLog = field(default_factory=FaultLog)

    @staticmethod
    def empty() -> "Step":
        return Step()

    def extend(self, other: "Step") -> "Step":
        """Merge ``other`` into self (in place), returning self."""
        if other.output:
            self.output.extend(other.output)
        if other.messages:
            self.messages.extend(other.messages)
        if other.fault_log.faults:
            self.fault_log.extend(other.fault_log)
        return self

    def with_output(self, out: Any) -> "Step":
        self.output.append(out)
        return self

    def map_messages(self, wrap: Callable[[Any], Any]) -> "Step":
        """Wrap every message payload IN PLACE and return self.

        This is how parent protocols lift child messages into their own
        message type (reference: ``Step::map`` in upstream ``src/traits.rs``).
        Output and fault log are carried through unchanged.  The caller
        must not reuse the un-wrapped step afterwards — every handler
        merges the result into a fresh parent step, and the copying
        version's per-message allocations dominated the control-plane
        profile at N=64.
        """
        msgs = self.messages
        for i, m in enumerate(msgs):
            msgs[i] = TargetedMessage(m.target, wrap(m.message))
        return self

    def broadcast(self, message: Any) -> "Step":
        self.messages.append(TargetedMessage(Target.all(), message))
        return self

    def send(self, node: Any, message: Any) -> "Step":
        self.messages.append(TargetedMessage(Target.node(node), message))
        return self

    def send_targeted(self, target: Target, message: Any) -> "Step":
        self.messages.append(TargetedMessage(target, message))
        return self

    def fault(self, node_id: Any, kind: str) -> "Step":
        self.fault_log.append_fault(node_id, kind)
        return self


class ConsensusProtocol(abc.ABC, Generic[N]):
    """Base contract for every protocol instance.

    Reference: upstream ``ConsensusProtocol`` trait (``handle_input``,
    ``handle_message``, ``terminated``, ``our_id``); name varies by
    revision (older: ``DistAlgorithm``).
    """

    @abc.abstractmethod
    def handle_input(self, input: Any, rng: Any) -> Step:
        """Process a local input (propose a value, cast a vote, ...)."""

    @abc.abstractmethod
    def handle_message(self, sender: N, message: Any, rng: Any) -> Step:
        """Process a message received from ``sender``."""

    @property
    @abc.abstractmethod
    def terminated(self) -> bool:
        """True once this instance will produce no further output."""

    @property
    @abc.abstractmethod
    def our_id(self) -> N:
        """Our own node id."""
