"""Structured Byzantine-evidence channel.

Reference: upstream ``src/fault_log.rs`` (``FaultLog``, ``Fault{node_id,
kind}``; per-module ``FaultKind`` enums).  Fork checkout empty at survey
time; see SURVEY.md §2 #3.

Every verification failure (bad Merkle proof, invalid signature share,
duplicate message, decoding failure) is recorded here instead of panicking
or silently dropping — the fault log is the framework's Byzantine-behavior
observable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator, List


@dataclass(frozen=True)
class Fault:
    node_id: Any
    kind: str

    def __repr__(self) -> str:  # compact in test output
        return f"Fault({self.node_id!r}, {self.kind})"


@dataclass
class FaultLog:
    faults: List[Fault] = field(default_factory=list)

    def append_fault(self, node_id: Any, kind: str) -> None:
        self.faults.append(Fault(node_id, kind))

    def append(self, fault: Fault) -> None:
        self.faults.append(fault)

    def extend(self, other: "FaultLog") -> None:
        self.faults.extend(other.faults)

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self) -> Iterator[Fault]:
        return iter(self.faults)

    def __bool__(self) -> bool:
        return bool(self.faults)
