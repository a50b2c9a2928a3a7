"""Seeded chaos schedules: Byzantine × link faults × churn, composed.

A schedule is a time-budgeted list of :class:`ChaosEvent`s fired
against a live :class:`~hbbft_tpu_torch.transport.cluster.LocalCluster`:
kill/restart (process death + rebirth), disconnect/reconnect (network
outage around a live process), partition/heal (injector windows).  The
WAN link *shape* composes orthogonally — it lives in the
:class:`~hbbft_tpu_torch.transport.faults.FaultInjector` the cluster was
built with (``wan_profile``), while this module drives the injector's
partition windows dynamically.

**Fault-budget discipline:** every disruptive event targets a
BYZANTINE id.  The Byzantine nodes already spend the cluster's f
budget; killing or isolating an honest node on top would exceed 3f+1
tolerance and make a liveness assertion vacuous (any stall would be
"expected").  Composed chaos therefore means: the adversary nodes
misbehave AND churn AND get partitioned, over WAN-shaped links, while
the honest quorum must keep committing — which is exactly the claim
HoneyBadgerBFT makes.

Determinism: :func:`build_schedule` is a pure function of its seed (a
dedicated ``random.Random`` stream, no wall clock), so a chaos test
names its scenario by ``(seed, duration)`` alone.  Event *firing*
happens at wall offsets from :meth:`ChaosRunner.start` — coarse
seconds, like the injector's partition windows.

Copy of ``hbbft_tpu/chaos/scheduler.py``.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Sequence

from hbbft_tpu_torch.transport.faults import PartitionSpec

#: Event kinds that need a later counter-event to restore liveness.
_PAIRED = {"kill": "restart", "disconnect": "reconnect", "partition": "heal"}


@dataclass(frozen=True)
class ChaosEvent:
    at_s: float          # offset from runner start
    kind: str            # kill | restart | disconnect | reconnect | partition | heal
    node: Optional[int] = None


def build_schedule(
    seed: int,
    byzantine_ids: Sequence[int],
    duration_s: float,
    *,
    churn: bool = True,
    outage: bool = False,
    partition: bool = True,
) -> List[ChaosEvent]:
    """One composed schedule inside ``[0, duration_s]``: optionally a
    kill→restart, a disconnect→reconnect, and a partition→heal, each
    against a seeded-chosen Byzantine id, at seeded offsets.  Pure in
    ``seed`` — same seed, same schedule."""
    rng = random.Random(f"chaos-schedule|{seed}")
    ids = sorted(byzantine_ids)
    ev: List[ChaosEvent] = []
    if not ids:
        return ev

    def pick() -> int:
        return ids[rng.randrange(len(ids))]

    if churn:
        t0 = duration_s * (0.10 + 0.15 * rng.random())
        dt = duration_s * (0.10 + 0.15 * rng.random())
        v = pick()
        ev += [ChaosEvent(t0, "kill", v), ChaosEvent(t0 + dt, "restart", v)]
    if outage:
        t0 = duration_s * (0.35 + 0.15 * rng.random())
        dt = duration_s * (0.08 + 0.12 * rng.random())
        v = pick()
        ev += [
            ChaosEvent(t0, "disconnect", v),
            ChaosEvent(t0 + dt, "reconnect", v),
        ]
    if partition:
        t0 = duration_s * (0.55 + 0.15 * rng.random())
        dt = duration_s * (0.10 + 0.15 * rng.random())
        v = pick()
        ev += [ChaosEvent(t0, "partition", v), ChaosEvent(t0 + dt, "heal", v)]
    return sorted(ev, key=lambda e: (e.at_s, e.kind, e.node))


class ChaosRunner:
    """Fires a schedule against a cluster from the driving thread.

    No thread of its own: the test/benchmark loop calls :meth:`pump`
    each tick (``LocalCluster.drive_to(..., tick=runner.pump)`` wires
    it into the standard paced drive), and :meth:`drain` at the end of
    the window fires whatever is left immediately — every restorative
    counter-event (restart/reconnect/heal) is guaranteed to run, so a
    timeout can never strand the cluster mid-fault.
    """

    def __init__(
        self,
        cluster: Any,
        schedule: Iterable[ChaosEvent],
        injector: Any = None,
    ) -> None:
        self.cluster = cluster
        self.schedule = sorted(schedule, key=lambda e: (e.at_s, e.kind))
        self.injector = injector
        if injector is None and any(
            e.kind in ("partition", "heal") for e in self.schedule
        ):
            raise ValueError(
                "schedule contains partition/heal events but the runner "
                "was given no FaultInjector"
            )
        self._i = 0
        self._t0: Optional[float] = None
        self.fired: List[ChaosEvent] = []

    def start(self) -> None:
        if self._t0 is None:
            self._t0 = time.monotonic()

    def pending(self) -> int:
        return len(self.schedule) - self._i

    def pump(self) -> bool:
        """Fire every due event; True while any event remains."""
        if self._t0 is None:
            self.start()
        now = time.monotonic() - self._t0
        while self._i < len(self.schedule) and self.schedule[self._i].at_s <= now:
            self._fire(self.schedule[self._i])
            self._i += 1
        return self._i < len(self.schedule)

    def drain(self) -> None:
        """Fire all remaining events NOW, in schedule order."""
        while self._i < len(self.schedule):
            self._fire(self.schedule[self._i])
            self._i += 1

    def _fire(self, e: ChaosEvent) -> None:
        c = self.cluster
        # Flight recorder: chaos disruptions land on the cluster track so
        # the trace shows the fault window next to the nodes' recovery.
        buf = getattr(c, "trace", None)
        if buf is not None:
            buf.emit(f"chaos.{e.kind}", node=e.node, at_s=e.at_s)
        if e.kind == "kill":
            c.kill(e.node)
        elif e.kind == "restart":
            c.restart(e.node)
        elif e.kind == "disconnect":
            c.disconnect(e.node)
        elif e.kind == "reconnect":
            c.reconnect(e.node)
        elif e.kind == "partition":
            groups = (
                frozenset(i for i in c.nodes if i != e.node),
                frozenset([e.node]),
            )
            self.injector.add_partition(
                PartitionSpec(groups, start_s=self.injector.elapsed())
            )
        elif e.kind == "heal":
            self.injector.heal_all()
        else:  # pragma: no cover - schedule construction is closed
            raise ValueError(f"unknown chaos event kind {e.kind!r}")
        self.fired.append(e)
