"""Deterministic open-loop transaction generators.

A presubmitted fixed workload models no *clients*.  This module is the
arrival process of the traffic plane: many simulated users, each a seeded :class:`OpenLoopClient`
emitting tagged transactions at a Poisson or fixed rate, merged into
one deterministic arrival stream by :class:`ClientFleet`.

Open-loop means arrivals never wait for commits — the load offered to
the cluster is a property of the clients, not of the cluster's speed
(the closed-loop alternative hides overload by slowing the offered
rate down to whatever the system sustains).  Backpressure is the
*mempool's* job (:mod:`hbbft_tpu_torch.traffic.mempool`): the arrival stream
here is pure data.

Transaction format: ``"c{client}.{seq}"`` (+ ``"#"`` padding when a
payload size is requested), so every committed transaction is
attributable back to exactly one (client, seq) pair — the handle the
submit→commit latency clock keys on.  Plain strings: they serde-encode
(``QueueingHoneyBadger`` validates at push) and compare across the
Python and native node arms byte-identically.

Clocks: arrival timestamps are virtual seconds from stream start.  A
wall-clock driver releases arrivals whose timestamp has elapsed
(:meth:`ClientFleet.take_until`); a deterministic workload takes the
first n arrivals with no clock at all (:meth:`ClientFleet.take` — the
mode cross-arm byte-identity tests use).

Copy of ``hbbft_tpu/traffic/clients.py``: the same arrival stream for the
same seed.
"""

from __future__ import annotations

import heapq
import random
from typing import List, Optional, Tuple


def txn_id_of(txn: str) -> str:
    """The attributable id of a traffic-plane transaction (strips the
    payload padding).  Foreign transactions pass through unchanged —
    callers treat unknown ids as not-ours."""
    return txn.split("#", 1)[0]


def make_txn(client: int, seq: int, payload_len: int = 0) -> str:
    tid = f"c{client}.{seq}"
    if payload_len > 0:
        return tid + "#" + "x" * payload_len
    return tid


class OpenLoopClient:
    """One simulated user: seeded arrival process + monotone sequence.

    ``arrival="poisson"`` draws i.i.d. exponential interarrivals (mean
    ``1/rate_tps``); ``"fixed"`` emits exactly every ``1/rate_tps``
    virtual seconds.  The rng is seeded by ``(seed, client_id)`` so a
    fleet's stream is reproducible client-by-client regardless of how
    the merge interleaves draws.
    """

    def __init__(
        self,
        client_id: int,
        rate_tps: float,
        seed: int = 0,
        arrival: str = "poisson",
        payload_len: int = 0,
    ) -> None:
        if rate_tps <= 0:
            raise ValueError("rate_tps must be > 0")
        if arrival not in ("poisson", "fixed"):
            raise ValueError(f"unknown arrival process {arrival!r}")
        self.client_id = client_id
        self.rate_tps = rate_tps
        self.arrival = arrival
        self.payload_len = payload_len
        self._rng = random.Random(f"traffic-client|{seed}|{client_id}")
        self._t = 0.0
        self._seq = 0

    def next(self) -> Tuple[float, str, str]:
        """The next arrival: ``(virtual_time_s, txn_id, txn)``."""
        if self.arrival == "poisson":
            self._t += self._rng.expovariate(self.rate_tps)
        else:
            self._t += 1.0 / self.rate_tps
        txn = make_txn(self.client_id, self._seq, self.payload_len)
        self._seq += 1
        return (self._t, txn_id_of(txn), txn)


class ClientFleet:
    """Many clients merged into one deterministic arrival stream.

    The merge is a heap on ``(virtual_time, client_id)`` — client id
    breaks timestamp ties — so the stream order is a pure function of
    ``(num_clients, rate, seed, arrival)``: the property the
    deterministic-workload byte-identity tests stand on.
    """

    def __init__(
        self,
        num_clients: int,
        rate_tps_each: float,
        seed: int = 0,
        arrival: str = "poisson",
        payload_len: int = 0,
    ) -> None:
        if num_clients < 1:
            raise ValueError("num_clients must be >= 1")
        self.clients = [
            OpenLoopClient(
                cid, rate_tps_each, seed=seed, arrival=arrival,
                payload_len=payload_len,
            )
            for cid in range(num_clients)
        ]
        # one buffered next-arrival per client, merged lazily
        self._heap: List[Tuple[float, int, str, str]] = []
        for c in self.clients:
            t, tid, txn = c.next()
            heapq.heappush(self._heap, (t, c.client_id, tid, txn))

    @property
    def offered_tps(self) -> float:
        return sum(c.rate_tps for c in self.clients)

    def _pop(self) -> Tuple[float, int, str, str]:
        t, cid, tid, txn = heapq.heappop(self._heap)
        nt, ntid, ntxn = self.clients[cid].next()
        heapq.heappush(self._heap, (nt, cid, ntid, ntxn))
        return (t, cid, tid, txn)

    def take_until(
        self, t: float, limit: Optional[int] = None
    ) -> List[Tuple[float, int, str, str]]:
        """All arrivals with virtual timestamp <= ``t`` (wall-clock
        drivers call this each poll tick).  ``limit`` bounds one call
        so a stalled driver cannot materialize an unbounded backlog in
        one sweep — the remainder stays buffered for the next tick."""
        out: List[Tuple[float, int, str, str]] = []
        while self._heap[0][0] <= t:
            out.append(self._pop())
            if limit is not None and len(out) >= limit:
                break
        return out

    def take(self, n: int) -> List[Tuple[float, int, str, str]]:
        """The first ``n`` arrivals in stream order (virtual clock only
        — the deterministic-workload mode)."""
        return [self._pop() for _ in range(n)]
