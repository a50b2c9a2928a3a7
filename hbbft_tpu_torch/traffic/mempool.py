"""Bounded per-node admission queue with pacing and dup suppression.

QueueingHoneyBadger commits empty epochs continuously, and an unpaced
feeder builds a transaction backlog that keeps epochs churning long
after the offered load stopped.  The
mempool sits between the traffic plane and ``ClusterNode.submit``
(i.e. in front of ``SenderQueue.push`` on the protocol thread) and
holds three rules:

* **bounded admission** — a deque capped at ``cap``; overflow drops
  the OLDEST queued transaction (counted, ``traffic.mempool_overflow``
  + an ``on_drop`` callback so the latency clock abandons it).  Oldest,
  not newest: under sustained overload the oldest queued transaction
  is the one whose latency target is already blown, and an open-loop
  client will resubmit what it still cares about.
* **duplicate suppression** — a transaction id is admitted at most
  once across queued / released-in-flight / recently-committed states
  (``traffic.dup_suppressed``).  The committed side is a bounded LRU
  (``committed_cache``), not an ever-growing set: resubmits arrive
  within a failure-recovery window, so a recency window is the right
  memory/coverage trade — evictions are counted
  (``traffic.committed_evicted``) so a too-small cache is visible.
* **pacing** — :meth:`pace` releases at most ``round_txns`` per
  committed batch plus an ``ahead`` allowance, keyed on the node's OWN
  committed count, with automatic rebase when that count goes
  backwards (the node was restarted with wiped state).

Single-writer by design: the traffic driver thread is the only caller
(admit/pace/mark_committed all mutate the same structures; the node's
``submit`` target is itself thread-safe).

Copy of ``hbbft_tpu/traffic/mempool.py``.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Tuple

from hbbft_tpu_torch.utils.metrics import Metrics


class Mempool:
    def __init__(
        self,
        submit: Callable[[Any], None],
        *,
        cap: int = 10_000,
        round_txns: int = 2,
        ahead: int = 3,
        committed_cache: int = 1 << 16,
        metrics: Optional[Metrics] = None,
        name: str = "traffic",
        on_drop: Optional[Callable[[str], None]] = None,
    ) -> None:
        if cap < 1 or round_txns < 1 or ahead < 0:
            raise ValueError("cap/round_txns >= 1 and ahead >= 0")
        self._submit = submit
        self.cap = cap
        self.round_txns = round_txns
        self.ahead = ahead
        self.metrics = metrics if metrics is not None else Metrics()
        self.name = name
        self.on_drop = on_drop
        self._queue: "collections.deque[Tuple[str, Any]]" = collections.deque()
        self._queued: set = set()
        # released to the node, commit not yet observed (txn kept for
        # the resubmit drill; bounded by pacing in steady state, and
        # drained by take_all() when a node dies holding some)
        self._released: Dict[str, Any] = {}
        # recently-committed LRU for resubmit suppression
        self._committed: "collections.OrderedDict[str, None]" = (
            collections.OrderedDict()
        )
        self._committed_cap = committed_cache
        self.released_count = 0
        # pacing base: rebased when the node's committed count resets
        self._base_released = 0
        self._base_committed = 0
        self._last_committed = 0

    # -- admission -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._queued)  # live entries (tombstones excluded)

    def admit(self, txn_id: str, txn: Any) -> bool:
        """Admit one transaction; False = suppressed as a duplicate.
        May shed the oldest queued transaction to stay under ``cap``."""
        if (
            txn_id in self._queued
            or txn_id in self._released
            or txn_id in self._committed
        ):
            self.metrics.count(f"{self.name}.dup_suppressed")
            return False
        while len(self._queued) >= self.cap:
            old_id, _ = self._queue.popleft()
            if old_id not in self._queued:
                continue  # tombstone (committed elsewhere while queued)
            self._queued.discard(old_id)
            self.metrics.count(f"{self.name}.mempool_overflow")
            if self.on_drop is not None:
                self.on_drop(old_id)
        self._queue.append((txn_id, txn))
        self._queued.add(txn_id)
        return True

    # -- pacing --------------------------------------------------------
    def pace(self, committed: int) -> int:
        """Release queued transactions against the node's committed
        batch count; returns how many were submitted this call.

        Budget: ``(committed_since_base + ahead) * round_txns``
        releases since base.  A committed count LOWER than the last
        one observed means the node restarted with wiped state — the
        budget is rebased so the fresh instance is fed again instead
        of being starved by the old instance's released total.
        """
        if committed < self._last_committed:
            self._base_released = self.released_count
            self._base_committed = committed
        self._last_committed = committed
        budget = (
            (committed - self._base_committed + self.ahead) * self.round_txns
        )
        n = 0
        while (
            self.released_count - self._base_released
        ) < budget and self._release_one():
            n += 1
        return n

    def _release_one(self) -> bool:
        """Release the next live queued transaction to the node (the
        ONE copy of the release bookkeeping — pace and flush_all both
        go through here).  False when nothing live is queued."""
        while self._queue:
            txn_id, txn = self._queue.popleft()
            if txn_id not in self._queued:
                continue  # tombstone (committed elsewhere while queued)
            self._queued.discard(txn_id)
            self._released[txn_id] = txn
            self.released_count += 1
            self._submit(txn)
            return True
        return False

    def flush_all(self) -> int:
        """Release EVERYTHING queued, ignoring the pacing budget, then
        rebase the budget so later :meth:`pace` calls are unaffected.
        This is the deterministic-workload (presubmit) mode — the
        whole point of pacing is moot when the workload is admitted
        before the cluster starts."""
        n = 0
        while self._release_one():
            n += 1
        self._base_released = self.released_count
        return n

    def force_rebase(self) -> None:
        """Rebase the pacing budget at the next :meth:`pace` call.  The
        driver calls this on exact restart detection (node identity
        changed) — a reborn node's committed count may never VISIBLY
        decrease if it climbed past the old count between polls, so the
        count-decrease heuristic inside pace() alone can compute the
        budget from the dead instance's base."""
        self._last_committed = float("inf")

    # -- commit / failure feedback ------------------------------------
    def mark_committed(self, txn_ids: List[str]) -> None:
        """Record observed commits (the driver fans every commit to ALL
        mempools, so the dup-suppression window is cluster-wide)."""
        for tid in txn_ids:
            self._released.pop(tid, None)
            # committed elsewhere while still queued here (a resubmit
            # raced its original): tombstone — pace()/admit() skip
            # deque entries whose id left _queued
            self._queued.discard(tid)
            self._committed[tid] = None
            self._committed.move_to_end(tid)
            while len(self._committed) > self._committed_cap:
                self._committed.popitem(last=False)
                self.metrics.count(f"{self.name}.committed_evicted")

    def inflight_count(self) -> int:
        """Released-but-uncommitted count (O(1): the driver sums this
        every poll tick — materializing the items just for len() is
        per-tick garbage)."""
        return len(self._released)

    def inflight_released(self) -> List[Tuple[str, Any]]:
        """Released-but-uncommitted transactions (what a client must
        consider resubmitting after this node dies)."""
        return list(self._released.items())

    def take_all(self) -> List[Tuple[str, Any]]:
        """Drain EVERYTHING (released in-flight first, then queued) —
        the full failover path when this mempool's node died.  A
        restarted node re-joins with wiped protocol state (era 0), and
        a plain restart has no JoinPlan, so routing held-back
        transactions to the reborn instance may never commit them;
        the traffic plane fails the whole backlog over instead."""
        out = list(self._released.items())
        self._released.clear()
        while self._queue:
            txn_id, txn = self._queue.popleft()
            if txn_id in self._queued:
                out.append((txn_id, txn))
        self._queued.clear()
        return out
