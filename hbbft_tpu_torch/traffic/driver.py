"""TrafficDriver: clients → mempools → cluster → latency accounting.

One driver thread owns the whole traffic plane of a
:class:`~hbbft_tpu_torch.transport.cluster.LocalCluster`:

* pulls due arrivals from a :class:`~hbbft_tpu_torch.traffic.clients.
  ClientFleet` (open-loop: the offered rate never waits for commits);
* routes each transaction to a node (default: ``client_id % n`` — one
  home node per client, so a transaction enters exactly one
  TransactionQueue and exactly-once commits are the protocol's own
  property, not a dedup artifact);
* admits into that node's :class:`~hbbft_tpu_torch.traffic.mempool.Mempool`
  and opens the latency clock at admission — submit→commit latency
  INCLUDES mempool queueing time, which is the honest open-loop
  number (an overloaded cluster shows up as latency, not as silently
  reduced load);
* paces each mempool against its node's OWN committed batch count;
* polls every node's committed batches, attributes transactions back
  to their ids, closes latency clocks on FIRST sighting (the recorder
  pop is the first-sighting test), and fans committed ids to every
  mempool so duplicate suppression is cluster-wide.

The driver only uses the ClusterNode surface (``submit`` /
``batches``), as the reference's does over both of its node arms.

Two drive modes:

* :meth:`run_open_loop` — wall-clock arrivals for a duration, then
  :meth:`drain` until every admitted transaction committed (or
  timeout).  Throughput + latency percentiles are meaningful;
  cross-arm batch digests are NOT (pacing races the faster arm ahead).
* :meth:`run_presubmit` — a fixed deterministic workload admitted and
  released in full BEFORE ``cluster.start()``; both node arms at one
  seed commit byte-identical streams (the determinism recipe of the
  reference's config6, fed by the client fleet).  Latency clocks all
  start at release time, so percentiles from this mode measure commit ORDER, not
  client-visible latency — use it for identity checks and A/B
  digests, not for latency claims.

Copy of ``hbbft_tpu/traffic/driver.py`` over the port's
:class:`~hbbft_tpu_torch.traffic.latency.LatencyRecorder`.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from hbbft_tpu_torch.protocols.queueing_honey_badger import Input
from hbbft_tpu_torch.traffic.clients import ClientFleet, txn_id_of
from hbbft_tpu_torch.traffic.latency import LatencyRecorder
from hbbft_tpu_torch.traffic.mempool import Mempool
from hbbft_tpu_torch.utils.metrics import Metrics

#: One take_until sweep is bounded so a stalled driver thread cannot
#: materialize an unbounded arrival backlog in a single tick.
ARRIVALS_PER_TICK = 2_000


class TrafficDriver:
    def __init__(
        self,
        cluster: Any,
        fleet: ClientFleet,
        *,
        recorder: Optional[LatencyRecorder] = None,
        metrics: Optional[Metrics] = None,
        mempool_cap: int = 10_000,
        ahead: int = 3,
        round_txns: Optional[int] = None,
        assign: Optional[Callable[[int], int]] = None,
    ) -> None:
        self.cluster = cluster
        self.fleet = fleet
        self.recorder = recorder if recorder is not None else LatencyRecorder()
        # default: the cluster's own Metrics, so merged_metrics() shows
        # the traffic plane next to transport/cluster counters
        self.metrics = metrics if metrics is not None else cluster.metrics
        n = cluster.n
        if round_txns is None:
            # QHB proposes ~batch_size/N transactions per node per epoch
            round_txns = max(1, cluster._batch_size // n)
        self.round_txns = round_txns
        self.assign = assign if assign is not None else (lambda cid: cid % n)
        self.mempools: Dict[int, Mempool] = {
            i: Mempool(
                (lambda txn, _i=i: cluster.submit(_i, Input.user(txn))),
                cap=mempool_cap,
                round_txns=round_txns,
                ahead=ahead,
                metrics=self.metrics,
                on_drop=self.recorder.drop,
            )
            for i in cluster.nodes
        }
        self._consumed: Dict[int, int] = {i: 0 for i in cluster.nodes}
        # restart detection: kill()/restart() builds a FRESH node
        # object, so identity is the exact signal — a count-decrease
        # heuristic alone misses a reborn stream that climbed past the
        # old consumed offset between polls
        self._node_ref: Dict[int, Any] = dict(cluster.nodes)
        self.arrived = 0
        self.admitted = 0

    # -- plumbing ------------------------------------------------------
    def outstanding(self) -> int:
        """Admitted transactions not yet observed committed (queued in
        mempools + released to nodes)."""
        return sum(
            len(mp) + mp.inflight_count() for mp in self.mempools.values()
        )

    def _admit(self, cid: int, tid: str, txn: str, now: float) -> bool:
        self.arrived += 1
        node = self.assign(cid)
        if self.mempools[node].admit(tid, txn):
            self.admitted += 1
            self.recorder.submit(tid, now)
            return True
        return False

    def _check_restarts(self) -> None:
        """Exact restart detection, once per tick for BOTH consumers:
        kill()/restart() builds a fresh node object, so identity is the
        signal — the count-decrease heuristics in pace()/poll_commits
        alone miss a reborn stream that climbed past the old offset
        between polls."""
        for i in self.cluster.nodes:
            node = self.cluster.nodes[i]
            if node is not self._node_ref[i]:
                self._node_ref[i] = node
                self._consumed[i] = 0
                self.mempools[i].force_rebase()

    def pace_all(self) -> int:
        self._check_restarts()
        n = 0
        for i, mp in self.mempools.items():
            n += mp.pace(self.cluster.batch_count(i))
        return n

    def poll_commits(self, now: Optional[float] = None) -> int:
        """Scan every node's new batches; close latency clocks on first
        sighting and fan committed ids to all mempools.  Returns the
        number of transactions newly clocked."""
        if now is None:
            now = time.monotonic()
        self._check_restarts()
        newly = 0
        for i in self.cluster.nodes:
            if self.cluster.batch_count(i) < self._consumed[i]:
                # fallback for cluster impls that reuse the node object
                self._consumed[i] = 0
            # tail-only fetch: the full batch list grows forever (QHB
            # commits empty epochs continuously) and this runs every tick
            fresh = self.cluster.batches_from(i, self._consumed[i])
            self._consumed[i] += len(fresh)
            for b in fresh:
                ids: List[str] = []
                for _proposer, contrib in b.contributions:
                    if not isinstance(contrib, (list, tuple)):
                        continue
                    for txn in contrib:
                        if isinstance(txn, str):
                            ids.append(txn_id_of(txn))
                if not ids:
                    continue
                for tid in ids:
                    if self.recorder.commit(tid, now) is not None:
                        newly += 1
                for mp in self.mempools.values():
                    mp.mark_committed(ids)
        if newly:
            self.metrics.count("traffic.committed", newly)
        return newly

    def resubmit_lost(self, dead_id: int, to_id: int) -> int:
        """Fail a dead node's whole mempool backlog (released in-flight
        AND still-queued transactions) over to another node's mempool —
        the client resubmit path.  Duplicate suppression filters
        everything already observed committed; resubmitted transactions
        keep their ORIGINAL latency clock.  Let the survivors advance a
        couple of epochs and :meth:`poll_commits` BEFORE calling this,
        so commits the dead node's final proposals still produced are
        in the committed window and are not resubmitted.  (Queued
        transactions move too: a plain restart has no JoinPlan, so the
        reborn era-0 instance may never commit its own proposals.)"""
        moved = 0
        for tid, txn in self.mempools[dead_id].take_all():
            if self.mempools[to_id].admit(tid, txn):
                moved += 1
        if moved:
            self.metrics.count("traffic.resubmitted", moved)
        return moved

    # -- drive modes ---------------------------------------------------
    def run_open_loop(
        self,
        duration_s: float,
        *,
        poll_s: float = 0.02,
        drain_timeout_s: float = 45.0,
    ) -> Dict[str, Any]:
        """Offer the fleet's load for ``duration_s`` wall seconds, then
        drain.  Returns a summary dict (also exported via metrics)."""
        t0 = time.monotonic()
        while True:
            now = time.monotonic()
            el = now - t0
            if el >= duration_s:
                break
            for _vt, cid, tid, txn in self.fleet.take_until(
                el, limit=ARRIVALS_PER_TICK
            ):
                self._admit(cid, tid, txn, now)
            self.pace_all()
            self.poll_commits(time.monotonic())
            time.sleep(poll_s)
        self.drain(drain_timeout_s, poll_s=poll_s)
        wall = time.monotonic() - t0
        self.export_metrics()
        return {
            "wall_s": wall,
            "arrived": self.arrived,
            "admitted": self.admitted,
            "committed": self.recorder.committed,
            "outstanding": self.outstanding(),
        }

    def drain(self, timeout_s: float, poll_s: float = 0.02) -> bool:
        """Keep pacing/polling (no new arrivals) until every admitted
        transaction is observed committed; False on timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.pace_all()
            self.poll_commits()
            if self.outstanding() == 0:
                return True
            time.sleep(poll_s)
        self.pace_all()
        self.poll_commits()
        return self.outstanding() == 0

    def run_presubmit(self, total_txns: int) -> List[str]:
        """Deterministic-workload mode: admit + release the first
        ``total_txns`` fleet arrivals in full, BEFORE the cluster
        starts, so every arm's proposers see identical queues (cross-
        arm byte-identity).  Returns the admitted txn ids; the caller
        starts the cluster and then uses :meth:`drain`."""
        assert not self.cluster._started, "presubmit before cluster.start()"
        now = time.monotonic()
        ids: List[str] = []
        for _vt, cid, tid, txn in self.fleet.take(total_txns):
            if self._admit(cid, tid, txn, now):
                ids.append(tid)
        for mp in self.mempools.values():
            mp.flush_all()
        return ids

    # -- observability -------------------------------------------------
    def export_metrics(self) -> None:
        self.recorder.export(self.metrics)
        self.metrics.gauge("traffic.outstanding", self.outstanding())
        self.metrics.gauge("traffic.arrived", self.arrived)
        self.metrics.gauge("traffic.admitted", self.admitted)
