"""Safety/liveness oracles for Byzantine cluster runs.

The oracle contract — what a chaos run must uphold, checked over the
HONEST nodes of a :class:`~hbbft_tpu_torch.transport.cluster.LocalCluster`
built with a ``byzantine`` map:

* **safety** — every honest node's committed batch stream is
  byte-identical over the common prefix (``assert_safety``;
  :func:`batches_sha` digests a stream);
* **liveness** — honest commit counts keep growing inside the standard
  45 s phase caps (``assert_progress`` — the paced
  ``LocalCluster.drive_to`` under the hood, with an optional ``tick``
  for pumping a :class:`~hbbft_tpu_torch.chaos.scheduler.ChaosRunner`);
* **exactly-once** — traffic-plane transactions appear at most once in
  every honest node's committed stream, and every admitted transaction
  was observed committed (``assert_exactly_once`` over a
  :class:`~hbbft_tpu_torch.traffic.driver.TrafficDriver`);
* **attribution** — honest fault logs name ONLY Byzantine ids: the
  evidence channel never frames an honest node
  (``assert_attribution``).  Both node arms are read — the Python
  node's ``Step.fault_log`` entries and the native node's engine fault
  vector (``hbe_fault_subject``/``hbe_fault_kind``) — through one
  :func:`fault_entries` view.

Attribution caveat: injected frame *duplication* (``dup_p``) makes
honest peers deliver duplicates, which some protocol layers log as
faults against the (honest) sender.  Chaos schedules therefore compose
with dup-free link shapes (``wan``); put duplication on Byzantine
links only if attribution is being asserted.

Copy of ``hbbft_tpu/chaos/oracle.py``.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, List, Optional, Tuple

from hbbft_tpu_torch.traffic.clients import txn_id_of
from hbbft_tpu_torch.utils import serde


def batch_keys(cluster: Any, nid: int, upto: Optional[int] = None) -> List[tuple]:
    bs = cluster.batches(nid)
    if upto is not None:
        bs = bs[:upto]
    return [(b.era, b.epoch, serde.dumps(b.contributions)) for b in bs]


def batches_sha(cluster: Any, nid: int, upto: Optional[int] = None) -> str:
    """SHA-256 digest of one node's committed stream (the cross-node
    identity handle)."""
    h = hashlib.sha256()
    for era, epoch, contrib in batch_keys(cluster, nid, upto):
        h.update(serde.dumps((era, epoch)))
        h.update(contrib)
    return h.hexdigest()


def fault_entries(node: Any) -> List[Tuple[Any, str]]:
    """(subject, kind) fault entries of one cluster node, either arm."""
    eng = getattr(node, "engine", None)
    if eng is not None:  # native arm: the engine's fault vector
        return eng.faults(node.id)
    return [(f.node_id, f.kind) for f in node.faults]


def stream_txns(cluster: Any, nid: int) -> List[str]:
    """All transactions in node ``nid``'s committed stream, in order."""
    out: List[str] = []
    for b in cluster.batches(nid):
        for _proposer, contrib in b.contributions:
            if isinstance(contrib, (list, tuple)):
                out.extend(t for t in contrib if isinstance(t, str))
    return out


class ChaosOracle:
    """Safety/liveness/exactly-once/attribution checks over the honest
    side of a Byzantine cluster.  Raises ``AssertionError`` with a
    named verdict on violation; check methods return evidence (prefix
    length, fault counts) for the caller's own assertions."""

    def __init__(self, cluster: Any, driver: Any = None) -> None:
        self.cluster = cluster
        self.byzantine_ids = frozenset(cluster.byzantine)
        self.honest_ids = list(cluster.honest_ids)
        self.driver = driver

    # -- safety --------------------------------------------------------
    def assert_safety(self, min_prefix: int = 1) -> int:
        """Honest streams agree byte-for-byte over the common prefix;
        returns the prefix length (>= ``min_prefix``)."""
        keys = {i: batch_keys(self.cluster, i) for i in self.honest_ids}
        k = min(len(v) for v in keys.values())
        if k < min_prefix:
            raise AssertionError(
                f"SAFETY(vacuous): honest common prefix {k} < {min_prefix}"
            )
        ref_id = self.honest_ids[0]
        ref = keys[ref_id][:k]
        for i in self.honest_ids[1:]:
            if keys[i][:k] != ref:
                d = next(
                    j for j in range(k) if keys[i][j] != ref[j]
                )
                raise AssertionError(
                    f"SAFETY: honest nodes {ref_id} and {i} diverge at "
                    f"batch {d} ({ref[d][:2]} vs {keys[i][d][:2]})"
                )
        return k

    # -- liveness ------------------------------------------------------
    def assert_progress(
        self,
        extra: int = 2,
        timeout_s: float = 45.0,
        tick: Optional[Callable[[], Any]] = None,
        tag: str = "oracle",
    ) -> int:
        """Honest nodes commit >= ``extra`` MORE batches within the
        phase cap (paced drive; raises TimeoutError on a stall).
        Returns the new minimum honest commit count."""
        base = min(self.cluster.batch_count(i) for i in self.honest_ids)
        self.cluster.drive_to(
            self.honest_ids, base + extra, timeout_s=timeout_s, tag=tag,
            tick=tick,
        )
        return min(self.cluster.batch_count(i) for i in self.honest_ids)

    # -- exactly-once --------------------------------------------------
    def assert_exactly_once(self) -> int:
        """Every honest committed stream is duplicate-free, and every
        admitted traffic transaction was observed committed (call after
        ``driver.drain()``).  Returns the committed count."""
        assert self.driver is not None, "exactly-once needs a TrafficDriver"
        d = self.driver
        if d.outstanding() != 0:
            raise AssertionError(
                f"EXACTLY-ONCE: {d.outstanding()} admitted txns never "
                "observed committed (drain incomplete?)"
            )
        for i in self.honest_ids:
            txns = stream_txns(self.cluster, i)
            if len(txns) != len(set(txns)):
                dup = sorted(
                    t for t in set(txns) if txns.count(t) > 1
                )[:4]
                raise AssertionError(
                    f"EXACTLY-ONCE: node {i} committed duplicates {dup}"
                )
        return d.recorder.committed

    def committed_ids(self, nid: int) -> set:
        return {txn_id_of(t) for t in stream_txns(self.cluster, nid)}

    # -- attribution ---------------------------------------------------
    def assert_attribution(self) -> int:
        """No honest fault log names a non-Byzantine subject; returns
        the total number of fault entries naming Byzantine ids (the
        caller asserts > 0 when the strategy should be detectable)."""
        named = 0
        for i in self.honest_ids:
            for subject, kind in fault_entries(self.cluster.nodes[i]):
                if subject in self.byzantine_ids:
                    named += 1
                else:
                    raise AssertionError(
                        f"ATTRIBUTION: honest node {i} logged {kind!r} "
                        f"against non-Byzantine {subject!r}"
                    )
        return named

    # -- composite -----------------------------------------------------
    def check_all(
        self,
        extra: int = 2,
        timeout_s: float = 45.0,
        tick: Optional[Callable[[], Any]] = None,
    ) -> dict:
        """Progress, then safety + attribution (+ exactly-once when a
        driver is attached); returns the evidence dict benchmarks
        embed in their JSON lines."""
        committed = self.assert_progress(
            extra=extra, timeout_s=timeout_s, tick=tick
        )
        # One safety pass: the cluster keeps committing while we look,
        # so a second assert_safety() could see a longer prefix than
        # the one the sha is reported for (and re-digests every stream).
        prefix = self.assert_safety()
        out = {
            "honest_committed_min": committed,
            "safety_prefix": prefix,
            "byzantine_faults_named": self.assert_attribution(),
            "batches_sha": batches_sha(
                self.cluster, self.honest_ids[0], upto=prefix
            ),
        }
        if self.driver is not None:
            out["exactly_once_committed"] = self.assert_exactly_once()
        return out
