"""Per-transaction submit→commit latency with bounded memory.

The latency price of decrypt-after-order designs (PAPERS.md, arxiv
2407.12172) is only visible with a per-transaction clock: throughput
numbers cannot distinguish "fast epochs" from "transactions waiting
three extra rounds for threshold decryption".  This module is that
clock, built to run unattended next to a live cluster:

* :class:`LatencyHistogram` — log-spaced buckets (HDR style): O(1)
  insert, fixed memory, ~7% relative quantile error across seven
  decades.  No raw-observation list anywhere.
* :class:`LatencyRecorder` — the submit→commit pairing: a bounded
  in-flight map (txn_id → submit time, O(1) per transaction in
  flight, capped overall — past the cap new transactions are counted
  ``untracked`` and simply not clocked, never buffered), committing
  into the histogram, exporting through
  :meth:`hbbft_tpu_torch.utils.metrics.Metrics.summary`.

The recorder is intentionally single-writer (the traffic driver
thread): commit attribution must pair a pop with an observe, and the
driver is the only component that sees both sides.

Copy of ``hbbft_tpu/traffic/latency.py``.  The crypto-plane service
keeps its batch-size distribution in a :class:`LatencyHistogram`.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

from hbbft_tpu_torch.utils.metrics import Metrics

#: Default quantiles every export publishes (the config7 JSON line and
#: the Prometheus summary share these).
QUANTILES: Tuple[float, ...] = (0.5, 0.9, 0.99)


class LatencyHistogram:
    """Log-bucketed streaming histogram: fixed memory, O(1) observe.

    Buckets are geometric: bucket k covers ``[lo * growth^k,
    lo * growth^(k+1))``, so the quantile estimate's relative error is
    bounded by ``growth - 1`` (~7% at the default) at every scale —
    the HDR-histogram idea without the library.  Values below ``lo``
    land in bucket 0; values above ``hi`` land in the last bucket;
    exact ``min``/``max`` are tracked separately and clamp the
    estimates, so the tails are never reported wider than observed.
    """

    def __init__(
        self, lo: float = 1e-4, hi: float = 3.6e3, growth: float = 1.07
    ) -> None:
        if not (0 < lo < hi) or growth <= 1.0:
            raise ValueError("need 0 < lo < hi and growth > 1")
        self._lo = lo
        self._log_growth = math.log(growth)
        self._growth = growth
        nbuckets = int(math.ceil(math.log(hi / lo) / self._log_growth)) + 1
        self._counts = [0] * nbuckets
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0

    def __len__(self) -> int:  # bounded-memory assertion hook
        return len(self._counts)

    def observe(self, v: float) -> None:
        v = max(v, 0.0)
        if v <= self._lo:
            k = 0
        else:
            k = int(math.log(v / self._lo) / self._log_growth)
            if k >= len(self._counts):
                k = len(self._counts) - 1
        self._counts[k] += 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1] (0.0 when empty)."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for k, c in enumerate(self._counts):
            cum += c
            if cum >= rank:
                # geometric midpoint of the bucket, clamped to the
                # exact observed range
                mid = self._lo * (self._growth ** (k + 0.5))
                return min(max(mid, self.min), self.max)
        return self.max  # unreachable; defensive

    def quantiles(
        self, qs: Iterable[float] = QUANTILES
    ) -> Dict[float, float]:
        return {q: self.quantile(q) for q in qs}


class LatencyRecorder:
    """Pairs submits with commits; everything bounded.

    ``submit(txn_id, now)`` opens the clock for one transaction (False
    + ``untracked`` count when the in-flight cap is hit, or when the
    id is already open — a resubmit keeps its ORIGINAL submit time:
    end-to-end latency includes the failure the resubmit recovered
    from).  ``commit(txn_id, now)`` closes it and returns the latency,
    or None for ids not in flight (already committed, or never
    tracked) — which is exactly the driver's first-sighting test, so
    duplicate commit observations across N nodes' batch streams clock
    each transaction once.  ``drop(txn_id)`` abandons the clock for a
    transaction the mempool shed.
    """

    def __init__(
        self,
        max_inflight: int = 1 << 16,
        hist: Optional[LatencyHistogram] = None,
    ) -> None:
        self.max_inflight = max_inflight
        self.hist = hist if hist is not None else LatencyHistogram()
        self._inflight: Dict[str, float] = {}
        self.submitted = 0
        self.committed = 0
        self.dropped = 0
        self.untracked = 0

    def inflight(self) -> int:
        return len(self._inflight)

    def submit(self, txn_id: str, now: float) -> bool:
        if txn_id in self._inflight:
            return False  # resubmit: keep the original clock
        if len(self._inflight) >= self.max_inflight:
            self.untracked += 1
            return False
        self._inflight[txn_id] = now
        self.submitted += 1
        return True

    def commit(self, txn_id: str, now: float) -> Optional[float]:
        t0 = self._inflight.pop(txn_id, None)
        if t0 is None:
            return None
        dt = max(now - t0, 0.0)
        self.hist.observe(dt)
        self.committed += 1
        return dt

    def drop(self, txn_id: str) -> None:
        if self._inflight.pop(txn_id, None) is not None:
            self.dropped += 1

    def export(
        self,
        m: Metrics,
        name: str = "traffic.latency_s",
        qs: Iterable[float] = QUANTILES,
    ) -> None:
        """Publish the current percentile snapshot + flow gauges (all
        derived from ``name``, so multiple recorders exported under
        distinct names never clobber each other's gauges)."""
        m.summary(name, self.hist.quantiles(qs), self.hist.count,
                  self.hist.total)
        m.gauge(f"{name}.max", self.hist.max if self.hist.count else 0.0)
        m.gauge(f"{name}.inflight", len(self._inflight))
        m.gauge(f"{name}.untracked", self.untracked)
