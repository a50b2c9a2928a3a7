"""Traffic plane: bounded-memory latency clocks.

Copy of the part of ``hbbft_tpu/traffic/`` that the crypto-plane service
imports (:mod:`.latency`).  The open-loop clients, the mempools and the
traffic driver are not part of this package yet (ROADMAP Queue 1).
"""

from hbbft_tpu_torch.traffic.latency import (
    QUANTILES,
    LatencyHistogram,
    LatencyRecorder,
)

__all__ = ["QUANTILES", "LatencyHistogram", "LatencyRecorder"]
