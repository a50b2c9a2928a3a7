"""Traffic plane: open-loop clients, mempools, submit→commit latency.

Seeded open-loop client fleets (:mod:`.clients`), bounded per-node
mempools with duplicate suppression and commit-paced release
(:mod:`.mempool`), bounded-memory latency percentiles (:mod:`.latency`),
and the driver tying them to a live
:class:`~hbbft_tpu_torch.transport.cluster.LocalCluster` (:mod:`.driver`).
WAN link shapes live with the rest of the fault machinery
(:func:`hbbft_tpu_torch.transport.faults.wan_profile`).

Copy of ``hbbft_tpu/traffic/``.
"""

from hbbft_tpu_torch.traffic.clients import (
    ClientFleet,
    OpenLoopClient,
    make_txn,
    txn_id_of,
)
from hbbft_tpu_torch.traffic.driver import TrafficDriver
from hbbft_tpu_torch.traffic.latency import (
    QUANTILES,
    LatencyHistogram,
    LatencyRecorder,
)
from hbbft_tpu_torch.traffic.mempool import Mempool

__all__ = [
    "ClientFleet",
    "OpenLoopClient",
    "make_txn",
    "txn_id_of",
    "TrafficDriver",
    "QUANTILES",
    "LatencyHistogram",
    "LatencyRecorder",
    "Mempool",
]
