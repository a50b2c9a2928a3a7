"""Real socket transport + cluster runtime.

Runs hbbft nodes over actual TCP connections instead of the in-process
simulator: length-prefixed serde frames (:mod:`.framing`), a
selectors-based per-node event loop with backpressure, reconnect and
sendmsg vectored egress (:mod:`.transport`), and a thread-per-node
cluster harness (:mod:`.cluster`).

Copy of ``hbbft_tpu/transport/`` for Python nodes, with the
deterministic byte-level fault injector (:mod:`.faults`).  The
process-per-node runtime (``proc_cluster.py``, ``cluster_worker.py``) and
the native node (``native_node.py``) wait for ROADMAP.md Queue 1's
process-per-node and native-engine items.
"""

from hbbft_tpu_torch.transport.cluster import ClusterNode, LocalCluster
from hbbft_tpu_torch.transport.faults import (
    FaultInjector,
    FaultStats,
    LinkFaults,
    PartitionSpec,
    wan_profile,
)
from hbbft_tpu_torch.transport.framing import (
    KIND_HELLO,
    KIND_MSG,
    KIND_MSGB,
    MAX_FRAME_LEN,
    PROTO_VERSION,
    RECV_CHUNK,
    FrameDecoder,
    FrameError,
    decode_hello,
    decode_msgb,
    encode_frame,
    encode_hello,
    encode_msgb,
    frame_message_count,
    msgb_body,
    validate_msgb,
)
from hbbft_tpu_torch.transport.transport import PeerStats, TcpTransport

__all__ = [
    "ClusterNode",
    "LocalCluster",
    "FaultInjector",
    "FaultStats",
    "LinkFaults",
    "PartitionSpec",
    "wan_profile",
    "KIND_HELLO",
    "KIND_MSG",
    "KIND_MSGB",
    "MAX_FRAME_LEN",
    "PROTO_VERSION",
    "RECV_CHUNK",
    "FrameDecoder",
    "FrameError",
    "decode_hello",
    "decode_msgb",
    "encode_frame",
    "encode_hello",
    "encode_msgb",
    "frame_message_count",
    "msgb_body",
    "validate_msgb",
    "PeerStats",
    "TcpTransport",
]
