"""Real socket transport + cluster runtime.

Runs hbbft nodes over actual TCP connections instead of the in-process
simulator: length-prefixed serde frames (:mod:`.framing`), a
selectors-based per-node event loop with backpressure, reconnect and
sendmsg vectored egress (:mod:`.transport`), and a thread-per-node
cluster harness (:mod:`.cluster`), engine-per-node cluster nodes
(:mod:`.native_node`), a process-per-node runtime (:mod:`.proc_cluster`
over :mod:`.cluster_worker`), and a deterministic byte-level fault
injector (:mod:`.faults`).

Copy of ``hbbft_tpu/transport/``.
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
from hbbft_tpu_torch.transport.native_node import NativeClusterNode
from hbbft_tpu_torch.transport.proc_cluster import ProcCluster
from hbbft_tpu_torch.transport.transport import PeerStats, TcpTransport

__all__ = [
    "ClusterNode",
    "LocalCluster",
    "NativeClusterNode",
    "ProcCluster",
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
