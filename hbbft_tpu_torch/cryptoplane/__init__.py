"""Cluster crypto plane: the shared batched share-verification service
behind :class:`~hbbft_tpu_torch.crypto.backend.CryptoBackend`, in the
process of the nodes (:mod:`.service`) or in a process of its own behind
a socket RPC boundary (:mod:`.proc_service`).  Behind either,
:class:`~hbbft_tpu_torch.crypto.device.backend.TorchBackend` merges every
node's share checks into flushes on the card.

Copy of ``hbbft_tpu/cryptoplane/``.
"""

from hbbft_tpu_torch.cryptoplane.service import (
    CryptoPlaneService,
    DeviceFlushError,
    ServiceClient,
)
from hbbft_tpu_torch.cryptoplane.proc_service import (
    CryptoRpcServer,
    RpcServiceClient,
    ServiceProcess,
)

__all__ = [
    "CryptoPlaneService",
    "DeviceFlushError",
    "ServiceClient",
    "CryptoRpcServer",
    "RpcServiceClient",
    "ServiceProcess",
]
