"""Protocol plane: pure host-side state machines.

Every protocol is a deterministic state machine consuming ``(sender,
message)`` pairs and inputs and emitting a :class:`~hbbft_tpu_torch.protocols.
traits.Step`.  No I/O, no threads, no clock — the caller owns the event
loop and the transport, exactly as in the reference (upstream
``src/lib.rs`` module docs).

Stack (upstream README's composition diagram):
``QueueingHoneyBadger -> DynamicHoneyBadger -> HoneyBadger -> Subset ->
{Broadcast, BinaryAgreement -> ThresholdSign}`` plus ``ThresholdDecrypt``
per epoch, ``SyncKeyGen`` for membership change, and ``SenderQueue`` as
the network-facing outbox wrapper.

Copy of ``hbbft_tpu/protocols/``: every share check goes through the
:class:`~hbbft_tpu_torch.crypto.pool.VerifySink` the caller hands in, so a
net built on :class:`~hbbft_tpu_torch.crypto.device.backend.TorchBackend`
checks them on the card, across era changes too.  As in the reference,
DynamicHoneyBadger's vote and key-gen signatures and SyncKeyGen's
ciphertext checks are verified on the host where they arise.
"""

from hbbft_tpu_torch.protocols.broadcast import Broadcast  # noqa: F401
from hbbft_tpu_torch.protocols.binary_agreement import BinaryAgreement  # noqa: F401
from hbbft_tpu_torch.protocols.dynamic_honey_badger import (  # noqa: F401
    Change,
    ChangeState,
    DhbBatch,
    DynamicHoneyBadger,
    JoinPlan,
)
from hbbft_tpu_torch.protocols.honey_badger import (  # noqa: F401
    Batch,
    EncryptionSchedule,
    HoneyBadger,
)
from hbbft_tpu_torch.protocols.queueing_honey_badger import (  # noqa: F401
    Input,
    QueueingHoneyBadger,
)
from hbbft_tpu_torch.protocols.sender_queue import (  # noqa: F401
    JoiningSenderQueue,
    SenderQueue,
)
from hbbft_tpu_torch.protocols.subset import Subset, SubsetOutput  # noqa: F401
from hbbft_tpu_torch.protocols.sync_key_gen import SyncKeyGen  # noqa: F401
from hbbft_tpu_torch.protocols.threshold_decrypt import ThresholdDecrypt  # noqa: F401
from hbbft_tpu_torch.protocols.threshold_sign import ThresholdSign  # noqa: F401
from hbbft_tpu_torch.protocols.transaction_queue import TransactionQueue  # noqa: F401
