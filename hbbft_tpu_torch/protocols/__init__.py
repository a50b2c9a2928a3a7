"""Protocol plane: pure host-side state machines.

Every protocol is a deterministic state machine consuming ``(sender,
message)`` pairs and inputs and emitting a :class:`~hbbft_tpu_torch.protocols.
traits.Step`.  No I/O, no threads, no clock — the caller owns the event
loop and the transport, exactly as in the reference (upstream
``src/lib.rs`` module docs).

Stack (upstream README's composition diagram):
``HoneyBadger -> Subset -> {Broadcast, BinaryAgreement -> ThresholdSign}``
plus ``ThresholdDecrypt`` per epoch.

Copy of ``hbbft_tpu/protocols/`` up to HoneyBadger: every share check goes
through the :class:`~hbbft_tpu_torch.crypto.pool.VerifySink` the caller
hands in, so a net built on
:class:`~hbbft_tpu_torch.crypto.device.backend.TorchBackend` checks them on
the card.  QueueingHoneyBadger, DynamicHoneyBadger, SyncKeyGen and
SenderQueue are not part of this package yet.
"""

from hbbft_tpu_torch.protocols.broadcast import Broadcast  # noqa: F401
from hbbft_tpu_torch.protocols.binary_agreement import BinaryAgreement  # noqa: F401
from hbbft_tpu_torch.protocols.honey_badger import (  # noqa: F401
    Batch,
    EncryptionSchedule,
    HoneyBadger,
)
from hbbft_tpu_torch.protocols.subset import Subset, SubsetOutput  # noqa: F401
from hbbft_tpu_torch.protocols.threshold_decrypt import ThresholdDecrypt  # noqa: F401
from hbbft_tpu_torch.protocols.threshold_sign import ThresholdSign  # noqa: F401
