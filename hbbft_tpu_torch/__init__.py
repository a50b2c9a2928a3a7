"""hbbft_tpu_torch — the PyTorch/CUDA port of the hbbft_tpu device planes.

The JAX package :mod:`hbbft_tpu` stays the reference; this package sits
beside it and imports none of it (nor ``jax``).  Host modules the port
needs are kept here as copies under the same relative paths: the whole
protocol stack, from ``Broadcast`` and ``BinaryAgreement`` through
``HoneyBadger``, ``SyncKeyGen``, ``DynamicHoneyBadger`` and
``QueueingHoneyBadger`` to ``SenderQueue``, with the reference's wire
tags and its simulation example (``examples/simulation.py``), and the
crypto plane: a TCP cluster runtime (``transport/``) whose nodes' share
checks one shared service (``cryptoplane/``) merges into flushes, and the
native engine (``native_engine.py`` over the C++ of ``csrc/native/``,
built with g++) with its cluster nodes and process-per-node runtime.  The device
modules live under ``crypto/device`` (the BLS share-verification flush)
and ``ops/device`` (the reliable-broadcast data plane), with the
hand-written CUDA kernels in ``csrc/``.

Every entry point takes ``device=`` and runs on ``cuda`` unless the
caller asks for ``"cpu"`` (:func:`hbbft_tpu_torch.device.resolve`).
"""

# The protocol substrate, re-exported as the reference's package root does.
# Importing it here first also gives the import order the reference relies
# on: ``crypto.pool`` imports ``protocols.traits``, and loading the
# protocols package imports ``crypto.pool`` (from ``binary_agreement``), so
# the protocols package must load first or the import is circular.
from hbbft_tpu_torch.protocols.traits import (  # noqa: F401,E402
    ConsensusProtocol,
    SourcedMessage,
    Step,
    Target,
    TargetedMessage,
)
from hbbft_tpu_torch.protocols.network_info import NetworkInfo  # noqa: F401,E402
from hbbft_tpu_torch.protocols.fault_log import Fault, FaultLog  # noqa: F401,E402
