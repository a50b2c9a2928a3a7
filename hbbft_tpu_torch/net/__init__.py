"""Deterministic in-process network simulation harness.

Reference: upstream ``tests/net/`` (``NetBuilder``, ``VirtualNet``,
``Adversary``, ``CrankError``) — split into the ``hbbft_testing`` crate in
later upstream revisions.  SURVEY.md §4/§2 #16.  Shipped as part of the
framework (not just the test tree) because the simulator doubles as the
benchmark driver, as upstream's ``examples/simulation.rs`` does.
"""

from hbbft_tpu_torch.net.adversary import (  # noqa: F401
    Adversary,
    NodeOrderAdversary,
    NullAdversary,
    RandomAdversary,
    ReorderingAdversary,
    TamperingAdversary,
)
from hbbft_tpu_torch.net.virtual_net import CrankError, NetBuilder, VirtualNet  # noqa: F401
