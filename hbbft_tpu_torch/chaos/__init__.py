"""Byzantine chaos plane.

Live-socket adversary node arms for the TCP cluster (crash-stop,
equivocation, corrupt shares, stale replay, garbage flooding — all
speaking the real wire protocol over the untouched transport), a
seeded scenario scheduler composing Byzantine strategies with link
faults and kill/restart churn, and safety/liveness oracles over the
honest side.

Copy of ``hbbft_tpu/chaos/``, both node arms.
"""

from hbbft_tpu_torch.chaos.nodes import install_byzantine
from hbbft_tpu_torch.chaos.oracle import (
    ChaosOracle,
    batches_sha,
    fault_entries,
    stream_txns,
)
from hbbft_tpu_torch.chaos.scheduler import ChaosEvent, ChaosRunner, build_schedule
from hbbft_tpu_torch.chaos.strategies import (
    EQUIVOCABLE_KINDS,
    SHARE_KINDS,
    STRATEGIES,
    ByzantineStrategy,
    CorruptShareSender,
    CrashStop,
    Equivocator,
    GarbageFlooder,
    StaleReplayer,
    StrategyContext,
    make_strategy,
    tamper_payload,
)
