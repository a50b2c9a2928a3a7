"""Byzantine node arms: arm a live cluster node with a strategy.

A Byzantine node keeps its REAL protocol stack and its untouched
:class:`~hbbft_tpu_torch.transport.transport.TcpTransport` — the
Byzantine behavior is installed at the transport's send surface: the
:class:`~hbbft_tpu_torch.transport.cluster.ClusterNode` emits via
per-message ``transport.send(dest, payload)`` and batched
``transport.send_many(items)``.

:func:`install_byzantine` wraps both entry points on the node's OWN
transport instance (nobody else sends through it), mapping every
``(dest, payload)`` through ``strategy.on_egress`` and appending
``strategy.extra_frames()`` once per send call/batch.  The wrapped
calls run on the node's protocol thread only, so strategies need no
locking.

Copy of ``hbbft_tpu/chaos/nodes.py`` for Python nodes.  The reference's
native arm (its send fast paths and the engine tamper hooks) waits for
the native engine: ``impl="native"`` raises a ``ValueError`` naming its
ROADMAP.md item.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Tuple

from hbbft_tpu_torch.chaos.strategies import (
    ByzantineStrategy,
    StrategyContext,
    make_strategy,
)


def install_byzantine(
    node: Any,
    spec: Any,
    *,
    seed: int,
    suite: Any,
    cluster_id: bytes,
    peer_addrs: Dict[Any, Tuple[str, int]],
    impl: str = "python",
) -> Any:
    """Arm ``node`` (a ClusterNode) with a Byzantine strategy; returns
    the node.  Called by ``LocalCluster._make_node`` for every id in its
    ``byzantine`` map — including on restart(), so a reborn Byzantine
    node is re-armed with fresh per-bind state."""
    if impl != "python":
        raise ValueError(
            "a Byzantine native node needs the native engine and its tamper "
            "hooks (hbbft_tpu/native_engine.py, hbbft_tpu/chaos/nodes.py "
            "_install_native_tamper), not ported yet: ROADMAP.md Queue 1 item 4"
        )
    strategy = make_strategy(spec)
    ctx = StrategyContext(
        node_id=node.id,
        peer_ids=sorted(peer_addrs),
        peer_addrs=dict(peer_addrs),
        cluster_id=cluster_id,
        suite=suite,
        rng=random.Random(f"chaos|{seed}|{node.id}|{strategy.name}"),
        metrics=node.metrics,
        impl=impl,
    )
    strategy.bind(ctx)
    node.byzantine_strategy = strategy
    _wrap_transport(node, strategy)
    return node


def _wrap_transport(node: Any, strategy: ByzantineStrategy) -> None:
    t = node.transport
    orig_send, orig_send_many = t.send, t.send_many

    def send(dest: Any, payload: bytes) -> None:
        for d, p in strategy.on_egress(dest, payload):
            orig_send(d, p)
        for d, p in strategy.extra_frames():
            orig_send(d, p)

    def send_many(items):
        out = []
        for dest, payload in items:
            out.extend(strategy.on_egress(dest, payload))
        out.extend(strategy.extra_frames())
        if out:
            orig_send_many(out)

    t.send, t.send_many = send, send_many
