"""Byzantine node arms: arm a live cluster node with a strategy.

Both ``node_impl`` arms keep their REAL protocol stack and their
untouched :class:`~hbbft_tpu_torch.transport.transport.TcpTransport` — the
Byzantine behavior is installed at the one seam both arms share, the
transport's send surface:

* the Python :class:`~hbbft_tpu_torch.transport.cluster.ClusterNode` emits
  via per-message ``transport.send(dest, payload)``;
* the native :class:`~hbbft_tpu_torch.transport.native_node.
  NativeClusterNode` emits via batched ``transport.send_many(items)``
  and, on the round-20 coalescing fast path, pre-packed MSGB bodies
  via ``transport.send_wire`` / ``transport.send_msgb`` (unpacked here
  so strategies keep seeing logical messages).

:func:`install_byzantine` wraps both entry points on the node's OWN
transport instance (nobody else sends through it), mapping every
``(dest, payload)`` through ``strategy.on_egress`` and appending
``strategy.extra_frames()`` once per send call/batch.  The wrapped
calls run on the node's protocol thread only, so strategies need no
locking.

The corrupt-share strategy on the native arm instead installs the
engine tamper hooks (``hbe_set_tamper`` + ``hbe_set_tampered``): the
rewrite happens on the engine's outgoing-message clone before the C
encoder, exactly like :class:`~hbbft_tpu_torch.net.adversary.
TamperingAdversary` runs in-process (the engine's ``outgoing()`` path
tampers the shared clone once per logical message, cluster mode
included).  The ``tampered`` flag survives ``hbe_restart_node``, so
era changes keep the node Byzantine.

Copy of ``hbbft_tpu/chaos/nodes.py``.
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
    """Arm ``node`` (ClusterNode or NativeClusterNode) with a Byzantine
    strategy; returns the node.  Called by ``LocalCluster._make_node``
    for every id in its ``byzantine`` map — including on restart(), so
    a reborn Byzantine node is re-armed with fresh per-bind state."""
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
    if impl == "native" and strategy.native_tamper:
        _install_native_tamper(node, strategy)
    else:
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

    def send_msgb(dest: Any, body: bytes, count: int) -> None:
        # The round-20 native fast path emits pre-packed MSGB bodies;
        # strategies operate on logical messages, so unpack here and
        # route through the wrapped send_many (which re-coalesces the
        # survivors).  decode_msgb is cheap next to the strategy work.
        from hbbft_tpu_torch.transport.framing import decode_msgb

        send_many([(dest, p) for p in decode_msgb(body)])

    def send_wire(records) -> None:
        # Whole-sweep fast path (round 20): same unpacking stance as
        # send_msgb — flatten every record to logical messages and let
        # the wrapped send_many re-coalesce the survivors.
        from hbbft_tpu_torch.transport.framing import decode_msgb

        flat = []
        for dest, count, data in records:
            if count <= 1:
                flat.append((dest, data))
            else:
                flat.extend((dest, p) for p in decode_msgb(data))
        send_many(flat)

    t.send, t.send_many = send, send_many
    t.send_msgb, t.send_wire = send_msgb, send_wire


def _install_native_tamper(node: Any, strategy: ByzantineStrategy) -> None:
    from hbbft_tpu_torch.native_engine import _TAMPER_CB

    eng = node.engine
    cb = strategy.native_tamper_cb(eng)
    # the ctypes callback object must outlive the engine
    node._chaos_tamper_cb = _TAMPER_CB(cb)
    eng.lib.hbe_set_tamper(eng.handle, node._chaos_tamper_cb)
    eng.lib.hbe_set_tampered(eng.handle, node.id, 1)
