"""VirtualNet: every node's protocol instance in one process, single-stepped.

Reference: upstream ``tests/net/mod.rs`` (``NetBuilder``, ``VirtualNet``,
``crank()``, ``CrankError``) — SURVEY.md §3.5/§4.  Because protocols are
sans-I/O state machines, "a network" is just a message queue.

Batch-first addition: each node owns a :class:`~hbbft_tpu_torch.crypto.pool.
VerifyPool`; the net flushes pools through the configured
``CryptoBackend`` according to ``flush_every`` (1 = eager, reference-
equivalent; larger = accumulate crypto checks into device-sized batches).

Copy of ``hbbft_tpu/net/virtual_net.py``.  ``NetBuilder`` keeps the
reference's defaults, the host ``ScalarSuite`` and ``BatchedBackend``; the
card is chosen as the reference chooses its device::

    NetBuilder(16, seed=4).suite(BLSSuite()).backend(lambda s: TorchBackend(s))

``TorchBackend`` runs on ``cuda`` unless given ``device="cpu"``, and
raises at ``build()`` when there is no card.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from hbbft_tpu_torch.crypto.backend import BatchedBackend, CryptoBackend
from hbbft_tpu_torch.crypto.keys import SecretKey, SecretKeySet
from hbbft_tpu_torch.crypto.pool import VerifyPool
from hbbft_tpu_torch.crypto.suite import ScalarSuite, Suite
from hbbft_tpu_torch.net.adversary import Adversary, NullAdversary
from hbbft_tpu_torch.obs import trace as _trace
from hbbft_tpu_torch.protocols.fault_log import FaultLog
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.traits import ConsensusProtocol, Step
from hbbft_tpu_torch.utils.metrics import Metrics


class CrankError(Exception):
    """Message/crank limit exceeded before the run condition was met."""


class MessageQueue:
    """FIFO with O(1) amortized popleft plus the list-ish surface
    adversaries use (indexing, in-place sort) — a plain list's ``pop(0)``
    would make long benchmark runs quadratic in delivered messages."""

    def __init__(self) -> None:
        self._items: List[Any] = []
        self._head = 0

    def append(self, item: Any) -> None:
        self._items.append(item)

    def popleft(self) -> Any:
        item = self._items[self._head]
        self._items[self._head] = None  # drop reference
        self._head += 1
        if self._head > 64 and self._head * 2 > len(self._items):
            self._compact()
        return item

    def _compact(self) -> None:
        self._items = self._items[self._head :]
        self._head = 0

    def sort(self, key=None) -> None:
        self._compact()
        self._items.sort(key=key)

    def __len__(self) -> int:
        return len(self._items) - self._head

    def __bool__(self) -> bool:
        return len(self) > 0

    def _index(self, i: int) -> int:
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("MessageQueue index out of range")
        return self._head + i

    def __getitem__(self, i: int) -> Any:
        return self._items[self._index(i)]

    def __setitem__(self, i: int, v: Any) -> None:
        self._items[self._index(i)] = v

    def __iter__(self):
        return iter(self._items[self._head :])


@dataclass
class NetMessage:
    sender: Any
    dest: Any
    payload: Any


@dataclass
class VirtualNode:
    id: Any
    netinfo: NetworkInfo
    protocol: ConsensusProtocol
    pool: VerifyPool
    rng: random.Random
    outputs: List[Any] = field(default_factory=list)
    faults: FaultLog = field(default_factory=FaultLog)
    sent_messages: int = 0

    @property
    def terminated(self) -> bool:
        return self.protocol.terminated


class VirtualNet:
    def __init__(
        self,
        nodes: Dict[Any, VirtualNode],
        faulty_ids: Sequence[Any],
        backend: CryptoBackend,
        adversary: Adversary,
        rng: random.Random,
        flush_every: int = 1,
        max_cranks: int = 100_000,
        faulty_nodes: Optional[Dict[Any, "VirtualNode"]] = None,
    ) -> None:
        self.nodes = nodes
        self.faulty_ids = list(faulty_ids)
        # Protocol instances for adversary-controlled nodes (used by
        # tampering adversaries that run the real algorithm and rewrite
        # its outgoing messages, upstream ``tamper``); silent/crash-style
        # adversaries simply never touch them.
        self.faulty_nodes: Dict[Any, VirtualNode] = dict(faulty_nodes or {})
        self.backend = backend
        self.adversary = adversary
        self.rng = rng
        self.flush_every = max(1, flush_every)
        self.max_cranks = max_cranks
        self.queue: MessageQueue = MessageQueue()
        self.node_order = sorted(nodes) + sorted(faulty_ids)
        self.cranks = 0
        self.delivered = 0
        self._since_flush = 0
        self._dirty_pools: set = set()
        self.metrics = Metrics()
        # Flight recorder (round 16): OFF by default — simulations pay
        # one attribute read per crank.  enable_trace() gives each
        # correct node a bounded ring; handlers run with that node's
        # buffer swapped in (tracer ctx preserved per node).
        self._traces: Optional[Dict[Any, Any]] = None

    # -- introspection -------------------------------------------------
    @property
    def correct_ids(self) -> List[Any]:
        return sorted(self.nodes)

    def node(self, node_id: Any) -> VirtualNode:
        return self.nodes[node_id]

    def all_terminated(self) -> bool:
        return all(n.terminated for n in self.nodes.values())

    def outputs(self) -> Dict[Any, List[Any]]:
        return {nid: list(n.outputs) for nid, n in self.nodes.items()}

    def correct_faults(self) -> List[Any]:
        """Faults *recorded by* correct nodes *against* correct nodes."""
        correct = set(self.nodes)
        return [
            f
            for n in self.nodes.values()
            for f in n.faults
            if f.node_id in correct
        ]

    # -- membership (upstream net_dynamic_hb analog) -------------------
    def add_node(self, node_id: Any, factory: Callable[[Any, random.Random], ConsensusProtocol]) -> VirtualNode:
        """Add a node mid-run (e.g. constructed from a ``JoinPlan``).

        ``factory(sink, rng) -> protocol``.  The node starts receiving
        broadcast traffic from the next send on.
        """
        assert node_id not in self.nodes and node_id not in self.faulty_ids
        node_rng = random.Random(self.rng.getrandbits(64))
        pool = VerifyPool()
        if self._traces is not None:
            # ring first, tracer swapped in DURING construction: the
            # new protocol's own epoch.open (with whatever era its
            # JoinPlan starts at) lands bracketed, unlike the original
            # nodes whose construction pre-dated enable_trace
            from hbbft_tpu_torch.obs.trace import TraceBuffer

            self._traces[node_id] = TraceBuffer(
                f"node{node_id}", self._trace_capacity
            )
            self._swap_tracer(node_id)
        proto = factory(pool, node_rng)
        self._swap_tracer(None)
        node = VirtualNode(
            id=node_id,
            netinfo=getattr(proto, "netinfo", None),
            protocol=proto,
            pool=pool,
            rng=node_rng,
        )
        self.nodes[node_id] = node
        self.node_order = sorted(self.nodes) + sorted(self.faulty_ids)
        return node

    # -- flight recorder (round 16) ------------------------------------
    def enable_trace(self, capacity: int = 8192) -> None:
        """Give every correct node a bounded milestone ring (the same
        per-node tracks a LocalCluster records), for the sim-net golden
        traces the critical-path analyzer is pinned against.  Call
        BEFORE driving: protocol construction pre-dated the rings, so
        each gets the (era 0, epoch 0) open re-emitted here — exactly
        ClusterNode._run's first-epoch dance."""
        from hbbft_tpu_torch.obs.trace import TraceBuffer

        self._trace_capacity = capacity
        self._traces = {
            nid: TraceBuffer(f"node{nid}", capacity)
            for nid in sorted(self.nodes)
        }
        for buf in self._traces.values():
            buf.emit("epoch.open", era=0, epoch=0)

    def trace_events(self) -> Dict[str, List[Any]]:
        """Snapshot of the per-node rings, keyed by track name (the
        shape the obs exporters/analyzer consume); empty when tracing
        was never enabled."""
        if self._traces is None:
            return {}
        return {buf.track: buf.snapshot() for buf in self._traces.values()}

    def _swap_tracer(self, node_id: Optional[Any]) -> None:
        if self._traces is not None:
            _trace.swap(
                self._traces.get(node_id) if node_id is not None else None
            )

    # -- driving -------------------------------------------------------
    def send_input(self, node_id: Any, input: Any) -> None:
        node = self.nodes[node_id]
        self._swap_tracer(node_id)
        step = node.protocol.handle_input(input, node.rng)
        self._process_step(node, step)
        self._maybe_flush()
        self._swap_tracer(None)

    def broadcast_input(self, input_fn: Callable[[Any], Any]) -> None:
        for nid in sorted(self.nodes):
            self.send_input(nid, input_fn(nid))
        for nid in sorted(self.faulty_ids):
            for m in self.adversary.on_input_to_faulty(
                self, nid, input_fn(nid), self.rng
            ):
                self.queue.append(m)

    def inject(self, msg: NetMessage) -> None:
        self.queue.append(msg)

    def crank(self) -> bool:
        """Deliver one message.  Returns False when idle (nothing pending)."""
        self.cranks += 1
        if self.cranks > self.max_cranks:
            raise CrankError(
                f"exceeded {self.max_cranks} cranks; delivered={self.delivered}"
            )
        self.adversary.pre_crank(self, self.rng)
        if not self.queue:
            # Drain any deferred verifications so progress can resume.
            self._flush_all_pools()
            return bool(self.queue)
        msg = self.queue.popleft()
        if msg.dest in self.faulty_ids:
            for injected in self.adversary.on_message_to_faulty(self, msg, self.rng):
                self.queue.append(injected)
            return True
        node = self.nodes.get(msg.dest)
        if node is None:
            return True  # unknown destination: drop
        self._swap_tracer(msg.dest)
        step = node.protocol.handle_message(msg.sender, msg.payload, node.rng)
        self.delivered += 1
        self._process_step(node, step)
        self._maybe_flush()
        self._swap_tracer(None)
        return True

    def crank_until(
        self, pred: Callable[["VirtualNet"], bool], max_cranks: Optional[int] = None
    ) -> None:
        limit = max_cranks if max_cranks is not None else self.max_cranks
        for _ in range(limit):
            if pred(self):
                return
            made_progress = self.crank()
            if not made_progress and not self.queue:
                self._flush_all_pools()
                if not self.queue and pred(self):
                    return
                if not self.queue:
                    raise CrankError("network idle but condition not met")
        if pred(self):
            return
        raise CrankError(f"condition not met after {limit} cranks")

    def run_to_termination(self, max_cranks: Optional[int] = None) -> None:
        self.crank_until(lambda net: net.all_terminated(), max_cranks)

    # -- internals -----------------------------------------------------
    def _process_step(self, node: VirtualNode, step: Step) -> None:
        node.outputs.extend(step.output)
        node.faults.extend(step.fault_log)
        all_ids = self.node_order
        for tm in step.messages:
            node.sent_messages += 1
            for dest in tm.target.recipients(all_ids, node.id):
                self.queue.append(NetMessage(node.id, dest, tm.message))
        if node.pool:
            self._dirty_pools.add(node.id)

    def _maybe_flush(self) -> None:
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self._flush_all_pools()

    def _flush_all_pools(self) -> None:
        """Flush nodes with pending verify requests, in sorted-id order.

        Only *dirty* nodes are visited: a node's pool can only fill
        while its own handler (or its own flush) runs, so the set of
        non-empty pools is exactly the ids recorded by _process_step —
        scanning every node per crank was the single hottest line of
        the N=64 benchmark profile."""
        self._since_flush = 0
        while self._dirty_pools:
            for nid in sorted(self._dirty_pools):
                self._dirty_pools.discard(nid)
                node = self.nodes.get(nid)
                # flush continuations emit the node's own milestones
                # (decrypt.done, epoch.commit) — swap its ring in
                self._swap_tracer(nid if node is not None else None)
                while node is not None and node.pool:
                    self.metrics.count("verify_requests", len(node.pool))
                    with self.metrics.timer("verify_flush"):
                        step = node.pool.flush(self.backend)
                    self._process_step(node, step)
        self._swap_tracer(None)  # idle-path callers don't re-swap


class NetBuilder:
    """Configures and builds a :class:`VirtualNet`.

    Reference: upstream ``NetBuilder`` (node count, faulty set, adversary,
    RNG seed, limits).  Key generation is dealer-based
    (``SecretKeySet.random``) exactly as in upstream tests.
    """

    def __init__(self, num_nodes: int, seed: int = 0) -> None:
        self.num_nodes = num_nodes
        self.seed = seed
        self._num_faulty: Optional[int] = None
        self._num_observers = 0
        self._suite: Suite = ScalarSuite()
        self._backend_factory: Callable[[Suite], CryptoBackend] = BatchedBackend
        self._adversary: Adversary = NullAdversary()
        self._protocol_factory: Optional[Callable[..., ConsensusProtocol]] = None
        self._flush_every = 1
        self._max_cranks = 100_000

    def num_faulty(self, f: int) -> "NetBuilder":
        self._num_faulty = f
        return self

    def suite(self, suite: Suite) -> "NetBuilder":
        self._suite = suite
        return self

    def backend(self, factory: Callable[[Suite], CryptoBackend]) -> "NetBuilder":
        self._backend_factory = factory
        return self

    def adversary(self, adv: Adversary) -> "NetBuilder":
        self._adversary = adv
        return self

    def flush_every(self, k: int) -> "NetBuilder":
        self._flush_every = k
        return self

    def max_cranks(self, k: int) -> "NetBuilder":
        self._max_cranks = k
        return self

    def protocol(
        self, factory: Callable[[NetworkInfo, Any, random.Random], ConsensusProtocol]
    ) -> "NetBuilder":
        """``factory(netinfo, sink, rng) -> protocol instance``."""
        self._protocol_factory = factory
        return self

    def observers(self, k: int) -> "NetBuilder":
        """The last ``k`` node ids join as observers: they hold regular
        keypairs and receive all traffic but are not validators (no
        threshold key share).  Mirrors upstream NetBuilder observer
        support; the dynamic-HB churn tests promote them via votes."""
        self._num_observers = k
        return self

    def build(self) -> VirtualNet:
        assert self._protocol_factory is not None, "protocol factory required"
        rng = random.Random(self.seed)
        n = self.num_nodes
        n_obs = self._num_observers
        n_val = n - n_obs
        f = self._num_faulty if self._num_faulty is not None else (n_val - 1) // 3
        assert 3 * f < n_val, f"need 3f < N (got N={n_val}, f={f})"
        ids = list(range(n))
        val_ids = ids[:n_val]
        faulty_ids = val_ids[n_val - f :] if f else []
        correct_ids = [i for i in ids if i not in faulty_ids]

        suite = self._suite
        sks = SecretKeySet.random(f, rng, suite)
        pks = sks.public_keys()
        node_sks = {i: SecretKey.random(rng, suite) for i in ids}
        node_pks = {i: node_sks[i].public_key() for i in ids}

        def make_node(i: Any) -> VirtualNode:
            is_val = i in val_ids
            netinfo = NetworkInfo(
                our_id=i,
                val_ids=val_ids,
                public_key_set=pks,
                secret_key_share=sks.secret_key_share(val_ids.index(i)) if is_val else None,
                public_keys={j: node_pks[j] for j in val_ids},
                secret_key=node_sks[i],
            )
            pool = VerifyPool()
            node_rng = random.Random((self.seed << 16) ^ (i + 1))
            proto = self._protocol_factory(netinfo, pool, node_rng)
            return VirtualNode(
                id=i, netinfo=netinfo, protocol=proto, pool=pool, rng=node_rng
            )

        nodes = {i: make_node(i) for i in correct_ids}
        # Faulty nodes get real instances too (their key shares exist in
        # any case — the dealer handed them out).  Whether these run is
        # the adversary's choice: crash-style ones ignore them.
        faulty_nodes = {i: make_node(i) for i in faulty_ids}

        return VirtualNet(
            nodes=nodes,
            faulty_ids=faulty_ids,
            backend=self._backend_factory(suite),
            adversary=self._adversary,
            rng=rng,
            flush_every=self._flush_every,
            max_cranks=self._max_cranks,
            faulty_nodes=faulty_nodes,
        )
