"""Cluster runtime: N hbbft nodes talking over real localhost TCP.

This is the first harness that takes the stack off the in-process
simulator (:mod:`hbbft_tpu_torch.net.virtual_net`): every node owns a
:class:`~hbbft_tpu_torch.transport.transport.TcpTransport` plus a protocol
thread running the SenderQueue(QueueingHoneyBadger) stack, and the only
way protocol state crosses nodes is serde-encoded frames on sockets.

Per node, two threads:

* the transport's selector loop (socket plane, owns all fds);
* the protocol thread (consensus plane): drains an inbox of decoded-
  frame events and local inputs, steps the protocol, serde-encodes each
  outgoing :class:`TargetedMessage` once per payload and hands it to
  the transport, then flushes the node's
  :class:`~hbbft_tpu_torch.crypto.pool.VerifyPool` through the configured
  backend (eager ``flush_every=1`` semantics — reference-equivalent, the
  deferred-batching invariant applies unchanged if a larger cadence is
  ever wanted here).

Keys are dealt exactly like :class:`~hbbft_tpu_torch.net.virtual_net.
NetBuilder` (same rng ritual at the same seed), so a TCP cluster at
seed s agrees batch-for-batch with a VirtualNet run at seed s modulo
scheduling; more importantly, a *subprocess* worker
(:mod:`hbbft_tpu_torch.transport.cluster_worker`) can derive its own keys
from ``(seed, n, f)`` alone — no key material ever crosses a process
boundary.

Failure drills the tests lean on:

* :meth:`LocalCluster.kill` / :meth:`LocalCluster.restart` — process
  death: protocol state is discarded (fresh instance at era 0), the
  listener port is reused so peers' backoff dials find the reborn node.
* :meth:`LocalCluster.disconnect` / :meth:`LocalCluster.reconnect` —
  network outage around a live process: sockets sever, protocol state
  and both sides' outbound queues survive, and the sender-queue window
  machinery replays/gates traffic on reconnect (churn test).

Untrusted-input policy at this layer: a frame whose payload fails
``serde.loads`` under the cluster's suite pin is counted
(``cluster.bad_payload``) and dropped — framing-level violations
already cost the sender its connection inside the transport.

Copy of ``hbbft_tpu/transport/cluster.py``: Python nodes, engine-per-node
nodes (``node_impl="native"``, :mod:`hbbft_tpu_torch.transport.
native_node`) or a mix, the reference's live Byzantine nodes
(``byzantine=``, :mod:`hbbft_tpu_torch.chaos`) and scrape server
(:meth:`LocalCluster.serve_obs`).  Where the caller names no backend, a BLS cluster
verifies on the card (``TorchBackend``, in each node, the in-process
service or the service process), which raises with no card; the
reference used the host's ``BatchedBackend``.  The scalar suite, which
has no device path, keeps ``BatchedBackend``.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from hbbft_tpu_torch.crypto.backend import BatchedBackend, CryptoBackend, default_backend
from hbbft_tpu_torch.crypto.keys import SecretKey, SecretKeySet
from hbbft_tpu_torch.crypto.pool import VerifyPool
from hbbft_tpu_torch.crypto.suite import ScalarSuite, Suite
from hbbft_tpu_torch.obs import trace as _trace
from hbbft_tpu_torch.obs.analyze import derived_summaries, diagnose
from hbbft_tpu_torch.obs.export import chrome_trace, summarize
from hbbft_tpu_torch.obs.trace import TraceBuffer, TraceEvent
from hbbft_tpu_torch.protocols.dynamic_honey_badger import DhbBatch
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.queueing_honey_badger import Input, QueueingHoneyBadger
from hbbft_tpu_torch.protocols.sender_queue import SenderQueue, SqMessage
from hbbft_tpu_torch.protocols.traits import ConsensusProtocol, Step
from hbbft_tpu_torch.transport.transport import TcpTransport
from hbbft_tpu_torch.utils import serde
from hbbft_tpu_torch.utils.metrics import EpochTracker, Metrics


def deal_keys(
    n: int, f: int, seed: int, suite: Suite
) -> Tuple[SecretKeySet, Dict[int, SecretKey]]:
    """NetBuilder's dealer ritual, factored out so every process of a
    cluster derives identical keys from ``(n, f, seed)`` (rng draw
    ORDER is part of the wire contract between processes — change it
    only with a version bump in the cluster id)."""
    rng = random.Random(seed)
    sks = SecretKeySet.random(f, rng, suite)
    node_sks = {i: SecretKey.random(rng, suite) for i in range(n)}
    return sks, node_sks


def build_netinfo(
    n: int, f: int, seed: int, suite: Suite, our_id: int
) -> NetworkInfo:
    sks, node_sks = deal_keys(n, f, seed, suite)
    val_ids = list(range(n))
    node_pks = {i: node_sks[i].public_key() for i in val_ids}
    return NetworkInfo(
        our_id=our_id,
        val_ids=val_ids,
        public_key_set=sks.public_keys(),
        secret_key_share=sks.secret_key_share(our_id),
        public_keys=node_pks,
        secret_key=node_sks[our_id],
    )


def track_commits(
    epochs: EpochTracker, batches: Sequence[DhbBatch], last_t: float
) -> float:
    """Record commit latency for ``batches`` (both node impls route
    committed batches through here): each epoch's latency is the
    commit-to-commit interval at this node — ``started_at`` is the
    previous commit (or node start), so the first measurement includes
    cluster ramp-up honestly.  Returns the new last-commit time."""
    for b in batches:
        now = time.time()
        key = (b.era, b.epoch)
        epochs.start(key, last_t)
        txns = sum(
            len(c) if isinstance(c, (list, tuple)) else 1
            for _, c in b.contributions
            if c
        )
        epochs.finish(key, now, contributions=len(b.contributions), txns=txns)
        last_t = now
    return last_t


def merge_node_metrics(
    nodes: Dict[int, Any],
    base: Optional[Metrics] = None,
    summaries: Optional[
        Dict[str, Tuple[Dict[float, float], int, float]]
    ] = None,
) -> Metrics:
    """Merge per-node metrics plus the derived observability families
    (per-node transport export, ``epoch.latency`` summary, per-node
    committed gauges, the ring-derived ``summaries`` — ``phase.*`` +
    ``ba.rounds``) — the shared half of
    :meth:`LocalCluster.merged_metrics`, factored out so the
    process-per-node worker (:mod:`~hbbft_tpu_torch.transport.cluster_worker`)
    exports the same metric families for ONE node that a cluster dump
    carries for N, and the parent-side merge stays a plain counter sum."""
    m = Metrics()
    for node in nodes.values():
        node.transport.export_metrics()
        m.merge(node.metrics)
    if base is not None:
        m.merge(base)
    lats: List[float] = []
    dropped_total = 0
    for i, node in nodes.items():
        # Trace-ring overflow (round-16 satellite): silently truncated
        # traces make every ring-derived number (phase.*, ba.rounds,
        # critical_path) quietly partial — export the drop counters so
        # a scrape or bench line shows the truncation.
        drop_fn = getattr(node, "trace_dropped", None)
        dropped = int(drop_fn()) if callable(drop_fn) else 0
        m.gauge(f"trace.{i}.dropped", dropped)
        dropped_total += dropped
        tracker = getattr(node, "epochs", None)
        if tracker is None:
            continue
        node_lats = tracker.latencies()
        lats.extend(node_lats)
        m.gauge(f"epoch.{i}.committed", len(node_lats))
    m.gauge("trace.dropped", dropped_total)
    sm = summarize(lats)
    if sm is not None:
        quant, count, total = sm
        m.summary("epoch.latency", quant, count, total)
    for name, (quant, count, total) in sorted((summaries or {}).items()):
        m.summary(name, quant, count, total)
    return m


class ClusterNode:
    """One node: protocol thread + transport, joined by an inbox."""

    def __init__(
        self,
        node_id: int,
        netinfo: NetworkInfo,
        all_ids: List[int],
        transport: TcpTransport,
        backend: CryptoBackend,
        suite: Suite,
        seed: int,
        protocol_factory: Callable[[NetworkInfo, Any, random.Random], ConsensusProtocol],
        metrics: Optional[Metrics] = None,
        inbox_cap: int = 50_000,
        trace: Optional[TraceBuffer] = None,
    ) -> None:
        self.id = node_id
        self.netinfo = netinfo
        self.all_ids = list(all_ids)
        self.transport = transport
        self.backend = backend
        self.suite = suite
        self.metrics = metrics if metrics is not None else transport.metrics
        # Flight recorder (round 12): the protocol thread installs this
        # buffer as its thread-local tracer, so the protocol modules'
        # milestone emits land here; epoch commit latency feeds the
        # epoch.latency summary via the tracker.
        self.trace = trace
        self.epochs = EpochTracker()
        self._last_commit_t = time.time()
        self.rng = random.Random((seed << 16) ^ (node_id + 1))
        self.pool = VerifyPool()
        self.protocol = protocol_factory(netinfo, self.pool, self.rng)
        self.outputs: List[Any] = []
        self._batches: List[DhbBatch] = []  # outputs filtered once, at append
        self.faults: List[Any] = []
        # Bounded: a peer streaming faster than the protocol thread
        # drains must hit receive-side backpressure (the transport drops
        # its connection un-acked and it resumes later), not grow memory.
        self.inbox: "queue.Queue[Tuple[str, Any, Any]]" = queue.Queue(
            maxsize=inbox_cap
        )
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._ran_before = False
        self._lock = threading.Lock()  # snapshot vs append on outputs
        # Burst consumer (round 20): one inbox item per read burst with
        # all-or-nothing consumption — the frame-atomic unit the MSGB
        # ACK contract needs (a partially-consumed batch frame would be
        # re-delivered whole after a reconnect).  The transport unpacks
        # MSGB bodies before this callback, so mixed clusters interop
        # regardless of the peer's coalesce arm.
        transport.on_batch = self._on_frame_burst

    # -- transport thread ----------------------------------------------
    def _on_frame_burst(self, sender: Any, payloads: List[bytes]) -> int:
        try:
            self.inbox.put_nowait(("msgs", sender, payloads))
        except queue.Full:
            self.metrics.count("cluster.inbox_overflow")
            return 0  # nothing consumed: transport drops the conn un-acked
        return len(payloads)

    # -- any thread ----------------------------------------------------
    def submit(self, input: Any) -> None:
        try:
            self.inbox.put_nowait(("input", input, None))
        except queue.Full:
            # local inputs are droppable under overload (drivers pace);
            # silently blocking the submitter could deadlock a test
            self.metrics.count("cluster.input_dropped")

    def batches(self) -> List[DhbBatch]:
        with self._lock:
            return list(self._batches)

    def batch_count(self) -> int:
        """O(1) committed-batch count (the traffic driver polls this
        every tick — copying the whole list just for len() is O(epochs)
        and QHB grows it forever)."""
        with self._lock:
            return len(self._batches)

    def batches_from(self, start: int) -> List[DhbBatch]:
        """Batches from index ``start`` on — copies only the new tail."""
        with self._lock:
            return self._batches[start:]

    def start(self) -> None:
        assert self._thread is None
        self._stop = False
        self._last_commit_t = time.time()
        self._thread = threading.Thread(
            target=self._run, name=f"node-{self.id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop = True  # the flag, not a queue item: survives a full inbox
        self._thread.join(timeout=10)
        self._thread = None

    def last_committed(self) -> Optional[Tuple[int, int]]:
        """(era, epoch) of the newest committed batch, or None."""
        with self._lock:
            if not self._batches:
                return None
            b = self._batches[-1]
            return (b.era, b.epoch)

    def trace_dropped(self) -> int:
        """Events this node's trace ring dropped to overflow (0 when
        the recorder is off) — the honest-truncation gauge."""
        return self.trace.dropped if self.trace is not None else 0

    def _track_commits(self, batches: List[DhbBatch]) -> None:
        if batches:
            self._last_commit_t = track_commits(
                self.epochs, batches, self._last_commit_t
            )

    # -- protocol thread -----------------------------------------------
    def _run(self) -> None:
        _trace.install(self.trace)
        if not self._ran_before:
            # The first epoch's state was built in __init__ on the MAIN
            # thread (no tracer installed): re-emit its open here so
            # epoch 0 gets a complete span.  A fresh node is always at
            # (era 0, epoch 0) before its protocol thread first runs.
            self._ran_before = True
            _trace.emit("epoch.open", era=0, epoch=0)
        egress: List[Tuple[Any, bytes]] = []
        while not self._stop:
            try:
                kind, a, b = self.inbox.get(timeout=0.2)
            except queue.Empty:
                continue
            egress.clear()
            if kind == "msgs":
                # Exception scope is per MESSAGE, not the burst: the
                # frames behind a failing one were already consumed +
                # ACKed by the transport, so skipping them would lose
                # acknowledged traffic with no retransmit.  A handler
                # bug must not take the thread down either way — count
                # it loudly; tests assert this stays zero.
                for payload in b:
                    try:
                        msg = serde.try_loads(payload, suite=self.suite)
                        # any well-formed-but-wrong-type payload is
                        # still peer-authored garbage, not a local
                        # handler bug
                        if msg is None or not isinstance(msg, SqMessage):
                            self.metrics.count("cluster.bad_payload")
                            continue
                        self.metrics.count("cluster.msgs_handled")
                        step = self.protocol.handle_message(a, msg, self.rng)
                        self._process_step(step, egress)
                    except Exception:
                        self.metrics.count("cluster.handler_errors")
            else:  # input
                try:
                    step = self.protocol.handle_input(a, self.rng)
                    self._process_step(step, egress)
                except Exception:
                    self.metrics.count("cluster.handler_errors")
            try:
                while self.pool:
                    self._process_step(self.pool.flush(self.backend), egress)
                if egress:
                    # One control-plane hand-off per inbox item: the
                    # transport packs each peer's payloads into MSGB
                    # frames (or per-message MSG frames, coalesce off).
                    self.transport.send_many(list(egress))
            except Exception:
                self.metrics.count("cluster.handler_errors")

    def _process_step(
        self, step: Step, egress: Optional[List[Tuple[Any, bytes]]] = None
    ) -> None:
        if step.output:
            batches = [o for o in step.output if isinstance(o, DhbBatch)]
            with self._lock:
                self.outputs.extend(step.output)
                self._batches.extend(batches)
            self._track_commits(batches)
        if step.fault_log.faults:
            self.faults.extend(step.fault_log.faults)
            self.metrics.count("cluster.protocol_faults", len(step.fault_log.faults))
        for tm in step.messages:
            data = serde.dumps(tm.message)
            for dest in tm.target.recipients(self.all_ids, self.id):
                if egress is not None:
                    egress.append((dest, data))
                else:
                    self.transport.send(dest, data)


def _default_protocol_factory(
    batch_size: int, session_id: bytes, n: int
) -> Callable[[NetworkInfo, Any, random.Random], ConsensusProtocol]:
    def factory(ni: NetworkInfo, sink: Any, rng: random.Random) -> ConsensusProtocol:
        return SenderQueue.wrap(
            lambda s: QueueingHoneyBadger(
                ni, s, batch_size=batch_size, session_id=session_id
            ),
            sink,
            peers=list(range(n)),
        )

    return factory


class LocalCluster:
    """N thread-per-node TCP nodes on localhost.

    ``injector`` (a :class:`~hbbft_tpu_torch.transport.faults.FaultInjector`)
    is shared by every node's transport, so one schedule partitions /
    degrades the whole cluster deterministically.
    """

    def __init__(
        self,
        n: int,
        seed: int = 0,
        batch_size: int = 8,
        num_faulty: Optional[int] = None,
        session_id: bytes = b"tcp-cluster",
        cluster_id: bytes = b"hbbft-tpu/cluster/v1",
        suite: Optional[Suite] = None,
        backend_factory: Optional[Callable[[Suite], CryptoBackend]] = None,
        protocol_factory: Optional[
            Callable[[NetworkInfo, Any, random.Random], ConsensusProtocol]
        ] = None,
        injector: Any = None,
        max_frame_len: Optional[int] = None,
        max_queue_frames: int = 20_000,
        node_impl: Any = "python",
        byzantine: Optional[Dict[int, Any]] = None,
        transport_kwargs: Optional[Dict[str, Any]] = None,
        crypto: str = "inline",
        crypto_service: Any = None,
        service_kwargs: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.n = n
        self.seed = seed
        self.f = num_faulty if num_faulty is not None else (n - 1) // 3
        # A real error, not an assert: ``python -O`` strips asserts, and
        # a cluster sized below the BFT bound silently voids every
        # agreement guarantee downstream (the failure shows up later as
        # an inexplicable stall or divergence, never here).
        if self.f < 0 or n < 3 * self.f + 1:
            raise ValueError(
                f"BFT bound violated: need n >= 3*num_faulty + 1 "
                f"(got n={n}, f={self.f})"
            )
        # byzantine: {node_id: strategy} — those nodes run live-socket
        # adversary arms (hbbft_tpu_torch.chaos) instead of honest ones.
        # A strategy is a registry name ("crash-stop" | "equivocate" |
        # "corrupt-share" | "stale-replay" | "flood"), a ByzantineStrategy
        # instance, or a zero-arg factory.  Byzantine nodes spend the
        # fault budget: more than f of them voids the oracle's
        # guarantees, so that is rejected too.
        self.byzantine: Dict[int, Any] = dict(byzantine or {})
        for nid in self.byzantine:
            if not (0 <= nid < n):
                raise ValueError(f"byzantine id {nid} outside 0..{n - 1}")
        if len(self.byzantine) > self.f:
            raise ValueError(
                f"{len(self.byzantine)} Byzantine nodes exceed the fault "
                f"budget f={self.f} (n={n})"
            )
        if self.byzantine:
            # Fail on a bad registry name HERE, not after n listeners
            # and a stack of node threads exist (there is no stop()
            # path for a half-built cluster).  Instances/factories are
            # resolved per-bind in _make_node.
            from hbbft_tpu_torch.chaos.strategies import STRATEGIES

            for spec in self.byzantine.values():
                if isinstance(spec, str) and spec not in STRATEGIES:
                    raise ValueError(
                        f"unknown Byzantine strategy {spec!r} "
                        f"(known: {sorted(STRATEGIES)})"
                    )
        self.suite = suite if suite is not None else ScalarSuite()
        self.cluster_id = cluster_id
        self.injector = injector
        self.metrics = Metrics()
        # Flight recorder (round 12): one bounded event ring per node
        # plus a cluster-level ring (chaos schedule events).  The rings
        # live HERE, not on the node objects, so a kill/restart drill
        # keeps one continuous timeline per node id across rebirths.
        self.trace = TraceBuffer("cluster")
        self.traces: Dict[int, TraceBuffer] = {
            i: TraceBuffer(f"node{i}") for i in range(n)
        }
        # Phase-summary TTL cache: deriving spans re-walks every ring
        # snapshot, which is fine once per run but not once per scrape —
        # a Prometheus poller must not re-pay it per request (stop()
        # invalidates, so end-of-run reads are exact).
        self._phase_cache: Optional[Tuple[float, Dict[str, Any]]] = None
        self._obs_server: Any = None
        # node_impl (round 9): "python" (the oracle ClusterNode above),
        # "native" (engine-per-node NativeClusterNode — the whole
        # decode+handle loop in C), or a {node_id: impl} mapping for
        # mixed clusters (interop tests).  Native nodes run the stock
        # SenderQueue(QHB) semantics natively, so they only compose with
        # the DEFAULT protocol stack and the scalar suite.
        self._node_impl = node_impl
        self._batch_size = batch_size
        self._session_id = session_id
        for i in range(n):
            impl = self._impl_for(i)
            if impl not in ("python", "native"):
                raise ValueError(
                    f"unknown node_impl {impl!r} (python or native)"
                )
        if any(self._impl_for(i) == "native" for i in range(n)):
            if protocol_factory is not None:
                raise ValueError(
                    "node_impl='native' runs the stock SenderQueue(QHB) "
                    "stack in the engine; custom protocol_factory needs "
                    "node_impl='python'"
                )
            if not isinstance(self.suite, ScalarSuite):
                raise ValueError(
                    "node_impl='native' requires the scalar suite "
                    "(the engine's internal-crypto mode)"
                )
        factory = protocol_factory or _default_protocol_factory(
            batch_size, session_id, n
        )
        self._factory = factory
        # backend_factory None: the card's TorchBackend for BLS (raises
        # with no card), BatchedBackend for the scalar suite
        # (crypto.backend.default_backend).
        self._backend_factory = backend_factory or default_backend
        # crypto: "inline" verifies shares in a per-node backend;
        # "service" routes every node's share checks through ONE shared
        # CryptoPlaneService that batches requests across all nodes
        # into single backend flushes (hbbft_tpu_torch/cryptoplane/).
        # The service's backend comes from backend_factory(suite) unless
        # a pre-built service (e.g. over TorchBackend) is passed in;
        # every node keeps a local BatchedBackend fallback, so a
        # dead/slow service degrades to inline verification instead of
        # stalling the cluster (counted in crypto.fallbacks).
        # "service-proc": the same service in its own OS process behind
        # the socket RPC boundary (cryptoplane/proc_service.py).
        # crypto_service may be a pre-started ServiceProcess, a (host,
        # port) address of an externally-run worker, or None — None
        # consults HBBFT_TORCH_CRYPTO_SERVICE and otherwise spawns an
        # owned worker over this cluster's suite (service_kwargs'
        # backend; by default "torch", the card, for BLS and "batched"
        # for the scalar suite).
        # Per-node RpcServiceClients keep the local-BatchedBackend
        # fallback (counted in crypto.rpc.fallbacks).
        if crypto not in ("inline", "service", "service-proc"):
            raise ValueError(
                f"unknown crypto arm {crypto!r} "
                "(inline | service | service-proc)"
            )
        if crypto_service is not None and crypto == "inline":
            raise ValueError("crypto_service requires a service crypto arm")
        self.crypto = crypto
        self.crypto_service = crypto_service
        self._owns_service = False
        self._service_timeout_s = 30.0
        self._service_addr: Optional[Tuple[str, int]] = None
        self._cryptoplane_trace: Optional[TraceBuffer] = None
        if crypto == "service":
            from hbbft_tpu_torch.cryptoplane import CryptoPlaneService

            kw = dict(service_kwargs or {})
            self._service_timeout_s = float(kw.pop("timeout_s", 30.0))
            if self.crypto_service is None:
                self.crypto_service = CryptoPlaneService(
                    self._backend_factory(self.suite),
                    trace=TraceBuffer("cryptoplane"),
                    **kw,
                )
                self._owns_service = True
            elif kw:
                # Construction kwargs cannot be applied to a pre-built
                # service — silently ignoring them would misconfigure
                # the run with no symptom beyond odd batch sizes.
                raise ValueError(
                    f"service_kwargs {sorted(kw)} cannot be applied to a "
                    "pre-built crypto_service (only timeout_s, which "
                    "configures the per-node clients)"
                )
        elif crypto == "service-proc":
            from hbbft_tpu_torch.cryptoplane.proc_service import (
                ServiceProcess,
                default_rpc_timeout_s,
                service_addr_from_env,
                suite_arg_for,
            )

            kw = dict(service_kwargs or {})
            self._service_timeout_s = float(
                kw.pop("timeout_s", default_rpc_timeout_s())
            )
            # one client-side span ring for all nodes: RPC flush spans
            # carry per-client span ids, so the analyzer can pair them
            # even though clients flush concurrently
            self._cryptoplane_trace = TraceBuffer("cryptoplane")
            if isinstance(self.crypto_service, tuple):
                if kw:
                    raise ValueError(
                        f"service_kwargs {sorted(kw)} cannot be applied "
                        "to an externally-run crypto service address"
                    )
                self._service_addr = self.crypto_service
                self.crypto_service = None
            elif self.crypto_service is not None:
                if kw:
                    raise ValueError(
                        f"service_kwargs {sorted(kw)} cannot be applied "
                        "to a pre-started crypto_service process"
                    )
                self._service_addr = self.crypto_service.addr
            else:
                env_addr = service_addr_from_env()
                if env_addr is not None:
                    if kw:
                        raise ValueError(
                            f"service_kwargs {sorted(kw)} cannot be "
                            "applied to the HBBFT_TORCH_CRYPTO_SERVICE "
                            "external service"
                        )
                    self._service_addr = env_addr
                else:
                    self.crypto_service = ServiceProcess(
                        suite=suite_arg_for(self.suite),
                        backend=kw.pop("backend", None),
                        **kw,
                    ).start()
                    self._owns_service = True
                    self._service_addr = self.crypto_service.addr
        elif service_kwargs:
            raise ValueError("service_kwargs requires a service crypto arm")
        # The inline arm's backends are built before any socket is bound:
        # one that cannot start (the card's, with no card) raises here
        # and leaves nothing open.
        inline_backends = (
            {
                i: self._backend_factory(self.suite)
                for i in range(n)
                if self._impl_for(i) == "python"
            }
            if crypto == "inline"
            else {}
        )
        self._transport_kwargs: Dict[str, Any] = dict(
            max_queue_frames=max_queue_frames,
        )
        if max_frame_len is not None:
            self._transport_kwargs["max_frame_len"] = max_frame_len
        if transport_kwargs:
            self._transport_kwargs.update(transport_kwargs)

        # Bind every listener first so the full address map exists
        # before any node is constructed.
        self.nodes: Dict[int, ClusterNode] = {}
        transports: Dict[int, TcpTransport] = {}
        for i in range(n):
            transports[i] = TcpTransport(
                node_id=i,
                cluster_id=cluster_id,
                metrics=Metrics(),
                injector=injector,
                seed=seed,
                **self._transport_kwargs,
            )
        self.addr_map: Dict[int, Tuple[str, int]] = {
            i: t.addr for i, t in transports.items()
        }
        for i, t in transports.items():
            t.set_peers({j: a for j, a in self.addr_map.items() if j != i})
            self.nodes[i] = self._make_node(i, t, inline_backends.get(i))
        self._started = False

    def _impl_for(self, node_id: int) -> str:
        if isinstance(self._node_impl, str):
            return self._node_impl
        return self._node_impl.get(node_id, "python")

    @property
    def honest_ids(self) -> List[int]:
        return [i for i in range(self.n) if i not in self.byzantine]

    def _service_client(self, i: int, t: TcpTransport):
        """A fresh per-node facade onto the shared verification service
        (each carries its own local-CPU fallback backend; restart()
        re-enters here, so a reborn node gets a live client even after
        drills killed its predecessor mid-wait).  In RPC mode the
        client writes ``crypto.rpc.*`` into the node's transport
        metrics — the path every merge/scrape already walks — and its
        flush spans onto the shared ``cryptoplane`` ring."""
        if self.crypto == "service-proc":
            from hbbft_tpu_torch.cryptoplane.proc_service import RpcServiceClient

            return RpcServiceClient(
                self._service_addr,
                self.suite,
                BatchedBackend(self.suite),
                timeout_s=self._service_timeout_s,
                metrics=t.metrics,
                trace=self._cryptoplane_trace,
                client_id=f"node{i}",
            )
        return self.crypto_service.client(
            BatchedBackend(self.suite), timeout_s=self._service_timeout_s
        )

    def _make_node(
        self, i: int, t: TcpTransport, backend: Optional[CryptoBackend] = None
    ):
        netinfo = build_netinfo(self.n, self.f, self.seed, self.suite, i)
        t.tracer = self.traces[i]  # transport milestones share the ring
        service = self.crypto in ("service", "service-proc")
        if self._impl_for(i) == "native":
            from hbbft_tpu_torch.transport.native_node import NativeClusterNode

            # Inline, the engine checks the scalar suite's shares itself;
            # with a service, they go to it as opaque requests.
            node = NativeClusterNode(
                node_id=i,
                netinfo=netinfo,
                all_ids=list(range(self.n)),
                transport=t,
                suite=self.suite,
                seed=self.seed,
                batch_size=self._batch_size,
                session_id=self._session_id,
                trace=self.traces[i],
                crypto_backend=self._service_client(i, t) if service else None,
            )
        else:
            if backend is None:
                backend = (
                    self._service_client(i, t)
                    if service
                    else self._backend_factory(self.suite)
                )
            node = ClusterNode(
                node_id=i,
                netinfo=netinfo,
                all_ids=list(range(self.n)),
                transport=t,
                backend=backend,
                suite=self.suite,
                seed=self.seed,
                protocol_factory=self._factory,
                trace=self.traces[i],
            )
        spec = self.byzantine.get(i)
        if spec is not None:
            # restart() re-enters here, so a reborn Byzantine node gets
            # its strategy re-armed with fresh per-bind state
            from hbbft_tpu_torch.chaos.nodes import install_byzantine

            node = install_byzantine(
                node,
                spec,
                seed=self.seed,
                suite=self.suite,
                cluster_id=self.cluster_id,
                peer_addrs={j: a for j, a in self.addr_map.items() if j != i},
                impl=self._impl_for(i),
            )
        return node

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        if self.injector is not None:
            self.injector.start()
        for node in self.nodes.values():
            node.transport.start()
            node.start()
        self._started = True

    def stop(self) -> None:
        if self._obs_server is not None:
            self._obs_server.stop()
            self._obs_server = None
        for node in self.nodes.values():
            node.stop()
            node.transport.stop()
        # Service AFTER the nodes: a protocol thread blocked in a
        # verify wait fails over to its local fallback and exits
        # cleanly; stopping the service first would only route the
        # final flushes through the fallback needlessly.  Only the
        # service THIS cluster built — stop() is terminal, and a
        # caller-supplied service (e.g. one over TorchBackend) may
        # outlive the cluster; its owner stops it.
        if self._owns_service and self.crypto_service is not None:
            self.crypto_service.stop()
        self._phase_cache = None  # end-of-run reads must be exact
        self._started = False

    def __enter__(self) -> "LocalCluster":
        self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- failure drills ------------------------------------------------
    def kill(self, node_id: int) -> None:
        """Process death: the node's threads stop, its sockets reset,
        its protocol state is GONE (restart() builds a fresh instance)."""
        node = self.nodes[node_id]
        node.stop()
        node.transport.stop()

    def restart(self, node_id: int) -> None:
        """Re-create the killed node on its old port with fresh state."""
        old = self.nodes[node_id]
        port = old.transport.port
        t = TcpTransport(
            node_id=node_id,
            cluster_id=self.cluster_id,
            peers={j: a for j, a in self.addr_map.items() if j != node_id},
            metrics=Metrics(),
            injector=self.injector,
            seed=self.seed,
            port=port,
            **self._transport_kwargs,
        )
        node = self._make_node(node_id, t)
        self.nodes[node_id] = node
        if self._started:
            t.start()
            node.start()

    def disconnect(self, node_id: int) -> None:
        """Network outage around a live process (state survives)."""
        self.nodes[node_id].transport.set_offline(True)

    def reconnect(self, node_id: int) -> None:
        self.nodes[node_id].transport.set_offline(False)

    # -- driving -------------------------------------------------------
    def submit(self, node_id: int, input: Any) -> None:
        self.nodes[node_id].submit(input)

    def submit_all(self, input_fn: Callable[[int], Any]) -> None:
        for i in sorted(self.nodes):
            self.submit(i, input_fn(i))

    def batches(self, node_id: int) -> List[DhbBatch]:
        return self.nodes[node_id].batches()

    def batch_count(self, node_id: int) -> int:
        return self.nodes[node_id].batch_count()

    def batches_from(self, node_id: int, start: int) -> List[DhbBatch]:
        return self.nodes[node_id].batches_from(start)

    def last_committed(self, node_id: int) -> Optional[Tuple[int, int]]:
        """(era, epoch) of the node's newest committed batch (None
        before its first commit) — the /healthz liveness payload."""
        return self.nodes[node_id].last_committed()

    def wait(
        self,
        pred: Callable[["LocalCluster"], bool],
        timeout_s: float,
        poll_s: float = 0.02,
    ) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if pred(self):
                return True
            time.sleep(poll_s)
        return pred(self)

    def drive_to(
        self,
        ids: Sequence[int],
        target: int,
        timeout_s: float = 60.0,
        tag: str = "d",
        tick: Optional[Callable[[], Any]] = None,
    ) -> None:
        """Feed txns to every live node until every node in ``ids`` has
        committed >= ``target`` batches; raises on timeout.

        Submission is PACED against committed epochs (at most ~2 rounds
        of txns ahead of the slowest observed node): an unpaced feeder
        builds a transaction backlog that keeps committing epochs long
        after the target — the pacing invariant, held here
        ONCE for tests, benchmarks, and examples.

        ``tick`` (optional) runs once per poll iteration — the chaos
        scheduler pumps its timed fault events through it so a drive
        and a fault schedule share one loop.
        """
        deadline = time.monotonic() + timeout_s
        # batch_count (O(1) under the node lock) not batches() — this
        # poll fires every 50 ms and a list copy grows with the stream.
        base = min(self.batch_count(i) for i in ids)
        k = 0
        while time.monotonic() < deadline:
            if tick is not None:
                tick()
            mn = min(self.batch_count(i) for i in ids)
            if mn >= target:
                return
            if k < (mn - base) + 3:
                for i in sorted(self.nodes):
                    if self.nodes[i]._thread is not None:
                        self.submit(i, Input.user(f"{tag}-{k}-{i}"))
                k += 1
            time.sleep(0.05)
        counts = {i: self.batch_count(i) for i in sorted(self.nodes)}
        raise TimeoutError(
            f"no progress to {target} batches within {timeout_s}s: {counts}"
        )

    # -- observability -------------------------------------------------
    def merged_metrics(self, fresh: bool = False) -> Metrics:
        """Merge every node's metrics plus the derived observability
        summaries.  ``fresh=True`` bypasses the phase-summary TTL cache
        — end-of-run snapshots (benchmark JSON lines) must be exact
        even when a live scraper primed the cache seconds earlier."""
        # phase.* (round 12) + ba.rounds (round 16): the per-epoch
        # ring-derived summaries (obs/export.py + obs/analyze.py),
        # TTL-cached so a polling scraper pays the ring walk at most
        # once per 2 s.
        now = time.monotonic()
        # local read: stop() clears the attribute from another thread
        # between a scrape handler's check and its dereference
        cache = self._phase_cache
        if not fresh and cache is not None and now < cache[0]:
            sums = cache[1]
        else:
            sums = derived_summaries(self.trace_events())
            self._phase_cache = (now + 2.0, sums)
        # epoch.latency + per-node export (round 12) via the shared
        # merge helper; the cluster-only extras (injector, crypto
        # service) layer on top.
        m = merge_node_metrics(self.nodes, base=self.metrics, summaries=sums)
        if self.injector is not None:
            # injected-fault totals land in the same Prometheus dump as
            # the transport/cluster counters (faults.* gauges)
            self.injector.export_metrics(m)
        if self.crypto_service is not None and hasattr(
            self.crypto_service, "export_metrics"
        ):
            # crypto.* service plane (round 13): flush count/latency,
            # batch-size summary, queue depth, fallback totals.  The
            # RPC-mode ServiceProcess has no in-process metrics to
            # merge — its clients' crypto.rpc.* counters already ride
            # the per-node transport metrics merged above, and the
            # service process's own counters come back through its
            # stats RPC (config9 queries it directly).
            self.crypto_service.export_metrics(m)
        return m

    def trace_events(self) -> Dict[str, List[TraceEvent]]:
        """Snapshot of every trace ring, keyed by track name (the
        per-node rings plus the cluster ring when non-empty)."""
        out: Dict[str, List[TraceEvent]] = {
            buf.track: buf.snapshot() for buf in self.traces.values()
        }
        cluster_events = self.trace.snapshot()
        if cluster_events:
            out[self.trace.track] = cluster_events
        # in-thread service: the service's own ring; RPC mode: the
        # cluster-held ring the per-node clients' flush spans land on
        svc_trace = getattr(self.crypto_service, "trace", None)
        if svc_trace is None:
            svc_trace = self._cryptoplane_trace
        if svc_trace is not None:
            svc_events = svc_trace.snapshot()
            if svc_events:
                out[svc_trace.track] = svc_events
        return out

    def chrome_trace(self) -> Dict[str, Any]:
        """The merged Chrome trace-event JSON object (one track per
        node; loads in Perfetto / ``chrome://tracing``)."""
        pids = {self.traces[i].track: i for i in self.traces}
        return chrome_trace(self.trace_events(), pids=pids)

    def diag(self, stall_after_s: float = 5.0) -> Dict[str, Any]:
        """The live stall diagnosis (obs/analyze.py) over this
        cluster's rings: stalled?, the open epoch per node, which
        proposer's RBC / BA / decrypt each node is waiting on, link
        state, and a verdict naming the most-implicated (proposer,
        phase).  Served as ``/diag`` by :meth:`serve_obs`."""
        return diagnose(
            self.trace_events(), n=self.n, stall_after_s=stall_after_s
        )

    def write_trace(self, path: str) -> str:
        """Write :meth:`chrome_trace` to ``path``; returns the path."""
        import json

        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        return path

    def serve_obs(self, host: str = "127.0.0.1", port: int = 0) -> Any:
        """Start (or return) the live scrape server (``/metrics``,
        ``/trace.json``, ``/healthz``, ``/diag``) — usable mid-run;
        stopped by :meth:`stop`."""
        if self._obs_server is None:
            from hbbft_tpu_torch.obs.server import ObsServer

            self._obs_server = ObsServer(self, host=host, port=port).start()
        return self._obs_server

    def transport_stats(self) -> Dict[int, Dict[Any, Dict[str, int]]]:
        return {i: node.transport.stats() for i, node in self.nodes.items()}
