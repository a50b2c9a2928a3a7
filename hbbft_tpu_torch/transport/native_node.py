"""Native-engine cluster node: C++ decode+handle loop on real sockets.

The round-8 Python cluster node plateaued at ~4.8k handled msgs/s
regardless of N because every frame was serde-decoded and protocol-
stepped by a Python thread, while the same engine moves 1.7M msgs/s
in-process (BASELINE.md round 8).  This runtime closes that gap with
the engine's message-boundary API (round 9):

* the transport's burst consumer (``TcpTransport.on_wire_batch``)
  queues one inbox item per read burst — a list of ``(nmsg, data)``
  wire records (plain MSG payloads and raw MSGB bodies), not one
  Python callback per frame;
* the protocol thread packs each burst into ONE ctypes call
  (``hbe_node_ingest_wire``: MSGB body walk + decode + epoch-announce
  handling + enqueue, all in C — no Python slicing of batch bodies),
  drains the engine's delivery queue with one ``hbe_run``, and hands
  the accumulated egress back as per-destination MSGB bodies built in
  C (``hbe_node_egress_drain_msgb`` — the round-20 coalescing fast
  path; a transport built with ``coalesce=False`` falls back to the
  round-9 per-frame drain);
* the per-BATCH layers stay the reused Python stack
  (``QueueingHoneyBadger`` over :class:`~hbbft_tpu_torch.native_engine.
  NativeDhb`), fired through the engine's batch callbacks exactly as in
  :class:`~hbbft_tpu_torch.native_engine.NativeQhbNet`.

The Python :class:`~hbbft_tpu_torch.transport.cluster.ClusterNode` is kept as
the cross-check oracle: same keys, same rng ritual, same eager
(``flush_every=1``) crypto cadence — a native cluster at seed s commits
byte-identical batches to the Python-node cluster at seed s
(tests/test_torch_native_cluster.py pins this against the reference,
plus the fault drills).

Threading: the protocol thread is the ONLY caller into the engine
(ingest / run / drain / stats / fault counters — the engine is not
thread-safe); the transport thread only feeds the bounded inbox, and
readers snapshot ``outputs`` (a plain list) under the GIL.

Copy of ``hbbft_tpu/transport/native_node.py`` over the port's engine
(:mod:`hbbft_tpu_torch.native_engine`) and transport.  Its nodes are
scalar-suite, as the reference's: the cluster wire grammar pins the
scalar suite's share encoding, so they have no card path.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, List, Optional, Tuple

from hbbft_tpu_torch.crypto.suite import Suite
from hbbft_tpu_torch.native_engine import NativeNodeEngine
from hbbft_tpu_torch.obs.trace import TraceBuffer
from hbbft_tpu_torch.protocols.dynamic_honey_badger import DhbBatch
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.transport.cluster import track_commits
from hbbft_tpu_torch.transport.transport import TcpTransport
from hbbft_tpu_torch.utils.metrics import EpochTracker, Metrics

#: Max inbox items coalesced into one processing sweep.  Bounds how
#: long egress draining can starve behind a flood of inbound bursts;
#: each item is already a whole read burst, so 256 sweeps ~16 MiB.
_MAX_COALESCE = 256


class NativeClusterNode:
    """One cluster node backed by a :class:`NativeNodeEngine`.

    Public surface mirrors :class:`~hbbft_tpu_torch.transport.cluster.
    ClusterNode` (``submit`` / ``batches`` / ``start`` / ``stop`` /
    ``metrics`` / ``transport``), so :class:`LocalCluster` drives both
    implementations through one code path.
    """

    def __init__(
        self,
        node_id: int,
        netinfo: NetworkInfo,
        all_ids: List[int],
        transport: TcpTransport,
        suite: Suite,
        seed: int,
        batch_size: int = 8,
        session_id: bytes = b"tcp-cluster",
        metrics: Optional[Metrics] = None,
        inbox_cap: int = 50_000,
        trace: Optional[TraceBuffer] = None,
        crypto_backend: Optional[Any] = None,
        flush_every: Optional[int] = None,
    ) -> None:
        self.id = node_id
        self.netinfo = netinfo
        self.all_ids = list(all_ids)
        self.transport = transport
        self.metrics = metrics if metrics is not None else transport.metrics
        # Flight recorder (round 12): the engine's bounded event log is
        # drained into this ring once per sweep (one ctypes call); the
        # engine side emits with no per-event allocation.
        self.trace = trace
        self.epochs = EpochTracker()
        self._last_commit_t = time.time()
        self._seen_batches = 0
        self._prof_last: dict = {}  # (kind, type) -> last published value
        self._next_prof_sync = 0.0
        # crypto_backend (round 13): run the engine's external-crypto
        # mode with share verification routed through this backend —
        # the cluster crypto-service arm (a ServiceClient of the shared
        # CryptoPlaneService).  The deferred cadence (flush_every=0 =
        # flush per ingest sweep at queue-dry) maximizes what each
        # service batch can merge; output-identical to the inline
        # scalar arm by the deferred-verification invariant.
        engine_kwargs: dict = {}
        if crypto_backend is not None:
            engine_kwargs["backend"] = crypto_backend
            engine_kwargs["flush_every"] = (
                0 if flush_every is None else flush_every
            )
        elif flush_every is not None:
            engine_kwargs["flush_every"] = flush_every
        self.engine = NativeNodeEngine(
            node_id,
            netinfo,
            seed=seed,
            batch_size=batch_size,
            session_id=session_id,
            suite=suite,
            trace_capacity=8192 if trace is not None else 0,
            **engine_kwargs,
        )
        # Bounded, like ClusterNode.inbox: a peer streaming faster than
        # the engine drains hits receive-side backpressure (the burst is
        # refused, the transport drops the connection un-acked, resume
        # retransmits later) instead of growing memory.
        self.inbox: "queue.Queue[tuple]" = queue.Queue(maxsize=inbox_cap)
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._synced_faults = 0  # engine fault entries already exported
        # Engine-ring drop count, cached by the protocol thread's sync
        # (the engine is not thread-safe, so trace_dropped() must not
        # call into it from a scraper thread); GIL-atomic int read.
        self._engine_trace_dropped = 0
        # Ingress: the wire-record consumer (raw MSGB bodies cross as
        # one record, walked in C; plain MSG payloads as records of
        # their own — accept-both interop, regardless of the coalesce
        # knob).
        transport.on_wire_batch = self._on_wire_burst

    # -- transport thread ----------------------------------------------
    def _on_wire_burst(
        self, sender: Any, records: List[Tuple[int, bytes]]
    ) -> int:
        try:
            self.inbox.put_nowait(("wire", sender, records))
        except queue.Full:
            self.metrics.count("cluster.inbox_overflow")
            return 0  # nothing consumed: connection drops un-acked
        return len(records)  # frames, all-or-nothing (batch-atomic ACK)

    # -- any thread ----------------------------------------------------
    def submit(self, input: Any) -> None:
        try:
            self.inbox.put_nowait(("input", input, None))
        except queue.Full:
            self.metrics.count("cluster.input_dropped")

    def batches(self) -> List[DhbBatch]:
        # outputs is append-only on the protocol thread; list() under
        # the GIL is a consistent snapshot (same guarantee ClusterNode's
        # lock provides for its outputs list).
        return list(self.engine.outputs)

    def batch_count(self) -> int:
        return len(self.engine.outputs)  # len() is GIL-atomic

    def batches_from(self, start: int) -> List[DhbBatch]:
        return self.engine.outputs[start:]

    def last_committed(self) -> Optional[Tuple[int, int]]:
        """(era, epoch) of the newest committed batch, or None."""
        outs = self.engine.outputs
        if not outs:
            return None
        b = outs[-1]  # GIL-atomic tail read of an append-only list
        return (b.era, b.epoch)

    def trace_dropped(self) -> int:
        """Total trace events lost to overflow: the Python ring's drop
        count plus the engine ring's (as of the last protocol-thread
        sync) — the honest-truncation gauge behind ``trace.<i>.dropped``."""
        py = self.trace.dropped if self.trace is not None else 0
        return py + self._engine_trace_dropped

    def start(self) -> None:
        assert self._thread is None
        self._stop = False
        self._last_commit_t = time.time()
        self._thread = threading.Thread(
            target=self._run, name=f"native-node-{self.id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop = True  # flag, not a queue item: survives a full inbox
        t = self._thread
        t.join(timeout=10)
        self._thread = None
        # Final export only once the protocol thread has ACTUALLY
        # exited: then this (main-thread) engine access preserves the
        # one-caller rule temporally and end-of-run metrics carry the
        # full counters.  A thread that outlived the timed join (wedged
        # handler) still owns the engine — touching the non-thread-safe
        # vectors concurrently would race it, so skip the sync.
        if not t.is_alive():
            self._sync_engine_counters(force=True)

    # -- protocol thread -----------------------------------------------
    def _run(self) -> None:
        eng = self.engine
        egress: List[tuple] = []
        def collect(dest: int, payload: bytes) -> None:
            egress.append((dest, payload))
        # Egress arm, resolved once: C-built MSGB bodies when the knob
        # is on, else the round-9 per-frame drain.
        coalesce_out = self.transport.coalesce
        while not self._stop:
            try:
                item = self.inbox.get(timeout=0.2)
            except queue.Empty:
                self._guarded_sync()
                continue
            burst = [item]
            while len(burst) < _MAX_COALESCE:
                try:
                    burst.append(self.inbox.get_nowait())
                except queue.Empty:
                    break
            # Exception scope is per ingest-group/input, NOT the whole
            # sweep: the coalesced items behind a failing one were
            # already consumed + ACKed by the transport, so skipping
            # them would lose acknowledged frames with no retransmit
            # (the Python node's blast radius is one inbox item —
            # cluster.py keeps the same stance).  A handler bug must
            # not take the thread down mid-run either way — count it
            # loudly; tests assert the counter stays zero.
            i = 0
            while i < len(burst):
                if burst[i][0] == "wire":
                    wsenders: List[int] = []
                    records: List[Tuple[int, bytes]] = []
                    nmsgs = 0
                    while i < len(burst) and burst[i][0] == "wire":
                        _, s, recs = burst[i]
                        wsenders.extend([s] * len(recs))
                        records.extend(recs)
                        nmsgs += sum(nm if nm else 1 for nm, _ in recs)
                        i += 1
                    try:
                        handled = eng.ingest_wire(wsenders, records)
                        self.metrics.count("cluster.msgs_handled", handled)
                        bad = nmsgs - handled
                        if bad:
                            self.metrics.count("cluster.bad_payload", bad)
                        eng.run()
                    except Exception:
                        self.metrics.count("cluster.handler_errors")
                else:  # input
                    item_input = burst[i][1]
                    i += 1
                    try:
                        eng.handle_input(item_input)
                    except Exception:
                        self.metrics.count("cluster.handler_errors")
            try:
                if coalesce_out:
                    self._drain_egress_coalesced(egress)
                else:
                    egress.clear()
                    eng.drain_egress(collect)
                    if egress:
                        # one control-plane hand-off for the whole
                        # sweep's emissions (send_many: one wakeup,
                        # one drain op)
                        self.transport.send_many(egress)
            except Exception:
                self.metrics.count("cluster.handler_errors")
            self._guarded_sync()

    def _drain_egress_coalesced(self, scratch: List[tuple]) -> None:
        """Egress sweep on the MSGB fast path: the engine hands back
        per-destination MSGB bodies built in C; multi-message groups
        stay pre-packed bodies (one frame each, zero Python re-packing)
        and singleton groups are stripped to plain MSG payloads —
        byte-identical to the uncoalesced arm.  The WHOLE sweep leaves
        as one :meth:`TcpTransport.send_wire` call (one wakeup byte,
        one loop-thread drain op for all destinations — not one post
        per group), and since send_wire preserves emission order,
        per-destination FIFO holds with no buffering dance."""
        scratch.clear()  # (dest, count, data) wire records, in order

        def emit(dest: int, nmsg: int, body: bytes) -> None:
            if nmsg <= 1:
                scratch.append((dest, 1, body[8:]))
            else:
                scratch.append((dest, nmsg, body))

        self.engine.drain_egress_msgb(emit, self.transport.max_frame_len - 1)
        if scratch:
            self.transport.send_wire(list(scratch))
            scratch.clear()

    def _guarded_sync(self) -> None:
        """Protocol-thread sync with the standard never-die guard: the
        exporter grew real work in round 12 (ring drain + struct
        decode + tracker math + prof reads) and an exporter bug must
        not take the protocol thread down mid-run — count it loudly
        like every other handler error (tests assert the counter stays
        zero)."""
        try:
            self._sync_engine_counters()
        except Exception:
            self.metrics.count("cluster.handler_errors")

    def _sync_engine_counters(self, force: bool = False) -> None:
        """Export engine-side observables into Metrics / the trace ring
        (protocol thread only while it runs: none of the engine's
        vectors are thread-safe).  Per call: fault deltas, committed-
        batch commit latencies, and the engine trace drain; the typed
        profiling counters (``engine.cyc.* / engine.msgs.*``) publish on
        a ~1 s throttle (32 ctypes reads — too heavy per sweep, cheap
        per second) and unconditionally with ``force`` (node stop)."""
        eng = self.engine
        if not eng.handle:
            return
        total = int(eng.lib.hbe_fault_count(eng.handle, self.id))
        if total > self._synced_faults:
            self.metrics.count(
                "cluster.protocol_faults", total - self._synced_faults
            )
            self._synced_faults = total
        outs = eng.outputs
        committed = len(outs) > self._seen_batches
        if committed:
            new = outs[self._seen_batches:]
            self._seen_batches = len(outs)
            self._last_commit_t = track_commits(
                self.epochs, new, self._last_commit_t
            )
        if self.trace is not None:
            events = eng.drain_trace()
            if events:
                self.trace.extend(events)
            self._engine_trace_dropped = eng.trace_dropped
        now = time.monotonic()
        # Also publish on commit sweeps (at most once per epoch): a
        # mid-run scrape right after an epoch lands must see its cycles
        # without waiting out the idle throttle.
        if force or committed or now >= self._next_prof_sync:
            self._next_prof_sync = now + 1.0
            # Deltas as COUNTERS (not gauges): counters sum across the
            # per-node Metrics in merged_metrics(), so the cluster dump
            # carries cluster-wide native cycle splits.
            for tname, st in eng.prof_stats().items():
                for field, kind in (("cycles", "cyc"), ("count", "msgs")):
                    cur = st[field]
                    key = (kind, tname)
                    delta = cur - self._prof_last.get(key, 0)
                    if delta > 0:
                        self.metrics.count(f"engine.{kind}.{tname}", delta)
                        self._prof_last[key] = cur
