"""Subprocess cluster worker: one hbbft node per OS process.

Round 14 promotes this from a Python-only slow-tier demo into the REAL
process-per-node runtime behind ``node_impl="native_proc"``
(:class:`~hbbft_tpu_torch.transport.proc_cluster.ProcCluster`):

* ``--impl native`` runs a :class:`~hbbft_tpu_torch.transport.native_node.
  NativeClusterNode` (C++ engine + burst wire API) event loop in this
  process; ``--impl python`` keeps the oracle ClusterNode.
* **Ephemeral spawn protocol** (kills the fixed-port flake class):
  with ``--peers`` omitted the worker binds port 0, prints ONE ready
  line ``{"ready": true, "node": i, "port": p, "obs_port": q|null,
  "pid": ...}`` on stdout, then blocks for a single JSON line on stdin
  carrying the full address map (``{"peers": {"0": ["127.0.0.1", p0],
  ...}}``) the parent assembled from every worker's ready line.  The
  legacy fixed-port mode (``--port P --peers host:port,...``) still
  works byte-for-byte (no ready line, per-batch lines, summary) for
  the round-8 subprocess test.
* **Key material is DERIVED, not transported**: every worker replays
  the dealer ritual (:func:`~hbbft_tpu_torch.transport.cluster.deal_keys`)
  from ``(n, f, seed)`` — nothing secret crosses the process boundary.
* **Driving**: ``--drive presubmit`` (the cross-arm identity mode)
  self-submits the config6 deterministic workload
  (``b-<k>-<node>``, ``k < --presubmit`` rounds) BEFORE start and runs
  to ``--epochs`` committed batches; ``--drive self`` paces one txn
  per observed commit and emits one JSON line per committed batch
  (``--epochs 0`` = run until a ``{"stop": true}`` line or EOF on
  stdin — the kill/restart drill's control channel; a dead parent
  means EOF, so orphaned workers tear down by themselves).
* **Final summary** line carries ``batches_sha`` (sha256 over the
  serde encoding of the first ``--epochs`` committed batches — the
  SAME digest config6 computes, so the parent asserts cross-process
  byte-identity without scraping) plus the merged counters of
  :func:`~hbbft_tpu_torch.transport.cluster.merge_node_metrics`.
* **Obs across processes**: ``--obs-port N`` serves ``/metrics``,
  ``/trace.json`` and ``/healthz`` for THIS node (0 = ephemeral, the
  bound port is echoed in the ready line); ``--trace-file PATH`` dumps
  the node's Chrome trace at exit — the parent merges the per-worker
  files into one cluster trace on the shared wall clock
  (:func:`~hbbft_tpu_torch.obs.export.merge_chrome_traces`).

Thread budget per process: the transport selector loop + the protocol
(engine-sweep) thread + this driver thread — not the 2N threads of a
thread-mode cluster in one interpreter.

Copy of ``hbbft_tpu/transport/cluster_worker.py``.  The worker is
scalar-suite, as the reference's: the scalar suite has no device path,
so its inline backend stays the host ``BatchedBackend`` and no worker
touches the card.  A ``--crypto-service`` worker's ``RpcServiceClient``
keeps its counted local fallback (``crypto.rpc.fallbacks``), and the
service it dials is the port's :mod:`hbbft_tpu_torch.cryptoplane.
proc_service`.  Run it as ``python -m hbbft_tpu_torch.transport.
cluster_worker``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.crypto.backend import BatchedBackend
from hbbft_tpu_torch.crypto.suite import ScalarSuite
from hbbft_tpu_torch.obs.analyze import derived_summaries
from hbbft_tpu_torch.obs.export import chrome_trace
from hbbft_tpu_torch.obs.trace import TraceBuffer
from hbbft_tpu_torch.protocols.queueing_honey_badger import Input
from hbbft_tpu_torch.transport.cluster import (
    ClusterNode,
    _default_protocol_factory,
    build_netinfo,
    merge_node_metrics,
)
from hbbft_tpu_torch.transport.transport import TcpTransport
from hbbft_tpu_torch.utils import serde


class _SoloClusterView:
    """Single-node cluster facade: exactly the surface
    :class:`~hbbft_tpu_torch.obs.server.ObsServer` and the metric merge
    expect from :class:`~hbbft_tpu_torch.transport.cluster.LocalCluster`,
    backed by THIS process's one node."""

    def __init__(
        self,
        node_id: int,
        node: Any,
        trace: TraceBuffer,
        consensus_n: Optional[int] = None,
        crypto_trace: Optional[TraceBuffer] = None,
    ) -> None:
        self.node_id = node_id
        self.nodes = {node_id: node}
        self.n = 1
        # The CLUSTER's consensus size (proposer universe) — this view
        # holds one node, but its /diag must reason about all N
        # proposers' instances on this node's timeline.
        self.consensus_n = consensus_n
        self.byzantine: Dict[int, Any] = {}
        self.trace = trace
        # RPC crypto-plane mode (round 18): this node's flush spans
        # ride their own "cryptoplane" ring so the analyzer's flush
        # attribution works per worker (and survives the parent-side
        # Chrome-trace merge as its own track).
        self.crypto_trace = crypto_trace
        # Same 2 s phase-summary TTL cache as LocalCluster: a polling
        # scraper must not re-pay the ring walk + quantile sort per
        # request (a parent drill polls /metrics many times a second
        # while this process is busy catching up).
        self._phase_cache: Optional[Tuple[float, Dict[str, Any]]] = None

    def batch_count(self, i: int) -> int:
        return self.nodes[i].batch_count()

    def last_committed(self, i: int) -> Optional[Tuple[int, int]]:
        return self.nodes[i].last_committed()

    def trace_events(self) -> Dict[str, list]:
        events = self.trace.snapshot()
        out = {self.trace.track: events} if events else {}
        if self.crypto_trace is not None:
            cp = self.crypto_trace.snapshot()
            if cp:
                out[self.crypto_trace.track] = cp
        return out

    def merged_metrics(self, fresh: bool = False) -> Any:
        now = time.monotonic()
        cache = self._phase_cache
        if not fresh and cache is not None and now < cache[0]:
            sums = cache[1]
        else:
            sums = derived_summaries(self.trace_events())
            self._phase_cache = (now + 2.0, sums)
        return merge_node_metrics(self.nodes, summaries=sums)

    def chrome_trace(self) -> Dict[str, Any]:
        return chrome_trace(
            self.trace_events(), pids={self.trace.track: self.node_id}
        )


def batches_digest(batches: List[Any], upto: int) -> str:
    """config6's cross-arm identity digest, bit for bit."""
    digest = hashlib.sha256()
    for b in batches[:upto]:
        digest.update(serde.dumps((b.era, b.epoch, b.contributions)))
    return digest.hexdigest()[:16]


def _read_peer_map(n: int) -> Dict[int, Tuple[str, int]]:
    """Block for the parent's one-line address map on stdin."""
    line = sys.stdin.readline()
    if not line:
        raise RuntimeError("stdin closed before the peer map arrived")
    obj = json.loads(line)
    peers = {int(k): (v[0], int(v[1])) for k, v in obj["peers"].items()}
    if len(peers) != n:
        raise RuntimeError(f"peer map has {len(peers)} entries, want {n}")
    return peers


def _watch_stdin(stop: threading.Event) -> None:
    """Drain stdin until a stop command or EOF; either sets ``stop``.
    EOF doubles as orphan cleanup — a dead parent closes the pipe."""
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            if json.loads(line).get("stop"):
                break
        except ValueError:
            continue
    stop.set()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--node-id", type=int, required=True)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--num-faulty", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--impl", choices=("python", "native"), default="python")
    ap.add_argument(
        "--port",
        type=int,
        default=0,
        help="listener port (0 = ephemeral; echoed in the ready line)",
    )
    ap.add_argument(
        "--peers",
        default=None,
        help="comma list host:port indexed by node id (our own slot "
        "included).  Omitted = handshake mode: bind port 0, print the "
        "ready line, read the address map from stdin.",
    )
    ap.add_argument(
        "--drive",
        choices=("self", "presubmit"),
        default="self",
        help="self = pace one txn per commit + emit per-batch lines "
        "(legacy; --epochs 0 runs until stdin stop/EOF); presubmit = "
        "deterministic pre-start workload, summary only",
    )
    ap.add_argument(
        "--presubmit",
        type=int,
        default=-1,
        help="presubmit rounds (default epochs+4, the config6 workload)",
    )
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--timeout-s", type=float, default=120.0)
    ap.add_argument("--session-id", default="tcp-cluster")
    ap.add_argument("--cluster-id", default="hbbft-tpu/cluster/v1")
    ap.add_argument(
        "--obs-port",
        type=int,
        default=None,
        help="serve /metrics /trace.json /healthz for this node "
        "(0 = ephemeral, echoed in the ready line)",
    )
    ap.add_argument(
        "--trace-file",
        default=None,
        help="write this node's Chrome trace here at exit",
    )
    ap.add_argument(
        "--metrics",
        action="store_true",
        help="embed the full metrics JSON in the summary line",
    )
    ap.add_argument(
        "--crypto-service",
        default=None,
        help="host:port of a crypto-plane service process "
        "(hbbft_tpu_torch.cryptoplane.proc_service); this node's share checks "
        "route there with a local-BatchedBackend fallback",
    )
    ap.add_argument(
        "--crypto-timeout-s",
        type=float,
        default=None,
        help="RPC round-trip budget before a flush falls back locally "
        "(default HBBFT_TORCH_CRYPTO_RPC_TIMEOUT_S)",
    )
    args = ap.parse_args(argv)

    n = args.n
    node_id = args.node_id
    f = args.num_faulty if args.num_faulty >= 0 else (n - 1) // 3
    suite = ScalarSuite()
    handshake = args.peers is None

    peers: Optional[Dict[int, Tuple[str, int]]] = None
    if not handshake:
        addrs = []
        for slot in args.peers.split(","):
            host, _, port = slot.rpartition(":")
            addrs.append((host, int(port)))
        if len(addrs) != n:
            raise SystemExit("--peers must list every node")
        peers = {j: addrs[j] for j in range(n) if j != node_id}

    transport = TcpTransport(
        node_id=node_id,
        cluster_id=args.cluster_id.encode(),
        peers=peers,
        port=args.port,
        seed=args.seed,
    )
    trace = TraceBuffer(f"node{node_id}")
    transport.tracer = trace

    crypto_trace: Optional[TraceBuffer] = None
    crypto_backend: Any = None
    if args.crypto_service is not None:
        # Round 18: route this node's share checks through the crypto
        # service process.  Metrics land on the transport's Metrics (the
        # object merge_node_metrics already walks), spans on their own
        # cryptoplane ring; verdict purity makes the fallback safe.
        from hbbft_tpu_torch.cryptoplane.proc_service import (
            RpcServiceClient,
            parse_addr,
        )

        crypto_trace = TraceBuffer("cryptoplane")
        crypto_backend = RpcServiceClient(
            parse_addr(args.crypto_service),
            suite,
            BatchedBackend(suite),
            timeout_s=args.crypto_timeout_s,
            metrics=transport.metrics,
            trace=crypto_trace,
            client_id=f"node{node_id}",
        )

    netinfo = build_netinfo(n, f, args.seed, suite, node_id)
    if args.impl == "native":
        from hbbft_tpu_torch.transport.native_node import NativeClusterNode

        node: Any = NativeClusterNode(
            node_id=node_id,
            netinfo=netinfo,
            all_ids=list(range(n)),
            transport=transport,
            suite=suite,
            seed=args.seed,
            batch_size=args.batch_size,
            session_id=args.session_id.encode(),
            trace=trace,
            crypto_backend=crypto_backend,
        )
    else:
        node = ClusterNode(
            node_id=node_id,
            netinfo=netinfo,
            all_ids=list(range(n)),
            transport=transport,
            backend=(
                crypto_backend
                if crypto_backend is not None
                else BatchedBackend(suite)
            ),
            suite=suite,
            seed=args.seed,
            protocol_factory=_default_protocol_factory(
                args.batch_size, args.session_id.encode(), n
            ),
            trace=trace,
        )

    view = _SoloClusterView(
        node_id, node, trace, consensus_n=n, crypto_trace=crypto_trace
    )
    obs_server = None
    obs_port: Optional[int] = None
    if args.obs_port is not None:
        from hbbft_tpu_torch.obs.server import ObsServer

        obs_server = ObsServer(view, port=args.obs_port).start()
        obs_port = obs_server.port

    if handshake:
        print(
            json.dumps(
                {
                    "ready": True,
                    "node": node_id,
                    "port": transport.port,
                    "obs_port": obs_port,
                    "impl": args.impl,
                    "pid": os.getpid(),
                },
                sort_keys=True,
            ),
            flush=True,
        )
        transport.set_peers(_read_peer_map(n))

    stop_flag = threading.Event()
    if handshake or args.epochs <= 0:
        # After the peer map, stdin becomes the stop/orphan channel.
        # Open-ended runs (--epochs 0) need it in EITHER mode — the
        # documented contract is "run until stdin stop/EOF"; bounded
        # legacy runs (--peers + --epochs N) skip it so a closed
        # inherited stdin can't end them early.
        threading.Thread(
            target=_watch_stdin, args=(stop_flag,), daemon=True
        ).start()

    presubmit = args.presubmit if args.presubmit >= 0 else args.epochs + 4
    if args.drive == "presubmit":
        # The config6 deterministic workload, submitted BEFORE start so
        # every arm's proposers see identical txn queues (per-node
        # order is k-ascending, exactly LocalCluster's presubmit loop).
        for k in range(presubmit):
            node.submit(Input.user(f"b-{k}-{node_id}"))

    t0 = time.perf_counter()
    transport.start()
    node.start()

    reported = 0
    submitted = 0
    deadline = time.monotonic() + args.timeout_s
    done = False
    try:
        while time.monotonic() < deadline and not stop_flag.is_set():
            count = node.batch_count()
            if args.drive == "self":
                if submitted <= count:
                    node.submit(Input.user(f"tx-{node_id}-{submitted}"))
                    submitted += 1
                for b in node.batches_from(reported):
                    print(
                        json.dumps(
                            {
                                "era": b.era,
                                "epoch": b.epoch,
                                "contributions": [
                                    [p, list(c)] for p, c in b.contributions
                                ],
                            },
                            sort_keys=True,
                        ),
                        flush=True,
                    )
                    reported += 1
            else:
                reported = count
            if args.epochs > 0 and reported >= args.epochs:
                done = True
                break
            time.sleep(0.02)
        if args.epochs <= 0:
            # open-ended run: a stop command (or parent EOF) is success
            done = stop_flag.is_set()
        wall = time.perf_counter() - t0
        batches = node.batches()
        upto = args.epochs if args.epochs > 0 else len(batches)
        m = view.merged_metrics(fresh=True)
        summary = {
            "done": done,
            "node": node_id,
            "impl": args.impl,
            "port": transport.port,
            "batches": len(batches),
            "batches_sha": batches_digest(batches, upto),
            # per-epoch contribution counts over the digest window: the
            # parent's "non-empty epochs" check, and the tell for the
            # cross-RUN flake class where one proposer's RBC misses an
            # epoch's BA cut (subset of n-1: still agreement-safe and
            # intra-run identical, but the digest differs from a
            # full-participation run)
            "epoch_contribs": [len(b.contributions) for b in batches[:upto]],
            "faults": len(getattr(node, "faults", ()))
            or m.counters.get("cluster.protocol_faults", 0),
            "msgs_handled": m.counters.get("cluster.msgs_handled", 0),
            "accepts": m.counters.get("transport.accepts", 0),
            "bad_payload": m.counters.get("cluster.bad_payload", 0),
            "handler_errors": m.counters.get("cluster.handler_errors", 0),
            # ring-overflow honesty: nonzero means this node's trace
            # (and everything derived from it) is silently partial
            "trace_dropped": int(m.gauges.get("trace.dropped", 0)),
            "wall_s": round(wall, 3),
        }
        if args.crypto_service is not None:
            # the crypto-plane RPC story in one glance: how many flushes
            # rode the service vs fell back locally (the kill drill's
            # fallback flip shows up here)
            summary["crypto_rpc"] = {
                "calls": m.counters.get("crypto.rpc.calls", 0),
                "requests": m.counters.get("crypto.rpc.requests", 0),
                "fallbacks": m.counters.get("crypto.rpc.fallbacks", 0),
                "fallback_requests": m.counters.get(
                    "crypto.rpc.fallback_requests", 0
                ),
                "reconnects": m.counters.get("crypto.rpc.reconnects", 0),
                "merged_requests": m.counters.get(
                    "crypto.rpc.merged_requests", 0
                ),
            }
        if args.metrics:
            summary["metrics"] = m.to_json()
        print(json.dumps(summary, sort_keys=True), flush=True)
        return 0 if done else 1
    finally:
        node.stop()
        transport.stop()
        if obs_server is not None:
            obs_server.stop()
        if args.trace_file:
            with open(args.trace_file, "w") as fh:
                json.dump(view.chrome_trace(), fh)


if __name__ == "__main__":
    sys.exit(main())
