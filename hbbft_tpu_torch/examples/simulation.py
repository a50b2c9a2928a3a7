"""Network simulation benchmark for QueueingHoneyBadger.

Reference behavior: upstream ``examples/simulation.rs`` (SURVEY.md §2 #17)
— an N-node virtual network running ``QueueingHoneyBadger`` (wrapped in
``SenderQueue``) over a hardware-quality model (link latency, bandwidth,
CPU-speed factor, per-message CPU-time accounting), printing a per-epoch
throughput/latency table.  Same capability, re-built on this framework's
sans-I/O state machines and deferred-verification pools.

The simulation is event-driven over *virtual time*:

* each node has a virtual clock; handling a message advances it by the
  measured wall CPU time divided by the CPU-speed factor;
* a message sent at time t arrives at ``t + latency + size/bandwidth``;
* an epoch is "done" at the virtual time the LAST correct node outputs
  its batch for that epoch.

Usage::

    python3 -m hbbft_tpu_torch.examples.simulation --nodes 16 --txns 256 --batch-size 256
    python3 -m hbbft_tpu_torch.examples.simulation --nodes 10 --suite bls --backend torch

With ``--suite bls`` the real BLS12-381 threshold crypto runs (and
``--backend torch`` checks its shares on the CUDA card through
:class:`~hbbft_tpu_torch.crypto.device.backend.TorchBackend`, in batches
set by ``--flush-every``); the default insecure scalar suite benchmarks
the protocol plane alone, like the reference's simulation does with its
always-on native crypto but without a 20-minute runtime.

Copy of ``examples/simulation.py``.  ``--backend torch`` runs on ``cuda``
and raises when there is no card; ``--device cpu`` runs ``TorchBackend``'s
plain stages instead, and only when asked.
"""

from __future__ import annotations

import argparse
import heapq
import random
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from hbbft_tpu_torch.crypto.backend import BatchedBackend, EagerBackend
from hbbft_tpu_torch.crypto.keys import SecretKey, SecretKeySet
from hbbft_tpu_torch.crypto.pool import VerifyPool
from hbbft_tpu_torch.crypto.suite import ScalarSuite
from hbbft_tpu_torch.protocols.dynamic_honey_badger import DhbBatch
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.queueing_honey_badger import Input, QueueingHoneyBadger
from hbbft_tpu_torch.protocols.sender_queue import SenderQueue
from hbbft_tpu_torch.protocols.traits import Step
from hbbft_tpu_torch.utils import sizeof


@dataclass
class HwQuality:
    """Hardware-quality model (upstream ``HwQuality``): per-link latency
    in seconds, bandwidth in bytes/second, and a CPU-speed factor
    (1.0 = this host's speed; 0.5 = half as fast)."""

    latency_s: float = 0.1
    bandwidth_bps: float = 2_000_000.0
    cpu_factor: float = 1.0

    def net_delay(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.bandwidth_bps

    def cpu_time(self, wall_s: float) -> float:
        return wall_s / self.cpu_factor


@dataclass(order=True)
class _Event:
    at: float
    seq: int
    dest: Any = field(compare=False)
    sender: Any = field(compare=False)
    payload: Any = field(compare=False)


@dataclass
class SimNode:
    id: Any
    protocol: SenderQueue
    pool: VerifyPool
    rng: random.Random
    clock: float = 0.0
    cpu_used: float = 0.0
    sent_msgs: int = 0
    sent_bytes: int = 0
    outputs: List[DhbBatch] = field(default_factory=list)
    epoch_done_at: Dict[Tuple[int, int], float] = field(default_factory=dict)
    committed: List[Any] = field(default_factory=list)


class TimedNetwork:
    """Event-driven virtual-time network (upstream ``TestNetwork``)."""

    def __init__(self, nodes: Dict[Any, SimNode], backend, hw: HwQuality,
                 flush_every: int = 1) -> None:
        from hbbft_tpu_torch.utils.metrics import Metrics

        self.nodes = nodes
        self.backend = backend
        self.hw = hw
        self.flush_every = max(1, flush_every)
        self.events: List[_Event] = []
        self._seq = 0
        self.delivered = 0
        self._since_flush: Dict[Any, int] = {nid: 0 for nid in nodes}
        self.metrics = Metrics()

    def _push(self, at: float, dest: Any, sender: Any, payload: Any) -> None:
        self._seq += 1
        heapq.heappush(self.events, _Event(at, self._seq, dest, sender, payload))

    def _emit(self, node: SimNode, step: Step) -> None:
        for out in step.output:
            if isinstance(out, DhbBatch):
                node.outputs.append(out)
                node.epoch_done_at.setdefault((out.era, out.epoch), node.clock)
                for _, contrib in out.contributions:
                    if isinstance(contrib, (list, tuple)):
                        node.committed.extend(contrib)
        all_ids = sorted(self.nodes)
        for tm in step.messages:
            size = sizeof.estimate(tm.message)
            for dest in tm.target.recipients(all_ids, node.id):
                node.sent_msgs += 1
                node.sent_bytes += size
                self._push(node.clock + self.hw.net_delay(size), dest,
                           node.id, tm.message)

    def _timed(self, node: SimNode, fn, *args) -> Step:
        t0 = time.perf_counter()
        step = fn(*args)
        wall = time.perf_counter() - t0
        node.clock += self.hw.cpu_time(wall)
        node.cpu_used += wall
        return step

    def _maybe_flush(self, node: SimNode) -> None:
        self._since_flush[node.id] += 1
        if self._since_flush[node.id] < self.flush_every:
            return
        self._since_flush[node.id] = 0
        while node.pool:
            self.metrics.count("verify_requests", len(node.pool))
            with self.metrics.timer("verify_flush"):
                step = self._timed(node, node.pool.flush, self.backend)
            self._emit(node, step)

    def input(self, nid: Any, value: Any) -> None:
        node = self.nodes[nid]
        step = self._timed(node, node.protocol.handle_input, value, node.rng)
        self._emit(node, step)
        self._maybe_flush(node)

    def run(self, done) -> None:
        while not done(self):
            if self.events:
                ev = heapq.heappop(self.events)
                node = self.nodes.get(ev.dest)
                if node is None:
                    continue
                node.clock = max(node.clock, ev.at)
                step = self._timed(node, node.protocol.handle_message,
                                   ev.sender, ev.payload, node.rng)
                self.delivered += 1
                self._emit(node, step)
                self._maybe_flush(node)
                continue
            # No events in flight: drain deferred verifies to unblock.
            progressed = False
            for node in self.nodes.values():
                while node.pool:
                    progressed = True
                    self._emit(node, self._timed(node, node.pool.flush,
                                                 self.backend))
            if not progressed and not self.events:
                raise RuntimeError("network idle but goal not met")


def build_network(args) -> TimedNetwork:
    rng = random.Random(args.seed)
    if args.suite == "bls":
        from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
        suite = BLSSuite()
    else:
        suite = ScalarSuite()
    if args.backend == "torch":
        from hbbft_tpu_torch.crypto.device.backend import TorchBackend
        backend = TorchBackend(suite, device=args.device)
    elif args.backend == "eager":
        backend = EagerBackend(suite)
    else:
        backend = BatchedBackend(suite)

    n = args.nodes
    f = (n - 1) // 3
    ids = list(range(n))
    sks = SecretKeySet.random(f, rng, suite)
    pks = sks.public_keys()
    node_sks = {i: SecretKey.random(rng, suite) for i in ids}
    node_pks = {i: node_sks[i].public_key() for i in ids}

    hw = HwQuality(latency_s=args.lag_ms / 1000.0,
                   bandwidth_bps=args.bw_kbps * 125.0,
                   cpu_factor=args.cpu_factor)

    nodes: Dict[Any, SimNode] = {}
    for i in ids:
        ni = NetworkInfo(
            our_id=i,
            val_ids=ids,
            public_key_set=pks,
            secret_key_share=sks.secret_key_share(i),
            public_keys=dict(node_pks),
            secret_key=node_sks[i],
        )
        pool = VerifyPool()
        proto = SenderQueue.wrap(
            lambda s, ni=ni: QueueingHoneyBadger(
                ni, s, batch_size=args.batch_size, session_id=b"simulation"),
            pool, peers=ids)
        nodes[i] = SimNode(id=i, protocol=proto, pool=pool,
                           rng=random.Random((args.seed << 16) ^ (i + 1)))
    return TimedNetwork(nodes, backend, hw, flush_every=args.flush_every)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--nodes", type=int, default=10, help="network size N")
    p.add_argument("--txns", type=int, default=128, help="total transactions")
    p.add_argument("--txn-size", type=int, default=16, help="bytes per txn")
    p.add_argument("--batch-size", type=int, default=128,
                   help="target txns per epoch across the network")
    p.add_argument("--lag-ms", type=float, default=100.0, help="link latency")
    p.add_argument("--bw-kbps", type=float, default=2000.0, help="bandwidth")
    p.add_argument("--cpu-factor", type=float, default=1.0,
                   help="CPU speed multiplier (0.5 = half speed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--suite", choices=["scalar", "bls"], default="scalar")
    p.add_argument("--backend", choices=["eager", "batched", "torch"],
                   default="batched")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where --backend torch runs (cpu: its plain stages)")
    p.add_argument("--flush-every", type=int, default=1,
                   help="deliveries per deferred-verify flush (device batching)")
    return p.parse_args(argv)


def run(net: TimedNetwork, args) -> Tuple[List[bytes], float]:
    """Input ``args.txns`` seeded transactions round robin and run until
    every node has committed all of them; returns them and the wall
    seconds of the run."""
    rng = random.Random(args.seed + 7)
    txns = [rng.randbytes(args.txn_size) for _ in range(args.txns)]
    for i, txn in enumerate(txns):
        net.input(i % args.nodes, Input.user(txn))

    want = set(txns)
    t_wall = time.perf_counter()
    net.run(lambda n: all(want <= set(node.committed)
                          for node in n.nodes.values()))
    return txns, time.perf_counter() - t_wall


def report(net: TimedNetwork, args, wall: float) -> None:
    """Print the per-epoch table and the traffic summary."""
    nodes = list(net.nodes.values())
    epochs = sorted(set().union(*[set(n.epoch_done_at) for n in nodes]))
    print(f"\n{'epoch':>5} {'done@(sim s)':>12} {'txns':>6} {'cum txns':>9} "
          f"{'tx/s (sim)':>11}")
    cum = 0
    for e in epochs:
        done_at = max(n.epoch_done_at.get(e, 0.0) for n in nodes)
        batch_txns = 0
        for n in nodes:
            for b in n.outputs:
                if (b.era, b.epoch) == e:
                    batch_txns = sum(len(c) for _, c in b.contributions
                                     if isinstance(c, (list, tuple)))
                    break
            if batch_txns:
                break
        cum += batch_txns
        rate = cum / done_at if done_at > 0 else 0.0
        tag = f"{e[0]}.{e[1]}"
        print(f"{tag:>5} {done_at:>12.3f} {batch_txns:>6} {cum:>9} {rate:>11.1f}")

    sim_end = max(max(n.epoch_done_at.values(), default=0.0) for n in nodes)
    msgs = sum(n.sent_msgs for n in nodes)
    mbytes = sum(n.sent_bytes for n in nodes) / 1e6
    cpu = sum(n.cpu_used for n in nodes)
    print(f"\nN={args.nodes} f={(args.nodes - 1) // 3} suite={args.suite} "
          f"backend={args.backend} flush_every={args.flush_every}")
    print(f"committed {args.txns} txns in {sim_end:.3f} sim-s "
          f"({args.txns / sim_end if sim_end else 0:.1f} tx/s); "
          f"{msgs} msgs, {mbytes:.2f} MB on the wire; "
          f"crypto+protocol CPU {cpu:.2f}s; wall {wall:.2f}s")
    print("\n" + net.metrics.report())


def main(argv=None) -> None:
    args = parse_args(argv)
    net = build_network(args)
    _, wall = run(net, args)
    report(net, args, wall)


if __name__ == "__main__":
    main()
