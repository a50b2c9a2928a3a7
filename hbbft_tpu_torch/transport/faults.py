"""Byte-level fault injection at the transport send path.

:mod:`hbbft_tpu_torch.net.adversary` owns *scheduling* adversaries inside the
in-process simulator; this module mirrors those semantics one layer
down, on the encoded frames a real node writes to real sockets:

* **drop** — the frame never leaves the sender;
* **duplicate** — the frame is queued twice;
* **delay / reorder** — the frame is held for a bounded time before
  queueing, so later frames overtake it (per-link frame order is the
  only order TCP gives us; delaying is how reordering manifests at this
  layer);
* **corrupt** — bit-flips in the encoded bytes.  Downstream, the frame
  decoder / serde boundary must reject these by dropping the connection
  — never by crashing (tests/test_transport.py);
* **partition / heal** — a schedule of time windows during which links
  between node groups drop every frame; outside the windows the links
  are clean.

Determinism: decisions are drawn from a per-*link* ``random.Random``
seeded by ``(seed, src, dst)``, so the k-th frame on a given link gets
the same verdict on every run regardless of thread interleaving across
links.  Partition windows are wall-clock offsets from ``start()`` —
coarse enough (seconds) that scheduling jitter does not move a frame
across a window edge in practice; tests drive the windows explicitly.

One injector instance is shared by all nodes of an in-process cluster
(:class:`~hbbft_tpu_torch.transport.cluster.LocalCluster` passes it to every
transport); its per-link state needs no lock beyond the GIL because
each ``(src, dst)`` link is only ever touched by src's transport
thread.

Copy of ``hbbft_tpu/transport/faults.py``: the same seeded decision
stream, frame for frame, for the same seed and link.
"""

from __future__ import annotations

import math
import random
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

from hbbft_tpu_torch.utils.metrics import Metrics


@dataclass(frozen=True)
class PartitionSpec:
    """Nodes split into ``groups`` from ``start_s`` until ``heal_s``
    (offsets in seconds from injector start; ``heal_s=None`` = never
    heals).  Frames between different groups are dropped; frames inside
    one group pass.  A node in no group is unrestricted."""

    groups: Tuple[FrozenSet, ...]
    start_s: float = 0.0
    heal_s: Optional[float] = None

    def blocks(self, src, dst, t: float) -> bool:
        if t < self.start_s or (self.heal_s is not None and t >= self.heal_s):
            return False
        sg = dg = None
        for i, g in enumerate(self.groups):
            if src in g:
                sg = i
            if dst in g:
                dg = i
        return sg is not None and dg is not None and sg != dg


@dataclass
class LinkFaults:
    """Per-link fault probabilities (applied frame-by-frame, in order).

    Two delay models coexist:

    * ``delay_p``/``delay_s`` — the *reorder fault*: occasional
      frames are held while later ones overtake them (per-frame delay
      with no ordering constraint — how reordering manifests on this
      layer).
    * ``latency_s``/``jitter_s``/``jitter_dist`` — the *WAN
      stream shape*: EVERY frame pays a base one-way latency plus a
      seeded jitter draw, and release times are clamped monotone per
      link, because a talking pair shares one TCP stream — a real WAN
      delays the stream, it does not reorder inside it.  Jitter
      distributions (all driven by one uniform draw via inverse CDF, so
      the per-link verdict stream stays a pure function of the frame
      index): ``"uniform"`` (U(0,1)·jitter_s), ``"exp"`` (mean
      jitter_s — heavy-ish tail, the default), ``"lognormal"``
      (median jitter_s, shape 0.6 — the long-tail shape WAN RTT
      studies report).

    Both models compose (WAN shape + occasional reorder fault); loss on
    a WAN link is the existing ``drop_p``.
    """

    drop_p: float = 0.0
    dup_p: float = 0.0
    delay_p: float = 0.0
    delay_s: Tuple[float, float] = (0.01, 0.05)  # uniform range when delayed
    corrupt_p: float = 0.0
    max_flips: int = 3  # bit flips per corrupted frame (>= 1)
    # WAN stream shape (applies to every frame when nonzero)
    latency_s: float = 0.0
    jitter_s: float = 0.0
    jitter_dist: str = "exp"  # "exp" | "uniform" | "lognormal"

    def wan_delay(self, u: float) -> float:
        """Map one uniform draw to this link's per-frame WAN delay."""
        if self.latency_s <= 0.0 and self.jitter_s <= 0.0:
            return 0.0
        j = 0.0
        if self.jitter_s > 0.0:
            if self.jitter_dist == "uniform":
                j = self.jitter_s * u
            elif self.jitter_dist == "lognormal":
                z = statistics.NormalDist().inv_cdf(
                    min(max(u, 1e-12), 1.0 - 1e-12)
                )
                j = self.jitter_s * math.exp(0.6 * z)
            else:  # "exp" (default): inverse CDF of Exp(1/jitter_s)
                j = -self.jitter_s * math.log(max(1.0 - u, 1e-300))
        return self.latency_s + j


def wan_profile(name: str, scale: float = 1.0) -> Optional[LinkFaults]:
    """Named WAN link shapes for benchmarks/tests (``config7_traffic``).

    ``"clean"`` → None (no injector needed); ``"wan"`` → ~30 ms base
    one-way latency + exponential jitter (mean 10 ms), lossless —
    the continental-WAN shape of the original HoneyBadgerBFT
    evaluation, scaled down so localhost epochs still close inside
    test budgets; ``"wan-lossy"`` → the same shape plus 0.5% frame
    loss and 0.2% duplication.  ``scale`` multiplies the time
    constants (1.0 = the named shape).  Loss is real loss — dropped
    frames are never retransmitted unless the connection itself
    cycles (the reference's docs/TRANSPORT.md "loss model") — so lossy profiles on
    EVERY link erode liveness; the config7 "faulty" arm instead puts
    loss on one node's links, inside the f-tolerance envelope.
    """
    if name == "clean":
        return None
    if name == "wan":
        return LinkFaults(
            latency_s=0.030 * scale, jitter_s=0.010 * scale, jitter_dist="exp"
        )
    if name == "wan-lossy":
        return LinkFaults(
            latency_s=0.030 * scale,
            jitter_s=0.010 * scale,
            jitter_dist="exp",
            drop_p=0.005,
            dup_p=0.002,
        )
    raise ValueError(f"unknown WAN profile {name!r} (clean|wan|wan-lossy)")


@dataclass
class FaultStats:
    """Cross-link totals.  Unlike the per-link rngs (single-writer by
    construction), these are incremented from every node's transport
    thread — the lock keeps the read-modify-writes from losing counts."""

    dropped: int = 0
    duplicated: int = 0
    delayed: int = 0
    corrupted: int = 0
    partitioned: int = 0
    shaped: int = 0  # frames that paid a WAN latency/jitter delay
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    NAMES = ("dropped", "duplicated", "delayed", "corrupted", "partitioned",
             "shaped")

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def export_metrics(self, m: Metrics, prefix: str = "faults") -> None:
        """Publish the totals as gauges (``faults.dropped`` etc.) so
        injected faults land in the same Prometheus dump as the
        transport/cluster counters.  Gauges, not
        counters: these are cross-link running totals owned here, and
        re-exporting monotone totals through ``Metrics.count`` would
        double-add on every export."""
        with self._lock:
            vals = [(name, getattr(self, name)) for name in self.NAMES]
        for name, v in vals:
            m.gauge(f"{prefix}.{name}", v)


class FaultInjector:
    """Deterministic-by-seed frame mangler for the TCP transport.

    ``on_send(src, dst, data) -> [(extra_delay_s, bytes), ...]`` is the
    whole interface the transport uses: an empty list means the frame
    was dropped; multiple entries mean duplication; a nonzero delay
    means the transport holds that copy on its timer heap before
    queueing it.  Without an injector the transport sends
    ``[(0.0, data)]`` — the injector is pure policy, never plumbing.
    """

    def __init__(
        self,
        seed: int = 0,
        default: Optional[LinkFaults] = None,
        links: Optional[Dict[Tuple, LinkFaults]] = None,
        partitions: Optional[List[PartitionSpec]] = None,
    ) -> None:
        self.seed = seed
        self.default = default or LinkFaults()
        self.links = dict(links or {})
        self.partitions = list(partitions or [])
        self.stats = FaultStats()
        self._rngs: Dict[Tuple, random.Random] = {}
        # WAN FIFO state: last scheduled release time per link (only
        # touched by src's transport thread, like _rngs)
        self._wan_last: Dict[Tuple, float] = {}
        self._t0: Optional[float] = None

    # -- lifecycle -----------------------------------------------------
    def start(self, now: Optional[float] = None) -> None:
        """Anchor partition-window offsets; called by the cluster when
        the transports come up (idempotent: first call wins, so every
        node shares one clock origin)."""
        if self._t0 is None:
            self._t0 = time.monotonic() if now is None else now

    def elapsed(self) -> float:
        if self._t0 is None:
            return 0.0
        return time.monotonic() - self._t0

    def export_metrics(self, m: Metrics, prefix: str = "faults") -> None:
        """Mirror :meth:`FaultStats.export_metrics` at the injector
        level (what :meth:`LocalCluster.merged_metrics` calls)."""
        self.stats.export_metrics(m, prefix)

    # -- dynamic schedule edits (tests drive heal explicitly) ----------
    def add_partition(self, spec: PartitionSpec) -> None:
        self.partitions.append(spec)

    def heal_all(self) -> None:
        """End every ACTIVE partition now (explicit heal, no clock).
        Windows scheduled to start in the future are left untouched."""
        t = self.elapsed()
        self.partitions = [
            p
            if p.start_s > t
            else PartitionSpec(
                p.groups,
                p.start_s,
                min(p.heal_s, t) if p.heal_s is not None else t,
            )
            for p in self.partitions
        ]

    # -- the send hook -------------------------------------------------
    def _rng(self, src, dst) -> random.Random:
        key = (src, dst)
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = random.Random(f"{self.seed}|{src}|{dst}")
        return rng

    def on_send(self, src, dst, data: bytes) -> List[Tuple[float, bytes]]:
        t = self.elapsed()
        for p in self.partitions:
            if p.blocks(src, dst, t):
                self.stats.bump('partitioned')
                return []
        lf = self.links.get((src, dst), self.default)
        rng = self._rng(src, dst)
        # Draw every decision unconditionally so the per-link sequence
        # of verdicts is a pure function of (seed, src, dst, frame
        # index) — independent of which faults are enabled elsewhere.
        r_drop = rng.random()
        r_dup = rng.random()
        r_delay = rng.random()
        u_delay = rng.random()
        r_corrupt = rng.random()
        u_jitter = rng.random()  # WAN jitter draw
        if lf.drop_p and r_drop < lf.drop_p:
            self.stats.bump('dropped')
            return []
        if lf.corrupt_p and r_corrupt < lf.corrupt_p:
            # flip positions come from a rng DERIVED from this frame's
            # unconditional corrupt draw, not from the verdict stream —
            # otherwise enabling corruption would shift every later
            # frame's drop/dup/delay verdicts on the link
            data = self._corrupt(data, random.Random(r_corrupt), lf.max_flips)
            self.stats.bump('corrupted')
        delay = 0.0
        if lf.delay_p and r_delay < lf.delay_p:
            lo, hi = lf.delay_s
            delay = lo + (hi - lo) * u_delay
            self.stats.bump('delayed')
        wan = lf.wan_delay(u_jitter)
        if wan > 0.0:
            # WAN stream shape: base+jitter on every frame, release
            # times clamped monotone per link — a talking pair shares
            # one TCP stream, so the WAN delays the stream without
            # reordering inside it.  The reorder fault (delay_p above)
            # is added AFTER the clamp: a delay-faulted frame is held
            # past its WAN slot and CAN still be overtaken by later
            # frames, so composing the shape with delay_p keeps real
            # reorder coverage (feeding the reorder delay into the
            # clamp would silently FIFO it away).
            release = t + wan
            last = self._wan_last.get((src, dst), 0.0)
            if release < last:
                release = last
            self._wan_last[(src, dst)] = release
            delay += release - t
            self.stats.bump('shaped')
        out = [(delay, data)]
        if lf.dup_p and r_dup < lf.dup_p:
            self.stats.bump('duplicated')
            out.append((delay, data))
        return out

    @staticmethod
    def _corrupt(data: bytes, rng: random.Random, max_flips: int) -> bytes:
        buf = bytearray(data)
        # max(1, ...) twice: a corrupted frame always flips >= 1 bit,
        # and a user-supplied max_flips of 0 must not raise from inside
        # the sender's protocol thread
        for _ in range(rng.randrange(max(1, max_flips)) + 1):
            i = rng.randrange(len(buf))
            buf[i] ^= 1 << rng.randrange(8)
        return bytes(buf)
