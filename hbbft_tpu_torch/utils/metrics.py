"""Structured metrics: counters, timers, and JAX profiler traces.

Reference behavior: the reference has no metrics beyond ``log`` lines and
the per-message CPU-time accounting of its simulation example (SURVEY.md
§5.1/§5.5).  This framework's observability surface is richer because the
crypto plane batches onto an accelerator — per-flush timing and batch
sizes are the operational signal — while staying optional: a ``Metrics``
instance is plain data, and nothing in the protocol plane requires one.

Usage::

    from hbbft_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    with m.timer("flush"):
        pool.flush(backend)
    m.count("verify_requests", 12)
    print(m.report())

``Metrics.trace(path)`` wraps ``torch.profiler`` so a verify flush can be
captured for TensorBoard without importing torch at module scope.

Copy of ``hbbft_tpu/utils/metrics.py``; ``trace`` differs (the
reference captures with ``jax.profiler``), and ``observe`` is the port's.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple


@dataclass
class TimerStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


@dataclass
class SummaryStats:
    """A quantile snapshot of some distribution (latency percentiles).

    Unlike :class:`TimerStats` (which accumulates raw observations),
    this is a point-in-time EXPORT: the producer owns the streaming
    estimator (e.g. :class:`hbbft_tpu_torch.traffic.latency.LatencyHistogram`)
    and re-publishes count/sum/quantiles whenever it likes — last write
    wins, like gauges.  Keeping the estimator out of Metrics keeps
    Metrics plain data and lets producers pick their own accuracy/
    memory trade-off.
    """

    count: int = 0
    total: float = 0.0
    quantiles: Dict[float, float] = field(default_factory=dict)


@dataclass
class Metrics:
    """Counters + gauges + timers; cheap enough to leave on.

    Mutations are lock-protected: one instance is routinely shared
    between a transport's selector thread and its node's protocol
    thread (hbbft_tpu/transport/), and ``+=`` on a dict entry is not
    atomic across bytecodes — concurrent same-key counts would lose
    increments without the lock.
    """

    counters: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    timers: Dict[str, TimerStats] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    summaries: Dict[str, SummaryStats] = field(default_factory=dict)
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time observable (queue depth, bytes buffered);
        last write wins, unlike the monotonic counters."""
        with self._lock:
            self.gauges[name] = value

    def summary(
        self,
        name: str,
        quantiles: Dict[float, float],
        count: int,
        total: float,
    ) -> None:
        """Publish a quantile snapshot (gauge semantics: last write
        wins).  ``quantiles`` maps q in [0, 1] to the estimated value at
        that quantile; ``count``/``total`` are the observation count and
        sum backing the estimate (the Prometheus summary ``_count`` /
        ``_sum`` pair)."""
        with self._lock:
            self.summaries[name] = SummaryStats(
                count=count, total=total, quantiles=dict(quantiles)
            )

    @contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def observe(self, name: str, seconds: float) -> None:
        """Add one duration measured elsewhere to the timer ``name``."""
        with self._lock:
            self.timers.setdefault(name, TimerStats()).add(seconds)

    @contextmanager
    def trace(self, logdir: str) -> Iterator[None]:
        """``torch.profiler`` capture into ``logdir`` (TensorBoard format):
        host activity, and the card's when one is present."""
        from torch.profiler import (
            ProfilerActivity,
            profile,
            tensorboard_trace_handler,
        )
        import torch

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(
            activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)
        ):
            yield

    def merge(self, other: "Metrics") -> None:
        # list() snapshots: ``other`` may belong to a live transport or
        # protocol thread that inserts new keys mid-merge (GIL makes the
        # item reads safe; iterating the live dict would not be)
        with self._lock:
            for k, v in list(other.counters.items()):
                self.counters[k] += v
            for k, st in list(other.timers.items()):
                mine = self.timers.setdefault(k, TimerStats())
                mine.count += st.count
                mine.total_s += st.total_s
                mine.max_s = max(mine.max_s, st.max_s)
            # gauges are point-in-time: the merged-in value wins (merge
            # order is "newer last" everywhere this is used)
            self.gauges.update(list(other.gauges.items()))
            # summaries share gauge semantics (snapshots, newest wins)
            self.summaries.update(list(other.summaries.items()))

    def _snapshot(
        self,
    ) -> Tuple[
        Dict[str, int],
        Dict[str, float],
        Dict[str, TimerStats],
        Dict[str, SummaryStats],
    ]:
        """Consistent copies for the export methods — they may run on a
        scrape thread while the owning threads keep inserting keys."""
        with self._lock:
            return (
                dict(self.counters),
                dict(self.gauges),
                dict(self.timers),
                dict(self.summaries),
            )

    def report(self) -> str:
        counters, gauges, timers, summaries = self._snapshot()
        lines = []
        if counters:
            lines.append("counters:")
            for k in sorted(counters):
                lines.append(f"  {k:<40} {counters[k]}")
        if gauges:
            lines.append("gauges:")
            for k in sorted(gauges):
                lines.append(f"  {k:<40} {gauges[k]:.12g}")
        if timers:
            lines.append("timers:  (count / mean ms / max ms / total s)")
            for k in sorted(timers):
                st = timers[k]
                lines.append(
                    f"  {k:<40} {st.count:>6} {st.mean_s * 1e3:>9.2f} "
                    f"{st.max_s * 1e3:>9.2f} {st.total_s:>8.2f}"
                )
        if summaries:
            lines.append("summaries:  (count / quantiles)")
            for k in sorted(summaries):
                sm = summaries[k]
                qs = " ".join(
                    f"p{q * 100:g}={v:.6g}" for q, v in sorted(sm.quantiles.items())
                )
                lines.append(f"  {k:<40} {sm.count:>6} {qs}")
        return "\n".join(lines) or "(no metrics)"

    # -- exports --------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        """Plain-data snapshot (counters, gauges, timer stats) for JSON
        benchmark lines (benchmarks/scale_native.py,
        benchmarks/config6_tcp_cluster.py dump this)."""
        counters, gauges, timers, summaries = self._snapshot()
        out: Dict[str, Any] = {
            "counters": counters,
            "gauges": gauges,
            "timers": {
                k: {
                    "count": st.count,
                    "total_s": st.total_s,
                    "mean_s": st.mean_s,
                    "max_s": st.max_s,
                }
                for k, st in timers.items()
            },
        }
        if summaries:
            out["summaries"] = {
                k: {
                    "count": sm.count,
                    "total": sm.total,
                    # JSON object keys must be strings; %g keeps 0.5
                    # and 0.99 readable and round-trippable
                    "quantiles": {
                        f"{q:g}": v for q, v in sorted(sm.quantiles.items())
                    },
                }
                for k, sm in summaries.items()
            }
        return out

    def prometheus_text(self, prefix: str = "hbbft") -> str:
        """Prometheus exposition format (text/plain version 0.0.4).

        Dotted/arrow metric names ride in a ``name`` label (labels admit
        any UTF-8) under a few fixed metric families, so per-peer series
        (``transport.0->1.queue_frames``) stay distinguishable without
        name mangling.  Label values are escaped per the exposition
        format (backslash, quote, newline) — metric names can embed
        peer-announced node ids, which are untrusted.  Every family
        carries its ``# HELP``/``# TYPE`` header pair, and each timer
        additionally exports its max single observation as the
        ``_max`` gauge family (tracked by :class:`TimerStats` — a
        summary has no max series of its own).  The line grammar is
        golden-pinned by tests/test_obs.py.
        """

        def esc(name: str) -> str:
            return (
                name.replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n")
            )

        counters, gauges, timers, summaries = self._snapshot()
        lines: List[str] = []
        if counters:
            lines.append(
                f"# HELP {prefix}_count Monotonic event counters"
                " (dotted source name in the 'name' label)."
            )
            lines.append(f"# TYPE {prefix}_count counter")
            for k in sorted(counters):
                lines.append(f'{prefix}_count{{name="{esc(k)}"}} {counters[k]}')
        if gauges:
            lines.append(
                f"# HELP {prefix}_gauge Point-in-time observables"
                " (last write wins)."
            )
            lines.append(f"# TYPE {prefix}_gauge gauge")
            for k in sorted(gauges):
                # .12g, not :g — byte totals exported as gauges exceed
                # :g's 6 significant digits and would scrape corrupted
                lines.append(
                    f'{prefix}_gauge{{name="{esc(k)}"}} {gauges[k]:.12g}'
                )
        if timers:
            lines.append(
                f"# HELP {prefix}_timer_seconds Wall-clock timer"
                " observations (count/sum per name)."
            )
            lines.append(f"# TYPE {prefix}_timer_seconds summary")
            for k in sorted(timers):
                st = timers[k]
                lines.append(
                    f'{prefix}_timer_seconds_count{{name="{esc(k)}"}} {st.count}'
                )
                lines.append(
                    f'{prefix}_timer_seconds_sum{{name="{esc(k)}"}} '
                    f"{st.total_s:.12g}"
                )
            lines.append(
                f"# HELP {prefix}_timer_seconds_max Largest single"
                " observation per timer."
            )
            lines.append(f"# TYPE {prefix}_timer_seconds_max gauge")
            for k in sorted(timers):
                lines.append(
                    f'{prefix}_timer_seconds_max{{name="{esc(k)}"}} '
                    f"{timers[k].max_s:.12g}"
                )
        if summaries:
            lines.append(
                f"# HELP {prefix}_summary Quantile snapshots published"
                " by streaming estimators (latency percentiles)."
            )
            lines.append(f"# TYPE {prefix}_summary summary")
            for k in sorted(summaries):
                sm = summaries[k]
                for q, v in sorted(sm.quantiles.items()):
                    lines.append(
                        f'{prefix}_summary{{name="{esc(k)}",quantile="{q:g}"}} '
                        f"{v:.12g}"
                    )
                lines.append(
                    f'{prefix}_summary_sum{{name="{esc(k)}"}} {sm.total:.12g}'
                )
                lines.append(
                    f'{prefix}_summary_count{{name="{esc(k)}"}} {sm.count}'
                )
        return "\n".join(lines) + ("\n" if lines else "")


@dataclass
class EpochStats:
    """Per-epoch protocol observables (what the simulation table prints)."""

    epoch: Tuple[int, int]
    started_at: float
    finished_at: Optional[float] = None
    contributions: int = 0
    txns: int = 0

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.started_at


class EpochTracker:
    """Collects EpochStats keyed by (era, epoch).

    Lock-protected (round 12): a cluster node's protocol thread records
    commits while a scrape/driver thread reads latencies for the
    ``epoch.latency`` summary export."""

    def __init__(self) -> None:
        self._stats: Dict[Tuple[int, int], EpochStats] = {}
        self._lock = threading.Lock()

    def start(self, epoch: Tuple[int, int], now: float) -> None:
        with self._lock:
            self._stats.setdefault(
                epoch, EpochStats(epoch=epoch, started_at=now)
            )

    def finish(
        self, epoch: Tuple[int, int], now: float, contributions: int, txns: int
    ) -> None:
        with self._lock:
            st = self._stats.setdefault(
                epoch, EpochStats(epoch=epoch, started_at=now)
            )
            if st.finished_at is None:
                st.finished_at = now
                st.contributions = contributions
                st.txns = txns

    def all(self) -> List[EpochStats]:
        with self._lock:
            return [self._stats[k] for k in sorted(self._stats)]

    def latencies(self) -> List[float]:
        """Commit latencies of every finished epoch (export feed for
        the ``epoch.latency`` summary)."""
        with self._lock:
            return [
                st.finished_at - st.started_at
                for st in self._stats.values()
                if st.finished_at is not None
            ]
