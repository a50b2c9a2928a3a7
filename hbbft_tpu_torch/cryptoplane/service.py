"""Cluster crypto plane: a shared batched share-verification service.

Copy of ``hbbft_tpu/cryptoplane/service.py``.  Cluster nodes verify
COIN/DECRYPT/sig shares either inline (a per-node
:class:`~hbbft_tpu_torch.crypto.backend.CryptoBackend`) or — with
``LocalCluster(crypto="service")`` — through ONE shared
:class:`CryptoPlaneService` that merges the share-check requests of ALL
nodes into single ``CryptoBackend.verify_batch`` flushes.  This is the
"threshold cryptography as a distributed service" architecture of
Thetacrypt (PAPERS.md, arxiv 2502.03247): with
:class:`~hbbft_tpu_torch.crypto.device.backend.TorchBackend` attached,
every merged flush runs the card's scan and pair kernels; with
``BatchedBackend`` the RLC pairing collapse still amortizes across
nodes on the host.

Correctness stance — the standing deferred-verification invariant:
verification verdicts are PURE functions of request content, so
merging requests across nodes, reordering flushes, or falling back to
a local backend can never change a verdict, only its timing.  The
service arm therefore commits byte-identical batches to the inline
arm, and per-sender fault attribution is preserved exactly
(``BatchedBackend`` bisects aggregate failures down to the offending
request — the RLC bisection contract).  Pinned by
tests/test_torch_cryptoplane.py and tests/test_torch_cluster.py.

Failure stance: the service is an OPTIMIZATION plane, never a
liveness dependency.  Every :class:`ServiceClient` carries a local
fallback backend; a flush that times out, a killed service, or a
worker crash routes the same requests through the fallback (counted:
``crypto.fallbacks``) and the cluster keeps committing on the host
path.  The count is what makes a fallback visible: a run that means
to measure the card treats any ``crypto.fallbacks`` as a failure.  A
flush of a device backend (``CryptoBackend.on_device``) that raises is
not a slow service but a fault of the device path: its callers get the
exception (:class:`DeviceFlushError`), never a host re-verification.

Threading: ``submit`` may be called from any number of node protocol
threads; the single worker thread owns the backend (a CUDA backend is
built on the caller's thread and launches its kernels from this one).
Callers block on their job's event — a node cannot progress past a
share check anyway, and the window is the measured "latency price of
threshold cryptography" (arxiv 2407.12172).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from hbbft_tpu_torch.crypto.backend import CryptoBackend, VerifyRequest
from hbbft_tpu_torch.traffic.latency import LatencyHistogram
from hbbft_tpu_torch.utils.metrics import Metrics


class DeviceFlushError(RuntimeError):
    """The service's device flush raised; the cause is chained."""


class _Job:
    """One client's submitted batch: requests in, verdicts out."""

    __slots__ = ("reqs", "results", "error", "done", "cancelled",
                 "flush_requests", "flush_jobs", "t_submit")

    def __init__(self, reqs: List[VerifyRequest]) -> None:
        self.reqs = reqs
        # Submit time: the worker's ``crypto.wait`` timer measures from
        # here to the flush that takes the job (window plus queue).
        self.t_submit = time.perf_counter()
        self.results: Optional[List[bool]] = None  # None = failed/killed
        # A device backend's exception: the client raises it on.
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        # Stamped by _flush: the size of the MERGED batch this job rode
        # in (requests / jobs across all clients) — the cross-node
        # amortization observable the RPC server reports back to its
        # clients (proc_service.py).
        self.flush_requests = 0
        self.flush_jobs = 0
        # Set by a client that timed out and re-verified locally: the
        # worker drops still-queued cancelled jobs instead of paying a
        # backend flush nobody is waiting for (best-effort — a job the
        # worker already collected still flushes).
        self.cancelled = False


class CryptoPlaneService:
    """The shared verification service: one worker, one backend.

    * ``window_s`` — how long the worker holds the first pending job
      open for more arrivals before flushing (the cross-node batching
      window; 0 flushes immediately).
    * ``max_batch`` — pending-request count that triggers an immediate
      flush regardless of the window.
    * ``trace`` — optional :class:`~hbbft_tpu_torch.obs.trace.TraceBuffer`;
      every flush emits ``crypto.flush.open`` / ``crypto.flush.done``
      milestone events (requests/jobs/backend args) onto it, so the
      flight recorder's merged timeline shows device flushes next to
      the per-node epoch phases.
    * ``on_device_error`` — called with the exception when a device
      backend's flush raises (the service process stops on it).

    Metrics (exported via :meth:`export_metrics` into
    ``LocalCluster.merged_metrics``): ``crypto.flushes`` /
    ``crypto.requests`` counters, ``crypto.flush`` timer (the backend's
    latency), ``crypto.wait`` timer (one entry a job: from its submit to
    the flush that takes it — the window plus the queue behind earlier
    flushes; not in the reference),
    ``crypto.batch_size`` summary (log-bucket histogram),
    ``crypto.queue_depth`` gauge, ``crypto.fallbacks`` (client-side,
    counted here so the cluster sees one total), ``crypto.flush_errors``.
    """

    def __init__(
        self,
        backend: CryptoBackend,
        *,
        window_s: float = 0.002,
        max_batch: int = 512,
        metrics: Optional[Metrics] = None,
        trace: Any = None,
        on_device_error: Optional[Callable[[BaseException], None]] = None,
    ) -> None:
        self.backend = backend
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self.metrics = metrics if metrics is not None else Metrics()
        self.trace = trace
        self.on_device_error = on_device_error
        # The first exception a device flush raised (None: none did).
        self.device_error: Optional[BaseException] = None
        self._cv = threading.Condition()
        self._jobs: List[_Job] = []
        self._pending_reqs = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._killed = False
        # batch-size distribution (requests per backend flush): the
        # log-bucket estimator bounds memory like the traffic plane's
        # latency clocks; re-published as the crypto.batch_size summary.
        self._batch_hist = LatencyHistogram(lo=1.0, hi=65536.0, growth=1.25)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "CryptoPlaneService":
        """Start the worker.  stop()/kill() are TERMINAL: a stopped
        service never restarts (clients fall back locally forever) —
        restartability would make LocalCluster.stop() racy against
        late in-flight submits."""
        with self._cv:
            if self._thread is None and not self._killed and not self._stop:
                self._start_locked()
        return self

    def _start_locked(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="cryptoplane", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Graceful shutdown: drains nothing — outstanding jobs fail
        over to their clients' fallbacks (same path as kill)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
        self._fail_pending()
        self._thread = None

    def kill(self) -> None:
        """Simulated crash (the fallback drill): the service goes dead
        NOW and stays dead — outstanding and future submissions fail
        immediately, clients fall back to their local backend."""
        with self._cv:
            self._killed = True
            self._stop = True
            self._cv.notify_all()
        self._fail_pending()

    @property
    def alive(self) -> bool:
        return not self._killed and not self._stop

    def _fail_pending(self) -> None:
        with self._cv:
            jobs, self._jobs = self._jobs, []
            self._pending_reqs = 0
            # scrapes of the surviving cluster must not show a stale
            # nonzero queue on a dead service
            self.metrics.gauge("crypto.queue_depth", 0)
        for j in jobs:
            j.done.set()  # results stay None -> client falls back

    # -- submission (any thread) ---------------------------------------
    def submit(self, reqs: Sequence[VerifyRequest]) -> Optional[_Job]:
        """Enqueue one batch; returns the job to wait on, or None when
        the service is dead (caller falls back immediately).  Lazily
        starts the worker so a cluster built before ``start()`` still
        gets service semantics."""
        job = _Job(list(reqs))
        with self._cv:
            if self._killed or self._stop:
                return None
            if self._thread is None:
                # Lazy start UNDER the lock: a submit racing stop()
                # must never resurrect a worker after shutdown.
                self._start_locked()
            self._jobs.append(job)
            self._pending_reqs += len(job.reqs)
            self.metrics.gauge("crypto.queue_depth", self._pending_reqs)
            self._cv.notify_all()
        return job

    # -- worker ---------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._jobs and not self._stop:
                    self._cv.wait(timeout=0.2)
                if self._stop:
                    return
                # Hold the window open from the FIRST pending arrival:
                # more nodes' flushes pile into the same device batch.
                deadline = time.monotonic() + self.window_s
                while (
                    not self._stop
                    and self._pending_reqs < self.max_batch
                    and (remain := deadline - time.monotonic()) > 0
                ):
                    self._cv.wait(timeout=remain)
                if self._stop:
                    return
                # Timed-out clients already re-verified locally; drop
                # their abandoned jobs rather than flushing for nobody.
                jobs = [j for j in self._jobs if not j.cancelled]
                self._jobs = []
                self._pending_reqs = 0
                self.metrics.gauge("crypto.queue_depth", 0)
            if jobs:
                self._flush(jobs)

    def _flush(self, jobs: List[_Job]) -> None:
        t_take = time.perf_counter()
        for j in jobs:
            self.metrics.observe("crypto.wait", t_take - j.t_submit)
        reqs = [r for j in jobs for r in j.reqs]
        backend = type(self.backend).__name__
        if self.trace is not None:
            self.trace.emit(
                "crypto.flush.open",
                requests=len(reqs), jobs=len(jobs), backend=backend,
            )
        ok = False
        try:
            with self.metrics.timer("crypto.flush"):
                results = self.backend.verify_batch(reqs)
            if len(results) != len(reqs):  # a broken backend is a crash
                raise RuntimeError(
                    f"backend returned {len(results)} verdicts "
                    f"for {len(reqs)} requests"
                )
            pos = 0
            for j in jobs:
                j.results = [bool(v) for v in results[pos:pos + len(j.reqs)]]
                pos += len(j.reqs)
            ok = True
            self.metrics.count("crypto.flushes")
            self.metrics.count("crypto.requests", len(reqs))
            self._batch_hist.observe(float(len(reqs)))
            self._publish_batch_summary()
        except Exception as exc:
            # One bad flush must not take the plane down: the worker
            # lives.  A host backend's jobs fail over to their clients'
            # fallbacks; a device backend's carry the exception to them.
            self.metrics.count("crypto.flush_errors")
            if getattr(self.backend, "on_device", False):
                for j in jobs:
                    j.error = exc
                if self.device_error is None:
                    self.device_error = exc
                if self.on_device_error is not None:
                    self.on_device_error(exc)
        finally:
            if self.trace is not None:
                self.trace.emit(
                    "crypto.flush.done",
                    requests=len(reqs), jobs=len(jobs), backend=backend,
                    ok=ok,
                )
            for j in jobs:
                j.flush_requests = len(reqs)
                j.flush_jobs = len(jobs)
                j.done.set()

    def _publish_batch_summary(self) -> None:
        h = self._batch_hist
        self.metrics.summary(
            "crypto.batch_size",
            {q: h.quantile(q) for q in (0.5, 0.9, 0.99)},
            h.count,
            h.total,
        )

    # -- clients --------------------------------------------------------
    def client(
        self,
        fallback: CryptoBackend,
        *,
        timeout_s: float = 30.0,
    ) -> "ServiceClient":
        return ServiceClient(self, fallback, timeout_s=timeout_s)

    def export_metrics(self, into: Metrics) -> None:
        into.merge(self.metrics)


class ServiceClient(CryptoBackend):
    """Per-node facade: a drop-in :class:`CryptoBackend` whose
    ``verify_batch`` routes through the shared service and falls back
    to ``fallback`` (a local CPU backend) when the service is dead,
    killed mid-wait, or slower than ``timeout_s``.  Verdicts are pure,
    so the two paths are interchangeable per request.  A device flush
    that raised raises :class:`DeviceFlushError` here instead."""

    def __init__(
        self,
        service: CryptoPlaneService,
        fallback: CryptoBackend,
        *,
        timeout_s: float = 30.0,
    ) -> None:
        self.service = service
        self.fallback = fallback
        self.timeout_s = float(timeout_s)

    def verify_batch(self, reqs: Sequence[VerifyRequest]) -> List[bool]:
        reqs = list(reqs)
        if not reqs:
            return []
        job = self.service.submit(reqs)
        if job is not None:
            if job.done.wait(self.timeout_s):
                if job.error is not None:
                    raise DeviceFlushError(
                        "the crypto service's device flush failed"
                    ) from job.error
                results = job.results
                if results is not None:
                    return results
            else:
                job.cancelled = True  # worker drops it if still queued
        m = self.service.metrics
        m.count("crypto.fallbacks")
        m.count("crypto.fallback_requests", len(reqs))
        return self.fallback.verify_batch(reqs)
