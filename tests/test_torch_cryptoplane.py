"""The port's crypto-plane service (``hbbft_tpu_torch.cryptoplane.service``)
against ``tests/test_cryptoplane.py``'s acceptance surface.

* Unit behaviour of ``CryptoPlaneService`` and ``ServiceClient``: requests
  of concurrent clients merge into one backend flush, a malformed request
  verifies False, a killed or stopped service falls back (counted in
  ``crypto.fallbacks``), a backend that raises fails its jobs over and the
  worker lives on, a device backend that raises reaches its callers as
  ``DeviceFlushError`` with no fallback, the lazy start, an external service outliving its
  cluster, and a timed-out job dropped before it reaches the backend.
* The ``crypto.*`` metrics and the ``crypto.flush.open/done`` spans of a
  live N = 4 service-arm cluster.
* Fault attribution: a seeded ``TamperingAdversary`` on the simulated net
  gives EXACTLY the reference's batches and per-node fault logs, order
  included, when every share check of the port goes through the service.
* The fallback drill: the service dies mid-run and the cluster keeps
  committing on its nodes' local backends.

Everything runs over ``ScalarSuite`` and the host ``BatchedBackend``.
"""

from __future__ import annotations

import random
import threading

import pytest

from hbbft_tpu_torch.crypto.backend import (
    BatchedBackend,
    CryptoBackend,
    EagerBackend,
    VerifyRequest,
)
from hbbft_tpu_torch.crypto.keys import SecretKeySet
from hbbft_tpu_torch.crypto.suite import ScalarSuite
from hbbft_tpu_torch.cryptoplane import CryptoPlaneService, DeviceFlushError
from hbbft_tpu_torch.protocols.queueing_honey_badger import Input
from hbbft_tpu_torch.transport import LocalCluster
from hbbft_tpu_torch.utils import serde

EPOCH_TIMEOUT_S = 45  # wall cap per driven phase; typical is < 3 s


def _scalar_fixture():
    suite = ScalarSuite()
    rng = random.Random(5)
    sks = SecretKeySet.random(1, rng, suite)
    pks = sks.public_keys()
    good = VerifyRequest.sig_share(
        pks.public_key_share(0), b"doc", sks.secret_key_share(0).sign(b"doc")
    )
    # wrong signer key: well-formed, verifies False
    bad = VerifyRequest.sig_share(
        pks.public_key_share(1), b"doc", sks.secret_key_share(0).sign(b"doc")
    )
    return suite, good, bad


def _batch_keys(cluster, nid, upto=None):
    bs = cluster.batches(nid)[:upto]
    return [(b.era, b.epoch, serde.dumps(b.contributions)) for b in bs]


# ---------------------------------------------------------------------------
# service unit behaviour
# ---------------------------------------------------------------------------


def test_service_merges_cross_thread_batches():
    suite, good, bad = _scalar_fixture()

    class CountingBackend(CryptoBackend):
        def __init__(self):
            self.inner = BatchedBackend(suite)
            self.calls = []

        def verify_batch(self, reqs):
            self.calls.append(len(reqs))
            return self.inner.verify_batch(reqs)

    backend = CountingBackend()
    svc = CryptoPlaneService(backend, window_s=0.05).start()
    client = svc.client(EagerBackend(suite))
    out = {}
    barrier = threading.Barrier(3)

    def worker(i):
        barrier.wait()
        out[i] = client.verify_batch([good, bad, good])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(out[i] == [True, False, True] for i in range(3)), out
    assert max(backend.calls) == 9, backend.calls
    assert svc.metrics.counters["crypto.requests"] == 9
    sm = svc.metrics.summaries["crypto.batch_size"]
    assert sm.count == len(backend.calls)
    # one wait entry a job: window plus queue, never negative
    wait = svc.metrics.timers["crypto.wait"]
    assert wait.count == 3 and wait.total_s >= 0
    svc.stop()


def test_service_malformed_request_is_false_not_fatal():
    suite, good, _ = _scalar_fixture()
    svc = CryptoPlaneService(BatchedBackend(suite), window_s=0.0).start()
    client = svc.client(EagerBackend(suite))
    junk = VerifyRequest("sig_share", (object(), b"m", object()))
    assert client.verify_batch([good, junk]) == [True, False]
    assert svc.metrics.counters.get("crypto.flush_errors", 0) == 0
    svc.stop()


def test_killed_service_falls_back_immediately():
    suite, good, bad = _scalar_fixture()
    svc = CryptoPlaneService(BatchedBackend(suite), window_s=0.0).start()
    client = svc.client(EagerBackend(suite))
    assert client.verify_batch([good]) == [True]
    svc.kill()
    assert client.verify_batch([good, bad]) == [True, False]  # fallback path
    assert svc.metrics.counters["crypto.fallbacks"] == 1
    assert svc.metrics.counters["crypto.fallback_requests"] == 2


def test_broken_backend_fails_over_and_worker_survives():
    suite, good, bad = _scalar_fixture()

    class Flaky(CryptoBackend):
        def __init__(self):
            self.inner = BatchedBackend(suite)
            self.fail_next = True

        def verify_batch(self, reqs):
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("device wedged")
            return self.inner.verify_batch(reqs)

    svc = CryptoPlaneService(Flaky(), window_s=0.0).start()
    client = svc.client(EagerBackend(suite))
    assert client.verify_batch([good, bad]) == [True, False]
    assert svc.metrics.counters["crypto.flush_errors"] == 1
    assert svc.metrics.counters["crypto.fallbacks"] == 1
    assert client.verify_batch([good]) == [True]
    assert svc.metrics.counters["crypto.flushes"] == 1  # the recovered one
    assert svc.metrics.counters["crypto.fallbacks"] == 1  # no new fallback
    svc.stop()


def test_device_backend_flush_error_propagates():
    """A device backend's flush that raises reaches its client as
    ``DeviceFlushError``: no host re-verification and no fallback; the
    service's hook sees the error, and the worker serves the next flush."""
    suite, good, bad = _scalar_fixture()

    class FlakyDevice(CryptoBackend):
        on_device = True

        def __init__(self):
            self.inner = BatchedBackend(suite)
            self.fail_next = True

        def verify_batch(self, reqs):
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("kernel launch failed")
            return self.inner.verify_batch(reqs)

    seen = []
    svc = CryptoPlaneService(
        FlakyDevice(), window_s=0.0, on_device_error=seen.append
    ).start()
    client = svc.client(EagerBackend(suite))
    with pytest.raises(DeviceFlushError) as info:
        client.verify_batch([good, bad])
    cause = info.value.__cause__
    assert str(cause) == "kernel launch failed"
    assert seen == [cause] and svc.device_error is cause
    assert svc.metrics.counters["crypto.flush_errors"] == 1
    assert svc.metrics.counters.get("crypto.fallbacks", 0) == 0
    assert client.verify_batch([good, bad]) == [True, False]
    assert svc.metrics.counters["crypto.flushes"] == 1
    svc.stop()


class _RaisingBackend(CryptoBackend):
    """A backend whose every flush raises."""

    def verify_batch(self, reqs):
        raise RuntimeError("flush failed")


@pytest.mark.parametrize("mode", ["host-only", "device"])
def test_hybrid_backend_behind_the_service(mode):
    """``HybridBackend`` behind the service: host-only
    (``device=NO_DEVICE``) with a raising host fails the flush over to the
    client's fallback, as the reference's service does for a host backend;
    with a device backend that raises, the error reaches the client as
    ``DeviceFlushError`` with no fallback."""
    from hbbft_tpu_torch.crypto.device.backend import HybridBackend

    suite, good, bad = _scalar_fixture()
    if mode == "host-only":
        be = HybridBackend(suite, device=HybridBackend.NO_DEVICE, host=_RaisingBackend())
    else:
        raising = _RaisingBackend()
        raising.on_device = True
        be = HybridBackend(suite, min_device_batch=1, device=raising,
                           host=BatchedBackend(suite))
    assert be.on_device is (mode == "device")
    svc = CryptoPlaneService(be, window_s=0.0).start()
    client = svc.client(EagerBackend(suite))
    try:
        if mode == "host-only":
            assert client.verify_batch([good, bad]) == [True, False]
            assert svc.metrics.counters["crypto.fallbacks"] == 1
        else:
            with pytest.raises(DeviceFlushError):
                client.verify_batch([good, bad])
            assert svc.metrics.counters.get("crypto.fallbacks", 0) == 0
        assert svc.metrics.counters["crypto.flush_errors"] == 1
    finally:
        svc.stop()


def test_lazy_start_on_first_submit():
    suite, good, _ = _scalar_fixture()
    svc = CryptoPlaneService(BatchedBackend(suite), window_s=0.0)
    client = svc.client(EagerBackend(suite))
    assert client.verify_batch([good]) == [True]
    assert svc.metrics.counters["crypto.flushes"] == 1
    svc.stop()


def test_stop_is_terminal_no_lazy_resurrection():
    suite, good, _ = _scalar_fixture()
    svc = CryptoPlaneService(BatchedBackend(suite), window_s=0.0).start()
    client = svc.client(EagerBackend(suite))
    assert client.verify_batch([good]) == [True]
    svc.stop()
    assert client.verify_batch([good]) == [True]  # via fallback
    assert svc.metrics.counters["crypto.fallbacks"] == 1
    assert svc._thread is None  # nothing resurrected
    assert svc.start()._thread is None  # start() after stop() refuses too


def test_cluster_does_not_stop_external_service():
    suite = ScalarSuite()
    _suite, good, _ = _scalar_fixture()
    svc = CryptoPlaneService(BatchedBackend(suite), window_s=0.0)
    c = LocalCluster(4, seed=1, crypto="service", crypto_service=svc)
    c.stop()
    assert svc.alive
    client = svc.client(EagerBackend(suite))
    assert client.verify_batch([good]) == [True]  # still serving
    assert svc.metrics.counters.get("crypto.fallbacks", 0) == 0
    svc.stop()
    with pytest.raises(ValueError, match="pre-built crypto_service"):
        LocalCluster(
            4, seed=1, crypto="service", crypto_service=svc,
            service_kwargs=dict(window_s=0.5),
        )
    with pytest.raises(ValueError, match="requires a service crypto arm"):
        LocalCluster(4, seed=1, crypto_service=svc)


def test_timed_out_job_is_dropped_not_flushed():
    suite, good, _ = _scalar_fixture()
    release = threading.Event()

    class Slow(CryptoBackend):
        def __init__(self):
            self.inner = BatchedBackend(suite)
            self.calls = 0

        def verify_batch(self, reqs):
            self.calls += 1
            release.wait(5)
            return self.inner.verify_batch(reqs)

    backend = Slow()
    # window large enough that the job is still QUEUED (not yet
    # collected) when its client times out and cancels it
    svc = CryptoPlaneService(backend, window_s=10.0).start()
    client = svc.client(EagerBackend(suite), timeout_s=0.05)
    assert client.verify_batch([good]) == [True]  # timeout -> fallback
    assert svc.metrics.counters["crypto.fallbacks"] == 1
    release.set()
    svc.stop()
    assert backend.calls == 0, "cancelled job still reached the backend"


# ---------------------------------------------------------------------------
# metrics and spans of a live service-arm cluster
# ---------------------------------------------------------------------------


def test_service_metrics_and_flush_spans_exported():
    c = LocalCluster(4, seed=0, crypto="service")
    for k in range(6):
        for i in range(4):
            c.submit(i, Input.user(f"tx-{k}-{i}"))
    c.start()
    try:
        assert c.wait(
            lambda cl: all(len(cl.batches(i)) >= 4 for i in range(4)),
            EPOCH_TIMEOUT_S,
        ), {i: len(c.batches(i)) for i in range(4)}
        m = c.merged_metrics(fresh=True)
        tracks = c.trace_events()
    finally:
        c.stop()
    assert m.counters.get("cluster.handler_errors", 0) == 0
    assert m.counters.get("crypto.flushes", 0) > 0
    assert m.counters.get("crypto.fallbacks", 0) == 0
    assert "crypto.flush" in m.timers and "crypto.wait" in m.timers
    assert "crypto.batch_size" in m.summaries
    assert "cryptoplane" in tracks, sorted(tracks)
    names = [ev.name for ev in tracks["cryptoplane"]]
    assert "crypto.flush.open" in names and "crypto.flush.done" in names
    opens = [ev for ev in tracks["cryptoplane"] if ev.name == "crypto.flush.open"]
    assert all(ev.args["requests"] >= 1 for ev in opens)
    assert all(ev.args["backend"] == "BatchedBackend" for ev in opens)
    c = LocalCluster(4, seed=1, crypto="service")
    try:
        svc = c.crypto_service
        svc.metrics.count("crypto.flushes")
        svc.metrics.gauge("crypto.queue_depth", 0)
        text = c.merged_metrics().prometheus_text()
        assert 'name="crypto.flushes"' in text
        assert 'name="crypto.queue_depth"' in text
    finally:
        c.stop()


# ---------------------------------------------------------------------------
# fault attribution through the service, against the reference
# ---------------------------------------------------------------------------


def _tampered_sim(pkg: str, backend_factory=None):
    """``tests/test_cryptoplane.py``'s deterministic drill on ``pkg``'s
    simulated net: N = 7, two faulty nodes running the real algorithm
    with half their messages tampered, QueueingHoneyBadger batch 8, one
    user transaction a node, until every correct node has a batch.
    Returns (per-node batches, per-node fault logs, deliveries)."""
    import importlib

    net_mod = importlib.import_module(f"{pkg}.net")
    adv = importlib.import_module(f"{pkg}.net.adversary")
    qhb = importlib.import_module(f"{pkg}.protocols.queueing_honey_badger")
    b = (net_mod.NetBuilder(7, seed=9).num_faulty(2)
         .adversary(adv.TamperingAdversary(tamper_p=0.5))
         .protocol(lambda ni, sink, rng: qhb.QueueingHoneyBadger(
             ni, sink, batch_size=8, session_id=b"qhb-test")))
    if backend_factory is not None:
        b = b.backend(backend_factory)
    net = b.build()
    net.broadcast_input(lambda nid: qhb.Input.user(f"x{nid}"))
    net.crank_until(lambda n: all(
        any(type(o).__name__ == "DhbBatch" for o in n.node(i).outputs)
        for i in n.correct_ids))
    batches = {
        i: [(o.era, o.epoch, o.contributions) for o in net.node(i).outputs
            if type(o).__name__ == "DhbBatch"]
        for i in net.correct_ids
    }
    faults = {i: [(f.node_id, f.kind) for f in net.node(i).faults]
              for i in net.correct_ids}
    return batches, faults, net.delivered


def test_fault_multiset_parity_deterministic_sim():
    suite = ScalarSuite()
    ref = _tampered_sim("hbbft_tpu")
    inline = _tampered_sim("hbbft_tpu_torch")
    svc = CryptoPlaneService(BatchedBackend(suite), window_s=0.0).start()
    try:
        via_service = _tampered_sim(
            "hbbft_tpu_torch", lambda s: svc.client(BatchedBackend(s)))
        assert svc.metrics.counters["crypto.flushes"] > 0
        assert svc.metrics.counters.get("crypto.fallbacks", 0) == 0
    finally:
        svc.stop()
    assert inline == ref
    assert via_service == ref
    share_faults = [
        (subj, kind)
        for faults in ref[1].values()
        for subj, kind in faults
        if "invalid-share" in kind
    ]
    assert share_faults, "tampering never produced a share fault"


# ---------------------------------------------------------------------------
# fallback drill: the service dies mid-run, the cluster keeps committing
# ---------------------------------------------------------------------------


def test_service_death_falls_back_to_scalar():
    with LocalCluster(
        4, seed=3, node_impl="python", crypto="service",
        service_kwargs=dict(timeout_s=2.0),
    ) as c:
        c.drive_to([0, 1, 2, 3], 2, timeout_s=EPOCH_TIMEOUT_S)
        pre = dict(c.merged_metrics().counters)
        assert pre.get("crypto.flushes", 0) > 0  # the service WAS serving
        c.crypto_service.kill()
        c.drive_to([0, 1, 2, 3], 4, timeout_s=EPOCH_TIMEOUT_S, tag="post")
        m = c.merged_metrics()
        assert m.counters.get("cluster.handler_errors", 0) == 0
        assert m.counters.get("crypto.fallbacks", 0) > 0
        want = _batch_keys(c, 0, upto=4)
        for i in (1, 2, 3):
            assert _batch_keys(c, i, upto=4) == want
