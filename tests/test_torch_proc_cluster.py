"""The port's process-per-node runtime (``ProcCluster`` over
``python -m hbbft_tpu_torch.transport.cluster_worker``).

After the reference's ``tests/test_transport_proc.py`` and the process
cases of ``tests/test_cryptoplane_proc.py``, on both worker arms
(``impl="python"`` and ``"native"``):

* presubmit workers agree on one ``batches_sha`` across the four
  processes, and it is the digest of the port's thread-mode cluster of the
  same arm at the same seed;
* the kill/restart drill (a real SIGKILL) is lossless for the survivors,
  and the reborn worker accepts redials and handles traffic again;
* every worker serves ``/metrics`` and ``/healthz``, and the per-worker
  Chrome traces merge into one trace, one pid a node;
* the ``service-proc`` arm sends every worker's share checks to one port
  crypto-service process with no fallback and commits the inline arm's
  stream; killing the service flips the workers to their counted local
  fallbacks and they keep committing.

Presubmit digests can differ from one process run to another (a
proposer that misses one epoch's cut under a scheduling outlier gives an
agreement-safe history of N - 1 contributions), so digests are compared
inside one run, or across runs of the port with a bounded retry, as the
reference's tests do; never across the two packages' process runs.

Tolerance: exact.
"""

from __future__ import annotations

import hashlib
import json

import pytest
from torch_low_priority import low_priority

from hbbft_tpu_torch import native_engine
from hbbft_tpu_torch.protocols.queueing_honey_badger import Input
from hbbft_tpu_torch.transport import LocalCluster, ProcCluster
from hbbft_tpu_torch.utils import serde

EPOCH_TIMEOUT_S = 45  # wall cap per driven phase; typical is < 5 s


@pytest.fixture(autouse=True)
def _engine_built():
    # every worker process loads the engine that this build leaves in
    # hbbft_tpu_torch/build/, so none of them compiles it
    assert native_engine.get_lib() is not None


def _thread_arm_sha(impl: str, seed: int, epochs: int) -> tuple:
    """The worker's presubmit digest from a thread-mode cluster, and
    whether every epoch in it had all four contributions."""
    c = LocalCluster(4, seed=seed, batch_size=8, node_impl=impl)
    for k in range(epochs + 4):
        for i in range(4):
            c.submit(i, Input.user(f"b-{k}-{i}"))
    c.start()
    try:
        assert c.wait(lambda cl: all(len(cl.batches(i)) >= epochs for i in range(4)),
                      EPOCH_TIMEOUT_S)
        digest = hashlib.sha256()
        window = c.batches(0)[:epochs]
        for b in window:
            digest.update(serde.dumps((b.era, b.epoch, b.contributions)))
        return digest.hexdigest()[:16], all(len(b.contributions) == 4 for b in window)
    finally:
        c.stop()


def _proc_sha(impl: str, seed: int, epochs: int, crypto: str = "inline") -> tuple:
    """A presubmit run's one digest across the workers, and whether every
    epoch in it had all four contributions."""
    with ProcCluster(4, seed=seed, impl=impl, epochs=epochs, drive="presubmit",
                     timeout_s=90.0, crypto=crypto) as c:
        sums = c.join(timeout_s=EPOCH_TIMEOUT_S + 60)
        assert all(s is not None and s["done"] for s in sums.values()), sums
        assert all(s["handler_errors"] == 0 and s["bad_payload"] == 0
                   for s in sums.values()), sums
        shas = {i: s["batches_sha"] for i, s in sums.items()}
        assert len(set(shas.values())) == 1, f"cross-process divergence: {shas}"
        if crypto == "service-proc":
            for i, s in sums.items():
                rpc = s.get("crypto_rpc")
                assert rpc and rpc["calls"] > 0 and rpc["fallbacks"] == 0, (i, s)
                assert rpc["merged_requests"] >= rpc["requests"], (i, s)
            stats = c.crypto_service.stats()["counters"]
            assert stats["crypto.requests"] > stats["crypto.flushes"] > 0, stats
        full = all(x == 4 for s in sums.values() for x in s["epoch_contribs"])
        return shas[0], full


def _agree(*runs):
    """Each run's digest, a run re-made (at most 3 times in all) while an
    epoch in its window misses a proposer, then compared."""
    got = []
    for run in runs:
        for _attempt in range(3):
            sha, full = run()
            if full:
                break
        got.append(sha)
    assert len(set(got)) == 1, got
    return got[0]


@pytest.mark.parametrize("impl", ["python", "native"])
@low_priority
def test_proc_cluster_one_sha_matches_thread_arm(impl):
    _agree(lambda: _proc_sha(impl, 0, 3), lambda: _thread_arm_sha(impl, 0, 3))


def _counter(cl, node_id, name):
    try:
        text = cl.scrape(node_id, "/metrics").decode()
    except OSError:
        return 0
    for line in text.splitlines():
        if f'name="{name}"' in line and line.startswith("hbbft_count"):
            return int(float(line.rsplit(None, 1)[1]))
    return 0


@pytest.mark.parametrize("impl", ["python", "native"])
@low_priority
def test_proc_kill_restart_drill_lossless_for_survivors(impl):
    with ProcCluster(4, seed=3, impl=impl, epochs=0, drive="self", timeout_s=120.0,
                     obs=True) as c:
        survivors = [0, 1, 2]
        assert c.wait(lambda cl: all(cl.batch_count(i) >= 2 for i in range(4)),
                      EPOCH_TIMEOUT_S), {i: c.batch_count(i) for i in range(4)}
        c.kill(3)
        base = max(c.batch_count(i) for i in survivors)
        assert c.wait(lambda cl: all(cl.batch_count(i) >= base + 2 for i in survivors),
                      EPOCH_TIMEOUT_S)
        c.restart(3)
        assert c.wait(lambda cl: _counter(cl, 3, "transport.accepts") >= 1
                      and _counter(cl, 3, "cluster.msgs_handled") >= 1, EPOCH_TIMEOUT_S)
        post = max(c.batch_count(i) for i in survivors)
        assert c.wait(lambda cl: all(cl.batch_count(i) >= post + 2 for i in survivors),
                      EPOCH_TIMEOUT_S)
        c.stop()
        reborn = c.workers[3].summary
        assert reborn is not None and reborn["accepts"] >= 1, reborn
        assert reborn["msgs_handled"] > 0 and reborn["handler_errors"] == 0, reborn
        streams = {i: c.batches(i) for i in survivors}
        by_key = {i: {(b["era"], b["epoch"]): b for b in bs} for i, bs in streams.items()}
        for i in survivors:
            keys = [(b["era"], b["epoch"]) for b in streams[i]]
            assert keys == sorted(set(keys)), f"node {i} stream disordered"
        for a in survivors:
            for b in survivors:
                common = by_key[a].keys() & by_key[b].keys()
                assert common
                assert all(by_key[a][k] == by_key[b][k] for k in common), (a, b)


@low_priority
def test_worker_obs_scrape_and_trace_merge(tmp_path):
    trace_dir = str(tmp_path / "traces")
    with ProcCluster(4, seed=5, impl="native", epochs=0, drive="self", timeout_s=120.0,
                     obs=True, trace_dir=trace_dir) as c:
        assert c.wait(lambda cl: all(cl.batch_count(i) >= 2 for i in range(4)),
                      EPOCH_TIMEOUT_S)
        metrics = c.scrape(1, "/metrics").decode()
        assert "cluster.msgs_handled" in metrics or "cluster_msgs_handled" in metrics
        health = json.loads(c.scrape(2, "/healthz"))
        assert health["ok"] is True
        assert health["nodes"]["2"]["alive"] is True and health["nodes"]["2"]["batches"] >= 2
        c.stop()
        merged = c.merged_chrome_trace()
    events = merged["traceEvents"]
    pids = {ev["args"]["name"]: ev["pid"] for ev in events
            if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    assert {"node0", "node1", "node2", "node3"} <= set(pids), pids
    assert len(set(pids.values())) == len(pids)
    commit_pids = {ev["pid"] for ev in events if ev.get("name") == "epoch.commit"}
    assert [ev for ev in events if ev.get("name") == "epoch.open"] and len(commit_pids) >= 2
    assert all(ev["ts"] >= 0 for ev in events if ev.get("ph") != "M")


@pytest.mark.parametrize("impl", ["python", "native"])
@low_priority
def test_proc_cluster_service_arm_no_fallback_and_inline_identity(impl):
    """One port crypto-service process serves all four workers with no
    fallback, merging their requests, and the stream is the inline
    arm's."""
    _agree(lambda: _proc_sha(impl, 0, 3, crypto="service-proc"),
           lambda: _proc_sha(impl, 0, 3))


@low_priority
def test_proc_cluster_service_kill_drill():
    with ProcCluster(4, seed=1, impl="native", epochs=0, drive="self", timeout_s=90.0,
                     crypto="service-proc", service_kwargs=dict(timeout_s=2.0)) as pc:
        assert pc.wait(lambda c: all(c.batch_count(i) >= 2 for i in range(4)),
                       EPOCH_TIMEOUT_S)
        pc.kill_service()
        base = {i: pc.batch_count(i) for i in range(4)}
        assert pc.wait(lambda c: all(c.batch_count(i) >= base[i] + 2 for i in range(4)),
                       EPOCH_TIMEOUT_S)
        pc.stop()
        for i, s in pc.summaries().items():
            assert s is not None, i
            rpc = s.get("crypto_rpc")
            assert rpc and rpc["calls"] > 0 and rpc["fallbacks"] > 0, (i, s)


def test_proc_cluster_construction_validation_matches_reference():
    from hbbft_tpu.transport.proc_cluster import ProcCluster as RefProcCluster

    for kwargs in (dict(crypto="service"), dict(crypto_service=("127.0.0.1", 1)),
                   dict(impl="rust"), dict(drive="open"),
                   dict(service_kwargs=dict(backend="batched"))):
        with pytest.raises(ValueError) as ref:
            RefProcCluster(4, **kwargs)
        with pytest.raises(ValueError) as got:
            ProcCluster(4, **kwargs)
        assert str(got.value) == str(ref.value)


def test_worker_argv_matches_reference():
    """The parent spawns the port's worker module with the reference's
    flags, and an owned service is the port's service process."""
    import hbbft_tpu.transport.proc_cluster as ref_pc
    import hbbft_tpu_torch.transport.proc_cluster as port_pc

    def argv(mod):
        captured = {}

        class _Popen:
            stdout = ()

            def __init__(self, cmd, **kw):
                captured["cmd"], captured["env"] = cmd, kw["env"]

        pc = mod.ProcCluster(4, seed=2, impl="native", epochs=3, obs=True, trace_dir=None)
        real = mod.subprocess.Popen
        mod.subprocess.Popen = _Popen
        try:
            pc._spawn(1)
        finally:
            mod.subprocess.Popen = real
        return captured

    ref, port = argv(ref_pc), argv(port_pc)
    assert port["cmd"][1:3] == ["-m", "hbbft_tpu_torch.transport.cluster_worker"]
    assert ref["cmd"][1:3] == ["-m", "hbbft_tpu.transport.cluster_worker"]
    assert port["cmd"][3:] == ref["cmd"][3:]
    assert port["env"]["PYTHONPATH"] == ref["env"]["PYTHONPATH"]
