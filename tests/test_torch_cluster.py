"""The port's TCP cluster (``hbbft_tpu_torch.transport.cluster``) against
the reference's.

At N = 4, seed 0, six presubmitted rounds of one transaction a node, the
port's ``"inline"``, ``"service"`` and ``"service-proc"`` arms and the
reference's python ``"inline"`` arm commit the same per-node stream of
four batches.  Which proposals land in an epoch's subset depends on
arrival times over live sockets, so a dissenting arm is re-run a bounded
number of times, as ``tests/test_cryptoplane.py`` does: a wrong verdict
diverges on every run and no rerun hides it.  The service arms route
every share check through the shared service (flushes > 0) with no
fallback.  The native engine's node arm (all nodes native, a mixed
cluster, a native Byzantine node), which raised here until the engine
was ported (ROADMAP.md Queue 1 item 4), builds the reference's cluster
and commits what it commits.
"""

from __future__ import annotations

import importlib

import pytest

from hbbft_tpu.utils import serde as ref_serde
from hbbft_tpu_torch.transport import LocalCluster
from hbbft_tpu_torch.utils import serde

EPOCH_TIMEOUT_S = 45  # wall cap per driven phase; typical is < 3 s
TARGET = 4


def _run_arm(pkg: str, crypto: str, seed: int = 0, rounds: int = 6):
    """One presubmitted run of ``pkg``'s python-node cluster; returns
    (per-node batch keys, merged counters)."""
    cluster = importlib.import_module(f"{pkg}.transport.cluster")
    qhb = importlib.import_module(f"{pkg}.protocols.queueing_honey_badger")
    dumps = ref_serde.dumps if pkg == "hbbft_tpu" else serde.dumps
    c = cluster.LocalCluster(4, seed=seed, node_impl="python", crypto=crypto)
    for k in range(rounds):
        for i in range(4):
            c.submit(i, qhb.Input.user(f"tx-{k}-{i}"))
    c.start()
    try:
        ok = c.wait(lambda cl: all(len(cl.batches(i)) >= TARGET for i in range(4)),
                    EPOCH_TIMEOUT_S)
        assert ok, {i: len(c.batches(i)) for i in range(4)}
        m = c.merged_metrics(fresh=True)
        assert m.counters.get("cluster.handler_errors", 0) == 0
        assert m.counters.get("cluster.bad_payload", 0) == 0
        assert m.counters.get("cluster.protocol_faults", 0) == 0
        keys = {
            i: [(b.era, b.epoch, dumps(b.contributions)) for b in c.batches(i)[:TARGET]]
            for i in range(4)
        }
        return keys, dict(m.counters)
    finally:
        c.stop()


def test_arms_commit_the_reference_stream():
    arms = [
        ("hbbft_tpu", "inline"),
        ("hbbft_tpu_torch", "inline"),
        ("hbbft_tpu_torch", "service"),
        ("hbbft_tpu_torch", "service-proc"),
    ]
    runs = {arm: _run_arm(*arm) for arm in arms}
    for arm, (keys, _) in runs.items():
        assert all(keys[i] == keys[0] for i in range(4)), f"nodes disagree in {arm}"
    for _retry in range(2):
        by_stream: dict = {}
        for arm, (keys, _) in runs.items():
            by_stream.setdefault(repr(keys[0]), []).append(arm)
        if len(by_stream) == 1:
            break
        majority = max(by_stream.values(), key=len)
        for group in by_stream.values():
            if group is not majority:
                for arm in group:
                    runs[arm] = _run_arm(*arm)
    ref = runs[("hbbft_tpu", "inline")][0]
    for arm, (keys, _) in runs.items():
        assert keys == ref, f"batch divergence in arm {arm}"
    svc = runs[("hbbft_tpu_torch", "service")][1]
    assert svc.get("crypto.flushes", 0) > 0 and svc.get("crypto.requests", 0) > 0, svc
    assert svc.get("crypto.fallbacks", 0) == 0, svc
    rpc = runs[("hbbft_tpu_torch", "service-proc")][1]
    assert rpc.get("crypto.rpc.calls", 0) > 0, rpc
    assert rpc.get("crypto.rpc.fallbacks", 0) == 0, rpc


def test_keys_and_netinfo_match_the_reference():
    """``deal_keys``/``build_netinfo`` draw the reference's keys from the
    same seed: every process of a cluster derives them alone."""
    from hbbft_tpu.crypto.suite import ScalarSuite as RefScalar
    from hbbft_tpu.transport import cluster as ref_cluster
    from hbbft_tpu_torch.crypto.suite import ScalarSuite
    from hbbft_tpu_torch.transport import cluster as port_cluster

    for seed in (0, 3):
        a = ref_cluster.build_netinfo(4, 1, seed, RefScalar(), 2)
        b = port_cluster.build_netinfo(4, 1, seed, ScalarSuite(), 2)
        assert a.public_key_set.to_bytes() == b.public_key_set.to_bytes()
        assert (a.secret_key_share.sign(b"doc").to_bytes()
                == b.secret_key_share.sign(b"doc").to_bytes())
        assert [a.public_key(i).to_bytes() for i in range(4)] == [
            b.public_key(i).to_bytes() for i in range(4)]


def _native_arm(pkg: str, kwargs: dict, rounds: int = 4, target: int = 2) -> dict:
    """A presubmitted run of ``pkg``'s cluster built with ``kwargs``, as
    plain data: each node's class, the honest nodes' streams (their first
    ``target`` batches; one stream when they agree) and the ids they
    accuse."""
    cluster = importlib.import_module(f"{pkg}.transport.cluster")
    qhb = importlib.import_module(f"{pkg}.protocols.queueing_honey_badger")
    oracle = importlib.import_module(f"{pkg}.chaos.oracle")
    dumps = ref_serde.dumps if pkg == "hbbft_tpu" else serde.dumps
    honest = [i for i in range(4) if i not in kwargs.get("byzantine", {})]
    c = cluster.LocalCluster(4, seed=0, **kwargs)
    for k in range(rounds):
        for i in honest:
            c.submit(i, qhb.Input.user(f"tx-{k}-{i}"))
    c.start()
    try:
        assert c.wait(lambda cl: all(len(cl.batches(i)) >= target for i in honest),
                      EPOCH_TIMEOUT_S)
        streams = {tuple((b.era, b.epoch, dumps(b.contributions))
                         for b in c.batches(i)[:target]) for i in honest}
        return dict(
            impls=[type(c.nodes[i]).__name__ for i in range(4)],
            stream=streams.pop() if len(streams) == 1 else None,
            accused=sorted({s for i in honest for s, _ in oracle.fault_entries(c.nodes[i])}),
            handler_errors=c.merged_metrics().counters.get("cluster.handler_errors", 0),
        )
    finally:
        c.stop()


@pytest.mark.parametrize("kwargs, item", [
    (dict(node_impl="native"), "Queue 1 item 4"),
    (dict(node_impl={0: "python", 1: "native"}), "Queue 1 item 4"),
    (dict(byzantine={3: "corrupt-share"}, node_impl={3: "native"}), "Queue 1 item 4"),
])
def test_unported_arguments_raise(kwargs, item):
    """The arms that raised, naming ROADMAP.md ``item``, until the native
    engine was ported: each now builds the reference's cluster (the same
    node classes) and commits what the reference's commits, a dissenting
    pair re-run at most 3 times.  A stream with a corrupt-share node in it
    is compared as the accused ids (only node 3) and the honest nodes'
    agreement, as tests/test_torch_chaos.py compares live Byzantine
    runs."""
    byzantine = "byzantine" in kwargs
    for _attempt in range(3):
        port, ref = (_native_arm(pkg, kwargs) for pkg in ("hbbft_tpu_torch", "hbbft_tpu"))
        if byzantine:
            port["stream"] = ref["stream"] = port["stream"] is not None
        if port == ref:
            break
    assert port == ref
    assert "NativeClusterNode" in port["impls"] and port["handler_errors"] == 0
    assert port["stream"] and port["accused"] == ([3] if byzantine else [])


def test_serve_obs_raises():
    """``serve_obs`` answers on a live cluster, returns the same server on
    a second call and is closed by ``stop()``; on a port another listener
    holds it raises ``OSError``."""
    import json
    import socket
    import urllib.request

    c = LocalCluster(4, seed=0)
    try:
        c.start()
        srv = c.serve_obs()
        assert c.serve_obs() is srv
        url = f"http://127.0.0.1:{srv.port}/healthz"
        health = json.loads(urllib.request.urlopen(url, timeout=10).read())
        assert health["ok"] and sorted(health["nodes"]) == ["0", "1", "2", "3"]
    finally:
        c.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(url, timeout=5)
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    holder.listen(1)
    c = LocalCluster(4, seed=0)
    try:
        with pytest.raises(OSError):
            c.serve_obs(port=holder.getsockname()[1])
    finally:
        c.stop()
        holder.close()


def test_cluster_size_and_crypto_arm_validation():
    with pytest.raises(ValueError, match="BFT bound"):
        LocalCluster(3, num_faulty=1)
    with pytest.raises(ValueError, match="unknown crypto arm"):
        LocalCluster(4, crypto="service-rpc")
    with pytest.raises(ValueError, match="service_kwargs requires"):
        LocalCluster(4, service_kwargs=dict(window_s=0.1))
