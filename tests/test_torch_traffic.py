"""The port's traffic plane (``hbbft_tpu_torch.traffic``) against the
reference's (``hbbft_tpu/traffic/``).

* ``OpenLoopClient`` and ``ClientFleet`` give the reference's arrival
  stream for a seed (Poisson and fixed arrivals, payload padding,
  ``take`` and ``take_until``).
* ``Mempool`` driven by one script of admits, paces, commits, restarts
  and drains releases, drops and counts as the reference's does.
* On a port cluster (``ScalarSuite``, N = 4, python nodes):
  open-loop traffic commits every admitted transaction exactly once on
  every node (``tests/test_traffic.py:295``, run on both packages with
  the same checks); a presubmitted workload commits the reference's
  stream byte for byte (``:341``'s recipe, across the two packages
  instead of the two node arms); a kill/restart with resubmission stays
  exactly once.

Tolerance: exact.
"""

from __future__ import annotations

import importlib
import time

import pytest
from torch_low_priority import low_priority

from hbbft_tpu.traffic import clients as ref_clients
from hbbft_tpu.traffic import mempool as ref_mempool
from hbbft_tpu.utils import serde as ref_serde
from hbbft_tpu.utils.metrics import Metrics as RefMetrics
from hbbft_tpu_torch.chaos import stream_txns
from hbbft_tpu_torch.traffic import (
    ClientFleet,
    Mempool,
    OpenLoopClient,
    TrafficDriver,
    make_txn,
    txn_id_of,
)
from hbbft_tpu_torch.transport import LocalCluster
from hbbft_tpu_torch.utils import serde
from hbbft_tpu_torch.utils.metrics import Metrics

EPOCH_TIMEOUT_S = 45  # wall cap per driven phase; typical is < 2 s


@pytest.mark.parametrize("kw", [
    dict(num_clients=4, rate_tps_each=10.0, seed=7),
    dict(num_clients=32, rate_tps_each=80 / 16 ** 2, seed=0),
    dict(num_clients=3, rate_tps_each=5.0, seed=1, arrival="fixed"),
    dict(num_clients=2, rate_tps_each=1.0, seed=4, payload_len=32),
])
def test_client_fleet_matches_reference(kw):
    port, ref = ClientFleet(**kw), ref_clients.ClientFleet(**kw)
    assert port.offered_tps == ref.offered_tps
    assert port.take(50) == ref.take(50)
    for t in (0.5, 3.0, 40.0):
        assert port.take_until(t, limit=25) == ref.take_until(t, limit=25)
    assert port.take(5) == ref.take(5)


def test_open_loop_client_and_ids_match_reference():
    for arrival in ("poisson", "fixed"):
        a = OpenLoopClient(5, 2.5, seed=3, arrival=arrival, payload_len=4)
        b = ref_clients.OpenLoopClient(5, 2.5, seed=3, arrival=arrival, payload_len=4)
        assert [a.next() for _ in range(40)] == [b.next() for _ in range(40)]
    assert make_txn(3, 9, 2) == ref_clients.make_txn(3, 9, 2) == "c3.9#xx"
    assert txn_id_of("c3.9#xx") == ref_clients.txn_id_of("c3.9#xx") == "c3.9"
    for mod in (ref_clients, importlib.import_module("hbbft_tpu_torch.traffic.clients")):
        with pytest.raises(ValueError):
            mod.OpenLoopClient(0, 0.0)
        with pytest.raises(ValueError):
            mod.OpenLoopClient(0, 1.0, arrival="bursty")
        with pytest.raises(ValueError):
            mod.ClientFleet(0, 1.0)


def _mempool_script(cls, metrics):
    """``tests/test_traffic.py:163``'s drill, recorded: every return value,
    every release and drop, then the counters."""
    released, dropped, log = [], [], []
    mp = cls(released.append, cap=5, round_txns=2, ahead=1, committed_cache=4,
             metrics=metrics, on_drop=dropped.append)
    log.append(mp.admit("a", "a-txn"))
    log.append(mp.admit("a", "a-txn"))
    for x in "bcdef":
        log.append(mp.admit(x, x))
    log += [len(mp), mp.pace(0), mp.pace(0), mp.pace(1), mp.admit("b", "b")]
    mp.mark_committed(["b", "c"])
    log += [mp.admit("b", "b"), mp.inflight_released(), mp.inflight_count()]
    mp.mark_committed(["f"])
    log += [mp.pace(2), len(mp)]
    mp.admit("g", "g")
    log.append(mp.pace(0))  # the node restarted: its count went back
    for x in "hijk":
        mp.admit(x, x)
    mp.force_rebase()
    log += [mp.pace(5), mp.flush_all(), mp.take_all(), len(mp)]
    mp.mark_committed([f"z{i}" for i in range(10)])
    return log, released, dropped, dict(metrics.counters)


def test_mempool_matches_reference():
    port = _mempool_script(Mempool, Metrics())
    ref = _mempool_script(ref_mempool.Mempool, RefMetrics())
    assert port == ref
    assert port[3]["traffic.committed_evicted"] > 0 and port[2] == ["a"]
    for cls in (Mempool, ref_mempool.Mempool):
        with pytest.raises(ValueError):
            cls(lambda t: None, cap=0)


def _wait_streams_cover(c, nodes, expect):
    assert c.wait(lambda cl: all(expect <= {txn_id_of(t) for t in stream_txns(cl, i)}
                                 for i in nodes), EPOCH_TIMEOUT_S), "a node never caught up"


def _open_loop(pkg: str) -> dict:
    """``tests/test_traffic.py:295``'s run on ``pkg``'s cluster: 8 clients
    at 5 txn/s for 2 s over N = 4, then drained."""
    traffic = importlib.import_module(f"{pkg}.traffic")
    cluster = importlib.import_module(f"{pkg}.transport.cluster")
    with cluster.LocalCluster(4, seed=17) as c:
        d = traffic.TrafficDriver(c, traffic.ClientFleet(8, 5.0, seed=3))
        res = d.run_open_loop(2.0, drain_timeout_s=EPOCH_TIMEOUT_S)
        expect = {tid for _, _, tid, _ in traffic.ClientFleet(8, 5.0, seed=3).take(
            res["admitted"])}
        _wait_streams_cover(c, range(4), expect)
        streams = [stream_txns(c, i) for i in range(4)]
        m = c.merged_metrics()
        return dict(
            outstanding=res["outstanding"],
            admitted_is_arrived=res["admitted"] == res["arrived"] > 20,
            committed_is_admitted=res["committed"] == res["admitted"],
            clocked=d.recorder.hist.count == res["committed"],
            p50_positive=d.recorder.hist.quantile(0.5) > 0.0,
            exactly_once=all(len(s) == len(set(s)) for s in streams),
            no_loss=all({txn_id_of(t) for t in s} == expect for s in streams),
            handler_errors=m.counters.get("cluster.handler_errors", 0),
            overflow=m.counters.get("traffic.mempool_overflow", 0),
            summary='hbbft_summary{name="traffic.latency_s"' in m.prometheus_text(),
        )


@low_priority
def test_open_loop_exactly_once_matches_reference():
    port = _open_loop("hbbft_tpu_torch")
    assert port == _open_loop("hbbft_tpu")
    assert port == dict(outstanding=0, admitted_is_arrived=True, committed_is_admitted=True,
                        clocked=True, p50_positive=True, exactly_once=True, no_loss=True,
                        handler_errors=0, overflow=0, summary=True)


def _presubmit(pkg: str):
    """A deterministic workload of 32 fleet arrivals admitted and
    released before ``start``; returns node 0's stream cut at its last
    batch that carries traffic, after checking agreement inside the run."""
    traffic = importlib.import_module(f"{pkg}.traffic")
    cluster = importlib.import_module(f"{pkg}.transport.cluster")
    dumps = ref_serde.dumps if pkg == "hbbft_tpu" else serde.dumps
    c = cluster.LocalCluster(4, seed=23)
    d = traffic.TrafficDriver(c, traffic.ClientFleet(6, 4.0, seed=11))
    ids = d.run_presubmit(32)
    assert len(ids) == 32
    with c:
        assert d.drain(EPOCH_TIMEOUT_S), d.outstanding()
        _wait_streams_cover(c, range(4), set(ids))
        keys = [(b.era, b.epoch, dumps(b.contributions)) for b in c.batches(0)]
        for i in (1, 2, 3):
            other = [(b.era, b.epoch, dumps(b.contributions)) for b in c.batches(i)]
            k = min(len(keys), len(other))
            assert other[:k] == keys[:k]
    last = max(i for i, b in enumerate(c.batches(0))
               if any(contrib for _, contrib in b.contributions))
    return keys[: last + 1]


@low_priority
def test_presubmitted_workload_commits_the_reference_stream():
    """Which proposals land in an epoch's subset depends on arrival times
    over live sockets, so a dissenting run is repeated a bounded number of
    times, as ``tests/test_torch_cluster.py`` does: a wrong commit
    diverges on every run and no rerun hides it."""
    ref = _presubmit("hbbft_tpu")
    for _attempt in range(3):
        port = _presubmit("hbbft_tpu_torch")
        if port == ref:
            break
        ref = _presubmit("hbbft_tpu")
        if port == ref:
            break
    assert port == ref


@low_priority
def test_kill_restart_resubmit_exactly_once():
    """``tests/test_traffic.py`` of the same name, on the port's cluster:
    node 3 dies with transactions in flight, its backlog is resubmitted to
    node 0, and after the restart every admitted transaction is committed
    exactly once on the survivors."""
    fleet = ClientFleet(8, 6.0, seed=13)
    with LocalCluster(4, seed=31) as c:
        d = TrafficDriver(c, fleet)
        admitted = []
        t0 = time.monotonic()
        while time.monotonic() - t0 < 1.0:
            for _vt, cid, tid, txn in fleet.take_until(time.monotonic() - t0, limit=500):
                if d._admit(cid, tid, txn, time.monotonic()):
                    admitted.append(tid)
            d.pace_all()
            d.poll_commits()
            time.sleep(0.02)
        extra = [a for a in fleet.take(64) if a[1] % 4 == 3][:6]
        now = time.monotonic()
        for _vt, cid, tid, txn in extra:
            if d._admit(cid, tid, txn, now):
                admitted.append(tid)
        d.pace_all()
        assert d.mempools[3].inflight_released()
        c.kill(3)
        target = c.batch_count(0) + 3
        assert c.wait(lambda cl: min(cl.batch_count(i) for i in (0, 1, 2)) >= target,
                      EPOCH_TIMEOUT_S)
        d.poll_commits()
        d.resubmit_lost(3, 0)
        c.restart(3)
        assert d.drain(EPOCH_TIMEOUT_S), d.outstanding()
        assert len(admitted) == len(set(admitted))
        _wait_streams_cover(c, (0, 1, 2), set(admitted))
        for i in (0, 1, 2):
            txns = stream_txns(c, i)
            assert len(txns) == len(set(txns)), f"dup commit on node {i}"
            assert set(map(txn_id_of, txns)) == set(admitted)
        assert d.recorder.committed == len(admitted)
        assert c.merged_metrics().counters.get("cluster.handler_errors", 0) == 0
