"""The port's chaos plane (``hbbft_tpu_torch.chaos``) and
``LocalCluster(byzantine=)`` against the reference's
(``hbbft_tpu/chaos/``, ``tests/test_chaos.py``).

* ``tamper_payload`` rewrites every payload of a live epoch's traffic
  into the same bytes as the reference's for the same rng, payload and
  suite; ``build_schedule`` gives the same events for a seed.
* ``LocalCluster`` rejects a bad ``byzantine=`` map with the
  reference's errors, before any listener exists.
* Every strategy on python nodes at N = 4 (f = 1), the mixed N = 10
  (f = 3) cluster, a composed schedule (Byzantine node, WAN shape,
  kill/restart, partition/heal) and open-loop traffic beside a
  corrupt-share node, each run on both packages: the oracle's verdicts
  and the set of accused ids equal the reference's.  Live socket runs
  are not byte-deterministic, so the comparison is at the set level.
* ``impl="native"`` arms a native node as the reference arms it: the
  corrupt-share sender through the engine's tamper hooks, every other
  strategy at the transport's send surface (its live runs are in
  ``tests/test_torch_native_chaos.py``).

Tolerance: exact.
"""

from __future__ import annotations

import importlib
import random
import time

import pytest
from torch_low_priority import low_priority

from hbbft_tpu.chaos import scheduler as ref_scheduler
from hbbft_tpu.chaos import strategies as ref_strategies
from hbbft_tpu.crypto.suite import ScalarSuite as RefScalarSuite
from hbbft_tpu.transport import cluster as ref_cluster
from hbbft_tpu_torch.chaos import (
    EQUIVOCABLE_KINDS,
    SHARE_KINDS,
    STRATEGIES,
    build_schedule,
    install_byzantine,
    tamper_payload,
)
from hbbft_tpu_torch.crypto.suite import ScalarSuite
from hbbft_tpu_torch.protocols.sender_queue import SqMessage
from hbbft_tpu_torch.transport import LocalCluster
from hbbft_tpu_torch.utils import serde

EPOCH_TIMEOUT_S = 45  # wall cap per driven phase; typical is < 2 s

#: per-strategy activity counter the run must have moved
ACTIVITY = {
    "crash-stop": "chaos.crash_stopped",
    "equivocate": "chaos.equivocated",
    "corrupt-share": "chaos.tampered_shares",
    "stale-replay": "chaos.replayed",
    "flood": "chaos.garbage_payloads",
}


def _chaos(pkg: str):
    return importlib.import_module(f"{pkg}.chaos")


def _cluster_mod(pkg: str):
    return importlib.import_module(f"{pkg}.transport.cluster")


def _harvest(seed: int = 3):
    """Every distinct payload node 1 of a port cluster sends in its first
    epoch."""
    corpus = []
    with LocalCluster(4, seed=seed) as c:
        t = c.nodes[1].transport
        orig, orig_many = t.send, t.send_many

        def send(dest, payload):
            corpus.append(payload)
            return orig(dest, payload)

        def send_many(items):
            corpus.extend(p for _, p in items)
            return orig_many(items)

        t.send, t.send_many = send, send_many
        c.drive_to([0, 1, 2, 3], 1, timeout_s=EPOCH_TIMEOUT_S)
    return sorted(set(corpus))


@low_priority
def test_tamper_payload_matches_reference():
    """``tests/test_chaos.py:374``: the variants are valid wire traffic that
    differs from the original, and each is the reference's, byte for byte,
    for the same rng state, payload and suite."""
    corpus = _harvest()
    changed = 0
    for kinds in (EQUIVOCABLE_KINDS | SHARE_KINDS, SHARE_KINDS, EQUIVOCABLE_KINDS):
        rng, ref_rng = random.Random(17), random.Random(17)
        for payload in corpus:
            v = tamper_payload(payload, rng, ScalarSuite(), kinds)
            want = ref_strategies.tamper_payload(payload, ref_rng, RefScalarSuite(), kinds)
            assert v == want
            if v is not None:
                changed += 1
                assert v != payload
                assert isinstance(serde.try_loads(v, suite=ScalarSuite()), SqMessage)
    assert changed > 5
    assert tamper_payload(serde.dumps(7), random.Random(1), ScalarSuite(), SHARE_KINDS) is None
    ann = serde.dumps(SqMessage.epoch_started((0, 1)))
    assert tamper_payload(ann, random.Random(1), ScalarSuite(), EQUIVOCABLE_KINDS) is None


@pytest.mark.parametrize("seed", [5, 6, 7, 41])
@pytest.mark.parametrize("flags", [
    dict(), dict(outage=True), dict(churn=False), dict(partition=False, outage=True),
])
def test_build_schedule_matches_reference(seed, flags):
    for ids, duration in (([3], 3.0), ([7, 8, 9], 10.0), ([], 1.0)):
        got = build_schedule(seed, ids, duration, **flags)
        want = ref_scheduler.build_schedule(seed, ids, duration, **flags)
        assert [(e.at_s, e.kind, e.node) for e in got] == [
            (e.at_s, e.kind, e.node) for e in want]
        assert all(e.node in ids and 0.0 <= e.at_s <= duration for e in got)


@pytest.mark.parametrize("kwargs", [
    dict(byzantine={2: "flood", 3: "flood"}),
    dict(byzantine={9: "flood"}),
    dict(byzantine={-1: "flood"}),
    dict(byzantine={3: "no-such-strategy"}),
    dict(num_faulty=2),
])
def test_localcluster_validates_byzantine_like_the_reference(kwargs):
    """``tests/test_chaos.py:72,86``: the same ``ValueError`` text, raised
    before any listener is bound."""
    with pytest.raises(ValueError) as ref:
        ref_cluster.LocalCluster(4, **kwargs)
    with pytest.raises(ValueError) as got:
        LocalCluster(4, **kwargs)
    assert str(got.value) == str(ref.value)


def _armed(pkg: str, name: str) -> dict:
    """A native node of ``pkg`` armed with strategy ``name`` by
    ``install_byzantine(impl="native")``, and a ``LocalCluster`` that
    makes node 3 a native flooding node, as plain data."""
    cluster = _cluster_mod(pkg)
    chaos = _chaos(pkg)
    suite = importlib.import_module(f"{pkg}.crypto.suite").ScalarSuite()
    with cluster.LocalCluster(4, seed=0, node_impl="native") as c:
        node = chaos.install_byzantine(
            c.nodes[3], name, seed=0, suite=suite, cluster_id=c.cluster_id,
            peer_addrs={j: a for j, a in c.addr_map.items() if j != 3}, impl="native")
        t = node.transport
        armed = dict(
            node=type(node).__name__,
            tamper_hooked=hasattr(node, "_chaos_tamper_cb"),
            wrapped=sorted(k for k in ("send", "send_many", "send_msgb", "send_wire")
                           if k in vars(t)),
        )
    with cluster.LocalCluster(4, seed=0, byzantine={3: "flood"}, node_impl={3: "native"}) as c:
        armed["flood_node"] = type(c.nodes[3]).__name__
        armed["flood_wrapped"] = sorted(k for k in ("send", "send_many", "send_msgb",
                                                    "send_wire") if k in vars(c.nodes[3].transport))
    return armed


def test_native_byzantine_arm_raises():
    """The native arm the reference has, which raised here before the
    native engine was ported: ``install_byzantine(impl="native")`` arms a
    native node exactly as the reference's does (the corrupt-share
    sender through the engine's tamper hooks, the other strategies at
    the transport's send surface, ``send_msgb``/``send_wire`` included),
    and ``LocalCluster`` builds a native Byzantine node."""
    for name in ("corrupt-share", "flood"):
        got = _armed("hbbft_tpu_torch", name)
        assert got == _armed("hbbft_tpu", name)
        assert got["node"] == got["flood_node"] == "NativeClusterNode"
        assert got["tamper_hooked"] == (name == "corrupt-share")
    assert sorted(STRATEGIES) == sorted(ref_strategies.STRATEGIES)


def _verdicts(c, o, names) -> dict:
    """What ``tests/test_chaos.py`` asserts of a run, as plain data: the
    oracle's safety and attribution verdicts, the accused ids, the fault
    kinds' families, and which strategies' activity moved."""
    chaos_oracle = importlib.import_module(type(o).__module__)
    k = o.assert_safety()
    named = o.assert_attribution()
    accused = sorted({s for i in o.honest_ids
                      for s, _ in chaos_oracle.fault_entries(c.nodes[i])})
    kinds = {kd.split(":")[1] for i in o.honest_ids
             for _, kd in chaos_oracle.fault_entries(c.nodes[i]) if ":" in kd}
    m = c.merged_metrics()
    return dict(
        prefix_ok=k >= 2,
        named=named > 0,
        accused=accused,
        invalid_share="invalid-share" in kinds,
        active=sorted(n for n in names if m.counters.get(ACTIVITY[n], 0) > 0),
        handler_errors=m.counters.get("cluster.handler_errors", 0),
        bad_payload=m.counters.get("cluster.bad_payload", 0) > 0,
    )


def _strategy_run(pkg: str, name: str, seed: int = 29) -> dict:
    chaos = _chaos(pkg)
    spec = (lambda: chaos.CrashStop(after_s=0.3)) if name == "crash-stop" else name
    with _cluster_mod(pkg).LocalCluster(4, seed=seed, byzantine={3: spec}) as c:
        o = chaos.ChaosOracle(c)
        o.assert_progress(extra=2, timeout_s=EPOCH_TIMEOUT_S)
        if name == "crash-stop":
            time.sleep(0.4)
            o.assert_progress(extra=2, timeout_s=EPOCH_TIMEOUT_S, tag="post")
        return _verdicts(c, o, [name])


def _same_as_reference(run, *args):
    """The port's run against the reference's; a dissenting pair is re-run
    a bounded number of times (which proposals and which shares reach a
    node first depends on arrival times over live sockets)."""
    for _attempt in range(3):
        port, ref = run("hbbft_tpu_torch", *args), run("hbbft_tpu", *args)
        if port == ref:
            break
    assert port == ref
    return port


@pytest.mark.parametrize("name", sorted(ACTIVITY))
@low_priority
def test_byzantine_strategy_python_arm_matches_reference(name):
    """``tests/test_chaos.py:237``, one strategy a case: the honest trio
    agrees, faults name only node 3, and the verdicts equal the
    reference's run."""
    v = _same_as_reference(_strategy_run, name)
    assert v["prefix_ok"] and v["handler_errors"] == 0 and v["active"] == [name]
    assert set(v["accused"]) <= {3}
    if name == "corrupt-share":
        assert v["named"] and v["accused"] == [3] and v["invalid_share"]
    if name == "flood":
        assert v["bad_payload"]


def _mixed_run(pkg: str) -> dict:
    chaos = _chaos(pkg)
    byz = {7: "corrupt-share", 8: "equivocate", 9: "flood"}
    with _cluster_mod(pkg).LocalCluster(10, seed=41, byzantine=byz) as c:
        o = chaos.ChaosOracle(c)
        assert o.honest_ids == list(range(7))
        o.assert_progress(extra=2, timeout_s=EPOCH_TIMEOUT_S)
        v = _verdicts(c, o, sorted(byz.values()))
    # which of the three an honest node names first depends on timing:
    # compare that node 7 (the corrupt shares) is named, inside {7, 8, 9}
    v["accused"] = 7 in v["accused"] and set(v["accused"]) <= {7, 8, 9}
    return v


@low_priority
def test_mixed_byzantine_n10_f3_matches_reference():
    """``tests/test_chaos.py:271``: three adversaries at once."""
    v = _same_as_reference(_mixed_run)
    assert v["prefix_ok"] and v["named"] and v["accused"] is True
    assert v["active"] == ["corrupt-share", "equivocate", "flood"]
    assert v["handler_errors"] == 0


def _composed_run(pkg: str) -> dict:
    chaos = _chaos(pkg)
    faults = importlib.import_module(f"{pkg}.transport.faults")
    inj = faults.FaultInjector(seed=9, default=faults.wan_profile("wan", scale=0.2))
    c = _cluster_mod(pkg).LocalCluster(4, seed=53, byzantine={3: "corrupt-share"},
                                       injector=inj)
    runner = chaos.ChaosRunner(c, chaos.build_schedule(seed=7, byzantine_ids=[3],
                                                       duration_s=3.0), injector=inj)
    with c:
        o = chaos.ChaosOracle(c)
        runner.start()
        while runner.pump():
            o.assert_progress(extra=1, timeout_s=EPOCH_TIMEOUT_S, tick=runner.pump,
                              tag="chaos")
        runner.drain()
        o.assert_progress(extra=2, timeout_s=EPOCH_TIMEOUT_S, tag="post")
        safe = o.assert_safety() >= 3
        o.assert_attribution()
        m = c.merged_metrics()
        return dict(
            safe=safe,
            fired=sorted({e.kind for e in runner.fired}),
            shaped=inj.stats.shaped > 0,
            partitioned=inj.stats.partitioned > 0,
            handler_errors=m.counters.get("cluster.handler_errors", 0),
            cluster_track=sorted({e.name for e in c.trace.snapshot()}),
        )


@low_priority
def test_composed_chaos_schedule_matches_reference():
    """``tests/test_chaos.py:285``: a corrupt-share node churned and
    partitioned over WAN-shaped links while the honest quorum commits."""
    v = _same_as_reference(_composed_run)
    assert v == dict(safe=True, fired=["heal", "kill", "partition", "restart"],
                     shaped=True, partitioned=True, handler_errors=0,
                     cluster_track=["chaos.heal", "chaos.kill", "chaos.partition",
                                    "chaos.restart"])


def _traffic_run(pkg: str) -> dict:
    chaos = _chaos(pkg)
    traffic = importlib.import_module(f"{pkg}.traffic")
    with _cluster_mod(pkg).LocalCluster(4, seed=59, byzantine={3: "corrupt-share"}) as c:
        d = traffic.TrafficDriver(c, traffic.ClientFleet(6, 4.0, seed=5),
                                  assign=lambda cid: cid % 3)
        res = d.run_open_loop(1.5, drain_timeout_s=EPOCH_TIMEOUT_S)
        o = chaos.ChaosOracle(c, driver=d)
        expect = {tid for _, _, tid, _ in traffic.ClientFleet(6, 4.0, seed=5).take(
            res["admitted"])}
        covered = c.wait(lambda cl: all(expect <= o.committed_ids(i) for i in o.honest_ids),
                         EPOCH_TIMEOUT_S)
        once = o.assert_exactly_once() == res["committed"]
        exact = all({t.split("#", 1)[0] for t in chaos.stream_txns(c, i)} == expect
                    for i in o.honest_ids)
        o.assert_safety()
        o.assert_attribution()
        return dict(outstanding=res["outstanding"], all_committed=res["committed"]
                    == res["admitted"] > 0, covered=covered, once=once, exact=exact)


@low_priority
def test_traffic_exactly_once_with_byzantine_node_matches_reference():
    """``tests/test_chaos.py:339``: open-loop clients homed on the honest
    trio beside a corrupt-share node commit exactly once."""
    v = _same_as_reference(_traffic_run)
    assert v == dict(outstanding=0, all_committed=True, covered=True, once=True, exact=True)
