"""The chaos plane's native arm against the reference's.

After ``tests/test_chaos.py``'s native cases: every strategy on a cluster
of engine-per-node nodes at N = 4 (f = 1), the corrupt-share sender
through the engine's tamper hooks (``CorruptShareSender.native_tamper_cb``
behind ``hbe_set_tamper``), the mixed N = 10 (f = 3) cluster and a
composed schedule (Byzantine node, WAN shape, kill/restart,
partition/heal), each run on both packages.  Live socket runs are not
byte-deterministic, so, as in ``tests/test_torch_chaos.py``, the oracle's
verdicts and the accused ids are compared at the set level, a dissenting
pair re-run at most 3 times.

Tolerance: exact.
"""

from __future__ import annotations

import importlib
import time

import pytest
from test_torch_chaos import (
    ACTIVITY,
    EPOCH_TIMEOUT_S,
    _chaos,
    _cluster_mod,
    _same_as_reference,
    _verdicts,
)
from torch_low_priority import low_priority


def _strategy_run(pkg: str, name: str, seed: int = 29) -> dict:
    chaos = _chaos(pkg)
    spec = (lambda: chaos.CrashStop(after_s=0.3)) if name == "crash-stop" else name
    with _cluster_mod(pkg).LocalCluster(4, seed=seed, node_impl="native",
                                        byzantine={3: spec}) as c:
        o = chaos.ChaosOracle(c)
        o.assert_progress(extra=2, timeout_s=EPOCH_TIMEOUT_S)
        if name == "crash-stop":
            time.sleep(0.4)
            o.assert_progress(extra=2, timeout_s=EPOCH_TIMEOUT_S, tag="post")
        v = _verdicts(c, o, [name])
        v["tamper_hooked"] = hasattr(c.nodes[3], "_chaos_tamper_cb")
        return v


@pytest.mark.parametrize("name", sorted(ACTIVITY))
@low_priority
def test_byzantine_strategy_native_arm_matches_reference(name):
    """``tests/test_chaos.py:244``, one strategy a case: the honest trio
    agrees, faults name only node 3, and the verdicts equal the
    reference's run; only the corrupt-share sender takes the engine's
    tamper hooks."""
    v = _same_as_reference(_strategy_run, name)
    assert v["prefix_ok"] and v["handler_errors"] == 0 and v["active"] == [name]
    assert set(v["accused"]) <= {3}
    assert v["tamper_hooked"] == (name == "corrupt-share")
    if name == "corrupt-share":
        assert v["named"] and v["accused"] == [3] and v["invalid_share"]
    if name == "flood":
        assert v["bad_payload"]


def _mixed_run(pkg: str) -> dict:
    chaos = _chaos(pkg)
    byz = {7: "corrupt-share", 8: "equivocate", 9: "flood"}
    with _cluster_mod(pkg).LocalCluster(10, seed=41, node_impl="native",
                                        byzantine=byz) as c:
        o = chaos.ChaosOracle(c)
        o.assert_progress(extra=2, timeout_s=EPOCH_TIMEOUT_S)
        v = _verdicts(c, o, sorted(byz.values()))
    v["accused"] = 7 in v["accused"] and set(v["accused"]) <= {7, 8, 9}
    return v


@low_priority
def test_mixed_byzantine_n10_f3_native_matches_reference():
    """``tests/test_chaos.py:275``: three adversaries at once, every node
    native."""
    v = _same_as_reference(_mixed_run)
    assert v["prefix_ok"] and v["named"] and v["accused"] is True
    assert v["active"] == ["corrupt-share", "equivocate", "flood"]
    assert v["handler_errors"] == 0


def _composed_run(pkg: str) -> dict:
    chaos = _chaos(pkg)
    faults = importlib.import_module(f"{pkg}.transport.faults")
    inj = faults.FaultInjector(seed=9, default=faults.wan_profile("wan", scale=0.2))
    c = _cluster_mod(pkg).LocalCluster(4, seed=53, node_impl="native",
                                       byzantine={3: "corrupt-share"}, injector=inj)
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
        )


@low_priority
def test_composed_chaos_schedule_native_matches_reference():
    """``tests/test_chaos.py:329``: a corrupt-share native node churned
    and partitioned over WAN-shaped links while the honest quorum
    commits."""
    v = _same_as_reference(_composed_run)
    assert v == dict(safe=True, fired=["heal", "kill", "partition", "restart"],
                     shaped=True, partitioned=True, handler_errors=0)
