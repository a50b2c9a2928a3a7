"""The port's fault injector (``hbbft_tpu_torch.transport.faults``) against
the reference's (``hbbft_tpu/transport/faults.py``).

* ``wan_profile`` gives the same link shapes, and ``LinkFaults.wan_delay``
  the same delay for every uniform draw and jitter distribution.
* For one seed, both injectors give the same decision stream frame for
  frame on every link (drop, duplicate, delay, corrupt, WAN shape,
  partition windows and heal), on one fake monotonic clock so that the
  WAN release clamp sees the same times; the stats and their
  ``faults.*`` gauges match after the schedule.
* On the port's TCP cluster, the reference's drills of
  ``tests/test_traffic.py`` and ``tests/test_transport.py``: the WAN
  FIFO clamp, the reorder fault composing with the WAN shape, the
  injector's gauges in the cluster's Prometheus dump, a partition that
  heals, and random link corruption out of one node.

Tolerance: exact (floats compared with ``==``; corrupted frames byte for
byte).
"""

from __future__ import annotations

import time

import pytest
from torch_low_priority import low_priority

from hbbft_tpu.transport import faults as ref_faults
from hbbft_tpu.utils.metrics import Metrics as RefMetrics
from hbbft_tpu_torch.transport import faults
from hbbft_tpu_torch.transport import (
    FaultInjector,
    LinkFaults,
    LocalCluster,
    PartitionSpec,
    wan_profile,
)
from hbbft_tpu_torch.utils import serde
from hbbft_tpu_torch.utils.metrics import Metrics

EPOCH_TIMEOUT_S = 45  # wall cap per driven phase; typical is < 2 s

LINK_FIELDS = ("drop_p", "dup_p", "delay_p", "delay_s", "corrupt_p", "max_flips",
               "latency_s", "jitter_s", "jitter_dist")


def _fields(lf):
    return None if lf is None else tuple(getattr(lf, k) for k in LINK_FIELDS)


@pytest.mark.parametrize("name", ["clean", "wan", "wan-lossy"])
@pytest.mark.parametrize("scale", [1.0, 0.2, 3.5])
def test_wan_profile_matches_reference(name, scale):
    assert _fields(wan_profile(name, scale)) == _fields(ref_faults.wan_profile(name, scale))
    for mod in (faults, ref_faults):
        with pytest.raises(ValueError, match="unknown WAN profile"):
            mod.wan_profile("marsnet")


@pytest.mark.parametrize("dist", ["exp", "uniform", "lognormal"])
def test_wan_delay_matches_reference(dist):
    kw = dict(latency_s=0.03, jitter_s=0.01, jitter_dist=dist)
    port, ref = LinkFaults(**kw), ref_faults.LinkFaults(**kw)
    us = [0.0, 1e-13, 0.05, 0.37, 0.5, 0.95, 1.0 - 1e-13, 1.0]
    assert [port.wan_delay(u) for u in us] == [ref.wan_delay(u) for u in us]
    assert LinkFaults().wan_delay(0.5) == ref_faults.LinkFaults().wan_delay(0.5) == 0.0


class _Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


SCHEDULES = {
    "drop-dup-delay": dict(drop_p=0.2, dup_p=0.2, delay_p=0.3, delay_s=(0.01, 0.05)),
    "corrupt": dict(corrupt_p=0.4, max_flips=5),
    "corrupt-max-flips-0": dict(corrupt_p=0.5, max_flips=0),
    "wan": dict(latency_s=0.03, jitter_s=0.01),
    "wan-lognormal-reorder": dict(latency_s=0.01, jitter_s=0.02, jitter_dist="lognormal",
                                  delay_p=0.3, delay_s=(0.5, 0.5)),
    "everything": dict(drop_p=0.05, dup_p=0.1, delay_p=0.2, corrupt_p=0.1,
                       latency_s=0.02, jitter_s=0.005, jitter_dist="uniform"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_injector_decision_stream_matches_reference(name, monkeypatch):
    """The same seed, links, partition windows and frames on one clock:
    every ``on_send`` plan (delays and bytes) and the stats are equal."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    kw = SCHEDULES[name]
    special = {(2, 0): dict(drop_p=0.5)}
    injs = []
    for mod in (faults, ref_faults):
        inj = mod.FaultInjector(
            seed=11,
            default=mod.LinkFaults(**kw),
            links={k: mod.LinkFaults(**v) for k, v in special.items()},
            partitions=[mod.PartitionSpec((frozenset([0, 1]), frozenset([3])), 0.4, 0.7)],
        )
        inj.start()
        injs.append(inj)
    links = [(0, 1), (1, 0), (0, 3), (3, 1), (2, 0), (1, 2)]
    plans = ([], [])
    for k in range(240):
        clock.t = 100.0 + 0.005 * k
        src, dst = links[k % len(links)]
        frame = b"frame-%d-" % k + bytes(range(k % 23))
        if k == 180:
            for inj, mod in zip(injs, (faults, ref_faults)):
                inj.add_partition(mod.PartitionSpec((frozenset([1]), frozenset([2])),
                                                    start_s=inj.elapsed()))
        if k == 200:
            for inj in injs:
                inj.heal_all()
        for inj, out in zip(injs, plans):
            out.append(inj.on_send(src, dst, frame))
    assert plans[0] == plans[1]
    names = faults.FaultStats.NAMES
    assert names == ref_faults.FaultStats.NAMES
    got = [getattr(injs[0].stats, k) for k in names]
    assert got == [getattr(injs[1].stats, k) for k in names]
    assert sum(got) > 0
    m, rm = Metrics(), RefMetrics()
    injs[0].export_metrics(m)
    injs[1].export_metrics(rm)
    assert m.gauges == rm.gauges


def test_wan_injector_fifo_and_stats():
    """``tests/test_traffic.py:216``: the WAN shape keeps a link's frames
    in stream order (the release clamp) and counts every shaped frame."""
    inj = FaultInjector(seed=5, default=wan_profile("wan"))
    inj.start()
    last = 0.0
    for k in range(200):
        plan = inj.on_send(0, 1, b"frame-%d" % k)
        assert len(plan) == 1 and plan[0][0] >= wan_profile("wan").latency_s
        rel = inj._wan_last[(0, 1)]
        assert rel >= last
        last = rel
    assert inj.stats.shaped == 200 and inj.stats.dropped == 0
    m = Metrics()
    inj.export_metrics(m)
    assert m.gauges["faults.shaped"] == 200


def test_wan_shape_composes_with_reorder_fault():
    """``tests/test_traffic.py:232``: the reorder fault rides on top of the
    WAN release clamp, so delay-faulted frames are overtaken."""
    lf = LinkFaults(latency_s=0.01, delay_p=0.3, delay_s=(0.5, 0.5))
    inj = FaultInjector(seed=7, default=lf)
    inj.start()
    rel = []
    t0 = time.monotonic()
    for k in range(50):
        plan = inj.on_send(0, 1, b"f%d" % k)
        rel.append((time.monotonic() - t0) + plan[0][0])
    assert inj.stats.delayed > 0 and inj.stats.shaped == 50
    assert any(rel[i] > rel[j] for i in range(len(rel)) for j in range(i + 1, len(rel)))


def test_fault_stats_reach_cluster_prometheus_dump():
    """``tests/test_traffic.py:202``: the injector's totals land in the
    cluster's Prometheus dump through ``merged_metrics``."""
    inj = FaultInjector(seed=1, default=LinkFaults(drop_p=1.0))
    assert inj.on_send(0, 1, b"abc") == []
    cluster = LocalCluster(4, seed=2, injector=inj)  # never started
    try:
        text = cluster.merged_metrics().prometheus_text()
    finally:
        cluster.stop()
    assert 'hbbft_gauge{name="faults.dropped"} 1' in text


def _batch_keys(c, nid, upto):
    return [(b.era, b.epoch, serde.dumps(b.contributions)) for b in c.batches(nid)[:upto]]


def _drive(c, ids, target, tag="drive", timeout_s=EPOCH_TIMEOUT_S):
    c.drive_to(ids, target, timeout_s=timeout_s, tag=tag)


@pytest.mark.parametrize("coalesce", [True, False])
@low_priority
def test_cluster_partition_heals_and_continues(coalesce):
    """``tests/test_transport.py`` of the same name, on the port's cluster:
    the majority commits through a partition that isolates node 3, and
    after heal the links carry frames again and committing continues."""
    inj = FaultInjector(seed=5)
    with LocalCluster(4, seed=13, injector=inj, transport_kwargs={"coalesce": coalesce}) as c:
        _drive(c, [0, 1, 2, 3], 2)
        inj.add_partition(PartitionSpec((frozenset([0, 1, 2]), frozenset([3])),
                                        start_s=inj.elapsed()))
        base = len(c.batches(0))
        _drive(c, [0, 1, 2], base + 2, tag="part")
        assert inj.stats.partitioned > 0
        before = sum(c.nodes[i].transport.peer_stats[3].frames_out for i in [0, 1, 2])
        inj.heal_all()
        _drive(c, [0, 1, 2], len(c.batches(0)) + 2, tag="heal")
        after = sum(c.nodes[i].transport.peer_stats[3].frames_out for i in [0, 1, 2])
        assert after > before
        want = _batch_keys(c, 0, 4)
        for i in [1, 2]:
            assert _batch_keys(c, i, 4) == want


@low_priority
def test_random_link_corruption_cluster_survives():
    """``tests/test_transport.py`` of the same name, on the port's cluster:
    corruption, duplication and delay on every link out of node 3 are
    detected (frame errors or bad payloads) and survived."""
    flaky = LinkFaults(corrupt_p=0.05, dup_p=0.1, delay_p=0.2)
    inj = FaultInjector(seed=3, links={(3, 0): flaky, (3, 1): flaky, (3, 2): flaky})
    with LocalCluster(4, seed=33, injector=inj) as c:
        _drive(c, [0, 1, 2], 3, timeout_s=60)
        want = _batch_keys(c, 0, 3)
        for i in [1, 2]:
            assert _batch_keys(c, i, 3) == want
        m = c.merged_metrics()
        assert inj.stats.corrupted > 0
        detected = (m.counters.get("transport.frame_errors", 0)
                    + m.counters.get("cluster.bad_payload", 0))
        assert detected > 0
        assert m.counters.get("cluster.handler_errors", 0) == 0
