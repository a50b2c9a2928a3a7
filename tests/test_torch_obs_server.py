"""The port's scrape server (``hbbft_tpu_torch.obs.server``) and chaos
events on the cluster's trace track, against ``tests/test_obs.py:309,352``.

* A live scrape of a port cluster mid-run: ``/healthz`` before and after
  progress, a ``/metrics`` exposition whose every line parses and that
  carries the epoch and phase summaries, a ``/trace.json`` with one
  process per node, ``/diag``, a 404, and ``stop()`` closing the server.
  The same scrape of the reference's cluster gives the same structure.
* ``ChaosRunner`` fires its events on a stub cluster and on a live port
  cluster, each on the ``cluster`` trace track; ``/healthz`` reports a
  crash-stopped Byzantine node as the schedule, not an outage.

Tolerance: exact on structure (keys, names, status codes); the values
of a live run differ from run to run.
"""

from __future__ import annotations

import importlib
import json
import re
import urllib.error
import urllib.request

import pytest
from torch_low_priority import low_priority

from hbbft_tpu_torch.chaos import ChaosEvent, ChaosRunner
from hbbft_tpu_torch.obs.trace import TraceBuffer
from hbbft_tpu_torch.transport import LocalCluster

EPOCH_TIMEOUT_S = 45  # wall cap per driven phase; typical is < 2 s

# The Prometheus text-format grammar of ``tests/test_obs.py``.
_COMMENT_RE = re.compile(
    r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* \S.*$"
)
_SAMPLE_RE = re.compile(
    r"^(?P<metric>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*")*\})?'
    r" (-?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?|[+-]?Inf|NaN)$"
)


def _get(url: str) -> bytes:
    return urllib.request.urlopen(url, timeout=10).read()


def _scrape(pkg: str) -> dict:
    """``tests/test_obs.py:352``'s live scrape on ``pkg``'s cluster; returns
    what it saw as plain data."""
    cluster = importlib.import_module(f"{pkg}.transport.cluster")
    c = cluster.LocalCluster(4, seed=0)
    with c:
        base = f"http://127.0.0.1:{c.serve_obs().port}"
        health0 = json.loads(_get(base + "/healthz"))
        c.drive_to(range(4), 2, timeout_s=EPOCH_TIMEOUT_S, tag="obs")
        text = _get(base + "/metrics").decode()
        bad = [line for line in text.splitlines()
               if not (_COMMENT_RE.match(line) if line.startswith("#")
                       else _SAMPLE_RE.match(line))]
        health = json.loads(_get(base + "/healthz"))
        doc = json.loads(_get(base + "/trace.json"))
        diag = json.loads(_get(base + "/diag?stall_s=60"))
        with pytest.raises(urllib.error.HTTPError) as missing:
            _get(base + "/nope")
    try:
        _get(base + "/healthz")
        closed = False
    except OSError:
        closed = True
    return dict(
        health0=(health0["ok"], sorted(health0["nodes"]), health0["n"]),
        unparsed=bad,
        epoch_latency='hbbft_summary{name="epoch.latency"' in text,
        phase_ba='name="phase.ba"' in text,
        health=(health["ok"], all(v["alive"] for v in health["nodes"].values()),
                health["nodes"]["0"]["last_committed"] is not None,
                sorted(health["nodes"]["0"])),
        pids=sorted(e["args"]["name"] for e in doc["traceEvents"]
                    if e["name"] == "process_name" and e["args"]["name"].startswith("node")),
        keys=all(k in ev for ev in doc["traceEvents"] for k in ("ts", "pid", "tid", "ph", "name")),
        diag_stalled=diag.get("stalled"),
        missing=missing.value.code,
        closed=closed,
    )


@low_priority
def test_live_scrape_matches_reference():
    port = _scrape("hbbft_tpu_torch")
    assert port == _scrape("hbbft_tpu")
    assert port["health0"] == (True, ["0", "1", "2", "3"], 4)
    assert port["unparsed"] == [] and port["epoch_latency"] and port["phase_ba"]
    assert port["health"][:3] == (True, True, True)
    assert port["pids"] == ["node0", "node1", "node2", "node3"] and port["keys"]
    assert port["diag_stalled"] is False and port["missing"] == 404 and port["closed"]


def test_chaos_runner_emits_cluster_track_events():
    """``tests/test_obs.py:309``: a stub cluster's ``trace`` gets one
    ``chaos.<kind>`` event per fired event, in order, naming the node."""

    class StubCluster:
        def __init__(self):
            self.trace = TraceBuffer("cluster", capacity=64)
            self.calls = []

        def kill(self, n):
            self.calls.append(("kill", n))

        def restart(self, n):
            self.calls.append(("restart", n))

    c = StubCluster()
    runner = ChaosRunner(c, [ChaosEvent(0.0, "kill", 3), ChaosEvent(0.0, "restart", 3)])
    runner.start()
    runner.drain()
    assert c.calls == [("kill", 3), ("restart", 3)]
    assert [e.name for e in c.trace.snapshot()] == ["chaos.kill", "chaos.restart"]
    assert c.trace.snapshot()[0].args["node"] == 3
    with pytest.raises(ValueError, match="no FaultInjector"):
        ChaosRunner(c, [ChaosEvent(0.0, "partition", 3)])


@low_priority
def test_chaos_events_on_a_live_cluster_track():
    """A kill/restart of a crash-stop node on a live port cluster lands on
    its ``cluster`` track and in the merged Chrome trace; ``/healthz``
    stays ok while the Byzantine node is dead."""
    c = LocalCluster(4, seed=7, byzantine={3: "crash-stop"})
    runner = ChaosRunner(c, [ChaosEvent(0.0, "kill", 3), ChaosEvent(0.5, "restart", 3)])
    with c:
        base = f"http://127.0.0.1:{c.serve_obs().port}"
        c.drive_to(range(4), 1, timeout_s=EPOCH_TIMEOUT_S)
        runner.start()
        runner.pump()
        health = json.loads(_get(base + "/healthz"))
        assert health["ok"] and health["nodes"]["3"] == dict(
            health["nodes"]["3"], alive=False, byzantine=True)
        c.drive_to([0, 1, 2], c.batch_count(0) + 1, timeout_s=EPOCH_TIMEOUT_S,
                   tick=runner.pump)
        runner.drain()
        doc = json.loads(_get(base + "/trace.json"))
    names = [(e.name, e.args["node"]) for e in c.trace.snapshot()]
    assert names == [("chaos.kill", 3), ("chaos.restart", 3)]
    assert {"chaos.kill", "chaos.restart"} <= {e["name"] for e in doc["traceEvents"]}
