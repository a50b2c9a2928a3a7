"""The port's trace exporter and analyzer (``hbbft_tpu_torch.obs.export``,
``.analyze``) give the reference's output on the same events.

The events are a fixed, seeded list: four node tracks of three epochs
(the last one left open on some nodes, so the stall diagnosis has work),
with RBC, BA (coins, extra rounds) and decryption milestones, transport
link events, a cluster track and a ``cryptoplane`` track of flush spans;
plus the repo's two golden traces (``tests/fixtures``).  Each function's
output is compared as JSON text, so a float that differs in its last bit
fails.
"""

from __future__ import annotations

import json
import os
import random

import pytest

from hbbft_tpu.obs import analyze as ref_analyze
from hbbft_tpu.obs import export as ref_export
from hbbft_tpu.obs.trace import TraceEvent as RefEvent
from hbbft_tpu_torch.obs import analyze, export
from hbbft_tpu_torch.obs.trace import TraceEvent

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _events(seed: int, n: int = 4, epochs: int = 3):
    """(track, ts, name, args) tuples, in each track's emit order."""
    rng = random.Random(seed)
    out = []
    t0 = 1_700_000_000.0 + seed
    for node in range(n):
        track = f"node{node}"
        t = t0 + rng.random() * 0.01
        stuck = node >= n - 2  # the last epoch never commits on two nodes

        def ev(name, **args):
            nonlocal t
            t += rng.random() * 0.02
            out.append((track, t, name, args))

        ev("transport.connect", peer=(node + 1) % n)
        for epoch in range(epochs):
            ev("epoch.open", era=0, epoch=epoch)
            for p in range(n):
                ev("rbc.value", proposer=p)
                ev("rbc.ready", proposer=p)
                if not (stuck and epoch == epochs - 1 and p == 1):
                    ev("rbc.deliver", proposer=p)
            for p in range(n):
                if stuck and epoch == epochs - 1 and p == 1:
                    continue
                ev("ba.input", proposer=p, round=0, value=1)
                rounds = rng.choice((0, 0, 1, 2))
                for r in range(rounds + 1):
                    if r:
                        ev("ba.round", proposer=p, round=r)
                    ev("ba.coin", proposer=p, round=r, value=r % 2)
                ev("ba.decide", proposer=p, round=rounds, value=1)
            if stuck and epoch == epochs - 1:
                ev("transport.disconnect", peer=1)
                continue
            for p in range(n - 1):
                ev("decrypt.start", proposer=p)
                ev("decrypt.done", proposer=p)
            ev("epoch.commit", contribs=n - 1, txns=2 * (n - 1))
    t = t0
    for k in range(12):
        t += rng.random() * 0.05
        args = dict(requests=rng.randrange(1, 40), backend="rpc", span=f"node{k % n}:{k}")
        out.append(("cryptoplane", t, "crypto.flush.open", dict(args)))
        out.append(("cryptoplane", t + rng.random() * 0.01, "crypto.flush.done",
                    dict(args, ok=True)))
    out.append(("cluster", t0 + 0.2, "chaos.partition", {"nodes": [3]}))
    return out


def _tracks(cls, rows):
    tracks = {}
    for track, ts, name, args in rows:
        tracks.setdefault(track, []).append(cls(ts, name, dict(args)))
    return tracks


def _golden(impl):
    with open(os.path.join(FIXDIR, f"golden_trace_{impl}.json")) as fh:
        doc = json.load(fh)
    return [(t, ts, name, args) for t, evs in doc["tracks"].items() for ts, name, args in evs]


CASES = {
    "seed0": lambda: _events(0),
    "seed1": lambda: _events(1),
    "seed7-n7": lambda: _events(7, n=7, epochs=2),
    "golden-python": lambda: _golden("python"),
    "golden-native": lambda: _golden("native"),
}


def _text(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=repr)


def _newest(rows) -> float:
    return max(ts for _, ts, _, _ in rows)


@pytest.mark.parametrize("case", sorted(CASES))
def test_exporter_output_is_the_reference(case):
    rows = CASES[case]()
    ours, theirs = _tracks(TraceEvent, rows), _tracks(RefEvent, rows)
    pids = {f"node{i}": i for i in range(8)}
    a = export.chrome_trace(ours, pids=pids)
    b = ref_export.chrome_trace(theirs, pids=pids)
    assert _text(a) == _text(b)
    assert _text(export.chrome_trace(ours)) == _text(ref_export.chrome_trace(theirs))
    assert _text(export.merge_chrome_traces([a, a])) == _text(
        ref_export.merge_chrome_traces([b, b]))
    assert _text(export.phase_spans(ours)) == _text(ref_export.phase_spans(theirs))
    assert _text(export.phase_summaries(ours)) == _text(ref_export.phase_summaries(theirs))
    values = [ts for _, ts, _, _ in rows][:50]
    assert _text(export.summarize(values)) == _text(ref_export.summarize(values))
    assert export.summarize([]) is None and ref_export.summarize([]) is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_analyzer_output_is_the_reference(case):
    rows = CASES[case]()
    ours, theirs = _tracks(TraceEvent, rows), _tracks(RefEvent, rows)
    paths = analyze.critical_path(ours)
    assert _text(paths) == _text(ref_analyze.critical_path(theirs))
    assert _text(analyze.summarize_critical_paths(paths)) == _text(
        ref_analyze.summarize_critical_paths(ref_analyze.critical_path(theirs)))
    assert _text(analyze.derived_summaries(ours)) == _text(
        ref_analyze.derived_summaries(theirs))
    assert analyze.ba_rounds_to_decide(ours) == ref_analyze.ba_rounds_to_decide(theirs)
    now = _newest(rows) + 6.0
    for n in (None, 4):
        d = analyze.diagnose(ours, n=n, now=now, stall_after_s=5.0)
        assert _text(d) == _text(ref_analyze.diagnose(theirs, n=n, now=now, stall_after_s=5.0))
    diags = [analyze.diagnose(ours, now=now), analyze.diagnose(ours, now=now + 10)]
    assert _text(analyze.merge_diags(diags)) == _text(ref_analyze.merge_diags(
        [ref_analyze.diagnose(theirs, now=now), ref_analyze.diagnose(theirs, now=now + 10)]))
    doc = json.loads(json.dumps(export.chrome_trace(ours)))
    back = analyze.tracks_from_chrome(doc)
    assert _text(back) == _text(ref_analyze.tracks_from_chrome(doc))


def test_seeded_tracks_exercise_the_diagnosis():
    """The seeded case stalls on purpose: the diagnosis sees it, and every
    epoch that some node committed has a critical path."""
    rows = _events(0)
    tracks = _tracks(TraceEvent, rows)
    d = analyze.diagnose(tracks, n=4, now=_newest(rows) + 6.0)
    assert d["stalled"] is True
    assert [rec["epoch"] for rec in analyze.critical_path(tracks)] == [0, 1, 2]
    assert "phase.epoch" in analyze.derived_summaries(tracks)
