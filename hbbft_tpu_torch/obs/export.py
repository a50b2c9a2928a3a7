"""Trace merging + export: Chrome trace-event JSON and phase latency.

The merger aligns per-node rings on the shared wall clock (every event
is stamped with ``time.time()`` / ``CLOCK_REALTIME`` at emit — nothing
here re-times anything) and derives **per-epoch phase spans** from the
milestone taxonomy:

* ``epoch``   — ``epoch.open`` → ``epoch.commit``
* ``rbc``     — ``epoch.open`` → last ``rbc.deliver`` (value dispersal
  and Bracha agreement for every accepted proposer)
* ``ba``      — first ``ba.*`` milestone → last ``ba.decide``
* ``coin``    — first ``ba.coin`` → last ``ba.coin`` (the threshold-
  crypto rounds inside BA, separated out because the decrypt-after-
  order latency price — PAPERS.md arxiv 2407.12172 — is exactly the
  coin+decrypt share of the epoch)
* ``decrypt`` — first ``decrypt.start`` → last ``decrypt.done``

Events from the native arm carry explicit ``era``/``epoch`` args (the
engine knows them); Python-arm leaf milestones without them are
BRACKETED — assigned to the track's currently-open epoch, which is
sound because :class:`~hbbft_tpu_torch.protocols.honey_badger.HoneyBadger`
only ever processes messages for its current epoch (future epochs are
buffered, stale ones dropped).

The Chrome output loads in Perfetto / ``chrome://tracing``: one
process (pid) per track, spans on per-phase thread lanes, milestones
as instant events on lane 0.  Timestamps are microseconds relative to
the earliest event (the absolute epoch is in the ``otherData`` block).

Copy of ``hbbft_tpu/obs/export.py``; its output is the reference's, byte
for byte (tests/test_torch_obs_export.py).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

from hbbft_tpu_torch.obs.trace import TraceEvent

#: Span lanes (Chrome "tid") per track; lane 0 carries instant events.
_LANES = {"epoch": 1, "rbc": 2, "ba": 3, "coin": 4, "decrypt": 5}

#: Default quantiles for phase/epoch latency summaries.
QUANTILES = (0.5, 0.9, 0.99)


def summarize(
    values: Iterable[float], qs: Tuple[float, ...] = QUANTILES
) -> Optional[Tuple[Dict[float, float], int, float]]:
    """(quantiles, count, total) of ``values`` by sorting — the
    producer-side estimator for :meth:`Metrics.summary` when the
    population is bounded (epochs, phase spans), where exact beats
    streaming.  None for an empty population."""
    vs = sorted(values)
    if not vs:
        return None
    n = len(vs)
    quant = {q: vs[min(n - 1, int(q * n))] for q in qs}
    return quant, n, sum(vs)


class _EpochAcc:
    __slots__ = ("open", "commit", "rbc_last", "ba_first", "ba_last",
                 "coin_first", "coin_last", "dec_first", "dec_last")

    def __init__(self) -> None:
        self.open = self.commit = None
        self.rbc_last = None
        self.ba_first = self.ba_last = None
        self.coin_first = self.coin_last = None
        self.dec_first = self.dec_last = None


def phase_spans(
    tracks: Dict[str, List[TraceEvent]]
) -> List[Dict[str, Any]]:
    """Derive per-epoch phase spans from each track's event stream.

    Returns dicts ``{track, era, epoch, phase, t0, t1}`` (wall seconds);
    a span appears only when both endpoints were observed.
    """
    spans: List[Dict[str, Any]] = []
    for track, events in tracks.items():
        acc: Dict[Tuple[int, int], _EpochAcc] = {}
        cur: Optional[Tuple[int, int]] = None

        def key_for(ev: TraceEvent) -> Optional[Tuple[int, int]]:
            if "epoch" in ev.args:
                return (int(ev.args.get("era", 0)), int(ev.args["epoch"]))
            return cur

        for ev in events:
            name = ev.name
            if name == "epoch.open":
                k = key_for(ev)
                if k is None:
                    continue
                cur = k
                acc.setdefault(k, _EpochAcc()).open = ev.ts
                continue
            k = key_for(ev)
            if k is None:
                continue  # unbracketed leaf milestone (ring overflow)
            a = acc.setdefault(k, _EpochAcc())
            if name == "epoch.commit":
                a.commit = ev.ts
            elif name == "rbc.deliver":
                a.rbc_last = ev.ts
            elif name.startswith("ba."):
                if a.ba_first is None:
                    a.ba_first = ev.ts
                if name == "ba.decide":
                    a.ba_last = ev.ts
                if name == "ba.coin":
                    if a.coin_first is None:
                        a.coin_first = ev.ts
                    a.coin_last = ev.ts
            elif name == "decrypt.start":
                if a.dec_first is None:
                    a.dec_first = ev.ts
            elif name == "decrypt.done":
                # only a real combine closes the span — fabricating the
                # end from decrypt.start would emit 0 s decrypt spans
                # for killed/overflowed epochs and drag phase.decrypt
                # quantiles down
                a.dec_last = ev.ts

        for (era, epoch), a in sorted(acc.items()):
            def put(phase: str, t0, t1) -> None:
                if t0 is not None and t1 is not None and t1 >= t0:
                    spans.append(
                        {
                            "track": track,
                            "era": era,
                            "epoch": epoch,
                            "phase": phase,
                            "t0": t0,
                            "t1": t1,
                        }
                    )

            put("epoch", a.open, a.commit)
            put("rbc", a.open, a.rbc_last)
            put("ba", a.ba_first, a.ba_last)
            put("coin", a.coin_first, a.coin_last)
            put("decrypt", a.dec_first, a.dec_last)
    return spans


def phase_summaries(
    tracks: Dict[str, List[TraceEvent]]
) -> Dict[str, Tuple[Dict[float, float], int, float]]:
    """Per-phase latency summaries across all tracks/epochs — the
    derived breakdown :meth:`LocalCluster.merged_metrics` publishes as
    ``phase.<name>`` (Prometheus summary triplets)."""
    durs: Dict[str, List[float]] = {}
    for sp in phase_spans(tracks):
        durs.setdefault(sp["phase"], []).append(sp["t1"] - sp["t0"])
    out = {}
    for phase, vals in durs.items():
        sm = summarize(vals)
        if sm is not None:
            out[phase] = sm
    return out


def chrome_trace(
    tracks: Dict[str, List[TraceEvent]],
    pids: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """Merge ``tracks`` into a Chrome trace-event JSON object.

    ``pids`` optionally pins track → pid (the cluster passes node ids);
    unpinned tracks get pids after the largest pinned one, in sorted
    track order.  Every emitted event carries the ``ts/pid/tid/ph/name``
    quintet (schema-pinned by tests/test_obs.py).
    """
    pids = dict(pids or {})
    next_pid = max(pids.values(), default=-1) + 1
    for track in sorted(tracks):
        if track not in pids:
            pids[track] = next_pid
            next_pid += 1

    all_ts = [ev.ts for evs in tracks.values() for ev in evs]
    t0 = min(all_ts) if all_ts else 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 1)

    events: List[Dict[str, Any]] = []
    for track in sorted(tracks):
        pid = pids[track]
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "ts": 0,
                "pid": pid,
                "tid": 0,
                "args": {"name": track},
            }
        )
        for lane_name, tid in [("milestones", 0)] + sorted(
            _LANES.items(), key=lambda kv: kv[1]
        ):
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "ts": 0,
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": lane_name},
                }
            )
        for ev in tracks[track]:
            events.append(
                {
                    "name": ev.name,
                    "ph": "i",
                    "s": "t",  # thread-scoped instant
                    "ts": us(ev.ts),
                    "pid": pid,
                    "tid": 0,
                    "cat": ev.name.split(".", 1)[0],
                    "args": ev.args,
                }
            )
    for sp in phase_spans(tracks):
        events.append(
            {
                "name": f"{sp['phase']} e{sp['era']}/{sp['epoch']}",
                "ph": "X",
                "ts": us(sp["t0"]),
                "dur": max(round((sp["t1"] - sp["t0"]) * 1e6, 1), 1),
                "pid": pids[sp["track"]],
                "tid": _LANES[sp["phase"]],
                "cat": "phase",
                "args": {"era": sp["era"], "epoch": sp["epoch"]},
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"t0_unix_s": t0, "source": "hbbft-tpu flight recorder"},
    }


def write_chrome_trace(
    path: str,
    tracks: Dict[str, List[TraceEvent]],
    pids: Optional[Dict[str, int]] = None,
) -> str:
    with open(path, "w") as fh:
        json.dump(chrome_trace(tracks, pids), fh)
    return path


def merge_chrome_traces(parts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge already-rendered Chrome traces from SEPARATE processes
    into one (the process-per-node cluster: each worker dumps its own
    node's trace; the parent merges).

    Every per-process trace's timestamps are relative to its OWN
    earliest event, but :func:`chrome_trace` records that absolute
    anchor in ``otherData.t0_unix_s`` — since every event was stamped
    with ``time.time()`` at emit, realigning each part by
    ``(t0_part - t0_min)`` puts all processes on the shared wall clock
    without re-timing anything.  Metadata records (``ph == "M"``,
    always ts 0) are not shifted.  Pid collisions across parts are
    remapped (workers pin pid = node id, so collisions only appear if
    two parts carry the same node — e.g. a restart's second trace).
    """
    anchored = []
    for p in parts:
        if not isinstance(p, dict):
            continue
        evs = p.get("traceEvents") or []
        t0 = float((p.get("otherData") or {}).get("t0_unix_s", 0.0))
        anchored.append((evs, t0, any(ev.get("ph") != "M" for ev in evs)))
    real_t0s = [t0 for _, t0, has_data in anchored if has_data]
    t0_min = min(real_t0s) if real_t0s else 0.0
    merged: List[Dict[str, Any]] = []
    used: set = set()
    for evs, t0, has_data in anchored:
        pids = sorted({int(ev.get("pid", 0)) for ev in evs})
        remap: Dict[int, int] = {}
        for pid in pids:
            new = pid
            while new in used:
                new = max(used) + 1
            remap[pid] = new
            used.add(new)
        shift_us = (t0 - t0_min) * 1e6 if has_data else 0.0
        for ev in evs:
            ev = dict(ev)
            ev["pid"] = remap.get(int(ev.get("pid", 0)), ev.get("pid", 0))
            if ev.get("ph") != "M":
                ev["ts"] = round(float(ev.get("ts", 0.0)) + shift_us, 1)
            merged.append(ev)
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "t0_unix_s": t0_min,
            "source": "hbbft-tpu flight recorder (process merge)",
        },
    }
