"""Consensus critical-path analyzer + stall diagnostician (round 16).

The flight recorder (round 12) made "which phase ate the time" a
queryable artifact; this module is the query.  It consumes the merged
recorder rings — the same ``Dict[track, List[TraceEvent]]`` shape
:meth:`LocalCluster.trace_events` snapshots and
:func:`tracks_from_chrome` recovers from a dumped ``trace.json`` — and
answers the two questions the raw Chrome trace only answers to a human:

* **post-mortem** — per committed epoch, the *critical path* to commit:
  the cluster-wide chain of last milestones (``epoch.open`` →
  ``rbc.value`` → ``rbc.ready`` → ``rbc.deliver`` → ``ba.input`` →
  ``ba.round``/``ba.coin`` → ``ba.decide`` → ``decrypt.start`` →
  ``decrypt.done`` → ``epoch.commit``), with straggler attribution
  (which node's which phase was last), cross-node skew, BA
  rounds-to-decide histograms, and crypto-plane flush latency folded in
  from the ``cryptoplane`` track (the decrypt-after-order latency price
  of PAPERS.md arxiv 2407.12172, measured per epoch);
* **live** — :func:`diagnose`: when commit rate goes quiescent, *why* —
  which proposer's RBC is incomplete, which BA instance is stuck at
  which round, which peers are disconnected or banned.  The ``/diag``
  scrape endpoint and the ``tools/analyze.py`` CLI run THIS code over
  live rings and dumped traces respectively, so live and post-mortem
  diagnosis can never disagree.

Epoch attribution follows the exporter's bracketing rule
(obs/export.py): events carrying explicit ``era``/``epoch`` args (the
native arm) are keyed directly; Python-arm leaf milestones are assigned
to the track's currently-open epoch, which is sound because HoneyBadger
only processes current-epoch messages.

Determinism: every max/argmax here breaks timestamp ties by
``(ts, track, proposer)``, so two analyses of the same event streams —
and two same-seed sim-net runs, whose event ORDER is deterministic —
produce structurally identical paths (pinned by tests/test_analyze.py
against golden fixtures from both sim-net impls).

Copy of ``hbbft_tpu/obs/analyze.py``; its output is the reference's
(tests/test_torch_obs_export.py).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

from hbbft_tpu_torch.obs.export import phase_summaries, summarize
from hbbft_tpu_torch.obs.trace import TraceEvent

#: Milestone chain to commit, in protocol order.  ``ba.round`` /
#: ``ba.coin`` sit between input and decide (a BA instance may decide
#: in round 0 without either).
STAGES = (
    "epoch.open",
    "rbc.value",
    "rbc.ready",
    "rbc.deliver",
    "ba.input",
    "ba.round",
    "ba.coin",
    "ba.decide",
    "decrypt.start",
    "decrypt.done",
    "epoch.commit",
)

#: Stage -> coarse phase for share-of-wall aggregation and diagnosis.
STAGE_PHASE = {
    "epoch.open": "open",
    "rbc.value": "rbc",
    "rbc.ready": "rbc",
    "rbc.deliver": "rbc",
    "ba.input": "ba",
    "ba.round": "ba",
    "ba.coin": "coin",
    "ba.decide": "ba",
    "decrypt.start": "decrypt",
    "decrypt.done": "decrypt",
    "epoch.commit": "commit",
}

_STAGE_SET = frozenset(STAGES)
_NODE_TRACK_RE = re.compile(r"^node(\d+)$")


def node_tracks(tracks: Dict[str, List[TraceEvent]]) -> Dict[str, List[TraceEvent]]:
    """The per-node tracks (``node<i>``), dropping the cluster /
    cryptoplane side-tracks whose events are not epoch milestones."""
    return {t: evs for t, evs in tracks.items() if _NODE_TRACK_RE.match(t)}


def _sort_key(track: str) -> Tuple[int, str]:
    m = _NODE_TRACK_RE.match(track)
    return (int(m.group(1)), track) if m else (1 << 30, track)


def epoch_events(
    tracks: Dict[str, List[TraceEvent]]
) -> Dict[Tuple[int, int], Dict[str, List[TraceEvent]]]:
    """Group each node track's milestone events by ``(era, epoch)``
    using the exporter's bracketing rule.  Non-milestone events
    (transport/chaos/crypto) are not epoch-scoped and are skipped."""
    out: Dict[Tuple[int, int], Dict[str, List[TraceEvent]]] = {}
    for track in sorted(node_tracks(tracks), key=_sort_key):
        cur: Optional[Tuple[int, int]] = None
        for ev in tracks[track]:
            if ev.name not in _STAGE_SET:
                continue
            if "epoch" in ev.args:
                key: Optional[Tuple[int, int]] = (
                    int(ev.args.get("era", 0)),
                    int(ev.args["epoch"]),
                )
            else:
                key = cur
            if ev.name == "epoch.open":
                cur = key
            if key is None:
                continue  # unbracketed leaf (ring overflow ate the open)
            out.setdefault(key, {}).setdefault(track, []).append(ev)
    return out


def _last(
    events: Iterable[Tuple[str, TraceEvent]], limit: Optional[float] = None
) -> Optional[Tuple[str, TraceEvent]]:
    """The (track, event) with the largest timestamp, ties broken by
    (track, proposer) so the choice is stable across analyses."""
    best: Optional[Tuple[str, TraceEvent]] = None
    best_key: Optional[Tuple[float, Tuple[int, str], int]] = None
    for track, ev in events:
        if limit is not None and ev.ts > limit:
            continue
        key = (ev.ts, _sort_key(track), int(ev.args.get("proposer", -1)))
        if best_key is None or key > best_key:
            best, best_key = (track, ev), key
    return best


def critical_path(
    tracks: Dict[str, List[TraceEvent]]
) -> List[Dict[str, Any]]:
    """Per committed epoch, the cluster-wide critical path to commit.

    An epoch qualifies when at least one track observed BOTH its
    ``epoch.open`` and its ``epoch.commit``.  Per stage the path takes
    the LAST matching milestone across all node tracks at or before the
    epoch's commit wall; clamping to a running maximum guarantees the
    reported chain is monotone even if cross-track clock jitter
    reorders raw stamps.  Returns one dict per epoch, sorted::

        {era, epoch, t_open, t_commit, wall_s, open_skew_s,
         commit_skew_s, path: [{stage, phase, t, dt_s, node, proposer,
         round?}...], straggler: {stage, phase, node, proposer, dt_s},
         ba_rounds: {rounds_to_decide: count}, coins: int,
         flush: {flushes, total_s, max_s} | None}
    """
    by_epoch = epoch_events(tracks)
    flushes = _flush_spans(tracks)
    out: List[Dict[str, Any]] = []
    for key in sorted(by_epoch):
        per_track = by_epoch[key]
        opens = {
            t: [e for e in evs if e.name == "epoch.open"]
            for t, evs in per_track.items()
        }
        commits = {
            t: [e for e in evs if e.name == "epoch.commit"]
            for t, evs in per_track.items()
        }
        open_ts = [e.ts for es in opens.values() for e in es]
        commit_ts = [e.ts for es in commits.values() for e in es]
        if not commit_ts or not any(
            opens[t] and commits[t] for t in per_track
        ):
            continue  # in-flight or truncated epoch: no commit wall
        t_open = min(open_ts)
        t_commit = max(commit_ts)

        path: List[Dict[str, Any]] = []
        prev_t = t_open
        for stage in STAGES:
            cand = (
                (t, e)
                for t, evs in per_track.items()
                for e in evs
                if e.name == stage
            )
            hit = _last(cand, limit=t_commit)
            if hit is None:
                continue  # stage absent (e.g. unencrypted epoch)
            track, ev = hit
            t = max(ev.ts, prev_t)  # monotone by construction
            entry: Dict[str, Any] = {
                "stage": stage,
                "phase": STAGE_PHASE[stage],
                "t": t,
                "dt_s": t - prev_t,
                "node": track,
            }
            if "proposer" in ev.args:
                entry["proposer"] = ev.args["proposer"]
            if "round" in ev.args:
                entry["round"] = ev.args["round"]
            path.append(entry)
            prev_t = t

        stragglers = [p for p in path if p["stage"] != "epoch.open"]
        straggler = (
            max(stragglers, key=lambda p: p["dt_s"]) if stragglers else None
        )
        rounds_hist: Dict[int, int] = {}
        coins = 0
        for t, evs in per_track.items():
            for e in evs:
                if e.name == "ba.decide":
                    r = int(e.args.get("round", 0)) + 1
                    rounds_hist[r] = rounds_hist.get(r, 0) + 1
                elif e.name == "ba.coin":
                    coins += 1
        epoch_flush = [
            (t0, t1) for t0, t1 in flushes if t_open <= t1 <= t_commit
        ]
        rec: Dict[str, Any] = {
            "era": key[0],
            "epoch": key[1],
            "t_open": t_open,
            "t_commit": t_commit,
            "wall_s": t_commit - t_open,
            "open_skew_s": (max(open_ts) - min(open_ts)) if open_ts else 0.0,
            "commit_skew_s": max(commit_ts) - min(commit_ts),
            "path": path,
            "straggler": (
                {
                    "stage": straggler["stage"],
                    "phase": straggler["phase"],
                    "node": straggler["node"],
                    "proposer": straggler.get("proposer"),
                    "dt_s": straggler["dt_s"],
                }
                if straggler is not None
                else None
            ),
            "ba_rounds": rounds_hist,
            "coins": coins,
            "flush": (
                {
                    "flushes": len(epoch_flush),
                    "total_s": sum(t1 - t0 for t0, t1 in epoch_flush),
                    "max_s": max((t1 - t0 for t0, t1 in epoch_flush)),
                }
                if epoch_flush
                else None
            ),
        }
        out.append(rec)
    return out


def _flush_spans(
    tracks: Dict[str, List[TraceEvent]]
) -> List[Tuple[float, float]]:
    """(t_open, t_done) per crypto-plane flush.

    Events carrying a ``span`` id pair by id: RPC-mode clients
    (proc_service.py) share one ``cryptoplane`` buffer and flush
    CONCURRENTLY, so their open/done events interleave.  Spanless
    events (the in-thread service flushes sequentially on its own
    worker) keep the emit-order pairing.  Spans are returned sorted by
    open time so the per-epoch window filter sees one timeline.
    """
    evs = tracks.get("cryptoplane") or []
    spans: List[Tuple[float, float]] = []
    open_t: Optional[float] = None
    open_by_span: Dict[Any, float] = {}
    for ev in evs:
        span = ev.args.get("span")
        if ev.name == "crypto.flush.open":
            if span is not None:
                open_by_span[span] = ev.ts
            else:
                open_t = ev.ts
        elif ev.name == "crypto.flush.done":
            if span is not None:
                t0 = open_by_span.pop(span, None)
                if t0 is not None:
                    spans.append((t0, ev.ts))
            elif open_t is not None:
                spans.append((open_t, ev.ts))
                open_t = None
    spans.sort()
    return spans


def path_structure(rec: Dict[str, Any]) -> List[Tuple[str, str, Any]]:
    """The timestamp-free shape of one epoch's critical path —
    ``(stage, node, proposer)`` triples — for rerun-identity checks."""
    return [
        (p["stage"], p["node"], p.get("proposer")) for p in rec["path"]
    ]


def summarize_critical_paths(
    records: List[Dict[str, Any]]
) -> Dict[str, Any]:
    """Aggregate per-epoch critical paths into the compact summary the
    benchmark JSON lines carry (``critical_path``): straggler
    histograms, phase share of wall, commit skew quantiles, BA
    rounds-to-decide histogram, crypto-plane flush totals."""
    out: Dict[str, Any] = {"epochs": len(records)}
    if not records:
        return out
    strag_nodes: Dict[str, int] = {}
    strag_phases: Dict[str, int] = {}
    share: Dict[str, float] = {}
    ba_rounds: Dict[int, int] = {}
    coins = 0
    fl_n = 0
    fl_total = 0.0
    for rec in records:
        s = rec.get("straggler")
        if s is not None:
            strag_nodes[s["node"]] = strag_nodes.get(s["node"], 0) + 1
            strag_phases[s["phase"]] = strag_phases.get(s["phase"], 0) + 1
        wall = rec["wall_s"] or 0.0
        if wall > 0:
            for p in rec["path"]:
                share[p["phase"]] = (
                    share.get(p["phase"], 0.0) + p["dt_s"] / wall
                )
        for r, c in rec["ba_rounds"].items():
            ba_rounds[int(r)] = ba_rounds.get(int(r), 0) + c
        coins += rec["coins"]
        fl = rec.get("flush")
        if fl:
            fl_n += fl["flushes"]
            fl_total += fl["total_s"]
    n = len(records)
    sm = summarize([r["commit_skew_s"] for r in records])
    out.update(
        {
            "wall_p50_s": round(
                summarize([r["wall_s"] for r in records])[0][0.5], 6
            ),
            "straggler_nodes": dict(sorted(strag_nodes.items())),
            "straggler_phases": dict(sorted(strag_phases.items())),
            "phase_share": {
                k: round(v / n, 4) for k, v in sorted(share.items())
            },
            "commit_skew_p50_s": round(sm[0][0.5], 6),
            "commit_skew_max_s": round(
                max(r["commit_skew_s"] for r in records), 6
            ),
            "ba_rounds": {
                str(k): v for k, v in sorted(ba_rounds.items())
            },
            "coins": coins,
        }
    )
    if fl_n:
        out["flush"] = {"flushes": fl_n, "total_s": round(fl_total, 6)}
    return out


# ---------------------------------------------------------------------------
# Derived metric summaries (merged_metrics): phase.* + ba.rounds
# ---------------------------------------------------------------------------


def ba_rounds_to_decide(tracks: Dict[str, List[TraceEvent]]) -> List[int]:
    """Rounds-to-decide (decide round + 1) of every BA decision across
    all node tracks — the population behind the ``ba.rounds`` summary
    metric (one observation per (node, epoch, proposer) instance)."""
    return [
        int(ev.args.get("round", 0)) + 1
        for t, evs in node_tracks(tracks).items()
        for ev in evs
        if ev.name == "ba.decide"
    ]


def derived_summaries(
    tracks: Dict[str, List[TraceEvent]]
) -> Dict[str, Tuple[Dict[float, float], int, float]]:
    """Every ring-derived summary family merged_metrics publishes:
    ``phase.<name>`` (the round-12 per-epoch phase-latency breakdown)
    plus ``ba.rounds`` (rounds-to-decide, round-16 satellite)."""
    out = {
        f"phase.{name}": sm
        for name, sm in phase_summaries(tracks).items()
    }
    sm = summarize([float(r) for r in ba_rounds_to_decide(tracks)])
    if sm is not None:
        out["ba.rounds"] = sm
    return out


# ---------------------------------------------------------------------------
# Live stall diagnosis
# ---------------------------------------------------------------------------

#: Diagnosis phase order: earlier = further from commit (a proposer
#: stuck in rbc blocks more than one stuck in decrypt).
_DIAG_PHASES = ("rbc", "ba", "decrypt")


def _instance_status(
    evs: List[TraceEvent], proposer: int
) -> Optional[Dict[str, Any]]:
    """Status of one (epoch, proposer) consensus instance on one node's
    timeline; None when the instance completed (decided + any started
    decrypt finished)."""
    value = ready = delivered = decided = False
    dec_start = dec_done = False
    last_ts: Optional[float] = None
    round_ = 0
    decide_value: Optional[int] = None
    for ev in evs:
        if ev.args.get("proposer") != proposer:
            continue
        last_ts = ev.ts
        name = ev.name
        if name == "rbc.value":
            value = True
        elif name == "rbc.ready":
            ready = True
        elif name == "rbc.deliver":
            delivered = True
        elif name in ("ba.input", "ba.round", "ba.coin"):
            round_ = max(round_, int(ev.args.get("round", 0)))
        elif name == "ba.decide":
            decided = True
            round_ = int(ev.args.get("round", round_))
            decide_value = ev.args.get("value")
        elif name == "decrypt.start":
            dec_start = True
        elif name == "decrypt.done":
            dec_done = True
    if decided and (not dec_start or dec_done):
        return None  # complete (or decided-out: no decrypt follows)
    if not delivered:
        phase, detail = "rbc", (
            "no value received" if not value else "echo/ready incomplete"
        )
    elif not decided:
        phase, detail = "ba", f"undecided at round {round_}"
    else:
        phase, detail = "decrypt", "combine pending"
    return {
        "proposer": proposer,
        "phase": phase,
        "round": round_ if phase == "ba" else None,
        "detail": detail,
        "value_seen": value,
        "ready_seen": ready,
        "delivered": delivered,
        "decided": decided,
        "decide_value": decide_value,
        "last_ts": last_ts,
    }


def _link_status(
    evs: List[TraceEvent], now: float
) -> Tuple[List[Any], List[Dict[str, Any]]]:
    """(disconnected_peers, active_bans) from a node track's transport
    milestones: a peer is disconnected when its last connect/disconnect
    event is a disconnect; a ban is active while now < ts + duration."""
    last: Dict[Any, str] = {}
    bans: List[Dict[str, Any]] = []
    for ev in evs:
        if ev.name == "transport.connect":
            last[ev.args.get("peer")] = "up"
        elif ev.name == "transport.disconnect":
            last[ev.args.get("peer")] = "down"
        elif ev.name == "transport.ban":
            if now < ev.ts + float(ev.args.get("duration_s", 0.0)):
                bans.append(
                    {
                        "peer": ev.args.get("peer"),
                        "offense": ev.args.get("offense"),
                    }
                )
    down = sorted(
        (p for p, st in last.items() if st == "down"),
        key=lambda p: str(p),
    )
    return down, bans


def _verdict(
    stuck: List[Dict[str, Any]],
    links: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Optional[Dict[str, Any]]:
    """The most-implicated cause, in evidence order.

    1. An ABSENT proposer — ``no value received`` on two or more nodes
       — outranks everything: a dead or partitioned proposer starves
       every downstream instance.  (One node reporting no-value only
       indicts the REPORTER's own link, so the threshold is 2.)
    2. A WIDELY-DOWN link — the same peer reported disconnected by two
       or more tracks — is named when no proposer is absent: a
       post-RBC quorum loss stalls every BA instance EQUALLY, and
       counting alone would blame an arbitrary well-behaved proposer
       while the link data holds the real cause.
    3. Otherwise: the instance stuck on the most nodes, ties toward
       the earlier phase then the lower proposer."""
    counts: Dict[Tuple[Any, str], int] = {}
    rounds: Dict[Tuple[Any, str], int] = {}
    absent: Dict[Any, int] = {}
    for s in stuck:
        k = (s["proposer"], s["phase"])
        counts[k] = counts.get(k, 0) + 1
        if s.get("round") is not None:
            rounds[k] = max(rounds.get(k, 0), s["round"])
        if s.get("detail") == "no value received":
            absent[s["proposer"]] = absent.get(s["proposer"], 0) + 1
    if not counts:
        return None
    wide_absent = {p: n for p, n in absent.items() if n >= 2}
    if wide_absent:
        proposer, n = min(
            wide_absent.items(), key=lambda kv: (-kv[1], str(kv[0]))
        )
        return {
            "proposer": proposer,
            "phase": "rbc",
            "nodes": n,
            "absent": True,
        }
    down: Dict[Any, int] = {}
    for st in (links or {}).values():
        for peer in st.get("disconnected", ()):
            down[peer] = down.get(peer, 0) + 1
    wide_down = {p: n for p, n in down.items() if n >= 2}
    if wide_down:
        return {
            "phase": "link",
            "peers": sorted(wide_down, key=str),
            "nodes": max(wide_down.values()),
        }
    (proposer, phase), n = min(
        counts.items(),
        key=lambda kv: (
            -kv[1],
            _DIAG_PHASES.index(kv[0][1]),
            str(kv[0][0]),
        ),
    )
    v: Dict[str, Any] = {"proposer": proposer, "phase": phase, "nodes": n}
    if (proposer, phase) in rounds:
        v["round"] = rounds[(proposer, phase)]
    return v


def diagnose(
    tracks: Dict[str, List[TraceEvent]],
    n: Optional[int] = None,
    now: Optional[float] = None,
    stall_after_s: float = 5.0,
) -> Dict[str, Any]:
    """Answer "why did the cluster stop committing" from the rings.

    ``n`` is the consensus size (proposer universe); inferred from the
    node-track indices when omitted (a single-node worker view should
    pass its cluster's real n).  ``now`` defaults to wall clock; pass
    the capture time (e.g. the newest event stamp) for post-mortem use.
    """
    if now is None:
        import time

        now = time.time()
    ntracks = node_tracks(tracks)
    if n is None:
        n = max(
            (int(_NODE_TRACK_RE.match(t).group(1)) + 1 for t in ntracks),
            default=0,
        )
    by_epoch = epoch_events(tracks)
    commit_ts = [
        e.ts
        for per_track in by_epoch.values()
        for evs in per_track.values()
        for e in evs
        if e.name == "epoch.commit"
    ]
    last_commit = max(commit_ts) if commit_ts else None
    first_ts = min(
        (evs[0].ts for evs in ntracks.values() if evs), default=None
    )
    anchor = last_commit if last_commit is not None else first_ts
    since_s = (now - anchor) if anchor is not None else None
    stalled = since_s is not None and since_s > stall_after_s

    last_committed: Dict[Tuple[int, int], float] = {}
    for key, per_track in by_epoch.items():
        for evs in per_track.values():
            for e in evs:
                if e.name == "epoch.commit":
                    last_committed[key] = max(
                        last_committed.get(key, 0.0), e.ts
                    )

    open_epochs: Dict[str, List[int]] = {}
    stuck: List[Dict[str, Any]] = []
    for track in sorted(ntracks, key=_sort_key):
        opened = {
            key
            for key, per_track in by_epoch.items()
            if any(
                e.name == "epoch.open" for e in per_track.get(track, ())
            )
        }
        committed = {
            key
            for key, per_track in by_epoch.items()
            if any(
                e.name == "epoch.commit" for e in per_track.get(track, ())
            )
        }
        pending = opened - committed
        if not pending:
            continue
        key = max(pending)
        open_epochs[track] = [key[0], key[1]]
        evs = by_epoch[key].get(track, [])
        open_ts = min(
            (e.ts for e in evs if e.name == "epoch.open"), default=now
        )
        for proposer in range(n):
            st = _instance_status(evs, proposer)
            if st is None:
                continue
            st.update(
                {
                    "node": track,
                    "era": key[0],
                    "epoch": key[1],
                    "age_s": now - (st.pop("last_ts") or open_ts),
                }
            )
            stuck.append(st)

    links: Dict[str, Dict[str, Any]] = {}
    for track in sorted(ntracks, key=_sort_key):
        down, bans = _link_status(ntracks[track], now)
        if down or bans:
            links[track] = {"disconnected": down, "banned": bans}

    last_key = max(last_committed) if last_committed else None
    return {
        "stalled": stalled,
        "since_s": round(since_s, 3) if since_s is not None else None,
        "stall_after_s": stall_after_s,
        "last_commit": list(last_key) if last_key is not None else None,
        "open_epochs": open_epochs,
        "stuck": stuck,
        "links": links,
        "verdict": _verdict(stuck, links) if stalled else None,
    }


def merge_diags(
    diags: List[Dict[str, Any]], stall_after_s: Optional[float] = None
) -> Dict[str, Any]:
    """Fold per-worker ``/diag`` payloads (one node track each — the
    process-per-node runtime) into one cluster-level diagnosis, using
    the SAME verdict rule as :func:`diagnose`.  The cluster is stalled
    when every reporting worker is (commits land on all survivors or
    none — HB has no partial commit)."""
    diags = [d for d in diags if d]
    if not diags:
        return {"stalled": False, "since_s": None, "workers": 0}
    stalled = all(d.get("stalled") for d in diags)
    stuck = [s for d in diags for s in d.get("stuck", ())]
    links: Dict[str, Any] = {}
    for d in diags:
        links.update(d.get("links", {}))
    open_epochs: Dict[str, Any] = {}
    for d in diags:
        open_epochs.update(d.get("open_epochs", {}))
    since = [d["since_s"] for d in diags if d.get("since_s") is not None]
    commits = [
        tuple(d["last_commit"])
        for d in diags
        if d.get("last_commit") is not None
    ]
    return {
        "stalled": stalled,
        "since_s": min(since) if since else None,
        "stall_after_s": (
            stall_after_s
            if stall_after_s is not None
            else max((d.get("stall_after_s", 0.0) for d in diags))
        ),
        "last_commit": list(max(commits)) if commits else None,
        "open_epochs": open_epochs,
        "stuck": stuck,
        "links": links,
        "workers": len(diags),
        "verdict": _verdict(stuck, links) if stalled else None,
    }


# ---------------------------------------------------------------------------
# Chrome-trace round trip (post-mortem CLI)
# ---------------------------------------------------------------------------


def tracks_from_chrome(doc: Dict[str, Any]) -> Dict[str, List[TraceEvent]]:
    """Recover recorder tracks from a dumped ``trace.json`` (the exact
    inverse of :func:`~hbbft_tpu_torch.obs.export.chrome_trace` for instant
    events; derived span events are re-derivable, so they are ignored).
    Timestamps return to absolute wall seconds via the
    ``otherData.t0_unix_s`` anchor, so a post-mortem analysis of a dump
    and a live analysis of the same rings see identical numbers."""
    t0 = float((doc.get("otherData") or {}).get("t0_unix_s", 0.0))
    names: Dict[int, str] = {}
    for ev in doc.get("traceEvents", ()):  # metadata pass first: a part
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            names[int(ev.get("pid", 0))] = ev["args"]["name"]
    tracks: Dict[str, List[TraceEvent]] = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "i":
            continue
        pid = int(ev.get("pid", 0))
        track = names.get(pid, f"pid{pid}")
        tracks.setdefault(track, []).append(
            TraceEvent(
                t0 + float(ev.get("ts", 0.0)) / 1e6,
                ev["name"],
                dict(ev.get("args") or {}),
            )
        )
    for evs in tracks.values():
        evs.sort(key=lambda e: e.ts)
    return tracks
