"""Critical-path / stall analysis CLI over a flight-recorder trace.

Runs the IDENTICAL code (:mod:`hbbft_tpu_torch.obs.analyze`) the live
``/diag`` endpoint runs, over a dumped ``trace.json`` — so post-mortem
and live diagnosis can never disagree.

Usage::

    python -m hbbft_tpu_torch.tools.analyze /tmp/run.trace.json         # critical paths
    python -m hbbft_tpu_torch.tools.analyze /tmp/run.trace.json --diag  # post-mortem stall
    python -m hbbft_tpu_torch.tools.analyze --url http://127.0.0.1:9100 # scrape a live run
    python -m hbbft_tpu_torch.tools.analyze --demo 4                    # live N=4 demo,
                                                                        # /diag printed
    ... --json                                                          # machine output

Trace sources: any ``trace.json`` the recorder writes —
``LocalCluster.write_trace``, a worker's ``--trace-file`` or a
``ProcCluster`` parent merge.  ``--url`` fetches ``<url>/trace.json``
from a live scrape server (``obs.server.ObsServer``) and analyzes it
client-side (plus ``<url>/diag`` with ``--diag``, which is the server's
own verdict).

For post-mortem ``--diag`` the clock is frozen at the newest event
stamp: "stalled" then means the RUN ended in a stall, not that the file
is old.

Copy of the reference's ``tools/analyze.py`` over this package: the same
flags and the same output.  A trace path or ``--url`` loads no
``torch``; ``--demo`` runs this package's ``LocalCluster`` (python
nodes, the scalar suite, host backends).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from hbbft_tpu_torch.obs.analyze import (
    critical_path,
    diagnose,
    summarize_critical_paths,
    tracks_from_chrome,
)


def _fmt_s(dt: float) -> str:
    return f"{dt * 1e3:8.2f} ms"


def render_paths(records: List[Dict[str, Any]]) -> str:
    """Human rendering of per-epoch critical paths + the summary."""
    lines: List[str] = []
    for rec in records:
        strag = rec["straggler"]
        lines.append(
            f"epoch (era {rec['era']}, {rec['epoch']}): "
            f"wall {rec['wall_s'] * 1e3:.2f} ms, "
            f"commit skew {rec['commit_skew_s'] * 1e3:.2f} ms, "
            f"coins {rec['coins']}"
            + (
                f", straggler {strag['node']}"
                f" {strag['phase']}"
                + (
                    f" (proposer {strag['proposer']})"
                    if strag.get("proposer") is not None
                    else ""
                )
                if strag
                else ""
            )
        )
        for p in rec["path"]:
            extra = []
            if "proposer" in p:
                extra.append(f"proposer {p['proposer']}")
            if p.get("round") is not None:
                extra.append(f"round {p['round']}")
            lines.append(
                f"  +{_fmt_s(p['dt_s'])}  {p['stage']:<14} {p['node']}"
                + (f"  ({', '.join(extra)})" if extra else "")
            )
        if rec.get("flush"):
            fl = rec["flush"]
            lines.append(
                f"  cryptoplane: {fl['flushes']} flushes, "
                f"{fl['total_s'] * 1e3:.2f} ms total"
            )
    lines.append("")
    lines.append("summary: " + json.dumps(summarize_critical_paths(records)))
    return "\n".join(lines)


def render_diag(d: Dict[str, Any]) -> str:
    lines = [
        f"stalled: {d['stalled']}"
        + (
            f" (no commit for {d['since_s']:.1f} s"
            f" > {d['stall_after_s']} s)"
            if d["stalled"] and d.get("since_s") is not None
            else ""
        ),
        f"last commit: {d.get('last_commit')}",
        f"open epochs: {json.dumps(d.get('open_epochs', {}))}",
    ]
    v = d.get("verdict")
    if v and v.get("phase") == "link":
        lines.append(
            f"verdict: peers {v['peers']} down on {v['nodes']} node(s) "
            "(quorum lost at the link layer)"
        )
    elif v:
        lines.append(
            f"verdict: proposer {v['proposer']} stuck in {v['phase']}"
            + (f" at round {v['round']}" if v.get("round") is not None else "")
            + f" on {v['nodes']} node(s)"
        )
    for s in d.get("stuck", ()):
        lines.append(
            f"  {s['node']} e{s['era']}/{s['epoch']}"
            f" proposer {s['proposer']}: {s['phase']} — {s['detail']}"
            f" (idle {s['age_s']:.1f} s)"
        )
    for track, st in sorted(d.get("links", {}).items()):
        if st.get("disconnected"):
            lines.append(f"  {track}: disconnected peers {st['disconnected']}")
        for ban in st.get("banned", ()):
            lines.append(
                f"  {track}: peer {ban['peer']} banned ({ban['offense']})"
            )
    if d.get("dead_nodes"):
        lines.append(f"  dead honest nodes: {d['dead_nodes']}")
    return "\n".join(lines)


def _demo(n: int, as_json: bool) -> int:
    """Live demo: drive an N-node cluster, print its critical paths,
    then partition an honest minority and print the resulting /diag —
    over HTTP, so what you see is exactly what a scraper sees."""
    import time
    import urllib.request

    from hbbft_tpu_torch.transport import LocalCluster

    with LocalCluster(n, seed=0) as c:
        base = f"http://127.0.0.1:{c.serve_obs().port}"
        print(f"# scrape endpoints live at {base} (/metrics /trace.json "
              f"/healthz /diag)", file=sys.stderr)
        c.drive_to(range(n), 3, timeout_s=60, tag="demo")
        doc = json.loads(
            urllib.request.urlopen(base + "/trace.json", timeout=10).read()
        )
        records = critical_path(tracks_from_chrome(doc))
        if not as_json:
            print(render_paths(records))
        # now demonstrate the stall diagnostician: sever f+1 nodes —
        # one more than the cluster tolerates — so commits stop and
        # /diag has something real to explain
        victims = list(range(n - (c.f + 1), n))
        print(f"\n# partitioning nodes {victims}; /diag after quiescence:",
              file=sys.stderr)
        for v in victims:
            c.disconnect(v)
        survivors = [i for i in range(n) if i not in victims]
        try:
            c.drive_to(survivors, 10**9, timeout_s=2, tag="stall")
        except TimeoutError:
            pass
        time.sleep(3.2)
        d = json.loads(
            urllib.request.urlopen(base + "/diag?stall_s=3", timeout=10).read()
        )
        if as_json:
            print(json.dumps({"critical_path": records, "diag": d}))
        else:
            print(render_diag(d))
        for v in victims:
            c.reconnect(v)
    return 0


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="hbbft-tpu flight-recorder critical-path analyzer"
    )
    ap.add_argument("trace", nargs="?", help="path to a dumped trace.json")
    ap.add_argument(
        "--url", help="base URL of a live obs server (fetches /trace.json)"
    )
    ap.add_argument(
        "--diag", action="store_true",
        help="print the stall diagnosis instead of just critical paths",
    )
    ap.add_argument(
        "--stall-s", type=float, default=5.0,
        help="quiescence threshold for --diag (default 5)",
    )
    ap.add_argument(
        "--n", type=int, default=None,
        help="consensus size for --diag (needed for a single-worker "
        "dump, whose one node track hides the other proposers; "
        "inferred from the node tracks otherwise)",
    )
    ap.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    ap.add_argument(
        "--demo", type=int, metavar="N",
        help="run a live N-node demo cluster and print its /diag",
    )
    args = ap.parse_args(argv)

    if args.demo:
        return _demo(args.demo, args.json)

    if args.url:
        import urllib.request

        doc = json.loads(
            urllib.request.urlopen(
                args.url.rstrip("/") + "/trace.json", timeout=10
            ).read()
        )
    elif args.trace:
        try:
            with open(args.trace) as fh:
                doc = json.load(fh)
        except OSError as exc:
            print(f"analyze: cannot read {args.trace}: {exc}", file=sys.stderr)
            return 2
        except json.JSONDecodeError as exc:
            print(
                f"analyze: {args.trace} is not a complete JSON document"
                f" (truncated dump?): {exc}",
                file=sys.stderr,
            )
            return 2
    else:
        ap.error("need a trace.json path, --url, or --demo N")
        return 2

    try:
        tracks = tracks_from_chrome(doc)
    except (AttributeError, KeyError, TypeError, ValueError) as exc:
        print(
            f"analyze: not a Chrome-trace document ({exc!r}) — expected "
            "the recorder's trace.json shape (traceEvents + otherData)",
            file=sys.stderr,
        )
        return 2
    if not tracks:
        # Valid document, zero recorder events (e.g. a dump taken before
        # any epoch opened): an honest empty analysis, not a crash.
        print(
            "analyze: trace contains no recorder events (empty tracks)",
            file=sys.stderr,
        )
    records = critical_path(tracks)
    out: Dict[str, Any] = {
        "critical_path": records,
        "summary": summarize_critical_paths(records),
    }
    if args.diag:
        if args.url:
            # live run: the server's own /diag IS the verdict — its
            # clock is real, so quiescence (no new events at all) reads
            # as stalled, which a frozen-clock local pass would miss
            out["diag"] = json.loads(
                urllib.request.urlopen(
                    args.url.rstrip("/")
                    + f"/diag?stall_s={args.stall_s}",
                    timeout=10,
                ).read()
            )
        else:
            # post-mortem: freeze the clock at the capture instant —
            # "stalled" must describe the run, not the file's age
            now = max(
                (ev.ts for evs in tracks.values() for ev in evs),
                default=None,
            )
            out["diag"] = diagnose(
                tracks, n=args.n, now=now, stall_after_s=args.stall_s
            )
    if args.json:
        print(json.dumps(out))
    else:
        print(render_paths(records))
        if args.diag:
            print()
            print(render_diag(out["diag"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
