"""Live scrape endpoints for a running cluster (stdlib HTTP only).

One :class:`ObsServer` per :class:`~hbbft_tpu_torch.transport.cluster.
LocalCluster` (``cluster.serve_obs()``), answering while the run is
live — every read path snapshots (Metrics takes its lock per family,
trace buffers copy under theirs, batch counts are O(1)), so a scrape
never blocks or perturbs the protocol/transport threads beyond those
snapshots.

Endpoints:

* ``GET /metrics``  — merged Prometheus exposition
  (:meth:`Metrics.prometheus_text` over
  :meth:`LocalCluster.merged_metrics`, which also carries the
  ``epoch.latency`` / ``phase.*`` summaries and, on a crypto-plane
  cluster, the ``crypto.*`` counters).
* ``GET /trace.json`` — the merged Chrome trace (one track per node;
  loads in Perfetto / ``chrome://tracing``).
* ``GET /healthz`` — JSON liveness: per node ``alive`` (protocol
  thread running), ``batches`` (committed count) and
  ``last_committed`` ``[era, epoch]`` (null before the first commit);
  top-level ``ok`` is true iff every non-Byzantine node is alive.
  Status 200 when ok, 503 otherwise (load-balancer semantics).
* ``GET /diag`` — the live stall diagnosis
  (:func:`~hbbft_tpu_torch.obs.analyze.diagnose` over the SAME rings the
  trace export reads, so live and post-mortem analysis can never
  disagree): ``stalled`` / ``since_s``, the open epoch per node,
  per-instance stuck phases (which proposer's RBC is incomplete, which
  BA is stuck at which round), link state, and a ``verdict`` naming
  the most-implicated (proposer, phase) when stalled.
  ``?stall_s=<seconds>`` overrides the quiescence threshold (default
  5 s).  Always HTTP 200 — a diagnosis of "stalled" is a successful
  scrape.

Tests drive these with ``urllib`` against a driven N=4 cluster.

Copy of ``hbbft_tpu/obs/server.py``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple
from urllib.parse import parse_qs


class ObsServer:
    """Serve /metrics, /trace.json and /healthz for ``cluster``."""

    def __init__(
        self, cluster: Any, host: str = "127.0.0.1", port: int = 0
    ) -> None:
        self.cluster = cluster
        obs = self

        class Handler(BaseHTTPRequestHandler):
            # quiet: a polling scraper must not spam the test log
            def log_message(self, fmt: str, *args: Any) -> None:
                pass

            def _reply(
                self, code: int, body: bytes, ctype: str
            ) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        text = obs.cluster.merged_metrics().prometheus_text()
                        self._reply(
                            200,
                            text.encode(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/trace.json":
                        body = json.dumps(obs.cluster.chrome_trace()).encode()
                        self._reply(200, body, "application/json")
                    elif path == "/healthz":
                        ok, health = obs.health()
                        self._reply(
                            200 if ok else 503,
                            json.dumps(health).encode(),
                            "application/json",
                        )
                    elif path == "/diag":
                        qs = parse_qs(
                            self.path.partition("?")[2], keep_blank_values=False
                        )
                        try:
                            stall_s = float(qs["stall_s"][0])
                        except (KeyError, ValueError, IndexError):
                            stall_s = 5.0
                        self._reply(
                            200,
                            json.dumps(obs.diag(stall_s)).encode(),
                            "application/json",
                        )
                    else:
                        self._reply(404, b"not found\n", "text/plain")
                except Exception as exc:  # a scrape bug must not kill the run
                    try:
                        self._reply(
                            500, f"scrape error: {exc}\n".encode(), "text/plain"
                        )
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def addr(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def diag(self, stall_after_s: float = 5.0) -> dict:
        """The live stall diagnosis for ``/diag``: the cluster's own
        :meth:`diag` when it has one (LocalCluster), else
        :func:`~hbbft_tpu_torch.obs.analyze.diagnose` over its rings (the
        single-node worker view, which carries the cluster's real
        consensus size as ``consensus_n``).  Dead HONEST protocol
        threads from the health probe ride along — a diagnosis that
        names a stuck proposer but hides a crashed node would mislead."""
        c = self.cluster
        own = getattr(c, "diag", None)
        if callable(own):
            d = own(stall_after_s)
        else:
            from hbbft_tpu_torch.obs.analyze import diagnose

            d = diagnose(
                c.trace_events(),
                n=getattr(c, "consensus_n", None) or getattr(c, "n", None),
                stall_after_s=stall_after_s,
            )
        _ok, health = self.health()
        dead = sorted(
            int(i)
            for i, st in health["nodes"].items()
            if not st["alive"] and not st.get("byzantine")
        )
        if dead:
            d["dead_nodes"] = dead
        return d

    def health(self) -> Tuple[bool, dict]:
        c = self.cluster
        nodes = {}
        ok = True
        for i, node in sorted(c.nodes.items()):
            # is_alive(), not a None check: a protocol thread that died
            # from an uncaught exception still leaves its Thread object
            # behind — reporting it alive would hide an outage.
            t = getattr(node, "_thread", None)
            alive = t is not None and t.is_alive()
            last = c.last_committed(i)
            nodes[str(i)] = {
                "alive": alive,
                "batches": c.batch_count(i),
                "last_committed": list(last) if last is not None else None,
                "byzantine": i in getattr(c, "byzantine", {}),
            }
            if not alive and i not in getattr(c, "byzantine", {}):
                ok = False  # a dead HONEST node is an outage; a dead
                #             adversary (crash-stop) is the schedule
        return ok, {"ok": ok, "n": c.n, "nodes": nodes}

    def start(self) -> "ObsServer":
        assert self._thread is None
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="obs-server",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._thread = None
