"""Process-per-node cluster runtime (round 14): ``node_impl="native_proc"``.

:class:`ProcCluster` spawns one :mod:`~hbbft_tpu_torch.transport.
cluster_worker` OS process per node and plays the parent side of the
spawn protocol:

1. spawn every worker with ``--port 0`` and no ``--peers`` (handshake
   mode) — each binds an ephemeral listener and prints ONE ready line
   with its actual port (and obs port);
2. collect the ready lines, assemble the full address map, and write it
   as one JSON line to every worker's stdin — the workers then dial
   each other directly; the parent is out of the data path;
3. drive: ``drive="presubmit"`` workers self-submit the config6
   deterministic workload and run to ``epochs`` committed batches
   (cross-arm ``batches_sha`` identity); ``drive="self"`` workers pace
   txns against their own commits and stream per-batch JSON lines up
   (the kill/restart drill watches those);
4. teardown: a ``{"stop": true}`` line (or just closing stdin) ends an
   open-ended worker; summaries carry ``batches_sha`` + merged
   counters, so the parent asserts cross-process byte-identity without
   scraping.

Key material never crosses the process boundary: every worker re-derives
its keys from ``(n, f, seed)`` (the ``deal_keys`` dealer ritual).

Failure drills: :meth:`kill` SIGKILLs a worker (a REAL process death —
kernel buffers, inbox, protocol state all gone); :meth:`restart`
respawns it on its old port (still handshake mode, so the parent can
re-send the address map and keep the stop channel).  Surviving workers'
resume layers retransmit across the death exactly as in thread mode —
tests/test_torch_proc_cluster.py pins losslessness from the batch streams.

The parent process stays out of the hot path by construction: after the
address map is delivered it only reads worker stdout lines and polls
process liveness, so N workers put ~3 threads each on the box (selector
loop, protocol/engine sweep, driver) instead of 2N threads in ONE
interpreter sharing a GIL.

Copy of ``hbbft_tpu/transport/proc_cluster.py``: the workers are
:mod:`hbbft_tpu_torch.transport.cluster_worker` processes, and an owned
crypto service is the port's :mod:`hbbft_tpu_torch.cryptoplane.
proc_service` (``backend="batched"``: the workers are scalar-suite).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.obs.export import merge_chrome_traces

#: Repo root (the directory holding the ``hbbft_tpu_torch`` package) —
#: pinned onto the workers' PYTHONPATH so spawning works from any cwd.
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


class _Worker:
    """Parent-side handle: process + stdout pump + parsed line state."""

    def __init__(self, node_id: int, proc: subprocess.Popen) -> None:
        self.id = node_id
        self.proc = proc
        self.ready: Optional[dict] = None
        self.summary: Optional[dict] = None
        self.batch_lines: List[dict] = []
        self.ready_evt = threading.Event()
        self.done_evt = threading.Event()
        self.lock = threading.Lock()
        self.thread = threading.Thread(
            target=self._pump, name=f"proc-worker-{node_id}", daemon=True
        )
        self.thread.start()

    def _pump(self) -> None:
        # One blocking reader per worker: stdout lines are the worker's
        # only upward channel (ready line, per-batch lines, summary).
        for line in self.proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if obj.get("ready"):
                self.ready = obj
                self.ready_evt.set()
            elif "done" in obj:
                self.summary = obj
                self.done_evt.set()
            elif "era" in obj:
                with self.lock:
                    self.batch_lines.append(obj)
        self.done_evt.set()  # EOF: the process is gone either way

    @property
    def port(self) -> Optional[int]:
        return self.ready["port"] if self.ready else None

    @property
    def obs_port(self) -> Optional[int]:
        return self.ready.get("obs_port") if self.ready else None

    def batches(self) -> List[dict]:
        with self.lock:
            return list(self.batch_lines)

    def batch_count(self) -> int:
        with self.lock:
            return len(self.batch_lines)

    def send(self, obj: dict) -> None:
        try:
            self.proc.stdin.write(json.dumps(obj) + "\n")
            self.proc.stdin.flush()
        except (OSError, ValueError):
            pass  # already dead / stdin closed


class ProcCluster:
    """N cluster-worker processes on localhost ephemeral ports."""

    def __init__(
        self,
        n: int,
        seed: int = 0,
        batch_size: int = 8,
        impl: str = "native",
        epochs: int = 5,
        drive: str = "presubmit",
        presubmit: Optional[int] = None,
        timeout_s: float = 300.0,
        num_faulty: Optional[int] = None,
        session_id: str = "tcp-cluster",
        cluster_id: str = "hbbft-tpu/cluster/v1",
        obs: bool = False,
        trace_dir: Optional[str] = None,
        metrics_in_summary: bool = False,
        ready_timeout_s: Optional[float] = None,
        stderr: str = "devnull",
        python: str = sys.executable,
        crypto: str = "inline",
        crypto_service: Any = None,
        service_kwargs: Optional[Dict[str, Any]] = None,
    ) -> None:
        if impl not in ("python", "native"):
            raise ValueError(f"impl must be python|native, got {impl!r}")
        if drive not in ("presubmit", "self"):
            raise ValueError(f"drive must be presubmit|self, got {drive!r}")
        # crypto (round 18): "service-proc" points every worker at ONE
        # crypto-plane service process (--crypto-service host:port), so
        # all N node processes' share checks batch through one backend
        # flush — the cross-node amortization plane ProcCluster could
        # not reach with the round-13 in-thread service.  crypto_service
        # may be a pre-started ServiceProcess or a (host, port) tuple;
        # None spawns an owned worker (or attaches to
        # HBBFT_TORCH_CRYPTO_SERVICE).  Workers keep local fallbacks —
        # killing the service process never stalls the cluster.
        if crypto not in ("inline", "service-proc"):
            raise ValueError(
                f"crypto must be inline|service-proc, got {crypto!r}"
            )
        if crypto_service is not None and crypto != "service-proc":
            raise ValueError("crypto_service requires crypto='service-proc'")
        if service_kwargs and crypto != "service-proc":
            raise ValueError("service_kwargs requires crypto='service-proc'")
        self.crypto = crypto
        self.crypto_service = crypto_service
        self._service_kwargs = dict(service_kwargs or {})
        self._crypto_timeout_s = self._service_kwargs.pop("timeout_s", None)
        self._owns_service = False
        self._service_addr: Optional[Tuple[str, int]] = None
        self.n = n
        self.seed = seed
        self.batch_size = batch_size
        self.impl = impl
        self.epochs = epochs
        self.drive = drive
        self.presubmit = presubmit
        self.timeout_s = timeout_s
        self.num_faulty = num_faulty
        self.session_id = session_id
        self.cluster_id = cluster_id
        self.obs = obs
        self.trace_dir = trace_dir
        self.metrics_in_summary = metrics_in_summary
        # Spawn is CPU-serialized on a 1-core box (one interpreter boot
        # per worker): scale the ready deadline with the fleet size.
        self.ready_timeout_s = (
            ready_timeout_s if ready_timeout_s is not None else 30.0 + 2.0 * n
        )
        self._stderr_mode = stderr
        self.python = python
        self.workers: Dict[int, _Worker] = {}
        self.addr_map: Dict[int, Tuple[str, int]] = {}
        self._started = False

    # -- spawn protocol -------------------------------------------------
    def _spawn(self, node_id: int, port: int = 0) -> _Worker:
        cmd = [
            self.python,
            "-m",
            "hbbft_tpu_torch.transport.cluster_worker",
            "--node-id", str(node_id),
            "--n", str(self.n),
            "--seed", str(self.seed),
            "--batch-size", str(self.batch_size),
            "--impl", self.impl,
            "--port", str(port),
            "--drive", self.drive,
            "--epochs", str(self.epochs),
            "--timeout-s", str(self.timeout_s),
            "--session-id", self.session_id,
            "--cluster-id", self.cluster_id,
        ]
        if self.num_faulty is not None:
            cmd += ["--num-faulty", str(self.num_faulty)]
        if self.presubmit is not None:
            cmd += ["--presubmit", str(self.presubmit)]
        if self.obs:
            cmd += ["--obs-port", "0"]
        if self.metrics_in_summary:
            cmd += ["--metrics"]
        if self.trace_dir:
            os.makedirs(self.trace_dir, exist_ok=True)
            cmd += [
                "--trace-file",
                os.path.join(self.trace_dir, f"node{node_id}.trace.json"),
            ]
        if self._service_addr is not None:
            cmd += [
                "--crypto-service",
                f"{self._service_addr[0]}:{self._service_addr[1]}",
            ]
            if self._crypto_timeout_s is not None:
                cmd += ["--crypto-timeout-s", str(self._crypto_timeout_s)]
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT
        proc = subprocess.Popen(
            cmd,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=(
                subprocess.DEVNULL
                if self._stderr_mode == "devnull"
                else None
            ),
            text=True,
            env=env,
            cwd=_REPO_ROOT,
        )
        return _Worker(node_id, proc)

    def _resolve_service(self) -> None:
        """Resolve the crypto-service address BEFORE any worker spawns
        (the address rides each worker's argv)."""
        if self.crypto != "service-proc" or self._service_addr is not None:
            return
        from hbbft_tpu_torch.cryptoplane.proc_service import (
            ServiceProcess,
            service_addr_from_env,
        )

        if isinstance(self.crypto_service, tuple):
            self._service_addr = self.crypto_service
            self.crypto_service = None
            return
        if self.crypto_service is not None:
            self._service_addr = self.crypto_service.addr
            return
        env_addr = service_addr_from_env()
        if env_addr is not None:
            self._service_addr = env_addr
            return
        self.crypto_service = ServiceProcess(
            suite="scalar",
            backend=self._service_kwargs.pop("backend", "batched"),
            python=self.python,
            **self._service_kwargs,
        ).start()
        self._owns_service = True
        self._service_addr = self.crypto_service.addr

    def kill_service(self) -> None:
        """SIGKILL the crypto-service process mid-run (the fallback
        drill): workers' flushes fall back locally, commits continue."""
        if self.crypto_service is None:
            raise RuntimeError("no crypto-service process to kill")
        self.crypto_service.kill()

    def restart_service(self) -> None:
        """Respawn the killed service on its old port; workers'
        bounded-backoff re-dials re-attach automatically."""
        if self.crypto_service is None:
            raise RuntimeError("no crypto-service process to restart")
        self.crypto_service.restart()

    def start(self) -> "ProcCluster":
        assert not self._started
        self._resolve_service()
        for i in range(self.n):
            self.workers[i] = self._spawn(i)
        deadline = time.monotonic() + self.ready_timeout_s
        for i, w in self.workers.items():
            if not w.ready_evt.wait(max(0.0, deadline - time.monotonic())):
                rcs = {
                    j: ww.proc.poll() for j, ww in self.workers.items()
                }
                self.stop()
                raise TimeoutError(
                    f"worker {i} never printed its ready line "
                    f"(exit codes so far: {rcs})"
                )
        self.addr_map = {
            i: ("127.0.0.1", w.port) for i, w in self.workers.items()
        }
        peers_line = {
            "peers": {str(i): list(a) for i, a in self.addr_map.items()}
        }
        for w in self.workers.values():
            w.send(peers_line)
        self._started = True
        return self

    def restart(self, node_id: int) -> None:
        """Respawn a killed worker on its OLD port (peers' backoff dials
        find the reborn listener).  Still handshake mode: the fresh
        process prints a ready line, then receives the SAME address map
        — so the parent keeps its stop channel and the worker re-derives
        its keys; nothing is replayed from the dead process."""
        old = self.workers[node_id]
        port = self.addr_map[node_id][1]
        if old.proc.poll() is None:
            old.proc.kill()
            old.proc.wait(timeout=10)
        w = self._spawn(node_id, port=port)
        self.workers[node_id] = w
        if not w.ready_evt.wait(self.ready_timeout_s):
            raise TimeoutError(f"restarted worker {node_id} never got ready")
        w.send(
            {"peers": {str(i): list(a) for i, a in self.addr_map.items()}}
        )

    # -- failure drills -------------------------------------------------
    def kill(self, node_id: int) -> None:
        """A real process death: SIGKILL, no teardown, no goodbyes."""
        self.workers[node_id].proc.kill()

    # -- driving / observing --------------------------------------------
    def batch_count(self, node_id: int) -> int:
        return self.workers[node_id].batch_count()

    def batches(self, node_id: int) -> List[dict]:
        return self.workers[node_id].batches()

    def wait(
        self, pred, timeout_s: float, poll_s: float = 0.05
    ) -> bool:
        """LocalCluster's predicate wait, against the worker handles."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if pred(self):
                return True
            time.sleep(poll_s)
        return pred(self)

    def join(self, timeout_s: Optional[float] = None) -> Dict[int, dict]:
        """Wait for every worker's summary (or exit); returns summaries
        keyed by node id (a worker that died without one maps to None)."""
        deadline = time.monotonic() + (
            timeout_s if timeout_s is not None else self.timeout_s + 60.0
        )
        for w in self.workers.values():
            w.done_evt.wait(max(0.0, deadline - time.monotonic()))
        return {i: w.summary for i, w in self.workers.items()}

    def summaries(self) -> Dict[int, Optional[dict]]:
        return {i: w.summary for i, w in self.workers.items()}

    def shas(self) -> Dict[int, Optional[str]]:
        return {
            i: (w.summary or {}).get("batches_sha")
            for i, w in self.workers.items()
        }

    def scrape(self, node_id: int, path: str = "/metrics") -> bytes:
        """GET an endpoint from one worker's obs server (requires
        ``obs=True``; the port came back in the ready line)."""
        import urllib.request

        port = self.workers[node_id].obs_port
        if not port:
            raise RuntimeError(f"worker {node_id} serves no obs port")
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10
        ) as resp:
            return resp.read()

    def diag(self, stall_after_s: float = 5.0) -> Dict[str, Any]:
        """Parent-side cluster diagnosis: scrape every live worker's
        ``/diag`` (the analyzer over ITS rings, with the cluster's real
        consensus size) and fold them with
        :func:`~hbbft_tpu_torch.obs.analyze.merge_diags` — the same verdict
        rule as a thread-mode cluster, so both runtimes name the same
        stuck (proposer, phase).  Dead workers are reported, not
        scraped (requires ``obs=True``)."""
        from hbbft_tpu_torch.obs.analyze import merge_diags

        per_worker: Dict[int, Optional[dict]] = {}
        dead: List[int] = []
        for i, w in self.workers.items():
            if w.proc.poll() is not None or not w.obs_port:
                dead.append(i)
                continue
            try:
                per_worker[i] = json.loads(
                    self.scrape(i, f"/diag?stall_s={stall_after_s}")
                )
            except Exception:
                dead.append(i)  # mid-scrape death: same as dead
        merged = merge_diags(
            list(per_worker.values()), stall_after_s=stall_after_s
        )
        if dead:
            merged["dead_nodes"] = sorted(dead)
        return merged

    def merged_chrome_trace(self) -> Dict[str, Any]:
        """Merge the per-worker trace files (``trace_dir`` mode) into
        one Chrome trace on the shared wall clock."""
        if not self.trace_dir:
            raise RuntimeError("ProcCluster(trace_dir=...) not set")
        parts = []
        for i in range(self.n):
            path = os.path.join(self.trace_dir, f"node{i}.trace.json")
            try:
                with open(path) as fh:
                    parts.append(json.load(fh))
            except (OSError, ValueError):
                continue  # killed worker: no exit dump — merge the rest
        return merge_chrome_traces(parts)

    # -- teardown -------------------------------------------------------
    def stop(self, grace_s: float = 10.0) -> None:
        for w in self.workers.values():
            if w.proc.poll() is None:
                w.send({"stop": True})
            try:
                if w.proc.stdin:
                    w.proc.stdin.close()
            except OSError:
                pass
        deadline = time.monotonic() + grace_s
        for w in self.workers.values():
            while w.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if w.proc.poll() is None:
                w.proc.terminate()
        for w in self.workers.values():
            try:
                w.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait(timeout=5)
            w.thread.join(timeout=5)
        # Service AFTER the workers (same ordering rule as
        # LocalCluster.stop): in-flight flushes drain or fall back
        # before the plane goes away.  Only a service THIS cluster
        # spawned — an externally-run one belongs to its owner.
        if self._owns_service and self.crypto_service is not None:
            self.crypto_service.stop()
        self._started = False

    def __enter__(self) -> "ProcCluster":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
