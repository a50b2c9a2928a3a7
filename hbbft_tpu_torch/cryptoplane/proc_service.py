"""Crypto plane as a process: the RPC boundary around the service.

Copy of ``hbbft_tpu/cryptoplane/proc_service.py``.  It runs
:class:`~hbbft_tpu_torch.cryptoplane.service.CryptoPlaneService` in its
own OS process, so one card can serve every node of a cluster, batching
ALL nodes' COIN/DECRYPT/sig checks into single ``verify_batch`` flushes —
the Thetacrypt "threshold crypto as a service" shape (arxiv
2502.03247).  Three pieces:

* **Worker** (``python -m hbbft_tpu_torch.cryptoplane.proc_service``): wraps
  the unchanged in-process service + a socket acceptor.  It binds
  ``--port 0``, prints ONE ready JSON line with the bound port (and,
  before it, one line naming its backend and device), then stdin is the
  stop channel (EOF = orphan cleanup).  ``--backend torch`` serves from
  :class:`~hbbft_tpu_torch.crypto.device.backend.TorchBackend` on
  ``--device`` (default ``cuda``; the counterpart of the reference's
  ``tpu``): the worker initialises the card and loads the kernels
  before it reports ready, and a worker that finds no card exits
  nonzero without a ready line, so :meth:`ServiceProcess.start` raises.
  With no ``--backend``, a BLS worker serves from the card and a scalar
  one from ``BatchedBackend`` (:data:`DEFAULT_BACKEND`).  A device
  flush that raises ends the worker (exit code 3, after a line naming
  the error), so it never goes on serving.  Requests from ALL connections merge
  through the service's one batching window, so cross-NODE amortization
  happens exactly where cross-THREAD amortization already did.
* **Wire**: the transport's length-prefixed frame grammar
  (:mod:`~hbbft_tpu_torch.transport.framing`) with a DISJOINT kind set
  (``CRYPTO_KINDS``) — a service socket pointed at a consensus port (or
  vice versa) dies at the framing layer.  Payloads are serde, suite-
  pinned; requests ride as the registered ``"vreq"`` struct
  (:mod:`hbbft_tpu_torch.wire`), so shares are opaque bytes to this module
  and any :class:`~hbbft_tpu_torch.crypto.backend.CryptoBackend` rides
  behind the boundary.  One outstanding request per connection: the
  caller is a node's protocol thread that cannot progress past the
  share check anyway, and it keeps the framing strictly sequential
  (req/resp alternation; a mismatched ``req_id`` is a protocol error).
* **Client** (:class:`RpcServiceClient`): a drop-in ``CryptoBackend``
  with the in-thread :class:`~hbbft_tpu_torch.cryptoplane.service.
  ServiceClient`'s failure stance — the service is an OPTIMIZATION
  plane, never a liveness dependency.  Any socket error, timeout,
  malformed response, or service-side flush failure routes the SAME
  requests through the local fallback backend (counted:
  ``crypto.rpc.fallbacks``), and the next flush re-dials (bounded
  backoff), so a restarted service is re-attached automatically.
  Verdicts are pure functions of request content (the standing
  deferred-verification invariant), so the two paths are
  interchangeable per request: no lost or duplicated fault
  attributions across a mid-flush SIGKILL (tests/
  test_torch_proc_service.py pins both).

Requests that fail to serde-encode (protocol handlers can be handed
arbitrary Byzantine objects) ride as ``None`` placeholders and verify
``False`` — the same verdict ``request_well_formed`` gives them on
every local backend, so the RPC boundary never changes a verdict.

Observability: the client stamps ``crypto.rpc.*`` metrics (round-trip
timer, queued gauge, fallback counters) into its node's metrics and
emits ``crypto.flush.open/done`` spans (batch size + a ``span`` id for
concurrent-client pairing) onto the cluster's ``cryptoplane`` trace
track, which /diag's critical-path analyzer already folds into
per-epoch flush attribution.  The server reports each response's
merged flush size (``flush_requests``/``flush_jobs``) so a client can
see the amortization it actually got.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import hbbft_tpu_torch.wire  # noqa: F401  (registers the "vreq" serde struct)
from hbbft_tpu_torch.crypto.backend import CryptoBackend, VerifyRequest
from hbbft_tpu_torch.cryptoplane.service import CryptoPlaneService
from hbbft_tpu_torch.transport.framing import (
    CRYPTO_KINDS,
    KIND_CRYPTO_HELLO,
    KIND_CRYPTO_REQ,
    KIND_CRYPTO_RESP,
    MAX_FRAME_LEN,
    RECV_CHUNK,
    FrameDecoder,
    FrameError,
    encode_frame,
)
from hbbft_tpu_torch.utils import serde
from hbbft_tpu_torch.utils.metrics import Metrics

RPC_VERSION = 1

#: Default RPC-mode client timeout (seconds); overridden per client or
#: via the env knob.  Generous on purpose: the fallback exists for
#: DEATH, not jitter — a busy 1-core box can hold a flush for a while.
DEF_TIMEOUT_S = 30.0

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def default_rpc_timeout_s() -> float:
    """``HBBFT_TORCH_CRYPTO_RPC_TIMEOUT_S`` (seconds a client waits on one
    RPC round trip before falling back locally)."""
    return float(os.environ.get("HBBFT_TORCH_CRYPTO_RPC_TIMEOUT_S", DEF_TIMEOUT_S))


def default_window_s() -> float:
    """``HBBFT_TORCH_CRYPTO_WINDOW_S`` (the service's cross-client batching
    window; the worker's ``--window-s`` default)."""
    return float(os.environ.get("HBBFT_TORCH_CRYPTO_WINDOW_S", 0.002))


def service_addr_from_env() -> Optional[Tuple[str, int]]:
    """``HBBFT_TORCH_CRYPTO_SERVICE`` (``host:port`` of an already-running
    service process to attach to instead of spawning one)."""
    spec = os.environ.get("HBBFT_TORCH_CRYPTO_SERVICE")
    return parse_addr(spec) if spec else None


def parse_addr(spec: str) -> Tuple[str, int]:
    host, _, port = spec.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad service address {spec!r} (want host:port)")
    return host, int(port)


# -- suites / backends (worker argv vocabulary) ------------------------------

#: The worker's backend when none is named: the card for BLS (a worker
#: with no card exits before it is ready), the host for the scalar suite,
#: which has no device path.
DEFAULT_BACKEND = {"bls": "torch", "scalar": "batched"}

def _build_suite(name: str):
    if name == "scalar":
        from hbbft_tpu_torch.crypto.suite import ScalarSuite

        return ScalarSuite()
    if name == "bls":
        from hbbft_tpu_torch.crypto.bls.suite import BLSSuite

        return BLSSuite()
    raise ValueError(f"unknown suite {name!r} (scalar | bls)")


def suite_arg_for(suite: Any) -> str:
    """The ``--suite`` argv token for a live suite instance."""
    return "bls" if suite.name == "bls12-381" else "scalar"


def _build_backend(name: str, suite: Any, device: str = "cuda") -> CryptoBackend:
    if name == "batched":
        from hbbft_tpu_torch.crypto.backend import BatchedBackend

        return BatchedBackend(suite)
    if name == "eager":
        from hbbft_tpu_torch.crypto.backend import EagerBackend

        return EagerBackend(suite)
    if name == "torch":
        # The card is initialised and the kernels loaded HERE, in the
        # service process only, whatever the nodes run.  No card and
        # device "cuda" raises: the worker never serves from the CPU
        # unless asked with device "cpu".
        from hbbft_tpu_torch.crypto.device.backend import TorchBackend

        backend = TorchBackend(suite, device=device)
        backend.load_kernels()
        return backend
    raise ValueError(f"unknown backend {name!r} (batched | eager | torch)")


# -- wire helpers ------------------------------------------------------------

def _hello_frame(suite_name: str, max_frame_len: int) -> bytes:
    return encode_frame(
        KIND_CRYPTO_HELLO,
        serde.dumps((RPC_VERSION, suite_name)),
        max_frame_len,
        kinds=CRYPTO_KINDS,
    )


def _check_hello(payload: bytes, suite_name: str) -> None:
    obj = serde.try_loads(payload)
    if (
        not isinstance(obj, tuple)
        or len(obj) != 2
        or type(obj[0]) is not int
        or type(obj[1]) is not str
    ):
        raise FrameError("malformed crypto HELLO")
    if obj[0] != RPC_VERSION:
        raise FrameError(f"crypto RPC version {obj[0]} != {RPC_VERSION}")
    if obj[1] != suite_name:
        raise FrameError(
            f"crypto suite mismatch: peer={obj[1]!r} local={suite_name!r}"
        )


def _recv_frame(
    sock: socket.socket, dec: FrameDecoder, deadline: Optional[float]
) -> Tuple[int, bytes]:
    """Block for the next complete frame (honoring ``deadline``,
    monotonic).  EOF and timeout both raise OSError subclasses — the
    caller's uniform response is drop-the-connection."""
    while True:
        got = dec.next_frame()
        if got is not None:
            return got
        if deadline is not None:
            remain = deadline - time.monotonic()
            if remain <= 0:
                raise socket.timeout("crypto RPC deadline")
            sock.settimeout(min(remain, 5.0) if remain > 0 else 0.001)
        data = sock.recv(RECV_CHUNK)
        if not data:
            raise ConnectionError("crypto RPC peer closed")
        dec.feed(data)


# -- server ------------------------------------------------------------------

class CryptoRpcServer:
    """Socket front of one :class:`CryptoPlaneService`.

    Accept loop + one reader thread per connection; every reader
    submits into the SAME service, whose batching window merges the
    requests of all connected nodes into one backend flush.  A
    malformed frame (bad CRC, unknown kind, oversized, undecodable
    payload) drops THAT connection only — the listener and every other
    client live on, and the disconnected client's next flush falls
    back locally then re-dials.
    """

    def __init__(
        self,
        service: CryptoPlaneService,
        suite: Any,
        host: str = "127.0.0.1",
        port: int = 0,
        max_frame_len: int = MAX_FRAME_LEN,
        job_wait_s: float = 600.0,
    ) -> None:
        self.service = service
        self.suite = suite
        self.max_frame_len = max_frame_len
        self.job_wait_s = job_wait_s
        self.metrics = service.metrics
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: Dict[int, socket.socket] = {}
        self._conn_seq = 0
        self._lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> "CryptoRpcServer":
        self.service.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="crypto-rpc-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            # shutdown wakes the accept loop at once; close alone leaves
            # it blocked in accept() until the join below times out
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
        for s in conns:
            try:
                s.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        self.service.stop()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return  # listener closed
            with self._lock:
                self._conn_seq += 1
                cid = self._conn_seq
                self._conns[cid] = sock
            self.metrics.count("crypto.rpc.accepts")
            threading.Thread(
                target=self._serve_conn,
                args=(cid, sock),
                name=f"crypto-rpc-conn-{cid}",
                daemon=True,
            ).start()

    def _serve_conn(self, cid: int, sock: socket.socket) -> None:
        dec = FrameDecoder(self.max_frame_len, kinds=CRYPTO_KINDS)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            kind, payload = _recv_frame(sock, dec, None)
            if kind != KIND_CRYPTO_HELLO:
                raise FrameError("first crypto frame must be HELLO")
            _check_hello(payload, self.suite.name)
            sock.sendall(_hello_frame(self.suite.name, self.max_frame_len))
            while not self._stop.is_set():
                kind, payload = _recv_frame(sock, dec, None)
                if kind != KIND_CRYPTO_REQ:
                    raise FrameError("expected crypto REQ")
                sock.sendall(self._handle_req(payload))
        except (FrameError, serde.DecodeError):
            self.metrics.count("crypto.rpc.bad_frames")
        except OSError:
            pass  # peer went away / timeout / we are stopping
        finally:
            try:
                sock.close()
            except OSError:
                pass
            with self._lock:
                self._conns.pop(cid, None)

    def _handle_req(self, payload: bytes) -> bytes:
        obj = serde.loads(payload, suite=self.suite)  # DecodeError -> drop
        if not isinstance(obj, tuple) or len(obj) != 3:
            raise FrameError("malformed crypto REQ")
        req_id, op, body = obj
        if type(req_id) is not int or type(op) is not str:
            raise FrameError("malformed crypto REQ header")
        if op == "stats":
            return self._resp(req_id, op, (self._stats_json(),))
        if op != "verify":
            raise FrameError(f"unknown crypto RPC op {op!r}")
        if not isinstance(body, tuple) or not all(
            item is None or isinstance(item, VerifyRequest) for item in body
        ):
            raise FrameError("malformed crypto verify body")
        return self._resp(req_id, op, self._verify(body))

    def _verify(self, items: Tuple[Any, ...]) -> tuple:
        # None placeholders (client-side unserializable junk) verify
        # False without touching the backend — the verdict every local
        # backend's request_well_formed gate would produce for them.
        real = [r for r in items if r is not None]
        verdicts = [False] * len(items)
        ok = True
        flush_requests = flush_jobs = 0
        if real:
            job = self.service.submit(real)
            ok = (
                job is not None
                and job.done.wait(self.job_wait_s)
                and job.results is not None
            )
            if job is not None and job.error is not None:
                # a device flush raised: the worker is stopping, and it
                # answers no request with a host re-verification
                raise ConnectionAbortedError("device flush failed")
            if job is not None and not ok:
                job.cancelled = True  # timed out: drop if still queued
            if ok:
                it = iter(job.results)
                verdicts = [
                    (next(it) if r is not None else False) for r in items
                ]
                flush_requests = job.flush_requests
                flush_jobs = job.flush_jobs
        self.metrics.count("crypto.rpc.served_requests", len(items))
        return (
            ok,
            bytes(bytearray(1 if v else 0 for v in verdicts)),
            flush_requests,
            flush_jobs,
        )

    def _resp(self, req_id: int, op: str, rest: tuple) -> bytes:
        return encode_frame(
            KIND_CRYPTO_RESP,
            serde.dumps((req_id, op) + rest),
            self.max_frame_len,
            kinds=CRYPTO_KINDS,
        )

    def _stats_json(self) -> bytes:
        # Stats are parent-side diagnostics (a benchmark's JSON line), not
        # protocol objects: JSON bytes, not serde structs.
        return json.dumps(self.metrics.to_json(), sort_keys=True).encode()


# -- client ------------------------------------------------------------------

class RpcServiceClient(CryptoBackend):
    """RPC-mode drop-in backend with local-fallback semantics.

    One instance per node (protocol thread is the only caller — same
    one-caller rule as every other per-node backend).  ``metrics``
    should be the node's own :class:`Metrics` so ``crypto.rpc.*`` rides
    every existing merge/scrape path; ``trace`` an (optionally shared)
    ``cryptoplane`` TraceBuffer — emits carry a ``span`` id so the
    analyzer can pair open/done across concurrently-flushing clients.
    """

    def __init__(
        self,
        addr: Tuple[str, int],
        suite: Any,
        fallback: CryptoBackend,
        *,
        timeout_s: Optional[float] = None,
        connect_timeout_s: float = 5.0,
        reconnect_backoff_s: float = 0.5,
        max_frame_len: int = MAX_FRAME_LEN,
        metrics: Optional[Metrics] = None,
        trace: Any = None,
        client_id: str = "",
    ) -> None:
        self.addr = (addr[0], int(addr[1]))
        self.suite = suite
        self.fallback = fallback
        self.timeout_s = float(
            timeout_s if timeout_s is not None else default_rpc_timeout_s()
        )
        self.connect_timeout_s = float(connect_timeout_s)
        self.reconnect_backoff_s = float(reconnect_backoff_s)
        self.max_frame_len = max_frame_len
        self.metrics = metrics if metrics is not None else Metrics()
        self.trace = trace
        self.client_id = client_id or f"rpc-{id(self) & 0xFFFF:04x}"
        self._sock: Optional[socket.socket] = None
        self._dec: Optional[FrameDecoder] = None
        self._seq = 0
        self._next_dial = 0.0
        self._ever_connected = False

    # -- connection management -----------------------------------------
    def _ensure_conn(self) -> Optional[socket.socket]:
        if self._sock is not None:
            return self._sock
        now = time.monotonic()
        if now < self._next_dial:
            return None  # inside the backoff window: fall back fast
        try:
            sock = socket.create_connection(
                self.addr, timeout=self.connect_timeout_s
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            dec = FrameDecoder(self.max_frame_len, kinds=CRYPTO_KINDS)
            sock.sendall(_hello_frame(self.suite.name, self.max_frame_len))
            deadline = time.monotonic() + self.connect_timeout_s
            kind, payload = _recv_frame(sock, dec, deadline)
            if kind != KIND_CRYPTO_HELLO:
                raise FrameError("service HELLO expected")
            _check_hello(payload, self.suite.name)
        except (OSError, FrameError):
            self._next_dial = now + self.reconnect_backoff_s
            return None
        self._sock, self._dec = sock, dec
        if self._ever_connected:
            # a successful dial after a drop = the re-attach drill's
            # observable (service restarted, client found it again)
            self.metrics.count("crypto.rpc.reconnects")
        self._ever_connected = True
        self.metrics.count("crypto.rpc.connects")
        return sock

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._dec = None
        self._next_dial = time.monotonic() + self.reconnect_backoff_s

    def close(self) -> None:
        self._drop_conn()

    # -- the backend interface -----------------------------------------
    def verify_batch(self, reqs: Sequence[VerifyRequest]) -> List[bool]:
        reqs = list(reqs)
        if not reqs:
            return []
        items = self._encode_items(reqs)
        sock = self._ensure_conn()
        if sock is None:
            return self._local(reqs, "unavailable")
        self._seq += 1
        req_id = self._seq
        span = f"{self.client_id}:{req_id}"
        if self.trace is not None:
            self.trace.emit(
                "crypto.flush.open",
                requests=len(reqs), backend="rpc", span=span,
            )
        self.metrics.gauge("crypto.rpc.queued", len(reqs))
        ok = False
        try:
            try:
                with self.metrics.timer("crypto.rpc.round_trip"):
                    sock.sendall(
                        encode_frame(
                            KIND_CRYPTO_REQ,
                            serde.dumps((req_id, "verify", tuple(items))),
                            self.max_frame_len,
                            kinds=CRYPTO_KINDS,
                        )
                    )
                    resp = self._read_resp(req_id)
            except (OSError, FrameError, serde.DecodeError):
                # timeout / death / garbage: the connection state is
                # unknown (a late response would desync req ids), so
                # drop it; the next flush re-dials after backoff.
                self._drop_conn()
                return self._local(reqs, "error")
            ok, verdict_bytes, flush_requests, flush_jobs = resp
            if not ok:
                # service alive but ITS flush failed: same degradation
                # as the in-thread arm — keep the connection.
                return self._local(reqs, "flush-failed")
            self.metrics.count("crypto.rpc.calls")
            self.metrics.count("crypto.rpc.requests", len(reqs))
            self.metrics.count("crypto.rpc.merged_requests", flush_requests)
            self.metrics.count("crypto.rpc.merged_jobs", flush_jobs)
            return [b != 0 for b in verdict_bytes]
        finally:
            self.metrics.gauge("crypto.rpc.queued", 0)
            if self.trace is not None:
                self.trace.emit(
                    "crypto.flush.done",
                    requests=len(reqs), backend="rpc", span=span, ok=ok,
                )

    def _encode_items(self, reqs: List[VerifyRequest]) -> List[Any]:
        # The common case (every payload a real suite object) costs one
        # serde encode later; only when something refuses to encode do
        # we probe per item and ship None placeholders.
        try:
            serde.dumps(tuple(reqs))
            return list(reqs)
        except Exception:
            items: List[Any] = []
            for r in reqs:
                try:
                    serde.dumps(r)
                    items.append(r)
                except Exception:
                    items.append(None)
            return items

    def _read_resp(self, req_id: int) -> Tuple[bool, bytes, int, int]:
        assert self._sock is not None and self._dec is not None
        deadline = time.monotonic() + self.timeout_s
        kind, payload = _recv_frame(self._sock, self._dec, deadline)
        if kind != KIND_CRYPTO_RESP:
            raise FrameError("expected crypto RESP")
        obj = serde.loads(payload, suite=self.suite)
        if (
            not isinstance(obj, tuple)
            or len(obj) != 6
            or obj[0] != req_id
            or obj[1] != "verify"
            or type(obj[2]) is not bool
            or type(obj[3]) is not bytes
            or type(obj[4]) is not int
            or type(obj[5]) is not int
        ):
            raise FrameError("malformed crypto RESP")
        return obj[2], obj[3], obj[4], obj[5]

    def _local(self, reqs: List[VerifyRequest], why: str) -> List[bool]:
        self.metrics.count("crypto.rpc.fallbacks")
        self.metrics.count("crypto.rpc.fallback_requests", len(reqs))
        self.metrics.count(f"crypto.rpc.fallback.{why}")
        return self.fallback.verify_batch(reqs)


def fetch_stats(
    addr: Tuple[str, int], suite: Any, timeout_s: float = 10.0
) -> Dict[str, Any]:
    """One-shot stats RPC (the parent/benchmark side of the JSON line)."""
    sock = socket.create_connection(addr, timeout=timeout_s)
    try:
        dec = FrameDecoder(kinds=CRYPTO_KINDS)
        deadline = time.monotonic() + timeout_s
        sock.sendall(_hello_frame(suite.name, MAX_FRAME_LEN))
        kind, payload = _recv_frame(sock, dec, deadline)
        if kind != KIND_CRYPTO_HELLO:
            raise FrameError("service HELLO expected")
        _check_hello(payload, suite.name)
        sock.sendall(
            encode_frame(
                KIND_CRYPTO_REQ,
                serde.dumps((1, "stats", None)),
                kinds=CRYPTO_KINDS,
            )
        )
        kind, payload = _recv_frame(sock, dec, deadline)
        if kind != KIND_CRYPTO_RESP:
            raise FrameError("expected crypto RESP")
        obj = serde.loads(payload, suite=suite)
        if (
            not isinstance(obj, tuple)
            or len(obj) != 3
            or obj[1] != "stats"
            or type(obj[2]) is not bytes
        ):
            raise FrameError("malformed stats RESP")
        return json.loads(obj[2])
    finally:
        sock.close()


# -- parent-side process handle ----------------------------------------------

class ServiceProcess:
    """Spawn/kill/restart handle for one service worker process.

    Spawn protocol: subprocess with a pipe stdin (the
    stop channel) + a stdout pump collecting the ready and summary
    lines.  ``kill()`` is a REAL SIGKILL (the mid-flush drill);
    ``restart()`` respawns on the OLD port so clients' bounded-backoff
    re-dials find the reborn listener without re-configuration.
    """

    def __init__(
        self,
        suite: str = "scalar",
        backend: Optional[str] = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        window_s: Optional[float] = None,
        max_batch: Optional[int] = None,
        python: str = sys.executable,
        stderr: str = "devnull",
        device: Optional[str] = None,
        ready_timeout_s: float = 60.0,
        env_overrides: Optional[Dict[str, str]] = None,
    ) -> None:
        self.suite_arg = suite
        self.backend_arg = backend or DEFAULT_BACKEND[suite]
        self.host = host
        self._want_port = port
        self.window_s = window_s
        self.max_batch = max_batch
        self.python = python
        self._stderr_mode = stderr
        self.device = device
        self.ready_timeout_s = ready_timeout_s
        self.env_overrides = dict(env_overrides or {})
        self.proc: Optional[subprocess.Popen] = None
        self.ready: Optional[dict] = None
        self.summary: Optional[dict] = None
        # The worker's plain (non-JSON) stdout lines, in order: its
        # backend-and-device line first.
        self.log: List[str] = []
        self._ready_evt = threading.Event()
        self._done_evt = threading.Event()
        self._pump_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self.ready["port"] if self.ready else None

    @property
    def addr(self) -> Tuple[str, int]:
        if not self.ready:
            raise RuntimeError("service process not started")
        return (self.host, self.ready["port"])

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def start(self) -> "ServiceProcess":
        self._spawn(self._want_port)
        got = self._ready_evt.wait(self.ready_timeout_s)
        if not got or self.ready is None:
            # no ready line: timed out, or the worker exited first (the
            # pump sets the event at EOF) — e.g. a torch worker with no
            # card
            rc = self.proc.poll() if self.proc else None
            self.stop()
            if got:
                raise RuntimeError(
                    f"crypto service exited before it was ready (rc={rc}, "
                    f"backend={self.backend_arg}, device={self.device}): "
                    + " | ".join(self.log[-3:])
                )
            raise TimeoutError(
                f"crypto service never printed its ready line (rc={rc})"
            )
        return self

    def _spawn(self, port: int) -> None:
        cmd = [
            self.python,
            "-m",
            "hbbft_tpu_torch.cryptoplane.proc_service",
            "--suite", self.suite_arg,
            "--backend", self.backend_arg,
            "--host", self.host,
            "--port", str(port),
        ]
        if self.window_s is not None:
            cmd += ["--window-s", str(self.window_s)]
        if self.max_batch is not None:
            cmd += ["--max-batch", str(self.max_batch)]
        if self.device is not None:
            cmd += ["--device", self.device]
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT
        env.update(self.env_overrides)
        self.ready = None
        self.summary = None
        self._ready_evt = threading.Event()
        self._done_evt = threading.Event()
        self.proc = subprocess.Popen(
            cmd,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=(
                subprocess.DEVNULL if self._stderr_mode == "devnull" else None
            ),
            text=True,
            env=env,
            cwd=_REPO_ROOT,
        )
        self._pump_thread = threading.Thread(
            target=self._pump, name="crypto-svc-pump", daemon=True
        )
        self._pump_thread.start()

    def _pump(self) -> None:
        proc = self.proc
        assert proc is not None and proc.stdout is not None
        for line in proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                self.log.append(line)
                continue
            if not isinstance(obj, dict):
                self.log.append(line)
                continue
            if obj.get("ready"):
                self.ready = obj
                self._ready_evt.set()
            elif "done" in obj:
                self.summary = obj
                self._done_evt.set()
        self._ready_evt.set()  # EOF: start() stops waiting for a ready line
        self._done_evt.set()

    def kill(self) -> None:
        """SIGKILL, no goodbyes: the mid-flush drill."""
        if self.proc is not None:
            self.proc.kill()

    def restart(self) -> None:
        """Respawn on the OLD port (clients re-attach via backoff dials)."""
        old_port = self.port
        if old_port is None:
            raise RuntimeError("restart() before a successful start()")
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self._spawn(old_port)
        if not self._ready_evt.wait(self.ready_timeout_s):
            raise TimeoutError("restarted crypto service never got ready")

    def stats(self) -> Dict[str, Any]:
        return fetch_stats(self.addr, _build_suite(self.suite_arg))

    def stop(self, grace_s: float = 10.0) -> None:
        proc = self.proc
        if proc is None:
            return
        if proc.poll() is None:
            try:
                if proc.stdin:
                    proc.stdin.write(json.dumps({"stop": True}) + "\n")
                    proc.stdin.flush()
            except (OSError, ValueError):
                pass
        try:
            if proc.stdin:
                proc.stdin.close()
        except OSError:
            pass
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5)

    def __enter__(self) -> "ServiceProcess":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


# -- worker entry ------------------------------------------------------------

def _watch_stdin(stop: threading.Event) -> None:
    """Drain stdin until a stop command or EOF (dead parent = EOF, so
    orphaned service processes tear down by themselves)."""
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            if json.loads(line).get("stop"):
                break
        except ValueError:
            continue
    stop.set()


def _device_name(backend: Any) -> str:
    dev = getattr(backend, "device", None)
    if dev is None or getattr(dev, "type", None) != "cuda":
        return ""
    import torch

    return f" ({torch.cuda.get_device_name(dev)})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", choices=("scalar", "bls"), default="scalar")
    ap.add_argument(
        "--backend",
        choices=("batched", "eager", "torch"),
        default=None,
        help="default: torch for the bls suite, batched for scalar",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="the torch backend's device (cuda; cpu runs its plain stages)",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument(
        "--port",
        type=int,
        default=0,
        help="listener port (0 = ephemeral; echoed in the ready line)",
    )
    ap.add_argument(
        "--window-s",
        type=float,
        default=default_window_s(),
        help="cross-client batching window (HBBFT_TORCH_CRYPTO_WINDOW_S)",
    )
    ap.add_argument("--max-batch", type=int, default=512)
    args = ap.parse_args(argv)
    args.backend = args.backend or DEFAULT_BACKEND[args.suite]

    suite = _build_suite(args.suite)
    try:
        backend = _build_backend(args.backend, suite, args.device)
    except RuntimeError as exc:
        print(f"crypto service: backend {args.backend} failed to start: {exc}",
              flush=True)
        return 2
    device = str(getattr(backend, "device", "host"))
    print(f"crypto service: backend {args.backend} ({type(backend).__name__}) "
          f"on {device}{_device_name(backend)}, suite {args.suite}", flush=True)
    stop = threading.Event()
    service = CryptoPlaneService(
        backend,
        window_s=args.window_s,
        max_batch=args.max_batch,
        on_device_error=lambda exc: stop.set(),
    )
    server = CryptoRpcServer(
        service, suite, host=args.host, port=args.port
    ).start()
    print(
        json.dumps(
            {
                "ready": True,
                "port": server.port,
                "suite": args.suite,
                "backend": args.backend,
                "device": device,
                "window_s": args.window_s,
                "pid": os.getpid(),
            },
            sort_keys=True,
        ),
        flush=True,
    )
    threading.Thread(target=_watch_stdin, args=(stop,), daemon=True).start()
    stop.wait()
    rc = 0
    if service.device_error is not None:
        print(f"crypto service: device flush failed, stopping: "
              f"{service.device_error!r}", flush=True)
        rc = 3
    m = service.metrics
    summary = {
        "done": True,
        "flushes": m.counters.get("crypto.flushes", 0),
        "requests": m.counters.get("crypto.requests", 0),
        "served_requests": m.counters.get("crypto.rpc.served_requests", 0),
        "accepts": m.counters.get("crypto.rpc.accepts", 0),
        "bad_frames": m.counters.get("crypto.rpc.bad_frames", 0),
        "flush_errors": m.counters.get("crypto.flush_errors", 0),
    }
    if args.backend == "torch":
        from hbbft_tpu_torch import build

        # the kernel launches of this worker's flushes (chip_smoke.py adds
        # them to its path's counts)
        summary["launches"] = dict(build.LAUNCHES)
    server.stop()
    try:
        print(json.dumps(summary, sort_keys=True), flush=True)
    except OSError:
        pass  # parent died first: the summary has no reader
    return rc


if __name__ == "__main__":
    sys.exit(main())
