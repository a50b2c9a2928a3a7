"""The port's crypto plane as a process (``hbbft_tpu_torch.cryptoplane.
proc_service``) against ``tests/test_cryptoplane_proc.py``.

* Wire identity: the HELLO, REQ and RESP frames of the port are the
  reference's bytes for the same requests, and each package's server
  answers the other's client.
* The RPC tier's unit drills: verdicts through the socket equal the local
  backend's, concurrent clients merge, the stats RPC, corrupt frames kill
  only their connection, a client fed garbage or silence falls back, and
  a device flush that raises is answered by no response at all.
* A ``ServiceProcess`` worker (``backend="batched"``) serves an N = 4
  ``"service-proc"`` cluster; the SIGKILL drill falls back and re-attaches;
  the flush spans pair by id; construction is validated.
* A ``"torch"`` worker with ``--device cuda`` on a machine without a card
  exits before it is ready, and ``ServiceProcess.start`` raises: the
  service never comes up serving from the CPU unless asked.  Named no
  backend, a BLS cluster and a BLS worker pick the card, and refuse to
  start without one.

Every wait is bounded and polls its condition; no fixed sleep stands in
for one.  ``ScalarSuite`` and the host ``BatchedBackend`` throughout.
"""

from __future__ import annotations

import random
import socket
import threading
import time

import pytest
import torch

import hbbft_tpu.wire  # noqa: F401  (the reference's "vreq" struct)
import hbbft_tpu_torch.wire  # noqa: F401  (the port's "vreq" struct)
from hbbft_tpu.crypto import keys as ref_keys
from hbbft_tpu.crypto.backend import VerifyRequest as RefRequest
from hbbft_tpu.crypto.suite import ScalarSuite as RefScalar
from hbbft_tpu.cryptoplane import proc_service as ref_ps
from hbbft_tpu.cryptoplane.service import CryptoPlaneService as RefService
from hbbft_tpu.crypto.backend import BatchedBackend as RefBatched
from hbbft_tpu.utils import serde as ref_serde
from hbbft_tpu_torch.crypto import keys as port_keys
from hbbft_tpu_torch.crypto.backend import BatchedBackend, VerifyRequest
from hbbft_tpu_torch.crypto.suite import ScalarSuite
from hbbft_tpu_torch.cryptoplane import CryptoPlaneService
from hbbft_tpu_torch.cryptoplane import proc_service as ps
from hbbft_tpu_torch.cryptoplane.proc_service import (
    CryptoRpcServer,
    RpcServiceClient,
    ServiceProcess,
    fetch_stats,
    parse_addr,
)
from hbbft_tpu_torch.protocols.queueing_honey_badger import Input
from hbbft_tpu_torch.transport import LocalCluster
from hbbft_tpu_torch.transport.framing import (
    CRYPTO_KINDS,
    KIND_CRYPTO_HELLO,
    KIND_CRYPTO_REQ,
    KIND_CRYPTO_RESP,
    KIND_MSG,
    FrameDecoder,
    FrameError,
    encode_frame,
)
from hbbft_tpu_torch.utils import serde
from hbbft_tpu_torch.utils.metrics import Metrics

EPOCH_TIMEOUT_S = 45  # wall cap per driven phase; typical is < 3 s


def _requests(keys_mod, Request, suite):
    """Good, bad and good again from one seed, in either package."""
    rng = random.Random(5)
    sks = keys_mod.SecretKeySet.random(1, rng, suite)
    pks = sks.public_keys()
    good = Request.sig_share(
        pks.public_key_share(0), b"doc", sks.secret_key_share(0).sign(b"doc"))
    bad = Request.sig_share(
        pks.public_key_share(1), b"doc", sks.secret_key_share(0).sign(b"doc"))
    ct = pks.public_key().encrypt(b"tx", rng)
    dec = Request.dec_share(pks.public_key_share(2), ct,
                            sks.secret_key_share(2).decryption_share(ct))
    return [good, bad, Request.ciphertext(ct), dec, good]


def _scalar_fixture():
    suite = ScalarSuite()
    good, bad = _requests(port_keys, VerifyRequest, suite)[:2]
    return suite, good, bad


def _server(suite, **kw):
    svc = CryptoPlaneService(BatchedBackend(suite), window_s=0.0, **kw)
    return CryptoRpcServer(svc, suite).start()


def _until(cond, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _converse(addr, frames, n_replies):
    """Send ``frames`` one at a time on a raw socket, reading one reply
    frame after each; returns the replies' raw bytes."""
    out = []
    with socket.create_connection(addr, timeout=10) as s:
        s.settimeout(10)
        buf = b""
        for f in frames[:n_replies]:
            s.sendall(f)
            while True:
                if len(buf) >= 4:
                    n = 8 + int.from_bytes(buf[:4], "big")
                    if len(buf) >= n:
                        out.append(buf[:n])
                        buf = buf[n:]
                        break
                data = s.recv(1 << 16)
                assert data, "server closed the connection"
                buf += data
    return out


# ---------------------------------------------------------------------------
# wire identity with the reference
# ---------------------------------------------------------------------------


def test_hello_and_rpc_frames_identical_to_reference():
    suite, rsuite = ScalarSuite(), RefScalar()
    assert ps.RPC_VERSION == ref_ps.RPC_VERSION
    assert ps._hello_frame(suite.name, ps.MAX_FRAME_LEN) == ref_ps._hello_frame(
        rsuite.name, ref_ps.MAX_FRAME_LEN)
    port_reqs = _requests(port_keys, VerifyRequest, suite)
    ref_reqs = _requests(ref_keys, RefRequest, rsuite)
    port_req = encode_frame(KIND_CRYPTO_REQ, serde.dumps((7, "verify", tuple(port_reqs))),
                            kinds=CRYPTO_KINDS)
    from hbbft_tpu.transport import framing as ref_framing

    ref_req = ref_framing.encode_frame(
        ref_framing.KIND_CRYPTO_REQ, ref_serde.dumps((7, "verify", tuple(ref_reqs))),
        kinds=ref_framing.CRYPTO_KINDS)
    assert port_req == ref_req
    # Each package's server answers the same conversation with the same
    # bytes, and answers the other package's request bytes alike.
    port_srv = _server(suite)
    ref_srv = ref_ps.CryptoRpcServer(
        RefService(RefBatched(rsuite), window_s=0.0), rsuite).start()
    try:
        hello = ps._hello_frame(suite.name, ps.MAX_FRAME_LEN)
        convo = [hello, port_req]
        a = _converse((port_srv.host, port_srv.port), convo, 2)
        b = _converse((ref_srv.host, ref_srv.port), convo, 2)
    finally:
        port_srv.stop()
        ref_srv.stop()
    assert a == b
    dec = FrameDecoder(kinds=CRYPTO_KINDS)
    dec.feed(a[1])
    kind, payload = dec.next_frame()
    assert kind == KIND_CRYPTO_RESP
    assert serde.loads(payload, suite=suite) == (
        7, "verify", True, bytes([1, 0, 1, 1, 1]), 5, 1)


def test_rpc_verdicts_identical_to_local_backend():
    suite, good, bad = _scalar_fixture()
    junk = VerifyRequest("sig_share", (object(), b"m", object()))
    batch = [good, bad, good, junk, bad]
    server = _server(suite)
    try:
        cli = RpcServiceClient(
            (server.host, server.port), suite, BatchedBackend(suite),
            metrics=Metrics(),
        )
        want = BatchedBackend(suite).verify_batch(batch)
        assert cli.verify_batch(batch) == want == [True, False, True, False, False]
        assert cli.metrics.counters["crypto.rpc.calls"] == 1
        assert cli.metrics.counters.get("crypto.rpc.fallbacks", 0) == 0
        assert cli.verify_batch([]) == []
        assert cli.metrics.counters["crypto.rpc.merged_requests"] >= 4
    finally:
        server.stop()


def test_rpc_concurrent_clients_merge_into_one_flush():
    suite, good, bad = _scalar_fixture()
    svc = CryptoPlaneService(BatchedBackend(suite), window_s=0.1)
    server = CryptoRpcServer(svc, suite).start()
    try:
        out = {}
        barrier = threading.Barrier(3)

        def worker(i):
            cli = RpcServiceClient(
                (server.host, server.port), suite, BatchedBackend(suite),
                client_id=f"c{i}",
            )
            barrier.wait()
            out[i] = (cli.verify_batch([good, bad, good]),
                      cli.metrics.counters.get("crypto.rpc.merged_requests", 0))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(out[i][0] == [True, False, True] for i in range(3)), out
        assert max(out[i][1] for i in range(3)) >= 6, out
    finally:
        server.stop()


def test_stats_rpc_and_parse_addr():
    suite, good, _ = _scalar_fixture()
    server = _server(suite)
    try:
        cli = RpcServiceClient((server.host, server.port), suite, BatchedBackend(suite))
        assert cli.verify_batch([good]) == [True]
        stats = fetch_stats((server.host, server.port), suite)
        assert stats["counters"]["crypto.rpc.served_requests"] == 1
        assert stats["counters"]["crypto.flushes"] == 1
    finally:
        server.stop()
    assert parse_addr("127.0.0.1:9999") == ("127.0.0.1", 9999)
    for bad_spec in ("nohost", ":123", "host:", "host:abc"):
        with pytest.raises(ValueError):
            parse_addr(bad_spec)


# ---------------------------------------------------------------------------
# framing fuzz: garbage kills connections, never the plane
# ---------------------------------------------------------------------------


def _dial_raw(server) -> socket.socket:
    s = socket.create_connection((server.host, server.port), timeout=5)
    s.settimeout(5)
    return s


def _poisoned(sock: socket.socket) -> bool:
    try:
        return sock.recv(4096) == b""
    except OSError:
        return True


def test_server_survives_corrupt_frames():
    suite, good, _ = _scalar_fixture()
    server = _server(suite)
    try:
        hello = serde.dumps((1, suite.name))
        attacks = []
        s = _dial_raw(server)
        s.sendall(b"\xff" * 64)  # raw garbage
        attacks.append(s)
        s = _dial_raw(server)
        s.sendall(encode_frame(KIND_MSG, b"x" * 10))  # consensus-plane kind
        attacks.append(s)
        s = _dial_raw(server)
        s.sendall((1 << 30).to_bytes(4, "big") + b"\x00" * 16)  # oversized
        attacks.append(s)
        s = _dial_raw(server)  # valid HELLO, then a REQ that is not serde
        s.sendall(encode_frame(KIND_CRYPTO_HELLO, hello, kinds=CRYPTO_KINDS))
        dec = FrameDecoder(kinds=CRYPTO_KINDS)
        while dec.next_frame() is None:
            dec.feed(s.recv(4096))
        s.sendall(encode_frame(KIND_CRYPTO_REQ, b"\x99not-serde", kinds=CRYPTO_KINDS))
        attacks.append(s)
        s = _dial_raw(server)  # wrong-suite HELLO
        s.sendall(encode_frame(KIND_CRYPTO_HELLO, serde.dumps((1, "bls12-381")),
                               kinds=CRYPTO_KINDS))
        attacks.append(s)
        s = _dial_raw(server)  # half a header, then close
        s.sendall(b"\x00\x00")
        s.close()
        for s in attacks:
            assert _poisoned(s)
            s.close()
        assert _until(lambda: server.metrics.counters.get("crypto.rpc.bad_frames", 0) >= 4)
        cli = RpcServiceClient((server.host, server.port), suite, BatchedBackend(suite))
        assert cli.verify_batch([good]) == [True]
        assert cli.metrics.counters.get("crypto.rpc.fallbacks", 0) == 0
    finally:
        server.stop()


class _EvilService:
    """Handshakes correctly, then answers every REQ with the given bytes."""

    def __init__(self, suite, responses):
        self.suite = suite
        self.responses = list(responses)
        self._listener = socket.socket()
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(8)
        self.addr = self._listener.getsockname()[:2]
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while self.responses:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            try:
                sock.settimeout(5)
                dec = FrameDecoder(kinds=CRYPTO_KINDS)
                while True:
                    f = dec.next_frame()
                    if f is not None:
                        if f[0] == KIND_CRYPTO_HELLO:
                            sock.sendall(encode_frame(
                                KIND_CRYPTO_HELLO, serde.dumps((1, self.suite.name)),
                                kinds=CRYPTO_KINDS))
                        else:
                            sock.sendall(self.responses.pop(0))
                            break
                        continue
                    data = sock.recv(1 << 16)
                    if not data:
                        break
                    dec.feed(data)
            except (OSError, FrameError):
                pass
            finally:
                sock.close()

    def close(self):
        self._listener.close()


def test_client_falls_back_on_malformed_responses():
    suite, good, bad = _scalar_fixture()
    evil = _EvilService(suite, [
        b"\xff" * 32,
        encode_frame(KIND_MSG, b"zzz"),
        encode_frame(KIND_CRYPTO_RESP, serde.dumps((999, "verify", True, b"\x01", 1, 1)),
                     kinds=CRYPTO_KINDS),
        encode_frame(KIND_CRYPTO_RESP, serde.dumps((1, "verify")), kinds=CRYPTO_KINDS),
    ])
    try:
        cli = RpcServiceClient(evil.addr, suite, BatchedBackend(suite),
                               timeout_s=5.0, reconnect_backoff_s=0.0)
        for k in range(4):
            assert cli.verify_batch([good, bad]) == [True, False], k
        assert cli.metrics.counters["crypto.rpc.fallbacks"] == 4
    finally:
        evil.close()


def test_client_times_out_on_silent_service_and_recovers():
    suite, good, _ = _scalar_fixture()
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(8)
    addr = listener.getsockname()[:2]
    conns = []

    def accept_and_hold():
        try:
            while True:
                sock, _ = listener.accept()
                sock.settimeout(5)
                dec = FrameDecoder(kinds=CRYPTO_KINDS)
                while dec.next_frame() is None:
                    dec.feed(sock.recv(1 << 16))
                sock.sendall(encode_frame(KIND_CRYPTO_HELLO, serde.dumps((1, suite.name)),
                                          kinds=CRYPTO_KINDS))
                conns.append(sock)  # then go silent
        except OSError:
            return

    threading.Thread(target=accept_and_hold, daemon=True).start()
    try:
        cli = RpcServiceClient(addr, suite, BatchedBackend(suite), timeout_s=0.5)
        t0 = time.monotonic()
        assert cli.verify_batch([good]) == [True]
        assert 0.4 < time.monotonic() - t0 < 10.0
        assert cli.metrics.counters["crypto.rpc.fallbacks"] == 1
    finally:
        listener.close()
        for s in conns:
            s.close()


def test_server_answers_no_request_after_a_device_flush_error():
    """Behind the RPC boundary, a device flush that raises drops the
    connection unanswered and fires the service's hook, on which the
    worker process stops; the client's fallback is the dead service's."""
    suite, good, bad = _scalar_fixture()

    class BrokenDevice(BatchedBackend):
        on_device = True

        def verify_batch(self, reqs):
            raise RuntimeError("kernel launch failed")

    stopped = threading.Event()
    svc = CryptoPlaneService(
        BrokenDevice(suite), window_s=0.0,
        on_device_error=lambda exc: stopped.set(),
    )
    server = CryptoRpcServer(svc, suite).start()
    try:
        cli = RpcServiceClient((server.host, server.port), suite,
                               BatchedBackend(suite), timeout_s=10.0)
        assert cli.verify_batch([good, bad]) == [True, False]
        assert stopped.is_set()
        assert cli.metrics.counters["crypto.rpc.fallback.error"] == 1
        assert svc.metrics.counters["crypto.flush_errors"] == 1
        assert svc.metrics.counters.get("crypto.flushes", 0) == 0
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the worker process serving a cluster
# ---------------------------------------------------------------------------


def _keys(c, nid, upto):
    return [(b.era, b.epoch, serde.dumps(b.contributions)) for b in c.batches(nid)[:upto]]


def test_service_process_serves_service_proc_cluster():
    suite = ScalarSuite()
    with ServiceProcess(suite="scalar", backend="batched") as svc:
        assert svc.ready["backend"] == "batched"
        assert svc.log and "backend batched" in svc.log[0], svc.log
        c = LocalCluster(4, seed=0, crypto="service-proc", crypto_service=svc)
        for k in range(6):
            for i in range(4):
                c.submit(i, Input.user(f"tx-{k}-{i}"))
        c.start()
        try:
            assert c.wait(lambda cl: all(len(cl.batches(i)) >= 4 for i in range(4)),
                          EPOCH_TIMEOUT_S), {i: len(c.batches(i)) for i in range(4)}
            m = c.merged_metrics(fresh=True)
            want = _keys(c, 0, 4)
            assert all(_keys(c, i, 4) == want for i in (1, 2, 3))
        finally:
            c.stop()
        assert svc.alive  # a pre-started service outlives the cluster
        stats = fetch_stats(svc.addr, suite)["counters"]
    assert m.counters.get("cluster.handler_errors", 0) == 0
    assert m.counters.get("crypto.rpc.calls", 0) > 0
    assert m.counters.get("crypto.rpc.fallbacks", 0) == 0
    assert stats["crypto.flushes"] > 0
    assert stats["crypto.rpc.served_requests"] == m.counters["crypto.rpc.requests"]


def test_service_process_sigkill_fallback_and_reattach():
    with LocalCluster(
        4, seed=3, node_impl="python", crypto="service-proc",
        service_kwargs=dict(timeout_s=2.0),
    ) as c:
        c.drive_to([0, 1, 2, 3], 2, timeout_s=EPOCH_TIMEOUT_S)
        pre = dict(c.merged_metrics(fresh=True).counters)
        assert pre.get("crypto.rpc.calls", 0) > 0  # the service WAS serving
        c.crypto_service.kill()
        c.drive_to([0, 1, 2, 3], 4, timeout_s=EPOCH_TIMEOUT_S, tag="post")
        m = c.merged_metrics(fresh=True)
        assert m.counters.get("cluster.handler_errors", 0) == 0
        assert m.counters.get("crypto.rpc.fallbacks", 0) > 0
        # an honest-only cluster logs no protocol fault through the flip
        for i in range(4):
            assert not c.nodes[i].faults, i
        want = _keys(c, 0, 4)
        assert all(_keys(c, i, 4) == want for i in (1, 2, 3))
        c.crypto_service.restart()  # waits for the reborn worker's ready line
        # drive until a flush after the clients' dial backoff re-attaches
        target, deadline = 5, time.monotonic() + 30
        while c.merged_metrics(fresh=True).counters.get("crypto.rpc.reconnects", 0) == 0:
            assert time.monotonic() < deadline, dict(c.merged_metrics(fresh=True).counters)
            c.drive_to([0, 1, 2, 3], target, timeout_s=EPOCH_TIMEOUT_S, tag=f"reborn{target}")
            target += 1
        m = c.merged_metrics(fresh=True)
        assert m.counters.get("cluster.handler_errors", 0) == 0
        want = _keys(c, 0, target - 1)
        assert all(_keys(c, i, target - 1) == want for i in (1, 2, 3))


def test_flush_spans_on_cryptoplane_track_pair_by_id():
    from hbbft_tpu_torch.obs.analyze import _flush_spans

    with LocalCluster(4, seed=0, crypto="service-proc") as c:
        c.drive_to([0, 1, 2, 3], 2, timeout_s=EPOCH_TIMEOUT_S)
        tracks = c.trace_events()
    evs = tracks.get("cryptoplane")
    assert evs, sorted(tracks)
    opens = [e for e in evs if e.name == "crypto.flush.open"]
    dones = [e for e in evs if e.name == "crypto.flush.done"]
    assert opens and dones
    assert all(e.args.get("span") for e in opens + dones)
    assert all(e.args.get("backend") == "rpc" for e in opens)
    spans = _flush_spans(tracks)
    assert spans and all(t1 >= t0 for t0, t1 in spans)
    done_ids = {e.args["span"] for e in dones}
    assert len(spans) == sum(1 for e in opens if e.args["span"] in done_ids)


def test_cluster_construction_validation():
    with pytest.raises(ValueError, match="unknown crypto arm"):
        LocalCluster(4, crypto="service-rpc")
    with pytest.raises(ValueError, match="service_kwargs"):
        LocalCluster(4, crypto="service-proc", crypto_service=("127.0.0.1", 1),
                     service_kwargs=dict(backend="x"))


# ---------------------------------------------------------------------------
# no card: a torch worker refuses to start
# ---------------------------------------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_torch_worker_without_a_card_fails_to_start():
    svc = ServiceProcess(suite="bls", backend="torch", device="cuda",
                         env_overrides={"CUDA_VISIBLE_DEVICES": ""})
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited before it was ready"):
        svc.start()
    assert time.monotonic() - t0 < svc.ready_timeout_s  # it did not wait it out
    assert not svc.alive and svc.proc.returncode != 0
    assert any("no CUDA device" in line for line in svc.log), svc.log
    # the same refusal through the cluster's service-proc arm
    with pytest.raises(RuntimeError, match="exited before it was ready"):
        LocalCluster(4, seed=0, crypto="service-proc",
                     service_kwargs=dict(backend="torch", device="cuda",
                                         env_overrides={"CUDA_VISIBLE_DEVICES": ""}))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_bls_defaults_to_the_card_and_refuses_without_one():
    """Named no backend, a BLS cluster verifies on the card, in its nodes,
    its in-process service or its service process; with no card each arm
    refuses to start.  The scalar suite, which has no device path, and a
    caller who names the host backend get ``BatchedBackend``."""
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite

    suite = BLSSuite()
    no_card = {"CUDA_VISIBLE_DEVICES": ""}
    for crypto in ("inline", "service"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LocalCluster(4, seed=0, suite=suite, crypto=crypto)
    svc = ServiceProcess(suite="bls", env_overrides=no_card)
    assert svc.backend_arg == "torch"
    with pytest.raises(RuntimeError, match="exited before it was ready"):
        svc.start()
    assert any("no CUDA device" in line for line in svc.log), svc.log
    with pytest.raises(RuntimeError, match="exited before it was ready"):
        LocalCluster(4, seed=0, suite=suite, crypto="service-proc",
                     service_kwargs=dict(env_overrides=no_card))
    assert ServiceProcess(suite="scalar").backend_arg == "batched"
    for c in (LocalCluster(4, seed=0, suite=suite, backend_factory=BatchedBackend),
              LocalCluster(4, seed=0)):
        assert all(type(node.backend) is BatchedBackend for node in c.nodes.values())
        c.stop()
