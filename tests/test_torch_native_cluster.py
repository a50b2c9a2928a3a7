"""The port's engine-per-node cluster nodes against the reference.

``LocalCluster(node_impl="native")`` runs one C++ engine per node
(``hbbft_tpu_torch.transport.native_node.NativeClusterNode`` over the
port's ``TcpTransport`` wire hooks).  After the reference's
``tests/test_transport_native.py``:

* a native cluster with the workload submitted before ``start()``
  commits the same batches as the port's python-node cluster and as the
  reference's native cluster at the same seed (a dissenting pair is
  re-run, at most 3 times: a proposer that misses one epoch's cut under a
  scheduling outlier gives a different, agreement-safe history), and
  every node of a run agrees;
* a mixed cluster (native and python nodes) agrees; kill/restart,
  partition/heal and a disconnect on both coalescing settings recover;
  garbage payloads are counted, not handler errors;
* the port's engine accepts exactly the wire payloads the reference's
  Python codec accepts, over real traffic, every truncation and bit
  flips, and re-encodes each byte for byte; its MSGB walk agrees with
  the reference's grammar (``framing.validate_msgb``); its MSGB drain
  regroups the per-frame drain;
* the crypto-service arm (shares as opaque requests to one
  ``CryptoPlaneService``) commits what the inline arm commits.

Tolerance: exact.
"""

from __future__ import annotations

import ctypes
import importlib
import random

import pytest
from torch_low_priority import low_priority

from hbbft_tpu.crypto.suite import ScalarSuite as RefScalarSuite
from hbbft_tpu.protocols.sender_queue import SqMessage as RefSqMessage
from hbbft_tpu.transport import framing as ref_framing
from hbbft_tpu.utils import serde as ref_serde
from hbbft_tpu_torch import native_engine
from hbbft_tpu_torch.crypto.suite import ScalarSuite
from hbbft_tpu_torch.protocols.queueing_honey_badger import Input
from hbbft_tpu_torch.protocols.sender_queue import SqMessage
from hbbft_tpu_torch.transport import FaultInjector, LocalCluster, PartitionSpec
from hbbft_tpu_torch.transport.cluster import build_netinfo
from hbbft_tpu_torch.transport.framing import decode_msgb, msgb_body
from hbbft_tpu_torch.utils import serde

EPOCH_TIMEOUT_S = 45  # wall cap per driven phase; typical is < 2 s


def _lib():
    lib = native_engine.get_lib()
    assert lib is not None, "the port's engine did not build"
    return lib


def batch_keys(cluster, nid, upto=None, dumps=serde.dumps):
    bs = cluster.batches(nid)
    if upto is not None:
        bs = bs[:upto]
    return [(b.era, b.epoch, dumps(b.contributions)) for b in bs]


def drive(cluster, ids, target, timeout_s=EPOCH_TIMEOUT_S, tag="d"):
    cluster.drive_to(ids, target, timeout_s=timeout_s, tag=tag)


def _clean(c):
    m = c.merged_metrics()
    assert m.counters.get("cluster.handler_errors", 0) == 0
    assert m.counters.get("cluster.bad_payload", 0) == 0


def _presubmit_run(pkg, seed, rounds=6, target=4, **kwargs):
    """The reference's ``_run_arm``: the whole workload submitted before
    ``start()``, run until every node has ``target`` batches; returns each
    node's first ``target`` batch keys (contributions as that package's
    serde bytes)."""
    cluster = importlib.import_module(f"{pkg}.transport.cluster")
    qhb = importlib.import_module(f"{pkg}.protocols.queueing_honey_badger")
    dumps = importlib.import_module(f"{pkg}.utils.serde").dumps
    c = cluster.LocalCluster(4, seed=seed, **kwargs)
    for k in range(rounds):
        for i in range(4):
            c.submit(i, qhb.Input.user(f"tx-{k}-{i}"))
    c.start()
    try:
        ok = c.wait(lambda cl: all(len(cl.batches(i)) >= target for i in range(4)),
                    EPOCH_TIMEOUT_S)
        assert ok, {i: len(c.batches(i)) for i in range(4)}
        _clean(c)
        out = {i: batch_keys(c, i, upto=target, dumps=dumps) for i in range(4)}
    finally:
        c.stop()
    for i in range(1, 4):
        assert out[i] == out[0], f"{pkg} {kwargs}: nodes disagree at seed {seed}"
    return out[0]


def _alike(*runs):
    """Run each zero-argument run and compare; a dissenting set is re-run
    (at most 3 times in all)."""
    for _attempt in range(3):
        got = [run() for run in runs]
        if all(g == got[0] for g in got):
            return got[0]
    assert all(g == got[0] for g in got), got
    return got[0]


@pytest.mark.parametrize("seed", [42, 7])
@low_priority
def test_native_cluster_matches_python_nodes_and_reference(seed):
    _lib()
    _alike(
        lambda: _presubmit_run("hbbft_tpu_torch", seed, node_impl="native"),
        lambda: _presubmit_run("hbbft_tpu_torch", seed, node_impl="python"),
        lambda: _presubmit_run("hbbft_tpu", seed, node_impl="native"),
    )


@low_priority
def test_mixed_cluster_interop_agrees():
    """Half native, half python in one cluster: all four commit alike,
    and the batches are the reference's mixed cluster's."""
    _lib()
    mixed = {0: "native", 2: "native"}
    _alike(
        lambda: _presubmit_run("hbbft_tpu_torch", 17, node_impl=mixed),
        lambda: _presubmit_run("hbbft_tpu", 17, node_impl=mixed),
    )
    with LocalCluster(4, seed=17, node_impl=mixed) as c:
        drive(c, [0, 1, 2, 3], 3)
        want = batch_keys(c, 0, upto=3)
        for i in [1, 2, 3]:
            assert batch_keys(c, i, upto=3) == want
        _clean(c)


@low_priority
def test_native_kill_restart_continues_committing():
    _lib()
    with LocalCluster(4, seed=11, node_impl="native") as c:
        drive(c, [0, 1, 2, 3], 2)
        c.kill(3)
        base = len(c.batches(0))
        drive(c, [0, 1, 2], base + 2)
        c.restart(3)
        drive(c, [0, 1, 2], len(c.batches(0)) + 2, tag="post")
        want = batch_keys(c, 0, upto=4)
        for i in [1, 2]:
            assert batch_keys(c, i, upto=4) == want

        def reborn_accepted(cl):
            return sum(st["accepts"] for st in cl.nodes[3].transport.stats().values()) >= 1

        assert c.wait(reborn_accepted, 15)
        assert c.merged_metrics().counters.get("cluster.handler_errors", 0) == 0


@low_priority
def test_native_partition_heals_and_continues():
    _lib()
    inj = FaultInjector(seed=5)
    with LocalCluster(4, seed=13, injector=inj, node_impl="native") as c:
        drive(c, [0, 1, 2, 3], 2)
        inj.add_partition(PartitionSpec((frozenset([0, 1, 2]), frozenset([3])),
                                        start_s=inj.elapsed()))
        base = len(c.batches(0))
        drive(c, [0, 1, 2], base + 2, tag="part")
        assert inj.stats.partitioned > 0
        inj.heal_all()
        drive(c, [0, 1, 2], len(c.batches(0)) + 2, tag="heal")
        want = batch_keys(c, 0, upto=4)
        for i in [1, 2]:
            assert batch_keys(c, i, upto=4) == want


@pytest.mark.parametrize("coalesce", [True, False])
@low_priority
def test_native_churn_disconnect_reconnect_catches_up(coalesce):
    _lib()
    with LocalCluster(4, seed=7, node_impl="native",
                      transport_kwargs={"coalesce": coalesce}) as c:
        drive(c, [0, 1, 2, 3], 2)
        c.disconnect(3)
        base = len(c.batches(0))
        drive(c, [0, 1, 2], base + 3, tag="out")
        assert len(c.batches(3)) < len(c.batches(0))
        c.reconnect(3)
        target = len(c.batches(0))
        assert c.wait(lambda cl: len(cl.batches(3)) >= target, EPOCH_TIMEOUT_S)
        b0, b3 = batch_keys(c, 0), batch_keys(c, 3)
        kk = min(len(b0), len(b3))
        assert b3[:kk] == b0[:kk]
        keys = [(e, ep) for e, ep, _ in b3]
        assert len(keys) == len(set(keys))
        st = c.nodes[0].transport.stats()
        msgs = sum(s.get("msgs_out", 0) for s in st.values())
        frames = sum(s.get("frames_out", 0) for s in st.values())
        assert (msgs > frames > 0) if coalesce else (msgs == frames > 0)


def test_native_garbage_payload_is_bad_payload_not_handler_error():
    _lib()
    with LocalCluster(4, seed=61, node_impl="native") as c:
        node = c.nodes[0]
        node.inbox.put(("wire", 1, [(0, serde.dumps(7)), (0, b"\xff\xfe garbage"),
                                    (0, serde.dumps((b"x", [1, 2])))]))
        assert c.wait(lambda cl: cl.nodes[0].metrics.counters.get(
            "cluster.bad_payload", 0) >= 3, 10)
        assert node.metrics.counters.get("cluster.handler_errors", 0) == 0
        drive(c, [0, 1, 2, 3], 1)


@low_priority
def test_native_crypto_service_arm_commits_what_inline_commits():
    """Shares through one in-process ``CryptoPlaneService`` as opaque
    requests (the engine's external-crypto mode in each node) commit the
    inline arm's batches, with no fallback."""
    _lib()
    base = _presubmit_run("hbbft_tpu_torch", 5, node_impl="native")
    got = _alike(
        lambda: _presubmit_run("hbbft_tpu_torch", 5, node_impl="native", crypto="service"),
        lambda: base,
    )
    assert got == base


_FLAVOR_TAGS = [
    b"epoch_started", b"bc_value", b"bc_echo", b"bc_ready", b"bc_echohash",
    b"bc_candecode", b"ba_bval", b"ba_aux", b"ba_conf", b"ba_term",
    b"ba_coin", b"decmsg",
]


def _capture_wire_corpus(seed=42, target=2):
    """Every distinct payload a python-node cluster of the port put on
    the wire over ``target`` epochs."""
    c = LocalCluster(4, seed=seed)
    corpus = set()
    for node in c.nodes.values():
        orig, orig_many = node.transport.send, node.transport.send_many

        def send(dest, payload, _orig=orig):
            corpus.add(payload)
            return _orig(dest, payload)

        def send_many(items, _orig=orig_many):
            corpus.update(p for _, p in items)
            return _orig(items)

        node.transport.send, node.transport.send_many = send, send_many
    c.start()
    try:
        drive(c, [0, 1, 2, 3], target)
    finally:
        c.stop()
    return sorted(corpus)


def _ref_accepts(data):
    return isinstance(ref_serde.try_loads(data, suite=RefScalarSuite()), RefSqMessage)


def _port_accepts(data):
    return isinstance(serde.try_loads(data, suite=ScalarSuite()), SqMessage)


@low_priority
def test_wire_fuzz_parity_with_reference_codecs():
    """``hbe_wire_classify`` of the port's engine accepts exactly what the
    reference's Python codec (and the port's) accepts, over real traffic
    of every flavor, every truncation and bit flips, and
    ``hbe_wire_roundtrip`` re-encodes every payload byte for byte."""
    lib = _lib()
    corpus = _capture_wire_corpus()
    assert len(corpus) > 50
    flavors, samples = set(), []
    for payload in corpus:
        key = tuple(t for t in _FLAVOR_TAGS if t in payload)
        assert int(lib.hbe_wire_classify(payload, len(payload))) > 0
        assert _ref_accepts(payload) and _port_accepts(payload)
        buf = (ctypes.c_uint8 * (len(payload) + 64))()
        rc = int(lib.hbe_wire_roundtrip(payload, len(payload), buf, len(buf)))
        assert rc == len(payload) and bytes(buf[:rc]) == payload, key
        if key not in flavors:
            flavors.add(key)
            samples.append(payload)
    assert {t for k in flavors for t in k} >= {
        b"epoch_started", b"bc_value", b"bc_echo", b"bc_ready",
        b"ba_bval", b"ba_aux", b"ba_coin", b"decmsg",
    }
    rng = random.Random(1234)
    checked = 0

    def parity(data):
        nonlocal checked
        checked += 1
        native_ok = int(lib.hbe_wire_classify(data, len(data))) > 0
        assert native_ok == _ref_accepts(data) == _port_accepts(data), data

    for payload in samples:
        stride = max(1, len(payload) // 150)
        for cut in range(0, len(payload), stride):
            parity(payload[:cut])
        for _ in range(200):
            i = rng.randrange(len(payload))
            parity(payload[:i] + bytes([payload[i] ^ (1 << rng.randrange(8))])
                   + payload[i + 1:])
        parity(payload + b"\x00")
    assert checked > 1000
    for obj in (None, 0, b"bytes", "str", (1, 2), [1], {"k": 1}):
        parity(serde.dumps(obj))


def _msgb_engines():
    suite = ScalarSuite()
    producer = native_engine.NativeNodeEngine(
        0, build_netinfo(4, 1, 0, suite, 0), seed=0, batch_size=3,
        session_id=b"msgb-parity")
    consumer = native_engine.NativeNodeEngine(
        1, build_netinfo(4, 1, 0, suite, 1), seed=0, batch_size=3,
        session_id=b"msgb-parity")
    producer.handle_input(Input.user("msgb-tx"))
    producer.run()
    payloads = []
    producer.drain_egress(lambda d, p: payloads.append(p))
    assert len(payloads) >= 3
    return producer, consumer, payloads


def test_msgb_engine_grammar_parity_with_reference_validator():
    """The port's engine walks an MSGB body as the reference's
    ``framing.validate_msgb`` reads it: a rejected body is counted
    ``bad_payload``, an accepted one fully consumed, each message once."""
    _lib()
    _, consumer, payloads = _msgb_engines()
    k = min(len(payloads), 5)
    good = msgb_body(payloads[:k])
    assert good == ref_framing.msgb_body(payloads[:k])

    def ref_count(body):
        try:
            return ref_framing.validate_msgb(body)
        except ref_framing.FrameError:
            return None

    def engine_deltas(nm, body):
        before = consumer.stats()
        consumer.ingest_wire([0], [(nm, body)])
        after = consumer.stats()
        return (after["handled"] - before["handled"],
                after["bad_payload"] - before["bad_payload"])

    def nm_claim(body):
        return max(1, int.from_bytes(body[:4], "big")) if len(body) >= 4 else 1

    assert ref_count(good) == k
    assert engine_deltas(k, good) == (k, 0)
    hostile = [
        (k + 1).to_bytes(4, "big") + good[4:], good[: len(good) // 2], good + b"\x00\x07",
        (0).to_bytes(4, "big"), b"", good[:4] + (1 << 24).to_bytes(4, "big") + good[8:],
    ]
    for body in hostile:
        assert ref_count(body) is None
        assert engine_deltas(nm_claim(body), body)[1] >= 1
    assert engine_deltas(k + 1, good) == (0, k + 1)
    rng = random.Random(2020)
    cases = [good[:cut] for cut in range(len(good))]
    for _ in range(300):
        i = rng.randrange(min(len(good), 8))
        cases.append(good[:i] + bytes([good[i] ^ (1 << rng.randrange(8))]) + good[i + 1:])
    rejects = 0
    for body in cases:
        want = ref_count(body)
        handled, bad = engine_deltas(want if want is not None else nm_claim(body), body)
        if want is None:
            rejects += 1
            assert bad >= 1
        else:
            assert handled + bad == want
    assert rejects > 100


@pytest.mark.parametrize("max_body,batched", [(1 << 20, True), (1, False)])
def test_msgb_drain_matches_per_frame_drain(max_body, batched):
    _lib()
    suite = ScalarSuite()

    def fresh():
        eng = native_engine.NativeNodeEngine(
            0, build_netinfo(4, 1, 0, suite, 0), seed=0, batch_size=3,
            session_id=b"msgb-drain")
        eng.handle_input(Input.user("drain-tx"))
        eng.run()
        return eng

    per_frame = {}
    assert fresh().drain_egress(lambda d, p: per_frame.setdefault(d, []).append(p)) >= 3
    grouped, sizes = {}, []

    def emit(dest, nmsg, body):
        sizes.append(nmsg)
        grouped.setdefault(dest, []).extend(decode_msgb(body))

    fresh().drain_egress_msgb(emit, max_body)
    assert grouped == per_frame
    assert (max(sizes) > 1) == batched
