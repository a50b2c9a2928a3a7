"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  A CUDA kernel has no CPU or interpret mode, so
these tests skip without a card; run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the
shared conftest imports jax, which this file does not need).  Tolerance:
exact — byte-identical digests, Merkle levels and proofs; field elements equal as
canonical values mod P; points equal as canonical affine points (or both
the identity); verdicts equal.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from hbbft_tpu_torch import build
from hbbft_tpu_torch.crypto import keys
from hbbft_tpu_torch.crypto.backend import BatchedBackend, VerifyRequest
from hbbft_tpu_torch.crypto.bls import curve as oc
from hbbft_tpu_torch.crypto.bls.suite import BLSSuite, G2Elem
from hbbft_tpu_torch.crypto.device import backend as dbackend
from hbbft_tpu_torch.crypto.device import curve as dc
from hbbft_tpu_torch.crypto.device import fq
from hbbft_tpu_torch.crypto.device import pair as dpair
from hbbft_tpu_torch.crypto.device import pairing as dpairing
from hbbft_tpu_torch.crypto.device import scan as dscan
from hbbft_tpu_torch.crypto.device.backend import TorchBackend
from hbbft_tpu_torch.ops.device import dataplane as dp
from hbbft_tpu_torch.ops.device import keccak as K
from hbbft_tpu_torch.ops.merkle import MerkleTree

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("batch,m", [(1, 0), (33, 65), (1000, 135), (257, 136), (64, 1779)])
def test_keccak_kernel_matches_plain_and_hashlib(cuda, batch, m):
    """The sponge kernel against the plain sponge and hashlib, in one
    launch, on padded messages that start at an offset that is not
    8-byte aligned (the kernel takes any start address)."""
    rng = np.random.default_rng(batch + m)
    msgs = rng.integers(0, 256, size=(batch, m), dtype=np.uint8)
    aligned = K.pad_tensor(torch.as_tensor(msgs, device=cuda))
    offset = (batch + m) % 13
    flat = torch.zeros(aligned.numel() + offset, dtype=torch.uint8, device=cuda)
    flat[offset:] = aligned.reshape(-1)
    padded = flat[offset:].view(aligned.shape)
    build.reset_launches()
    got = K.sha3_256_kernel(padded)
    assert build.LAUNCHES[K.KERNEL] == 1
    assert torch.equal(got, K.sha3_256_padded(aligned))
    host = got.cpu().numpy()
    for i in range(0, batch, max(1, batch // 8)):
        assert host[i].tobytes() == hashlib.sha3_256(msgs[i].tobytes()).digest()


TREE_SHAPES = [(v, n, s) for v in (1, 3) for n in (1, 2, 3, 7, 10, 104)
               for s in (1, 134, 135, 136, 1778)] + [(104, 104, 1778)]


@pytest.mark.parametrize("values,n,s", TREE_SHAPES)
def test_merkle_tree_kernel_matches_plain_and_hashlib(cuda, values, n, s):
    """Every level of every tree, byte for byte, against the plain tree
    on the card and the host MerkleTree; the shards start at an offset
    that is not 16-byte aligned, in one launch."""
    rng = np.random.default_rng(values * 100_000 + n * 10_000 + s)
    shards = rng.integers(0, 256, size=(values, n, s), dtype=np.uint8)
    offset = (n + s) % 13
    flat = torch.zeros(shards.size + offset, dtype=torch.uint8, device=cuda)
    flat[offset:] = torch.as_tensor(shards.reshape(-1), device=cuda)
    on_card = flat[offset:].view(values, n, s)
    build.reset_launches()
    got = K.merkle_tree_kernel(on_card)
    assert build.LAUNCHES[K.TREE_KERNEL] == 1
    assert torch.equal(got, dp.tree_levels_plain(on_card, n))
    host = got.cpu().numpy()
    for v in sorted({0, values - 1}):
        tree = MerkleTree([shards[v, i].tobytes() for i in range(n)])
        assert host[v].tobytes() == b"".join(h for level in tree.levels for h in level)


def test_dataplane_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    values = [rng.integers(0, 256, 3000, dtype=np.uint8).tobytes() for _ in range(10)]
    build.reset_launches()
    on_card = dp.encode_and_prove(values, 4, 10, device=cuda)
    assert build.LAUNCHES[K.TREE_KERNEL] == 1  # leaves and every level
    assert build.LAUNCHES[K.KERNEL] == 0
    on_cpu = dp.encode_and_prove(values, 4, 10, device="cpu")
    assert on_card == on_cpu


def _canonical(limbs: torch.Tensor) -> list:
    return [fq.from_limbs_int(row) % fq.P for row in limbs.reshape(-1, fq.NL).cpu()]


def test_fq_mont_mul_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(49), "little") % (1 << 386) for _ in range(2048)]
    vals[:5] = [0, 1, fq.P - 1, fq.P, (1 << 386) - 1]
    a = torch.as_tensor(fq.ints_to_limbs_batch(vals), device=cuda)
    a[5, :35:3] = 4096  # limbs at the top of the range, value < 2^386
    a[5, 35] = 0
    b = a.flip(0).contiguous()
    build.reset_launches()
    got = fq.mont_mul(a, b)
    assert build.LAUNCHES[fq.KERNEL] == 1
    assert int(got.max()) < 2048 and int(got.min()) >= 0
    assert _canonical(got) == _canonical(fq.mont_mul_plain(a, b))
    # Broadcasting and a non-contiguous operand.
    one = fq.const("one", cuda)
    assert _canonical(fq.mont_mul(a[::2], one)) == _canonical(fq.mont_mul_plain(a[::2], one))


def _same_points(p, q, group) -> bool:
    frm, ops = (dc.g1_from_dev, oc.FQ_OPS) if group == 1 else (dc.g2_from_dev, oc.FQ2_OPS)
    return all(oc.jac_eq(ops, frm(p, i), frm(q, i)) for i in range(p[3].shape[0]))


def _subsets(suite):
    rng = random.Random(21)
    sks = keys.SecretKeySet.random(1, rng, suite)
    pks = sks.public_keys()
    sig = [VerifyRequest.sig_share(pks.public_key_share(i), b"doc %d" % (i % 2),
                                   sks.secret_key_share(i).sign(b"doc %d" % (i % 2)))
           for i in range(40)]
    ct = pks.public_key().encrypt(b"tx", rng)
    dec = VerifyRequest.dec_share(pks.public_key_share(2), ct,
                                  sks.secret_key_share(2).decryption_share(ct))
    forged = VerifyRequest.sig_share(pks.public_key_share(3), b"doc 1",
                                     keys.SignatureShare(G2Elem(oc._twist_sample_point()), suite))
    bad = VerifyRequest.sig_share(pks.public_key_share(4), b"doc 0",
                                  sks.secret_key_share(5).sign(b"doc 0"))
    return [sig[:30] + [VerifyRequest.ciphertext(ct), dec], sig[30:] + [forged], [bad]]


def test_scan_kernel_matches_plain_scan_stage(cuda):
    suite = BLSSuite()
    be = TorchBackend(suite, device=cuda)
    subsets = _subsets(suite)
    inp, pair_sub = be._scan_prep(subsets)
    plain_args, plain_pair_sub = be._scan_prep(subsets, kernel=False)
    assert pair_sub == plain_pair_sub
    # The G2 sums see a segment of one row and segments of odd counts.
    g2_rows = np.diff(inp.g2_pieces.cpu().numpy()[inp.g2_segments.cpu().numpy()]).tolist()
    assert g2_rows == [31, 11, 1]
    build.reset_launches()
    sub_ok, lhs, rhs = dscan.scan_stage_kernel(inp)
    torch.cuda.synchronize()
    assert {k: build.LAUNCHES[k] for k in dscan.KERNELS} == {
        dscan.G1_ROWS: 1, dscan.G2_ROWS: 1, dscan.G1_SUMS: 2, dscan.G2_SUMS: 2}
    want_ok, want_lhs, want_rhs = dbackend.scan_stage(*plain_args)
    assert sub_ok.tolist() == want_ok.tolist() == [True, False, True]
    assert _same_points(lhs, want_lhs, 1)
    assert _same_points(rhs, want_rhs, 2)


@pytest.mark.parametrize("piece_rows", [1, dscan.PIECE_ROWS, 100])
def test_scan_kernel_long_g1_leg_matches_plain(cuda, monkeypatch, piece_rows):
    """A G1 leg of 90 rows, longer than one ``scan_g1_sums`` block's 64
    points: with pieces of one row the second pass sums 90 pieces onto a
    running sum, with pieces of 100 rows the first pass does."""
    monkeypatch.setattr(dscan, "PIECE_ROWS", piece_rows)
    suite = BLSSuite()
    rng = random.Random(90)
    sks = keys.SecretKeySet.random(1, rng, suite)
    pks = sks.public_keys()
    shares = [sks.secret_key_share(i).sign(b"leg") for i in range(10)]
    subsets = [[VerifyRequest.sig_share(pks.public_key_share(i % 10), b"leg", shares[i % 10])
                for i in range(90)], _subsets(suite)[2]]
    be = TorchBackend(suite, device=cuda)
    inp, _ = be._scan_prep(subsets)
    plain_args, _ = be._scan_prep(subsets, kernel=False)
    pieces, segments = inp.g1_pieces.cpu().numpy(), inp.g1_segments.cpu().numpy()
    assert max(np.diff(pieces[segments]).tolist()) == 90
    build.reset_launches()
    sub_ok, lhs, rhs = dscan.scan_stage_kernel(inp)
    torch.cuda.synchronize()
    assert build.LAUNCHES[dscan.G1_SUMS] == 2
    want_ok, want_lhs, want_rhs = dbackend.scan_stage(*plain_args)
    assert sub_ok.tolist() == want_ok.tolist() == [True, True]
    assert _same_points(lhs, want_lhs, 1)
    assert _same_points(rhs, want_rhs, 2)


def test_pair_kernels_match_plain_pair_stage(cuda):
    """K3 against the plain pair stage on the card, on the pairs of the
    scan kernels: three subsets (one False, one with the forged point),
    then subsets of one and two requests as the bisection makes them."""
    suite = BLSSuite()
    be = TorchBackend(suite, device=cuda)
    subsets = _subsets(suite)
    for subs in (subsets, [subsets[0][:1], subsets[1][:2], subsets[2]]):
        _, lhs, rhs, pair_sub = be._scan(subs)
        build.reset_launches()
        fs = dpair.miller_values_kernel(lhs, rhs)
        got = dpair.pair_stage_kernel(lhs, rhs, pair_sub, len(subs))
        torch.cuda.synchronize()
        assert {k: build.LAUNCHES[k] for k in dpair.KERNELS} == {dpair.MILLER: 2, dpair.FINAL: 1}
        assert int(fs.min()) >= 0 and int(fs.max()) < 2048
        assert _canonical(fs) == _canonical(dpairing.miller_values(lhs, rhs))
        want = dbackend.pair_stage_plain(lhs, rhs, pair_sub, len(subs))
        assert got.tolist() == want.tolist()
        assert got[0] and not got[2]


def test_pair_kernels_at_sixteen_pairs_with_identities(cuda):
    """``pair_miller`` at 16 pairs, a mixed-512 level's most, with two
    G1-identity and two G2-identity pairs among them: Miller values equal
    the plain ones coefficient by coefficient (1 on the identity pairs),
    verdicts equal the plain pair stage's."""
    suite = BLSSuite()
    _, lhs, rhs, _ = TorchBackend(suite, device=cuda)._scan(_subsets(suite))
    n = lhs[3].shape[0]
    idx = torch.as_tensor([i % n for i in range(12)], device=cuda)
    g1_id = dc.g1_to_dev([(1, 1, 0)] * 2, cuda)
    g2_id = dc.g2_to_dev([((1, 0), (1, 0), (0, 0))] * 2, cuda)
    lhs16 = tuple(torch.cat([c[idx], i, c[:2]]).contiguous() for c, i in zip(lhs, g1_id))
    rhs16 = tuple(torch.cat([c[idx], c[2:4], i]).contiguous() for c, i in zip(rhs, g2_id))
    pair_sub = [i % 5 for i in range(16)]
    build.reset_launches()
    fs = dpair.miller_values_kernel(lhs16, rhs16)
    got = dpair.pair_stage_kernel(lhs16, rhs16, pair_sub, 5)
    torch.cuda.synchronize()
    assert build.LAUNCHES[dpair.MILLER] == 2
    assert int(fs.min()) >= 0 and int(fs.max()) < 2048
    assert _canonical(fs) == _canonical(dpairing.miller_values(lhs16, rhs16))
    for i in range(12, 16):
        assert [fq.from_mont_int(r) for r in fs[i].reshape(-1, fq.NL).cpu()] == [1] + [0] * 11
    assert got.tolist() == dbackend.pair_stage_plain(lhs16, rhs16, pair_sub, 5).tolist()


def test_torch_backend_on_card_matches_batched(cuda):
    suite = BLSSuite()
    reqs = [r for s in _subsets(suite) for r in s]
    build.reset_launches()
    got = TorchBackend(suite, device=cuda, chunk=16).verify_batch(reqs)
    assert got == BatchedBackend(suite).verify_batch(reqs)
    assert got.count(False) == 2
    assert all(build.LAUNCHES[k] > 0 for k in dpair.KERNELS + dscan.KERNELS)


def test_honey_badger_epoch_on_card_matches_host_backend(cuda):
    """A 4-node BLS HoneyBadger epoch whose every share check runs on the
    card (``TorchBackend``) commits the same batches, after the same
    deliveries and faults, as the same run on the host ``BatchedBackend``."""
    from hbbft_tpu_torch.net import NetBuilder
    from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule, HoneyBadger

    def run(factory):
        net = (
            NetBuilder(4, seed=6)
            .suite(BLSSuite())
            .backend(factory)
            .flush_every(100_000)
            .protocol(lambda ni, sink, rng: HoneyBadger(
                ni, sink, session_id=b"hb-card",
                encryption_schedule=EncryptionSchedule.always()))
            .build()
        )
        for nid in net.correct_ids:
            net.send_input(nid, [f"tx-{nid}-{i}" for i in range(4)])
        net.crank_until(lambda n: all(n.node(i).outputs for i in n.correct_ids))
        return net

    build.reset_launches()
    card = run(lambda s: TorchBackend(s))
    assert all(build.LAUNCHES[k] > 0 for k in dpair.KERNELS + dscan.KERNELS)
    host = run(BatchedBackend)
    for nid in card.correct_ids:
        assert card.node(nid).outputs == host.node(nid).outputs
        assert sorted((f.node_id, f.kind) for f in card.node(nid).faults) == sorted(
            (f.node_id, f.kind) for f in host.node(nid).faults)
    assert card.delivered == host.delivered
    assert card.correct_faults() == []


def test_queueing_honey_badger_epoch_on_card_matches_host_backend(cuda):
    """A 4-node BLS QueueingHoneyBadger epoch (the dynamic stack's era
    layer over HoneyBadger) whose every share check runs on the card
    commits the same batches, after the same deliveries and faults, as
    the same run on the host ``BatchedBackend``."""
    from hbbft_tpu_torch.net import NetBuilder
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import DhbBatch
    from hbbft_tpu_torch.protocols.queueing_honey_badger import Input, QueueingHoneyBadger

    def run(factory):
        net = (
            NetBuilder(4, seed=4).num_faulty(0)
            .suite(BLSSuite())
            .backend(factory)
            .flush_every(100_000)
            .protocol(lambda ni, sink, rng: QueueingHoneyBadger(
                ni, sink, batch_size=4, session_id=b"cfg4"))
            .build()
        )
        for nid in net.correct_ids:
            net.send_input(nid, Input.user(f"pre-{nid}"))
        net.crank_until(lambda n: all(
            any(isinstance(o, DhbBatch) for o in n.node(i).outputs) for i in n.correct_ids))
        return net

    def plain(net, nid):
        return [(b.era, b.epoch, b.contributions, b.change.kind)
                for b in net.node(nid).outputs if isinstance(b, DhbBatch)]

    build.reset_launches()
    card = run(lambda s: TorchBackend(s))
    assert all(build.LAUNCHES[k] > 0 for k in dpair.KERNELS + dscan.KERNELS)
    host = run(BatchedBackend)
    for nid in card.correct_ids:
        assert plain(card, nid) == plain(host, nid) and plain(card, nid)
        assert sorted((f.node_id, f.kind) for f in card.node(nid).faults) == sorted(
            (f.node_id, f.kind) for f in host.node(nid).faults)
    assert card.delivered == host.delivered
    assert card.correct_faults() == []


def test_sharded_flush_on_card_matches_unsharded(cuda):
    """``TorchBackend(devices=[cuda, cuda])`` (K7's counterpart, one card
    listed twice) on several chunks: the unsharded verdicts, and the same
    kernel launches."""
    suite = BLSSuite()
    reqs = [r for s in _subsets(suite) for r in s]
    build.reset_launches()
    want = TorchBackend(suite, device=cuda, chunk=8).verify_batch(reqs)
    plain = dict(build.LAUNCHES)
    build.reset_launches()
    got = TorchBackend(suite, devices=[cuda, cuda], chunk=8).verify_batch(reqs)
    assert got == want == BatchedBackend(suite).verify_batch(reqs)
    assert dict(build.LAUNCHES) == plain


def test_sharded_flush_across_cards_matches_unsharded(cuda):
    """``TorchBackend(devices=[cuda:0, cuda:1, ...])`` over every card:
    chunk k scanned on card k mod n, the pairs gathered on cuda:0, and
    the unsharded verdicts, rechecks and bisection of the bad chunks
    included, with the same kernel launches."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    suite = BLSSuite()
    reqs = [r for s in _subsets(suite) for r in s]
    build.reset_launches()
    want = TorchBackend(suite, device="cuda:0", chunk=8).verify_batch(reqs)
    plain = dict(build.LAUNCHES)
    be = TorchBackend(suite, devices=[f"cuda:{k}" for k in range(n)], chunk=8)
    be.load_kernels()
    scan, seen = be._scan, []

    def rec_scan(subsets, dev=None):
        out = scan(subsets, dev)
        seen.append((dev is not None, out[0].device.index))  # a chunk's, or a bisection's
        return out

    be._scan = rec_scan
    build.reset_launches()
    got = be.verify_batch(reqs)
    assert got == want == BatchedBackend(suite).verify_batch(reqs)
    assert not all(got)
    assert dict(build.LAUNCHES) == plain
    chunk_cards = [card for is_chunk, card in seen if is_chunk]
    assert len(chunk_cards) >= 2 and chunk_cards == [k % n for k in range(len(chunk_cards))]
    assert all(card == 0 for is_chunk, card in seen if not is_chunk)


def test_service_arm_cluster_on_card(cuda):
    """A live 4-validator BLS cluster over localhost TCP whose every share
    check the shared ``CryptoPlaneService`` merges into ``TorchBackend``
    flushes on the card: every node commits the same batch, the flushes
    launch the scan and pair kernels, and no client falls back."""
    from hbbft_tpu_torch.cryptoplane import CryptoPlaneService
    from hbbft_tpu_torch.protocols.queueing_honey_badger import Input
    from hbbft_tpu_torch.transport import LocalCluster

    suite = BLSSuite()
    backend = TorchBackend(suite, device=cuda)
    backend.load_kernels()
    service = CryptoPlaneService(backend, window_s=0.002)
    build.reset_launches()
    c = LocalCluster(4, seed=0, node_impl="python", suite=suite, crypto="service",
                     crypto_service=service)
    for i in range(4):
        c.submit(i, Input.user(f"tx-{i}"))
    c.start()
    try:
        assert c.wait(lambda cl: all(cl.batch_count(i) >= 1 for i in range(4)), 300)
        m = c.merged_metrics(fresh=True)
        first = [c.batches(i)[0] for i in range(4)]
    finally:
        c.stop()
        service.stop()
    assert all((b.era, b.epoch, b.contributions) == (first[0].era, first[0].epoch,
                                                      first[0].contributions) for b in first)
    assert m.counters.get("crypto.fallbacks", 0) == 0
    assert m.counters.get("crypto.flush_errors", 0) == 0
    assert m.counters.get("cluster.handler_errors", 0) == 0
    assert m.counters["crypto.flushes"] > 0
    assert all(build.LAUNCHES[k] >= m.counters["crypto.flushes"] for k in dpair.KERNELS)


def test_bls_cluster_defaults_to_the_card(cuda):
    """Named no backend, a BLS cluster's nodes (inline arm) and its
    in-process service verify with ``TorchBackend`` on the card."""
    from hbbft_tpu_torch.transport import LocalCluster

    suite = BLSSuite()
    c = LocalCluster(4, seed=0, suite=suite)
    try:
        assert all(isinstance(node.backend, TorchBackend) and node.backend.device.type == "cuda"
                   for node in c.nodes.values())
    finally:
        c.stop()
    c = LocalCluster(4, seed=0, suite=suite, crypto="service")
    try:
        be = c.crypto_service.backend
        assert isinstance(be, TorchBackend) and be.device.type == "cuda"
    finally:
        c.stop()


def test_corrupt_share_cluster_on_card_matches_host(cuda):
    """``chip_smoke.py`` phase 7 (b) at N = 4: a live BLS cluster whose node
    3 sends corrupt COIN and DECRYPT shares, every share check merged by
    the service into ``TorchBackend`` flushes on the card.  The card
    rejects only node 3's shares, by bisection, and every flush that holds
    a rejected share gives the host ``BatchedBackend``'s verdicts; the
    honest nodes agree and accuse only node 3."""
    from hbbft_tpu_torch.chaos import ChaosOracle, fault_entries
    from hbbft_tpu_torch.cryptoplane import CryptoPlaneService
    from hbbft_tpu_torch.transport import LocalCluster

    suite = BLSSuite()
    backend = TorchBackend(suite, device=cuda)
    backend.load_kernels()
    flushes = []
    card_verify = backend.verify_batch

    def logged(reqs):
        reqs = list(reqs)
        out = card_verify(reqs)
        flushes.append((reqs, list(out)))
        return out

    backend.verify_batch = logged
    service = CryptoPlaneService(backend, window_s=0.002)
    build.reset_launches()
    c = LocalCluster(4, seed=0, suite=suite, crypto="service", crypto_service=service,
                     byzantine={3: "corrupt-share"})
    try:
        c.start()
        oracle = ChaosOracle(c)
        oracle.assert_progress(extra=2, timeout_s=600)
        assert oracle.assert_safety() >= 2
        assert oracle.assert_attribution() > 0
        accused = {s for i in oracle.honest_ids for s, _ in fault_entries(c.nodes[i])}
        m = c.merged_metrics(fresh=True)
        signer3 = c.nodes[0].netinfo.public_key_share(3).to_bytes()
    finally:
        c.stop()
        service.stop()
    assert accused == {3}
    assert m.counters.get("chaos.tampered_shares", 0) > 0
    for key in ("crypto.fallbacks", "crypto.flush_errors", "cluster.handler_errors"):
        assert m.counters.get(key, 0) == 0, key
    bad = [k for k, (_, out) in enumerate(flushes) if not all(out)]
    assert bad
    for k in bad:
        reqs, out = flushes[k]
        assert all(r.kind != "ciphertext" and r.payload[0].to_bytes() == signer3
                   for r, ok in zip(reqs, out) if not ok)
    host = BatchedBackend(suite)
    for k in bad[:3]:
        reqs, out = flushes[k]
        assert host.verify_batch(reqs) == out
    assert all(build.LAUNCHES[k] >= len(flushes) for k in dpair.KERNELS)


def _native_bls_run(backend, suite):
    """The BLS engine at N = 4, seed 1, one epoch (the reference's
    ``test_native_ext_crypto.py`` run), deferred flushes; returns the run
    as plain data."""
    from hbbft_tpu_torch.native_engine import NativeQhbNet
    from hbbft_tpu_torch.protocols.queueing_honey_badger import Input
    from hbbft_tpu_torch.utils import serde

    nat = NativeQhbNet(4, seed=1, batch_size=8, num_faulty=1, session_id=b"qhb-test",
                       suite=suite, backend=backend, flush_every=0)
    for k in range(2):
        for nid in range(3):
            nat.send_input(nid, Input.user(f"tx-{nid}-{k}"))
    nat.run_until(lambda e: all(len(e.nodes[i].outputs) >= 1 for i in e.correct_ids),
                  chunk=200)
    out = dict(
        batches={i: [(b.era, b.epoch, serde.dumps(b.contributions))
                     for b in nat.nodes[i].outputs] for i in nat.correct_ids},
        faults={i: nat.faults(i) for i in range(4)},
        delivered=nat.delivered,
        flush_stats=dict(nat.flush_stats),
    )
    nat.close()
    return out


def test_native_bls_engine_on_card_matches_host_backend(cuda):
    """The native engine's external-crypto flush over ``TorchBackend`` on
    the card (``chip_smoke.py`` phase 8 at N = 4): the same batches,
    faults, deliveries and flush counts as over the host
    ``BatchedBackend``, and the scan and pair kernels launched on every
    flush the card answered."""
    suite = BLSSuite()
    backend = TorchBackend(suite, device=cuda)
    backend.load_kernels()
    flushes = []
    card_verify = backend.verify_batch

    def counted(reqs):
        flushes.append(len(reqs))
        return card_verify(reqs)

    backend.verify_batch = counted
    build.reset_launches()
    card = _native_bls_run(backend, suite)
    host = _native_bls_run(BatchedBackend(suite), suite)
    assert card == host
    assert all(not f for fs in card["faults"].values() for f in fs)
    assert flushes and all(build.LAUNCHES[k] >= len(flushes) for k in dpair.KERNELS)
    assert all(build.LAUNCHES[k] >= len(flushes) for k in dscan.KERNELS)
