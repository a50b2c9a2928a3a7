"""The port's SyncKeyGen against the JAX package's, message by message.

A whole in-process DKG (``tests/test_sync_key_gen.py``'s ``_run_dkg``) is
run in both packages from the same seed: the same ``Part`` and ``Ack``
bytes (``serde.dumps``, which covers the encrypted rows and values and the
bivariate commitment), the same ``PartOutcome``/``AckOutcome`` faults,
including a dealer that corrupts one row, a forged ack, an acker that
corrupts one node's value and malformed parts and acks, and the same
generated ``PublicKeySet`` bytes and secret shares.  Over ScalarSuite the
reference is run twice: as it loads (its native DKG engine where that is
built) and pinned to its pure-Python path, as its own tests pin it
(``monkeypatch`` of ``_NATIVE_DKG``).  One case runs over BLS12-381 at
N = 4, threshold 1.  Every comparison is exact.
"""

import importlib
import random

import pytest

from torch_low_priority import low_priority

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _suite(pkg, name):
    if name == "bls":
        return _mod(pkg, "crypto.bls.suite").BLSSuite()
    return _mod(pkg, "crypto.suite").ScalarSuite()


def _dkg(pkg, n, t, seed, suite_name="scalar", corrupt=None, observer=False):
    """A full DKG among ``n`` nodes (plus an observer), every message
    handled by every node in dealer order; ``corrupt`` names the fault
    injected.  Returns the transcript as plain data."""
    suite = _suite(pkg, suite_name)
    keys = _mod(pkg, "crypto.keys")
    skg_m = _mod(pkg, "protocols.sync_key_gen")
    dumps = _mod(pkg, "utils.serde").dumps
    rng = random.Random(seed)
    sks = {i: keys.SecretKey.random(rng, suite) for i in range(n)}
    pks = {i: sks[i].public_key() for i in range(n)}
    ids = list(range(n)) + (["obs"] if observer else [])
    nodes, parts = {}, {}
    for i in ids:
        sk = sks.get(i) or keys.SecretKey.random(rng, suite)
        nodes[i], part = skg_m.SyncKeyGen.new(i, sk, pks, t, rng, suite)
        if part is not None:
            parts[i] = part
    log = [("part", d, dumps(parts[d])) for d in sorted(parts)]
    acks = []
    for dealer in sorted(parts):
        part = parts[dealer]
        if corrupt == "row" and dealer == n - 1:
            rows = list(part.rows)
            rng2 = random.Random(99)
            rows[0] = keys.SecretKey.random(rng2, suite).public_key().encrypt(b"garbage", rng2)
            part = skg_m.Part(part.commitment, tuple(rows))
        for i in ids:
            out = nodes[i].handle_part(dealer, part, rng)
            log.append(("part-outcome", i, dealer, out.fault,
                        None if out.ack is None else dumps(out.ack)))
            if out.ack is not None:
                ack = out.ack
                if corrupt == "ack-slot" and i == n - 1:
                    vals = list(ack.values)
                    vals[1] = pks[1].encrypt(dumps(12345), rng)
                    ack = skg_m.Ack(ack.proposer, tuple(vals))
                if corrupt == "forged-ack" and i == 0 and dealer == 1:
                    ack = skg_m.Ack(ack.proposer,
                                    tuple(pks[j].encrypt(b"\x00" * 8, rng) for j in range(n)))
                acks.append((i, ack))
    for sender, ack in acks:
        for i in ids:
            log.append(("ack-outcome", sender, i, nodes[i].handle_ack(sender, ack).fault))
    for i in ids:
        skg = nodes[i]
        log.append(("state", i, skg.count_complete(), skg.is_ready(),
                    [skg.is_node_ready(d) for d in sorted(parts)]))
        if skg.is_ready():
            pk_set, share = skg.generate()
            log.append(("keys", i, pk_set.to_bytes(), None if share is None else share.x))
    return log


def _malformed(pkg):
    """Malformed parts and acks (``test_malformed_part_and_ack_fault_
    instead_of_crash``) and the unknown-sender / ack-before-part faults."""
    suite = _suite(pkg, "scalar")
    keys = _mod(pkg, "crypto.keys")
    skg_m = _mod(pkg, "protocols.sync_key_gen")
    BivarCommitment = _mod(pkg, "crypto.poly").BivarCommitment
    rng = random.Random(7)
    sks = {i: keys.SecretKey.random(rng, suite) for i in range(4)}
    pks = {i: sks[i].public_key() for i in range(4)}
    skg, part = skg_m.SyncKeyGen.new(0, sks[0], pks, 1, rng, suite)
    Part, Ack = skg_m.Part, skg_m.Ack
    log = [skg.handle_ack(1, Ack(0, part.rows)).fault,  # before any part
           skg.handle_part("stranger", part, rng).fault]
    for bad in (42, Part(commitment="junk", rows=(1, 2, 3, 4)),
                Part(commitment=BivarCommitment(elems=5), rows=part.rows),
                Part(part.commitment, rows=("a",) * 4), Part(part.commitment, rows=part.rows[:2])):
        log.append(skg.handle_part(1, bad, rng).fault)
    log.append(skg.handle_part(0, part, rng).fault)
    log.append(skg.handle_part(0, part, rng).fault)  # duplicate
    other = skg_m.SyncKeyGen.new(2, sks[2], pks, 1, rng, suite)[1]
    log.append(skg.handle_part(0, other, rng).fault)  # a second, different part
    for bad in ("junk", Ack(proposer=[], values=part.rows), Ack(proposer=0, values=5),
                Ack(proposer=0, values=("x",) * 4), Ack(proposer=0, values=part.rows[:1])):
        log.append(skg.handle_ack(1, bad).fault)
    log.append(skg.handle_ack("stranger", Ack(0, part.rows)).fault)
    return log


CASES = {
    "full_n4_t1": dict(n=4, t=1, seed=7),
    "full_n7_t2": dict(n=7, t=2, seed=11),
    "observer_n4_t1": dict(n=4, t=1, seed=7, observer=True),
    "corrupted_row": dict(n=4, t=1, seed=7, corrupt="row"),
    "forged_ack": dict(n=4, t=1, seed=7, corrupt="forged-ack"),
    "corrupted_ack_slot": dict(n=4, t=1, seed=5, corrupt="ack-slot"),
}


@pytest.mark.parametrize("ref_path", ["as_loaded", "pure"])
@pytest.mark.parametrize("case", sorted(CASES))
@low_priority
def test_dkg_transcript_identity(case, ref_path, monkeypatch):
    if ref_path == "pure":
        monkeypatch.setattr(_mod("hbbft_tpu", "protocols.sync_key_gen"), "_NATIVE_DKG",
                            {"scalar-insecure": None})
    ref, port = (_dkg(pkg, **CASES[case]) for pkg in PKGS)
    assert port == ref
    keys = [entry for entry in port if entry[0] == "keys"]
    assert len({entry[2] for entry in keys}) == 1  # one PublicKeySet everywhere


def test_dkg_faults_are_raised_where_the_reference_raises_them():
    """The identity above covers faults; this pins that the corrupting
    cases do record them, against the right node."""
    skg_m = _mod("hbbft_tpu_torch", "protocols.sync_key_gen")
    row = _dkg("hbbft_tpu_torch", **CASES["corrupted_row"])
    assert ("part-outcome", 0, 3, skg_m.FAULT_BAD_PART, None) in row
    ack = _dkg("hbbft_tpu_torch", **CASES["corrupted_ack_slot"])
    bad = {(e[1], e[2]) for e in ack if e[0] == "ack-outcome" and e[3] is not None}
    assert bad and all(sender == 3 and node == 1 for sender, node in bad)


@pytest.mark.parametrize("ref_path", ["as_loaded", "pure"])
def test_malformed_messages_fault_alike(ref_path, monkeypatch):
    if ref_path == "pure":
        monkeypatch.setattr(_mod("hbbft_tpu", "protocols.sync_key_gen"), "_NATIVE_DKG",
                            {"scalar-insecure": None})
    ref, port = (_malformed(pkg) for pkg in PKGS)
    assert port == ref
    assert port.count(None) == 2  # the first part and its duplicate


@pytest.mark.slow  # ~100 s: 80 host pairing checks (ciphertext validity) per package
@low_priority
def test_bls_dkg_transcript_identity():
    ref, port = (_dkg(pkg, n=4, t=1, seed=3, suite_name="bls") for pkg in PKGS)
    assert port == ref
    assert all(e[3] is None for e in port if e[0] == "ack-outcome")
