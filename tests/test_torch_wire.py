"""The port's wire codec and GF(2^16) codec against the JAX package's.

For one value of every tag the port registers, built from a seed in both
packages (over ScalarSuite, and over BLS12-381 for the tags that carry
group elements), ``serde.dumps`` gives identical bytes; each package's
``serde.loads`` decodes the other's bytes to a value equal to its own; and
truncated, extended or bit-flipped encodings are rejected (``DecodeError``)
or accepted alike by both, with the same re-encoding when accepted.
``rs_codec(k, n)`` for n > 255 (GF(2^16)) encodes and reconstructs
byte-identically to the reference.  Every comparison is exact.
"""

import importlib
import random

import pytest

from torch_low_priority import low_priority

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")

# Tags whose values carry group elements: built over both suites.
GROUP_TAGS = {"ct", "sig", "pk", "comm", "bicomm", "vreq_sig", "vreq_dec", "vreq_ct",
              "sigshare", "decshare", "signmsg", "decmsg", "ba_coin", "ba_coin_round",
              "hbmsg_decrypt", "change", "svote", "skg", "skg_ack", "icontrib", "joinplan",
              "part", "ack", "dhbmsg", "sqmsg_algo", "sqmsg_join_plan"}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _values(pkg, suite_name):
    """One seeded value per case, the same in both packages."""
    suite = (_mod(pkg, "crypto.suite").ScalarSuite() if suite_name == "scalar"
             else _mod(pkg, "crypto.bls.suite").BLSSuite())
    keys = _mod(pkg, "crypto.keys")
    poly = _mod(pkg, "crypto.poly")
    backend = _mod(pkg, "crypto.backend")
    merkle = _mod(pkg, "ops.merkle")
    bc = _mod(pkg, "protocols.broadcast")
    ba = _mod(pkg, "protocols.binary_agreement")
    bs = _mod(pkg, "protocols.bool_set")
    sbv = _mod(pkg, "protocols.sbv_broadcast")
    ts = _mod(pkg, "protocols.threshold_sign")
    td = _mod(pkg, "protocols.threshold_decrypt")
    sub = _mod(pkg, "protocols.subset")
    hb = _mod(pkg, "protocols.honey_badger")
    dhb = _mod(pkg, "protocols.dynamic_honey_badger")
    skg = _mod(pkg, "protocols.sync_key_gen")
    sq = _mod(pkg, "protocols.sender_queue")

    rng = random.Random(8)
    sks = keys.SecretKeySet.random(2, rng, suite)
    pks = sks.public_keys()
    doc = b"wire identity document"
    ct = pks.public_key().encrypt(b"wire identity plaintext", rng)
    sig_share = sks.secret_key_share(1).sign(doc)
    dec_share = sks.secret_key_share(2).decryption_share(ct)
    bivar = poly.BivarPoly.random(2, rng, suite.scalar_modulus).commitment(suite)
    shards = [rng.randbytes(40) for _ in range(7)]
    proof = merkle.MerkleTree(shards).proof(3)
    root = proof.root
    sign_msg = ts.SignMessage(sig_share)
    aba = ba.AbaMessage(4, ba.ConfMsg(bs.BoolSet.both()))
    node_sks = {i: keys.SecretKey.random(rng, suite) for i in range(3)}
    node_pks = {i: sk.public_key() for i, sk in node_sks.items()}
    part = skg.SyncKeyGen.new(0, node_sks[0], node_pks, 1, rng, suite)[1]
    ack = skg.Ack(2, tuple(node_pks[i].encrypt(bytes([i]) * 32, rng) for i in range(3)))
    change = dhb.Change.node_change(node_pks)
    vote = dhb.SignedVote(1, 0, 2, change, node_sks[1].sign(b"vote"))
    kg_part = dhb.SignedKeyGenMsg(0, 0, part, node_sks[0].sign(b"part"))
    kg_ack = dhb.SignedKeyGenMsg(1, 2, ack, node_sks[2].sign(b"ack"))
    plan = dhb.JoinPlan(1, pks, change.new_validators, hb.EncryptionSchedule.tick_tock(2))
    hb_dec = hb.HbMessage(2, hb.DECRYPT, 1, td.DecryptMessage(dec_share))
    return {
        "change": change,
        "change_schedule": dhb.Change.encryption_schedule(hb.EncryptionSchedule.every_nth(2)),
        "svote": vote,
        "skg": kg_part,
        "skg_ack": kg_ack,
        "icontrib": dhb.InternalContrib(["tx-1", b"tx-2"], (kg_part, kg_ack), (vote,)),
        "joinplan": plan,
        "part": part,
        "ack": ack,
        "dhbmsg": dhb.DhbMessage(3, hb_dec),
        "sqmsg_epoch": sq.SqMessage.epoch_started((1, 2)),
        "sqmsg_algo": sq.SqMessage.algo(dhb.DhbMessage(0, hb_dec)),
        "sqmsg_algo_hb": sq.SqMessage.algo(hb.HbMessage(5, hb.SUBSET, None,
                                                        sub.SubsetMessage(0, sub.BA, aba))),
        "sqmsg_join_plan": sq.SqMessage.join_plan(plan),
        "ct": ct,
        "sig": pks.combine_signatures({i: sks.secret_key_share(i).sign(doc) for i in range(3)}),
        "pk": pks.public_key(),
        "comm": pks.commitment,
        "bicomm": bivar,
        "vreq_sig": backend.VerifyRequest.sig_share(pks.public_key_share(1), doc, sig_share),
        "vreq_dec": backend.VerifyRequest.dec_share(pks.public_key_share(2), ct, dec_share),
        "vreq_ct": backend.VerifyRequest.ciphertext(ct),
        "sigshare": sig_share,
        "decshare": dec_share,
        "proof": proof,
        "bc_value": bc.ValueMsg(proof),
        "bc_echo": bc.EchoMsg(proof),
        "bc_ready": bc.ReadyMsg(root),
        "bc_echohash": bc.EchoHashMsg(root),
        "bc_candecode": bc.CanDecodeMsg(root),
        "bools": bs.BoolSet.single(True),
        "ba_bval": sbv.BValMsg(False),
        "ba_aux": sbv.AuxMsg(True),
        "ba_conf": ba.ConfMsg(bs.BoolSet.both()),
        "ba_coin": ba.CoinMsg(sign_msg),
        "ba_term": ba.TermMsg(True),
        "ba": aba,
        "ba_coin_round": ba.AbaMessage(2, ba.CoinMsg(sign_msg)),
        "signmsg": sign_msg,
        "decmsg": td.DecryptMessage(dec_share),
        "subsetmsg": sub.SubsetMessage(3, sub.BC, bc.EchoMsg(proof)),
        "subsetmsg_ba": sub.SubsetMessage(1, sub.BA, aba),
        "encsched": hb.EncryptionSchedule.every_nth(3),
        "hbmsg": hb.HbMessage(5, hb.SUBSET, None, sub.SubsetMessage(0, sub.BA, aba)),
        "hbmsg_decrypt": hb_dec,
        "nested": [b"raw", "text", -7, (True, None, {"k": 2**70})],
    }


_CACHE = {}


def _both(suite_name):
    if suite_name not in _CACHE:
        _CACHE[suite_name] = tuple(_values(pkg, suite_name) for pkg in PKGS)
    return _CACHE[suite_name]


CASES = sorted(_values("hbbft_tpu_torch", "scalar"))
PARAMS = [(case, "scalar") for case in CASES] + [
    (case, "bls") for case in CASES if case in GROUP_TAGS
]


def _serde(pkg):
    return _mod(pkg, "utils.serde")


def test_registered_tags_are_the_reference_tags_of_the_ported_modules():
    """The port registers every struct tag of the reference; of its
    token-level builders (the native scan's) it registers none."""
    ref, port = (_serde(pkg) for pkg in PKGS)
    ref.dumps(None), port.dumps(None)  # bootstrap both registries
    assert set(port._STRUCTS) == set(ref._STRUCTS)
    assert len(port._STRUCTS) == 35
    assert set(ref._TOKEN_STRUCTS) == {"ct"}
    assert not getattr(port, "_TOKEN_STRUCTS", {})
    # Every registered tag is exercised by a case below.
    values = _values("hbbft_tpu_torch", "scalar")
    used = set()

    def walk(v):
        name = port._STRUCT_BY_CLS.get(type(v))
        if name is not None:
            used.add(name)
            _, pack, _ = port._STRUCTS[name]
            for field in pack(v):
                walk(field)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)

    for v in values.values():
        walk(v)
    assert used == set(port._STRUCTS)


@pytest.mark.parametrize("case,suite_name", PARAMS)
@low_priority
def test_dumps_bytes_equal_and_each_package_decodes_the_other(case, suite_name):
    ref_v, port_v = (vals[case] for vals in _both(suite_name))
    ref_s, port_s = (_serde(pkg) for pkg in PKGS)
    data = ref_s.dumps(ref_v)
    assert port_s.dumps(port_v) == data
    for serde, own in ((port_s, port_v), (ref_s, ref_v)):
        got = serde.loads(data)
        assert got == own
        assert serde.dumps(got) == data
    # The suite pin: accepted under the value's own suite, refused under
    # the other one.
    suite = getattr(port_v, "suite", None)
    if suite is not None:
        assert port_s.loads(data, suite=suite) == port_v
        other = (_mod("hbbft_tpu_torch", "crypto.bls.suite").BLSSuite()
                 if suite_name == "scalar"
                 else _mod("hbbft_tpu_torch", "crypto.suite").ScalarSuite())
        with pytest.raises(port_s.DecodeError):
            port_s.loads(data, suite=other)


def _mutations(data: bytes):
    """Truncations and a trailing byte (all invalid) first, then bit flips."""
    rng = random.Random(len(data))
    out = [data[:cut] for cut in sorted({0, 1, 5, len(data) // 2, len(data) - 1})]
    out.append(data + b"\x00")
    invalid = len(out)
    for pos in sorted(rng.sample(range(len(data)), min(24, len(data)))):
        flipped = bytearray(data)
        flipped[pos] ^= 1 << rng.randrange(8)
        out.append(bytes(flipped))
    return out, invalid


def _outcome(serde, data):
    try:
        return ("ok", serde.dumps(serde.loads(data)))
    except serde.DecodeError:
        return ("DecodeError",)


@pytest.mark.parametrize("case,suite_name", PARAMS)
@low_priority
def test_truncated_and_tampered_encodings_decode_alike(case, suite_name):
    ref_s, port_s = (_serde(pkg) for pkg in PKGS)
    data = port_s.dumps(_both(suite_name)[1][case])
    muts, invalid = _mutations(data)
    ref = [_outcome(ref_s, m) for m in muts]
    port = [_outcome(port_s, m) for m in muts]
    assert port == ref
    assert all(o == ("DecodeError",) for o in port[:invalid])


@pytest.mark.parametrize("k,n", [(1, 256), (98, 300)])
@low_priority
def test_gf16_codec_matches_reference(k, n):
    ref_gf, port_gf = (_mod(pkg, "ops.gf256") for pkg in PKGS)
    ref_rs, port_rs = ref_gf.rs_codec(k, n), port_gf.rs_codec(k, n)
    assert type(port_rs).__name__ == "ReedSolomon16" and port_rs.shard_align == 2
    rng = random.Random(n)
    data = [rng.randbytes(16) for _ in range(k)]
    shards = port_rs.encode(data)
    assert shards == ref_rs.encode(data)
    assert len(shards) == n and shards[:k] == data
    keep = sorted(rng.sample(range(n), k))  # erasures everywhere else
    have = {i: shards[i] for i in keep}
    assert port_rs.reconstruct(have) == ref_rs.reconstruct(have) == data
    assert (port_gf.encoding_matrix16(k, n) == ref_gf.encoding_matrix16(k, n)).all()
