"""The port's native host paths against the JAX package's and its own
pure paths.

``hbbft_tpu_torch.ops.native`` wraps ``csrc/native/hbbft_native.cpp``
(SHA3-256, Merkle levels, Reed-Solomon over GF(2^8) and GF(2^16)); the
port's ``ops/merkle.py``, ``ops/gf256.py``, ``utils/serde.py`` (the token
scan), ``crypto/keys.py`` (the scalar KEM) and ``protocols/sync_key_gen.py``
(the native DKG) take those paths where the library builds, as the
reference does.  Each is held byte for byte against hashlib, the port's
numpy or pure-Python path (the native path switched off) and the
reference's binding on the same inputs, made from a seed.  Every
comparison is exact.
"""

import hashlib
import importlib
import random

import numpy as np
import pytest

from test_torch_sync_key_gen import CASES as DKG_CASES
from test_torch_sync_key_gen import _dkg
from torch_low_priority import low_priority

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module")
def natives():
    ref, port = (_mod(pkg, "ops.native") for pkg in PKGS)
    assert port.available(), "the port's host data plane did not build"
    assert ref.available()
    return ref, port


def test_sha3_matches_hashlib_and_reference(natives):
    ref, port = natives
    rng = random.Random(1)
    for n in (0, 1, 135, 136, 137, 1000, 4096):
        data = rng.randbytes(n)
        assert port.sha3_256(data) == hashlib.sha3_256(data).digest() == ref.sha3_256(data)
    msgs = np.frombuffer(rng.randbytes(37 * 300), np.uint8).reshape(37, 300)
    got = port.sha3_256_batch(msgs)
    assert np.array_equal(got, ref.sha3_256_batch(msgs))
    assert [bytes(r) for r in got] == [hashlib.sha3_256(bytes(m)).digest() for m in msgs]


@pytest.mark.parametrize("count,size", [(1, 0), (3, 17), (4, 64), (7, 200), (16, 33)])
def test_merkle_native_equals_python_and_reference(natives, monkeypatch, count, size):
    ref, port = natives
    merkle = _mod("hbbft_tpu_torch", "ops.merkle")
    rng = random.Random(count * 1000 + size)
    leaves = [rng.randbytes(size) for _ in range(count)]
    got = port.merkle_levels(leaves)
    assert got == ref.merkle_levels(leaves)
    tree = merkle.MerkleTree(leaves)
    assert tree.levels == got
    for i in range(count):
        assert tree.proof(i).validate(count)
    monkeypatch.setattr(merkle, "_native", None)
    assert merkle.MerkleTree(leaves).levels == got
    assert merkle.MerkleTree(leaves).root == tree.root


@pytest.mark.parametrize("codec,k,n,size", [
    ("rs8", 1, 4, 8), ("rs8", 3, 4, 16), ("rs8", 5, 16, 33), ("rs8", 36, 104, 64),
    ("rs16", 2, 4, 8), ("rs16", 11, 32, 40), ("rs16", 86, 256, 16),
])
def test_reed_solomon_native_equals_numpy_and_reference(natives, monkeypatch, codec, k, n, size):
    ref, port = natives
    gf = _mod("hbbft_tpu_torch", "ops.gf256")
    rng = random.Random(k * 7919 + n)
    shards = [rng.randbytes(size) for _ in range(k)]
    enc, rec = (port.rs_encode, port.rs_reconstruct) if codec == "rs8" else (
        port.rs16_encode, port.rs16_reconstruct)
    ref_enc, ref_rec = (ref.rs_encode, ref.rs_reconstruct) if codec == "rs8" else (
        ref.rs16_encode, ref.rs16_reconstruct)
    cls = gf.ReedSolomon if codec == "rs8" else gf.ReedSolomon16
    got = enc(shards, n)
    assert got == ref_enc(shards, n)
    rs = cls(k, n)
    assert rs.encode(shards) == got
    keep = sorted(rng.sample(range(n), k))
    sub = {i: got[i] for i in keep}
    assert rec(sub, k, n) == ref_rec(sub, k, n) == shards
    assert rs.reconstruct(sub) == shards
    monkeypatch.setattr(gf, "_native", None)
    assert cls(k, n).encode(shards) == got
    assert cls(k, n).reconstruct(sub) == shards


def test_rs_bad_args(natives):
    ref, port = natives
    assert port.rs_encode([b"x"], 300) is None
    assert ref.rs_encode([b"x"], 300) is None


def test_no_native_knob_takes_the_numpy_path():
    """``HBBFT_TORCH_NO_NATIVE`` keeps the library unloaded (a fresh
    interpreter: the loader memoizes), and the codecs still answer."""
    import subprocess
    import sys
    import os

    code = (
        "from hbbft_tpu_torch.ops import native, gf256, merkle\n"
        "assert not native.available()\n"
        "rs = gf256.ReedSolomon(2, 4)\n"
        "s = rs.encode([b'ab', b'cd'])\n"
        "assert rs.reconstruct({1: s[1], 3: s[3]}) == [b'ab', b'cd']\n"
        "assert merkle.MerkleTree([b'a', b'b', b'c']).proof(2).validate(3)\n"
        "print('NUMPY')\n"
    )
    env = dict(os.environ, HBBFT_TORCH_NO_NATIVE="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "NUMPY" in res.stdout


def _serde_corpus(pkg):
    keys = _mod(pkg, "crypto.keys")
    suite = _mod(pkg, "crypto.suite").ScalarSuite()
    serde = _mod(pkg, "utils.serde")
    rng = random.Random(5)
    sk = keys.SecretKey.random(rng, suite)
    ct = sk.public_key().encrypt(b"payload bytes", rng)
    samples = [
        None, True, False, 0, 1, -1, 2**300, -(2**300), b"", b"abc", "txt", "ünicode",
        (1, (2, b"x"), [None, True]), {"k": 1, 2: (3,)}, [], ct, (ct, ct), {"ct": ct},
        sk.public_key(),
    ]
    encs = [serde.dumps(obj) for obj in samples]
    enc = serde.dumps((1, b"ab", "c", ct))
    cuts = [enc[:cut] for cut in range(len(enc))]
    rng2 = random.Random(7)
    flips = []
    for _ in range(300):
        i = rng2.randrange(len(enc))
        flips.append(enc[:i] + bytes([enc[i] ^ (1 << rng2.randrange(8))]) + enc[i + 1:])
    return encs + cuts + flips


def _loads_all(pkg, datas, native):
    """Each encoding decoded (serde bytes of the result, or "ERR"), the
    native token scan on or off."""
    serde = _mod(pkg, "utils.serde")
    out = []
    for data in datas:
        if native:
            try:
                obj = serde.loads(data)
            except serde.DecodeError:
                obj = "ERR"
        else:
            r = serde._Reader(data, None)
            try:
                obj = serde._decode(r, 0)
                if r.pos != len(r.data):
                    raise serde.DecodeError("trailing bytes")
            except serde.DecodeError:
                obj = "ERR"
        out.append(obj if obj == "ERR" else serde.dumps(obj))
    return out


def test_serde_native_scan_matches_pure_decoder_and_reference():
    """The engine's C token scan (used once an engine is loaded) accepts
    exactly what the pure decoder accepts, with the same objects, over
    round trips, every truncation and 300 bit flips; and both packages
    agree."""
    for pkg in PKGS:
        assert _mod(pkg, "native_engine").get_lib() is not None
    port_serde = _mod("hbbft_tpu_torch", "utils.serde")
    assert port_serde._native_scan(b"\x00") is not None
    ref_datas = _serde_corpus("hbbft_tpu")
    datas = _serde_corpus("hbbft_tpu_torch")
    assert datas == ref_datas
    native = _loads_all("hbbft_tpu_torch", datas, native=True)
    assert native == _loads_all("hbbft_tpu_torch", datas, native=False)
    assert native == _loads_all("hbbft_tpu", datas, native=True)
    assert native.count("ERR") > 100


def test_scalar_ct_serde_cache_matches_recursive_encoder():
    keys = _mod("hbbft_tpu_torch", "crypto.keys")
    suite = _mod("hbbft_tpu_torch", "crypto.suite").ScalarSuite()
    serde = _mod("hbbft_tpu_torch", "utils.serde")
    ref_keys = _mod("hbbft_tpu", "crypto.keys")
    rng = random.Random(9)
    sk = keys.SecretKey.random(rng, suite)
    for msg in (b"\x00" * 32, b"hello world", b""):
        ct = sk.public_key().encrypt(msg, rng)
        want = serde.dumps(keys.Ciphertext(ct.u, ct.v, ct.w, suite))
        args = (ct.u.value.to_bytes(32, "big"), ct.v, ct.w.value.to_bytes(32, "big"))
        assert keys.scalar_ct_serde(*args) == want == ref_keys.scalar_ct_serde(*args)
        assert serde.dumps(ct) == want


def _kem_run(pkg, native):
    keys = _mod(pkg, "crypto.keys")
    suite = _mod(pkg, "crypto.suite").ScalarSuite()
    serde = _mod(pkg, "utils.serde")
    if not native:
        keys._KEM_CACHE[suite.name] = None
    try:
        assert (keys._scalar_kem(suite) is not None) == native
        rng = random.Random(1)
        sk = keys.SecretKey.random(rng, suite)
        out = []
        for trial in range(4):
            msg = bytes([trial]) * (32 * (trial + 1))
            ct = sk.public_key().encrypt(msg, rng)
            bad = keys.Ciphertext(ct.u, b"\x00" + ct.v[1:], ct.w, suite)
            out.append((serde.dumps(ct), sk.decrypt(ct), sk.decrypt(bad), rng.random()))
        return out
    finally:
        keys._KEM_CACHE.pop(suite.name, None)


def test_scalar_kem_native_equals_pure_and_reference():
    """The scalar-suite native KEM gives the pure path's ciphertexts for
    the same rng draws (and leaves the rng where the pure path leaves
    it), the same plaintexts and the same rejection of a tampered
    ciphertext; the reference's does the same."""
    port = _kem_run("hbbft_tpu_torch", native=True)
    assert port == _kem_run("hbbft_tpu_torch", native=False)
    assert port == _kem_run("hbbft_tpu", native=True)
    assert all(plain is not None and bad is None for _, plain, bad, _ in port)


@pytest.mark.parametrize("case", ["full_n4_t1", "full_n7_t2", "corrupted_row",
                                  "corrupted_ack_slot"])
@low_priority
def test_native_dkg_equals_pure_dkg_and_reference(case, monkeypatch):
    """SyncKeyGen's native scalar DKG (registered commitments, one-call
    row and ack checks) gives the pure path's transcript and the
    reference's (``test_torch_sync_key_gen``'s ``_dkg``), faults
    included."""
    skg = _mod("hbbft_tpu_torch", "protocols.sync_key_gen")
    assert skg._native_dkg(_mod("hbbft_tpu_torch", "crypto.suite").ScalarSuite()) is not None
    native = _dkg("hbbft_tpu_torch", **DKG_CASES[case])
    assert native == _dkg("hbbft_tpu", **DKG_CASES[case])
    monkeypatch.setattr(skg, "_NATIVE_DKG", {"scalar-insecure": None})
    assert native == _dkg("hbbft_tpu_torch", **DKG_CASES[case])
