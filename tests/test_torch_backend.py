"""The slice as a whole: ``TorchBackend(device="cpu").verify_batch`` vs the
JAX package's ``TpuBackend`` and ``BatchedBackend``, and the port's copied
host backends vs the originals.

Requests are built twice from the same seeded ``random.Random`` — once
with each package's key material — and the key sets are checked to agree
byte for byte, so both backends see the same requests.  Tolerance: exact
equality of verdict lists.

The request mixes are the ones ``tests/test_tpu_crypto.py`` runs through
``TpuBackend`` and pins to the expected verdict lists asserted below, so
the port equals ``TpuBackend`` on them through those lists; the
multi-chunk mix is that test's cut to two chunks of three requests (every
plain CPU stage costs seconds whatever its rows), checked against both
host backends.  The direct
``TpuBackend`` call (seed-77 mix, whose kernel shapes
``test_tpu_crypto.py`` already compiles) is marked ``slow``: even with a
warm XLA cache it spends about 150 s tracing and loading its kernels on
an 8-core CPU.
"""

import random

import pytest
import torch

from hbbft_tpu.crypto import keys as ref_keys
from hbbft_tpu.crypto.backend import BatchedBackend as RefBatched
from hbbft_tpu.crypto.backend import VerifyRequest as RefRequest
from hbbft_tpu.crypto.bls import curve as ref_oc
from hbbft_tpu.crypto.bls.suite import BLSSuite as RefSuite
from hbbft_tpu.crypto.bls.suite import G2Elem as RefG2Elem
from hbbft_tpu.crypto.tpu.backend import TpuBackend
from hbbft_tpu_torch import build, convert
from hbbft_tpu_torch.crypto import keys as port_keys
from hbbft_tpu_torch.crypto.backend import BatchedBackend, EagerBackend, VerifyRequest
from hbbft_tpu_torch.crypto.bls.suite import BLSSuite, G2Elem
from hbbft_tpu_torch.crypto.device.backend import TorchBackend
from torch_low_priority import low_priority

# Small tensors: intra-op threads only contend with the other test workers.
torch.set_num_threads(1)


def _mixed_requests(keys, Request, suite, rngpy, n_sig=5, n_ct=2):
    """tests/test_tpu_crypto.py::_mixed_requests over either package."""
    sks = keys.SecretKeySet.random(1, rngpy, suite)
    pks = sks.public_keys()
    msg = b"flush epoch"
    reqs = []
    for i in range(n_sig):
        share = sks.secret_key_share(i % 4).sign(msg)
        reqs.append(Request.sig_share(pks.public_key_share(i % 4), msg, share))
    for i in range(n_ct):
        ct = pks.public_key().encrypt(b"tx-%d" % i, rngpy)
        reqs.append(Request.ciphertext(ct))
        ds = sks.secret_key_share(i % 4).decryption_share(ct)
        reqs.append(Request.dec_share(pks.public_key_share(i % 4), ct, ds))
    return reqs, sks


def _with_bad_share(keys, Request, suite, seed):
    """tests/test_tpu_crypto.py::test_tpu_backend_isolates_bad_shares."""
    rngpy = random.Random(seed)
    reqs, _ = _mixed_requests(keys, Request, suite, rngpy, n_sig=4, n_ct=1)
    sks = keys.SecretKeySet.random(1, rngpy, suite)
    bad = sks.secret_key_share(0).sign(b"wrong document")
    reqs.append(Request.sig_share(
        keys.SecretKeySet.random(1, rngpy, suite).public_keys().public_key_share(0),
        b"flush epoch", bad))
    return reqs


def _forged(keys, Request, suite, G2, rogue_pt):
    """tests/test_tpu_crypto.py::test_device_subgroup_check_and_rejection."""
    rng_ = random.Random(77)
    sks = keys.SecretKeySet.random(1, rng_, suite)
    pks = sks.public_keys()
    msg = b"subgroup test doc"
    reqs = [
        Request.sig_share(pks.public_key_share(i), msg, sks.secret_key_share(i).sign(msg))
        for i in range(3)
    ]
    reqs.append(Request.sig_share(
        pks.public_key_share(3), msg, keys.SignatureShare(G2(rogue_pt), suite)))
    return reqs


# Two chunks of a few rows: the cross-chunk combined check, then the
# per-chunk recheck and bisection when a share is bad.
MULTI_CHUNK, MULTI_BAD = 3, 4


def _multi_chunk(keys, Request, suite, bad=True):
    """tests/test_tpu_crypto.py::test_tpu_backend_multi_chunk_combined cut
    from 24 requests in three chunks of 8 to 6 requests in two chunks of
    3 (the same keys, message and bad signer; the bad share in chunk 2)."""
    rngpy = random.Random(99)
    sks = keys.SecretKeySet.random(2, rngpy, suite)
    pks = sks.public_keys()
    msg = b"two-stage flush doc"
    reqs = [
        Request.sig_share(pks.public_key_share(i), msg, sks.secret_key_share(i).sign(msg))
        for i in range(2 * MULTI_CHUNK)
    ]
    signer = 4 if bad else 5
    reqs[MULTI_BAD] = Request.sig_share(
        pks.public_key_share(5), msg, sks.secret_key_share(signer).sign(msg))
    return reqs


def _payload_bytes(reqs):
    out = []
    for r in reqs:
        row = [r.kind]
        for item in r.payload:
            row.append(item if isinstance(item, bytes) else item.to_bytes())
        out.append(row)
    return out


@low_priority
def test_key_sets_agree_byte_for_byte():
    a = ref_keys.SecretKeySet.random(2, random.Random(77), RefSuite())
    b = port_keys.SecretKeySet.random(2, random.Random(77), BLSSuite())
    assert a.public_keys().to_bytes() == b.public_keys().to_bytes()
    for i in range(4):
        assert (a.public_keys().public_key_share(i).to_bytes()
                == b.public_keys().public_key_share(i).to_bytes())
        assert (a.secret_key_share(i).sign(b"m").to_bytes()
                == b.secret_key_share(i).sign(b"m").to_bytes())


@pytest.mark.parametrize("case", ["seed77", "seed78_bad", "forged", "multi_chunk"])
@low_priority
def test_torch_backend_matches_reference_backends(case):
    ref_suite, suite = RefSuite(), BLSSuite()
    if case == "seed77":
        ref = _mixed_requests(ref_keys, RefRequest, ref_suite, random.Random(77))[0]
        port = _mixed_requests(port_keys, VerifyRequest, suite, random.Random(77))[0]
        want = [True] * 9
    elif case == "seed78_bad":
        ref = _with_bad_share(ref_keys, RefRequest, ref_suite, 78)
        port = _with_bad_share(port_keys, VerifyRequest, suite, 78)
        want = [True] * 6 + [False]
    elif case == "forged":
        rogue = ref_oc._twist_sample_point()
        ref = _forged(ref_keys, RefRequest, ref_suite, RefG2Elem, rogue)
        port = _forged(port_keys, VerifyRequest, suite, G2Elem, rogue)
        want = [True, True, True, False]
    else:
        ref = _multi_chunk(ref_keys, RefRequest, ref_suite)
        port = _multi_chunk(port_keys, VerifyRequest, suite)
        want = [True] * (2 * MULTI_CHUNK)
        want[MULTI_BAD] = False
    # The carried-across requests are the port's own, byte for byte.
    assert _payload_bytes(convert.requests_from_reference(ref, suite)) == _payload_bytes(port)

    chunk = MULTI_CHUNK if case == "multi_chunk" else 2048
    build.reset_launches()
    got = TorchBackend(suite, device="cpu", chunk=chunk).verify_batch(port)
    assert not build.LAUNCHES  # CPU tensors: the plain scan and field ops, no kernel
    assert got == want
    assert got == RefBatched(ref_suite).verify_batch(ref)
    assert got == BatchedBackend(suite).verify_batch(port)


@pytest.mark.slow
@low_priority
def test_torch_backend_matches_tpu_backend():
    ref_suite, suite = RefSuite(), BLSSuite()
    ref = _mixed_requests(ref_keys, RefRequest, ref_suite, random.Random(77))[0]
    port = _mixed_requests(port_keys, VerifyRequest, suite, random.Random(77))[0]
    got = TorchBackend(suite, device="cpu").verify_batch(port)
    assert got == TpuBackend(ref_suite).verify_batch(ref) == [True] * 9


@low_priority
def test_fiat_shamir_coefficients_are_bit_identical():
    from hbbft_tpu.crypto.backend import _batch_coefficients as ref_coeffs
    from hbbft_tpu_torch.crypto.backend import _batch_coefficients

    ref = _with_bad_share(ref_keys, RefRequest, RefSuite(), 78)
    port = _with_bad_share(port_keys, VerifyRequest, BLSSuite(), 78)
    assert _batch_coefficients(BLSSuite(), port) == ref_coeffs(RefSuite(), ref)


@low_priority
def test_copied_host_backends_match_the_originals():
    suite = BLSSuite()
    reqs = _with_bad_share(port_keys, VerifyRequest, suite, 78)
    ref = _with_bad_share(ref_keys, RefRequest, RefSuite(), 78)
    want = RefBatched(RefSuite()).verify_batch(ref)
    assert BatchedBackend(suite).verify_batch(reqs) == want
    assert EagerBackend(suite).verify_batch(reqs) == want


@low_priority
def test_multi_chunk_all_good_takes_the_combined_path():
    suite = BLSSuite()
    reqs = _multi_chunk(port_keys, VerifyRequest, suite, bad=False)
    be = TorchBackend(suite, device="cpu", chunk=MULTI_CHUNK)
    calls = []
    be._bisect = lambda *a: calls.append(a)
    assert be.verify_batch(reqs) == [True] * (2 * MULTI_CHUNK)
    assert calls == []  # the combined check passed; no chunk was rechecked


@pytest.mark.parametrize("group_points", [1 << 20, 4])
@low_priority
def test_masked_leg_sums_match_oracle_in_groups(monkeypatch, group_points):
    """Per-leg sums, all masks in one pass and one mask per pass."""
    from hbbft_tpu_torch.crypto.bls import curve as oc
    from hbbft_tpu_torch.crypto.device import backend as dbackend
    from hbbft_tpu_torch.crypto.device import curve as dc

    monkeypatch.setattr(dbackend, "MASKED_SUM_POINTS", group_points)
    rng = random.Random(5)
    pts = [oc.jac_mul(oc.FQ_OPS, oc.G1_GEN, rng.randrange(1, 1 << 64)) for _ in range(4)]
    legs = [0, 2, 0, 1]
    mask = torch.zeros((3, 4), dtype=torch.int64)
    mask[legs, range(4)] = 1
    sums = dbackend._masked_sums(dc.G1_OPS, dc.g1_to_dev(pts), mask)
    for l in range(3):
        want = oc.jac_identity(oc.FQ_OPS)
        for p, pl in zip(pts, legs):
            if pl == l:
                want = oc.jac_add(oc.FQ_OPS, want, p)
        assert oc.jac_eq(oc.FQ_OPS, dc.g1_from_dev(sums, l), want)
