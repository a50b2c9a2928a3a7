"""``HybridBackend`` and the sharded flush (``TorchBackend(devices=)``, the
counterpart of the reference's ``TpuBackend(shard=True)``, K7).

* ``HybridBackend`` sends flushes of ``min_device_batch`` requests or more
  to its device backend and smaller ones to the host, with a counting
  stand-in for the device; ``device=None`` builds ``TorchBackend`` on
  ``cuda`` and raises without a card; a device flush that raises
  propagates, and the next flush goes to the device again (no failover);
  ``NO_DEVICE`` is host-only by the caller's choice.
* ``TorchBackend(devices=["cpu", "cpu"])`` on a small BLS mix (valid shares,
  and with one bad share, two chunks): the chunks' scan stages go to the
  listed devices in turn, and the verdicts are the host's and the
  unsharded flush's (``tests/test_tpu_crypto.py:316``'s counterpart).  The
  bad share sits in the chunk scanned on ``devices[1]``, beside a valid
  one, so that chunk is rechecked on ``devices[0]`` and bisected there.
  Each plain CPU stage takes seconds, so the mix is three requests (four
  with the bad share) in chunks of two, and the cases with the bad share
  (seven stages or more) are slow.  On ``["cpu", "cpu"]`` no tensor moves
  between devices: that the gathering is right across two cards is not
  shown here.
"""

from __future__ import annotations

import random

import pytest
import torch

from hbbft_tpu_torch.crypto import keys
from hbbft_tpu_torch.crypto.backend import BatchedBackend, CryptoBackend, VerifyRequest
from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
from hbbft_tpu_torch.crypto.device.backend import HybridBackend, TorchBackend
from hbbft_tpu_torch.crypto.suite import ScalarSuite
from torch_low_priority import low_priority

# Small tensors: intra-op threads only contend with the other test workers.
torch.set_num_threads(1)


def _scalar_requests(n: int):
    suite = ScalarSuite()
    rng = random.Random(11)
    sks = keys.SecretKeySet.random(1, rng, suite)
    pks = sks.public_keys()
    reqs = [VerifyRequest.sig_share(pks.public_key_share(i % 3), b"doc",
                                    sks.secret_key_share(i % 3).sign(b"doc"))
            for i in range(n)]
    reqs[n // 2] = VerifyRequest.sig_share(pks.public_key_share(1), b"doc",
                                           sks.secret_key_share(2).sign(b"doc"))
    return suite, reqs


class Counting(CryptoBackend):
    """A device stand-in: the host's verdicts, and the flush sizes seen."""

    def __init__(self, suite, fail: bool = False):
        self.inner = BatchedBackend(suite)
        self.calls = []
        self.fail = fail

    def verify_batch(self, reqs):
        self.calls.append(len(reqs))
        if self.fail:
            raise RuntimeError("device flush failed")
        return self.inner.verify_batch(reqs)


def test_hybrid_routes_by_size():
    suite, reqs = _scalar_requests(64)
    dev, host = Counting(suite), Counting(suite)
    hb = HybridBackend(suite, device=dev, host=host)
    assert hb.min_device_batch == 64
    want = BatchedBackend(suite).verify_batch(reqs)
    assert hb.verify_batch(reqs[:63]) == want[:63]
    assert (dev.calls, host.calls) == ([], [63])
    assert hb.verify_batch(reqs) == want
    assert (dev.calls, host.calls) == ([64], [63])
    assert want.count(False) == 1
    assert hb.verify_batch([]) == []


def test_hybrid_device_failure_propagates_without_failover():
    suite, reqs = _scalar_requests(64)
    dev, host = Counting(suite, fail=True), Counting(suite)
    hb = HybridBackend(suite, device=dev, host=host)
    with pytest.raises(RuntimeError, match="device flush failed"):
        hb.verify_batch(reqs)
    assert hb.device is dev  # still the device: nothing failed over
    with pytest.raises(RuntimeError, match="device flush failed"):
        hb.verify_batch(reqs)
    assert (dev.calls, host.calls) == ([64, 64], [])


def test_hybrid_no_device_is_host_only():
    suite, reqs = _scalar_requests(64)
    host = Counting(suite)
    hb = HybridBackend(suite, device=HybridBackend.NO_DEVICE, host=host)
    assert hb.device is None
    assert hb.verify_batch(reqs) == BatchedBackend(suite).verify_batch(reqs)
    assert host.calls == [64]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_hybrid_default_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridBackend(BLSSuite())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(BLSSuite(), devices=["cuda", "cuda"])


def test_devices_argument_validation():
    with pytest.raises(ValueError, match="not both"):
        TorchBackend(BLSSuite(), device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="at least one"):
        TorchBackend(BLSSuite(), devices=[])
    be = TorchBackend(BLSSuite(), devices=["cpu", "cpu"])
    assert be.device == torch.device("cpu") and len(be.devices) == 2


def _bls_mix(bad: bool):
    """Three sig shares, and when ``bad`` a fourth from the wrong signer:
    with chunks of two it shares the second chunk with a valid one."""
    suite = BLSSuite()
    rng = random.Random(99)
    sks = keys.SecretKeySet.random(1, rng, suite)
    pks = sks.public_keys()
    msg = b"sharded flush doc"
    reqs = [VerifyRequest.sig_share(pks.public_key_share(i), msg,
                                    sks.secret_key_share(i).sign(msg)) for i in range(3)]
    if bad:
        reqs.append(VerifyRequest.sig_share(pks.public_key_share(3), msg,
                                            sks.secret_key_share(0).sign(msg)))
    return suite, reqs


def _recorded(be):
    """Record the index in ``be.devices`` of every scan stage's device (by
    identity: the listed devices compare equal) and count the pair checks
    of whole chunks."""
    seen = {"scan": [], "pair": 0}
    scan, check = be._scan, be._check_parts

    def rec_scan(subsets, dev=None):
        out = scan(subsets, dev)
        seen["scan"].append(next((k for k, d in enumerate(be.devices) if d is dev), 0))
        return out

    def rec_check(parts):
        seen["pair"] += 1
        return check(parts)

    be._scan, be._check_parts = rec_scan, rec_check
    return seen


# The valid mix takes two scan stages and one pair stage (~15 s here);
# the bad share adds the two per-chunk rechecks and one bisection level
# (~40 s), hence slow.
@pytest.mark.parametrize("bad", [False, pytest.param(True, marks=pytest.mark.slow)])
@low_priority
def test_sharded_flush_matches_host_verdicts(bad):
    suite, reqs = _bls_mix(bad)
    be = TorchBackend(suite, devices=["cpu", "cpu"], chunk=2)
    seen = _recorded(be)
    got = be.verify_batch(reqs)
    assert got == BatchedBackend(suite).verify_batch(reqs) == [True] * 3 + [False] * bad
    # two chunks, scanned on devices[0] and devices[1], one combined pair
    # check on devices[0]; after a failed one, both chunks rechecked there
    # and the second bisected (one scan of its two halves on devices[0])
    assert seen["scan"] == ([0, 1, 0] if bad else [0, 1])
    assert seen["pair"] == (3 if bad else 1)


@pytest.mark.slow
@low_priority
def test_sharded_flush_matches_unsharded():
    suite, reqs = _bls_mix(bad=True)
    sharded = TorchBackend(suite, devices=["cpu", "cpu"], chunk=2)
    plain = TorchBackend(suite, device="cpu", chunk=2)
    a, b = _recorded(sharded), _recorded(plain)
    assert sharded.verify_batch(reqs) == plain.verify_batch(reqs) == [True, True, True, False]
    assert (len(a["scan"]), a["pair"]) == (len(b["scan"]), b["pair"])
