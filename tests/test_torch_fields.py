"""Port Fq / Fq2 limb arithmetic vs the JAX package's ``crypto/tpu/fq.py``
and ``fq2.py`` and vs Python ints / the BLS oracle.

The port keeps the reference's 36x11-bit redundant limbs and algorithms,
so the same inputs give the same limbs: tolerance is exact equality of
limb arrays where both sides are compared, and of canonical integers
(``from_mont_int``) against Python ints.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.bls import fields as OF
from hbbft_tpu.crypto.tpu import fq as jfq
from hbbft_tpu.crypto.tpu import fq2 as jfq2
from hbbft_tpu_torch import convert
from hbbft_tpu_torch.crypto.device import fq, fq2
from torch_low_priority import low_priority

# Small tensors: intra-op threads only contend with the other test workers.
torch.set_num_threads(1)

P = OF.P


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(48), "big") % P for _ in range(n)]


def _both(vals):
    ref = jfq.to_mont_batch(vals)  # the JAX package's int32 limbs
    return jnp.asarray(ref), convert.limbs_from_reference(ref, device="cpu")


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out).astype(np.int64), torch_out.numpy())


@low_priority
def test_carry_across_round_trip(rng):
    vals = _rand(rng, 8)
    ref = jfq.to_mont_batch(vals)
    t = convert.limbs_from_reference(ref, device="cpu")
    assert t.dtype == torch.int64 and t.shape == (8, fq.NL)
    np.testing.assert_array_equal(fq.to_mont_batch(vals), ref)
    back = convert.limbs_to_reference(t)
    assert back.dtype == np.int32
    np.testing.assert_array_equal(back, ref)
    assert [fq.from_mont_int(t[i]) for i in range(8)] == vals
    with pytest.raises(ValueError):
        convert.limbs_from_reference(np.zeros((2, 5), np.int32), device="cpu")


@low_priority
def test_fq_ops_match_jax_and_ints(rng):
    n = 32
    avals, bvals = _rand(rng, n), _rand(rng, n)
    ja, ta = _both(avals)
    jb, tb = _both(bvals)
    _same(jfq.mont_mul(ja, jb), fq.mont_mul(ta, tb))
    _same(jfq.add(ja, jb), fq.add(ta, tb))
    _same(jfq.sub(ja, jb), fq.sub(ta, tb))
    _same(jfq.neg(ja), fq.neg(ta))
    _same(jfq.small_mul(ja, 8), fq.small_mul(ta, 8))
    _same(jfq.normalize(ja), fq.normalize(ta))
    # a deep alternating chain (the historic failure mode of signed limbs)
    s = ta
    for _ in range(8):
        s = fq.mont_mul(fq.sub(s, tb), fq.add(s, s))
    for i in range(n):
        a, b = avals[i], bvals[i]
        ss = a
        for _ in range(8):
            ss = (ss - b) * (2 * ss) % P
        assert fq.from_mont_int(fq.mont_mul(ta, tb)[i]) == a * b % P
        assert fq.from_mont_int(fq.sub(ta, tb)[i]) == (a - b) % P
        assert fq.from_mont_int(s[i]) == ss
    assert bool(fq.is_zero(fq.sub(ta, ta)).all())
    assert fq.is_zero(ta).tolist() == [a % P == 0 for a in avals]
    np.testing.assert_array_equal(
        np.asarray(jfq.is_zero(jfq.sub(ja, jb))), fq.is_zero(fq.sub(ta, tb)).numpy()
    )


@low_priority
def test_fq_zero_identity_and_inverse(rng):
    z = torch.as_tensor(fq.ZERO)
    one = torch.as_tensor(fq.ONE_MONT)
    assert bool(fq.is_zero(z)) and not bool(fq.is_zero(one))
    assert fq.from_mont_int(fq.mont_mul(one, one)) == 1
    # exact zero in each redundant form: 0, P and 2P
    for k in (1, 2):
        assert bool(fq.is_zero(torch.as_tensor(fq.to_limbs_np(k * P))))
    vals = _rand(rng, 4)
    ja, ta = _both(vals)
    ti = fq.inv(ta)
    _same(jfq.inv(ja), ti)
    assert [fq.from_mont_int(ti[i]) * v % P for i, v in enumerate(vals)] == [1] * 4


@low_priority
def test_fq2_ops_match_jax_and_oracle(rng):
    a = (int.from_bytes(rng.bytes(48), "big") % P, int.from_bytes(rng.bytes(48), "big") % P)
    b = (int.from_bytes(rng.bytes(48), "big") % P, int.from_bytes(rng.bytes(48), "big") % P)
    ja, jb = jnp.asarray(jfq2.to_mont_np(a)), jnp.asarray(jfq2.to_mont_np(b))
    ta, tb = torch.as_tensor(fq2.to_mont_np(a)), torch.as_tensor(fq2.to_mont_np(b))
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    _same(jfq2.mul(ja, jb), fq2.mul(ta, tb))
    _same(jfq2.sqr(ja), fq2.sqr(ta))
    _same(jfq2.conj(ja), fq2.conj(ta))
    _same(jfq2.mul_by_xi(ja), fq2.mul_by_xi(ta))
    _same(jfq2.mul_fq(ja, ja[0]), fq2.mul_fq(ta, ta[0]))
    assert fq2.from_mont_int(fq2.mul(ta, tb)) == OF.fq2_mul(a, b)
    assert fq2.from_mont_int(fq2.sqr(ta)) == OF.fq2_sqr(a)
    assert fq2.from_mont_int(fq2.conj(ta)) == OF.fq2_conj(a)
    assert fq2.from_mont_int(fq2.mul_by_xi(ta)) == OF.fq2_mul(a, OF.XI)
    got_inv = fq2.inv(ta)
    _same(jfq2.inv(ja), got_inv)
    assert OF.fq2_eq(OF.fq2_mul(fq2.from_mont_int(got_inv), a), OF.FQ2_ONE)
    assert bool(fq2.is_zero(fq2.sub(ta, ta))) and not bool(fq2.is_zero(ta))
