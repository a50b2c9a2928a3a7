"""Port Fq12 tower, Miller loop and final exponentiation vs the JAX
package's ``crypto/tpu/pairing.py`` and the BLS oracle
``crypto/bls/pairing.py``.

Tolerance: exact.  Fq12 ops that both packages run by the same formula
are compared limb for limb; the Miller loop is compared after the
oracle's own final exponentiation (the line scalings differ from the
oracle's and vanish there); pairing-product checks as verdicts against
the oracle's ``multi_pairing_is_one`` on the inputs of
``tests/test_tpu_crypto.py::test_pairing_product_vs_oracle``.  The JAX
pairing kernel itself is held against the port through the whole flush
in ``test_torch_backend.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.bls import curve as oc
from hbbft_tpu.crypto.bls import fields as OF
from hbbft_tpu.crypto.bls import pairing as opair
from hbbft_tpu.crypto.tpu import fq2 as jfq2
from hbbft_tpu.crypto.tpu import pairing as jp
from hbbft_tpu_torch.crypto.device import curve as dc
from hbbft_tpu_torch.crypto.device import fq2
from hbbft_tpu_torch.crypto.device import pairing as tp
from torch_low_priority import low_priority

# Small tensors: intra-op threads only contend with the other test workers.
torch.set_num_threads(1)

P = OF.P


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


def _rand_fq12(rng):
    return tuple(
        (int.from_bytes(rng.bytes(48), "big") % P, int.from_bytes(rng.bytes(48), "big") % P)
        for _ in range(6)
    )


def _limbs12(a):
    return np.stack([jfq2.to_mont_np(c) for c in a])


def _from12(x):
    arr = x.numpy()
    return tuple(fq2.from_mont_int(arr[i]) for i in range(6))


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


@low_priority
def test_fq12_ops_match_jax_and_oracle(rng):
    A, B = _rand_fq12(rng), _rand_fq12(rng)
    jA, jB = jnp.asarray(_limbs12(A)), jnp.asarray(_limbs12(B))
    tA, tB = torch.as_tensor(_limbs12(A).astype(np.int64)), torch.as_tensor(_limbs12(B).astype(np.int64))
    _same(jp.mul(jA, jB), tp.mul(tA, tB))
    assert _from12(tp.mul(tA, tB)) == OF.fq12_mul(A, B)
    for k in (1, 2, 6):
        _same(jp.frobenius(jA, k), tp.frobenius(tA, k))
        assert _from12(tp.frobenius(tA, k)) == OF.fq12_frobenius(A, k)
    l0, l2, l3 = tB[0], tB[2], tB[3]
    _same(jp.sparse_mul(jA, jB[0], jB[2], jB[3]), tp.sparse_mul(tA, l0, l2, l3))
    got_inv = tp.inv(tA)
    _same(jp.inv(jA), got_inv)
    assert OF.fq12_eq(OF.fq12_mul(_from12(got_inv), A), OF.FQ12_ONE)
    assert bool(tp.is_one(torch.as_tensor(tp.FQ12_ONE)))
    assert not bool(tp.is_one(tA))
    assert tp.X_RUNS == jp.X_RUNS


@low_priority
def test_pow_x_matches_oracle(rng):
    A = _rand_fq12(rng)
    tA = torch.as_tensor(_limbs12(A).astype(np.int64))
    assert _from12(tp.pow_x_abs(tA)) == OF.fq12_pow(A, -OF.BLS_X)


@low_priority
def test_miller_loop_matches_oracle_after_final_exp(rng):
    sk = int.from_bytes(rng.bytes(32), "big") % OF.R
    p1 = oc.jac_mul(oc.FQ_OPS, oc.G1_GEN, sk)
    q2 = oc.hash_to_g2(b"torch miller loop test")
    px, py = tp.g1_affine(dc.g1_to_dev([p1]))
    qx, qy = tp.g2_affine(dc.g2_to_dev([q2]))
    f = _from12(tp.miller_loop(px, py, qx, qy)[0])
    p_aff = oc.jac_to_affine(oc.FQ_OPS, p1)
    q_aff = oc.jac_to_affine(oc.FQ2_OPS, q2)
    assert OF.fq12_eq(opair.final_exponentiation(f), opair.pairing(p_aff, q_aff))


@low_priority
def test_pairing_product_vs_jax_and_oracle(rng):
    """BLS verification equation: valid, corrupted and all-identity."""
    sk = int.from_bytes(rng.bytes(32), "big") % OF.R
    pk = oc.jac_mul(oc.FQ_OPS, oc.G1_GEN, sk)
    h = oc.hash_to_g2(b"device pairing test")
    sig = oc.jac_mul(oc.FQ2_OPS, h, sk)
    badsig = oc.jac_mul(oc.FQ2_OPS, h, (sk + 1) % OF.R)
    g1_pairs = [oc.G1_GEN, oc.jac_neg(oc.FQ_OPS, pk)]
    ident = [(1, 1, 0), (1, 1, 0)]
    cases = [(g1_pairs, [sig, h], True), (g1_pairs, [badsig, h], False),
             (ident, [badsig, h], True)]
    for g1s, g2s, want in cases:
        got = tp.pairing_product_is_one(dc.g1_to_dev(g1s), dc.g2_to_dev(g2s))
        assert bool(got) is want
        aff = [(oc.jac_to_affine(oc.FQ_OPS, a), oc.jac_to_affine(oc.FQ2_OPS, b))
               for a, b in zip(g1s, g2s)]
        aff = [(a, b) for a, b in aff if a is not None and b is not None]
        assert opair.multi_pairing_is_one(aff) is want
