"""Port Jacobian G1/G2 ops, RLC scans, endomorphism subgroup checks and
tree sums vs the JAX package's ``crypto/tpu/curve.py`` and the BLS oracle
``crypto/bls/curve.py``.

Tolerance: exact.  Where both packages run the same formula the limb
arrays are equal; points are otherwise compared as exact projective
equality of canonical integers (``oc.jac_eq``), and verdicts as booleans.
The scan checks reuse the shapes and seeds of
``tests/test_tpu_crypto.py::test_device_endo_subgroup_matches_oracle``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.bls import curve as oc
from hbbft_tpu.crypto.bls import fields as OF
from hbbft_tpu.crypto.bls.suite import BLSSuite
from hbbft_tpu.crypto.tpu import curve as jc
from hbbft_tpu_torch.crypto.device import curve as dc
from torch_low_priority import low_priority

# Small tensors: intra-op threads only contend with the other test workers.
torch.set_num_threads(1)

P = OF.P


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


def _rand_points(rng, n):
    g1s = [oc.jac_mul(oc.FQ_OPS, oc.G1_GEN, int.from_bytes(rng.bytes(32), "big") % OF.R)
           for _ in range(n)]
    g2s = [oc.jac_mul(oc.FQ2_OPS, oc.G2_GEN, int.from_bytes(rng.bytes(32), "big") % OF.R)
           for _ in range(n)]
    return g1s, g2s


def _same_point(jpt, tpt):
    for j, t in zip(jpt, tpt):
        np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


def _rogue_g1():
    x = 1
    while True:
        rhs = (x * x * x + oc.B1) % P
        y = pow(rhs, (P + 1) // 4, P)
        if y * y % P == rhs and not oc.g1_in_subgroup((x, y, 1)):
            return (x, y, 1)
        x += 1


@low_priority
def test_jacobian_ops_match_jax_and_oracle(rng):
    n = 4
    g1s, g2s = _rand_points(rng, n)
    for ops_t, ops_j, o_ops, pts, to_t, to_j, frm in (
        (dc.G1_OPS, jc.G1_OPS, oc.FQ_OPS, g1s, dc.g1_to_dev, jc.g1_to_dev, dc.g1_from_dev),
        (dc.G2_OPS, jc.G2_OPS, oc.FQ2_OPS, g2s, dc.g2_to_dev, jc.g2_to_dev, dc.g2_from_dev),
    ):
        tp, jp = to_t(pts), to_j(pts)
        _same_point(jp, tp)
        td = dc.double(ops_t, tp)
        _same_point(jc.double(ops_j, jp), td)
        ts = dc.add_unsafe(ops_t, tp, td)
        _same_point(jc.add_unsafe(ops_j, jp, jc.double(ops_j, jp)), ts)
        tn = dc.neg(ops_t, tp)
        _same_point(jc.neg(ops_j, jp), tn)
        flag = torch.tensor([1, 0, 1, 0])
        _same_point(
            jc.select(jnp.asarray(flag.numpy()), jp, jc.double(ops_j, jp), ops_j),
            dc.select(flag, tp, td, ops_t),
        )
        tt = dc.tree_sum(ops_t, tp)
        _same_point(jc.tree_sum(ops_j, jp), tt)
        acc = oc.jac_identity(o_ops)
        for i in range(n):
            assert oc.jac_eq(o_ops, frm(td, i), oc.jac_double(o_ops, pts[i]))
            assert oc.jac_eq(o_ops, frm(ts, i), oc.jac_mul(o_ops, pts[i], 3))
            acc = oc.jac_add(o_ops, acc, pts[i])
        assert oc.jac_eq(o_ops, frm(tt), acc)
        eq = dc.jac_eq_dev(ops_t, dc.add_unsafe(ops_t, td, tp), ts)
        assert eq.tolist() == [True] * n
        assert dc.jac_eq_dev(ops_t, td, tp).tolist() == [False] * n


@low_priority
def test_scalar_mul_identity_flags_and_add_safe(rng):
    g1s, g2s = _rand_points(rng, 2)
    P1, P2 = dc.g1_to_dev(g1s), dc.g2_to_dev(g2s)
    scalars = [int.from_bytes(rng.bytes(8), "big") | 1 for _ in range(2)]
    m2 = dc.scalar_mul(dc.G2_OPS, P2, dc.scalars_to_bits(scalars, 64))
    for i in range(2):
        assert oc.jac_eq(oc.FQ2_OPS, dc.g2_from_dev(m2, i),
                         oc.jac_mul(oc.FQ2_OPS, g2s[i], scalars[i]))
    z = dc.scalar_mul(dc.G1_OPS, P1, torch.zeros((2, 16), dtype=torch.int64))
    assert z[3].tolist() == [1, 1]
    s = dc.add_unsafe(dc.G1_OPS, dc.identity(dc.G1_OPS, (2,)), P1)
    dbl = dc.add_safe(dc.G1_OPS, P1, P1)
    cancel = dc.add_safe(dc.G1_OPS, P1, dc.neg(dc.G1_OPS, P1))
    for i in range(2):
        assert oc.jac_eq(oc.FQ_OPS, dc.g1_from_dev(s, i), g1s[i])
        assert oc.jac_eq(oc.FQ_OPS, dc.g1_from_dev(dbl, i), oc.jac_double(oc.FQ_OPS, g1s[i]))
    assert cancel[3].tolist() == [1, 1]


def _scan_case(group):
    """Points, membership verdicts and RLC coefficients of
    test_tpu_crypto.py::test_device_endo_subgroup_matches_oracle."""
    suite = BLSSuite()
    gen2 = suite.g2_generator()
    rogue2 = oc._twist_sample_point()  # on E'(Fq2), outside G2
    cof2 = oc.jac_mul(oc.FQ2_OPS, rogue2, OF.R)  # order | h2
    g2_jacs = [rogue2, cof2, gen2.jac, (gen2 * 9999).jac, suite.g2_identity().jac]
    rng5 = random.Random(5)
    coeffs = [rng5.getrandbits(128) for _ in range(len(g2_jacs))]
    if group == "g2":
        return g2_jacs, [oc.g2_in_subgroup(j) for j in g2_jacs], coeffs
    gen1 = suite.g1_generator()
    g1_jacs = [_rogue_g1(), gen1.jac, (gen1 * 31337).jac, suite.g1_identity().jac]
    return g1_jacs, [oc.g1_in_subgroup(j) for j in g1_jacs], coeffs[: len(g1_jacs)]


@pytest.mark.parametrize("group", ["g1", "g2"])
@low_priority
def test_rlc_scan_and_endo_subgroup_vs_jax_and_oracle(group):
    jacs, want, coeffs = _scan_case(group)
    if group == "g2":
        assert want == [False, False, True, True, True]
        sq = [dc.decompose_g2_scalar(c) for c in coeffs]
        assert sq == [jc.decompose_g2_scalar(c) for c in coeffs]
        bs, bq = [s for s, _ in sq], [q for _, q in sq]
        pts = dc.g2_to_dev(jacs)
        scaled, chain = dc.scalar_mul_rlc_g2(
            pts, dc.scalars_to_bits(bs, dc.G2_SCAN_NBITS),
            dc.scalars_to_bits(bq, dc.G2_SCAN_NBITS),
        )
        jpts = jc.g2_to_dev(jacs)
        jscaled, jchain = jc.scalar_mul_rlc_g2(
            jpts, jc.scalars_to_bits(bs, jc.G2_SCAN_NBITS),
            jc.scalars_to_bits(bq, jc.G2_SCAN_NBITS),
        )
        ops, jops, o_ops, frm = dc.G2_OPS, jc.G2_OPS, oc.FQ2_OPS, dc.g2_from_dev
    else:
        assert want == [False, True, True, True]
        pts = dc.g1_to_dev(jacs)
        scaled, chain = dc.scalar_mul_rlc_g1(
            pts, dc.scalars_to_bits_lsb(coeffs, dc.ENDO_NBITS)
        )
        jpts = jc.g1_to_dev(jacs)
        jscaled, jchain = jc.scalar_mul_rlc_g1(
            jpts, jc.scalars_to_bits_lsb(coeffs, jc.ENDO_NBITS)
        )
        ops, jops, o_ops, frm = dc.G1_OPS, jc.G1_OPS, oc.FQ_OPS, dc.g1_from_dev
    _same_point(jscaled, scaled)
    _same_point(jchain, chain)
    assert dc.endo_subgroup_eq(ops, pts, chain).tolist() == want
    assert list(map(bool, np.asarray(jc.endo_subgroup_eq(jops, jpts, jchain)))) == want
    for i, j in enumerate(jacs):
        if want[i]:
            assert oc.jac_eq(o_ops, frm(scaled, i), oc.jac_mul(o_ops, j, coeffs[i]))


@low_priority
def test_rlc_width_guard_raises():
    pts = dc.g1_to_dev([oc.G1_GEN])
    with pytest.raises(ValueError):
        dc.scalar_mul_rlc_g1(pts, torch.zeros((1, 64), dtype=torch.int64))
