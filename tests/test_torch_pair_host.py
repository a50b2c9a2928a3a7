"""The pair stage's kernel arithmetic (``csrc/fq12.cuh``, ``csrc/tower.cuh``,
``csrc/pairing.cuh`` and the Fq/Fq2 inverses of ``csrc/fq.cuh``) on the
CPU, and the host layout of ``crypto/device/pair.py``.

``csrc/host_check.cc`` includes the kernels' headers and is built with the
host C++ compiler (as in ``tests/test_torch_kernel_host.py``); its ``ML``
and ``PF`` requests run the very functions each ``pair_miller`` warp and
each ``pair_final`` warp runs, the warp's lanes one after another between
its barriers.  They are held against Python integers, the
BLS oracle (``crypto/bls/pairing.py``), the port's plain pairing
(``crypto/device/pairing.py``, ``backend.pair_stage_plain``) and the JAX
package's ``pairing_product_is_one``.  On the card
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernels against
the plain stage.

Tolerance: exact.  Field and Fq12 values are compared as canonical values
mod P (coefficient by coefficient in the w basis), verdicts as booleans,
and every kernel output must be in the port's strict format.
"""

import random

import jax
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.bls import curve as oc
from hbbft_tpu.crypto.bls import fields as OF
from hbbft_tpu.crypto.bls import pairing as opair
from hbbft_tpu.crypto.tpu import curve as jcurve
from hbbft_tpu.crypto.tpu import pairing as jpairing
from hbbft_tpu_torch import build
from hbbft_tpu_torch.crypto.device import backend as dbackend
from hbbft_tpu_torch.crypto.device import curve as dc
from hbbft_tpu_torch.crypto.device import fq, fq2
from hbbft_tpu_torch.crypto.device import pair as dpair
from hbbft_tpu_torch.crypto.device import pairing as tp
from test_torch_kernel_host import _ints, _loose_limbs, _strict_value, host_check  # noqa: F401
from torch_low_priority import low_priority

# Small tensors: intra-op threads only contend with the other test workers.
torch.set_num_threads(1)

P = OF.P
NL = fq.NL
CPU = torch.device("cpu")


def _fq12_limbs(a) -> np.ndarray:
    return np.stack([fq2.to_mont_np(c) for c in a])


def _fq12_value(limbs):
    """Canonical Fq12 of (6, 2, 36) limbs, asserting the strict format."""
    arr = np.asarray(limbs).reshape(6, 2, NL)
    for i in range(6):
        for c in range(2):
            _strict_value(arr[i, c])
    return tuple(fq2.from_mont_int(arr[i]) for i in range(6))


def _plain_value(t: torch.Tensor):
    arr = t.numpy()
    return tuple(fq2.from_mont_int(arr[i]) for i in range(6))


def _gam_line() -> str:
    return f"GAM {_ints(dpair.gamma_limbs(CPU))}"


def _rand_fq12(rng):
    return tuple((rng.randrange(P), rng.randrange(P)) for _ in range(6))


def _cube(a):
    return OF.fq12_mul(OF.fq12_sqr(a), a)


def test_inverses_match_python_ints(host_check):
    """The Fermat inverse on Montgomery limbs w (x = w / R): the output is
    x^-1 R = R^2 / w, and 0 for w = 0 mod P; inputs in loose limbs up to
    the top of the port's range."""
    rng = random.Random(31)
    vals = [0, 1, 2, P - 1, P, 2 * P, (1 << 386) - 1] + [rng.randrange(1 << 386)
                                                        for _ in range(20)]
    out = host_check([f"I {_ints(_loose_limbs(rng, w))}" for w in vals])
    for w, row in zip(vals, out):
        assert _strict_value(row) == pow(w, P - 2, P) * fq.R * fq.R % P, w
    els = [((0, 0), 5), ((1, 0), 7), ((0, 1), P - 1)] + [
        ((rng.randrange(P), rng.randrange(P)), rng.randrange(P)) for _ in range(20)]
    out = host_check([f"I2 {_ints(fq2.to_mont_np(a))} {_ints(fq.to_mont_np(s))}"
                      for a, s in els])
    for (a, s), row in zip(els, out):
        inv = fq2.from_mont_int(np.asarray(row[:2 * NL]).reshape(2, NL))
        prod = fq2.from_mont_int(np.asarray(row[2 * NL:]).reshape(2, NL))
        assert inv == (OF.fq2_inv(a) if a != (0, 0) else (0, 0))
        assert prod == (a[0] * s % P, a[1] * s % P)


def test_fq12_ops_match_oracle_and_plain(host_check):
    """pair_miller's square and line product and pair_final's tower ops
    (run by the host build lane after lane) against the oracle."""
    rng = random.Random(12)
    cases = [(_rand_fq12(rng), _rand_fq12(rng)) for _ in range(3)]
    cases.append((OF.FQ12_ONE, _rand_fq12(rng)))
    cases.append((OF.FQ12_ZERO, _rand_fq12(rng)))
    lines = [_gam_line()] + [f"F12 {_ints(_fq12_limbs(a))} {_ints(_fq12_limbs(b))}"
                             for a, b in cases]
    out = host_check(lines)[1:]
    zero = (0, 0)
    for (a, b), row in zip(cases, out):
        got = [_fq12_value(row[432 * k: 432 * (k + 1)]) for k in range(8)]
        sparse = (b[0], zero, b[2], b[3], zero, zero)
        want = [OF.fq12_sqr(a), OF.fq12_mul(a, sparse), OF.fq12_conjugate(a),
                OF.fq12_mul(a, b), OF.fq12_conjugate(a)]
        want += [OF.fq12_frobenius(a, k) for k in dpair.GAMMA_KS]
        want.append(OF.fq12_inv(a) if a != OF.FQ12_ZERO else OF.FQ12_ZERO)
        assert got == want
        assert row[-1] == (a == OF.FQ12_ONE)
    # conj without gamma constants equals the plain frobenius(a, 6).
    a = cases[0][0]
    assert _fq12_value(out[0][432 * 2: 432 * 3]) == _plain_value(
        tp.frobenius(torch.as_tensor(_fq12_limbs(a)), 6))


def test_tower_map_round_trips(host_check):
    """w basis -> tower slots (g0 g1 g2 h0 h1 h2 = c0 c2 c4 c1 c3 c5) -> w
    basis gives the value back."""
    rng = random.Random(13)
    for a in (_rand_fq12(rng), OF.FQ12_ONE):
        row = host_check([f"TW {_ints(_fq12_limbs(a))}"])[0]
        slots = _fq12_value(row[:432])
        assert slots == tuple(a[i] for i in (0, 2, 4, 1, 3, 5))
        assert _fq12_value(row[432:]) == a


def _easy_part(a):
    """a^((p^6 - 1)(p^2 + 1)): a value of the cyclotomic subgroup."""
    f1 = OF.fq12_mul(OF.fq12_conjugate(a), OF.fq12_inv(a))
    return OF.fq12_mul(OF.fq12_frobenius(f1, 2), f1)


def test_cyclotomic_square_matches_generic_square(host_check):
    """On values after the easy part the Granger-Scott square equals the
    tower product f f and the oracle's square, and the power by x built on
    it equals the oracle's; on a value outside the subgroup it does not."""
    rng = random.Random(14)
    cyc = [_easy_part(_rand_fq12(rng)) for _ in range(2)] + [OF.FQ12_ONE]
    out = host_check([f"CS {_ints(_fq12_limbs(f))}" for f in cyc])
    for f, row in zip(cyc, out):
        square, product, power = (_fq12_value(row[432 * k: 432 * (k + 1)]) for k in range(3))
        assert square == product == OF.fq12_sqr(f)
        assert power == OF.fq12_inv(OF.fq12_pow(f, -OF.BLS_X))
    outside = _rand_fq12(rng)
    row = host_check([f"CS {_ints(_fq12_limbs(outside))}"])[0]
    assert _fq12_value(row[:432]) != OF.fq12_sqr(outside)
    assert _fq12_value(row[432:864]) == OF.fq12_sqr(outside)


def _bls_pairs():
    """The pairs of ``test_torch_pairing.py::test_pairing_product_vs_jax_and_oracle``:
    the BLS verification equation e(g1, sig) e(-pk, H(m)) == 1, valid
    and corrupted, and the same with both G1 points the identity."""
    rng = np.random.default_rng(42)
    sk = int.from_bytes(rng.bytes(32), "big") % OF.R
    pk = oc.jac_mul(oc.FQ_OPS, oc.G1_GEN, sk)
    h = oc.hash_to_g2(b"device pairing test")
    sig = oc.jac_mul(oc.FQ2_OPS, h, sk)
    badsig = oc.jac_mul(oc.FQ2_OPS, h, (sk + 1) % OF.R)
    g1 = [oc.G1_GEN, oc.jac_neg(oc.FQ_OPS, pk)]
    ident = [(1, 1, 0), (1, 1, 0)]
    return [(g1, [sig, h], True), (g1, [badsig, h], False), (ident, [badsig, h], True)]


def _stage_inputs():
    """The three cases as one pair stage: subsets 0, 1, 2 are the cases,
    subset 3 a single non-identity pair (False) and subset 4 a single
    pair with the G2 identity (True)."""
    cases = _bls_pairs()
    g1s, g2s, pair_sub = [], [], []
    for s, (a, b, _) in enumerate(cases):
        g1s += a
        g2s += b
        pair_sub += [s, s]
    g1s += [oc.G1_GEN, oc.G1_GEN]
    g2s += [cases[0][1][0], ((1, 0), (1, 0), (0, 0))]
    pair_sub += [3, 4]
    # Interleave so that a subset's pairs are not adjacent: the CSR list
    # must keep each subset's own order.
    order = [0, 2, 4, 1, 3, 5, 6, 7]
    return ([g1s[i] for i in order], [g2s[i] for i in order], [pair_sub[i] for i in order],
            [True, False, True, False, True])


def _ml_line(g1, g2) -> str:
    x, y, z, inf = dc.g1_to_dev([g1])
    X, Y, Z, INF = dc.g2_to_dev([g2])
    return (f"ML {_ints(x)} {_ints(y)} {_ints(z)} {int(inf[0])} "
            f"{_ints(X)} {_ints(Y)} {_ints(Z)} {int(INF[0])}")


@pytest.fixture(scope="module")
def stage(host_check):
    """The stage's inputs, the host build's Miller values and the plain
    version's (computed once for the module)."""
    g1s, g2s, pair_sub, want = _stage_inputs()
    kernel_fs = np.stack([np.asarray(r).reshape(6, 2, NL)
                          for r in host_check([_ml_line(a, b) for a, b in zip(g1s, g2s)])])
    lhs, rhs = dc.g1_to_dev(g1s), dc.g2_to_dev(g2s)
    with torch.inference_mode():
        plain_fs = low_priority(tp.miller_values)(lhs, rhs)
    return g1s, g2s, pair_sub, want, lhs, rhs, kernel_fs, plain_fs


def _projective_miller(p_aff, q_aff):
    """The Miller loop of ``crypto/device/pairing.py`` (Jacobian T, lines
    scaled by T's coordinates) in the oracle's field arithmetic
    (``hbbft_tpu.crypto.bls.fields``): the value pair_miller must give
    coefficient by coefficient.  The oracle's own ``miller_loop`` scales
    its affine lines otherwise, which only the final exponentiation hides."""
    px, py = p_aff
    qx, qy = q_aff
    zero, one = (0, 0), (1, 0)
    mul, sqr, add, sub = OF.fq2_mul, OF.fq2_sqr, OF.fq2_add, OF.fq2_sub

    def k(a, n):
        return OF.fq2_muls(a, n)

    def line(l0, l2, l3):
        return (l0, zero, l2, l3, zero, zero)

    x, y, z, f = qx, qy, one, OF.FQ12_ONE
    for bit in bin(-OF.BLS_X)[3:]:
        a, b, z1z1 = sqr(x), sqr(y), sqr(z)
        l0 = sub(k(mul(x, a), 3), k(b, 2))
        l2 = OF.fq2_neg(OF.fq2_muls(k(mul(a, z1z1), 3), px))
        znew = k(mul(y, z), 2)
        l3 = OF.fq2_muls(mul(znew, z1z1), py)
        c = sqr(b)
        d = k(sub(sub(sqr(add(x, b)), a), c), 2)
        e = k(a, 3)
        x3 = sub(sqr(e), k(d, 2))
        x, y, z = x3, sub(mul(e, sub(d, x3)), k(c, 8)), znew
        f = OF.fq12_mul(OF.fq12_sqr(f), line(l0, l2, l3))
        if bit == "1":
            z1z1 = sqr(z)
            u2, s2 = mul(qx, z1z1), mul(qy, mul(z, z1z1))
            h, theta = sub(u2, x), sub(s2, y)
            hz = mul(h, z)
            l0 = sub(mul(theta, qx), mul(qy, hz))
            l2 = OF.fq2_muls(theta, (-px) % P)
            l3 = OF.fq2_muls(hz, py)
            i = k(sqr(h), 4)
            j, rr, v = mul(h, i), k(theta, 2), mul(x, i)
            x3 = sub(sub(sqr(rr), j), k(v, 2))
            x, y, z = x3, sub(mul(rr, sub(v, x3)), k(mul(y, j), 2)), k(hz, 2)
            f = OF.fq12_mul(f, line(l0, l2, l3))
    return OF.fq12_conjugate(f)


@low_priority
def test_miller_values_match_plain_and_oracle(host_check, stage):
    """pair_miller's value, its warp's lanes run one after another, equals
    the plain miller_values and the oracle-field Miller loop coefficient by
    coefficient (the same line scaling), 1 on identity pairs (P or Q the
    identity), and the oracle's pairing after the oracle's final
    exponentiation: valid pairs, identity pairs and pairs with a forged
    non-subgroup point on either side."""
    g1s, g2s, _, _, _, _, kernel_fs, plain_fs = stage
    from hbbft_tpu.crypto.bls.curve import _twist_sample_point
    from test_torch_kernel_host import _rogue_g1

    forged = [(_rogue_g1(), g2s[0]), (g1s[0], _twist_sample_point())]
    forged_fs = [np.asarray(r).reshape(6, 2, NL)
                 for r in host_check([_ml_line(a, b) for a, b in forged])]
    with torch.inference_mode():
        forged_plain = low_priority(tp.miller_values)(dc.g1_to_dev([a for a, _ in forged]),
                                                      dc.g2_to_dev([b for _, b in forged]))
    pairs = list(zip(g1s, g2s)) + forged
    fs = list(kernel_fs) + forged_fs
    plain = list(plain_fs) + list(forged_plain)
    skips = [i for i, (a, b) in enumerate(pairs) if a[2] == 0 or b[2] == (0, 0)]
    assert len(skips) == 3
    assert any(g1s[i][2] == 0 for i in skips) and any(g2s[i][2] == (0, 0) for i in skips)
    for i, (a, b) in enumerate(pairs):
        got = _fq12_value(fs[i])
        assert got == _plain_value(plain[i]), i
        if i in skips:
            assert got == OF.FQ12_ONE
            continue
        p_aff = oc.jac_to_affine(oc.FQ_OPS, a)
        q_aff = oc.jac_to_affine(oc.FQ2_OPS, b)
        assert got == _projective_miller(p_aff, q_aff), i
        if i in (0, len(pairs) - 2, len(pairs) - 1):  # valid, forged G1, forged G2
            assert OF.fq12_eq(opair.final_exponentiation(got), opair.pairing(p_aff, q_aff))


def test_final_exp_is_the_cube_of_the_oracles(host_check, stage):
    """The 3-hard chain gives e^3: the oracle's final exponentiation
    cubed, for a valid product (1) and single Miller values."""
    g1s, _, pair_sub, _, _, _, kernel_fs, _ = stage
    valid = [i for i, s in enumerate(pair_sub) if s == 0]
    f_valid = OF.fq12_mul(_fq12_value(kernel_fs[valid[0]]), _fq12_value(kernel_fs[valid[1]]))
    singles = [_fq12_value(kernel_fs[i]) for i in valid]
    fs = [f_valid] + singles
    out = host_check([_gam_line()] + [f"FE {_ints(_fq12_limbs(f))}" for f in fs])[1:]
    for f, row in zip(fs, out):
        want = _cube(opair.final_exponentiation(f))
        assert _fq12_value(row[:432]) == want
        assert row[432] == (want == OF.FQ12_ONE)
    assert [row[432] for row in out] == [1, 0, 0]


def test_subset_members_is_the_plain_product_order():
    offsets, members = dpair.subset_members([2, 0, 1, 0, 2, 2], 4)
    assert offsets.dtype == members.dtype == np.int32
    assert offsets.tolist() == [0, 2, 3, 6, 6]
    assert members.tolist() == [1, 3, 2, 0, 4, 5]
    with pytest.raises(ValueError):
        dpair.subset_members([0, 4], 4)


@low_priority
def test_pair_final_and_cpu_route_match_plain_stage(host_check, stage):
    """pair_final's per-subset verdicts on the CSR layout and the CPU
    route of ``backend.pair_stage`` (plain, no launch) agree with each
    other and with the oracle."""
    g1s, g2s, pair_sub, want, lhs, rhs, kernel_fs, _ = stage
    n_sub = len(want)
    offsets, members = dpair.subset_members(pair_sub, n_sub)
    out = host_check([_gam_line(), f"PF {len(g1s)} {n_sub} {_ints(kernel_fs)} "
                      f"{_ints(offsets)} {_ints(members)}"])[1]
    assert [bool(v) for v in out] == want
    # A zero Miller value (Fermat's 0^-1 = 0 keeps it 0 through the easy
    # part, outside the cyclotomic subgroup) gives False, alone or in a
    # product, as the plain final exponentiation does.
    zero_fs = np.concatenate([np.zeros((1, 6, 2, NL), dtype=np.int64), kernel_fs[:2]])
    out = host_check([_gam_line(), f"PF 3 2 {_ints(zero_fs)} 0 1 3 0 1 2"])[1]
    assert out == [0, 0]
    with torch.inference_mode():
        assert not bool(tp.final_exp_is_one(torch.zeros((6, 2, NL), dtype=torch.int64)))
    with torch.inference_mode():
        build.reset_launches()
        assert dbackend.pair_stage(lhs, rhs, pair_sub, n_sub).tolist() == want
    assert not build.LAUNCHES
    for s in range(n_sub):
        aff = [(oc.jac_to_affine(oc.FQ_OPS, g1s[i]), oc.jac_to_affine(oc.FQ2_OPS, g2s[i]))
               for i in range(len(g1s)) if pair_sub[i] == s]
        aff = [(a, b) for a, b in aff if a is not None and b is not None]
        assert opair.multi_pairing_is_one(aff) is want[s]
    # The kernel wrappers refuse CPU tensors instead of falling back.
    with pytest.raises(ValueError):
        dpair.miller_values_kernel(lhs, rhs)
    with pytest.raises(ValueError):
        dpair.pair_stage_kernel(lhs, rhs, pair_sub, n_sub)
    assert not build.LAUNCHES


@pytest.mark.slow
def test_plain_stage_matches_jax_pairing_product():
    """The plain pair stage, the CPU route, against the JAX package's
    ``pairing_product_is_one`` on the same three cases.  Marked slow: the
    JAX function compiles for many minutes on a CPU without a warm cache."""
    fn = jax.jit(jpairing.pairing_product_is_one)
    for g1, g2, want in _bls_pairs():
        got_jax = bool(fn(jcurve.g1_to_dev(g1), jcurve.g2_to_dev(g2)))
        with torch.inference_mode():
            got = bool(dbackend.pair_stage_plain(dc.g1_to_dev(g1), dc.g2_to_dev(g2),
                                                 [0, 0], 1)[0])
        assert got == got_jax == want


def test_product_counts_match_chip_smoke_chains(host_check, stage):
    """The Fq products ``chip_smoke.py`` gives as each K3 kernel's critical
    path (that of its warp, each lane's products counted on the longest
    chain of stages) and as its whole work are the products the kernels'
    code runs (host build, counted in ``fq.cuh``'s portable product), for a
    live pair and an identity pair of pair_miller; its bounds count less,
    on the same schedule of |x|."""
    import chip_smoke as cs

    g1s, g2s, _, _, _, _, kernel_fs, _ = stage
    lines = ["N", _ml_line(g1s[0], g2s[0]), "N", _ml_line((1, 1, 0), g2s[0]), "N",
             _gam_line(), "N", f"FE {_ints(kernel_fs[0])}", "N",
             f"PF 3 1 {_ints(kernel_fs[:3])} 0 3 0 1 2", "N"]
    counts = [tuple(row) for line, row in zip(lines, host_check(lines)) if line == "N"][1:]
    miller, identity, gammas, fe, pf3 = counts
    assert miller == (cs.MILLER_PRODUCTS, cs.MILLER_PATH)
    assert identity == (cs.MILLER_IDENTITY_PRODUCTS, cs.MILLER_IDENTITY_PATH)
    assert gammas == (cs.GAMMA_PRODUCTS, 1)  # one conversion per lane
    # FE reads f on 12 lanes and writes the result on one thread.
    read, write = 12, 12
    assert fe == (cs.FINAL_EXP_PRODUCTS + read + write, cs.FINAL_EXP_PATH + 1 + write)
    assert pf3 == (cs.FINAL_EXP_PRODUCTS + 3 * read + 2 * cs.FQ12_MUL_PRODUCTS,
                   cs.FINAL_EXP_PATH + 3 * cs.FQ12_READ_PATH + 2 * cs.FQ12_MUL_PATH)
    # The bounds' Miller loop and powers by |x| follow the plain schedule:
    # 63 doublings (squares) and an addition (product) at 5 set bits.
    assert sum(n for n, _ in tp.X_RUNS) == 63
    assert sum(1 for _, add in tp.X_RUNS if add) == 5
    assert cs.MILLER_NEED + cs.AFFINE_NEED[0] < miller[0]
    assert cs.FINAL_EXP_NEED < cs.FINAL_EXP_PRODUCTS
