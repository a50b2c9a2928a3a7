"""The arithmetic of the hand-written kernels (``csrc/fq.cuh``,
``csrc/curve.cuh``) on the CPU, against Python integers and the BLS oracle.

A CUDA kernel does not run here, but its headers are ``__host__
__device__`` code: ``csrc/host_check.cc`` includes them and is compiled
with the host C++ compiler into a temporary directory, and these tests
drive it.  The rows run as ``scan_g1_rows`` and ``scan_g2_rows`` run them,
and the sums as ``scan_g1_sums``' and ``scan_g2_sums``' trees, on teams of lanes
(``csrc/team.cuh``), the lanes of a stage (and the teams and blocks the
card runs side by side) one after another.  On
the card the same headers run, with the Montgomery rows as
PTX carry chains instead of ``uint64_t``; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernels against the plain versions there.

Tolerance: exact.  Field results are compared as canonical values mod P,
points as exact projective equality, verdicts as booleans; every output
must also be in the port's strict format (limbs < 2^11, value < P).
"""

import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.bls import curve as oc
from hbbft_tpu.crypto.bls import fields as OF
from hbbft_tpu.crypto.bls.suite import BLSSuite
from hbbft_tpu_torch.crypto.device import curve as dc
from hbbft_tpu_torch.crypto.device import fq, fq2
from hbbft_tpu_torch.crypto.device import scan as dscan
from torch_low_priority import low_priority

P = OF.P
NL = fq.NL
CSRC = Path(fq.__file__).resolve().parents[2] / "csrc"
R_INV = pow(1 << fq.R_BITS, -1, P)


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """The host build of the kernel headers (skips only without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel headers for the host")
    out = tmp_path_factory.mktemp("kernel_host") / "host_check"
    subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O2", "-Wall", "-Werror", f"-I{CSRC}",
         "-o", str(out), str(CSRC / "host_check.cc")],
        check=True, capture_output=True, text=True, timeout=300,
    )

    def run(lines):
        res = subprocess.run([str(out)], input="\n".join(lines) + "\n", check=True,
                             capture_output=True, text=True, timeout=300)
        rows = [[int(v) for v in row.split()] for row in res.stdout.splitlines()]
        assert len(rows) == len(lines)
        return rows

    return run


def _ints(a) -> str:
    return " ".join(str(int(v)) for v in np.asarray(a).reshape(-1))


def _strict_value(limbs) -> int:
    """Value of one output element, asserting the strict format."""
    arr = np.asarray(limbs)
    assert arr.min() >= 0 and arr.max() < 2048
    v = fq.from_limbs_int(arr)
    assert v < P
    return v


def _loose_limbs(rng: random.Random, value: int) -> np.ndarray:
    """Limbs of ``value`` with borrows pushed down, so that some limbs sit
    above 2047 (up to 4096, the top of the port's limb range)."""
    limbs = fq.to_limbs_np(value).copy()
    for i in rng.sample(range(NL - 1), 12):
        if limbs[i + 1] >= 2 and limbs[i] == 0 and rng.random() < 0.5:
            limbs[i + 1] -= 2
            limbs[i] = 4096
        elif limbs[i + 1] >= 1 and limbs[i] < 2048:
            limbs[i + 1] -= 1
            limbs[i] += 2048
    assert fq.from_limbs_int(limbs) == value and limbs.max() <= 4096
    return limbs


def _edge_operands(rng: random.Random, n: int):
    """n seeded operand pairs: random values below 2^386 (the product's
    input bound) in loose limbs, and the edges 0, 1, P - 1, P, 2P,
    2^386 - 1 and elements whose limbs are 4096."""
    edges = [0, 1, P - 1, P, 2 * P, (1 << 386) - 1, (1 << 385) + 4096]
    four = np.zeros(NL, dtype=np.int64)
    four[::3] = 4096  # many limbs of 4096, value < 2^386
    four[NL - 1] = 0
    pairs = []
    for i in range(n):
        a = edges[i] if i < len(edges) else rng.randrange(1 << 386)
        b = edges[-1 - i] if i < len(edges) else rng.randrange(1 << 386)
        la, lb = _loose_limbs(rng, a), _loose_limbs(rng, b)
        if i == len(edges):
            la = four
        if i == len(edges) + 1:
            la = lb = four
        pairs.append((la, lb))
    return pairs


def test_montgomery_product_and_conversions_match_python_ints(host_check):
    rng = random.Random(4)
    pairs = _edge_operands(rng, 1200)
    lines = []
    for la, lb in pairs:
        lines.append(f"M {_ints(la)} {_ints(lb)}")
        lines.append(f"R {_ints(la)}")
    out = host_check(lines)
    for k, (la, lb) in enumerate(pairs):
        a, b = fq.from_limbs_int(la), fq.from_limbs_int(lb)
        assert _strict_value(out[2 * k]) == a * b * R_INV % P, k
        assert _strict_value(out[2 * k + 1]) == a % P, k
    # The plain product on the same limbs gives the same values mod P.
    a = torch.as_tensor(np.stack([la for la, _ in pairs[:64]]))
    b = torch.as_tensor(np.stack([lb for _, lb in pairs[:64]]))
    plain = fq.mont_mul_plain(a, b)
    for k in range(64):
        assert fq.from_limbs_int(plain[k]) % P == _strict_value(out[2 * k]), k


def test_fq2_ops_match_python_ints(host_check):
    rng = random.Random(8)
    els = [((rng.randrange(P), rng.randrange(P)), (rng.randrange(P), rng.randrange(P)))
           for _ in range(40)]
    els[0] = ((0, 0), (P - 1, 1))
    lines = [f"F2 {_ints(fq2.to_mont_np(a))} {_ints(fq2.to_mont_np(b))}" for a, b in els]
    out = host_check(lines)
    for (a, b), row in zip(els, out):
        got = [fq2.from_mont_int(np.asarray(row[72 * k: 72 * (k + 1)]).reshape(2, NL))
               for k in range(7)]
        for k in range(7):
            for c in range(2):
                lo = 72 * k + NL * c
                _strict_value(row[lo: lo + NL])
        (a0, a1), (b0, b1) = a, b
        want = [
            ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P),
            ((a0 * a0 - a1 * a1) % P, (2 * a0 * a1) % P),
            (a0, (-a1) % P),
            ((a0 - a1) % P, (a0 + a1) % P),
            ((a0 + b0) % P, (a1 + b1) % P),
            ((a0 - b0) % P, (a1 - b1) % P),
            ((-a0) % P, (-a1) % P),
        ]
        assert got == want


def _rogue_g1():
    """A point on E(Fq) outside G1 (tests/test_torch_curve.py)."""
    x = 1
    while True:
        rhs = (x * x * x + oc.B1) % P
        y = pow(rhs, (P + 1) // 4, P)
        if y * y % P == rhs and not oc.g1_in_subgroup((x, y, 1)):
            return (x, y, 1)
        x += 1


def _row_cases(group):
    """Points and coefficients: a genuine point with a random 128-bit
    coefficient, the same with scalar 0 and with all 128 bits set, the
    identity, a non-subgroup point (the forged G2 point of
    ``_twist_sample_point``) and a point of small order."""
    suite = BLSSuite()
    rng = random.Random(11)
    if group == "g1":
        gen, ops = suite.g1_generator(), oc.FQ_OPS
        rogue = _rogue_g1()
        ident = suite.g1_identity().jac
    else:
        gen, ops = suite.g2_generator(), oc.FQ2_OPS
        rogue = oc._twist_sample_point()
        ident = suite.g2_identity().jac
    small = oc.jac_mul(ops, rogue, OF.R)  # order divides the cofactor
    genuine = (gen * 4321).jac
    jacs = [genuine, genuine, genuine, ident, rogue, small, gen.jac]
    coeffs = [rng.getrandbits(128), 0, (1 << 128) - 1, rng.getrandbits(128),
              rng.getrandbits(128), rng.getrandbits(128), 1]
    return jacs, coeffs, ops


def _g1_line(jac, c):
    x, y, z, inf = dc.g1_to_dev([jac])
    return f"G1 {_ints(x)} {_ints(y)} {_ints(z)} {int(inf[0])} {_ints(dscan.pack_words([c], 16))}"


def _g2_line(jac, c):
    x, y, z, inf = dc.g2_to_dev([jac])
    s, q = dc.decompose_g2_scalar(c)
    return (f"G2 {_ints(x)} {_ints(y)} {_ints(z)} {int(inf[0])} "
            f"{_ints(dscan.pack_words([s + (q << 64)], 20))}")


def _g1_out(row):
    x, y, z = (fq.from_mont_int(np.asarray(row[NL * k: NL * (k + 1)])) for k in range(3))
    return (x, y, z), row[3 * NL], row[3 * NL + 1]


def _g2_out(row):
    x, y, z = (fq2.from_mont_int(np.asarray(row[2 * NL * k: 2 * NL * (k + 1)]).reshape(2, NL))
               for k in range(3))
    return (x, y, z), row[6 * NL], row[6 * NL + 1]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_row_scans_match_oracle(host_check, group):
    jacs, coeffs, ops = _row_cases(group)
    line, parse = (_g1_line, _g1_out) if group == "g1" else (_g2_line, _g2_out)
    member = oc.g1_in_subgroup if group == "g1" else oc.g2_in_subgroup
    out = host_check([line(j, c) for j, c in zip(jacs, coeffs)])
    verdicts = []
    for k, (jac, c) in enumerate(zip(jacs, coeffs)):
        pt, inf, sub = parse(out[k])
        verdicts.append(bool(sub))
        if c == 0 or k == 3:  # scalar 0, the identity row
            assert inf == 1, k
        elif member(jac):
            assert inf == 0 and oc.jac_eq(ops, pt, oc.jac_mul(ops, jac, c)), k
    assert verdicts == [member(j) for j in jacs]
    assert verdicts == [True, True, True, True, False, False, True]


def _g2s_request(points, pieces, segments) -> str:
    """A G2S request: ``points`` as port-limb strings (x, y, z, inf)."""
    return (f"G2S {len(points)} {len(pieces) - 1} {len(segments) - 1} " + " ".join(points)
            + " " + _ints(pieces) + " " + _ints(segments))


def _g2s_out(row, n_seg):
    """The segment sums of a G2S answer as (oracle jac, inf)."""
    width = 6 * NL + 1
    assert len(row) == n_seg * width
    sums = []
    for g in range(n_seg):
        seg = row[g * width: (g + 1) * width]
        jac = tuple(fq2.from_mont_int(np.asarray(seg[2 * NL * k: 2 * NL * (k + 1)]).reshape(2, NL))
                    for k in range(3))
        sums.append((jac, seg[6 * NL]))
    return sums


@pytest.mark.parametrize("piece_rows", [1, 3, 100])
def test_g2_tree_sums_match_oracle(host_check, piece_rows):
    """``scan_g2_sums``' two passes, each block's pairwise tree on six-lane
    teams, against the oracle's running sum: segments of 1, 2, 3 and 5
    rows, one of 70 (more than a piece, and more points than a block holds
    at once in one pass or the other), one of identity records only, and
    identity records among the others whose coordinates are a real point's
    (the flag alone makes the identity)."""
    ops = oc.FQ2_OPS
    sizes = [1, 2, 3, 5, 70, 4, 9]
    ident = {(4, 0), (5, 0), (5, 1), (5, 2), (5, 3), (6, 4), (6, 8), (3, 2)}
    # [2^i] G: no partial sum of distinct powers equals another or its
    # negative, so add_unsafe's forbidden pairs cannot occur.
    pt = BLSSuite().g2_generator().jac
    points, want = [], []
    for g, size in enumerate(sizes):
        acc = oc.jac_identity(ops)
        for r in range(size):
            x, y, z, _ = dc.g2_to_dev([pt])
            flag = int((g, r) in ident)
            points.append(f"{_ints(x)} {_ints(y)} {_ints(z)} {flag}")
            if not flag:
                acc = oc.jac_add(ops, acc, pt)
            pt = oc.jac_double(ops, pt)
        want.append(acc)
    seg_of_row = [g for g, size in enumerate(sizes) for _ in range(size)]
    pieces, segments = dscan.cut_pieces(seg_of_row, len(sizes), piece_rows)
    (row,) = host_check([_g2s_request(points, pieces, segments)])
    got = _g2s_out(row, len(sizes))
    for g, ((jac, inf), w) in enumerate(zip(got, want)):
        if g == 5:
            assert inf == 1
        else:
            assert inf == 0 and oc.jac_eq(ops, jac, w), g


def _g1s_request(points, pieces, segments) -> str:
    """A G1S request: ``points`` as port-limb strings (x, y, z, inf)."""
    return (f"G1S {len(points)} {len(pieces) - 1} {len(segments) - 1} " + " ".join(points)
            + " " + _ints(pieces) + " " + _ints(segments))


def _g1s_out(row, n_seg):
    """The segment sums of a G1S answer as (oracle jac, inf), strict limbs."""
    width = 3 * NL + 1
    assert len(row) == n_seg * width
    sums = []
    for g in range(n_seg):
        seg = row[g * width: (g + 1) * width]
        jac = tuple(_strict_value(seg[NL * k: NL * (k + 1)]) * R_INV % P for k in range(3))
        sums.append((jac, seg[3 * NL]))
    return sums


G1_SUM_SIZES = [1, 2, 3, 5, 70, 4, 9]
G1_SUM_IDENT = {(4, 0), (5, 0), (5, 1), (5, 2), (5, 3), (6, 4), (6, 8), (3, 2), (4, 69)}


@pytest.fixture(scope="module")
def g1_sum_case():
    """The G1 tree sums' points and the oracle's and the plain
    ``_masked_sums``' segment sums, computed once for the module.  The
    points are [2^i] G: no partial sum of distinct powers equals another or
    its negative, so add_unsafe's forbidden pairs cannot occur; identity
    records keep a real point's coordinates (the flag alone makes the
    identity)."""
    from hbbft_tpu_torch.crypto.device import backend as dbackend

    ops = oc.FQ_OPS
    pt = BLSSuite().g1_generator().jac
    jacs, flags, want = [], [], []
    for g, size in enumerate(G1_SUM_SIZES):
        acc = oc.jac_identity(ops)
        for r in range(size):
            jacs.append(pt)
            flag = int((g, r) in G1_SUM_IDENT)
            flags.append(flag)
            if not flag:
                acc = oc.jac_add(ops, acc, pt)
            pt = oc.jac_double(ops, pt)
        want.append(acc)
    x, y, z, _ = dc.g1_to_dev(jacs)
    inf = torch.as_tensor(flags, dtype=torch.int64)
    points = [f"{_ints(x[i])} {_ints(y[i])} {_ints(z[i])} {flags[i]}" for i in range(len(jacs))]
    seg_of_row = [g for g, size in enumerate(G1_SUM_SIZES) for _ in range(size)]
    mask = torch.zeros((len(G1_SUM_SIZES), len(jacs)), dtype=torch.bool)
    mask[seg_of_row, torch.arange(len(jacs))] = True
    with torch.inference_mode():
        plain = low_priority(dbackend._masked_sums)(dc.G1_OPS, (x, y, z, inf), mask)
    return points, seg_of_row, want, plain


@pytest.mark.parametrize("piece_rows", [1, 3, 100])
def test_g1_tree_sums_match_oracle_and_plain(host_check, g1_sum_case, piece_rows):
    """``scan_g1_sums``' two passes, each block's pairwise tree on teams of
    four lanes, against the oracle's running sum and the plain
    ``_masked_sums``: segments of 1, 2, 3 and 5 rows, one of 70 (more than
    a piece, and more points than a block holds at once in one pass or the
    other), one of identity records only, and identity records among the
    others."""
    ops = oc.FQ_OPS
    points, seg_of_row, want, plain = g1_sum_case
    pieces, segments = dscan.cut_pieces(seg_of_row, len(G1_SUM_SIZES), piece_rows)
    (row,) = host_check([_g1s_request(points, pieces, segments)])
    for g, ((jac, inf), w) in enumerate(zip(_g1s_out(row, len(G1_SUM_SIZES)), want)):
        assert inf == int(plain[3][g]), g
        if g == 5:
            assert inf == 1
        else:
            assert inf == 0 and oc.jac_eq(ops, jac, w), g
            assert oc.jac_eq(ops, jac, dc.g1_from_dev(plain, g)), g


def test_g2_row_product_counts_match_chip_smoke(host_check):
    """``chip_smoke.py``'s products of one G2 row and the critical path it
    gives for ``scan_g2_rows`` (the RLC scan's warp; the check chain runs
    beside it in another warp) are what the team code runs, whatever the
    row's data: every step runs the same stages."""
    import chip_smoke as cs

    jacs, coeffs, _ = _row_cases("g2")
    lines = ["N"]
    for k in (0, 3, 4):  # a genuine point, the identity, the forged point
        lines += [_g2_line(jacs[k], coeffs[k]), "N"]
    counts = [tuple(row) for line, row in zip(lines, host_check(lines)) if line == "N"][1:]
    assert counts == [(cs.G2_ROW_PRODUCTS, cs.G2_ROW_PATH)] * 3


def test_g1_row_and_g2_sum_counts_match_chip_smoke(host_check):
    """``chip_smoke.py``'s work and critical path of one G1 row of
    ``scan_g1_rows`` and of ``scan_g1_sums`` and ``scan_g2_sums`` at a
    firehose chunk's layout (2,048 rows in one segment, pieces of
    ``PIECE_ROWS``) are what the team code runs, whatever the data: every
    step and every tree level runs the same stages."""
    import chip_smoke as cs

    jacs, coeffs, _ = _row_cases("g1")
    lines = ["N"]
    for k in (0, 1, 3, 4):  # genuine, scalar 0, the identity, the forged point
        lines += [_g1_line(jacs[k], coeffs[k]), "N"]
    n = 2048
    pieces, segments = dscan.cut_pieces([0] * n, 1, dscan.PIECE_ROWS)
    x, y, z, inf = dc.g2_to_dev([BLSSuite().g2_generator().jac])
    lines += [_g2s_request([f"{_ints(x)} {_ints(y)} {_ints(z)} 0"] * n, pieces, segments), "N"]
    x, y, z, inf = dc.g1_to_dev([BLSSuite().g1_generator().jac])
    lines += [_g1s_request([f"{_ints(x)} {_ints(y)} {_ints(z)} 0"] * n, pieces, segments), "N"]
    counts = [tuple(row) for line, row in zip(lines, host_check(lines)) if line == "N"][1:]
    assert counts == [(cs.G1_ROW_PRODUCTS, cs.G1_ROW_PATH)] * 4 + [
        (cs.G2_SUMS_PRODUCTS, cs.G2_SUMS_PATH), (cs.G1_SUMS_PRODUCTS, cs.G1_SUMS_PATH)]


def _scan_subsets():
    """Two RLC subsets of the three request kinds; the second holds the
    forged non-subgroup share (tests/test_torch_backend.py::_forged)."""
    from hbbft_tpu_torch.crypto import keys
    from hbbft_tpu_torch.crypto.backend import VerifyRequest as Req
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite as PortSuite
    from hbbft_tpu_torch.crypto.bls.suite import G2Elem

    suite = PortSuite()
    rng = random.Random(21)
    sks = keys.SecretKeySet.random(1, rng, suite)
    pks = sks.public_keys()
    sig = [Req.sig_share(pks.public_key_share(i), b"doc %d" % (i % 2),
                         sks.secret_key_share(i).sign(b"doc %d" % (i % 2))) for i in range(5)]
    ct = pks.public_key().encrypt(b"tx", rng)
    dec = Req.dec_share(pks.public_key_share(2), ct, sks.secret_key_share(2).decryption_share(ct))
    forged = Req.sig_share(pks.public_key_share(3), b"doc 1",
                           keys.SignatureShare(G2Elem(oc._twist_sample_point()), suite))
    return suite, [sig[:3] + [Req.ciphertext(ct), dec], sig[3:] + [forged]]


def test_kernel_scan_layout_matches_oracle_sums(host_check, monkeypatch):
    """The K2 host prep (packed words, rows ordered by leg, pieces) with
    the kernels' row scans and both groups' sums run by the host build:
    the sums and verdicts the kernels would return, against oracle sums
    over the plain scan's own inputs."""
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend

    monkeypatch.setattr(dscan, "PIECE_ROWS", 1)  # several pieces per segment
    suite, subsets = _scan_subsets()
    be = TorchBackend(suite, device="cpu")
    inp, pair_sub = be._scan_prep(subsets, kernel=True)
    plain, plain_pair_sub = be._scan_prep(subsets, kernel=False)
    assert pair_sub == plain_pair_sub
    assert inp.g1_pieces.tolist()[-1] == inp.g1_words.shape[0]
    assert len(inp.g1_pieces) > len(inp.g1_segments)  # segments were cut

    def words_int(words) -> int:
        return sum((int(w) & 0xFFFFFFFF) << (32 * k) for k, w in enumerate(words.tolist()))

    xabs = -OF.BLS_X
    sq = [words_int(w) for w in inp.g2_words]
    g1 = [_g1_line(dc.g1_from_dev(inp.g1_pts, i), words_int(w))
          for i, w in enumerate(inp.g1_words)]
    g2 = [_g2_line(dc.g2_from_dev(inp.g2_pts, i), (v >> 64) * xabs + (v & ((1 << 64) - 1)))
          for i, v in enumerate(sq)]
    raw1 = host_check(g1)
    rows1 = [_g1_out(r) for r in raw1]
    raw2 = host_check(g2)
    rows2 = [_g2_out(r) for r in raw2]

    # The G1 sums as scan_g1_sums' trees run them, over the rows' records.
    (g1s,) = host_check([_g1s_request([_ints(r[: 3 * NL + 1]) for r in raw1],
                                      inp.g1_pieces, inp.g1_segments)])
    leg_sums = [jac if not inf else oc.jac_identity(oc.FQ_OPS)
                for jac, inf in _g1s_out(g1s, inp.g1_segments.shape[0] - 1)]
    # The G2 sums as scan_g2_sums' trees run them, over the rows' records.
    (g2s,) = host_check([_g2s_request([_ints(r[: 6 * NL + 1]) for r in raw2],
                                      inp.g2_pieces, inp.g2_segments)])
    gen_legs = [jac if not inf else oc.jac_identity(oc.FQ2_OPS)
                for jac, inf in _g2s_out(g2s, inp.n_sub)]
    assert len(inp.g2_pieces) > len(inp.g2_segments)  # segments were cut
    sub_ok = [True] * inp.n_sub
    for rows, chk, sub in ((rows1, inp.g1_chk, inp.g1_sub), (rows2, inp.g2_chk, inp.g2_sub)):
        for (_, _, ok), c, s in zip(rows, chk.tolist(), sub.tolist()):
            if c and not ok:
                sub_ok[s] = False
    assert sub_ok == [True, False]

    # The oracle over the plain scan's inputs: bit matrices and one-hot masks.
    (g1_pts, g1_bits, g1_chk, seg, g1_sub, g2_pts, g2_bits_s, g2_bits_q, g2_chk,
     g2_sub, _rhs, _gen) = plain
    c1 = [int("".join(map(str, b.tolist()[::-1])), 2) for b in g1_bits]
    c2 = [int("".join(map(str, q.tolist())), 2) * xabs + int("".join(map(str, s.tolist())), 2)
          for s, q in zip(g2_bits_s, g2_bits_q)]
    p1 = [dc.g1_from_dev(g1_pts, i) for i in range(len(c1))]
    p2 = [dc.g2_from_dev(g2_pts, i) for i in range(len(c2))]
    for l in range(seg.shape[0]):
        want = oc.jac_identity(oc.FQ_OPS)
        for i in np.flatnonzero(seg[l].numpy()):
            want = oc.jac_add(oc.FQ_OPS, want, oc.jac_mul(oc.FQ_OPS, p1[i], c1[i]))
        assert oc.jac_eq(oc.FQ_OPS, leg_sums[l], want), l
    for s in range(len(subsets)):
        want = oc.jac_identity(oc.FQ2_OPS)
        for i in np.flatnonzero(g2_sub[s].numpy()):
            if oc.g2_in_subgroup(p2[i]):  # [c]Q by psi is exact for members only
                want = oc.jac_add(oc.FQ2_OPS, want, oc.jac_mul(oc.FQ2_OPS, p2[i], c2[i]))
        if s == 0:
            assert oc.jac_eq(oc.FQ2_OPS, gen_legs[s], want)
    want_ok = [all(oc.g1_in_subgroup(p1[i]) or not g1_chk[i] for i in np.flatnonzero(g1_sub[s].numpy()))
               and all(oc.g2_in_subgroup(p2[i]) or not g2_chk[i]
                       for i in np.flatnonzero(g2_sub[s].numpy()))
               for s in range(len(subsets))]
    assert sub_ok == want_ok


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend

    a = torch.as_tensor(fq.to_mont_batch([3, 5, P - 1]))
    build.reset_launches()
    assert torch.equal(fq.mont_mul(a, a.flip(0)), fq.mont_mul_plain(a, a.flip(0)))
    assert not build.LAUNCHES
    # The kernel wrappers refuse CPU tensors instead of falling back.
    with pytest.raises(ValueError):
        fq.mont_mul_kernel(a, a)
    suite, subsets = _scan_subsets()
    inp, _ = TorchBackend(suite, device="cpu")._scan_prep(subsets, kernel=True)
    with pytest.raises(ValueError):
        dscan.scan_stage_kernel(inp)
    assert not build.LAUNCHES
