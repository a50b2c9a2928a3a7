// Jacobian G1 (over Fq) and G2 (over Fq2) points for the scan kernel (K2),
// carried over from hbbft_tpu_torch/crypto/device/curve.py with the same
// formulas, the same explicit infinity flag and the same add_unsafe routing,
// so a kernel row and the plain scan give the same points.
//
// Like fq.cuh, every function is __host__ __device__: the host check in
// tests/test_torch_kernel_host.py runs these row scans and the G1 and G2
// tree sums against the oracle, the lanes and teams one after another.
//
// add_unsafe is WRONG when both inputs are the same non-identity point or
// exact negatives.  Every call below carries a "// safety:" line naming the
// argument (curve.py module docstring and its "Static-endo flush scans"
// notes) for why its inputs cannot be such a pair, or why a corrupted result
// can only make the subgroup check fail closed.

#pragma once

#include "fq.cuh"
#include "team.cuh"

namespace curve {

using fq::Fq;
using fq::Fq2;

template <class F>
struct Jac {
  F x, y, z;
  uint32_t inf;  // 1 = the identity, whatever x, y, z hold
};

using G1 = Jac<Fq>;
using G2 = Jac<Fq2>;

// Jacobian doubling on a = 0 curves (curve.py double :74), addition
// (add_unsafe :107) and projective equality (jac_eq_dev :183) are the
// formulas of the team code below.  add_unsafe routes identity flags (an
// identity p gives q, an identity q gives p) and does NOT handle p == +-q;
// each caller states why it cannot occur.

// GLV endomorphism on G1: X *= beta (curve.py phi_g1 :238).  beta in the
// kernel's Montgomery form (x * 2^384 mod P).
FQ_HD Fq g1_beta() {
  return Fq{{0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu, 0xc61577f7u, 0x16a8ca3au,
             0x74fd029bu, 0xc26a2ff8u, 0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu}};
}

// The constants of the untwist-Frobenius-twist on G2, psi(X, Y, Z) = (cx
// conj(X), cy conj(Y), conj(Z)) (curve.py psi_g2 :245), in the kernel's
// Montgomery form; g2team::psi applies it.
FQ_HD Fq2 psi_cx() {
  return Fq2{fq::fq_zero(),
             Fq{{0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
                 0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu}}};
}

FQ_HD Fq2 psi_cy() {
  return Fq2{Fq{{0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du, 0x8b623732u, 0x382844c8u,
                 0x19103e18u, 0x92ad2afdu, 0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu}},
             Fq{{0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
                 0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}}};
}

// ---------------------------------------------------------------------------
// The static-endo flush scans (curve.py scalar_mul_rlc_g1 :341,
// scalar_mul_rlc_g2 :393, endo_subgroup_eq :258)
// ---------------------------------------------------------------------------

// x^2 (128 bits, 17 set bits) and |x| (64 bits, 6 set bits), x = BLS_X.
constexpr uint64_t kXsqLo = 0x0000000100000000ull;
constexpr uint64_t kXsqHi = 0xac45a4010001a402ull;
constexpr uint64_t kXAbs = 0xd201000000010000ull;
constexpr int kG1Bits = 128;  // RLC coefficient width (curve.py ENDO_NBITS)
constexpr int kG2Bits = 65;   // G2 two-scalar scan width (G2_SCAN_NBITS)

FQ_HD bool bit_of(const uint32_t* words, int k) { return (words[k >> 5] >> (k & 31)) & 1u; }

FQ_HD bool xsq_bit(int k) { return ((k < 64 ? kXsqLo >> k : kXsqHi >> (k - 64)) & 1u) != 0; }

// ---------------------------------------------------------------------------
// One G1 row on a team of kLanes lanes (team.cuh), as scan_g1_rows runs it:
// [c]P by the 128-step LSB-first scan and the verdict phi(P) == -[x^2]P
// from the same doubling chain cur = [2^k]P.  The row's points live in a
// file of Fq slots in shared memory.  An Fq product is one lane's, so a
// round of products is one stage (no join).  Step k runs three formulas
// side by side, none reading another's result: the RLC addition acc +
// cur_k, the check-chain addition chain + cur_k (at x^2's 17 set bits) and
// the doubling cur_{k+1} = 2 cur_k, written to the other of two slot sets.
// An addition is 5 rounds of products (at most 4 of them a round), the
// doubling 3 spread over the same 5, so a step is 5 rounds: 7 products
// at most a round, 11 at a check step.
// The formulas are curve.py's, product for product, so the points are the
// same values as the plain scalar_mul_rlc_g1.
// ---------------------------------------------------------------------------

namespace g1team {

using team::Team;

constexpr int kLanes = 8;  // a step's largest bundle but a check step's
constexpr int kRounds = 5;

// Slots of a row's file: the base point P (x, y, z at 0, 1, 2), cur in
// two sets (step k reads one and writes the other), acc, the check chain,
// then each formula's temporaries (product k of a formula writes tmp + k).
constexpr int kBase = 0;
constexpr int kCur = 3;  // and kCur + 3
constexpr int kAcc = 9;
constexpr int kChain = 12;
constexpr int kDblTmp = 15;
constexpr int kAccTmp = 22;  // and the verdict's, after the scan
constexpr int kChainTmp = 38;
constexpr int kSlots = 54;

// Formula kinds.
constexpr int kNone = 0, kDbl = 1, kAdd = 2, kEq = 3;

// One formula of a step: its kind, its points' first slots and its first
// temporary.
struct Form {
  int kind, p, q, tmp;
};

// The products of each formula, numbered in the order of their rounds.
// Doubling of p (curve.py double): A = x^2, B = y^2 | C = B^2, S = (x +
// B)^2, F = E^2 with E = 3 A | M = E (D - X3) | - | YZ = y z.
enum { kA, kB, kC, kS, kF, kM, kYZ };
// Addition p + q (add_unsafe): Z11 = z1^2, Z22 = z2^2, Z12 = z1 z2 | U1 =
// x1 Z22, U2 = x2 Z11, T1 = z2 Z22, T2 = z1 Z11 | S1 = y1 T1, S2 = y2 T2,
// I = (2 H)^2 with H = U2 - U1 | J = H I, V = U1 I, R2 = RR^2 with RR =
// 2 (S2 - S1), Z3 = 2 Z12 H | S1J = S1 J, Y3 = RR (V - X3).
enum { kZ11, kZ22, kZ12, kU1, kU2, kT1, kT2, kS1, kS2, kI, kJ, kV, kR2, kZ3, kS1J, kY3 };
// phi(p) == -q as jac_eq_dev: XB = x1 beta, Z11 = z1^2, Z22 = z2^2 | AX
// = XB Z22, BX = x2 Z11, T1 = z2 Z22, T2 = z1 Z11 | C = y1 T1, D = -y2 T2.
enum { kXB, kEZ11, kEZ22, kAX, kBX, kET1, kET2, kEC, kED };

// Round r of a formula runs its products [start(kind, r), start(kind, r +
// 1)): the six bounds packed 5 bits each.
constexpr uint32_t pack5(int a, int b, int c, int d, int e, int f) {
  return a | b << 5 | c << 10 | d << 15 | e << 20 | static_cast<uint32_t>(f) << 25;
}
constexpr uint32_t kDblRounds = pack5(kA, kC, kM, kYZ, kYZ, kYZ + 1);
constexpr uint32_t kAddRounds = pack5(kZ11, kU1, kS1, kJ, kS1J, kY3 + 1);
constexpr uint32_t kEqRounds = pack5(kXB, kAX, kEC, kED + 1, kED + 1, kED + 1);

FQ_HD int start(int kind, int r) {
  const uint32_t packed = kind == kDbl   ? kDblRounds
                          : kind == kAdd ? kAddRounds
                          : kind == kEq  ? kEqRounds
                                         : 0u;
  return static_cast<int>((packed >> (5 * r)) & 31u);
}

// The doubling's D = 2 (S - A - C) and X3 = F - 2 D.
FQ_HD Fq dbl_d(const Fq* t) { return fq::small_mul<2>(fq::sub(fq::sub(t[kS], t[kA]), t[kC])); }
FQ_HD Fq dbl_x3(const Fq* t) { return fq::sub(t[kF], fq::small_mul<2>(dbl_d(t))); }
// The addition's H = U2 - U1, RR = 2 (S2 - S1) and X3 = R2 - J - 2 V.
FQ_HD Fq add_h(const Fq* t) { return fq::sub(t[kU2], t[kU1]); }
FQ_HD Fq add_rr(const Fq* t) { return fq::small_mul<2>(fq::sub(t[kS2], t[kS1])); }
FQ_HD Fq add_x3(const Fq* t) { return fq::sub(fq::sub(t[kR2], t[kJ]), fq::small_mul<2>(t[kV])); }

// Coordinate c of a formula's result from its temporaries.
FQ_HD Fq dbl_out(const Fq* t, int c) {
  return c == 0 ? dbl_x3(t)
         : c == 1 ? fq::sub(t[kM], fq::small_mul<8>(t[kC]))
                  : fq::small_mul<2>(t[kYZ]);
}
FQ_HD Fq add_out(const Fq* t, int c) {
  return c == 0 ? add_x3(t) : c == 1 ? fq::sub(t[kY3], fq::small_mul<2>(t[kS1J])) : t[kZ3];
}

// Product k of formula f: its operands formed from the file, one Fq
// product into slot f.tmp + k.  The one out-of-line product of the G1 row.
TEAM_CALL void part(const Form& f, int k, Fq* R) {
  using namespace fq;
  const Fq* p = R + f.p;
  const Fq* q = R + f.q;
  Fq* t = R + f.tmp;
  Fq a, b;
  switch (f.kind * 16 + k) {
    case kDbl * 16 + kA: a = b = p[0]; break;
    case kDbl * 16 + kB: a = b = p[1]; break;
    case kDbl * 16 + kC: a = b = t[kB]; break;
    case kDbl * 16 + kS: a = b = add(p[0], t[kB]); break;
    case kDbl * 16 + kF: a = b = small_mul<3>(t[kA]); break;
    case kDbl * 16 + kM:
      a = small_mul<3>(t[kA]);
      b = sub(dbl_d(t), dbl_x3(t));
      break;
    case kDbl * 16 + kYZ: a = p[1]; b = p[2]; break;
    case kAdd * 16 + kZ11: a = b = p[2]; break;
    case kAdd * 16 + kZ22: a = b = q[2]; break;
    case kAdd * 16 + kZ12: a = p[2]; b = q[2]; break;
    case kAdd * 16 + kU1: a = p[0]; b = t[kZ22]; break;
    case kAdd * 16 + kU2: a = q[0]; b = t[kZ11]; break;
    case kAdd * 16 + kT1: a = q[2]; b = t[kZ22]; break;
    case kAdd * 16 + kT2: a = p[2]; b = t[kZ11]; break;
    case kAdd * 16 + kS1: a = p[1]; b = t[kT1]; break;
    case kAdd * 16 + kS2: a = q[1]; b = t[kT2]; break;
    case kAdd * 16 + kI: a = b = small_mul<2>(add_h(t)); break;
    case kAdd * 16 + kJ: a = add_h(t); b = t[kI]; break;
    case kAdd * 16 + kV: a = t[kU1]; b = t[kI]; break;
    case kAdd * 16 + kR2: a = b = add_rr(t); break;
    case kAdd * 16 + kZ3: a = small_mul<2>(t[kZ12]); b = add_h(t); break;
    case kAdd * 16 + kS1J: a = t[kS1]; b = t[kJ]; break;
    case kAdd * 16 + kY3:
      a = add_rr(t);
      b = sub(t[kV], add_x3(t));
      break;
    case kEq * 16 + kXB: a = p[0]; b = g1_beta(); break;
    case kEq * 16 + kEZ11: a = b = p[2]; break;
    case kEq * 16 + kEZ22: a = b = q[2]; break;
    case kEq * 16 + kAX: a = t[kXB]; b = t[kEZ22]; break;
    case kEq * 16 + kBX: a = q[0]; b = t[kEZ11]; break;
    case kEq * 16 + kET1: a = q[2]; b = t[kEZ22]; break;
    case kEq * 16 + kET2: a = p[2]; b = t[kEZ11]; break;
    case kEq * 16 + kEC: a = p[1]; b = t[kET1]; break;
    default: a = neg(q[1]); b = t[kET2]; break;  // kEq * 16 + kED
  }
  t[k] = mont_mul_in(a, b);
}

// Round r of up to three formulas (kind kNone for none).
FQ_HD void run_round(const Team& t, Fq* R, int r, const Form& f0, const Form& f1, const Form& f2) {
  const int lo0 = start(f0.kind, r), lo1 = start(f1.kind, r), lo2 = start(f2.kind, r);
  team::fq_round(t, start(f0.kind, r + 1) - lo0, start(f1.kind, r + 1) - lo1,
                 start(f2.kind, r + 1) - lo2, [&](int i, int k) {
                   part(i == 0 ? f0 : i == 1 ? f1 : f2, k + (i == 0 ? lo0 : i == 1 ? lo1 : lo2),
                        R);
                 });
}

// The base point from the port's limbs ((36,) per coordinate at x, y, z),
// one conversion (one product) per lane; acc and the chain start as (1, 1,
// 0), the identity's coordinates.
FQ_HD void load(const Team& t, Fq* R, const int64_t* x, const int64_t* y, const int64_t* z) {
  t.stage(9, [&](int l) {
    if (l < 3) {
      R[kBase + l] = fq::from_port(l == 0 ? x : l == 1 ? y : z);
      return;
    }
    const int c = l % 3;
    R[(l < 6 ? kAcc : kChain) + c] = c < 2 ? fq::fq_one() : fq::fq_zero();
  });
}

// [c]P into kAcc, its flag into *acc_inf, and the verdict phi(P) ==
// -[x^2]P, for the loaded base; ``coeff`` holds c as 4 little-endian
// words.  Branch-free: the RLC addition runs at every step and the last
// stage of the step routes its result (a clear bit keeps acc, an identity
// operand gives the other), so the rows of a warp stay in step.
FQ_HD bool row(const Team& t, Fq* R, uint32_t base_inf, const uint32_t* coeff,
               uint32_t* acc_inf) {
  bool started = false;     // a set bit so far: acc is not the identity
  uint32_t chain_inf = 1u;  // the chain's first addition routes to cur
  for (int k = 0; k < kG1Bits; ++k) {
    const int cur = k == 0 ? kBase : kCur + 3 * ((k - 1) & 1);
    const int next = kCur + 3 * (k & 1);
    const bool bit = bit_of(coeff, k), check = xsq_bit(k), dbl = k + 1 < kG1Bits;
    // safety: LSB-first RLC adds (curve.py section notes, first bullet):
    // acc = (c mod 2^k) P meets 2^k P only if c mod 2^k = +-2^k (mod r),
    // impossible below 2^128; small-order inputs fail closed (z = 0).
    const Form fa{kAdd, kAcc, cur, kAccTmp};
    // safety: check-chain sub-mask argument (curve.py section notes,
    // second bullet).  chain = [m1]P with m1 the sub-mask of x^2's bits
    // below k, cur = [2^k]P with 2^k a disjoint sub-mask; coincidence
    // needs m1 = +-2^k (mod r) with both < 2^128, impossible.  The
    // argument holds for this running sum as for the plain tree sum.
    const Form fc{check ? kAdd : kNone, kChain, cur, kChainTmp};
    const Form fd{dbl ? kDbl : kNone, cur, cur, kDblTmp};
    for (int r = 0; r < kRounds; ++r) run_round(t, R, r, fa, fc, fd);
    // cur_{k+1}; acc and the chain routed: an identity sum so far gives
    // cur, an identity cur (the base's flag) keeps the sum.
    const int nd = dbl ? 3 : 0, nc = check ? 3 : 0;
    t.stage(nd + 3 + nc, [&](int l) {
      if (l < nd) {
        R[next + l] = dbl_out(R + kDblTmp, l);
        return;
      }
      l -= nd;
      if (l < 3) {
        if (bit && !started) R[kAcc + l] = R[cur + l];
        if (bit && started && !base_inf) R[kAcc + l] = add_out(R + kAccTmp, l);
        return;
      }
      l -= 3;
      if (chain_inf) R[kChain + l] = R[cur + l];
      if (!chain_inf && !base_inf) R[kChain + l] = add_out(R + kChainTmp, l);
    });
    started = started || bit;
    if (check) chain_inf &= base_inf;
  }
  *acc_inf = (started ? 0u : 1u) | base_inf;
  chain_inf |= base_inf;
  // phi(P) == -chain.
  const Form fe{kEq, kBase, kChain, kAccTmp};
  const Form none{kNone, 0, 0, 0};
  for (int r = 0; r < 3; ++r) run_round(t, R, r, fe, none, none);
  const Fq* e = R + kAccTmp;
  const bool ex = fq::is_zero(fq::sub(e[kAX], e[kBX]));
  const bool ey = fq::is_zero(fq::sub(e[kEC], e[kED]));
  // A z of 0 with the flag unset (add_unsafe's garbage on forbidden
  // inputs) compares unequal to everything: the check fails closed.
  const bool z_ok = !fq::is_zero(R[kBase + 2]) && !fq::is_zero(R[kChain + 2]);
  const bool both_fin = base_inf == 0 && chain_inf == 0;
  const bool both_inf = base_inf != 0 && chain_inf != 0;
  return both_inf || (both_fin && z_ok && ex && ey);
}

// ---------------------------------------------------------------------------
// The sum of G1 points by a pairwise tree (curve.py tree_sum :578), as one
// block of scan_g1_sums runs it: up to kTreePoints points in a file of Fq
// slots (point i at slots 3 i .. 3 i + 2, its flag flag[i]) and
// kTreeTeams teams of kSumLanes lanes, each with its own temporaries.  An
// addition is add_unsafe's five rounds of at most four products, so four
// lanes run it; teams.run(m, f) runs f(team, j) for the teams j < m side
// by side, then meets a barrier of the whole block (g2team::tree is the
// same tree over G2).
// ---------------------------------------------------------------------------

constexpr int kSumLanes = 4;
constexpr int kTreeTeams = 32;
constexpr int kTreePoints = 2 * kTreeTeams;
constexpr int kAddTmp = kY3 + 1;  // an addition's temporaries
constexpr int kTreeSlots = 3 * kTreePoints + kAddTmp * kTreeTeams;

// D = P + Q (add_unsafe) at Fq slots, P and Q with identity flags pin and
// qin; D may be P; the temporaries from slot tmp on.  Branch-free: the
// formula always runs and a last stage routes (an identity P gives Q, an
// identity Q gives P).  p == +-q is NOT handled; each caller states why
// it cannot occur.  Returns D's flag.
FQ_HD uint32_t add(const Team& t, Fq* R, int D, int P, int Q, uint32_t pin, uint32_t qin,
                   int tmp) {
  const Form f{kAdd, P, Q, tmp};
  for (int r = 0; r < kRounds; ++r) {
    const int lo = start(kAdd, r);
    t.stage(start(kAdd, r + 1) - lo, [&](int k) { part(f, lo + k, R); });
  }
  t.stage(3, [&](int l) {
    R[D + l] = pin ? R[Q + l] : qin ? R[P + l] : add_out(R + tmp, l);
  });
  return pin & qin;
}

// Points [0, n) summed into point 0: at level s, point a + s is added into
// a for every a that is a multiple of 2 s; a point left over by an odd
// count waits for the next level (tree_sum pads with the identity).
template <class Teams>
FQ_HD void tree(const Teams& teams, Fq* R, uint32_t* flag, int n) {
  for (int s = 1; s < n; s *= 2) {
    teams.run((n - s + 2 * s - 1) / (2 * s), [&](const Team& t, int j) {
      const int a = 2 * s * j;
      // safety: tree reduction over RLC-scaled points (curve.py module
      // docstring, second bullet): the points are c_i P_i with Fiat-Shamir
      // coefficients fixed after the P_i were committed, so an engineered
      // coincidence is negligible in any summation order, this one included.
      const uint32_t f = add(t, R, 3 * a, 3 * a, 3 * (a + s), flag[a], flag[a + s],
                             3 * kTreePoints + kAddTmp * j);
      if (t.lane == 0) flag[a] = f;
    });
  }
}

// The sum of `count` points into point 0: the tree over the first
// kTreePoints, then over the sum so far and the next kTreePoints - 1, and
// so on.  load(dst, first, m) puts points [first, first + m) of the range
// at [dst, dst + m) and meets the block's barrier.  No point: the identity.
template <class Teams, class Load>
FQ_HD void sum(const Teams& teams, Fq* R, uint32_t* flag, int count, const Load& load) {
  if (count == 0) {
    teams.run(1, [&](const Team& t, int) {
      t.stage(3, [&](int l) { R[l] = l < 2 ? fq::fq_one() : fq::fq_zero(); });
      if (t.lane == 0) flag[0] = 1u;
    });
  }
  for (int done = 0, have = 0; done < count; have = 1) {
    const int m = count - done < kTreePoints - have ? count - done : kTreePoints - have;
    load(have, done, m);
    done += m;
    tree(teams, R, flag, have + m);
  }
}

}  // namespace g1team

// ---------------------------------------------------------------------------
// G2 points on teams of six lanes (team.cuh): one row of scan_g2_rows, or
// one addition of scan_g2_sums' tree.  The points live in a file of Fq2
// slots in shared memory; every Fq2 product is split into its Karatsuba
// parts, and the products of one step that do not depend on each other
// run in one bundle (up to six parts): a doubling is 3 rounds of
// products, an addition 8.
// The two chains of a row are independent, so scan_g2_rows gives each its
// own warp: scan_row computes [c]Q, check_row the subgroup verdict.
// The formulas are curve.py's double, add_unsafe and jac_eq_dev, in the
// same order, so the points are the same values.
// ---------------------------------------------------------------------------

namespace g2team {

using team::mul;
using team::sqr;
using team::Team;

// Slots of a row's file: the base point Q (x, y, z at 0, 1, 2), three
// more points, the psi constants and the formulas' temporaries.
constexpr int kBase = 0;
constexpr int kP1 = 3;   // scan: -psi(Q);     check: cur = [2^j]Q
constexpr int kP2 = 6;   // scan: Q - psi(Q);  check: the running chain
constexpr int kP3 = 9;   // scan: acc;         check: psi(Q)
constexpr int kCx = 12;
constexpr int kCy = 13;
constexpr int kTmp = 14;
constexpr int kAddTmp = 21;  // the temporaries of add
constexpr int kSlots = kTmp + kAddTmp;
constexpr int kLanes = 6;  // the most parts of one bundle

// Component k of slot `slot`.
FQ_HD Fq& comp_at(Fq2* R, int slot, int k) { return team::comp(R[slot], k); }

// Doubling in place of the point at slots P (curve.py double).  Correct for all
// inputs; the identity flag rides through unchanged (the caller keeps it).
FQ_HD void dbl(const Team& t, Fq2* R, Fq* X, int P) {
  using namespace fq;
  const int x = P, y = P + 1, z = P + 2;
  const int a = kTmp, b = a + 1, s = a + 2, e = a + 3, c = a + 4, f = a + 5, w = a + 6,
            c8 = a + 7, m = a + 8, yz = a + 9;
  team::prods(t, R, X, sqr(a, x), sqr(b, y));
  t.stage(2, [&](int k) {
    comp_at(R, s, k) = add(comp_at(R, x, k), comp_at(R, b, k));
    comp_at(R, e, k) = small_mul<3>(comp_at(R, a, k));
  });
  team::prods(t, R, X, sqr(c, b), sqr(s, s), sqr(f, e));
  t.stage(2, [&](int k) {
    const Fq d = small_mul<2>(sub(sub(comp_at(R, s, k), comp_at(R, a, k)), comp_at(R, c, k)));
    const Fq x3 = sub(comp_at(R, f, k), small_mul<2>(d));
    comp_at(R, w, k) = sub(d, x3);
    comp_at(R, c8, k) = small_mul<8>(comp_at(R, c, k));
    comp_at(R, x, k) = x3;
  });
  team::prods(t, R, X, mul(m, e, w), mul(yz, y, z));
  t.stage(2, [&](int k) {
    comp_at(R, y, k) = sub(comp_at(R, m, k), comp_at(R, c8, k));
    comp_at(R, z, k) = small_mul<2>(comp_at(R, yz, k));
  });
}

// D = P + Q (add_unsafe), P and Q with identity flags pin and qin; D may
// be P; the kAddTmp temporaries from slot tmp on.  Branch-free: the
// formula always runs and a last stage routes (an identity P gives Q, an
// identity Q gives P).  p == +-q is NOT handled; each caller states why
// it cannot occur.  Returns D's flag.
FQ_HD uint32_t add(const Team& t, Fq2* R, Fq* X, int D, int P, int Q, uint32_t pin,
                   uint32_t qin, int tmp = kTmp) {
  using namespace fq;
  const int x1 = P, y1 = P + 1, z1 = P + 2, x2 = Q, y2 = Q + 1, z2 = Q + 2;
  const int z11 = tmp, z22 = z11 + 1, u1 = z11 + 2, u2 = z11 + 3, t1 = z11 + 4, t2 = z11 + 5,
            h = z11 + 6, h2 = z11 + 7, s1 = z11 + 8, s2 = z11 + 9, i = z11 + 10, rr = z11 + 11,
            r2 = z11 + 12, j = z11 + 13, v = z11 + 14, s1j = z11 + 15, z12 = z11 + 16,
            x3 = z11 + 17, y3 = z11 + 18, z3 = z11 + 19, w = z11 + 20;  // x3, y3, z3 in a row
  team::prods(t, R, X, sqr(z11, z1), sqr(z22, z2));
  team::prods(t, R, X, mul(u1, x1, z22), mul(u2, x2, z11));
  t.stage(2, [&](int k) {
    comp_at(R, h, k) = sub(comp_at(R, u2, k), comp_at(R, u1, k));
    comp_at(R, h2, k) = small_mul<2>(comp_at(R, h, k));
  });
  team::prods(t, R, X, mul(t1, z2, z22), mul(t2, z1, z11));
  team::prods(t, R, X, mul(s1, y1, t1), mul(s2, y2, t2));
  t.stage(2, [&](int k) {
    comp_at(R, rr, k) = small_mul<2>(sub(comp_at(R, s2, k), comp_at(R, s1, k)));
  });
  team::prods(t, R, X, sqr(i, h2), sqr(r2, rr));
  team::prods(t, R, X, mul(j, h, i), mul(v, u1, i));
  t.stage(2, [&](int k) {
    comp_at(R, x3, k) =
        sub(sub(comp_at(R, r2, k), comp_at(R, j, k)), small_mul<2>(comp_at(R, v, k)));
    comp_at(R, w, k) = sub(comp_at(R, v, k), comp_at(R, x3, k));
  });
  team::prods(t, R, X, mul(s1j, s1, j), mul(z12, z1, z2));
  t.stage(2, [&](int k) { comp_at(R, z12, k) = small_mul<2>(comp_at(R, z12, k)); });
  team::prods(t, R, X, mul(y3, rr, w), mul(z3, z12, h));
  t.stage(2, [&](int k) {
    comp_at(R, y3, k) = sub(comp_at(R, y3, k), small_mul<2>(comp_at(R, s1j, k)));
  });
  t.stage(6, [&](int l) {
    const int crd = l >> 1, k = l & 1;
    comp_at(R, D + crd, k) = pin   ? comp_at(R, Q + crd, k)
                             : qin ? comp_at(R, P + crd, k)
                                   : comp_at(R, x3 + crd, k);
  });
  return pin & qin;
}

// Projective equality of P and Q (jac_eq_dev): unequal when a z is 0 but its
// flag is unset, so checks fail closed.  Uses the temporaries.
FQ_HD bool eq(const Team& t, Fq2* R, Fq* X, int P, uint32_t pin, int Q, uint32_t qin) {
  const int z11 = kTmp, z22 = z11 + 1, a = z11 + 2, b = z11 + 3, t1 = z11 + 4, t2 = z11 + 5,
            c = z11 + 6, d = z11 + 7;
  team::prods(t, R, X, sqr(z11, P + 2), sqr(z22, Q + 2));
  team::prods(t, R, X, mul(a, P, z22), mul(b, Q, z11));
  team::prods(t, R, X, mul(t1, Q + 2, z22), mul(t2, P + 2, z11));
  team::prods(t, R, X, mul(c, P + 1, t1), mul(d, Q + 1, t2));
  t.stage(2, [&](int k) {
    comp_at(R, a, k) = fq::sub(comp_at(R, a, k), comp_at(R, b, k));
    comp_at(R, c, k) = fq::sub(comp_at(R, c, k), comp_at(R, d, k));
  });
  const bool z_ok = !fq::is_zero(R[P + 2]) && !fq::is_zero(R[Q + 2]);
  const bool both_fin = pin == 0 && qin == 0;
  const bool both_inf = pin != 0 && qin != 0;
  return both_inf || (both_fin && z_ok && fq::is_zero(R[a]) && fq::is_zero(R[c]));
}

// D = psi(P) = (cx conj(X), cy conj(Y), conj(Z)); with neg, -psi(P).
FQ_HD void psi(const Team& t, Fq2* R, Fq* X, int D, int P, bool neg) {
  const int jx = kTmp, jy = kTmp + 1;  // conj(X), conj(Y)
  t.stage(2, [&](int k) {
    comp_at(R, jx, k) = k ? fq::neg(comp_at(R, P, k)) : comp_at(R, P, k);
    comp_at(R, jy, k) = k ? fq::neg(comp_at(R, P + 1, k)) : comp_at(R, P + 1, k);
    comp_at(R, D + 2, k) = k ? fq::neg(comp_at(R, P + 2, k)) : comp_at(R, P + 2, k);
  });
  team::prods(t, R, X, mul(D, kCx, jx), mul(D + 1, kCy, jy));
  if (neg) t.stage(2, [&](int k) { comp_at(R, D + 1, k) = fq::neg(comp_at(R, D + 1, k)); });
}

// The base point from the port's limbs ((2, 36) per coordinate at x, y, z)
// and the psi constants: one conversion (one product) per lane.
FQ_HD void load(const Team& t, Fq2* R, const int64_t* x, const int64_t* y, const int64_t* z) {
  t.stage(6, [&](int l) {
    const int crd = l >> 1, k = l & 1;
    const int64_t* src = (crd == 0 ? x : crd == 1 ? y : z) + k * fq::kLimbs;
    comp_at(R, kBase + crd, k) = fq::from_port(src);
    if (crd == 0) comp_at(R, kCx, k) = team::comp(psi_cx(), k);
    if (crd == 1) comp_at(R, kCy, k) = team::comp(psi_cy(), k);
  });
}

// The identity's coordinates (1, 1, 0) at slots P.
FQ_HD void set_identity(const Team& t, Fq2* R, int P) {
  t.stage(6, [&](int l) {
    const int crd = l >> 1, k = l & 1;
    comp_at(R, P + crd, k) = (crd < 2 && k == 0) ? fq::fq_one() : fq::fq_zero();
  });
}

// [c]Q with c = q |x| + s, as ONE MSB-first scan over {O, Q, -psi(Q),
// Q - psi(Q)}; ``sq`` holds s (words 0-1) and q (words 2-4).  The base is
// loaded; the result is left at kP3, its flag returned.
FQ_HD uint32_t scan_row(const Team& t, Fq2* R, Fq* X, uint32_t base_inf, const uint32_t* sq) {
  const int b0 = kBase, b1 = kP1, b01 = kP2, acc = kP3;
  psi(t, R, X, b1, b0, true);
  // safety: B01 precompute (curve.py section notes, third bullet): psi(Q)
  // = +-Q needs [x -+ 1]Q = O, impossible for genuine points; a poisoned
  // B01 belongs to a point that fails the psi check in this same flush.
  add(t, R, X, b01, b0, b1, base_inf, base_inf);  // b0, b1 and b01 carry the base's flag
  const uint32_t* s = sq;
  const uint32_t* q = sq + 2;
  set_identity(t, R, acc);
  uint32_t acc_inf = 1u;
  for (int k = kG2Bits - 1; k >= 0; --k) {
    const bool sbit = k < 64 && bit_of(s, k);
    const bool qbit = bit_of(q, k);
    dbl(t, R, X, acc);
    const int addend = sbit && qbit ? b01 : (sbit ? b0 : b1);
    // Identity addend when neither bit is set; keep the base's own flag.
    const uint32_t add_inf = (sbit || qbit) ? base_inf : 1u;
    // safety: MSB accumulator adds (curve.py section notes, fourth
    // bullet): after the double acc = [2m]Q, 2m < 2^131; the addend
    // scalars 1 and |x|+1 are odd and |x| cannot equal 2m inside the
    // decomposition's range, so no coincidence is possible.
    acc_inf = add(t, R, X, acc, acc, addend, acc_inf, add_inf);
  }
  return acc_inf | base_inf;
}

// The verdict psi(Q) == -[|x|]Q, with [|x|]Q by a double-only chain cur =
// [2^j]Q summed at |x|'s set bits.  The base is loaded.
FQ_HD bool check_row(const Team& t, Fq2* R, Fq* X, uint32_t base_inf) {
  const int cur = kP1, chain = kP2, ps = kP3;
  t.stage(6, [&](int l) {
    comp_at(R, cur + (l >> 1), l & 1) = comp_at(R, kBase + (l >> 1), l & 1);
  });
  set_identity(t, R, chain);
  uint32_t chain_inf = 1u;  // identity: the first add routes to cur
  for (int j = 0; j < 64; ++j) {
    if ((kXAbs >> j) & 1u) {
      // safety: check-chain sub-mask argument (curve.py section notes,
      // second bullet), for this running sum as for the tree sum.
      chain_inf = add(t, R, X, chain, chain, cur, chain_inf, base_inf);
    }
    if (j < 63) dbl(t, R, X, cur);
  }
  chain_inf |= base_inf;
  psi(t, R, X, ps, kBase, false);
  t.stage(2, [&](int k) { comp_at(R, chain + 1, k) = fq::neg(comp_at(R, chain + 1, k)); });
  return eq(t, R, X, ps, base_inf, chain, chain_inf);
}

// ---------------------------------------------------------------------------
// The sum of G2 points by a pairwise tree (curve.py tree_sum :578), as one
// block of scan_g2_sums runs it: up to kTreePoints points in the file
// (point i at slots 3 i .. 3 i + 2, its flag flag[i]) and kTreeTeams
// teams, each with its own temporaries.  teams.run(m, f) runs f(team, j,
// X) for the teams j < m side by side (X: team j's exchange buffer), then
// meets a barrier of the whole block.
// ---------------------------------------------------------------------------

constexpr int kTreeTeams = 32;
constexpr int kTreePoints = 2 * kTreeTeams;
constexpr int kTreeSlots = 3 * kTreePoints + kAddTmp * kTreeTeams;

// Points [0, n) summed into point 0: at level s, point a + s is added into
// a for every a that is a multiple of 2 s; a point left over by an odd
// count waits for the next level (tree_sum pads with the identity).
template <class Teams>
FQ_HD void tree(const Teams& teams, Fq2* R, uint32_t* flag, int n) {
  for (int s = 1; s < n; s *= 2) {
    teams.run((n - s + 2 * s - 1) / (2 * s), [&](const Team& t, int j, Fq* X) {
      const int a = 2 * s * j;
      // safety: tree reduction over RLC-scaled points (curve.py module
      // docstring, second bullet): the points are c_i Q_i with Fiat-Shamir
      // coefficients fixed after the Q_i were committed, so an engineered
      // coincidence is negligible in any summation order, this one included.
      const uint32_t f = add(t, R, X, 3 * a, 3 * a, 3 * (a + s), flag[a], flag[a + s],
                             3 * kTreePoints + kAddTmp * j);
      if (t.lane == 0) flag[a] = f;
    });
  }
}

// The sum of `count` points into point 0: the tree over the first
// kTreePoints, then over the sum so far and the next kTreePoints - 1, and
// so on.  load(dst, first, m) puts points [first, first + m) of the range
// at [dst, dst + m) and meets the block's barrier.  No point: the identity.
template <class Teams, class Load>
FQ_HD void sum(const Teams& teams, Fq2* R, uint32_t* flag, int count, const Load& load) {
  if (count == 0) {
    teams.run(1, [&](const Team& t, int, Fq*) {
      set_identity(t, R, 0);
      if (t.lane == 0) flag[0] = 1u;
    });
  }
  for (int done = 0, have = 0; done < count; have = 1) {
    const int m = count - done < kTreePoints - have ? count - done : kTreePoints - have;
    load(have, done, m);
    done += m;
    tree(teams, R, flag, have + m);
  }
}

// The point at slots P in the port's limbs ((2, 36) per coordinate at x,
// y, z): one conversion (one product) per lane.
FQ_HD void store(const Team& t, const Fq2* R, int P, int64_t* x, int64_t* y, int64_t* z) {
  t.stage(6, [&](int l) {
    const int crd = l >> 1, k = l & 1;
    fq::to_port(team::comp(R[P + crd], k), (crd == 0 ? x : crd == 1 ? y : z) + k * fq::kLimbs);
  });
}

}  // namespace g2team

}  // namespace curve
