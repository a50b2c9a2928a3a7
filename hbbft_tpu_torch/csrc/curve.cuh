// Jacobian G1 (over Fq) and G2 (over Fq2) points for the scan kernel (K2),
// carried over from hbbft_tpu_torch/crypto/device/curve.py with the same
// formulas, the same explicit infinity flag and the same add_unsafe routing,
// so a kernel row and the plain scan give the same points.
//
// Like fq.cuh, every function is __host__ __device__: the host check in
// tests/test_torch_kernel_host.py runs these row scans against the oracle.
//
// add_unsafe is WRONG when both inputs are the same non-identity point or
// exact negatives.  Every call below carries a "// safety:" line naming the
// argument (curve.py module docstring and its "Static-endo flush scans"
// notes) for why its inputs cannot be such a pair, or why a corrupted result
// can only make the subgroup check fail closed.

#pragma once

#include "fq.cuh"
#include "team.cuh"

// Points go by reference (see the portable mont_mul in fq.cuh for why
// large structs are not passed by value to out-of-line functions).
#if defined(__CUDACC__)
#define CURVE_CALL static __host__ __device__ __noinline__
#else
#define CURVE_CALL static inline
#endif

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

FQ_HD Fq one_of(const Fq*) { return fq::fq_one(); }
FQ_HD Fq2 one_of(const Fq2*) { return Fq2{fq::fq_one(), fq::fq_zero()}; }
FQ_HD Fq zero_of(const Fq*) { return fq::fq_zero(); }
FQ_HD Fq2 zero_of(const Fq2*) { return Fq2{fq::fq_zero(), fq::fq_zero()}; }

// (1, 1, 0) flagged as the identity (curve.py identity()).
template <class F>
FQ_HD Jac<F> identity() {
  const F one = one_of((const F*)nullptr);
  return Jac<F>{one, one, zero_of((const F*)nullptr), 1u};
}

// Jacobian doubling on a = 0 curves (curve.py double :74).  Correct for all
// inputs: the subgroup has prime order, so y = 0 never occurs on valid
// points, and the identity flag rides through unchanged (z' = 2yz keeps 0).
template <class F>
CURVE_CALL Jac<F> jac_double(const Jac<F>& p) {
  using namespace fq;
  const F a = sqr(p.x);
  const F b = sqr(p.y);
  const F c = sqr(b);
  const F d = small_mul<2>(sub(sub(sqr(add(p.x, b)), a), c));
  const F e = small_mul<3>(a);
  const F f = sqr(e);
  const F x3 = sub(f, small_mul<2>(d));
  const F y3 = sub(mul(e, sub(d, x3)), small_mul<8>(c));
  const F z3 = small_mul<2>(mul(p.y, p.z));
  return Jac<F>{x3, y3, z3, p.inf};
}

// General Jacobian addition (curve.py add_unsafe :107).  Identity flags are
// routed: an identity p gives q, an identity q gives p.  p == +-q is NOT
// handled; each caller states why it cannot occur.
template <class F>
CURVE_CALL Jac<F> jac_add_unsafe(const Jac<F>& p, const Jac<F>& q) {
  using namespace fq;
  if (p.inf) return q;
  if (q.inf) return p;
  const F z1z1 = sqr(p.z);
  const F z2z2 = sqr(q.z);
  const F u1 = mul(p.x, z2z2);
  const F u2 = mul(q.x, z1z1);
  const F s1 = mul(p.y, mul(q.z, z2z2));
  const F s2 = mul(q.y, mul(p.z, z1z1));
  const F h = sub(u2, u1);
  const F i = sqr(small_mul<2>(h));
  const F j = mul(h, i);
  const F rr = small_mul<2>(sub(s2, s1));
  const F v = mul(u1, i);
  const F x3 = sub(sub(sqr(rr), j), small_mul<2>(v));
  const F y3 = sub(mul(rr, sub(v, x3)), small_mul<2>(mul(s1, j)));
  const F z3 = mul(small_mul<2>(mul(p.z, q.z)), h);
  return Jac<F>{x3, y3, z3, 0u};
}

// curve.py neg :158.
template <class F>
FQ_HD Jac<F> jac_neg(const Jac<F>& p) {
  return Jac<F>{p.x, fq::neg(p.y), p.z, p.inf};
}

// Projective equality, cross-multiplied (curve.py jac_eq_dev :183).  A point
// whose z is 0 but whose flag is unset (the garbage add_unsafe makes on
// forbidden inputs) compares UNEQUAL to everything: checks fail closed.
template <class F>
CURVE_CALL bool jac_eq(const Jac<F>& p, const Jac<F>& q) {
  using namespace fq;
  const F z1z1 = sqr(p.z);
  const F z2z2 = sqr(q.z);
  const bool ex = is_zero(sub(mul(p.x, z2z2), mul(q.x, z1z1)));
  const bool ey = is_zero(sub(mul(p.y, mul(q.z, z2z2)), mul(q.y, mul(p.z, z1z1))));
  const bool z_ok = !is_zero(p.z) && !is_zero(q.z);
  const bool both_fin = p.inf == 0 && q.inf == 0;
  const bool both_inf = p.inf != 0 && q.inf != 0;
  return both_inf || (both_fin && z_ok && ex && ey);
}

// GLV endomorphism on G1: X *= beta (curve.py phi_g1 :238).  beta in the
// kernel's Montgomery form (x * 2^384 mod P).
FQ_HD Fq g1_beta() {
  return Fq{{0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu, 0xc61577f7u, 0x16a8ca3au,
             0x74fd029bu, 0xc26a2ff8u, 0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu}};
}

FQ_HD G1 phi_g1(const G1& p) { return G1{fq::mul(p.x, g1_beta()), p.y, p.z, p.inf}; }

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
// The static-endo flush scans, one row per call (curve.py
// scalar_mul_rlc_g1 :341, scalar_mul_rlc_g2 :393, endo_subgroup_eq :258)
// ---------------------------------------------------------------------------

// x^2 (128 bits, 17 set bits) and |x| (64 bits, 6 set bits), x = BLS_X.
constexpr uint64_t kXsqLo = 0x0000000100000000ull;
constexpr uint64_t kXsqHi = 0xac45a4010001a402ull;
constexpr uint64_t kXAbs = 0xd201000000010000ull;
constexpr int kG1Bits = 128;  // RLC coefficient width (curve.py ENDO_NBITS)
constexpr int kG2Bits = 65;   // G2 two-scalar scan width (G2_SCAN_NBITS)

FQ_HD bool bit_of(const uint32_t* words, int k) { return (words[k >> 5] >> (k & 31)) & 1u; }

FQ_HD bool xsq_bit(int k) { return ((k < 64 ? kXsqLo >> k : kXsqHi >> (k - 64)) & 1u) != 0; }

// One G1 row: scaled = [c]P and the membership verdict phi(P) == -[x^2]P.
// ``coeff`` holds c as 4 little-endian words.  LSB-first: one doubling
// chain cur = [2^k]P serves both the RLC sum and the check chain.
CURVE_CALL G1 rlc_g1_row(const G1& base, const uint32_t* coeff, bool* in_subgroup) {
  G1 acc = identity<Fq>();
  bool started = false;
  G1 cur = base;
  G1 chain = identity<Fq>();
  bool have_chain = false;
  for (int k = 0; k < kG1Bits; ++k) {
    if (xsq_bit(k)) {
      // safety: check-chain sub-mask argument (curve.py section notes,
      // second bullet).  chain = [m1]P with m1 the sub-mask of x^2's bits
      // below k, cur = [2^k]P with 2^k a disjoint sub-mask; coincidence
      // needs m1 = +-2^k (mod r) with both < 2^128, impossible.  The
      // argument holds for this running sum as for the plain tree sum.
      chain = have_chain ? jac_add_unsafe(chain, cur) : cur;
      have_chain = true;
    }
    if (bit_of(coeff, k)) {
      // "acc is the identity" is exactly "no set bit yet": use the flag.
      G1 a = acc;
      a.inf = started ? 0u : 1u;
      // safety: LSB-first RLC adds (curve.py section notes, first bullet):
      // acc = (c mod 2^k) P meets 2^k P only if c mod 2^k = +-2^k (mod r),
      // impossible below 2^128; small-order inputs fail closed (z = 0).
      acc = jac_add_unsafe(a, cur);
      started = true;
    }
    if (k + 1 < kG1Bits) cur = jac_double(cur);
  }
  acc.inf = (started ? 0u : 1u) | base.inf;
  chain.inf |= base.inf;
  *in_subgroup = jac_eq(phi_g1(base), jac_neg(chain));
  return acc;
}

// ---------------------------------------------------------------------------
// One G2 row on a team of six lanes (team.cuh), as scan_g2_rows runs it.
// The row's points live in a file of Fq2 slots in shared memory; every Fq2
// product is split into its Karatsuba parts, and the products of one step
// that do not depend on each other run in one bundle (up to six parts): a
// doubling is 3 rounds of products, an addition 8.
// The two chains of a row are independent, so scan_g2_rows gives each its
// own warp: scan_row computes [c]Q, check_row the subgroup verdict.
// The formulas are those of jac_double, jac_add_unsafe and jac_eq above,
// in the same order, so the points are the same values.
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
constexpr int kSlots = kTmp + 21;
constexpr int kLanes = 6;  // the most parts of one bundle

// Component k of slot `slot`.
FQ_HD Fq& comp_at(Fq2* R, int slot, int k) { return team::comp(R[slot], k); }

// Doubling in place of the point at slots P (jac_double).  Correct for all
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

// D = P + Q (jac_add_unsafe), P and Q with identity flags pin and qin; D
// may be P.  Branch-free: the formula always runs and a last stage routes
// (an identity P gives Q, an identity Q gives P).  p == +-q is NOT
// handled; each caller states why it cannot occur.  Returns D's flag.
FQ_HD uint32_t add(const Team& t, Fq2* R, Fq* X, int D, int P, int Q, uint32_t pin,
                   uint32_t qin) {
  using namespace fq;
  const int x1 = P, y1 = P + 1, z1 = P + 2, x2 = Q, y2 = Q + 1, z2 = Q + 2;
  const int z11 = kTmp, z22 = z11 + 1, u1 = z11 + 2, u2 = z11 + 3, t1 = z11 + 4, t2 = z11 + 5,
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

// Projective equality of P and Q (jac_eq): unequal when a z is 0 but its
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

}  // namespace g2team

}  // namespace curve
