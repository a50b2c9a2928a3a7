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

// Untwist-Frobenius-twist on G2: (cx conj(X), cy conj(Y), conj(Z))
// (curve.py psi_g2 :245); cx, cy in the kernel's Montgomery form.
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

FQ_HD G2 psi_g2(const G2& p) {
  return G2{fq::mul(psi_cx(), fq::conj(p.x)), fq::mul(psi_cy(), fq::conj(p.y)), fq::conj(p.z),
            p.inf};
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

// One G2 row: scaled = [c]Q with c = q |x| + s, as ONE MSB-first scan over
// {O, Q, -psi(Q), Q - psi(Q)}, and the verdict psi(Q) == -[|x|]Q.  ``sq``
// holds s (words 0-1) and q (words 2-4), little-endian.
CURVE_CALL G2 rlc_g2_row(const G2& base, const uint32_t* sq, bool* in_subgroup) {
  const G2 b0 = base;
  const G2 b1 = jac_neg(psi_g2(base));
  // safety: B01 precompute (curve.py section notes, third bullet): psi(Q)
  // = +-Q needs [x -+ 1]Q = O, impossible for genuine points; a poisoned
  // B01 belongs to a point that fails the psi check in this same flush.
  const G2 b01 = jac_add_unsafe(b0, b1);
  const uint32_t* s = sq;
  const uint32_t* q = sq + 2;
  G2 acc = identity<Fq2>();
  for (int k = kG2Bits - 1; k >= 0; --k) {
    const bool sbit = k < 64 && bit_of(s, k);
    const bool qbit = bit_of(q, k);
    acc = jac_double(acc);
    G2 addend = sbit && qbit ? b01 : (sbit ? b0 : b1);
    // Identity addend when neither bit is set; keep the base's own flag.
    addend.inf |= (sbit || qbit) ? 0u : 1u;
    // safety: MSB accumulator adds (curve.py section notes, fourth
    // bullet): after the double acc = [2m]Q, 2m < 2^131; the addend
    // scalars 1 and |x|+1 are odd and |x| cannot equal 2m inside the
    // decomposition's range, so no coincidence is possible.
    acc = jac_add_unsafe(acc, addend);
  }
  // [|x|]Q check chain: double-only chain, summed at |x|'s set bits.
  G2 cur = base;
  G2 chain = identity<Fq2>();
  bool have_chain = false;
  for (int j = 0; j < 64; ++j) {
    if ((kXAbs >> j) & 1u) {
      // safety: check-chain sub-mask argument (curve.py section notes,
      // second bullet), for this running sum as for the tree sum.
      chain = have_chain ? jac_add_unsafe(chain, cur) : cur;
      have_chain = true;
    }
    if (j < 63) cur = jac_double(cur);
  }
  acc.inf |= base.inf;
  chain.inf |= base.inf;
  *in_subgroup = jac_eq(psi_g2(base), jac_neg(chain));
  return acc;
}

}  // namespace curve
