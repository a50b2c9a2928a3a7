// The optimal-ate pairing pieces of the pair-stage kernels (K3): affine
// conversion, the Miller loop and the final exponentiation, carried over
// from crypto/device/pairing.py with the same formulas and the same line
// scaling, so a kernel's Miller value equals the plain miller_values
// coefficient by coefficient (as canonical values), not merely after the
// final exponentiation.
//
// Replaces, inside the kernels, hbbft_tpu/crypto/tpu/pairing.py
// (g1_affine :288, g2_affine :297, miller_loop :196 with dbl_step :208
// and add_step :226, final_exp_is_one :251, miller_product :304).  The
// Miller loop keeps the port's w basis (fq12.cuh); the final
// exponentiation runs over the Fq6 tower on a warp (tower.cuh).
//
// Like fq.cuh, every function is __host__ __device__ and goes through the
// host check too (tests/test_torch_pair_host.py).

#pragma once

#include "curve.cuh"
#include "fq12.cuh"
#include "tower.cuh"

namespace pairing {

using curve::G1;
using curve::G2;
using fq::Fq;
using fq::Fq2;
using fq12::Fq12;

struct Affine1 {
  Fq x, y;
};

struct Affine2 {
  Fq2 x, y;
};

// Jacobian -> affine by one Fermat inversion.  The identity (z = 0) gives
// (0, 0), which is garbage: the caller gates it on the inf flag.
FQ12_CALL Affine1 g1_affine(const G1& p) {
  const Fq zi = fq::inv(p.z);
  const Fq zi2 = fq::sqr(zi);
  return Affine1{fq::mul(p.x, zi2), fq::mul(p.y, fq::mul(zi2, zi))};
}

FQ12_CALL Affine2 g2_affine(const G2& q) {
  const Fq2 zi = fq::inv(q.z);
  const Fq2 zi2 = fq::sqr(zi);
  return Affine2{fq::mul(q.x, zi2), fq::mul(q.y, fq::mul(zi2, zi))};
}

// T on the twist in Jacobian coordinates, and the running value f.
struct MillerState {
  Fq2 x, y, z;
  Fq12 f;
};

// Doubling step: the tangent line at T scaled by 2 Y Z^3 (so no inversion),
// T = 2T, f = f^2 * line (pairing.py miller_loop dbl_step).
FQ12_CALL void dbl_step(MillerState* s, const Affine1& p) {
  using namespace fq;
  const Fq2 a = sqr(s->x);
  const Fq2 b = sqr(s->y);
  const Fq2 z1z1 = sqr(s->z);
  const Fq2 l0 = sub(small_mul<3>(mul(s->x, a)), small_mul<2>(b));
  const Fq2 l2 = neg(mul_fq(small_mul<3>(mul(a, z1z1)), p.x));
  const Fq2 znew = small_mul<2>(mul(s->y, s->z));
  const Fq2 l3 = mul_fq(mul(znew, z1z1), p.y);
  const Fq2 c = sqr(b);
  const Fq2 d = small_mul<2>(sub(sub(sqr(add(s->x, b)), a), c));
  const Fq2 e = small_mul<3>(a);
  const Fq2 f = sqr(e);
  const Fq2 x3 = sub(f, small_mul<2>(d));
  s->y = sub(mul(e, sub(d, x3)), small_mul<8>(c));
  s->x = x3;
  s->z = znew;
  s->f = fq12::sparse_mul(fq12::sqr(s->f), l0, l2, l3);
}

// Addition step with the affine Q: the chord through T and Q scaled by
// H Z, T = T + Q, f = f * line (pairing.py miller_loop add_step).
FQ12_CALL void add_step(MillerState* s, const Affine2& q, const Fq& px_neg, const Fq& py) {
  using namespace fq;
  const Fq2 z1z1 = sqr(s->z);
  const Fq2 u2 = mul(q.x, z1z1);
  const Fq2 s2 = mul(q.y, mul(s->z, z1z1));
  const Fq2 h = sub(u2, s->x);
  const Fq2 theta = sub(s2, s->y);
  const Fq2 hz = mul(h, s->z);
  const Fq2 l0 = sub(mul(theta, q.x), mul(q.y, hz));
  const Fq2 l2 = mul_fq(theta, px_neg);
  const Fq2 l3 = mul_fq(hz, py);
  const Fq2 hh = sqr(h);
  const Fq2 i = small_mul<4>(hh);
  const Fq2 j = mul(h, i);
  const Fq2 rr = small_mul<2>(theta);
  const Fq2 v = mul(s->x, i);
  const Fq2 x3 = sub(sub(sqr(rr), j), small_mul<2>(v));
  const Fq2 y3 = sub(mul(rr, sub(v, x3)), small_mul<2>(mul(s->y, j)));
  s->z = small_mul<2>(mul(s->z, h));
  s->x = x3;
  s->y = y3;
  s->f = fq12::sparse_mul(s->f, l0, l2, l3);
}

// f_{x,Q}(P): a doubling step for each bit of |x| below the top and an
// addition step at each set bit (the X_RUNS schedule), then the conjugate
// for x < 0.
FQ12_CALL Fq12 miller_loop(const Affine1& p, const Affine2& q) {
  MillerState s{q.x, q.y, fq12::fq2_one(), fq12::one()};
  const Fq px_neg = fq::neg(p.x);
  for (int k = 62; k >= 0; --k) {
    dbl_step(&s, p);
    if ((fq12::kXAbs >> k) & 1u) add_step(&s, q, px_neg, p.y);
  }
  return fq12::conj(s.f);
}

// One pair's Miller value, or 1 where either side is the identity (the
// oracle's None-skip; pairing.py miller_values gates with torch.where).
FQ12_CALL Fq12 miller_value(const G1& p, const G2& q) {
  if (p.inf || q.inf) return fq12::one();
  return miller_loop(g1_affine(p), g2_affine(q));
}

// ---------------------------------------------------------------------------
// pair_final on a team of 32 lanes: the tower Fq12 of tower.cuh
// ---------------------------------------------------------------------------

// f^(3 (p^12 - 1) / r) for f at tower::kF, left at tower::kD: the easy part
// f^((p^6 - 1)(p^2 + 1)), then the hard part to the power 3 (p^4 - p^2 + 1)
// / r = (x - 1)^2 (x + p) (x^2 + p^2 - 1) + 3 (pairing.py
// final_exp_is_one; its module notes verify the identity).  That is e^3,
// not e: only is_one of it means anything, and cubing is a bijection on
// the cyclotomic subgroup.  Uses every value slot of the file.
FQ_HD void final_exp(const team::Team& t, Fq2* R, Fq* X) {
  using namespace tower;
  inv(t, R, X, kV, kF);
  conj(t, R, kU, kF);
  mul(t, R, X, kF, kU, kV);  // f1 = f^(p^6 - 1)
  frobenius(t, R, X, kM, kF, 2);
  mul(t, R, X, kM, kM, kF);  // m = f1^(p^2 + 1)
  // safety: cyclotomic squares (pow_x, cyc_sqr) from here on.  For f != 0,
  // m = f^((p^6 - 1)(p^2 + 1)) lies in the cyclotomic subgroup, and so does
  // every value below: products, conj and Frobenius maps of its elements.
  // For f = 0 (a zero Miller value), Fermat gives 0^-1 = 0, so f1 = m = 0;
  // the Granger-Scott square of 0 is 0, every product with it is 0, and
  // is_one(0) is false, as the plain stage's verdict.
  pow_x(t, R, X, kA, kM);
  conj(t, R, kU, kM);
  mul(t, R, X, kA, kA, kU);  // a = m^(x - 1)
  pow_x(t, R, X, kB, kA);
  conj(t, R, kU, kA);
  mul(t, R, X, kB, kB, kU);  // b = a^(x - 1)
  pow_x(t, R, X, kC, kB);
  frobenius(t, R, X, kU, kB, 1);
  mul(t, R, X, kC, kC, kU);  // c = b^(x + p)
  pow_x(t, R, X, kU, kC);
  pow_x(t, R, X, kD, kU);    // d = c^(x^2)
  frobenius(t, R, X, kU, kC, 2);
  mul(t, R, X, kD, kD, kU);
  conj(t, R, kU, kC);
  mul(t, R, X, kD, kD, kU);  // g = d c^(p^2) c^-1
  cyc_sqr(t, R, X, kU, kM);
  mul(t, R, X, kU, kU, kM);
  mul(t, R, X, kD, kD, kU);  // g m^3
}

// One subset's verdict: the product of its pairs' Miller values in the
// order given, one final exponentiation, is_one.  ``fs`` holds (n, 6, 2,
// 36) port limbs; ``members`` the subset's pair indices.  The Frobenius
// constants are loaded (tower::load_gammas).
FQ_HD bool subset_is_one(const team::Team& t, Fq2* R, Fq* X, const int64_t* fs,
                         const int32_t* members, int count) {
  constexpr int kPairLimbs = 12 * fq::kLimbs;
  if (count == 0) tower::set_one(t, R, tower::kF);
  for (int k = 0; k < count; ++k) {
    const int64_t* f = fs + static_cast<int64_t>(members[k]) * kPairLimbs;
    tower::load(t, R, k == 0 ? tower::kF : tower::kL, f);
    if (k > 0) tower::mul(t, R, X, tower::kF, tower::kF, tower::kL);
  }
  final_exp(t, R, X);
  return tower::is_one(R, tower::kD);
}

}  // namespace pairing
