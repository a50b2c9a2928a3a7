// Fq12 for the pair-stage kernels (K3), in the port's own basis: six Fq2
// coefficients of w with w^6 = xi = 1 + u, the (6, 2, 36) limb tensors of
// crypto/device/pairing.py.  Not an Fq6 tower, so a kernel value and a
// plain value compare coefficient by coefficient (as canonical values).
//
// Replaces, inside the kernels, the Fq12 ops of
// hbbft_tpu/crypto/tpu/pairing.py (mul :94, _reduce_cross :100,
// sparse_mul :132, conj/frobenius/inv :139-:150, pow_x_abs :161, is_one
// :182) and their plain counterparts in crypto/device/pairing.py.
//
// Like fq.cuh, every function is __host__ __device__, so the host check
// (tests/test_torch_pair_host.py) runs the same code.  Elements go to the
// out-of-line functions by reference (fq.cuh's portable mont_mul says why).
//
// The Frobenius constants gamma[k][i] = xi^(i (p^k - 1) / 6) are not typed
// in here: the caller passes them in, converted from the same port limbs
// the plain version registers (pairing.py _gamma_name), for k = 1, 2, 4,
// 8 and 10.  k = 6 needs none: gamma[6][i] = (-1)^i, so conj negates the
// odd coefficients.

#pragma once

#include "fq.cuh"

#if defined(__CUDACC__)
#define FQ12_CALL static __host__ __device__ __noinline__
#else
#define FQ12_CALL static inline
#endif

namespace fq12 {

using fq::Fq;
using fq::Fq2;

struct Fq12 {
  Fq2 c[6];  // sum c[i] w^i
};

// The Frobenius powers whose constants the caller passes, k = 1, 2, 4, 8,
// 10 in this order: gam[6 * gamma_slot(k) + i] = gamma[k][i].
constexpr int kGammaSlots = 5;

FQ_HD int gamma_slot(int k) { return k == 1 ? 0 : k == 2 ? 1 : k == 4 ? 2 : k == 8 ? 3 : 4; }

FQ_HD Fq2 fq2_zero() { return Fq2{fq::fq_zero(), fq::fq_zero()}; }
FQ_HD Fq2 fq2_one() { return Fq2{fq::fq_one(), fq::fq_zero()}; }

FQ_HD Fq12 one() {
  Fq12 r;
  r.c[0] = fq2_one();
  for (int i = 1; i < 6; ++i) r.c[i] = fq2_zero();
  return r;
}

// Out-of-line Fq2 product and square: the Fq12 ops below call them dozens
// of times, and one copy each keeps the kernels' code small.
FQ12_CALL Fq2 mul2(const Fq2& a, const Fq2& b) { return fq::mul(a, b); }
FQ12_CALL Fq2 sqr2(const Fq2& a) { return fq::sqr(a); }

// Sums of the cross products by power of w: lo[k] holds w^k, hi[k] holds
// w^(6+k); fold folds w^(6+k) = xi w^k (pairing.py _reduce_cross).
struct Cross {
  Fq2 lo[6], hi[5];
};

FQ_HD void cross_clear(Cross* x) {
  for (int k = 0; k < 6; ++k) x->lo[k] = fq2_zero();
  for (int k = 0; k < 5; ++k) x->hi[k] = fq2_zero();
}

FQ_HD void cross_add(Cross* x, int k, const Fq2& t) {
  if (k < 6) {
    x->lo[k] = fq::add(x->lo[k], t);
  } else {
    x->hi[k - 6] = fq::add(x->hi[k - 6], t);
  }
}

FQ_HD Fq12 cross_fold(const Cross& x) {
  Fq12 r;
  for (int k = 0; k < 5; ++k) r.c[k] = fq::add(x.lo[k], fq::mul_by_xi(x.hi[k]));
  r.c[5] = x.lo[5];
  return r;
}

// Full product: the 6 x 6 cross of Fq2 products (108 Fq products).
FQ12_CALL Fq12 mul(const Fq12& a, const Fq12& b) {
  Cross x;
  cross_clear(&x);
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) cross_add(&x, i + j, mul2(a.c[i], b.c[j]));
  return cross_fold(x);
}

// Square: the same cross, each unordered pair once (6 squares and 15
// doubled products: 57 Fq products).
FQ12_CALL Fq12 sqr(const Fq12& a) {
  Cross x;
  cross_clear(&x);
  for (int i = 0; i < 6; ++i) {
    cross_add(&x, 2 * i, sqr2(a.c[i]));
    for (int j = i + 1; j < 6; ++j) {
      const Fq2 t = mul2(a.c[i], a.c[j]);
      cross_add(&x, i + j, fq::add(t, t));
    }
  }
  return cross_fold(x);
}

// a (l0 + l2 w^2 + l3 w^3): the Miller-line shape (18 Fq2 products).
FQ12_CALL Fq12 sparse_mul(const Fq12& a, const Fq2& l0, const Fq2& l2, const Fq2& l3) {
  Cross x;
  cross_clear(&x);
  for (int i = 0; i < 6; ++i) {
    cross_add(&x, i, mul2(a.c[i], l0));
    cross_add(&x, i + 2, mul2(a.c[i], l2));
    cross_add(&x, i + 3, mul2(a.c[i], l3));
  }
  return cross_fold(x);
}

// a^(p^6): the inverse on the cyclotomic unit circle.  gamma[6][i] =
// (-1)^i, so the odd coefficients change sign (pairing.py frobenius(a, 6)).
FQ_HD Fq12 conj(const Fq12& a) {
  Fq12 r;
  for (int i = 0; i < 6; ++i) r.c[i] = (i & 1) ? fq::neg(a.c[i]) : a.c[i];
  return r;
}

// a^(p^k) for k = 1, 2, 4, 8 or 10: the coefficient Frobenius (Fq2 conjugate when
// k is odd) times gamma[k][i].
FQ12_CALL Fq12 frobenius(const Fq12& a, int k, const Fq2* gam) {
  const Fq2* g = gam + 6 * gamma_slot(k);
  Fq12 r;
  for (int i = 0; i < 6; ++i) r.c[i] = mul2((k & 1) ? fq::conj(a.c[i]) : a.c[i], g[i]);
  return r;
}

// Inverse through the norm to Fq2 (pairing.py inv, the oracle's fq12_inv):
// prod = a^(p^2 + p^4 + p^6 + p^8 + p^10), a * prod lies in Fq2, one Fq2
// inverse.  0 maps to 0.
FQ12_CALL Fq12 inv(const Fq12& a, const Fq2* gam) {
  Fq12 prod = frobenius(a, 2, gam);
  prod = mul(prod, frobenius(a, 4, gam));
  prod = mul(prod, conj(a));
  prod = mul(prod, frobenius(a, 8, gam));
  prod = mul(prod, frobenius(a, 10, gam));
  const Fq12 norm = mul(a, prod);
  const Fq2 ninv = fq::inv(norm.c[0]);
  Fq12 r;
  for (int i = 0; i < 6; ++i) r.c[i] = mul2(prod.c[i], ninv);
  return r;
}

// |x| = 0xd201000000010000, the BLS parameter's magnitude.
constexpr uint64_t kXAbs = 0xd201000000010000ull;

// f^|x|: from the top bit down, a square per bit and a product at each of
// the 5 set bits below the top.  This is pairing.py's X_RUNS schedule (its
// runs are this bit string in run-length form).
FQ12_CALL Fq12 pow_x_abs(const Fq12& f) {
  Fq12 acc = f;
  for (int k = 62; k >= 0; --k) {
    acc = sqr(acc);
    if ((kXAbs >> k) & 1u) acc = mul(acc, f);
  }
  return acc;
}

// f^x for x < 0, f unitary.
FQ_HD Fq12 pow_x(const Fq12& f) { return conj(pow_x_abs(f)); }

// Exact: every coefficient is fully reduced (< P), so equality is word
// equality with the Montgomery form of 1.
FQ_HD bool is_one(const Fq12& a) {
  const Fq one = fq::fq_one();
  uint32_t diff = 0;
  for (int j = 0; j < fq::kWords; ++j) diff |= a.c[0].c0.w[j] ^ one.w[j];
  bool ok = diff == 0 && fq::is_zero(a.c[0].c1);
  for (int i = 1; i < 6; ++i) ok = ok && fq::is_zero(a.c[i]);
  return ok;
}

// The port's limbs at the kernel boundary: (6, 2, 36) int64.
FQ_HD Fq12 from_port12(const int64_t* limbs) {
  Fq12 r;
  for (int i = 0; i < 6; ++i) r.c[i] = fq::from_port2(limbs + 2 * fq::kLimbs * i);
  return r;
}

FQ_HD void to_port12(const Fq12& a, int64_t* limbs) {
  for (int i = 0; i < 6; ++i) fq::to_port2(a.c[i], limbs + 2 * fq::kLimbs * i);
}

}  // namespace fq12
