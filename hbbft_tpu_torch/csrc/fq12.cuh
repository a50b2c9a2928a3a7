// Fq12 for pair_miller (K3), in the port's own basis: six Fq2 coefficients
// of w with w^6 = xi = 1 + u, the (6, 2, 36) limb tensors of
// crypto/device/pairing.py.  Not an Fq6 tower, so a kernel's Miller value
// and the plain one compare coefficient by coefficient (as canonical
// values).  pair_final maps these values to the Fq6 tower (tower.cuh).
//
// Replaces, inside the Miller loop, the Fq12 ops of
// hbbft_tpu/crypto/tpu/pairing.py (_reduce_cross :100, sparse_mul :132,
// conj :139) and their plain counterparts in crypto/device/pairing.py.
//
// Like fq.cuh, every function is __host__ __device__, so the host check
// (tests/test_torch_pair_host.py) runs the same code.  Elements go to the
// out-of-line functions by reference (fq.cuh's portable mont_mul says why).

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

// a^(p^6): the inverse on the cyclotomic unit circle.  The Frobenius
// constants gamma[6][i] are (-1)^i, so the odd coefficients change sign
// (pairing.py frobenius(a, 6)).
FQ_HD Fq12 conj(const Fq12& a) {
  Fq12 r;
  for (int i = 0; i < 6; ++i) r.c[i] = (i & 1) ? fq::neg(a.c[i]) : a.c[i];
  return r;
}

// |x| = 0xd201000000010000, the BLS parameter's magnitude.
constexpr uint64_t kXAbs = 0xd201000000010000ull;

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
