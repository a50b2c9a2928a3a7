// Fq12 values in the port's own basis, at the pair kernels' boundary (K3):
// six Fq2 coefficients of w with w^6 = xi = 1 + u, the (6, 2, 36) limb
// tensors of crypto/device/pairing.py.  Both pair kernels compute over the
// Fq6 tower (tower.cuh, pairing.cuh), whose slots only re-index these
// coefficients (tower::slot_of), so a kernel's Miller value and the plain
// one compare coefficient by coefficient (as canonical values).  The host
// check (tests/test_torch_pair_host.py) reads and writes values through
// this type.

#pragma once

#include "fq.cuh"

namespace fq12 {

using fq::Fq;
using fq::Fq2;

struct Fq12 {
  Fq2 c[6];  // sum c[i] w^i
};

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
