// Batched Fq Montgomery product on the port's limbs, hand-written for Hopper
// (sm_90a): the K4 kernel.
//
// Replaces hbbft_tpu/crypto/tpu/fq.py:mont_mul (:208), which XLA fused on
// the TPU and which the port's plain version (crypto/device/fq.py
// mont_mul_plain) runs as about fifty PyTorch launches.  Everything under
// the field layer on the card (fq2, fq12, inv, pow_fixed, the plain pair
// stage) reaches this kernel through fq.mont_mul.
//
// Layout: one thread per product.  Each thread reads its two (36,) int64
// limb rows, packs them into 12 reduced 32-bit words, runs two CIOS
// products (fq.cuh: a*b/2^384, then times 2^372/2^384, which together
// give the port's a*b/2^396) and writes 36 strict limbs, fully reduced.
//
// What bounds it: 32-bit multiply-adds, 2 x 588 per product, against 864
// bytes moved; the IMAD rate over the memory rate is about 5 operations per
// byte and a product needs about 1.4, so at the main path's shapes the
// bytes bound it and the launch itself (a few microseconds) dominates.
// The design does not stage the strided rows through shared memory: a
// later slice makes that trade if the product ever shows in a profile.

#include <cstdint>
#include <cuda_runtime.h>

#include "fq.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fq_mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                   int64_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  fq::port_mont_mul(a + i * fq::kLimbs, b + i * fq::kLimbs, out + i * fq::kLimbs);
}

}  // namespace

// a, b, out: (n, 36) int64 limb rows on the device, contiguous.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int hbbft_fq_mont_mul(const void* a, const void* b, void* out, long long n,
                                 void* stream) {
  if (n <= 0) return 0;
  const long long grid = (n + kThreads - 1) / kThreads;
  fq_mont_mul_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<int64_t*>(out), static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}
