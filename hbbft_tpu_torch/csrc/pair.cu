// The flush's pair stage, hand-written for Hopper (sm_90a): the K3 kernels.
//
// Replaces hbbft_tpu/crypto/tpu/backend.py:_pair_kernel (:137), the jitted
// XLA program around pairing.py:pairing_product_is_one (:326): affine
// conversion, the Miller loop of every pair, the product of each subset's
// Miller values and one final exponentiation per subset.  The port's plain
// version is crypto/device/backend.py:pair_stage_plain.  Two kernels:
//
//   pair_miller  one thread per pair: reads the scan stage's lhs (G1) and
//                rhs (G2) Jacobian points in the port's limbs, converts
//                them to affine, runs the Miller loop and writes the (6, 2,
//                36) limbs of f_{x,Q}(P), or of 1 where either side is the
//                identity;
//   pair_final   one thread per subset: the product of the subset's Miller
//                values in pair order (a CSR list of pair indices), the
//                final exponentiation and is_one, written as an int32
//                verdict.
//
// What bounds it: 32-bit multiply-adds.  A pair_miller thread runs 10,441
// Fq products (both affine inversions and the limb conversions included;
// 21 for an identity pair) and a pair_final thread 22,857 for the final
// exponentiation, 12 to read its subset's first pair and 120 for each
// further pair (tests/test_torch_pair_host.py pins the counts on the host
// build).  That is this code's own schoolbook work in the w basis: the
// pairing check needs fewer products (chip_smoke.py counts those for its
// bound).  Each thread's products form one dependent chain, and a flush
// has tens of pairs and one subset (a bisection level a few subsets), so
// the card is far from its IMAD rate: the time is one thread's chain.
// This first design accepts that.  Blocks of 32 threads put each warp on
// its own SM.
// f (144 words), T (72) and the lines (72) do not fit in registers beside
// the product's own state, so they live in each thread's stack frame
// (ptxas -v: pair_miller 4,720 bytes, pair_final 20,000 bytes); the Fq2
// and Fq12 functions are calls, not inlined copies, to keep the code small.
// No call is recursive, so each frame is static and CUDA grows the
// context's local memory to it at the first launch; that reservation
// (frame x resident threads of the whole card) stays for the context's
// life, which makes the frame's size a memory cost as well as a time one.

#include <cstdint>
#include <cuda_runtime.h>

#include "pairing.cuh"

namespace {

using curve::G1;
using curve::G2;
using fq::Fq2;

constexpr int kThreads = 32;
constexpr int kPairLimbs = 12 * fq::kLimbs;  // (6, 2, 36) limbs of one Fq12
constexpr int kGammas = fq12::kGammaSlots * 6;

__global__ void __launch_bounds__(kThreads)
pair_miller(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
            const int64_t* __restrict__ pz, const int64_t* __restrict__ pinf,
            const int64_t* __restrict__ qx, const int64_t* __restrict__ qy,
            const int64_t* __restrict__ qz, const int64_t* __restrict__ qinf, int n,
            int64_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t o1 = static_cast<int64_t>(i) * fq::kLimbs;
  const int64_t o2 = 2 * o1;
  const G1 p{fq::from_port(px + o1), fq::from_port(py + o1), fq::from_port(pz + o1),
             pinf[i] != 0 ? 1u : 0u};
  const G2 q{fq::from_port2(qx + o2), fq::from_port2(qy + o2), fq::from_port2(qz + o2),
             qinf[i] != 0 ? 1u : 0u};
  fq12::to_port12(pairing::miller_value(p, q), out + static_cast<int64_t>(i) * kPairLimbs);
}

__global__ void __launch_bounds__(kThreads)
pair_final(const int64_t* __restrict__ fs, const int32_t* __restrict__ offsets,
           const int32_t* __restrict__ members, int n_sub, const int64_t* __restrict__ gammas,
           int32_t* __restrict__ ok) {
  // The Frobenius constants, converted once per block.
  __shared__ Fq2 gam[kGammas];
  for (int t = threadIdx.x; t < kGammas; t += kThreads)
    gam[t] = fq::from_port2(gammas + static_cast<int64_t>(t) * 2 * fq::kLimbs);
  __syncthreads();
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_sub) return;
  const int lo = offsets[s];
  ok[s] = pairing::subset_is_one(fs, members + lo, offsets[s + 1] - lo, gam) ? 1 : 0;
}

unsigned blocks(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// All pointers are device memory, contiguous.  px, py, pz: (n, 36) int64,
// pinf: (n,) int64 (G1); qx, qy, qz: (n, 2, 36) int64, qinf: (n,) int64
// (G2); out: (n, 6, 2, 36) int64.  Launches on `stream` without
// synchronising and returns the first CUDA error (0 = ok).
extern "C" int hbbft_pair_miller(const void* px, const void* py, const void* pz,
                                 const void* pinf, const void* qx, const void* qy,
                                 const void* qz, const void* qinf, int n, void* out,
                                 void* stream) {
  if (n <= 0) return 0;
  pair_miller<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(px), static_cast<const int64_t*>(py),
      static_cast<const int64_t*>(pz), static_cast<const int64_t*>(pinf),
      static_cast<const int64_t*>(qx), static_cast<const int64_t*>(qy),
      static_cast<const int64_t*>(qz), static_cast<const int64_t*>(qinf), n,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// fs: (n, 6, 2, 36) int64 Miller values; offsets: (n_sub + 1,) int32 into
// members: (n,) int32 pair indices, subset by subset; gammas: (5, 6, 2, 36)
// int64, the Frobenius constants for k = 1, 2, 4, 8, 10 in the port's
// limbs; ok: (n_sub,) int32.  Same launch contract as above.
extern "C" int hbbft_pair_final(const void* fs, const void* offsets, const void* members,
                                int n_sub, const void* gammas, void* ok, void* stream) {
  if (n_sub <= 0) return 0;
  pair_final<<<blocks(n_sub), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(fs), static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(members), n_sub, static_cast<const int64_t*>(gammas),
      static_cast<int32_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
