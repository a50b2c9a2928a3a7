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
//   pair_final   one warp per subset: the product of the subset's Miller
//                values in pair order (a CSR list of pair indices), the
//                final exponentiation and is_one, written as an int32
//                verdict.
//
// What bounds it: 32-bit multiply-adds.  A pair_miller thread runs 10,441
// Fq products (both affine inversions and the limb conversions included;
// 21 for an identity pair), one dependent chain; its f (144 words), T and
// the lines live in a 4,720-byte stack frame, and its Fq2 and Fq12
// functions are calls.  A flush has tens of pairs, so the card is far from
// its IMAD rate and the time is one thread's chain.
//
// pair_final was one thread per subset too at first (22,857 Fq products of
// w-basis schoolbook arithmetic, 43 ms on an H100 at the firehose's one
// subset, a 20,000-byte frame that held 3.9 GB of device memory).  Its
// redesign (tower.cuh, pairing.cuh final_exp):
//
//   - One warp per subset (blocks of 32 threads), so a bisection level's
//     subsets run on different SMs.  The subset's values live in shared
//     memory (141 Fq2 slots, 16 KB).
//   - Each Miller value is mapped on load from the w basis to the Fq6
//     tower (a re-indexing), where an Fq12 product is 54 Fq products
//     (Karatsuba twice) and a square in the cyclotomic subgroup 18
//     (Granger-Scott), used for the 315 squares of the hard part's powers
//     by |x|.  A final exponentiation is 8,208 Fq products instead of
//     22,857.
//   - The products of each op are spread over the lanes, one Fq product
//     each: a cyclotomic square is one round, an Fq12 product two.  The
//     critical path is 913 Fq products per final exponentiation, about
//     half of them the Fermat inverse, which one lane runs alone.
//   - The Fq12 product, the cyclotomic square, the Frobenius map and each
//     lane's part product are out-of-line functions, one copy each, so
//     the code the final exponentiation loops over stays in the
//     instruction cache.  Only the frame of the inverse remains (under
//     1 KB, ptxas -v in PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "pairing.cuh"

namespace {

using curve::G1;
using curve::G2;
using fq::Fq2;

constexpr int kThreads = 32;
constexpr int kPairLimbs = 12 * fq::kLimbs;  // (6, 2, 36) limbs of one Fq12

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

// One warp per subset (tower.cuh): the subset's state in shared memory,
// the Fq products of each Fq12 op across the lanes.
__global__ void __launch_bounds__(tower::kLanes)
pair_final(const int64_t* __restrict__ fs, const int32_t* __restrict__ offsets,
           const int32_t* __restrict__ members, const int64_t* __restrict__ gammas,
           int32_t* __restrict__ ok) {
  __shared__ Fq2 file[tower::kSlots];
  __shared__ fq::Fq xch[tower::kParts];
  const team::Team t{static_cast<int>(threadIdx.x), tower::kLanes, 0xffffffffu};
  tower::load_gammas(t, file, gammas);
  const int s = blockIdx.x;
  const int lo = offsets[s];
  const bool one = pairing::subset_is_one(t, file, xch, fs, members + lo, offsets[s + 1] - lo);
  if (threadIdx.x == 0) ok[s] = one ? 1 : 0;
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
// members: (n,) int32 pair indices, subset by subset; gammas: (2, 6, 2, 36)
// int64, the Frobenius constants for k = 1, 2 in the port's limbs; ok:
// (n_sub,) int32.  Same launch contract as above.
extern "C" int hbbft_pair_final(const void* fs, const void* offsets, const void* members,
                                int n_sub, const void* gammas, void* ok, void* stream) {
  if (n_sub <= 0) return 0;
  pair_final<<<n_sub, tower::kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(fs), static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(members), static_cast<const int64_t*>(gammas),
      static_cast<int32_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
