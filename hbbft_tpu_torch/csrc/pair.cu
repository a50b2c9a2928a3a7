// The flush's pair stage, hand-written for Hopper (sm_90a): the K3 kernels.
//
// Replaces hbbft_tpu/crypto/tpu/backend.py:_pair_kernel (:137), the jitted
// XLA program around pairing.py:pairing_product_is_one (:326): affine
// conversion, the Miller loop of every pair, the product of each subset's
// Miller values and one final exponentiation per subset.  The port's plain
// version is crypto/device/backend.py:pair_stage_plain.  Two kernels:
//
//   pair_miller  one warp per pair: reads the scan stage's lhs (G1) and
//                rhs (G2) Jacobian points in the port's limbs, converts
//                them to affine, runs the Miller loop and writes the (6, 2,
//                36) limbs of f_{x,Q}(P), or of 1 where either side is the
//                identity;
//   pair_final   one warp per subset: the product of the subset's Miller
//                values in pair order (a CSR list of pair indices), the
//                final exponentiation and is_one, written as an int32
//                verdict.
//
// What bounds them: 32-bit multiply-adds.  A flush has tens of pairs and
// a few subsets, so the card is far from its IMAD rate; what sets the time
// is the longest dependent chain of Fq products (about 2 us each on an
// H100).  Both kernels were one thread per pair or subset at first:
// pair_miller a chain of 10,441 Fq products over the w basis from a
// 4,720-byte stack frame, pair_final 22,857 (43 ms on an H100 at the
// firehose's one subset, a 20,000-byte frame that held 3.9 GB of device
// memory).  Both now run on a warp (team.cuh, tower.cuh, pairing.cuh):
//
//   - One block of 32 threads per pair or subset, so the pairs of a
//     launch and a bisection level's subsets run on different SMs.  The
//     state lives in shared memory: 91 Fq2 slots (8.7 KB) for a pair, 141
//     (16 KB) for a subset.
//   - Fq12 values live in the Fq6 tower, where the w-basis coefficients
//     are only re-indexed (a Miller value is written back in the w basis).
//     An Fq12 product is 54 Fq products (Karatsuba twice), a general square
//     36 (the complex square: two Fq6 products), a product by a Miller
//     line 39 (it has three nonzero Fq2 coefficients), a square in the
//     cyclotomic subgroup 18 (Granger-Scott; final exponentiation only).
//   - The independent Fq products of each step are spread over the lanes,
//     one Fq product each.  In the Miller loop, T's doubling (three
//     dependent rounds) runs beside f's square, and the products of f^2 *
//     line that need only l0 beside T's last round: a doubling step is
//     four rounds, an addition step six.  With the two Fermat inverses of
//     the affine conversion on two lanes side by side, a live pair's
//     critical path is chip_smoke.py's MILLER_PATH; pair_final's is 913
//     Fq products per final exponentiation.  About half of each is a
//     serial Fermat inverse, which one lane runs alone.
//   - The team's product and join (team.cuh), the Fq12 product, the
//     cyclotomic square and the Frobenius map are out-of-line functions,
//     one copy each, so the code the loops run stays in the instruction
//     cache.  Only the frame of the inverse remains (under 1 KB, ptxas -v
//     in PERF.md).
//   - On the warp the products no longer set pair_miller's time alone:
//     the linear stages between its product bundles take about half of
//     it, since a stage's lanes take different branches and the warp runs
//     them one after another (benchmarks_torch/miller_split.py times the
//     affine conversion, the bundles and the linear stages apart).

#include <cstdint>
#include <cuda_runtime.h>

#include "pairing.cuh"

namespace {

using fq::Fq2;

constexpr int kPairLimbs = 12 * fq::kLimbs;  // (6, 2, 36) limbs of one Fq12

// One warp per pair (pairing.cuh ml): the pair's state in shared memory,
// the Fq products of each step across the lanes.
__global__ void __launch_bounds__(pairing::ml::kLanes)
pair_miller(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
            const int64_t* __restrict__ pz, const int64_t* __restrict__ pinf,
            const int64_t* __restrict__ qx, const int64_t* __restrict__ qy,
            const int64_t* __restrict__ qz, const int64_t* __restrict__ qinf,
            int64_t* __restrict__ out) {
  __shared__ Fq2 file[pairing::ml::kSlots];
  __shared__ fq::Fq xch[pairing::ml::kParts];
  const team::Team t{static_cast<int>(threadIdx.x), pairing::ml::kLanes, 0xffffffffu};
  const int i = blockIdx.x;
  const int64_t o1 = static_cast<int64_t>(i) * fq::kLimbs;
  const int64_t o2 = 2 * o1;
  pairing::ml::value(t, file, xch, px + o1, py + o1, pz + o1, pinf[i] != 0, qx + o2, qy + o2,
                     qz + o2, qinf[i] != 0, out + static_cast<int64_t>(i) * kPairLimbs);
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
  pair_miller<<<static_cast<unsigned>(n), pairing::ml::kLanes, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(px), static_cast<const int64_t*>(py),
      static_cast<const int64_t*>(pz), static_cast<const int64_t*>(pinf),
      static_cast<const int64_t*>(qx), static_cast<const int64_t*>(qy),
      static_cast<const int64_t*>(qz), static_cast<const int64_t*>(qinf),
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
