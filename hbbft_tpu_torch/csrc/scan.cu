// The flush's scan stage, hand-written for Hopper (sm_90a): the K2 kernels.
//
// Replaces hbbft_tpu/crypto/tpu/backend.py:_scan_kernel (:79), the jitted
// XLA program that runs every row's RLC scalar multiple, its endomorphism
// subgroup check and the per-leg sums; the port's plain version is
// crypto/device/backend.py:scan_stage.  Four kernels:
//
//   scan_g1_rows  one thread per G1 row: [c]P by the 128-step LSB-first
//                 scan, and phi(P) == -[x^2]P from the same doubling chain;
//   scan_g2_rows  a team of six lanes per G2 row, in two warps: one warp's
//                 teams compute [c]Q by the 65-step two-scalar MSB scan (c
//                 = q |x| + s), the other's psi(Q) == -[|x|]Q;
//   scan_g1_sums, scan_g2_sums
//                 one thread per piece: the sum of a contiguous run of
//                 points.  Blocks cannot carry a sum across, so a segment
//                 sum is two launches: rows -> pieces of at most a few dozen
//                 rows (the host cuts them inside segments), then pieces ->
//                 one sum per segment, written in the port's limb format.
//
// The host orders the rows by (subset, leg) (crypto/device/scan.py), so
// every leg sum and every subset's generator-leg sum is a contiguous range.
// A row whose check is masked in (chk != 0) and fails clears its subset's
// sub_ok word; all writers write the same 0.
//
// What bounds it: 32-bit multiply-adds, 588 per Fq product and at least
// 456 per Fq square (the kernels square with the product; fq.cuh says
// why).  A G1 row needs about 128 doublings (2 products and 5
// squares), popcount(c) + 16 additions (12 and 4) and the check; a G2 row
// about 128 doublings and additions of Fq2 points (3 products per Fq2
// product, 2 per Fq2 square).  chip_smoke.py counts what these inputs
// need.  Bytes are a few hundred per row.
//
// scan_g1_rows and the sum kernels keep a whole row or piece in one
// thread; their point functions are calls, not inlined copies.  What held
// the first scan_g2_rows back (12.6 ms a chunk on an H100) was one
// thread's chain of ~4,420 Fq products per row, each an out-of-line call
// on spilled state (a 3,912-byte frame), on 16 of the 132 SMs.  Its
// redesign (curve.cuh, g2team; team.cuh):
//
//   - The RLC scan and the check chain do not depend on each other, so
//     they run in different warps (blocks of one warp: rows 5w..5w+4 scan
//     in block w, check in block W + w).  2,048 rows are 820 warps, about
//     6 on each of the 132 SMs.
//   - A row's points live in shared memory (35 Fq2 slots); its team of six
//     lanes splits every Fq2 product into its Karatsuba parts, one Fq
//     product per lane, and runs the independent products of a step
//     together: a doubling is 3 rounds of products, an addition 8.  The
//     critical path of a row is 731 Fq products instead of ~4,420
//     (chip_smoke.py's G2_ROW_PATH; the host check counts it).  Teams of
//     twelve lanes (an addition in 5 rounds, two rows a warp) ran 1.6
//     times slower: twice the warps issue about twice the instructions,
//     so the card's issue rate rather than the chain looks to set the
//     time.
//   - Everything a lane keeps is a few Fq values: no spills, a frame of
//     a few hundred bytes for the calls (ptxas -v in PERF.md).  Each
//     part's product is one out-of-line function: inlined at every
//     bundle, the loop over a row's 65 steps held a dozen copies of the
//     CIOS code, more than the instruction cache keeps, and ran 1.7 times
//     slower.  The formulas run branch-free (an addition with an identity
//     operand is computed and routed away), so the rows of a warp stay in
//     step.

#include <cstdint>
#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

using curve::G1;
using curve::G2;
using curve::Jac;
using fq::Fq;
using fq::Fq2;

constexpr int kThreads = 128;

// Internal point records between the row and sum kernels: x, y, z words,
// then the flag.
constexpr int kG1Rec = 3 * fq::kWords + 1;
constexpr int kG2Rec = 6 * fq::kWords + 1;

__device__ __forceinline__ void store_fq(const Fq& a, uint32_t* r) {
#pragma unroll
  for (int j = 0; j < fq::kWords; ++j) r[j] = a.w[j];
}

__device__ __forceinline__ Fq load_fq(const uint32_t* r) {
  Fq a;
#pragma unroll
  for (int j = 0; j < fq::kWords; ++j) a.w[j] = r[j];
  return a;
}

__device__ __forceinline__ void store(const G1& p, uint32_t* r) {
  store_fq(p.x, r);
  store_fq(p.y, r + fq::kWords);
  store_fq(p.z, r + 2 * fq::kWords);
  r[3 * fq::kWords] = p.inf;
}

__device__ __forceinline__ void store(const G2& p, uint32_t* r) {
  store_fq(p.x.c0, r);
  store_fq(p.x.c1, r + fq::kWords);
  store_fq(p.y.c0, r + 2 * fq::kWords);
  store_fq(p.y.c1, r + 3 * fq::kWords);
  store_fq(p.z.c0, r + 4 * fq::kWords);
  store_fq(p.z.c1, r + 5 * fq::kWords);
  r[6 * fq::kWords] = p.inf;
}

__device__ __forceinline__ void load(const uint32_t* r, G1* p) {
  p->x = load_fq(r);
  p->y = load_fq(r + fq::kWords);
  p->z = load_fq(r + 2 * fq::kWords);
  p->inf = r[3 * fq::kWords];
}

__device__ __forceinline__ void load(const uint32_t* r, G2* p) {
  p->x = Fq2{load_fq(r), load_fq(r + fq::kWords)};
  p->y = Fq2{load_fq(r + 2 * fq::kWords), load_fq(r + 3 * fq::kWords)};
  p->z = Fq2{load_fq(r + 4 * fq::kWords), load_fq(r + 5 * fq::kWords)};
  p->inf = r[6 * fq::kWords];
}

template <class F>
struct Rec;
template <>
struct Rec<Fq> {
  static constexpr int kWords = kG1Rec;
  static constexpr int kLimbs = fq::kLimbs;  // limbs per coordinate
};
template <>
struct Rec<Fq2> {
  static constexpr int kWords = kG2Rec;
  static constexpr int kLimbs = 2 * fq::kLimbs;
};

__device__ __forceinline__ void write_port(const Fq& a, int64_t* limbs) { fq::to_port(a, limbs); }
__device__ __forceinline__ void write_port(const Fq2& a, int64_t* limbs) { fq::to_port2(a, limbs); }

__global__ void __launch_bounds__(kThreads)
scan_g1_rows(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
             const int64_t* __restrict__ z, const int64_t* __restrict__ inf,
             const uint32_t* __restrict__ coeff, const int32_t* __restrict__ chk,
             const int32_t* __restrict__ row_sub, int n, uint32_t* __restrict__ scaled,
             int32_t* __restrict__ sub_ok) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t o = static_cast<int64_t>(i) * fq::kLimbs;
  const G1 base{fq::from_port(x + o), fq::from_port(y + o), fq::from_port(z + o),
                inf[i] != 0 ? 1u : 0u};
  bool in_subgroup;
  const G1 s = curve::rlc_g1_row(base, coeff + 4 * static_cast<int64_t>(i), &in_subgroup);
  store(s, scaled + static_cast<int64_t>(i) * kG1Rec);
  if (!in_subgroup && chk[i] != 0) sub_ok[row_sub[i]] = 0;
}

// Five rows per warp, one team of six lanes per row (g2team in
// curve.cuh).  Blocks [0, w) run the rows' RLC scans, blocks [w, 2w) their
// subgroup checks, w = ceil(n / 5): the two chains of a row do not depend
// on each other.  The last warp's spare teams repeat row n - 1 and write
// nothing.
constexpr int kG2RowsPerWarp = 5;
constexpr int kG2Threads = 32;
constexpr unsigned kG2Mask = (1u << (kG2RowsPerWarp * curve::g2team::kLanes)) - 1u;

__global__ void __launch_bounds__(kG2Threads)
scan_g2_rows(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
             const int64_t* __restrict__ z, const int64_t* __restrict__ inf,
             const uint32_t* __restrict__ sq, const int32_t* __restrict__ chk,
             const int32_t* __restrict__ row_sub, int n, uint32_t* __restrict__ scaled,
             int32_t* __restrict__ sub_ok) {
  __shared__ Fq2 file[kG2RowsPerWarp][curve::g2team::kSlots];
  __shared__ Fq xch[kG2RowsPerWarp][curve::g2team::kLanes];
  const int team_id = threadIdx.x / curve::g2team::kLanes;
  if (team_id >= kG2RowsPerWarp) return;
  const int warps = (n + kG2RowsPerWarp - 1) / kG2RowsPerWarp;
  const bool check = static_cast<int>(blockIdx.x) >= warps;
  const int first = (check ? blockIdx.x - warps : blockIdx.x) * kG2RowsPerWarp;
  const bool owner = first + team_id < n;
  const int i = owner ? first + team_id : n - 1;
  const team::Team t{static_cast<int>(threadIdx.x) % curve::g2team::kLanes,
                     curve::g2team::kLanes, kG2Mask};
  Fq2* R = file[team_id];
  Fq* X = xch[team_id];
  const int64_t o = static_cast<int64_t>(i) * 2 * fq::kLimbs;
  curve::g2team::load(t, R, x + o, y + o, z + o);
  const uint32_t base_inf = inf[i] != 0 ? 1u : 0u;
  if (check) {
    const bool ok = curve::g2team::check_row(t, R, X, base_inf);
    if (owner && t.lane == 0 && !ok && chk[i] != 0) sub_ok[row_sub[i]] = 0;
    return;
  }
  const uint32_t acc_inf =
      curve::g2team::scan_row(t, R, X, base_inf, sq + 5 * static_cast<int64_t>(i));
  if (!owner) return;
  // The record as store() lays it out: lane l writes words [12 l, 12 l + 12).
  uint32_t* rec = scaled + static_cast<int64_t>(i) * kG2Rec;
  store_fq(team::comp(R[curve::g2team::kP3 + (t.lane >> 1)], t.lane & 1),
           rec + fq::kWords * t.lane);
  if (t.lane == 0) rec[6 * fq::kWords] = acc_inf;
}

// Piece p sums records [starts[p], starts[p+1]).  With ox == nullptr the
// sums go to `out` as records; otherwise to the port's limb format.
template <class F>
__global__ void __launch_bounds__(kThreads)
scan_sums(const uint32_t* __restrict__ pts, const int32_t* __restrict__ starts, int npieces,
          uint32_t* __restrict__ out, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
          int64_t* __restrict__ oz, int64_t* __restrict__ oinf) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= npieces) return;
  Jac<F> acc = curve::identity<F>();
  for (int r = starts[p]; r < starts[p + 1]; ++r) {
    Jac<F> pt;
    load(pts + static_cast<int64_t>(r) * Rec<F>::kWords, &pt);
    // safety: tree reduction over RLC-scaled points (curve.py module
    // docstring, second bullet): the points are c_i P_i with Fiat-Shamir
    // coefficients fixed after the P_i were committed, so an engineered
    // coincidence is negligible in any summation order, this one included.
    acc = curve::jac_add_unsafe(acc, pt);
  }
  if (ox == nullptr) {
    store(acc, out + static_cast<int64_t>(p) * Rec<F>::kWords);
    return;
  }
  const int64_t o = static_cast<int64_t>(p) * Rec<F>::kLimbs;
  write_port(acc.x, ox + o);
  write_port(acc.y, oy + o);
  write_port(acc.z, oz + o);
  oinf[p] = acc.inf;
}

unsigned blocks(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// All pointers are device memory, contiguous.  x, y, z: (n, 36) int64 for
// G1, (n, 2, 36) for G2; inf: (n,) int64; coeff: (n, 4) words of c (G1), sq:
// (n, 5) words of s then q (G2); chk, row_sub: (n,) int32; scaled: (n, rec)
// words of scratch; sub_ok: (n_sub,) int32, ones on entry.  Each launches on
// `stream` without synchronising and returns the first CUDA error (0 = ok).
extern "C" int hbbft_scan_g1_rows(const void* x, const void* y, const void* z, const void* inf,
                                  const void* coeff, const void* chk, const void* row_sub,
                                  int n, void* scaled, void* sub_ok, void* stream) {
  if (n <= 0) return 0;
  scan_g1_rows<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(y),
      static_cast<const int64_t*>(z), static_cast<const int64_t*>(inf),
      static_cast<const uint32_t*>(coeff), static_cast<const int32_t*>(chk),
      static_cast<const int32_t*>(row_sub), n, static_cast<uint32_t*>(scaled),
      static_cast<int32_t*>(sub_ok));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hbbft_scan_g2_rows(const void* x, const void* y, const void* z, const void* inf,
                                  const void* sq, const void* chk, const void* row_sub, int n,
                                  void* scaled, void* sub_ok, void* stream) {
  if (n <= 0) return 0;
  const unsigned warps = static_cast<unsigned>((n + kG2RowsPerWarp - 1) / kG2RowsPerWarp);
  scan_g2_rows<<<2 * warps, kG2Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(y),
      static_cast<const int64_t*>(z), static_cast<const int64_t*>(inf),
      static_cast<const uint32_t*>(sq), static_cast<const int32_t*>(chk),
      static_cast<const int32_t*>(row_sub), n, static_cast<uint32_t*>(scaled),
      static_cast<int32_t*>(sub_ok));
  return static_cast<int>(cudaGetLastError());
}

// pts: (rows, rec) records; starts: (npieces + 1,) int32 offsets into pts.
// Pass 1 (ox null) writes records to out; pass 2 writes limbs to ox, oy, oz
// ((npieces, 36) G1 or (npieces, 2, 36) G2) and flags to oinf (int64).
template <class F>
static int launch_sums(const void* pts, const void* starts, int npieces, void* out, void* ox,
                       void* oy, void* oz, void* oinf, void* stream) {
  if (npieces <= 0) return 0;
  scan_sums<F><<<blocks(npieces), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pts), static_cast<const int32_t*>(starts), npieces,
      static_cast<uint32_t*>(out), static_cast<int64_t*>(ox), static_cast<int64_t*>(oy),
      static_cast<int64_t*>(oz), static_cast<int64_t*>(oinf));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hbbft_scan_g1_sums(const void* pts, const void* starts, int npieces, void* out,
                                  void* ox, void* oy, void* oz, void* oinf, void* stream) {
  return launch_sums<Fq>(pts, starts, npieces, out, ox, oy, oz, oinf, stream);
}

extern "C" int hbbft_scan_g2_sums(const void* pts, const void* starts, int npieces, void* out,
                                  void* ox, void* oy, void* oz, void* oinf, void* stream) {
  return launch_sums<Fq2>(pts, starts, npieces, out, ox, oy, oz, oinf, stream);
}
