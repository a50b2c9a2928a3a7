// The flush's scan stage, hand-written for Hopper (sm_90a): the K2 kernels.
//
// Replaces hbbft_tpu/crypto/tpu/backend.py:_scan_kernel (:79), the jitted
// XLA program that runs every row's RLC scalar multiple, its endomorphism
// subgroup check and the per-leg sums; the port's plain version is
// crypto/device/backend.py:scan_stage.  Four kernels:
//
//   scan_g1_rows  a team of eight lanes per G1 row, four rows a warp: [c]P
//                 by the 128-step LSB-first scan, and phi(P) == -[x^2]P
//                 from the same doubling chain;
//   scan_g2_rows  a team of six lanes per G2 row, in two warps: one warp's
//                 teams compute [c]Q by the 65-step two-scalar MSB scan (c
//                 = q |x| + s), the other's psi(Q) == -[|x|]Q;
//   scan_g1_sums  one block per piece: the sum of a contiguous run of
//                 points by a pairwise tree on teams of four lanes;
//   scan_g2_sums  the same over G2, on teams of six lanes.
//
// Blocks cannot carry a sum across, so a segment sum is two launches:
// rows -> pieces of at most a few dozen rows (the host cuts them inside
// segments), then pieces -> one sum per segment, written in the port's
// limb format.  The host orders the rows by (subset, leg)
// (crypto/device/scan.py), so every leg sum and every subset's
// generator-leg sum is a contiguous range.  A row whose check is masked in
// (chk != 0) and fails clears its subset's sub_ok word; all writers write
// the same 0.
//
// What bounds it: 32-bit multiply-adds, 588 per Fq product and at least
// 456 per Fq square (the kernels square with the product; fq.cuh says
// why).  A G1 row needs about 128 doublings (2 products and 5
// squares), popcount(c) + 16 additions (12 and 4) and the check; a G2 row
// about 128 doublings and additions of Fq2 points (3 products per Fq2
// product, 2 per Fq2 square).  chip_smoke.py counts what these inputs
// need.  Bytes are a few hundred per row.
//
// What held the kernels back was latency, not that work: each was first
// one thread's chain of dependent Fq products per row or piece (about 2 us
// each on an H100), on a few of the 132 SMs.  The redesigns (curve.cuh
// g1team, g2team; team.cuh) shorten the chains:
//
//   - scan_g2_rows (12.6 ms a chunk before): the RLC scan and the check
//     chain do not depend on each other, so they run in different warps
//     (blocks of one warp: rows 5w..5w+4 scan in block w, check in block
//     W + w), and a row's team of six lanes splits every Fq2 product into
//     its Karatsuba parts and runs the independent products of a step
//     together: a doubling is 3 rounds, an addition 8.  A row's critical
//     path is 731 Fq products instead of ~4,420 (chip_smoke.py's
//     G2_ROW_PATH).  Teams of twelve lanes ran 1.6 times slower: twice
//     the warps issue about twice the instructions, so the card's issue
//     rate rather than the chain looks to set the time.
//   - scan_g1_rows (5.1 ms a chunk before, one thread per row in 16 blocks
//     of 128: 64 warps, one chain of ~2,160 products a row): step k's RLC
//     addition, check-chain addition and doubling read cur_k and nothing
//     of each other, so a team runs their products in the same 5 rounds
//     (the doubling writes cur_{k+1} to a second slot set).  The RLC
//     addition runs at every step and is routed away at a clear bit, so a
//     warp's rows stay in step.  A row's path is chip_smoke.py's
//     G1_ROW_PATH; 2,048 rows are 512 warps.
//   - scan_g2_sums (8.2 ms a chunk before, one thread per piece of 32
//     rows, then one thread over the pieces: 94 serial G2 additions at a
//     chunk): a block loads up to 64 points into shared memory and halves
//     them level by level, one team of six lanes per addition and a block
//     barrier between levels; a piece is 5 levels, a chunk's 64 pieces 6
//     more (chip_smoke.py's G2_SUMS_PATH).
//   - scan_g1_sums (2.4 ms a chunk before, one thread per piece of 32
//     rows, then one thread per leg over its pieces): the same tree over
//     G1 records, one team of four lanes per addition (add_unsafe's five
//     rounds of at most four products), eight teams a warp; a piece is 5
//     levels, a leg's pieces a few more (chip_smoke.py's G1_SUMS_PATH).
//
// Everything a lane keeps is a few Fq values: no spills (ptxas -v in
// PERF.md).  Each team's product is one out-of-line function: inlined at
// every bundle, the loop over a row's steps held a dozen copies of the
// CIOS code, more than the instruction cache keeps, and ran 1.7 times
// slower.  The formulas run branch-free (an addition with an identity
// operand is computed and routed away), so the rows of a warp stay in
// step.

#include <cstdint>
#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

using fq::Fq;
using fq::Fq2;

// Internal point records between the row and sum kernels: x, y, z words,
// then the flag.
constexpr int kG1Rec = 3 * fq::kWords + 1;
constexpr int kG2Rec = 6 * fq::kWords + 1;

__device__ __forceinline__ void store_fq(const Fq& a, uint32_t* r) {
#pragma unroll
  for (int j = 0; j < fq::kWords; ++j) r[j] = a.w[j];
}

// Four rows per warp, one team of eight lanes per row (g1team in
// curve.cuh), blocks of one warp.  The last warp's spare teams repeat row
// n - 1 and write nothing.
constexpr int kG1RowsPerWarp = 32 / curve::g1team::kLanes;
constexpr int kG1Threads = 32;
constexpr unsigned kG1Mask =
    kG1RowsPerWarp * curve::g1team::kLanes == 32
        ? 0xffffffffu
        : (1u << (kG1RowsPerWarp * curve::g1team::kLanes)) - 1u;

__global__ void __launch_bounds__(kG1Threads)
scan_g1_rows(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
             const int64_t* __restrict__ z, const int64_t* __restrict__ inf,
             const uint32_t* __restrict__ coeff, const int32_t* __restrict__ chk,
             const int32_t* __restrict__ row_sub, int n, uint32_t* __restrict__ scaled,
             int32_t* __restrict__ sub_ok) {
  __shared__ Fq file[kG1RowsPerWarp][curve::g1team::kSlots];
  const int team_id = threadIdx.x / curve::g1team::kLanes;
  if (team_id >= kG1RowsPerWarp) return;
  const int first = blockIdx.x * kG1RowsPerWarp;
  const bool owner = first + team_id < n;
  const int i = owner ? first + team_id : n - 1;
  const team::Team t{static_cast<int>(threadIdx.x) % curve::g1team::kLanes,
                     curve::g1team::kLanes, kG1Mask};
  Fq* R = file[team_id];
  const int64_t o = static_cast<int64_t>(i) * fq::kLimbs;
  curve::g1team::load(t, R, x + o, y + o, z + o);
  uint32_t acc_inf;
  const bool ok = curve::g1team::row(t, R, inf[i] != 0 ? 1u : 0u,
                                     coeff + 4 * static_cast<int64_t>(i), &acc_inf);
  if (!owner) return;
  // The record as a G1 record: lane l < 3 writes coordinate l.
  uint32_t* rec = scaled + static_cast<int64_t>(i) * kG1Rec;
  if (t.lane < 3) store_fq(R[curve::g1team::kAcc + t.lane], rec + fq::kWords * t.lane);
  if (t.lane == 0) {
    rec[3 * fq::kWords] = acc_inf;
    if (!ok && chk[i] != 0) sub_ok[row_sub[i]] = 0;
  }
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
  // The record as a G2 record: lane l writes words [12 l, 12 l + 12).
  uint32_t* rec = scaled + static_cast<int64_t>(i) * kG2Rec;
  store_fq(team::comp(R[curve::g2team::kP3 + (t.lane >> 1)], t.lane & 1),
           rec + fq::kWords * t.lane);
  if (t.lane == 0) rec[6 * fq::kWords] = acc_inf;
}

// scan_g1_sums: block p sums G1 records [starts[p], starts[p+1]) by the
// tree of g1team::sum: kTreeTeams teams of four lanes, eight a warp; the
// points, the teams' temporaries and the flags in shared memory.  With ox
// == nullptr the sums go to `out` as records; otherwise to the port's limb
// format.
constexpr int kG1SumTeamsPerWarp = 32 / curve::g1team::kSumLanes;
constexpr int kG1SumThreads = curve::g1team::kSumLanes * curve::g1team::kTreeTeams;

// The block's teams for g1team::tree: team j is lanes [4 (j mod 8), 4 (j
// mod 8) + 4) of warp j / 8.  A team's barrier is its warp's teams that
// run at this level.
struct G1BlockTeams {
  int team;
  int lane;

  template <class F>
  __device__ void run(int m, F&& f) const {
    if (team < m) {
      const int in_warp =
          min(m - team / kG1SumTeamsPerWarp * kG1SumTeamsPerWarp, kG1SumTeamsPerWarp);
      const unsigned mask = in_warp == kG1SumTeamsPerWarp
                                ? 0xffffffffu
                                : (1u << (curve::g1team::kSumLanes * in_warp)) - 1u;
      f(team::Team{lane, curve::g1team::kSumLanes, mask}, team);
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(kG1SumThreads)
scan_g1_sums(const uint32_t* __restrict__ pts, const int32_t* __restrict__ starts,
             uint32_t* __restrict__ out, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
             int64_t* __restrict__ oz, int64_t* __restrict__ oinf) {
  __shared__ Fq R[curve::g1team::kTreeSlots];
  __shared__ uint32_t flag[curve::g1team::kTreePoints];
  uint32_t* words = reinterpret_cast<uint32_t*>(R);  // point i: words [36 i, 36 i + 36)
  const int p = blockIdx.x;
  const int lo = starts[p];
  const G1BlockTeams teams{static_cast<int>(threadIdx.x) / curve::g1team::kSumLanes,
                           static_cast<int>(threadIdx.x) % curve::g1team::kSumLanes};
  constexpr int kPtWords = kG1Rec - 1;
  curve::g1team::sum(teams, R, flag, starts[p + 1] - lo, [&](int dst, int from, int m) {
    const uint32_t* src = pts + static_cast<int64_t>(lo + from) * kG1Rec;
    for (int w = threadIdx.x; w < m * kG1Rec; w += kG1SumThreads) {
      const int r = w / kG1Rec, c = w - r * kG1Rec;
      if (c < kPtWords) {
        words[(dst + r) * kPtWords + c] = src[w];
      } else {
        flag[dst + r] = src[w];
      }
    }
    __syncthreads();
  });
  if (ox == nullptr) {
    uint32_t* rec = out + static_cast<int64_t>(p) * kG1Rec;
    for (int w = threadIdx.x; w < kG1Rec; w += kG1SumThreads)
      rec[w] = w < kPtWords ? words[w] : flag[0];
    return;
  }
  if (threadIdx.x < 3) {
    const int64_t o = static_cast<int64_t>(p) * fq::kLimbs;
    fq::to_port(R[threadIdx.x], (threadIdx.x == 0 ? ox : threadIdx.x == 1 ? oy : oz) + o);
    if (threadIdx.x == 0) oinf[p] = flag[0];
  }
}

// scan_g2_sums: block p sums G2 records [starts[p], starts[p+1]) by the
// tree of g2team::sum.  kTreeTeams teams of six lanes, five a warp (lanes
// 30 and 31 only meet the barriers); the points, the teams' temporaries,
// exchange buffers and the flags in dynamic shared memory.
constexpr int kSumTeamsPerWarp = 5;
constexpr int kSumWarps = (curve::g2team::kTreeTeams + kSumTeamsPerWarp - 1) / kSumTeamsPerWarp;
constexpr int kSumThreads = 32 * kSumWarps;
constexpr int kSumXch = curve::g2team::kLanes * curve::g2team::kTreeTeams;
constexpr int kSumShared = curve::g2team::kTreeSlots * sizeof(Fq2) + kSumXch * sizeof(Fq) +
                           curve::g2team::kTreePoints * sizeof(uint32_t);

// The block's teams for g2team::tree: team j is lanes [6 (j mod 5), 6 (j
// mod 5) + 6) of warp j / 5.  A team's barrier is its warp's teams that
// run at this level.
struct BlockTeams {
  int team;  // this thread's team (kTreeTeams and above: none)
  int lane;
  Fq* xch;

  template <class F>
  __device__ void run(int m, F&& f) const {
    if (team < m) {
      const int in_warp = min(m - team / kSumTeamsPerWarp * kSumTeamsPerWarp, kSumTeamsPerWarp);
      const team::Team t{lane, curve::g2team::kLanes,
                         (1u << (curve::g2team::kLanes * in_warp)) - 1u};
      f(t, team, xch + curve::g2team::kLanes * team);
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(kSumThreads)
scan_g2_sums(const uint32_t* __restrict__ pts, const int32_t* __restrict__ starts,
             uint32_t* __restrict__ out, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
             int64_t* __restrict__ oz, int64_t* __restrict__ oinf) {
  extern __shared__ uint4 shared[];
  Fq2* R = reinterpret_cast<Fq2*>(shared);
  Fq* X = reinterpret_cast<Fq*>(R + curve::g2team::kTreeSlots);
  uint32_t* flag = reinterpret_cast<uint32_t*>(X + kSumXch);
  uint32_t* words = reinterpret_cast<uint32_t*>(R);  // point i: words [72 i, 72 i + 72)
  const int p = blockIdx.x;
  const int lo = starts[p];
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int in_warp = wl / curve::g2team::kLanes;
  const BlockTeams teams{in_warp < kSumTeamsPerWarp ? warp * kSumTeamsPerWarp + in_warp
                                                    : curve::g2team::kTreeTeams,
                         wl % curve::g2team::kLanes, X};
  constexpr int kPtWords = kG2Rec - 1;
  curve::g2team::sum(teams, R, flag, starts[p + 1] - lo, [&](int dst, int from, int m) {
    const uint32_t* src = pts + static_cast<int64_t>(lo + from) * kG2Rec;
    for (int w = threadIdx.x; w < m * kG2Rec; w += kSumThreads) {
      const int r = w / kG2Rec, c = w - r * kG2Rec;
      if (c < kPtWords) {
        words[(dst + r) * kPtWords + c] = src[w];
      } else {
        flag[dst + r] = src[w];
      }
    }
    __syncthreads();
  });
  if (ox == nullptr) {
    uint32_t* rec = out + static_cast<int64_t>(p) * kG2Rec;
    for (int w = threadIdx.x; w < kG2Rec; w += kSumThreads)
      rec[w] = w < kPtWords ? words[w] : flag[0];
    return;
  }
  if (threadIdx.x < curve::g2team::kLanes) {
    const int64_t o = static_cast<int64_t>(p) * 2 * fq::kLimbs;
    curve::g2team::store(team::Team{static_cast<int>(threadIdx.x), curve::g2team::kLanes, 0x3fu},
                         R, 0, ox + o, oy + o, oz + o);
    if (threadIdx.x == 0) oinf[p] = flag[0];
  }
}

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
  const unsigned warps = static_cast<unsigned>((n + kG1RowsPerWarp - 1) / kG1RowsPerWarp);
  scan_g1_rows<<<warps, kG1Threads, 0, static_cast<cudaStream_t>(stream)>>>(
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
extern "C" int hbbft_scan_g1_sums(const void* pts, const void* starts, int npieces, void* out,
                                  void* ox, void* oy, void* oz, void* oinf, void* stream) {
  if (npieces <= 0) return 0;
  scan_g1_sums<<<static_cast<unsigned>(npieces), kG1SumThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pts), static_cast<const int32_t*>(starts),
      static_cast<uint32_t*>(out), static_cast<int64_t*>(ox), static_cast<int64_t*>(oy),
      static_cast<int64_t*>(oz), static_cast<int64_t*>(oinf));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hbbft_scan_g2_sums(const void* pts, const void* starts, int npieces, void* out,
                                  void* ox, void* oy, void* oz, void* oinf, void* stream) {
  if (npieces <= 0) return 0;
  // Above 48 KB a block's shared memory must be asked for.
  const cudaError_t err = cudaFuncSetAttribute(
      scan_g2_sums, cudaFuncAttributeMaxDynamicSharedMemorySize, kSumShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_g2_sums<<<static_cast<unsigned>(npieces), kSumThreads, kSumShared,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pts), static_cast<const int32_t*>(starts),
      static_cast<uint32_t*>(out), static_cast<int64_t*>(ox), static_cast<int64_t*>(oy),
      static_cast<int64_t*>(oz), static_cast<int64_t*>(oinf));
  return static_cast<int>(cudaGetLastError());
}
