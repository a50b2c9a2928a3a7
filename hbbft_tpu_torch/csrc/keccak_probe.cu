// Probes of the Keccak kernels' issue rate on the card, for
// benchmarks_torch/keccak_rate.py.  Not used by the port's entry points.
//
// * alu_probe<op>: every thread runs 16 independent chains of one 32-bit
//   instruction, a 3-input XOR (LOP3, op 0) or a funnel shift (SHF, op 1),
//   and its block's first thread records the SM clocks the loop took: the
//   rate one SM sustains for that instruction at a given number of warps.
// * loads_only: sha3_256_kernel's staging and absorb (keccak.cu, on
//   keccak.cuh) with no permutation; perm_only: the permutations of a
//   register state with no loads.  Together they split the sponge's time.

#include <cstdint>
#include <cuda_runtime.h>

#include "keccak.cuh"

namespace {

template <int kOp>
__global__ void alu_probe(uint32_t* out, long long* cycles, int iters) {
  uint32_t acc[16];
  const uint32_t x = threadIdx.x * 0x9E3779B9u + blockIdx.x, y = ~x;
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = x + j;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (kOp == 0) {
        asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(acc[j]) : "r"(x), "r"(y));
      } else {
        asm volatile("shf.l.wrap.b32 %0, %0, %1, 7;" : "+r"(acc[j]) : "r"(x));
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) r ^= acc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

constexpr int kThreads = 128;  // messages per block, as in sha3_256_kernel

// keccak::absorb without its permutations.
__global__ void __launch_bounds__(kThreads)
loads_only(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int64_t batch, int nb) {
  __shared__ __align__(16) uint32_t ring[2][kThreads][keccak::kSlotWords];
  const int64_t msg = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (msg >= batch) return;
  const int64_t len = static_cast<int64_t>(nb) * keccak::kRate;
  const keccak::Message m{reinterpret_cast<uintptr_t>(in + msg * len), 0, len, -1, nb};
  const keccak::Ring slots{{ring[0][threadIdx.x], ring[1][threadIdx.x]}};
  keccak::State a;
  keccak::clear(a);
  keccak::stage_block(m, 0, slots.at(0));
  keccak::commit_chunks();
  for (int b = 0; b < nb; ++b) {
    const bool more = b + 1 < nb;
    if (more) keccak::stage_block(m, b + 1, slots.at(b + 1));
    keccak::commit_chunks();
    keccak::wait_chunks(more ? 1 : 0);
    keccak::absorb_block(a, m, b, slots.at(b));
  }
  uint32_t d[keccak::kDigestWords];
  keccak::digest(a, d);
  keccak::put_words(out + msg * 32, d, keccak::kDigestWords);
}

__global__ void __launch_bounds__(kThreads) perm_only(uint8_t* out, int64_t batch, int nb) {
  const int64_t msg = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (msg >= batch) return;
  keccak::State a;
  for (int i = 0; i < 25; ++i) {
    a.lo[i] = static_cast<uint32_t>(msg) * (2 * i + 1);
    a.hi[i] = static_cast<uint32_t>(msg >> 32) + i;
  }
  for (int b = 0; b < nb; ++b) keccak::permute(a);
  uint32_t d[keccak::kDigestWords];
  keccak::digest(a, d);
  keccak::put_words(out + msg * 32, d, keccak::kDigestWords);
}

}  // namespace

// op 0: LOP3, 1: SHF.  out: blocks * threads words; cycles: blocks values.
extern "C" int hbbft_probe_alu(int op, int blocks, int threads, int iters, void* out,
                               void* cycles, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<uint32_t*>(out);
  auto c = static_cast<long long*>(cycles);
  if (op == 0) {
    alu_probe<0><<<blocks, threads, 0, s>>>(o, c, iters);
  } else {
    alu_probe<1><<<blocks, threads, 0, s>>>(o, c, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// variant 0: sha3_256_kernel's staging and absorb without a permutation,
// 1: its permutations without loads.  in: (batch, nb * 136) bytes (unread
// by 1); out: (batch, 32) bytes, 16-byte aligned.
extern "C" int hbbft_probe_sponge(int variant, const void* in, void* out, long long batch,
                                  int nb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((batch + kThreads - 1) / kThreads);
  auto o = static_cast<uint8_t*>(out);
  switch (variant) {
    case 0: loads_only<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(in), o, batch, nb);
            break;
    case 1: perm_only<<<grid, kThreads, 0, s>>>(o, batch, nb); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
