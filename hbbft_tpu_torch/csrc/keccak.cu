// Batched SHA3-256 over pre-padded messages, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel hbbft_tpu/ops/jaxops/keccak_pallas.py:_keccak_kernel
// (the Pallas Keccak-f[1600] permutation over a (50, batch) uint32 column
// state) together with its sponge wrappers sha3_256_block/_multi/_batch,
// which absorbed one block per pallas_call with a host round trip between
// blocks.  Here one launch absorbs every block of every message and writes
// only the 32-byte digests.
//
// Layout: one thread per message.  The 25 lanes live as uint64_t in
// registers; the TPU's lo/hi uint32 split existed only for its 32-bit lanes
// and is not carried over.  The 24 rounds are fully unrolled and every
// rotation amount is a compile-time constant, so each rotation is a pair of
// funnel shifts.
//
// Inputs: `in` is (batch, nb * 136) bytes, row-major, 8-byte aligned.  A
// block of kThreads threads stages its messages' current 136-byte block
// through shared memory with consecutive threads on consecutive 8-byte
// words (each message's block is one contiguous 136-byte run), then each
// thread XORs its 17 rate lanes from shared memory (stride 17 words, odd,
// so no two threads of a warp hit one bank pair) and permutes.
//
// What bounds it: integer operations.  A permutation needs at least 4,343
// 32-bit instructions (24 rounds of 178 three-input logic ops and funnel
// shifts on the lanes' 32-bit halves, plus iota and the 17-lane absorb;
// chip_smoke.py derives the count) against 136 bytes read per block,
// about 32 operations per byte, where the card's 32-bit integer rate over
// its 3.35 TB/s memory rate gives about 5 operations per byte.
// The design keeps the whole state in registers, reads each input byte
// once and writes each digest byte once, so all that remains is the
// arithmetic itself.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRateWords = 17;  // 136-byte SHA3-256 rate, in 64-bit lanes
constexpr int kThreads = 128;   // messages per block

__constant__ uint64_t kRoundConstants[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

template <int R>
__device__ __forceinline__ uint64_t rotl(uint64_t x) {
  static_assert(R > 0 && R < 64, "rotation amount");
  return (x << R) | (x >> (64 - R));
}

// Keccak-f[1600] in place; lane index x + 5y.
__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
#pragma unroll
  for (int round = 0; round < 24; ++round) {
    // theta
    uint64_t c[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    }
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);
#pragma unroll
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d;
    }
    // rho + pi: b[y + 5((2x + 3y) mod 5)] = rotl(a[x + 5y], RHO[x][y])
    uint64_t b[25];
    b[0] = a[0];
    b[16] = rotl<36>(a[5]);
    b[7] = rotl<3>(a[10]);
    b[23] = rotl<41>(a[15]);
    b[14] = rotl<18>(a[20]);
    b[10] = rotl<1>(a[1]);
    b[1] = rotl<44>(a[6]);
    b[17] = rotl<10>(a[11]);
    b[8] = rotl<45>(a[16]);
    b[24] = rotl<2>(a[21]);
    b[20] = rotl<62>(a[2]);
    b[11] = rotl<6>(a[7]);
    b[2] = rotl<43>(a[12]);
    b[18] = rotl<15>(a[17]);
    b[9] = rotl<61>(a[22]);
    b[5] = rotl<28>(a[3]);
    b[21] = rotl<55>(a[8]);
    b[12] = rotl<25>(a[13]);
    b[3] = rotl<21>(a[18]);
    b[19] = rotl<56>(a[23]);
    b[15] = rotl<27>(a[4]);
    b[6] = rotl<20>(a[9]);
    b[22] = rotl<39>(a[14]);
    b[13] = rotl<8>(a[19]);
    b[4] = rotl<14>(a[24]);
    // chi
#pragma unroll
    for (int y = 0; y < 5; ++y) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        a[x + 5 * y] =
            b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
      }
    }
    // iota
    a[0] ^= kRoundConstants[round];
  }
}

__global__ void __launch_bounds__(kThreads)
sha3_256_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                int64_t batch, int nb) {
  __shared__ uint64_t stage[kThreads * kRateWords];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t row_words = static_cast<int64_t>(nb) * kRateWords;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;

  for (int blk = 0; blk < nb; ++blk) {
    __syncthreads();  // the previous block's lanes have been read
    for (int t = threadIdx.x; t < kThreads * kRateWords; t += kThreads) {
      const int m = t / kRateWords;
      const int w = t - m * kRateWords;
      const int64_t msg = first + m;
      stage[t] = msg < batch
                     ? in[msg * row_words + static_cast<int64_t>(blk) * kRateWords + w]
                     : 0ULL;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kRateWords; ++w) {
      a[w] ^= stage[threadIdx.x * kRateWords + w];
    }
    keccak_f(a);
  }

  const int64_t msg = first + threadIdx.x;
  if (msg < batch) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[msg * 4 + i] = a[i];  // 32-byte digest
  }
}

}  // namespace

// in: (batch, nb * 136) bytes; out: (batch, 32) bytes; both on the device,
// 8-byte aligned.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int hbbft_sha3_256(const void* in, void* out, long long batch,
                              int nb, void* stream) {
  if (batch <= 0 || nb <= 0) return 0;
  const long long grid = (batch + kThreads - 1) / kThreads;
  sha3_256_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
      static_cast<int64_t>(batch), nb);
  return static_cast<int>(cudaGetLastError());
}
