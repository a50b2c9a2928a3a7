// Batched SHA3-256 and the data plane's Merkle trees, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel hbbft_tpu/ops/jaxops/keccak_pallas.py:_keccak_kernel
// (the Pallas Keccak-f[1600] permutation over a (50, batch) uint32 column
// state) together with its sponge wrappers sha3_256_block/_multi/_batch,
// which absorbed one block per pallas_call with a host round trip between
// blocks, and the level loop of hbbft_tpu/ops/jaxops/dataplane.py:52 around
// them.  The permutation, the absorb and the tree's per-thread code are in
// keccak.cuh, which the host check builds too.
//
// Two kernels:
//
// * sha3_256_kernel: one thread per message over pre-padded (batch, nb *
//   136) bytes, every block of every message in one launch, writing only
//   the 32-byte digests.  Each thread stages its message's next block into
//   its own two shared-memory slots with cp.async while it permutes the
//   current one, so no barrier is needed.
// * merkle_tree_kernel: one block per value, the whole tree in one launch.
//   Thread t hashes leaf t, SHA3-256(0x00 || shard t), straight from the
//   (V, n, s) shard tensor: the prefix and the padding are set in
//   registers, so no prefixed or padded copy of the shards is made.  Slots
//   past the last leaf take the padding digest H(0x00).  Then, level by
//   level after a block barrier, width / 2 threads hash 0x01 || left ||
//   right, one block each, up to the root.  Every digest goes to the
//   (V, 2 size - 1, 32) output as it is made, and a level reads its
//   children back from there (the block's own writes, L2-resident): the
//   tree's size is then bounded by nothing in the block, and a thread
//   loops over leaves and nodes when they outnumber its block's 128
//   threads.  The critical path is nb + depth permutations on one thread
//   (14 + 7 at the data plane's N = 104).
//
// What bounds them: integer operations.  A permutation needs at least 4,343
// 32-bit instructions (keccak.cuh; chip_smoke.py derives the count) against
// 136 bytes read per block, about 32 operations per byte, where the card's
// 32-bit integer rate over its 3.35 TB/s memory rate gives about 5.  Each
// input byte is read once and each digest written once; the loads of the
// next block are in flight while the current one is permuted.

#include <cstdint>
#include <cuda_runtime.h>

#include "keccak.cuh"

namespace {

constexpr int kThreads = 128;  // messages per block of sha3_256_kernel

using keccak::kSlotWords;

__global__ void __launch_bounds__(kThreads)
sha3_256_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int64_t batch, int nb) {
  __shared__ __align__(16) uint32_t ring[2][kThreads][kSlotWords];
  const int64_t msg = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (msg >= batch) return;  // no barrier follows
  const int64_t len = static_cast<int64_t>(nb) * keccak::kRate;
  const keccak::Message m{reinterpret_cast<uintptr_t>(in + msg * len), 0, len, -1, nb};
  keccak::State a;
  keccak::clear(a);
  keccak::absorb(a, m, keccak::Ring{{ring[0][threadIdx.x], ring[1][threadIdx.x]}});
  uint32_t d[keccak::kDigestWords];
  keccak::digest(a, d);
  keccak::put_words(out + msg * 32, d, keccak::kDigestWords);
}

__global__ void __launch_bounds__(keccak::kTreeThreads) merkle_tree_kernel(keccak::Tree t) {
  __shared__ __align__(16) uint32_t ring[2][keccak::kTreeThreads][kSlotWords];
  const int v = blockIdx.x;
  keccak::tree_leaves(t, v, threadIdx.x, blockDim.x,
                      keccak::Ring{{ring[0][threadIdx.x], ring[1][threadIdx.x]}});
  int64_t at = t.size;
  for (int width = t.size / 2; width >= 1; width /= 2) {
    __syncthreads();  // the level below is written
    keccak::tree_level(t, v, threadIdx.x, blockDim.x, at, width);
    at += width;
  }
}

}  // namespace

// in: (batch, nb * 136) bytes; out: (batch, 32) bytes, 16-byte aligned;
// both on the device.  Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int hbbft_sha3_256(const void* in, void* out, long long batch, int nb, void* stream) {
  if (batch <= 0 || nb <= 0) return 0;
  const long long grid = (batch + kThreads - 1) / kThreads;
  sha3_256_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<int64_t>(batch), nb);
  return static_cast<int>(cudaGetLastError());
}

// shards: (values, n, s) bytes; out: (values, 2 size - 1, 32) bytes,
// 16-byte aligned, size = the next power of two >= n; both on the device.
// Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int hbbft_merkle_tree(const void* shards, void* out, int values, int n, int s,
                                 void* stream) {
  if (values <= 0 || n <= 0) return 0;
  const int size = keccak::tree_size(n);
  const keccak::Tree t{static_cast<const uint8_t*>(shards), static_cast<uint8_t*>(out), n, s,
                       size};
  merkle_tree_kernel<<<static_cast<unsigned>(values), keccak::tree_threads(size), 0,
                       static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
