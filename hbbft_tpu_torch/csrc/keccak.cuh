// Keccak-f[1600] and the SHA3-256 sponge for the port's hand-written Keccak
// kernels (K1, csrc/keccak.cu).
//
// Replaces, inside the kernels, the permutation of
// hbbft_tpu/ops/jaxops/keccak_pallas.py:_keccak_kernel (a (50, batch)
// uint32 column state on the TPU) and the block absorb of its sponge
// wrappers.  Everything here is __host__ __device__ code: the kernels run
// it on the card, and csrc/keccak_check.cc, compiled by a host C++
// compiler, runs the same functions one thread after another for
// tests/test_torch_keccak_host.py.
//
// The state is 25 64-bit lanes held as explicit 32-bit halves, the width of
// the card's integer instructions.  On the card a round is the least the
// instruction set allows, 178 instructions (chip_smoke.py derives the
// bound from the same count): theta's column parities as two 3-input XORs
// (LOP3) per half, their 1-bit rotations as two funnel shifts (SHF), D
// folded into each lane as one more 3-input XOR per half (a ^ c[x-1] ^
// rot(c[x+1]); a compiler that computes D once spends 10 more), rho as two
// funnel shifts per lane, chi as one LOP3 per half (a ^ (~b & c)).  The
// LOP3s are written as PTX so that no compiler pass splits them.  The 24
// rounds run as a loop over one round's code (permute below), which adds
// a counter, a branch and iota's constant table reads to each round.
//
// The sponge stages each 136-byte block through shared memory with
// cp.async, one 16-byte chunk at a time from the 16-byte-aligned cover of
// the block's bytes, and builds its 17 lanes from the staged words with
// funnel shifts, so a message may start at any byte address.  A chunk is
// copied only when it holds at least one input byte of the block, so every
// copy stays inside the 16-byte-aligned granules the input already
// occupies (an allocation is never smaller than one).  Bytes that are not
// input (a prefix, the SHA3 padding, whatever a copied chunk holds beyond
// the message) are set in registers.

#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define KECCAK_HD __host__ __device__ __forceinline__
#else
#define KECCAK_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define KECCAK_UNROLL _Pragma("unroll")
#define KECCAK_NO_UNROLL _Pragma("unroll 1")
#else
#define KECCAK_UNROLL
#define KECCAK_NO_UNROLL
#endif

namespace keccak {

constexpr int kRate = 136;        // SHA3-256 rate in bytes
constexpr int kRateHalves = 34;   // the rate in 32-bit halves
constexpr int kSlotChunks = 10;   // 16-byte chunks staged per block (covers 15 + 136 bytes)
constexpr int kSlotWords = 4 * kSlotChunks + 4;  // a staging slot in 32-bit words; the 4 spare
                                                 // words keep 16-byte reads of a warp's
                                                 // slots apart in the banks
constexpr int kDigestWords = 8;   // 32 bytes

// Iota's round constants, one list: in constant memory on the card, a
// plain array on the host.
#define KECCAK_ROUND_CONSTANTS                                               \
  {                                                                          \
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,     \
        0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL, \
        0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL, \
        0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL, \
        0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL, \
        0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL, \
        0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL, \
        0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL, \
  }

#if defined(__CUDACC__)
__constant__ uint64_t kRcDevice[24] = KECCAK_ROUND_CONSTANTS;
#endif
constexpr uint64_t kRc[24] = KECCAK_ROUND_CONSTANTS;

KECCAK_HD uint64_t round_constant(int r) {
#if defined(__CUDA_ARCH__)
  return kRcDevice[r];
#else
  return kRc[r];
#endif
}

struct State {
  uint32_t lo[25], hi[25];  // lane x + 5y
};

// a ^ b ^ c and a ^ (~b & c), one LOP3 each on the card.
KECCAK_HD uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  return a ^ b ^ c;
#endif
}

KECCAK_HD uint32_t chi(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xD2;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  return a ^ (~b & c);
#endif
}

// The high word of (hi:lo) << r and the low word of (hi:lo) >> r, 0 <= r < 32
// (one SHF each on the card).
KECCAK_HD uint32_t funnel_l(uint32_t lo, uint32_t hi, uint32_t r) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(lo, hi, r);
#else
  return r ? (hi << r) | (lo >> (32 - r)) : hi;
#endif
}

KECCAK_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, uint32_t r) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, r);
#else
  return r ? (lo >> r) | (hi << (32 - r)) : lo;
#endif
}

// The 64-bit lane (lo, hi) rotated left by R, into (nlo, nhi).
template <int R>
KECCAK_HD void rotl(uint32_t lo, uint32_t hi, uint32_t& nlo, uint32_t& nhi) {
  static_assert(R > 0 && R < 64 && R != 32, "rotation amount");
  if constexpr (R < 32) {
    nlo = funnel_l(hi, lo, R);
    nhi = funnel_l(lo, hi, R);
  } else {
    nlo = funnel_l(lo, hi, R - 32);
    nhi = funnel_l(hi, lo, R - 32);
  }
}

// One round in place; iota's constant halves are given.
KECCAK_HD void one_round(State& a, uint32_t rc_lo, uint32_t rc_hi) {
  uint32_t clo[5], chh[5];
KECCAK_UNROLL
  for (int x = 0; x < 5; ++x) {
    clo[x] = xor3(xor3(a.lo[x], a.lo[x + 5], a.lo[x + 10]), a.lo[x + 15], a.lo[x + 20]);
    chh[x] = xor3(xor3(a.hi[x], a.hi[x + 5], a.hi[x + 10]), a.hi[x + 15], a.hi[x + 20]);
  }
KECCAK_UNROLL
  for (int x = 0; x < 5; ++x) {
    uint32_t rlo, rhi;
    rotl<1>(clo[(x + 1) % 5], chh[(x + 1) % 5], rlo, rhi);
    const uint32_t plo = clo[(x + 4) % 5], phi = chh[(x + 4) % 5];
KECCAK_UNROLL
    for (int y = 0; y < 5; ++y) {
      a.lo[x + 5 * y] = xor3(a.lo[x + 5 * y], plo, rlo);
      a.hi[x + 5 * y] = xor3(a.hi[x + 5 * y], phi, rhi);
    }
  }
  // rho + pi: b[y + 5((2x + 3y) mod 5)] = rotl(a[x + 5y], RHO[x][y])
  State b;
  b.lo[0] = a.lo[0];
  b.hi[0] = a.hi[0];
  rotl<36>(a.lo[5], a.hi[5], b.lo[16], b.hi[16]);
  rotl<3>(a.lo[10], a.hi[10], b.lo[7], b.hi[7]);
  rotl<41>(a.lo[15], a.hi[15], b.lo[23], b.hi[23]);
  rotl<18>(a.lo[20], a.hi[20], b.lo[14], b.hi[14]);
  rotl<1>(a.lo[1], a.hi[1], b.lo[10], b.hi[10]);
  rotl<44>(a.lo[6], a.hi[6], b.lo[1], b.hi[1]);
  rotl<10>(a.lo[11], a.hi[11], b.lo[17], b.hi[17]);
  rotl<45>(a.lo[16], a.hi[16], b.lo[8], b.hi[8]);
  rotl<2>(a.lo[21], a.hi[21], b.lo[24], b.hi[24]);
  rotl<62>(a.lo[2], a.hi[2], b.lo[20], b.hi[20]);
  rotl<6>(a.lo[7], a.hi[7], b.lo[11], b.hi[11]);
  rotl<43>(a.lo[12], a.hi[12], b.lo[2], b.hi[2]);
  rotl<15>(a.lo[17], a.hi[17], b.lo[18], b.hi[18]);
  rotl<61>(a.lo[22], a.hi[22], b.lo[9], b.hi[9]);
  rotl<28>(a.lo[3], a.hi[3], b.lo[5], b.hi[5]);
  rotl<55>(a.lo[8], a.hi[8], b.lo[21], b.hi[21]);
  rotl<25>(a.lo[13], a.hi[13], b.lo[12], b.hi[12]);
  rotl<21>(a.lo[18], a.hi[18], b.lo[3], b.hi[3]);
  rotl<56>(a.lo[23], a.hi[23], b.lo[19], b.hi[19]);
  rotl<27>(a.lo[4], a.hi[4], b.lo[15], b.hi[15]);
  rotl<20>(a.lo[9], a.hi[9], b.lo[6], b.hi[6]);
  rotl<39>(a.lo[14], a.hi[14], b.lo[22], b.hi[22]);
  rotl<8>(a.lo[19], a.hi[19], b.lo[13], b.hi[13]);
  rotl<14>(a.lo[24], a.hi[24], b.lo[4], b.hi[4]);
KECCAK_UNROLL
  for (int y = 0; y < 25; y += 5) {
KECCAK_UNROLL
    for (int x = 0; x < 5; ++x) {
      a.lo[y + x] = chi(b.lo[y + x], b.lo[y + (x + 1) % 5], b.lo[y + (x + 2) % 5]);
      a.hi[y + x] = chi(b.hi[y + x], b.hi[y + (x + 1) % 5], b.hi[y + (x + 2) % 5]);
    }
  }
  a.lo[0] ^= rc_lo;
  a.hi[0] ^= rc_hi;
}

// Keccak-f[1600] in place: one round's code in a loop.  Unrolled, a
// permutation is ~4,400 instructions (~70 KB of machine code, twice over
// where a caller's block loop is unrolled by two), beyond what the SM's
// instruction caches hold; at the data plane's leaf shape the round loop
// ran 27% faster (PERF.md §6, K1).
KECCAK_HD void permute(State& a) {
KECCAK_NO_UNROLL
  for (int r = 0; r < 24; ++r) {
    const uint64_t rc = round_constant(r);
    one_round(a, static_cast<uint32_t>(rc), static_cast<uint32_t>(rc >> 32));
  }
}

KECCAK_HD void clear(State& a) {
  KECCAK_UNROLL
  for (int i = 0; i < 25; ++i) a.lo[i] = a.hi[i] = 0;
}

// The squeeze: the first 32 bytes of the state, little-endian.
KECCAK_HD void digest(const State& a, uint32_t out[kDigestWords]) {
  KECCAK_UNROLL
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = a.lo[i];
    out[2 * i + 1] = a.hi[i];
  }
}

// Bits of the bytes [a, b) of a 32-bit word, clipped to [0, 4).
KECCAK_HD uint32_t byte_mask(int a, int b) {
  a = a < 0 ? 0 : a;
  b = b > 4 ? 4 : b;
  if (b <= a) return 0u;
  return static_cast<uint32_t>(((uint64_t{1} << (8 * (b - a))) - 1) << (8 * a));
}

// One message of a sponge: byte j of the message is at address start + j
// for data_lo <= j < data_hi and is not input elsewhere (a prefix below
// data_lo, which the caller sets; the padding above data_hi).  `start` may
// lie before the input, so it is an integer address.  pad >= 0: the SHA3
// padding (0x06 at pad, 0x80 at the end of the last block) is applied in
// registers; pad < 0: the input is padded already.
struct Message {
  uintptr_t start;
  int64_t data_lo, data_hi;
  int64_t pad;
  int nb;  // blocks absorbed
};

// A 16-byte copy from the device (or host) address src into the staging
// slot; cp.async on the card, so it runs while the thread permutes.
KECCAK_HD void copy_chunk(uint32_t* dst, uintptr_t src) {
#if defined(__CUDA_ARCH__)
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(reinterpret_cast<const void*>(src))
               : "memory");
#else
  std::memcpy(dst, reinterpret_cast<const void*>(src), 16);
#endif
}

KECCAK_HD void commit_chunks() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;");
#endif
}

// Wait until at most `pending` (0 or 1) committed groups are in flight.
KECCAK_HD void wait_chunks(int pending) {
#if defined(__CUDA_ARCH__)
  if (pending) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
#else
  (void)pending;
#endif
}

// Stage block `blk` of message m into `slot`: the chunks of the block's
// 16-byte-aligned cover that hold at least one of its input bytes.
KECCAK_HD void stage_block(const Message& m, int blk, uint32_t* slot) {
  const int64_t first = static_cast<int64_t>(blk) * kRate;
  const int64_t lo = first > m.data_lo ? first : m.data_lo;
  const int64_t hi = first + kRate < m.data_hi ? first + kRate : m.data_hi;
  if (hi <= lo) return;
  const uintptr_t block = m.start + first;
  const uintptr_t base = block & ~uintptr_t{15};
  const uintptr_t in_lo = m.start + lo, in_hi = m.start + hi;
KECCAK_UNROLL
  for (int c = 0; c < kSlotChunks; ++c) {
    const uintptr_t chunk = base + 16 * c;
    if (chunk < in_hi && chunk + 16 > in_lo) copy_chunk(slot + 4 * c, chunk);
  }
}

// XOR block `blk` of message m, staged in `slot`, into the rate: the 34
// halves read from the slot at the block's byte offset, the bytes that are
// not input cleared, the padding set.
KECCAK_HD void absorb_block(State& a, const Message& m, int blk, const uint32_t* slot) {
  const int64_t first = static_cast<int64_t>(blk) * kRate;
  const uint32_t off = static_cast<uint32_t>((m.start + first) & 15);
  const uint32_t* w = slot + (off >> 2);
  const uint32_t shift = 8 * (off & 3);
  const int64_t jlo = m.data_lo - first, jhi = m.data_hi - first;
  const bool edge = jlo > 0 || jhi < kRate;
  const bool last = blk == m.nb - 1;
  uint32_t h[kRateHalves];
KECCAK_UNROLL
  for (int i = 0; i < kRateHalves; ++i) h[i] = funnel_r(w[i], w[i + 1], shift);
  if (edge) {
    const int keep_lo = jlo < 0 ? 0 : static_cast<int>(jlo < kRate ? jlo : kRate);
    const int keep_hi = jhi < 0 ? 0 : static_cast<int>(jhi < kRate ? jhi : kRate);
KECCAK_UNROLL
    for (int i = 0; i < kRateHalves; ++i) h[i] &= byte_mask(keep_lo - 4 * i, keep_hi - 4 * i);
  }
  if (m.pad >= 0 && last) {
    const int p = static_cast<int>(m.pad - first);  // 0 <= p < kRate in the last block
KECCAK_UNROLL
    for (int i = 0; i < kRateHalves; ++i) {
      if (p >> 2 == i) h[i] ^= 0x06u << (8 * (p & 3));
    }
    h[kRateHalves - 1] ^= 0x80u << 24;
  }
KECCAK_UNROLL
  for (int i = 0; i < kRateHalves / 2; ++i) {
    a.lo[i] ^= h[2 * i];
    a.hi[i] ^= h[2 * i + 1];
  }
}

// A thread's two staging slots (16-byte aligned, kSlotWords each).
struct Ring {
  uint32_t* slot[2];
  // Slot i & 1, chosen without indexing (an indexed pair would be kept in
  // local memory on the card).
  KECCAK_HD uint32_t* at(int i) const { return (i & 1) ? slot[1] : slot[0]; }
};

// The whole sponge of one message on one thread: block b + 1 is staged
// (in flight on the card) while block b is permuted.
KECCAK_HD void absorb(State& a, const Message& m, const Ring& ring) {
  stage_block(m, 0, ring.at(0));
  commit_chunks();
  for (int b = 0; b < m.nb; ++b) {
    const bool more = b + 1 < m.nb;
    if (more) stage_block(m, b + 1, ring.at(b + 1));
    commit_chunks();
    wait_chunks(more ? 1 : 0);
    absorb_block(a, m, b, ring.at(b));
    permute(a);
  }
}

// A Merkle node, SHA3-256(0x01 || left || right), from the two children's
// 16 digest words: one block, the 64 bytes shifted up by the prefix byte.
KECCAK_HD void node(const uint32_t kids[2 * kDigestWords], uint32_t out[kDigestWords]) {
  State a;
  clear(a);
  uint32_t h[kRateHalves] = {};
  h[0] = 0x01u | (kids[0] << 8);
  KECCAK_UNROLL
  for (int i = 1; i < 2 * kDigestWords; ++i) h[i] = funnel_l(kids[i - 1], kids[i], 8);
  h[2 * kDigestWords] = (kids[2 * kDigestWords - 1] >> 24) | (0x06u << 8);
  h[kRateHalves - 1] = 0x80u << 24;
  KECCAK_UNROLL
  for (int i = 0; i < kRateHalves / 2; ++i) {
    a.lo[i] = h[2 * i];
    a.hi[i] = h[2 * i + 1];
  }
  permute(a);
  digest(a, out);
}

// ---- The Merkle tree of one value (keccak_merkle_tree's block) ----------
//
// Leaves are SHA3-256(0x00 || shard), n of them, padded with H(0x00) up to
// size = the next power of two; level l + 1 hashes the pairs of level l.
// The output holds every level bottom up, (2 size - 1) digests: the
// layout of hbbft_tpu/ops/native.py:221 merkle_levels.

struct Tree {
  const uint8_t* shards;  // (V, n, s) bytes, contiguous
  uint8_t* out;           // (V, 2 size - 1, 32) bytes
  int n, s, size;
};

KECCAK_HD int tree_size(int n) {
  int size = 1;
  while (size < n) size <<= 1;
  return size;
}

// Threads of a tree's block: one per leaf slot, at most kTreeThreads (a
// thread then loops over leaves and nodes).
constexpr int kTreeThreads = 128;

KECCAK_HD int tree_threads(int size) { return size < kTreeThreads ? size : kTreeThreads; }

KECCAK_HD uint8_t* tree_row(const Tree& t, int v, int64_t row) {
  return t.out + (static_cast<int64_t>(v) * (2 * t.size - 1) + row) * 32;
}

// n words to and from a 16-byte-aligned row of the output.
KECCAK_HD void put_words(uint8_t* dst, const uint32_t* w, int n) {
#if defined(__CUDA_ARCH__)
  KECCAK_UNROLL
  for (int i = 0; i < n; i += 4) {
    reinterpret_cast<uint4*>(dst)[i / 4] = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  }
#else
  std::memcpy(dst, w, 4 * n);
#endif
}

KECCAK_HD void get_words(const uint8_t* src, uint32_t* w, int n) {
#if defined(__CUDA_ARCH__)
  KECCAK_UNROLL
  for (int i = 0; i < n; i += 4) {
    const uint4 q = reinterpret_cast<const uint4*>(src)[i / 4];
    w[i] = q.x;
    w[i + 1] = q.y;
    w[i + 2] = q.z;
    w[i + 3] = q.w;
  }
#else
  std::memcpy(w, src, 4 * n);
#endif
}

// Thread `t` of `threads`: the leaves t, t + threads, ... of value v, each
// digest into level 0 of the output.  Threads past the last leaf write
// the padding digest.
KECCAK_HD void tree_leaves(const Tree& t, int v, int thread, int threads, const Ring& ring) {
  const int nb = (1 + t.s) / kRate + 1;
  for (int leaf = thread; leaf < t.size; leaf += threads) {
    uint32_t d[kDigestWords];
    if (leaf < t.n) {
      const uint8_t* row = t.shards + (static_cast<int64_t>(v) * t.n + leaf) * t.s;
      // Message byte 0 is the prefix 0x00, byte 1 + i is shard byte i.
      const Message m{reinterpret_cast<uintptr_t>(row) - 1, 1, 1 + int64_t{t.s},
                      1 + int64_t{t.s}, nb};
      State a;
      clear(a);
      absorb(a, m, ring);
      digest(a, d);
    } else {
      // SHA3-256 of the one byte 0x00, the digest of a padding leaf.
      constexpr uint32_t pad[kDigestWords] = {0x9f46535du, 0xf8f4fe20u, 0x882bb5eau,
                                              0x69de4e04u, 0x686a7ac7u, 0x602807a6u,
                                              0x5fa6c49fu, 0xd0e731f5u};
      KECCAK_UNROLL
      for (int i = 0; i < kDigestWords; ++i) d[i] = pad[i];
    }
    put_words(tree_row(t, v, leaf), d, kDigestWords);
  }
}

// Thread `t` of `threads`: the nodes t, t + threads, ... of the level of
// `width` nodes at output row `at`, whose children are the level below it.
KECCAK_HD void tree_level(const Tree& t, int v, int thread, int threads, int64_t at, int width) {
  for (int i = thread; i < width; i += threads) {
    uint32_t kids[2 * kDigestWords], d[kDigestWords];
    get_words(tree_row(t, v, at - 2 * width + 2 * i), kids, 2 * kDigestWords);
    node(kids, d);
    put_words(tree_row(t, v, at + i), d, kDigestWords);
  }
}

}  // namespace keccak
