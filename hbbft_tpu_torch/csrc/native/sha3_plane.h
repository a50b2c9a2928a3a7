// Copy of native/sha3_plane.h for the PyTorch port (hbbft_tpu_torch), built by
// hbbft_tpu_torch/build.py.  Its edits, each listed here; the copy-drift
// test (tests/test_torch_native_copy.py) holds the copy to its original
// with these edits and no other:
//   1. Every name that began HBBFT_TPU and an underscore begins HBBFT_TORCH_
//      instead: the environment knobs and the comments that name them.
//   2. The reference's numbered work-item tags are taken out of comments.
// ---- end of the port's header ----
// Batched sha3 plane for the native engine: multi-message
// Keccak-f[1600] over contiguous equal-length inputs with an AVX-512
// 8-lane state-parallel arm and the hbn:: scalar arm behind the SAME
// runtime dispatch point as the field plane (hbf::simd_mode — one cell,
// one env knob, one in-process force for both planes).
//
// Layering:
//   * hbn::sha3_256 (sha3_gf.h) — the scalar FIPS-202 arm, always
//     available, also the per-message tail of every batched call.
//   * hbf_ifma_sha3_256_x8 (native/field_ifma.cpp) — eight independent
//     SHA3-256 states side by side, one Keccak lane word per __m512i
//     (state-parallel, NOT a tree/interleaved construction).  Compiled
//     only in the -mavx512ifma unit per the COMDAT rule; stubbed when
//     the toolchain lacks the flag, in which case hbf_ifma_compiled()
//     is 0 and the dispatch never reaches it.
//
// THE DISPATCH-IDENTITY CONTRACT (docs/INVARIANTS.md "SIMD dispatch
// identity") applies verbatim: both arms compute the exact FIPS-202
// SHA3-256 digest of each message — the boundary values are digests,
// never internal state — so protocol outputs are byte-identical across
// HBBFT_TORCH_SIMD=0/1 by construction and the equivalence suites pin it.
//
// Consumers (engine.cpp): kdf_stream block generation, Merkle
// leaf/branch level hashing in RBC encode/decode.  Long single messages
// (the DKG ciphertext digest) go through sha3_256_one — lane
// parallelism cannot help one message, and the stats keep that honest.
//
// This header references the hbf_ifma_* arm and therefore must be
// included ONLY by translation units linked against field_ifma.o (the
// engine); hbbft_native.cpp must keep including sha3_gf.h alone.

#ifndef HBBFT_SHA3_PLANE_H
#define HBBFT_SHA3_PLANE_H

#include <atomic>
#include <cstdint>
#include <cstring>

#include "field_plane.h"
#include "sha3_gf.h"

extern "C" {
// 8 messages of msg_len bytes at in, in+msg_len, ...; 8 digests of 32
// bytes at out, out+32, ...
void hbf_ifma_sha3_256_x8(const uint8_t* in, size_t msg_len, uint8_t* out);
}

namespace hbs {

// Batch-plane counters (relaxed atomics: multicore workers hash too).
// Exported via hbe_sha3_stats for the self-documenting benchmark lines.
struct Sha3Stats {
  std::atomic<uint64_t> batch_calls{0};  // sha3_256_batch invocations
  std::atomic<uint64_t> batch_msgs{0};   // messages through the batch entry
  std::atomic<uint64_t> ifma_msgs{0};    // of those, hashed by the 8-lane arm
  std::atomic<uint64_t> single_msgs{0};  // messages through sha3_256_one
};

inline Sha3Stats& stats() {
  static Sha3Stats s;
  return s;
}

// One message (the honest path for long inputs: ct digests and the
// like).  Same digest as hbn::sha3_256 — it IS hbn::sha3_256.
inline void sha3_256_one(const uint8_t* in, size_t len, uint8_t out32[32]) {
  stats().single_msgs.fetch_add(1, std::memory_order_relaxed);
  hbn::sha3_256(in, len, out32);
}

// count messages, each msg_len bytes, contiguous at stride msg_len;
// digests written contiguously (32 bytes each) to out.  Dispatches
// full groups of 8 to the state-parallel arm, the remainder to the
// scalar arm — per-message digests are identical either way.
inline void sha3_256_batch(const uint8_t* in, size_t msg_len, size_t count,
                           uint8_t* out) {
  if (!count) return;
  Sha3Stats& st = stats();
  st.batch_calls.fetch_add(1, std::memory_order_relaxed);
  st.batch_msgs.fetch_add(count, std::memory_order_relaxed);
  size_t i = 0;
  if (hbf::simd_mode() && count >= 8) {
    size_t main = count & ~(size_t)7;
    for (; i < main; i += 8)
      hbf_ifma_sha3_256_x8(in + i * msg_len, msg_len, out + i * 32);
    st.ifma_msgs.fetch_add(main, std::memory_order_relaxed);
  }
  for (; i < count; ++i) hbn::sha3_256(in + i * msg_len, msg_len, out + i * 32);
}

}  // namespace hbs

#endif  // HBBFT_SHA3_PLANE_H
