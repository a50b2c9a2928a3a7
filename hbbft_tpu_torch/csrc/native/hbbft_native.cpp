// Copy of native/hbbft_native.cpp for the PyTorch port (hbbft_tpu_torch), built by
// hbbft_tpu_torch/build.py.  Its edits, each listed here; the copy-drift
// test (tests/test_torch_native_copy.py) holds the copy to its original
// with these edits and no other:
//   1. Every name that began HBBFT_TPU and an underscore begins HBBFT_TORCH_
//      instead: the environment knobs and the comments that name them.
//   2. The reference's numbered work-item tags are taken out of comments.
// ---- end of the port's header ----
// Native host data plane: SHA3-256 / Merkle hashing and GF(256)
// Reed-Solomon erasure coding.
//
// Reference behavior: the reference's native (Rust) hot loops outside the
// pairing path — `tiny-keccak` SHA3-256 Merkle hashing and the
// `reed-solomon-erasure` GF(2^8) codec used by its broadcast module
// (SURVEY.md §2 #4).  This library is the host-side fast path of the new
// framework's data plane; the TPU (JAX) path batches the same ops on
// device, and the pure-Python implementations remain as oracles.
//
// Bit-exact contracts (checked by tests/test_native.py):
//  * SHA3-256 == hashlib.sha3_256 (FIPS 202 padding 0x06).
//  * Merkle levels == hbbft_tpu.ops.merkle.MerkleTree (leaf prefix 0x00,
//    branch prefix 0x01, pad with H(0x00) to the next power of two).
//  * RS matrix == hbbft_tpu.ops.gf256.encoding_matrix (poly 0x11d,
//    Vandermonde a_i = exp(i), systematic normalization).
//
// C ABI only (loaded via ctypes); no exceptions across the boundary.

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <utility>
#include <vector>

#include "sha3_gf.h"

// --------------------------------------------------------------------------
// Keccak-f[1600] / SHA3-256 (implementation shared via sha3_gf.h)
// --------------------------------------------------------------------------

namespace {

inline void sha3_256_one(const uint8_t* in, size_t len, uint8_t* out32) {
  hbn::sha3_256(in, len, out32);
}

}  // namespace

extern "C" {

void hb_sha3_256(const uint8_t* in, uint64_t len, uint8_t* out32) {
  sha3_256_one(in, static_cast<size_t>(len), out32);
}

// n messages of msg_len bytes each, contiguous -> n 32-byte digests.
void hb_sha3_256_batch(const uint8_t* in, uint64_t n, uint64_t msg_len,
                       uint8_t* out) {
  for (uint64_t i = 0; i < n; ++i)
    sha3_256_one(in + i * msg_len, static_cast<size_t>(msg_len), out + 32 * i);
}

// Merkle tree over n_leaves leaves of leaf_len bytes each.
// Writes every level bottom-up into out_levels: the padded leaf level has
// size = next power of two >= n_leaves, then size/2, ... down to 1 — a
// total of 2*size-1 32-byte nodes.  Leaf hash = H(0x00 || leaf); padding
// leaves use H(0x00); branch hash = H(0x01 || left || right).  Matches
// hbbft_tpu.ops.merkle.MerkleTree exactly.
void hb_merkle_levels(const uint8_t* leaves, uint64_t n_leaves,
                      uint64_t leaf_len, uint8_t* out_levels) {
  uint64_t size = 1;
  while (size < n_leaves) size <<= 1;

  std::vector<uint8_t> buf(1 + leaf_len);
  buf[0] = 0x00;
  uint8_t* level = out_levels;
  for (uint64_t i = 0; i < n_leaves; ++i) {
    std::memcpy(buf.data() + 1, leaves + i * leaf_len, leaf_len);
    sha3_256_one(buf.data(), 1 + leaf_len, level + 32 * i);
  }
  if (n_leaves < size) {
    uint8_t empty[32];
    uint8_t prefix = 0x00;
    sha3_256_one(&prefix, 1, empty);
    for (uint64_t i = n_leaves; i < size; ++i)
      std::memcpy(level + 32 * i, empty, 32);
  }
  uint8_t branch[65];
  branch[0] = 0x01;
  while (size > 1) {
    uint8_t* next = level + 32 * size;
    for (uint64_t i = 0; i < size / 2; ++i) {
      std::memcpy(branch + 1, level + 64 * i, 64);
      sha3_256_one(branch, 65, next + 32 * i);
    }
    level = next;
    size >>= 1;
  }
}

}  // extern "C"

// --------------------------------------------------------------------------
// GF(256) Reed-Solomon (poly 0x11d, generator 2)
// --------------------------------------------------------------------------

namespace {

inline void gf_matmul(const uint8_t* a, const uint8_t* b, uint8_t* out,
                      size_t m, size_t k, size_t n) {
  hbn::gf_matmul(a, b, out, m, k, n);
}

inline bool gf_mat_inv(const uint8_t* m_in, uint8_t* inv_out, size_t n) {
  return hbn::gf_mat_inv_t<std::vector<uint8_t>>(m_in, inv_out, n);
}

inline bool encoding_matrix_uncached(size_t k, size_t n,
                                     std::vector<uint8_t>& out) {
  return hbn::encoding_matrix_t<std::vector<uint8_t>>(k, n, out);
}

// Per-(k, n) cache: Broadcast creates one codec per RBC instance but the
// dimensions repeat (fixed validator set), and the O(k^3) normalization
// would otherwise rerun on every encode/reconstruct call.
bool encoding_matrix(size_t k, size_t n, const std::vector<uint8_t>*& out) {
  static std::mutex mu;
  static std::map<std::pair<size_t, size_t>, std::vector<uint8_t>> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto key = std::make_pair(k, n);
  auto it = cache.find(key);
  if (it == cache.end()) {
    std::vector<uint8_t> mat;
    if (!encoding_matrix_uncached(k, n, mat)) return false;
    it = cache.emplace(key, std::move(mat)).first;
  }
  out = &it->second;
  return true;
}

}  // namespace

extern "C" {

// data: k x size bytes -> parity: (n-k) x size bytes.  Returns 0 on ok.
int hb_rs_encode(const uint8_t* data, uint64_t k, uint64_t n, uint64_t size,
                 uint8_t* parity) {
  if (!k || k > n || n > 255) return 1;
  const std::vector<uint8_t>* mat;
  if (!encoding_matrix(k, n, mat)) return 2;
  gf_matmul(mat->data() + k * k, data, parity, n - k, k, size);
  return 0;
}

// shards: k x size bytes whose global indices are idxs[0..k) (sorted,
// unique, < n) -> out: the k x size data shards.  Returns 0 on ok.
int hb_rs_reconstruct(const uint8_t* shards, const uint64_t* idxs, uint64_t k,
                      uint64_t n, uint64_t size, uint8_t* out) {
  if (!k || k > n || n > 255) return 1;
  const std::vector<uint8_t>* mat;
  if (!encoding_matrix(k, n, mat)) return 2;
  std::vector<uint8_t> sub(k * k);
  for (uint64_t r = 0; r < k; ++r) {
    if (idxs[r] >= n) return 3;
    std::memcpy(sub.data() + r * k, mat->data() + idxs[r] * k, k);
  }
  std::vector<uint8_t> dec(k * k);
  if (!gf_mat_inv(sub.data(), dec.data(), k)) return 4;
  gf_matmul(dec.data(), shards, out, k, k, size);
  return 0;
}

// -- GF(2^16) variants (validator sets > 255; symbols 2B big-endian) -------

namespace {

// Shared per-(k, n) GF(2^16) matrix cache (same rationale as the
// GF(256) encoding_matrix helper above).
bool encoding_matrix16(uint64_t k, uint64_t n,
                       const std::vector<uint16_t>*& out) {
  static std::mutex mu;
  static std::map<std::pair<uint64_t, uint64_t>, std::vector<uint16_t>> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto key = std::make_pair(k, n);
  auto it = cache.find(key);
  if (it == cache.end()) {
    std::vector<uint16_t> m;
    if (!hbn::encoding_matrix16_t<std::vector<uint16_t>>(k, n, m))
      return false;
    it = cache.emplace(key, std::move(m)).first;
  }
  out = &it->second;
  return true;
}

}  // namespace

// data: k x size bytes (size even) -> parity: (n-k) x size bytes.
int hb_rs16_encode(const uint8_t* data, uint64_t k, uint64_t n, uint64_t size,
                   uint8_t* parity) {
  if (!k || k > n || n > 65535 || size % 2) return 1;
  const std::vector<uint16_t>* mat;
  if (!encoding_matrix16(k, n, mat)) return 2;
  uint64_t nsym = size / 2;
  std::vector<uint16_t> dsym(k * nsym), psym((n - k) * nsym);
  hbn::bytes_to_sym16(data, k * nsym, dsym.data());
  hbn::gf16_matmul(mat->data() + k * k, dsym.data(), psym.data(), n - k, k,
                   nsym);
  hbn::sym16_to_bytes(psym.data(), (n - k) * nsym, parity);
  return 0;
}

int hb_rs16_reconstruct(const uint8_t* shards, const uint64_t* idxs,
                        uint64_t k, uint64_t n, uint64_t size, uint8_t* out) {
  if (!k || k > n || n > 65535 || size % 2) return 1;
  const std::vector<uint16_t>* mat;
  if (!encoding_matrix16(k, n, mat)) return 2;
  std::vector<uint16_t> sub(k * k);
  for (uint64_t r = 0; r < k; ++r) {
    if (idxs[r] >= n) return 3;
    std::memcpy(sub.data() + r * k, mat->data() + idxs[r] * k, 2 * k);
  }
  std::vector<uint16_t> dec(k * k);
  if (!hbn::gf16_mat_inv_t<std::vector<uint16_t>>(sub.data(), dec.data(), k))
    return 4;
  uint64_t nsym = size / 2;
  std::vector<uint16_t> hsym(k * nsym), dsym(k * nsym);
  hbn::bytes_to_sym16(shards, k * nsym, hsym.data());
  hbn::gf16_matmul(dec.data(), hsym.data(), dsym.data(), k, k, nsym);
  hbn::sym16_to_bytes(dsym.data(), k * nsym, out);
  return 0;
}

}  // extern "C"
