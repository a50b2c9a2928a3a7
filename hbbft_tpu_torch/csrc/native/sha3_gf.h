// Copy of native/sha3_gf.h for the PyTorch port (hbbft_tpu_torch), built by
// hbbft_tpu_torch/build.py.  Its edits, each listed here; the copy-drift
// test (tests/test_torch_native_copy.py) holds the copy to its original
// with these edits and no other:
//   1. Every name that began HBBFT_TPU and an underscore begins HBBFT_TORCH_
//      instead: the environment knobs and the comments that name them.
//   2. The reference's numbered work-item tags are taken out of comments.
// ---- end of the port's header ----
// Shared native primitives: Keccak-f[1600]/SHA3-256 and GF(256) tables.
//
// Used by both the data-plane library (hbbft_native.cpp) and the
// protocol engine (engine.cpp).  Bit-exact contracts (pinned by
// tests/test_native.py):
//  * SHA3-256 == hashlib.sha3_256 (FIPS 202 padding 0x06).
//  * GF(256) tables: poly 0x11d, generator 2 (gf256.py).
//
// Header-only (inline / function-local statics) so each .so carries its
// own copy without ODR issues across the C ABI boundary.

#pragma once

#include <cstdint>
#include <cstring>

namespace hbn {

inline uint64_t rotl64(uint64_t x, int r) {
  return r ? (x << r) | (x >> (64 - r)) : x;
}

inline void keccak_f(uint64_t st[25]) {
  static const uint64_t RC[24] = {
      0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
      0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
      0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
      0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
      0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
      0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
      0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
      0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};
  static const int RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10,
                              43, 25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56,
                              14};
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], d[5];
    for (int x = 0; x < 5; ++x)
      c[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
    for (int x = 0; x < 5; ++x) {
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
      for (int y = 0; y < 5; ++y) st[x + 5 * y] ^= d[x];
    }
    uint64_t b[25];
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(st[x + 5 * y], RHO[x + 5 * y]);
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        st[x + 5 * y] =
            b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    st[0] ^= RC[round];
  }
}

const size_t SHA3_RATE = 136;  // SHA3-256

inline void sha3_256(const uint8_t* in, size_t len, uint8_t* out32) {
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  uint8_t block[SHA3_RATE];
  while (len >= SHA3_RATE) {
    for (size_t i = 0; i < SHA3_RATE / 8; ++i) {
      uint64_t w;
      std::memcpy(&w, in + 8 * i, 8);
      st[i] ^= w;  // little-endian host assumed (x86-64 / aarch64)
    }
    keccak_f(st);
    in += SHA3_RATE;
    len -= SHA3_RATE;
  }
  std::memset(block, 0, SHA3_RATE);
  std::memcpy(block, in, len);
  block[len] = 0x06;
  block[SHA3_RATE - 1] ^= 0x80;
  for (size_t i = 0; i < SHA3_RATE / 8; ++i) {
    uint64_t w;
    std::memcpy(&w, block + 8 * i, 8);
    st[i] ^= w;
  }
  keccak_f(st);
  std::memcpy(out32, st, 32);
}

// Incremental SHA3 for multi-part inputs (avoids concatenation copies).
struct Sha3 {
  uint64_t st[25];
  uint8_t buf[SHA3_RATE];
  size_t fill = 0;
  Sha3() { std::memset(st, 0, sizeof(st)); }
  void update(const uint8_t* in, size_t len) {
    while (len) {
      size_t take = SHA3_RATE - fill;
      if (take > len) take = len;
      std::memcpy(buf + fill, in, take);
      fill += take;
      in += take;
      len -= take;
      if (fill == SHA3_RATE) {
        for (size_t i = 0; i < SHA3_RATE / 8; ++i) {
          uint64_t w;
          std::memcpy(&w, buf + 8 * i, 8);
          st[i] ^= w;
        }
        keccak_f(st);
        fill = 0;
      }
    }
  }
  void final(uint8_t* out32) {
    std::memset(buf + fill, 0, SHA3_RATE - fill);
    buf[fill] = 0x06;
    buf[SHA3_RATE - 1] ^= 0x80;
    for (size_t i = 0; i < SHA3_RATE / 8; ++i) {
      uint64_t w;
      std::memcpy(&w, buf + 8 * i, 8);
      st[i] ^= w;
    }
    keccak_f(st);
    std::memcpy(out32, st, 32);
  }
};

// -- GF(256), poly 0x11d, generator 2 ---------------------------------------

struct GfTables {
  uint8_t exp[512];
  int log[256];
  uint8_t mul[256 * 256];
  GfTables() {
    int x = 1;
    for (int i = 0; i < 255; ++i) {
      exp[i] = static_cast<uint8_t>(x);
      log[x] = i;
      x <<= 1;
      if (x & 0x100) x ^= 0x11d;
    }
    for (int i = 255; i < 510; ++i) exp[i] = exp[i - 255];
    exp[510] = exp[511] = 0;
    log[0] = 0;
    for (int a = 0; a < 256; ++a)
      for (int b = 0; b < 256; ++b)
        mul[a * 256 + b] = (a && b) ? exp[log[a] + log[b]] : 0;
  }
};

inline const GfTables& gf() {
  static const GfTables tables;
  return tables;
}

inline uint8_t gf_mul(uint8_t a, uint8_t b) { return gf().mul[a * 256 + b]; }
inline uint8_t gf_inv(uint8_t a) { return gf().exp[255 - gf().log[a]]; }

// out[r][c] ^= sum over i of a[r][i]*b[i][c]  (dims m x k @ k x n)
inline void gf_matmul(const uint8_t* a, const uint8_t* b, uint8_t* out,
                      size_t m, size_t k, size_t n) {
  if (!m || !n) return;  // empty shards: memset/memcpy on a null
                         // vector data() is UB even at size 0
  std::memset(out, 0, m * n);
  for (size_t r = 0; r < m; ++r) {
    for (size_t i = 0; i < k; ++i) {
      uint8_t coef = a[r * k + i];
      if (!coef) continue;
      const uint8_t* row = b + i * n;
      const uint8_t* tab = gf().mul + static_cast<size_t>(coef) * 256;
      uint8_t* dst = out + r * n;
      for (size_t c = 0; c < n; ++c) dst[c] ^= tab[row[c]];
    }
  }
}

// Gauss-Jordan inverse over GF(256); false if singular.  Needs <vector>.
template <typename Vec>
inline bool gf_mat_inv_t(const uint8_t* m_in, uint8_t* inv_out, size_t n) {
  Vec a(m_in, m_in + n * n);
  Vec inv(n * n, 0);
  for (size_t i = 0; i < n; ++i) inv[i * n + i] = 1;
  for (size_t col = 0; col < n; ++col) {
    size_t pivot = col;
    while (pivot < n && !a[pivot * n + col]) ++pivot;
    if (pivot == n) return false;
    if (pivot != col) {
      for (size_t j = 0; j < n; ++j) {
        uint8_t t = a[col * n + j];
        a[col * n + j] = a[pivot * n + j];
        a[pivot * n + j] = t;
        t = inv[col * n + j];
        inv[col * n + j] = inv[pivot * n + j];
        inv[pivot * n + j] = t;
      }
    }
    uint8_t pinv = gf_inv(a[col * n + col]);
    for (size_t j = 0; j < n; ++j) {
      a[col * n + j] = gf_mul(a[col * n + j], pinv);
      inv[col * n + j] = gf_mul(inv[col * n + j], pinv);
    }
    for (size_t r = 0; r < n; ++r) {
      uint8_t f = a[r * n + col];
      if (r == col || !f) continue;
      for (size_t j = 0; j < n; ++j) {
        a[r * n + j] ^= gf_mul(a[col * n + j], f);
        inv[r * n + j] ^= gf_mul(inv[col * n + j], f);
      }
    }
  }
  std::memcpy(inv_out, inv.data(), n * n);
  return true;
}

// Systematic n x k encoding matrix (gf256.encoding_matrix semantics).
// GF(256) Vandermonde points exp[i] are distinct only for n <= 255 —
// callers MUST use the GF(2^16) codec below past that.
template <typename Vec>
inline bool encoding_matrix_t(size_t k, size_t n, Vec& out) {
  if (n > 255) return false;
  Vec vand(n * k);
  for (size_t i = 0; i < n; ++i)
    for (size_t j = 0; j < k; ++j) vand[i * k + j] = gf().exp[(i * j) % 255];
  Vec top_inv(k * k);
  if (!gf_mat_inv_t<Vec>(vand.data(), top_inv.data(), k)) return false;
  out.assign(n * k, 0);
  gf_matmul(vand.data(), top_inv.data(), out.data(), n, k, k);
  return true;
}

// -- GF(2^16), poly 0x1100B, generator 2 ------------------------------------
//
// The large-validator-set RBC codec: GF(256) runs out of distinct
// Vandermonde evaluation points at 255 shards, so networks with more
// than 255 validators erasure-code over GF(2^16) (65535 points).
// Symbols are TWO bytes, big-endian on the wire (matches the numpy
// '>u2' view in ops/gf256.py); shard lengths must be even.

struct Gf16Tables {
  std::vector<uint16_t> exp;  // 2*65535 (wraparound, no mod in mul)
  std::vector<int32_t> log;   // 65536
  Gf16Tables() : exp(131070, 0), log(65536, 0) {
    uint32_t x = 1;
    for (int i = 0; i < 65535; ++i) {
      exp[i] = static_cast<uint16_t>(x);
      log[x] = i;
      x <<= 1;
      if (x & 0x10000) x ^= 0x1100B;
    }
    for (int i = 0; i < 65535; ++i) exp[65535 + i] = exp[i];
  }
};

inline const Gf16Tables& gf16() {
  static const Gf16Tables tables;
  return tables;
}

inline uint16_t gf16_mul(uint16_t a, uint16_t b) {
  if (!a || !b) return 0;
  const Gf16Tables& t = gf16();
  return t.exp[t.log[a] + t.log[b]];
}

inline uint16_t gf16_inv(uint16_t a) {
  const Gf16Tables& t = gf16();
  return t.exp[65535 - t.log[a]];
}

// out = a @ b over GF(2^16); dims m x k @ k x n, u16 symbol arrays.
inline void gf16_matmul(const uint16_t* a, const uint16_t* b, uint16_t* out,
                        size_t m, size_t k, size_t n) {
  const Gf16Tables& t = gf16();
  std::memset(out, 0, m * n * 2);
  for (size_t r = 0; r < m; ++r) {
    for (size_t i = 0; i < k; ++i) {
      uint16_t coef = a[r * k + i];
      if (!coef) continue;
      int32_t lc = t.log[coef];
      const uint16_t* row = b + i * n;
      uint16_t* dst = out + r * n;
      for (size_t c = 0; c < n; ++c)
        if (row[c]) dst[c] ^= t.exp[lc + t.log[row[c]]];
    }
  }
}

template <typename Vec16>
inline bool gf16_mat_inv_t(const uint16_t* m_in, uint16_t* inv_out, size_t n) {
  Vec16 a(m_in, m_in + n * n);
  Vec16 inv(n * n, 0);
  for (size_t i = 0; i < n; ++i) inv[i * n + i] = 1;
  for (size_t col = 0; col < n; ++col) {
    size_t pivot = col;
    while (pivot < n && !a[pivot * n + col]) ++pivot;
    if (pivot == n) return false;
    if (pivot != col) {
      for (size_t j = 0; j < n; ++j) {
        std::swap(a[col * n + j], a[pivot * n + j]);
        std::swap(inv[col * n + j], inv[pivot * n + j]);
      }
    }
    uint16_t pinv = gf16_inv(a[col * n + col]);
    for (size_t j = 0; j < n; ++j) {
      a[col * n + j] = gf16_mul(a[col * n + j], pinv);
      inv[col * n + j] = gf16_mul(inv[col * n + j], pinv);
    }
    for (size_t r = 0; r < n; ++r) {
      uint16_t f = a[r * n + col];
      if (r == col || !f) continue;
      for (size_t j = 0; j < n; ++j) {
        a[r * n + j] ^= gf16_mul(a[col * n + j], f);
        inv[r * n + j] ^= gf16_mul(inv[col * n + j], f);
      }
    }
  }
  std::memcpy(inv_out, inv.data(), n * n * 2);
  return true;
}

// Systematic n x k encoding matrix over GF(2^16) (points exp16[i],
// distinct for n <= 65535).
template <typename Vec16>
inline bool encoding_matrix16_t(size_t k, size_t n, Vec16& out) {
  if (n > 65535) return false;
  const Gf16Tables& t = gf16();
  Vec16 vand(n * k);
  for (size_t i = 0; i < n; ++i)
    for (size_t j = 0; j < k; ++j)
      vand[i * k + j] = t.exp[(i * j) % 65535];
  Vec16 top_inv(k * k);
  if (!gf16_mat_inv_t<Vec16>(vand.data(), top_inv.data(), k)) return false;
  out.assign(n * k, 0);
  gf16_matmul(vand.data(), top_inv.data(), out.data(), n, k, k);
  return true;
}

// Big-endian byte <-> u16 symbol conversion (wire format).
inline void bytes_to_sym16(const uint8_t* in, size_t n_sym, uint16_t* out) {
  for (size_t i = 0; i < n_sym; ++i)
    out[i] = (uint16_t)((in[2 * i] << 8) | in[2 * i + 1]);
}

inline void sym16_to_bytes(const uint16_t* in, size_t n_sym, uint8_t* out) {
  for (size_t i = 0; i < n_sym; ++i) {
    out[2 * i] = (uint8_t)(in[i] >> 8);
    out[2 * i + 1] = (uint8_t)(in[i] & 0xFF);
  }
}

}  // namespace hbn
