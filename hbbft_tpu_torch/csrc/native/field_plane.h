// Copy of native/field_plane.h for the PyTorch port (hbbft_tpu_torch), built by
// hbbft_tpu_torch/build.py.  Its edits, each listed here; the copy-drift
// test (tests/test_torch_native_copy.py) holds the copy to its original
// with these edits and no other:
//   1. Every name that began HBBFT_TPU and an underscore begins HBBFT_TORCH_
//      instead: the environment knobs and the comments that name them.
//   2. The reference's numbered work-item tags are taken out of comments.
// ---- end of the port's header ----
// Vectorized field-arithmetic plane for the scalar-suite engine
// batched Montgomery arithmetic mod r (the BLS12-381 scalar
// field order) with an AVX-512 IFMA 8-lane arm and a portable 4x64
// scalar arm behind ONE runtime dispatch point.
//
// Layering:
//   * hbf:: scalar core — 4x64-word helpers (add/sub/cmp, 2^256-radix
//     Montgomery REDC, mont_mul/to_mont/from_mont/mont_inv).  These are
//     DETERMINISTIC (never dispatched); engine code uses them to keep
//     loops in the Montgomery domain and convert once at boundaries —
//     the structural fix for the old store-canonical/double-REDC cost.
//   * hbf:: batch kernels — mul_batch / dot_batch / lagrange_dens /
//     rlc_accum.  Each dispatches to the IFMA arm (native/field_ifma.cpp,
//     52-bit-limb 8-lane structure-of-arrays over _mm512_madd52{lo,hi})
//     when compiled in AND the CPU advertises AVX512IFMA AND
//     HBBFT_TORCH_SIMD != 0; the scalar arm otherwise.
//
// THE DISPATCH-IDENTITY CONTRACT (docs/INVARIANTS.md): every batch
// kernel's boundary semantics are R-FREE — canonical values (or exact
// integers for rlc_accum) in and out, never Montgomery residues.  The
// two arms use different Montgomery radices internally (2^256 scalar,
// 2^260 IFMA), so a residue crossing the dispatch boundary would be
// arm-dependent; full products/sums mod r are arm-independent EXACT
// values.  Protocol outputs are therefore byte-identical across
// HBBFT_TORCH_SIMD=0/1 by construction, and the equivalence suites pin it.
//
// Operand domains: unless stated otherwise, inputs are < 2^256 with at
// least one operand of every multiplied pair CANONICAL (< r) — the same
// precondition the engine's classic mulmod always had (wire-sourced
// shares may be >= r; the values they meet are canonical).  Outputs are
// canonical.

#ifndef HBBFT_FIELD_PLANE_H
#define HBBFT_FIELD_PLANE_H

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

// IFMA arm entry points (native/field_ifma.cpp — always linked; compiled
// as stubs when the toolchain lacks -mavx512ifma, in which case
// hbf_ifma_compiled() is 0 and the dispatch never reaches them).
extern "C" {
int32_t hbf_ifma_compiled();
int32_t hbf_ifma_cpu_ok();
void hbf_ifma_mul_batch(const uint64_t* a, const uint64_t* b, uint64_t* out,
                        size_t n);
void hbf_ifma_dot_acc(const uint64_t* a, const uint64_t* b, size_t n,
                      uint64_t acc8[8], size_t* done);
void hbf_ifma_lagrange_dens(const int64_t* xs, size_t k, uint64_t* dens);
void hbf_ifma_rlc_accum(const uint64_t* x, const uint64_t* coeffs, size_t n,
                        uint64_t acc8[8]);
}

namespace hbf {

// --------------------------------------------------------------------------
// Constants (r = BLS12-381 scalar field order)
// --------------------------------------------------------------------------

// r = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
inline const uint64_t R4[4] = {0xFFFFFFFF00000001ULL, 0x53BDA402FFFE5BFEULL,
                               0x3339D80809A1D805ULL, 0x73EDA753299D7D48ULL};
// -(r^-1) mod 2^64
inline const uint64_t NP64 = 0xFFFFFFFEFFFFFFFFULL;
// 2^512 mod r (to_mont multiplier for the 2^256 radix)
inline const uint64_t R2_256[4] = {0xC999E990F3F29C6DULL, 0x2B6CEDCB87925C23ULL,
                                   0x05D314967254398FULL, 0x0748D9D99F59FF11ULL};
// 2^256 mod r (Montgomery one for the 2^256 radix)
inline const uint64_t ONE_M256[4] = {0x00000001FFFFFFFEULL,
                                     0x5884B7FA00034802ULL,
                                     0x998C4FEFECBC4FF5ULL,
                                     0x1824B159ACC5056FULL};
// 2^260 mod r (the IFMA radix; used to lift IFMA-reduced partial sums
// back to plain values on the scalar side of the boundary)
inline const uint64_t TWO260[4] = {0x00000022FFFFFFDDULL, 0x8D12939700396C23ULL,
                                   0xFF1776E6AEDF7745ULL, 0x26821FA14F77DF20ULL};

// --------------------------------------------------------------------------
// 4x64 scalar core (little-endian words)
// --------------------------------------------------------------------------

inline int cmp4(const uint64_t a[4], const uint64_t b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}

inline bool is_zero4(const uint64_t a[4]) {
  return (a[0] | a[1] | a[2] | a[3]) == 0;
}

// a + b with carry out (no reduction); out may alias a or b.
inline uint64_t add4_raw(const uint64_t a[4], const uint64_t b[4],
                         uint64_t out[4]) {
  unsigned __int128 c = 0;
  for (int i = 0; i < 4; ++i) {
    c += (unsigned __int128)a[i] + b[i];
    out[i] = (uint64_t)c;
    c >>= 64;
  }
  return (uint64_t)c;
}

// a - b with borrow out; out may alias.
inline uint64_t sub4_raw(const uint64_t a[4], const uint64_t b[4],
                         uint64_t out[4]) {
  unsigned __int128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    unsigned __int128 d = (unsigned __int128)a[i] - b[i] - (uint64_t)borrow;
    out[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  return (uint64_t)borrow;
}

inline void addmod4(const uint64_t a[4], const uint64_t b[4], uint64_t out[4]) {
  uint64_t s[4], t[4];
  uint64_t carry = add4_raw(a, b, s);
  uint64_t borrow = sub4_raw(s, R4, t);
  if (carry || !borrow)
    std::memcpy(out, t, sizeof(t));
  else
    std::memcpy(out, s, sizeof(s));
}

inline void submod4(const uint64_t a[4], const uint64_t b[4], uint64_t out[4]) {
  uint64_t d[4];
  if (sub4_raw(a, b, d)) add4_raw(d, R4, d);
  std::memcpy(out, d, sizeof(d));
}

inline void mul4_raw(const uint64_t a[4], const uint64_t b[4],
                     uint64_t out[8]) {
  std::memset(out, 0, 8 * sizeof(uint64_t));
  for (int i = 0; i < 4; ++i) {
    unsigned __int128 c = 0;
    for (int j = 0; j < 4; ++j) {
      c += (unsigned __int128)a[i] * b[j] + out[i + j];
      out[i + j] = (uint64_t)c;
      c >>= 64;
    }
    out[i + 4] = (uint64_t)c;
  }
}

// REDC: given T (8 words, T < r * 2^256), returns T * 2^-256 mod r,
// canonical.
inline void redc256(const uint64_t t_in[8], uint64_t out[4]) {
  uint64_t t[9];
  std::memcpy(t, t_in, 8 * sizeof(uint64_t));
  t[8] = 0;
  for (int i = 0; i < 4; ++i) {
    uint64_t m = t[i] * NP64;
    unsigned __int128 c = 0;
    for (int j = 0; j < 4; ++j) {
      c += (unsigned __int128)m * R4[j] + t[i + j];
      t[i + j] = (uint64_t)c;
      c >>= 64;
    }
    for (int j = i + 4; j < 9 && c; ++j) {
      c += t[j];
      t[j] = (uint64_t)c;
      c >>= 64;
    }
  }
  uint64_t res[4] = {t[4], t[5], t[6], t[7]};
  if (t[8] || cmp4(res, R4) >= 0) sub4_raw(res, R4, res);
  std::memcpy(out, res, sizeof(res));
}

// Montgomery product a * b * 2^-256 mod r (canonical out).  Valid when
// a * b < r * 2^256 — i.e. at least one side canonical, the other
// < 2^256.  One REDC pass: the building block that keeps loops in the
// Montgomery domain (the classic mulmod pays two).
inline void mont_mul4(const uint64_t a[4], const uint64_t b[4],
                      uint64_t out[4]) {
  uint64_t t[8];
  mul4_raw(a, b, t);
  redc256(t, out);
}

// a -> a * 2^256 mod r (enter the 2^256 Montgomery domain)
inline void to_mont4(const uint64_t a[4], uint64_t out[4]) {
  mont_mul4(a, R2_256, out);
}

// a -> a * 2^-256 mod r (leave the domain; also the exact map from a
// mont residue back to its plain value)
inline void from_mont4(const uint64_t a[4], uint64_t out[4]) {
  uint64_t t[8] = {a[0], a[1], a[2], a[3], 0, 0, 0, 0};
  redc256(t, out);
}

// Classic full product a * b mod r (two REDC passes) — for one-shot
// call sites; batch loops should stay in the Montgomery domain instead.
inline void mulmod4(const uint64_t a[4], const uint64_t b[4], uint64_t out[4]) {
  uint64_t m[4];
  mont_mul4(a, b, m);
  mont_mul4(m, R2_256, out);
}

// a^(r-2) in the Montgomery domain: in/out are mont residues (the
// domain is a ring isomorphic via x -> x*2^256, so the Fermat ladder
// carries over verbatim with mont_mul as the product).
inline void mont_inv4(const uint64_t a_m[4], uint64_t out_m[4]) {
  uint64_t e[4];
  std::memcpy(e, R4, sizeof(e));
  e[0] -= 2;  // r - 2 (no borrow: r[0] ends ...0001)
  uint64_t result[4], base[4];
  std::memcpy(result, ONE_M256, sizeof(result));
  std::memcpy(base, a_m, sizeof(base));
  for (int i = 0; i < 255; ++i) {
    if ((e[i / 64] >> (i % 64)) & 1) mont_mul4(result, base, result);
    mont_mul4(base, base, base);
  }
  std::memcpy(out_m, result, sizeof(result));
}

// base^e mod r for a small exponent (square-and-multiply over classic
// mulmod; e <= 2^20 in practice — the per-kernel-call R-power fixups).
inline void pow_small4(const uint64_t base[4], uint64_t e, uint64_t out[4]) {
  uint64_t acc[4] = {1, 0, 0, 0};
  uint64_t b[4];
  std::memcpy(b, base, sizeof(b));
  while (e) {
    if (e & 1) mulmod4(acc, b, acc);
    e >>= 1;
    if (e) mulmod4(b, b, b);
  }
  std::memcpy(out, acc, sizeof(acc));
}

// --------------------------------------------------------------------------
// Dispatch
// --------------------------------------------------------------------------

// -1 = auto (HBBFT_TORCH_SIMD env, default on), 0 = force scalar,
// 1 = force IFMA (clamped to availability).
inline std::atomic<int32_t>& simd_force_cell() {
  static std::atomic<int32_t> cell{-1};
  return cell;
}

inline int32_t simd_available() {
  static const int32_t avail =
      (hbf_ifma_compiled() && hbf_ifma_cpu_ok()) ? 1 : 0;
  return avail;
}

// Resolved dispatch mode for this call: 1 = IFMA, 0 = scalar.
inline int32_t simd_mode() {
  int32_t f = simd_force_cell().load(std::memory_order_relaxed);
  if (f == 0) return 0;
  if (f == 1) return simd_available();
  static const int32_t env_on = [] {
    const char* s = std::getenv("HBBFT_TORCH_SIMD");
    return (s && s[0] == '0' && !s[1]) ? 0 : 1;
  }();
  return env_on ? simd_available() : 0;
}

inline int32_t simd_force(int32_t mode) {
  simd_force_cell().store(mode < 0 ? -1 : (mode ? 1 : 0),
                          std::memory_order_relaxed);
  return simd_mode();
}

// --------------------------------------------------------------------------
// Batch kernels (R-free boundaries; see the dispatch-identity contract)
// --------------------------------------------------------------------------

// out[i] = a[i] * b[i] mod r (elementwise; arrays of n 4-word values).
// Precondition per pair: at least one side canonical.
inline void mul_batch(const uint64_t* a, const uint64_t* b, uint64_t* out,
                      size_t n) {
  size_t i = 0;
  if (simd_mode() && n >= 8) {
    size_t main = n & ~(size_t)7;
    hbf_ifma_mul_batch(a, b, out, main);
    i = main;
  }
  for (; i < n; ++i) mulmod4(a + 4 * i, b + 4 * i, out + 4 * i);
}

// out = sum_i a[i] * b[i] mod r.  The scalar arm accumulates one-REDC
// Montgomery products (sum of a*b*2^-256 terms, linear in the shared
// R-factor) and converts ONCE; the IFMA arm accumulates a*b*2^-260
// terms and lifts by 2^260 once.  Both yield the exact canonical sum.
inline void dot_batch(const uint64_t* a, const uint64_t* b, size_t n,
                      uint64_t out[4]) {
  uint64_t s[4] = {0, 0, 0, 0};
  size_t i = 0;
  if (simd_mode() && n >= 8) {
    uint64_t acc8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    size_t done = 0;
    hbf_ifma_dot_acc(a, b, n, acc8, &done);
    // acc8 = exact integer sum of the 8-lane Montgomery products
    // (== (sum_{i<done} a_i*b_i) * 2^-260 mod r, unreduced): reduce,
    // then lift the 2^-260.
    uint64_t red[4];
    uint64_t m[4];
    redc256(acc8, m);  // * 2^-256
    uint64_t t[8];
    mul4_raw(m, R2_256, t);
    redc256(t, red);  // exact value of acc8 mod r
    mulmod4(red, TWO260, s);
    i = done;
  }
  if (i < n) {
    // Scalar (sub)sum in the 2^-256-deficit domain, lifted once.
    uint64_t t[4] = {0, 0, 0, 0};
    for (; i < n; ++i) {
      uint64_t p[4];
      mont_mul4(a + 4 * i, b + 4 * i, p);  // a*b*2^-256
      addmod4(t, p, t);
    }
    to_mont4(t, t);  // * 2^256: the exact canonical partial sum
    addmod4(s, t, s);
  }
  std::memcpy(out, s, 4 * sizeof(uint64_t));
}

// dens[i] = prod_{j != i} (x_j - x_i) mod r for i in [0, k); xs are
// positive evaluation points < 2^31 (Lagrange denominators — the
// O(k^2) half of every coefficient computation).  A zero output marks
// a duplicate point (callers treat it as their existing fall-back /
// invalid-input condition).
inline void lagrange_dens(const int64_t* xs, size_t k, uint64_t* dens) {
  if (simd_mode() && k >= 8) {
    hbf_ifma_lagrange_dens(xs, k, dens);
    return;
  }
  // Scalar arm: Montgomery-domain chains with a single R-power fixup
  // (k-1 one-REDC muls per point instead of k-1 classic two-REDC
  // mulmods).  acc starts at ONE_M256 (= R); after m = k-1 products of
  // canonical factors it holds prod * R^(2-k); multiplying by
  // R^(k-1) through one more mont_mul restores the canonical product.
  uint64_t fix[4];
  pow_small4(ONE_M256, k >= 1 ? k - 1 : 0, fix);
  for (size_t i = 0; i < k; ++i) {
    uint64_t acc[4];
    std::memcpy(acc, ONE_M256, sizeof(acc));
    uint64_t xi[4] = {(uint64_t)xs[i], 0, 0, 0};
    for (size_t j = 0; j < k; ++j) {
      if (j == i) continue;
      uint64_t xj[4] = {(uint64_t)xs[j], 0, 0, 0};
      uint64_t f[4];
      submod4(xj, xi, f);
      mont_mul4(acc, f, acc);
    }
    mont_mul4(acc, fix, dens + 4 * i);
  }
}

// acc8 += sum_i coeffs[i] * x[i] as an EXACT 512-bit integer (the RLC
// accumulate: coeffs are 64-bit, x are 4-word values; n * 2^320 fits 8
// words for any feasible n).  Identical to the per-item schoolbook
// accumulate in either arm — the sum is an integer, not a residue.
inline void rlc_accum(const uint64_t* x, const uint64_t* coeffs, size_t n,
                      uint64_t acc8[8]) {
  size_t i = 0;
  if (simd_mode() && n >= 8) {
    size_t main = n & ~(size_t)7;
    hbf_ifma_rlc_accum(x, coeffs, main, acc8);
    i = main;
  }
  for (; i < n; ++i) {
    const uint64_t* a = x + 4 * i;
    uint64_t r = coeffs[i];
    unsigned __int128 c = 0;
    for (int w = 0; w < 4; ++w) {
      c += (unsigned __int128)a[w] * r + acc8[w];
      acc8[w] = (uint64_t)c;
      c >>= 64;
    }
    for (int w = 4; w < 8 && c; ++w) {
      c += acc8[w];
      acc8[w] = (uint64_t)c;
      c >>= 64;
    }
  }
}

}  // namespace hbf

#endif  // HBBFT_FIELD_PLANE_H
