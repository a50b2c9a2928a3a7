// Copy of native/field_ifma.cpp for the PyTorch port (hbbft_tpu_torch), built by
// hbbft_tpu_torch/build.py.  Its edits, each listed here; the copy-drift
// test (tests/test_torch_native_copy.py) holds the copy to its original
// with these edits and no other:
//   1. Every name that began HBBFT_TPU and an underscore begins HBBFT_TORCH_
//      instead: the environment knobs and the comments that name them.
//   2. The reference's numbered work-item tags are taken out of comments.
// ---- end of the port's header ----
// AVX-512 IFMA arm of the field-arithmetic plane (native/field_plane.h).
//
// This translation unit is the ONLY code compiled with -mavx512ifma
// (feature-gated in native/Makefile and hbbft_tpu/ops/native.py: the
// flag is dropped if the toolchain rejects it, and the #else branch
// below compiles stubs).  The runtime-dispatch guarantee that a
// non-IFMA host never executes vector code rests on two rules:
//
//  1. hbf::simd_mode() (field_plane.h) only routes here when
//     hbf_ifma_compiled() AND hbf_ifma_cpu_ok() both hold — every other
//     function in this file runs exclusively behind that gate, so the
//     compiler is free to use EVB/EVEX encodings anywhere in them.
//  2. This file includes NO shared inline code (not even field_plane.h):
//     a COMDAT-inline function compiled here under -mavx512ifma could
//     win linker resolution over the copy engine.cpp instantiated and
//     smuggle AVX-512 into unconditionally-executed paths.  The few
//     4x64 scalar helpers the fixup constants need are duplicated as
//     static locals instead.
//
// Kernel math: 8-lane structure-of-arrays over 52-bit limbs (5 limbs =
// 260 bits), Montgomery radix 2^260, CIOS reduction with
// _mm512_madd52{lo,hi}_epu64, lazy reduction (values < 2r between
// multiplies, strict-52 limbs re-normalized after every multiply so the
// madd52 low-52 masking stays exact).  Boundary semantics are R-free
// (field_plane.h dispatch-identity contract): canonical values or exact
// integers in and out, so results are bit-identical to the scalar arm.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" int32_t hbf_ifma_cpu_ok() {
#if defined(__x86_64__) || defined(__i386__)
  return (__builtin_cpu_supports("avx512ifma") &&
          __builtin_cpu_supports("avx512f"))
             ? 1
             : 0;
#else
  return 0;
#endif
}

#if defined(__AVX512IFMA__) && defined(__AVX512F__)

#include <immintrin.h>

extern "C" int32_t hbf_ifma_compiled() { return 1; }

namespace {

const uint64_t M52 = (1ULL << 52) - 1;
// -(r^-1) mod 2^52
const uint64_t NP52 = 0xFFFFEFFFFFFFFULL;
// r in 52-bit limbs (little-endian)
const uint64_t R52[5] = {0xFFFFF00000001ULL, 0x02FFFE5BFEFFFULL,
                         0x9A1D80553BDA4ULL, 0x7D483339D8080ULL,
                         0x073EDA753299DULL};
// 2^260 mod r (Montgomery one for this radix), 52-bit limbs
const uint64_t ONEM260_52[5] = {0x00022FFFFFFDDULL, 0x9700396C23000ULL,
                                0xEDF77458D1293ULL, 0xDF20FF1776E6AULL,
                                0x026821FA14F77ULL};
// 2^520 mod r (to-Montgomery multiplier for this radix), 52-bit limbs
const uint64_t R2_260_52[5] = {0x99103F29C6CF0ULL, 0x57927663D999EULL,
                               0xA1C0ED631138BULL, 0x3C829F7715F1BULL,
                               0x009FF646CC027ULL};
// r and 2^260 mod r in 64-bit words (for the scalar fixup-power helper)
const uint64_t R64[4] = {0xFFFFFFFF00000001ULL, 0x53BDA402FFFE5BFEULL,
                         0x3339D80809A1D805ULL, 0x73EDA753299D7D48ULL};
const uint64_t NP64 = 0xFFFFFFFEFFFFFFFFULL;
const uint64_t TWO260_64[4] = {0x00000022FFFFFFDDULL, 0x8D12939700396C23ULL,
                               0xFF1776E6AEDF7745ULL, 0x26821FA14F77DF20ULL};

// ---- minimal local 4x64 scalar helpers (fixup powers + canonical
// subtract; duplicated from field_plane.h on purpose — see the header
// comment on COMDAT contamination) --------------------------------------

int s_cmp4(const uint64_t a[4], const uint64_t b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}

void s_sub4(const uint64_t a[4], const uint64_t b[4], uint64_t out[4]) {
  unsigned __int128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    unsigned __int128 d = (unsigned __int128)a[i] - b[i] - (uint64_t)borrow;
    out[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

void s_mulmod4(const uint64_t a[4], const uint64_t b[4], uint64_t out[4]) {
  uint64_t t[9];
  auto redc = [&](uint64_t res[4]) {
    for (int i = 0; i < 4; ++i) {
      uint64_t m = t[i] * NP64;
      unsigned __int128 c = 0;
      for (int j = 0; j < 4; ++j) {
        c += (unsigned __int128)m * R64[j] + t[i + j];
        t[i + j] = (uint64_t)c;
        c >>= 64;
      }
      for (int j = i + 4; j < 9 && c; ++j) {
        c += t[j];
        t[j] = (uint64_t)c;
        c >>= 64;
      }
    }
    uint64_t r4[4] = {t[4], t[5], t[6], t[7]};
    if (t[8] || s_cmp4(r4, R64) >= 0) s_sub4(r4, R64, r4);
    std::memcpy(res, r4, sizeof(r4));
  };
  auto mul = [&](const uint64_t x[4], const uint64_t y[4]) {
    std::memset(t, 0, sizeof(t));
    for (int i = 0; i < 4; ++i) {
      unsigned __int128 c = 0;
      for (int j = 0; j < 4; ++j) {
        c += (unsigned __int128)x[i] * y[j] + t[i + j];
        t[i + j] = (uint64_t)c;
        c >>= 64;
      }
      t[i + 4] = (uint64_t)c;
    }
  };
  // classic two-pass mulmod (a*b*2^-256, then *2^512*2^-256)
  const uint64_t R2_256[4] = {0xC999E990F3F29C6DULL, 0x2B6CEDCB87925C23ULL,
                              0x05D314967254398FULL, 0x0748D9D99F59FF11ULL};
  uint64_t m4[4];
  mul(a, b);
  redc(m4);
  mul(m4, R2_256);
  redc(out);
}

// (2^260)^e mod r for small e (the per-call R-power fixups)
void s_pow260(uint64_t e, uint64_t out[4]) {
  uint64_t acc[4] = {1, 0, 0, 0};
  uint64_t b[4];
  std::memcpy(b, TWO260_64, sizeof(b));
  while (e) {
    if (e & 1) s_mulmod4(acc, b, acc);
    e >>= 1;
    if (e) s_mulmod4(b, b, b);
  }
  std::memcpy(out, acc, sizeof(acc));
}

void limbs52_of(const uint64_t w[4], uint64_t l[5]) {
  l[0] = w[0] & M52;
  l[1] = ((w[0] >> 52) | (w[1] << 12)) & M52;
  l[2] = ((w[1] >> 40) | (w[2] << 24)) & M52;
  l[3] = ((w[2] >> 28) | (w[3] << 36)) & M52;
  l[4] = w[3] >> 16;
}

// ---- 8-lane SoA core ---------------------------------------------------

struct Fe8 {
  __m512i l[5];
};

inline __m512i vm52() { return _mm512_set1_epi64((long long)M52); }

inline Fe8 bcast(const uint64_t limbs[5]) {
  Fe8 o;
  for (int i = 0; i < 5; ++i) o.l[i] = _mm512_set1_epi64((long long)limbs[i]);
  return o;
}

inline __m512i stride4_idx() { return _mm512_setr_epi64(0, 4, 8, 12, 16, 20, 24, 28); }

// 8 consecutive 4-word elements (AoS) -> 52-bit SoA
inline Fe8 load8(const uint64_t* aos) {
  __m512i idx = stride4_idx();
  __m512i w0 = _mm512_i64gather_epi64(idx, aos + 0, 8);
  __m512i w1 = _mm512_i64gather_epi64(idx, aos + 1, 8);
  __m512i w2 = _mm512_i64gather_epi64(idx, aos + 2, 8);
  __m512i w3 = _mm512_i64gather_epi64(idx, aos + 3, 8);
  __m512i m = vm52();
  Fe8 o;
  o.l[0] = _mm512_and_epi64(w0, m);
  o.l[1] = _mm512_and_epi64(
      _mm512_or_epi64(_mm512_srli_epi64(w0, 52), _mm512_slli_epi64(w1, 12)), m);
  o.l[2] = _mm512_and_epi64(
      _mm512_or_epi64(_mm512_srli_epi64(w1, 40), _mm512_slli_epi64(w2, 24)), m);
  o.l[3] = _mm512_and_epi64(
      _mm512_or_epi64(_mm512_srli_epi64(w2, 28), _mm512_slli_epi64(w3, 36)), m);
  o.l[4] = _mm512_srli_epi64(w3, 16);
  return o;
}

// strict-52 SoA (value < 2^256) -> 8 AoS elements
inline void store8(const Fe8& a, uint64_t* aos) {
  __m512i w0 = _mm512_or_epi64(a.l[0], _mm512_slli_epi64(a.l[1], 52));
  __m512i w1 = _mm512_or_epi64(_mm512_srli_epi64(a.l[1], 12),
                               _mm512_slli_epi64(a.l[2], 40));
  __m512i w2 = _mm512_or_epi64(_mm512_srli_epi64(a.l[2], 24),
                               _mm512_slli_epi64(a.l[3], 28));
  __m512i w3 = _mm512_or_epi64(_mm512_srli_epi64(a.l[3], 36),
                               _mm512_slli_epi64(a.l[4], 16));
  __m512i idx = stride4_idx();
  _mm512_i64scatter_epi64(aos + 0, idx, w0, 8);
  _mm512_i64scatter_epi64(aos + 1, idx, w1, 8);
  _mm512_i64scatter_epi64(aos + 2, idx, w2, 8);
  _mm512_i64scatter_epi64(aos + 3, idx, w3, 8);
}

// CIOS Montgomery product a*b*2^-260 per lane (AMM: output value < 2r
// when a*b < r*2^260, which all callers satisfy), normalized back to
// strict 52-bit limbs so it can feed the next multiply.
inline Fe8 mont_mul8(const Fe8& a, const Fe8& b) {
  const __m512i z = _mm512_setzero_si512();
  const __m512i np = _mm512_set1_epi64((long long)NP52);
  const __m512i r0 = _mm512_set1_epi64((long long)R52[0]);
  const __m512i r1 = _mm512_set1_epi64((long long)R52[1]);
  const __m512i r2 = _mm512_set1_epi64((long long)R52[2]);
  const __m512i r3 = _mm512_set1_epi64((long long)R52[3]);
  const __m512i r4 = _mm512_set1_epi64((long long)R52[4]);
  __m512i t0 = z, t1 = z, t2 = z, t3 = z, t4 = z, t5 = z;
  for (int i = 0; i < 5; ++i) {
    __m512i ai = a.l[i];
    t0 = _mm512_madd52lo_epu64(t0, ai, b.l[0]);
    t1 = _mm512_madd52lo_epu64(t1, ai, b.l[1]);
    t2 = _mm512_madd52lo_epu64(t2, ai, b.l[2]);
    t3 = _mm512_madd52lo_epu64(t3, ai, b.l[3]);
    t4 = _mm512_madd52lo_epu64(t4, ai, b.l[4]);
    __m512i m = _mm512_madd52lo_epu64(z, t0, np);
    t0 = _mm512_madd52lo_epu64(t0, m, r0);
    t1 = _mm512_madd52lo_epu64(t1, m, r1);
    t2 = _mm512_madd52lo_epu64(t2, m, r2);
    t3 = _mm512_madd52lo_epu64(t3, m, r3);
    t4 = _mm512_madd52lo_epu64(t4, m, r4);
    t1 = _mm512_add_epi64(t1, _mm512_srli_epi64(t0, 52));
    // shift one limb down, folding in the high halves of this round's
    // products (they belong one position up)
    t0 = _mm512_madd52hi_epu64(_mm512_madd52hi_epu64(t1, ai, b.l[0]), m, r0);
    t1 = _mm512_madd52hi_epu64(_mm512_madd52hi_epu64(t2, ai, b.l[1]), m, r1);
    t2 = _mm512_madd52hi_epu64(_mm512_madd52hi_epu64(t3, ai, b.l[2]), m, r2);
    t3 = _mm512_madd52hi_epu64(_mm512_madd52hi_epu64(t4, ai, b.l[3]), m, r3);
    t4 = _mm512_madd52hi_epu64(_mm512_madd52hi_epu64(t5, ai, b.l[4]), m, r4);
    t5 = z;
  }
  // normalize (value < 2r < 2^257, so the top limb needs no mask)
  const __m512i m52 = vm52();
  Fe8 o;
  __m512i c;
  o.l[0] = _mm512_and_epi64(t0, m52);
  c = _mm512_srli_epi64(t0, 52);
  t1 = _mm512_add_epi64(t1, c);
  o.l[1] = _mm512_and_epi64(t1, m52);
  c = _mm512_srli_epi64(t1, 52);
  t2 = _mm512_add_epi64(t2, c);
  o.l[2] = _mm512_and_epi64(t2, m52);
  c = _mm512_srli_epi64(t2, 52);
  t3 = _mm512_add_epi64(t3, c);
  o.l[3] = _mm512_and_epi64(t3, m52);
  c = _mm512_srli_epi64(t3, 52);
  o.l[4] = _mm512_add_epi64(t4, c);
  return o;
}

// conditional subtract r per lane (strict-52 input, value < 2r):
// canonical output
inline void canon8(Fe8& a) {
  const __m512i m52 = vm52();
  __m512i d[5];
  __mmask8 borrow = 0;
  for (int i = 0; i < 5; ++i) {
    __m512i ri = _mm512_set1_epi64((long long)R52[i]);
    __m512i bi = _mm512_maskz_set1_epi64(borrow, 1);
    __m512i sub = _mm512_sub_epi64(_mm512_sub_epi64(a.l[i], ri), bi);
    // borrow iff the signed result went negative (operands < 2^53)
    borrow = _mm512_cmplt_epi64_mask(sub, _mm512_setzero_si512());
    d[i] = _mm512_and_epi64(sub, m52);
  }
  // borrow out => value < r => keep a; else take d
  for (int i = 0; i < 5; ++i)
    a.l[i] = _mm512_mask_mov_epi64(d[i], borrow, a.l[i]);
}

// Fold a 7-slot redundant SoA accumulator (per-lane 52-bit-radix
// values) into an exact 8x64-word integer added into acc8.
void fold_acc(__m512i t[7], uint64_t acc8[8]) {
  // normalize per lane first so the cross-lane sums fit u64
  const __m512i m52 = vm52();
  __m512i c = _mm512_setzero_si512();
  for (int i = 0; i < 7; ++i) {
    __m512i u = _mm512_add_epi64(t[i], c);
    c = _mm512_srli_epi64(u, 52);
    t[i] = (i < 6) ? _mm512_and_epi64(u, m52) : u;
  }
  uint64_t s[7];
  for (int i = 0; i < 7; ++i) s[i] = (uint64_t)_mm512_reduce_add_epi64(t[i]);
  // 52-bit-radix digits (each < 2^56) -> 8x64 words, added into acc8
  unsigned __int128 carry = 0;
  uint64_t add8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 7; ++i) {
    size_t bit = 52u * (size_t)i;
    size_t w = bit / 64, sh = bit % 64;
    unsigned __int128 v = (unsigned __int128)s[i] << sh;
    unsigned __int128 lo = (unsigned __int128)add8[w] + (uint64_t)v;
    add8[w] = (uint64_t)lo;
    unsigned __int128 hi =
        (unsigned __int128)add8[w + 1] + (uint64_t)(v >> 64) + (uint64_t)(lo >> 64);
    add8[w + 1] = (uint64_t)hi;
    if (hi >> 64) {
      for (size_t j = w + 2; j < 8; ++j) {
        if (++add8[j]) break;
      }
    }
  }
  carry = 0;
  for (int i = 0; i < 8; ++i) {
    carry += (unsigned __int128)acc8[i] + add8[i];
    acc8[i] = (uint64_t)carry;
    carry >>= 64;
  }
}

// ---- 8-lane state-parallel Keccak-f[1600] (batched sha3 plane,
// native/sha3_plane.h) -----------------------------------------------------
//
// Eight independent FIPS-202 SHA3-256 states side by side: Keccak state
// word w of message j lives in qword lane j of st[w].  Rotations use
// vprolvq (broadcast counts — the intrinsic with an immediate count
// cannot take a table value from a loop), chi is one vpternlogq per
// word (imm 0xD2 = a ^ (~b & c)).  Round constants / rotation offsets
// are duplicated from sha3_gf.h on purpose — this unit includes no
// shared inline code (COMDAT rule, header comment).

const uint64_t KC_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};
const int KC_RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10,
                        43, 25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56,
                        14};

void keccak_f_x8(__m512i st[25]) {
  for (int round = 0; round < 24; ++round) {
    __m512i c[5], d[5];
    for (int x = 0; x < 5; ++x)
      c[x] = _mm512_xor_epi64(
          _mm512_xor_epi64(_mm512_xor_epi64(st[x], st[x + 5]),
                           _mm512_xor_epi64(st[x + 10], st[x + 15])),
          st[x + 20]);
    for (int x = 0; x < 5; ++x) {
      d[x] = _mm512_xor_epi64(c[(x + 4) % 5],
                              _mm512_rol_epi64(c[(x + 1) % 5], 1));
      for (int y = 0; y < 5; ++y)
        st[x + 5 * y] = _mm512_xor_epi64(st[x + 5 * y], d[x]);
    }
    __m512i b[25];
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = _mm512_rolv_epi64(
            st[x + 5 * y], _mm512_set1_epi64(KC_RHO[x + 5 * y]));
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        st[x + 5 * y] = _mm512_ternarylogic_epi64(
            b[x + 5 * y], b[(x + 1) % 5 + 5 * y], b[(x + 2) % 5 + 5 * y],
            0xD2);
    st[0] = _mm512_xor_epi64(st[0],
                             _mm512_set1_epi64((long long)KC_RC[round]));
  }
}

}  // namespace

extern "C" {

// out[i] = a[i]*b[i] mod r, n a multiple of 8.
void hbf_ifma_mul_batch(const uint64_t* a, const uint64_t* b, uint64_t* out,
                        size_t n) {
  Fe8 r2 = bcast(R2_260_52);
  for (size_t i = 0; i < n; i += 8) {
    Fe8 A = load8(a + 4 * i);
    Fe8 B = load8(b + 4 * i);
    Fe8 P = mont_mul8(A, B);        // a*b*2^-260
    Fe8 Q = mont_mul8(P, r2);       // a*b
    canon8(Q);
    store8(Q, out + 4 * i);
  }
}

// acc8 += exact integer sum of per-lane a[i]*b[i]*2^-260 residues over
// the largest multiple-of-8 prefix; *done reports how many elements
// were consumed (the caller lifts the 2^-260 once and handles the tail).
void hbf_ifma_dot_acc(const uint64_t* a, const uint64_t* b, size_t n,
                      uint64_t acc8[8], size_t* done) {
  __m512i t[7];
  for (int i = 0; i < 7; ++i) t[i] = _mm512_setzero_si512();
  size_t main = n & ~(size_t)7;
  size_t since_fold = 0;
  for (size_t i = 0; i < main; i += 8) {
    Fe8 A = load8(a + 4 * i);
    Fe8 B = load8(b + 4 * i);
    Fe8 P = mont_mul8(A, B);  // strict-52 limbs, value < 2r
    for (int l = 0; l < 5; ++l) t[l] = _mm512_add_epi64(t[l], P.l[l]);
    // limbs grow ~2^52 per chunk: fold well before u64 overflow
    if (++since_fold == 1024) {
      fold_acc(t, acc8);
      for (int l = 0; l < 7; ++l) t[l] = _mm512_setzero_si512();
      since_fold = 0;
    }
  }
  if (since_fold) fold_acc(t, acc8);
  *done = main;
}

// dens[i] = prod_{j != i} (x_j - x_i) mod r (canonical), xs positive.
void hbf_ifma_lagrange_dens(const int64_t* xs, size_t k, uint64_t* dens) {
  uint64_t fix64[4];
  s_pow260(k - 1, fix64);  // (2^260)^(k-1) mod r
  uint64_t fix52[5];
  limbs52_of(fix64, fix52);
  Fe8 FIX = bcast(fix52);
  Fe8 ONE = bcast(ONEM260_52);
  const __m512i z = _mm512_setzero_si512();
  const __m512i r0 = _mm512_set1_epi64((long long)R52[0]);
  for (size_t base = 0; base < k; base += 8) {
    alignas(64) int64_t xi[8];
    for (int l = 0; l < 8; ++l)
      xi[l] = (base + (size_t)l < k) ? xs[base + l] : 0;
    __m512i XI = _mm512_load_si512((const void*)xi);
    Fe8 acc = ONE;
    for (size_t j = 0; j < k; ++j) {
      __m512i d = _mm512_sub_epi64(_mm512_set1_epi64(xs[j]), XI);
      __mmask8 wrap = _mm512_cmple_epi64_mask(d, z);  // x_j <= x_i: + r
      Fe8 f;
      f.l[0] = _mm512_mask_add_epi64(d, wrap, d, r0);
      for (int l = 1; l < 5; ++l)
        f.l[l] = _mm512_maskz_set1_epi64(wrap, (long long)R52[l]);
      if (j >= base && j < base + 8) {
        // the i == j lane multiplies by the Montgomery one instead
        // (keeps every lane's R-deficit uniform for the single fixup)
        __mmask8 self = (__mmask8)(1u << (j - base));
        for (int l = 0; l < 5; ++l)
          f.l[l] = _mm512_mask_mov_epi64(f.l[l], self, ONE.l[l]);
      }
      acc = mont_mul8(acc, f);
    }
    acc = mont_mul8(acc, FIX);
    canon8(acc);
    size_t lanes = k - base < 8 ? k - base : 8;
    if (lanes == 8) {
      store8(acc, dens + 4 * base);
    } else {
      alignas(64) uint64_t tmp[32];
      store8(acc, tmp);
      std::memcpy(dens + 4 * base, tmp, lanes * 4 * sizeof(uint64_t));
    }
  }
}

// acc8 += sum_i coeffs[i]*x[i] (exact integer), n a multiple of 8.
void hbf_ifma_rlc_accum(const uint64_t* x, const uint64_t* coeffs, size_t n,
                        uint64_t acc8[8]) {
  __m512i t[7];
  for (int i = 0; i < 7; ++i) t[i] = _mm512_setzero_si512();
  const __m512i m52 = vm52();
  size_t since_fold = 0;
  for (size_t i = 0; i < n; i += 8) {
    Fe8 A = load8(x + 4 * i);
    __m512i C = _mm512_loadu_si512((const void*)(coeffs + i));
    __m512i clo = _mm512_and_epi64(C, m52);
    __m512i chi = _mm512_srli_epi64(C, 52);
    for (int l = 0; l < 5; ++l) {
      t[l] = _mm512_madd52lo_epu64(t[l], clo, A.l[l]);
      t[l + 1] = _mm512_madd52hi_epu64(t[l + 1], clo, A.l[l]);
      t[l + 1] = _mm512_madd52lo_epu64(t[l + 1], chi, A.l[l]);
      t[l + 2] = _mm512_madd52hi_epu64(t[l + 2], chi, A.l[l]);
    }
    if (++since_fold == 512) {
      fold_acc(t, acc8);
      for (int l = 0; l < 7; ++l) t[l] = _mm512_setzero_si512();
      since_fold = 0;
    }
  }
  if (since_fold) fold_acc(t, acc8);
}

// SHA3-256 of 8 equal-length messages (contiguous, stride msg_len);
// digests contiguous (32 bytes each) at out.  Full rate blocks are
// absorbed by qword gathers straight from the messages; the final
// padded block is staged scalar-side (FIPS-202: 0x06 after the tail,
// 0x80 into the last rate byte) so short tails never read past a
// message.  Digest-identical to hbn::sha3_256 per message — the sha3
// plane's dispatch-identity contract rests on exactly that.
void hbf_ifma_sha3_256_x8(const uint8_t* in, size_t msg_len, uint8_t* out) {
  const size_t RATE = 136;  // SHA3-256
  __m512i st[25];
  for (int i = 0; i < 25; ++i) st[i] = _mm512_setzero_si512();
  const __m512i midx = _mm512_setr_epi64(
      0, (long long)msg_len, (long long)(2 * msg_len), (long long)(3 * msg_len),
      (long long)(4 * msg_len), (long long)(5 * msg_len),
      (long long)(6 * msg_len), (long long)(7 * msg_len));
  size_t nfull = msg_len / RATE;
  for (size_t b = 0; b < nfull; ++b) {
    const uint8_t* base = in + b * RATE;
    for (int i = 0; i < 17; ++i) {
      __m512i w = _mm512_i64gather_epi64(midx, (const void*)(base + 8 * i), 1);
      st[i] = _mm512_xor_epi64(st[i], w);
    }
    keccak_f_x8(st);
  }
  size_t rem = msg_len - nfull * RATE;
  alignas(64) uint8_t stage[8 * 136];
  std::memset(stage, 0, sizeof(stage));
  for (int j = 0; j < 8; ++j) {
    std::memcpy(stage + j * RATE, in + j * msg_len + nfull * RATE, rem);
    stage[j * RATE + rem] = 0x06;
    stage[j * RATE + RATE - 1] ^= 0x80;
  }
  const __m512i sidx = _mm512_setr_epi64(0, 136, 272, 408, 544, 680, 816, 952);
  for (int i = 0; i < 17; ++i) {
    __m512i w = _mm512_i64gather_epi64(sidx, (const void*)(stage + 8 * i), 1);
    st[i] = _mm512_xor_epi64(st[i], w);
  }
  keccak_f_x8(st);
  const __m512i oidx = _mm512_setr_epi64(0, 32, 64, 96, 128, 160, 192, 224);
  for (int w = 0; w < 4; ++w)
    _mm512_i64scatter_epi64((void*)(out + 8 * w), oidx, st[w], 1);
}

}  // extern "C"

#else  // !__AVX512IFMA__: stub arm (never dispatched to)

extern "C" {

int32_t hbf_ifma_compiled() { return 0; }

void hbf_ifma_mul_batch(const uint64_t*, const uint64_t*, uint64_t*, size_t) {}
void hbf_ifma_dot_acc(const uint64_t*, const uint64_t*, size_t,
                      uint64_t[8], size_t* done) {
  *done = 0;
}
void hbf_ifma_lagrange_dens(const int64_t*, size_t, uint64_t*) {}
void hbf_ifma_rlc_accum(const uint64_t*, const uint64_t*, size_t, uint64_t[8]) {
}
void hbf_ifma_sha3_256_x8(const uint8_t*, size_t, uint8_t*) {}

}  // extern "C"

#endif
