// BLS12-381 base-field arithmetic for the port's hand-written kernels (K4).
//
// Replaces, inside the kernels, the batched limb arithmetic of
// hbbft_tpu/crypto/tpu/fq.py (mont_mul :208 and the ops around it), which
// XLA fused on the TPU and which the port's plain PyTorch version
// (hbbft_tpu_torch/crypto/device/fq.py) runs as about fifty launches per
// product.  Everything here is a __host__ __device__ function, so the same
// source runs in the CUDA kernels and, compiled by a host C++ compiler, in
// the host check that tests/test_torch_kernel_host.py drives.
//
// Representation inside a kernel: an Fq element is 12 little-endian 32-bit
// words, fully reduced (< P), in Montgomery form with R' = 2^384.  The
// product is CIOS (coarsely integrated operand scanning): twelve rows of
// "t += a * b_i" followed by "t = (t + m * P) / 2^32".  On the card each row
// is a mad.lo/madc.lo carry chain followed by a mad.hi/madc.hi chain
// (PTX, under __CUDA_ARCH__); elsewhere the same rows run on uint64_t.
//
// The boundary format is the port's: (..., 36) int64 limbs of 11 bits,
// each in [0, 4096], value below 2^386, in Montgomery form with
// R = 2^396 (fq.py module notes).  The conversion chosen:
//
//   in:  pack the limbs by carrying (never masking: a limb may be 4096),
//        fold the bits above 2^381 back in with 2^381 - P until none are
//        left, subtract P once, then one product by 2^372:
//        mont'(x * 2^396, 2^372) = x * 2^396 * 2^372 / 2^384 = x * 2^384;
//   out: one product by (2^396 mod P): mont'(x * 2^384, 2^396) =
//        x * 2^396, which is < P and is written as 36 strict 11-bit limbs.
//
// Outputs are therefore fully reduced with strict limbs, inside every plain
// op's input bound, so a kernel's result can flow into plain code.
//
// What bounds a product: 32-bit multiply-adds.  Schoolbook CIOS needs
// 12 x 12 lo/hi pairs for a*b, 12 for the quotient words m and 12 x 12
// lo/hi pairs for m*P: 588 IMAD instructions (chip_smoke.py derives the
// scan bounds from this count).  A square is the same product: a
// dedicated square (456 multiply-adds: the 66 cross products once, then
// the reduction) had a longer dependent chain on the H100 than this CIOS
// product and made the G1 rows slower, so none is kept (PERF.md).
//
// The product has two forms.  mont_mul_in is forced inline and takes its
// operands by reference: the lane teams (team.cuh) call it from one
// out-of-line part function.  mont_mul is an out-of-line copy for the
// chains one thread runs alone (the Fermat inverse, the limb conversions,
// fq_mont_mul), where inlining every product would multiply the code.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define FQ_HD __host__ __device__ __forceinline__
#define FQ_CALL static __host__ __device__ __noinline__
#else
#define FQ_HD inline
#define FQ_CALL static inline
#endif

#if defined(__CUDA_ARCH__)
#define FQ_UNROLL _Pragma("unroll")
#else
#define FQ_UNROLL
#endif

namespace fq {

constexpr int kWords = 12;     // 32-bit words per element
constexpr int kLimbs = 36;     // the port's 11-bit limbs per element
constexpr int kLimbBits = 11;
constexpr uint32_t kN0 = 0xfffcfffdu;  // -P^-1 mod 2^32

struct Fq {
  uint32_t w[kWords];
};

struct Fq2 {
  Fq c0, c1;  // c0 + c1 * u, u^2 = -1
};

// Constants as words, little-endian.  Built by value inside each function,
// so a device loop over the words folds them into immediates.
FQ_HD Fq fq_p() {
  return Fq{{0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
             0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau}};
}

// 2^384 mod P: the Montgomery form of 1 inside the kernels.
FQ_HD Fq fq_one() {
  return Fq{{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
             0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u}};
}

FQ_HD Fq fq_zero() { return Fq{{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}}; }

// 2^372 (< P): the entry conversion's factor.
FQ_HD Fq fq_c_in() { return Fq{{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0x00100000u}}; }

// 2^396 mod P: the exit conversion's factor.
FQ_HD Fq fq_c_out() {
  return Fq{{0x3480cb7fu, 0x6f830000u, 0xbe042b12u, 0xd1fccdeau, 0x3c7de4b4u, 0x40d78057u,
             0xc66805c5u, 0x6da3d19eu, 0x2746752au, 0x9afe6676u, 0x23205efbu, 0x09772fe1u}};
}

// 2^381 - P: folds the value bits above 2^381 back in.
FQ_HD Fq fq_fold381() {
  return Fq{{0x00005555u, 0x46010000u, 0x4eac0000u, 0xe1540001u, 0x094f09dbu, 0x98cf2d5fu,
             0x0c7aed40u, 0x9b88b47bu, 0xbcb45328u, 0xb4e45849u, 0xc6801965u, 0x05feee15u}};
}

// ---------------------------------------------------------------------------
// Reduction helpers
// ---------------------------------------------------------------------------

// t (12 words plus a top word t12) -> t - P if that is nonnegative, else t.
// Callers guarantee t < 2P.
FQ_HD Fq reduce_once(const uint32_t t[kWords], uint32_t t12) {
  const Fq p = fq_p();
  Fq d;
  uint64_t borrow = 0;
  FQ_UNROLL
  for (int j = 0; j < kWords; ++j) {
    uint64_t x = (uint64_t)t[j] - p.w[j] - borrow;
    d.w[j] = (uint32_t)x;
    borrow = x >> 63;
  }
  // t - P = d + (t12 - borrow) * 2^384: negative iff t12 == 0 and borrow.
  const bool keep = (t12 == 0) && (borrow != 0);
  Fq r;
  FQ_UNROLL
  for (int j = 0; j < kWords; ++j) r.w[j] = keep ? t[j] : d.w[j];
  return r;
}

// ---------------------------------------------------------------------------
// Montgomery product a * b / 2^384 (mod P), CIOS.  Inputs < P (a may be any
// value < 2^384 when b < P); output < P.
// ---------------------------------------------------------------------------

#if defined(__CUDA_ARCH__)

// One PTX instruction each.  The carry flag runs from one asm statement to
// the next: every statement is volatile, so they stay in program order, and
// nothing between them touches the flag (the chains are straight-line code
// over registers).
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

FQ_HD Fq mont_mul_in(const Fq& a, const Fq& b) {
  const Fq p = fq_p();
  uint32_t t[kWords + 2];
  FQ_UNROLL
  for (int j = 0; j < kWords + 2; ++j) t[j] = 0;
  FQ_UNROLL
  for (int i = 0; i < kWords; ++i) {
    const uint32_t bi = b.w[i];
    // t += a * b_i: low halves into t[0..11], high halves into t[1..12].
    t[0] = mad_lo_cc(a.w[0], bi, t[0]);
    FQ_UNROLL
    for (int j = 1; j < kWords; ++j) t[j] = madc_lo_cc(a.w[j], bi, t[j]);
    t[kWords] = addc(t[kWords], 0);
    t[1] = mad_hi_cc(a.w[0], bi, t[1]);
    FQ_UNROLL
    for (int j = 1; j < kWords; ++j) t[j + 1] = madc_hi_cc(a.w[j], bi, t[j + 1]);
    t[kWords + 1] = addc(0, 0);
    // t += m * P with m chosen so that t[0] becomes 0, then shift a word.
    const uint32_t m = t[0] * kN0;
    t[0] = mad_lo_cc(m, p.w[0], t[0]);
    FQ_UNROLL
    for (int j = 1; j < kWords; ++j) t[j] = madc_lo_cc(m, p.w[j], t[j]);
    t[kWords] = addc_cc(t[kWords], 0);
    t[kWords + 1] = addc(t[kWords + 1], 0);
    t[1] = mad_hi_cc(m, p.w[0], t[1]);
    FQ_UNROLL
    for (int j = 1; j < kWords; ++j) t[j + 1] = madc_hi_cc(m, p.w[j], t[j + 1]);
    t[kWords + 1] = addc(t[kWords + 1], 0);
    FQ_UNROLL
    for (int j = 0; j < kWords + 1; ++j) t[j] = t[j + 1];
    t[kWords + 1] = 0;
  }
  return reduce_once(t, t[kWords]);
}

FQ_CALL Fq mont_mul(Fq a, Fq b) { return mont_mul_in(a, b); }

#else  // portable path: the same rows on 64-bit integers

// Counters the host check reads: every Fq product, and the critical path,
// the products of the longest chain when each lane of a team (team.cuh)
// runs on its own thread.
inline uint64_t host_products = 0;
inline uint64_t host_path = 0;

// The operands are references here: GCC 12 at -O1/-O2 drops the caller's
// stores into a 48-byte struct passed by value to this function (its
// mod/ref analysis marks the argument unread), so by-value operands gave
// wrong products on the host.
FQ_HD Fq mont_mul_in(const Fq& a, const Fq& b) {
  ++host_products;
  ++host_path;
  const Fq p = fq_p();
  uint32_t t[kWords + 2] = {0};
  for (int i = 0; i < kWords; ++i) {
    const uint64_t bi = b.w[i];
    uint64_t c = 0;
    for (int j = 0; j < kWords; ++j) {
      c += (uint64_t)a.w[j] * bi + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[kWords];
    t[kWords] = (uint32_t)c;
    t[kWords + 1] = (uint32_t)(c >> 32);
    const uint64_t m = (uint32_t)(t[0] * kN0);
    c = ((uint64_t)m * p.w[0] + t[0]) >> 32;
    for (int j = 1; j < kWords; ++j) {
      c += m * p.w[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[kWords];
    t[kWords - 1] = (uint32_t)c;
    t[kWords] = t[kWords + 1] + (uint32_t)(c >> 32);
  }
  return reduce_once(t, t[kWords]);
}

FQ_CALL Fq mont_mul(const Fq& a, const Fq& b) { return mont_mul_in(a, b); }

#endif

FQ_HD Fq sqr(const Fq& a) { return mont_mul(a, a); }

// ---------------------------------------------------------------------------
// Additive ops on fully reduced elements
// ---------------------------------------------------------------------------

FQ_HD Fq add(const Fq& a, const Fq& b) {
  uint32_t t[kWords];
  uint64_t c = 0;
  FQ_UNROLL
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)a.w[j] + b.w[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  return reduce_once(t, (uint32_t)c);
}

FQ_HD Fq sub(const Fq& a, const Fq& b) {
  const Fq p = fq_p();
  Fq d;
  uint64_t borrow = 0;
  FQ_UNROLL
  for (int j = 0; j < kWords; ++j) {
    uint64_t x = (uint64_t)a.w[j] - b.w[j] - borrow;
    d.w[j] = (uint32_t)x;
    borrow = x >> 63;
  }
  // On a borrow, add P back (the sum wraps past 2^384 to the right value).
  const uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
  FQ_UNROLL
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)d.w[j] + (p.w[j] & mask);
    d.w[j] = (uint32_t)c;
    c >>= 32;
  }
  return d;
}

FQ_HD Fq neg(const Fq& a) { return sub(fq_zero(), a); }

FQ_HD Fq dbl(const Fq& a) { return add(a, a); }

// k * a for the small constants the curve and line formulas use (2, 3,
// 4, 8).
template <int K>
FQ_HD Fq small_mul(const Fq& a) {
  static_assert(K == 2 || K == 3 || K == 4 || K == 8, "small_mul factor");
  if (K == 2) return dbl(a);
  if (K == 3) return add(dbl(a), a);
  if (K == 4) return dbl(dbl(a));
  return dbl(dbl(dbl(a)));
}

FQ_HD bool is_zero(const Fq& a) {
  uint32_t acc = 0;
  FQ_UNROLL
  for (int j = 0; j < kWords; ++j) acc |= a.w[j];
  return acc == 0;
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u] / (u^2 + 1), the ops of crypto/device/fq2.py
// ---------------------------------------------------------------------------

FQ_HD Fq2 add(const Fq2& a, const Fq2& b) { return Fq2{add(a.c0, b.c0), add(a.c1, b.c1)}; }
FQ_HD Fq2 sub(const Fq2& a, const Fq2& b) { return Fq2{sub(a.c0, b.c0), sub(a.c1, b.c1)}; }
FQ_HD Fq2 neg(const Fq2& a) { return Fq2{neg(a.c0), neg(a.c1)}; }

template <int K>
FQ_HD Fq2 small_mul(const Fq2& a) {
  return Fq2{small_mul<K>(a.c0), small_mul<K>(a.c1)};
}

// Karatsuba, three base products: (a0 b0 - a1 b1) + ((a0+a1)(b0+b1) - a0 b0 - a1 b1) u.
FQ_HD Fq2 mul(const Fq2& a, const Fq2& b) {
  const Fq t0 = mont_mul(a.c0, b.c0);
  const Fq t1 = mont_mul(a.c1, b.c1);
  const Fq t2 = mont_mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return Fq2{sub(t0, t1), sub(sub(t2, t0), t1)};
}

// Two base products: (a0 + a1)(a0 - a1) + 2 a0 a1 u.
FQ_HD Fq2 sqr(const Fq2& a) {
  const Fq t0 = mont_mul(add(a.c0, a.c1), sub(a.c0, a.c1));
  const Fq t1 = mont_mul(a.c0, a.c1);
  return Fq2{t0, dbl(t1)};
}

FQ_HD Fq2 conj(const Fq2& a) { return Fq2{a.c0, neg(a.c1)}; }

// Times the sextic non-residue xi = 1 + u.
FQ_HD Fq2 mul_by_xi(const Fq2& a) { return Fq2{sub(a.c0, a.c1), add(a.c0, a.c1)}; }

FQ_HD bool is_zero(const Fq2& a) { return is_zero(a.c0) && is_zero(a.c1); }

FQ_HD Fq mul(const Fq& a, const Fq& b) { return mont_mul(a, b); }

// Times a base-field scalar (crypto/device/fq2.py mul_fq): two products.
FQ_HD Fq2 mul_fq(const Fq2& a, const Fq& s) { return Fq2{mont_mul(a.c0, s), mont_mul(a.c1, s)}; }

// ---------------------------------------------------------------------------
// Inversion (crypto/device/fq.py pow_fixed and inv, fq2.py inv)
// ---------------------------------------------------------------------------

// a^(P-2), which is a^-1 for a != 0 and 0 for a = 0 (Fermat), in the
// kernel's Montgomery form: 4-bit windows MSB-first as pow_fixed, a table
// of a^0 .. a^15 (14 products), then per window four squarings and at
// most one product: 485 products in all.  The exponent is fixed, so the
// branch on a window never depends on the data.
FQ_CALL Fq inv(const Fq& a) {
  Fq e = fq_p();
  e.w[0] -= 2u;  // P - 2; the low word of P is above 2
  Fq table[16];
  table[0] = fq_one();
  table[1] = a;
  for (int k = 2; k < 16; ++k) table[k] = mont_mul(table[k - 1], a);
  constexpr int kWindows = kWords * 8;  // 4-bit windows of 384 bits
  Fq acc = table[e.w[kWords - 1] >> 28];  // the top window of P - 2 is 1
  for (int win = kWindows - 2; win >= 0; --win) {
    acc = sqr(acc);
    acc = sqr(acc);
    acc = sqr(acc);
    acc = sqr(acc);
    const uint32_t nib = (e.w[win >> 3] >> (4 * (win & 7))) & 15u;
    if (nib != 0) acc = mont_mul(acc, table[nib]);
  }
  return acc;
}

// (a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 + a1^2): one Fq inversion; 0 maps
// to 0.
FQ_CALL Fq2 inv(const Fq2& a) {
  const Fq ninv = inv(add(sqr(a.c0), sqr(a.c1)));
  return Fq2{mont_mul(a.c0, ninv), neg(mont_mul(a.c1, ninv))};
}

// ---------------------------------------------------------------------------
// The port's limb format at the kernel boundary (conversion in the header
// notes above)
// ---------------------------------------------------------------------------

// 36 limbs (each >= 0, value < 2^397) -> the value mod P, < P, as words.
FQ_HD Fq limbs_to_words_reduced(const int64_t* limbs) {
  uint32_t v[kWords + 1];
  uint64_t acc = 0;
  int nbits = 0;
  int w = 0;
  // Carry, never mask: a limb may be 4096, one bit above 11.
  FQ_UNROLL
  for (int i = 0; i < kLimbs; ++i) {
    acc += (uint64_t)limbs[i] << nbits;
    nbits += kLimbBits;
    if (nbits >= 32) {
      v[w++] = (uint32_t)acc;
      acc >>= 32;
      nbits -= 32;
    }
  }
  v[kWords] = (uint32_t)acc;  // 36 * 11 = 396 bits: 12 words and 12 bits
  // Fold the bits above 2^381: v = lo + hi * 2^381 = lo + hi * (2^381 - P)
  // (mod P).  Each fold shrinks hi about fivefold; at most a few rounds.
  const Fq d = fq_fold381();
  for (;;) {
    const uint32_t hi = (v[kWords - 1] >> 29) | (v[kWords] << 3);
    if (hi == 0) break;
    v[kWords - 1] &= 0x1fffffffu;
    uint64_t c = 0;
    FQ_UNROLL
    for (int j = 0; j < kWords; ++j) {
      c += (uint64_t)hi * d.w[j] + v[j];
      v[j] = (uint32_t)c;
      c >>= 32;
    }
    v[kWords] = (uint32_t)c;
  }
  return reduce_once(v, 0);  // v < 2^381 < 2P
}

// Port Montgomery form (x * 2^396) -> kernel Montgomery form (x * 2^384).
FQ_HD Fq from_port(const int64_t* limbs) {
  return mont_mul(limbs_to_words_reduced(limbs), fq_c_in());
}

// Fully reduced words -> 36 strict 11-bit limbs.
FQ_HD void words_to_limbs(const Fq& a, int64_t* limbs) {
  FQ_UNROLL
  for (int i = 0; i < kLimbs; ++i) {
    const int bit = kLimbBits * i;
    const int w = bit >> 5, s = bit & 31;
    uint32_t v = w < kWords ? a.w[w] >> s : 0;
    if (s > 32 - kLimbBits && w + 1 < kWords) v |= a.w[w + 1] << (32 - s);
    limbs[i] = (int64_t)(v & ((1u << kLimbBits) - 1));
  }
}

// Kernel Montgomery form (x * 2^384) -> port Montgomery form (x * 2^396).
FQ_HD void to_port(const Fq& a, int64_t* limbs) { words_to_limbs(mont_mul(a, fq_c_out()), limbs); }

FQ_HD Fq2 from_port2(const int64_t* limbs) {  // (2, 36) limbs
  return Fq2{from_port(limbs), from_port(limbs + kLimbs)};
}

FQ_HD void to_port2(const Fq2& a, int64_t* limbs) {
  to_port(a.c0, limbs);
  to_port(a.c1, limbs + kLimbs);
}

// The port's mont_mul on its own limbs: a * b / 2^396 (mod P), fully
// reduced.  Two products: mont'(a, b) = a b / 2^384, then times 2^372 / 2^384.
FQ_HD void port_mont_mul(const int64_t* a, const int64_t* b, int64_t* out) {
  const Fq ab = mont_mul(limbs_to_words_reduced(a), limbs_to_words_reduced(b));
  words_to_limbs(mont_mul(ab, fq_c_in()), out);
}

}  // namespace fq
