// Fq12 over the Fq6 tower for pair_final, on a team of 32 lanes (team.cuh):
// one warp per subset.
//
// Fq12 = Fq6[w] / (w^2 - v), Fq6 = Fq2[v] / (v^3 - xi), xi = 1 + u, so v =
// w^2 and w^6 = xi as in the port's w basis (fq12.cuh).  A value (g0 + g1 v
// + g2 v^2) + (h0 + h1 v + h2 v^2) w takes six consecutive Fq2 slots of the
// team's file, g0 g1 g2 h0 h1 h2.  The w-basis coefficient c_i (of w^i) is
// g_{i/2} for even i and h_{(i-1)/2} for odd i: the map between the bases
// only re-indexes coefficients and costs no product.
//
// Products (Beuchat et al., "High-speed software implementation of the
// optimal ate pairing over Barreto-Naehrig curves", 2010): an Fq12 product
// is three Fq6 products by Karatsuba, each six Fq2 products: 18 Fq2
// products, 54 Fq products, in one bundle over the warp.  A square in the
// cyclotomic subgroup is nine Fq2 squares (Granger and Scott, "Faster
// squaring in the cyclotomic subgroup of sixth degree extensions", 2010),
// 18 Fq products in one round of the warp; it is right only for values of
// that subgroup (see pairing.cuh, final_exp, for where it is used).
//
// Every op takes slot indices of the file R; "out" may equal an input
// unless an op says otherwise.  The product, the square and the Frobenius
// map are out-of-line: the final exponentiation calls them dozens of
// times, and one copy each keeps its code in the instruction cache.

#pragma once

#include "fq12.cuh"
#include "team.cuh"

namespace tower {

using fq::Fq;
using fq::Fq2;
using team::comp;
using team::Team;
using team::xi_comp;

constexpr int kLanes = 32;

// The file: Fq12 values of six slots each, the Frobenius constants, and
// the scratch of the products.
constexpr int kF = 0, kU = 6, kV = 12, kM = 18, kA = 24, kB = 30, kC = 36, kD = 42, kL = 48;
constexpr int kInvA = 54, kInvB = 60;
constexpr int kGam1 = 66, kGam2 = 72;  // gamma[k][i] at the slot of w^i, k = 1, 2
constexpr int kSA = 78;                // 18 operand sums of a product (or a conj)
constexpr int kSB = kSA + 18;          // 18 of its second operand
constexpr int kPR = kSB + 18;          // 18 Fq2 products
constexpr int kC6 = kPR + 18;          // 3 x 3 Fq6 coefficients
constexpr int kSlots = kC6 + 9;
constexpr int kParts = 54;  // the exchange buffer: the parts of one bundle

// The tower slot of w^i.
FQ_HD int slot_of(int i) { return (i & 1) ? 3 + (i >> 1) : (i >> 1); }

FQ_HD void copy(const Team& t, Fq2* R, int out, int a) {
  t.stage(12, [&](int l) { comp(R[out + (l >> 1)], l & 1) = comp(R[a + (l >> 1)], l & 1); });
}

// out = a^(p^6), the inverse on the cyclotomic unit circle: h negated.
FQ_HD void conj(const Team& t, Fq2* R, int out, int a) {
  t.stage(12, [&](int l) {
    const Fq& v = comp(R[a + (l >> 1)], l & 1);
    comp(R[out + (l >> 1)], l & 1) = (l >> 1) >= 3 ? fq::neg(v) : v;
  });
}

FQ_HD void set_one(const Team& t, Fq2* R, int out) {
  t.stage(12, [&](int l) {
    comp(R[out + (l >> 1)], l & 1) = l == 0 ? fq::fq_one() : fq::fq_zero();
  });
}

// Exact: every coefficient is fully reduced, so equality is word equality.
FQ_HD bool is_one(const Fq2* R, int a) {
  const Fq one = fq::fq_one();
  uint32_t diff = 0;
  for (int j = 0; j < fq::kWords; ++j) diff |= R[a].c0.w[j] ^ one.w[j];
  bool ok = diff == 0 && fq::is_zero(R[a].c1);
  for (int s = 1; s < 6; ++s) ok = ok && fq::is_zero(R[a + s]);
  return ok;
}

// out = a b: 18 Fq2 products over the operand sums, then the Fq6 and Fq12
// Karatsuba recombinations.  Op m in {0, 1, 2} is the Fq6 product g g', h
// h', (g + h)(g' + h'); op q in 0..5 of an Fq6 product x y is x0 y0, x1 y1,
// x2 y2, (x0 + x1)(y0 + y1), (x0 + x2)(y0 + y2), (x1 + x2)(y1 + y2).
TEAM_CALL void mul(Team t, Fq2* R, Fq* X, int out, int a, int b) {
  // Operand sums: S[o][m][q] at kSA + 18 o + 6 m + q (kSB = kSA + 18).
  t.stage(36, [&](int l) {
    const int c = l & 1, q = (l >> 1) % 3, m = (l >> 1) / 3 % 3, o = l / 18;
    const int src = o ? b : a;
    const Fq& g = comp(R[src + q], c);
    const Fq& h = comp(R[src + 3 + q], c);
    comp(R[kSA + 18 * o + 6 * m + q], c) = m == 0 ? g : m == 1 ? h : fq::add(g, h);
  });
  t.stage(36, [&](int l) {
    const int c = l & 1, q = 3 + (l >> 1) % 3, m = (l >> 1) / 3 % 3, o = l / 18;
    const int base = kSA + 18 * o + 6 * m;
    const int i1 = q == 5 ? 1 : 0, i2 = q == 3 ? 1 : 2;
    comp(R[base + q], c) = fq::add(comp(R[base + i1], c), comp(R[base + i2], c));
  });
  team::prods_of(t, R, X, 18, false, [&](int i) { return team::mul(kPR + i, kSA + i, kSB + i); });
  // Fq6: c0 = v0 + xi (m12 - v1 - v2), c1 = m01 - v0 - v1 + xi v2, c2 = m02
  // - v0 - v2 + v1.
  t.stage(18, [&](int l) {
    const int c = l & 1, j = (l >> 1) % 3, m = (l >> 1) / 3;
    const Fq2* P = R + kPR + 6 * m;
    Fq r;
    if (j == 0) {
      const Fq2 in = fq::sub(fq::sub(P[5], P[1]), P[2]);
      r = fq::add(comp(P[0], c), xi_comp(in, c));
    } else if (j == 1) {
      r = fq::add(fq::sub(fq::sub(comp(P[3], c), comp(P[0], c)), comp(P[1], c)), xi_comp(P[2], c));
    } else {
      r = fq::add(fq::sub(fq::sub(comp(P[4], c), comp(P[0], c)), comp(P[2], c)), comp(P[1], c));
    }
    comp(R[kC6 + 3 * m + j], c) = r;
  });
  // Fq12: g = C0 + v C1 (v (x0, x1, x2) = (xi x2, x0, x1)), h = C2 - C0 - C1.
  t.stage(12, [&](int l) {
    const int c = l & 1, s = l >> 1;
    const Fq2* C = R + kC6;
    Fq r;
    if (s == 0) {
      r = fq::add(comp(C[0], c), xi_comp(C[5], c));
    } else if (s < 3) {
      r = fq::add(comp(C[s], c), comp(C[3 + s - 1], c));
    } else {
      r = fq::sub(fq::sub(comp(C[6 + s - 3], c), comp(C[s - 3], c)), comp(C[3 + s - 3], c));
    }
    comp(R[out + s], c) = r;
  });
}

// The slot of z_k in the Granger-Scott square: z0..z5 = g0, h1, h0, g2, g1,
// h2.
FQ_HD int z_slot(int k) {
  return k == 0 ? 0 : k == 1 ? 4 : k == 2 ? 3 : k == 3 ? 2 : k == 4 ? 1 : 5;
}

// out = a^2 for a in the cyclotomic subgroup (Granger-Scott), out may be
// a.  With z0..z5 = g0, h1, h0, g2, g1, h2 and the Fq4 squares of the
// pairs (z0, z1), (z2, z3), (z4, z5): (t0, t1) of (x, y) is (x^2 + xi y^2,
// (x + y)^2 - x^2 - y^2), and z0' = 3 t0 - 2 z0, z1' = 3 t1 + 2 z1 for the
// first pair, z4' = 3 t0 - 2 z4, z5' = 3 t1 + 2 z5 from (z2, z3), and z2' =
// 3 xi t1 + 2 z2, z3' = 3 t0 - 2 z3 from (z4, z5).
TEAM_CALL void cyc_sqr(Team t, Fq2* R, Fq* X, int out, int a) {
  t.stage(6, [&](int l) {  // x + y of each pair
    const int pr = l >> 1, c = l & 1;
    comp(R[kSA + pr], c) =
        fq::add(comp(R[a + z_slot(2 * pr)], c), comp(R[a + z_slot(2 * pr + 1)], c));
  });
  // Square i = 3 pair + s: s = 0 x^2, 1 y^2, 2 (x + y)^2, into kPR + i.
  team::prods_of(t, R, X, 9, true, [&](int i) {
    const int pr = i / 3, s = i % 3;
    return team::sqr(kPR + i, s == 2 ? kSA + pr : a + z_slot(2 * pr + s));
  });
  t.stage(12, [&](int l) {
    const int c = l & 1, k = l >> 1;
    // k = 0, 1 from pair 0; 2, 3 from pair 2; 4, 5 from pair 1.
    const int pr = k < 2 ? 0 : k < 4 ? 2 : 1;
    const Fq2* S = R + kPR + 3 * pr;
    const bool first = k == 0 || k == 3 || k == 4;  // t0, else t1
    Fq tc;
    if (first) {
      tc = fq::add(comp(S[0], c), xi_comp(S[1], c));
    } else if (k == 2) {
      tc = xi_comp(fq::sub(fq::sub(S[2], S[0]), S[1]), c);
    } else {
      tc = fq::sub(fq::sub(comp(S[2], c), comp(S[0], c)), comp(S[1], c));
    }
    const Fq z2 = fq::dbl(comp(R[a + z_slot(k)], c));
    const Fq t3 = fq::small_mul<3>(tc);
    comp(R[out + z_slot(k)], c) = first ? fq::sub(t3, z2) : fq::add(t3, z2);
  });
}

// out = a^(p^k) for k = 1 or 2: the coefficient Frobenius (conj when k is
// odd) times gamma[k][i] at w^i.  out must not be a.
TEAM_CALL void frobenius(Team t, Fq2* R, Fq* X, int out, int a, int k) {
  int src = a;
  if (k & 1) {
    t.stage(12, [&](int l) {
      const Fq& v = comp(R[a + (l >> 1)], l & 1);
      comp(R[kSA + (l >> 1)], l & 1) = (l & 1) ? fq::neg(v) : v;
    });
    src = kSA;
  }
  const int gam = k == 1 ? kGam1 : kGam2;
  team::prods_of(t, R, X, 6, false, [&](int s) { return team::mul(out + s, src + s, gam + s); });
}

// x^-1 for x in Fq6 (three Fq2), 0 for 0: one lane's serial code.
FQ_HD void fq6_inv(const Fq2* x, Fq2* out) {
  const Fq2 c0 = fq::sub(fq::sqr(x[0]), fq::mul_by_xi(fq::mul(x[1], x[2])));
  const Fq2 c1 = fq::sub(fq::mul_by_xi(fq::sqr(x[2])), fq::mul(x[0], x[1]));
  const Fq2 c2 = fq::sub(fq::sqr(x[1]), fq::mul(x[0], x[2]));
  const Fq2 d = fq::add(fq::mul(x[0], c0),
                        fq::mul_by_xi(fq::add(fq::mul(x[2], c1), fq::mul(x[1], c2))));
  const Fq2 di = fq::inv(d);  // Fermat: 0 maps to 0
  out[0] = fq::mul(c0, di);
  out[1] = fq::mul(c1, di);
  out[2] = fq::mul(c2, di);
}

// out = a^-1 = conj(a) / N(a), N(a) = a conj(a) = g^2 - v h^2 in Fq6; 0
// maps to 0.  out must not be a.
FQ_HD void inv(const Team& t, Fq2* R, Fq* X, int out, int a) {
  conj(t, R, kInvA, a);
  mul(t, R, X, kInvB, a, kInvA);  // its h is 0
  t.stage(1, [&](int) {
    Fq2 ninv[3];
    fq6_inv(R + kInvB, ninv);
    for (int j = 0; j < 3; ++j) R[kInvB + j] = ninv[j];
  });
  mul(t, R, X, out, kInvA, kInvB);
}

// out = a^x for x = BLS_X < 0, a in the cyclotomic subgroup: from the top
// bit of |x| down, a square per bit and a product at each of the 5 set bits
// below the top (pairing.py's X_RUNS schedule), then conj.  out must not
// be a.
FQ_HD void pow_x(const Team& t, Fq2* R, Fq* X, int out, int a) {
  copy(t, R, out, a);
  for (int k = 62; k >= 0; --k) {
    cyc_sqr(t, R, X, out, out);
    if ((fq12::kXAbs >> k) & 1u) mul(t, R, X, out, out, a);
  }
  conj(t, R, out, out);
}

// The port's (6, 2, 36) limbs of a w-basis value into slots out: one
// conversion (one product) per lane.
FQ_HD void load(const Team& t, Fq2* R, int out, const int64_t* limbs) {
  t.stage(12, [&](int l) {
    const int i = l >> 1, c = l & 1;
    comp(R[out + slot_of(i)], c) = fq::from_port(limbs + (2 * i + c) * fq::kLimbs);
  });
}

// The Frobenius constants gamma[k][i] for k = 1, 2 from the port's (2, 6,
// 2, 36) limbs.
FQ_HD void load_gammas(const Team& t, Fq2* R, const int64_t* limbs) {
  t.stage(24, [&](int l) {
    const int k = l / 12, i = (l >> 1) % 6, c = l & 1;
    comp(R[(k ? kGam2 : kGam1) + slot_of(i)], c) =
        fq::from_port(limbs + ((6 * k + i) * 2 + c) * fq::kLimbs);
  });
}

}  // namespace tower
