// The optimal-ate pairing pieces of the pair-stage kernels (K3), on teams
// of 32 lanes (team.cuh): the Miller loop of pair_miller (one warp per
// pair) and the final exponentiation of pair_final (one warp per subset),
// both over the Fq6 tower of tower.cuh.  The formulas and the line
// scaling are crypto/device/pairing.py's, so a kernel's Miller value
// equals the plain miller_values coefficient by coefficient (as canonical
// values), not merely after the final exponentiation.
//
// Replaces, inside the kernels, hbbft_tpu/crypto/tpu/pairing.py
// (g1_affine :288, g2_affine :297, miller_loop :196 with dbl_step :208
// and add_step :226, final_exp_is_one :251, miller_product :304).
//
// Like fq.cuh, every function is __host__ __device__ and goes through the
// host check too (tests/test_torch_pair_host.py), the lanes of a stage one
// after another.

#pragma once

#include "fq12.cuh"
#include "tower.cuh"

namespace pairing {

using fq::Fq;
using fq::Fq2;
using team::comp;
using team::Team;
using team::xi_comp;

// ---------------------------------------------------------------------------
// pair_miller on a team of 32 lanes
// ---------------------------------------------------------------------------
//
// The pair's state lives in a file of Fq2 slots: f in the tower's slot
// order (g0 g1 g2 h0 h1 h2; the w-basis value only re-indexes them), T in
// Jacobian coordinates, the affine Q, -x_P and y_P (as Fq2 values with a
// zero c1), the line (l0 + l2 v) + (l3 v) w = l0 + l2 w^2 + l3 w^3 and the
// temporaries.  Every Fq2 product is split into its Karatsuba parts
// (team::prods), one Fq product a lane.
//
// A doubling step is four bundles of products, none over 32 parts, so its
// critical path is four Fq products:
//
//   B1  a = x^2, b = y^2, z1z1 = z^2, yz, and 7 of f^2's 12 products;
//   B2  x a, a z1z1, z' z1z1, c = b^2, (x + b)^2, e^2, and f^2's last 5;
//   B3  e (d - x3), the two products by P, and the 4 products of
//       f^2 * line that need only l0;
//   B4  the other 9 products of f^2 * line.
//
// T's doubling is three dependent rounds; f^2 does not depend on T, so it
// runs beside them.  f^2 is the complex square of f = g + h w: A = g h and
// B = (g + h)(g + v h), two Fq6 products of six Fq2 products each
// (Karatsuba), then f^2 = (B - A - v A) + 2 A w.  (f is not in the
// cyclotomic subgroup inside the Miller loop, so tower::cyc_sqr would be
// wrong here.)  f * line is sparse: with g' = (l0, l2, 0) and h' = (0, l3,
// 0), g g' is five Fq2 products, h h' three, and (g + h)(g' + h') five.
// An addition step is five rounds of T's products, the fifth together with
// the 13 of f * line (two Fq products on the busiest lane).  The linear
// steps between bundles are stages of additions, one component a lane.
//
// T follows pairing.py's dbl_step and add_step formula for formula: the
// lines are scaled by T's coordinates, so another representative of T
// would change every later Miller value.

namespace ml {

using team::mul;
using team::sqr;

constexpr int kLanes = 32;
constexpr int kParts = 48;  // the most parts of one bundle (45)

constexpr int kF = 0;                    // f, six slots
constexpr int kX = 6, kY = 7, kZ = 8;    // T
constexpr int kQX = 9, kQY = 10;         // the affine Q
constexpr int kPXN = 11, kPY = 12;       // -x_P, y_P (c1 = 0)
constexpr int kL0 = 13, kL2 = 14, kL3 = 15;             // the line
constexpr int kL02 = 16, kL23 = 17, kL023 = 18;         // its sums
constexpr int kT = 19;                   // a step's temporaries, 18 slots
constexpr int kSS = kT + 18;             // f^2's 18 operand sums
constexpr int kSP = kSS + 18;            // f^2's 12 products
constexpr int kA6 = kSP + 12;            // A = g h and B, 3 slots each
constexpr int kB6 = kA6 + 3;
constexpr int kLS = kB6 + 3;             // f * line's 5 operand sums
constexpr int kLP = kLS + 5;             // f * line's 13 products
constexpr int kSlots = kLP + 13;

// The doubling's temporaries.
constexpr int kA = kT, kB = kT + 1, kZZ = kT + 2, kYZ = kT + 3, kS = kT + 4, kE = kT + 5,
              kXA = kT + 6, kAZ = kT + 7, kZZN = kT + 8, kC = kT + 9, kS2 = kT + 10,
              kE2 = kT + 11, kW = kT + 12, kC8 = kT + 13, kAZ3 = kT + 14, kM = kT + 15;
// The addition's.
constexpr int kAZ1 = kT, kU2 = kT + 1, kZZ1 = kT + 2, kH = kT + 3, kS2A = kT + 4, kHZ = kT + 5,
              kHH = kT + 6, kTH = kT + 7, kRR = kT + 8, kI = kT + 9, kTQ = kT + 10,
              kQH = kT + 11, kJ = kT + 12, kV = kT + 13, kR2 = kT + 14, kWA = kT + 15,
              kMA = kT + 16, kYJ = kT + 17;

FQ_HD const Fq& at(const Fq2* R, int slot, int c) { return comp(R[slot], c); }
FQ_HD Fq& at(Fq2* R, int slot, int c) { return comp(R[slot], c); }

// --- f^2 --------------------------------------------------------------------

// Component c of f^2's operand sum q (kSS + q), from f: A = g h takes x =
// g, y = h and the Karatsuba sums x01 x02 x12 y01 y02 y12 (q 0..5); B = s
// t with s = g + h, t = g + v h = (g0 + xi h2, g1 + h0, g2 + h1) takes s0
// s1 s2 t0 t1 t2 (q 6..11) and s01 s02 s12 t01 t02 t12 (q 12..17).
FQ_HD Fq sq_sum(const Fq2* R, int q, int c) {
  auto g = [&](int j) -> const Fq& { return at(R, kF + j, c); };
  auto h = [&](int j) -> const Fq& { return at(R, kF + 3 + j, c); };
  auto s = [&](int j) { return fq::add(g(j), h(j)); };
  auto tt = [&](int j) { return j == 0 ? fq::add(g(0), xi_comp(R[kF + 5], c)) : fq::add(g(j), h(j - 1)); };
  // The pair of indices a Karatsuba sum adds: 01, 02, 12.
  const int k = q % 3, i0 = k == 2 ? 1 : 0, i1 = k == 0 ? 1 : 2;
  if (q < 3) return fq::add(g(i0), g(i1));
  if (q < 6) return fq::add(h(i0), h(i1));
  if (q < 9) return s(q - 6);
  if (q < 12) return tt(q - 9);
  if (q < 15) return fq::add(s(i0), s(i1));
  return fq::add(tt(i0), tt(i1));
}

// f^2's product i: A's six (i < 6) then B's, each x0 y0, x1 y1, x2 y2,
// x01 y01, x02 y02, x12 y12.
FQ_HD team::Prod sq_prod(int i) {
  const int m = i / 6, q = i % 6;
  int a, b;
  if (m == 0) {
    a = q < 3 ? kF + q : kSS + q - 3;
    b = q < 3 ? kF + 3 + q : kSS + q;
  } else {
    a = q < 3 ? kSS + 6 + q : kSS + 9 + q;
    b = q < 3 ? kSS + 9 + q : kSS + 12 + q;
  }
  return mul(kSP + i, a, b);
}

// Component c of coefficient j of the Fq6 product m (A or B) from its six
// products: c0 = V0 + xi (M12 - V1 - V2), c1 = M01 - V0 - V1 + xi V2, c2 =
// M02 - V0 - V2 + V1 (tower::mul).
FQ_HD void sq_fq6(Fq2* R, int l) {
  const int c = l & 1, j = (l >> 1) % 3, m = (l >> 1) / 3;
  const Fq2* P = R + kSP + 6 * m;
  Fq r;
  if (j == 0) {
    r = fq::add(comp(P[0], c), xi_comp(fq::sub(fq::sub(P[5], P[1]), P[2]), c));
  } else if (j == 1) {
    r = fq::add(fq::sub(fq::sub(comp(P[3], c), comp(P[0], c)), comp(P[1], c)), xi_comp(P[2], c));
  } else {
    r = fq::add(fq::sub(fq::sub(comp(P[4], c), comp(P[0], c)), comp(P[2], c)), comp(P[1], c));
  }
  at(R, (m ? kB6 : kA6) + j, c) = r;
}

// Component c of f^2's slot s from A and B: g = B - A - v A with v A =
// (xi a2, a0, a1), h = 2 A.
FQ_HD void sq_out(Fq2* R, int l) {
  const int c = l & 1, s = l >> 1;
  if (s >= 3) {
    at(R, kF + s, c) = fq::dbl(at(R, kA6 + s - 3, c));
    return;
  }
  const Fq va = s == 0 ? xi_comp(R[kA6 + 2], c) : at(R, kA6 + s - 1, c);
  at(R, kF + s, c) = fq::sub(fq::sub(at(R, kB6 + s, c), at(R, kA6 + s, c)), va);
}

// --- f * line -----------------------------------------------------------------

// Component c of f * line's operand sum q (kLS + q), from f: g0 + g1, then
// g_j + h_j for j = 0, 1, 2, then (g0 + h0) + (g1 + h1).
FQ_HD void line_sum(Fq2* R, int l) {
  const int c = l & 1, q = l >> 1;
  auto gh = [&](int j) { return fq::add(at(R, kF + j, c), at(R, kF + 3 + j, c)); };
  at(R, kLS + q, c) = q == 0   ? fq::add(at(R, kF, c), at(R, kF + 1, c))
                      : q < 4 ? gh(q - 1)
                              : fq::add(gh(0), gh(1));
}

// Component c of the line's sums: l0 + l2, l2 + l3, l0 + l2 + l3; l0 given
// (the stage that forms l0 forms them too).
FQ_HD void line_sums(Fq2* R, int l, const Fq& l0) {
  const int c = l & 1, q = l >> 1;
  const Fq& l2 = at(R, kL2, c);
  const Fq& l3 = at(R, kL3, c);
  at(R, kL02 + q, c) = q == 0 ? fq::add(l0, l2) : q == 1 ? fq::add(l2, l3)
                                                         : fq::add(fq::add(l0, l2), l3);
}

// f * line's product i into kLP + i.  g g' (x = g, y = (l0, l2)): P0 = g0
// l0, P1 = g1 l2, P2 = (g0 + g1)(l0 + l2), P3 = g2 l0, P4 = g2 l2; h h':
// P5..P7 = h_j l3; (g + h)(g' + h') (y = (l0, l2 + l3)): P8 = (g0 + h0) l0,
// P9 = (g1 + h1)(l2 + l3), P10 = (g01 + h01)(l0 + l2 + l3), P11 = (g2 + h2)
// l0, P12 = (g2 + h2)(l2 + l3).  P0, P3, P8 and P11 need only l0.
FQ_HD team::Prod line_prod(int i) {
  switch (i) {
    case 0: return mul(kLP + 0, kF + 0, kL0);
    case 1: return mul(kLP + 1, kF + 1, kL2);
    case 2: return mul(kLP + 2, kLS + 0, kL02);
    case 3: return mul(kLP + 3, kF + 2, kL0);
    case 4: return mul(kLP + 4, kF + 2, kL2);
    case 5: return mul(kLP + 5, kF + 3, kL3);
    case 6: return mul(kLP + 6, kF + 4, kL3);
    case 7: return mul(kLP + 7, kF + 5, kL3);
    case 8: return mul(kLP + 8, kLS + 1, kL0);
    case 9: return mul(kLP + 9, kLS + 2, kL23);
    case 10: return mul(kLP + 10, kLS + 4, kL023);
    case 11: return mul(kLP + 11, kLS + 3, kL0);
    default: return mul(kLP + 12, kLS + 3, kL23);
  }
}

// The l0-only products (B3) and the others (B4), in line_prod's numbering.
FQ_HD int line_early(int i) { return i == 0 ? 0 : i == 1 ? 3 : i == 2 ? 8 : 11; }
FQ_HD int line_late(int i) { return i < 2 ? i + 1 : i < 6 ? i + 2 : i < 8 ? i + 3 : 12; }

// Component c of f * line's slot s: g = g g' + v h h', h = (g + h)(g' + h')
// - g g' - h h', with v h h' = (xi P6, xi P7, P5).
FQ_HD void line_out(Fq2* R, int l) {
  const int c = l & 1, s = l >> 1;
  const Fq2* P = R + kLP;
  auto p = [&](int k) -> const Fq& { return comp(P[k], c); };
  Fq r;
  switch (s) {
    case 0: r = fq::add(p(0), xi_comp(fq::add(P[4], P[6]), c)); break;
    case 1: r = fq::add(fq::sub(fq::sub(p(2), p(0)), p(1)), xi_comp(P[7], c)); break;
    case 2: r = fq::add(fq::add(p(1), p(3)), p(5)); break;
    case 3:
      r = fq::add(fq::sub(p(8), p(0)), xi_comp(fq::sub(fq::sub(P[12], P[4]), P[7]), c));
      break;
    case 4:
      r = fq::sub(fq::sub(fq::sub(fq::sub(p(10), p(8)), p(9)), fq::sub(fq::sub(p(2), p(0)), p(1))),
                  p(5));
      break;
    default: r = fq::sub(fq::sub(fq::add(p(9), p(11)), fq::add(p(1), p(3))), p(6)); break;
  }
  at(R, kF + s, c) = r;
}

// --- the steps ----------------------------------------------------------------

// Doubling step (pairing.py dbl_step): the tangent at T scaled by 2 Y Z^3,
// T = 2T, f = f^2 * line.
FQ_HD void dbl_step(const Team& t, Fq2* R, Fq* X) {
  using namespace fq;
  t.stage(36, [&](int l) { at(R, kSS + (l >> 1), l & 1) = sq_sum(R, l >> 1, l & 1); });
  team::prods(t, R, X, 11, [&](int i) {
    switch (i) {
      case 0: return sqr(kA, kX);
      case 1: return sqr(kB, kY);
      case 2: return sqr(kZZ, kZ);
      case 3: return mul(kYZ, kY, kZ);
      default: return sq_prod(i - 4);
    }
  });
  // x + b, e = 3 a, z' = 2 y z (z is read no more).
  t.stage(6, [&](int l) {
    const int c = l & 1, k = l >> 1;
    if (k == 0) at(R, kS, c) = add(at(R, kX, c), at(R, kB, c));
    if (k == 1) at(R, kE, c) = small_mul<3>(at(R, kA, c));
    if (k == 2) at(R, kZ, c) = small_mul<2>(at(R, kYZ, c));
  });
  team::prods(t, R, X, 11, [&](int i) {
    switch (i) {
      case 0: return mul(kXA, kX, kA);
      case 1: return mul(kAZ, kA, kZZ);
      case 2: return mul(kZZN, kZ, kZZ);
      case 3: return sqr(kC, kB);
      case 4: return sqr(kS2, kS);
      case 5: return sqr(kE2, kE);
      default: return sq_prod(i + 1);
    }
  });
  // A and B; d = 2 ((x + b)^2 - a - c), x3 = e^2 - 2 d, d - x3, 8 c, l0 =
  // 3 x a - 2 b, 3 a z1z1.
  t.stage(22, [&](int l) {
    if (l < 12) {
      sq_fq6(R, l);
      return;
    }
    const int c = l & 1, k = (l - 12) >> 1;
    const Fq d = small_mul<2>(sub(sub(at(R, kS2, c), at(R, kA, c)), at(R, kC, c)));
    const Fq x3 = sub(at(R, kE2, c), small_mul<2>(d));
    if (k == 0) at(R, kX, c) = x3;
    if (k == 1) at(R, kW, c) = sub(d, x3);
    if (k == 2) at(R, kC8, c) = small_mul<8>(at(R, kC, c));
    if (k == 3) at(R, kL0, c) = sub(small_mul<3>(at(R, kXA, c)), small_mul<2>(at(R, kB, c)));
    if (k == 4) at(R, kAZ3, c) = small_mul<3>(at(R, kAZ, c));
  });
  t.stage(12, [&](int l) { sq_out(R, l); });
  t.stage(10, [&](int l) { line_sum(R, l); });
  team::prods(t, R, X, 7, [&](int i) {
    switch (i) {
      case 0: return mul(kM, kE, kW);
      case 1: return mul(kL2, kAZ3, kPXN);
      case 2: return mul(kL3, kZZN, kPY);
      default: return line_prod(line_early(i - 3));
    }
  });
  // y3 = e (d - x3) - 8 c; the line's sums.
  t.stage(8, [&](int l) {
    if (l < 2) {
      at(R, kY, l) = sub(at(R, kM, l), at(R, kC8, l));
      return;
    }
    line_sums(R, l - 2, at(R, kL0, l & 1));
  });
  team::prods(t, R, X, 9, [&](int i) { return line_prod(line_late(i)); });
  t.stage(12, [&](int l) { line_out(R, l); });
}

// Addition step with the affine Q (pairing.py add_step): the chord
// through T and Q scaled by H Z, T = T + Q, f = f * line.
FQ_HD void add_step(const Team& t, Fq2* R, Fq* X) {
  using namespace fq;
  team::prods(t, R, X, 1, [&](int) { return sqr(kAZ1, kZ); });
  team::prods(t, R, X, mul(kU2, kQX, kAZ1), mul(kZZ1, kZ, kAZ1));
  // h = u2 - x; f * line's operand sums.
  t.stage(12, [&](int l) {
    if (l < 2) {
      at(R, kH, l) = sub(at(R, kU2, l), at(R, kX, l));
      return;
    }
    line_sum(R, l - 2);
  });
  team::prods(t, R, X, mul(kS2A, kQY, kZZ1), mul(kHZ, kH, kZ), sqr(kHH, kH));
  // theta = s2 - y, rr = 2 theta, i = 4 h^2.
  t.stage(6, [&](int l) {
    const int c = l & 1, k = l >> 1;
    const Fq th = sub(at(R, kS2A, c), at(R, kY, c));
    if (k == 0) at(R, kTH, c) = th;
    if (k == 1) at(R, kRR, c) = small_mul<2>(th);
    if (k == 2) at(R, kI, c) = small_mul<4>(at(R, kHH, c));
  });
  team::prods(t, R, X, 7, [&](int i) {
    switch (i) {
      case 0: return mul(kTQ, kTH, kQX);
      case 1: return mul(kQH, kQY, kHZ);
      case 2: return mul(kL2, kTH, kPXN);
      case 3: return mul(kL3, kHZ, kPY);
      case 4: return mul(kJ, kH, kI);
      case 5: return mul(kV, kX, kI);
      default: return sqr(kR2, kRR);
    }
  });
  // l0 = theta x_Q - y_Q h z and the line's sums; x3 = rr^2 - j - 2 v, v -
  // x3, z3 = 2 h z.
  t.stage(14, [&](int l) {
    const int c = l & 1, k = l >> 1;
    const Fq x3 = sub(sub(at(R, kR2, c), at(R, kJ, c)), small_mul<2>(at(R, kV, c)));
    const Fq l0 = sub(at(R, kTQ, c), at(R, kQH, c));
    if (k == 0) at(R, kX, c) = x3;
    if (k == 1) at(R, kWA, c) = sub(at(R, kV, c), x3);
    if (k == 2) at(R, kZ, c) = small_mul<2>(at(R, kHZ, c));
    if (k == 3) at(R, kL0, c) = l0;
    if (k >= 4) line_sums(R, l - 8, l0);
  });
  team::prods(t, R, X, 15, [&](int i) {
    return i == 0 ? mul(kMA, kRR, kWA) : i == 1 ? mul(kYJ, kY, kJ) : line_prod(i - 2);
  });
  // y3 = rr (v - x3) - 2 y j; f = f * line.
  t.stage(14, [&](int l) {
    if (l < 2) {
      at(R, kY, l) = sub(at(R, kMA, l), small_mul<2>(at(R, kYJ, l)));
      return;
    }
    line_out(R, l - 2);
  });
}

// The pair's points from the port's limbs to affine, and the loop's
// start: T = (x_Q, y_Q, 1), f = 1, -x_P and y_P.  One Fermat inversion
// for P's z and one for the norm of Q's z, on two lanes side by side
// (pairing.py g1_affine, g2_affine; fq.cuh inv for Fq2).  The Jacobian
// inputs sit in slots of f^2's sums, which the loop overwrites.
FQ_HD void affine(const Team& t, Fq2* R, Fq* X, const int64_t* px, const int64_t* py,
                  const int64_t* pz, const int64_t* qx, const int64_t* qy, const int64_t* qz) {
  using namespace fq;
  constexpr int kJP = kSS, kJQ = kSS + 3;  // P's x, y, z (in c0), Q's x, y, z
  constexpr int kN = kSS + 6;              // z_Q0^2, z_Q1^2 (c0, c1)
  constexpr int kInv = kSS + 7;            // 1 / z_P (c0), 1 / N(z_Q) (c1)
  constexpr int kZP = kSS + 8;             // 1 / z_P^2 (c0), 1 / z_P^3 (c1)
  constexpr int kZQ = kSS + 9, kZQ2 = kSS + 10, kZQ3 = kSS + 11;  // 1 / z_Q^k
  t.stage(9, [&](int l) {
    if (l < 3) {
      at(R, kJP + l, 0) = from_port(l == 0 ? px : l == 1 ? py : pz);
      return;
    }
    const int crd = (l - 3) >> 1, c = (l - 3) & 1;
    at(R, kJQ + crd, c) = from_port((crd == 0 ? qx : crd == 1 ? qy : qz) + c * kLimbs);
  });
  t.stage(2, [&](int c) { at(R, kN, c) = sqr(at(R, kJQ + 2, c)); });
  t.stage(2, [&](int l) {
    at(R, kInv, l) = inv(l == 0 ? at(R, kJP + 2, 0) : add(at(R, kN, 0), at(R, kN, 1)));
  });
  // 1 / z_Q = (z0 - z1 u) / N; 1 / z_P^2.
  t.stage(3, [&](int l) {
    if (l == 2) {
      at(R, kZP, 0) = sqr(at(R, kInv, 0));
      return;
    }
    const Fq v = mont_mul(at(R, kJQ + 2, l), at(R, kInv, 1));
    at(R, kZQ, l) = l ? neg(v) : v;
  });
  // 1 / z_Q^2 (two parts); -x_P = -x z^-2, 1 / z_P^3.
  t.stage(4, [&](int l) {
    if (l < 2) {
      X[l] = team::part(sqr(kZQ2, kZQ), l, R);
    } else if (l == 2) {
      at(R, kPXN, 0) = neg(mont_mul(at(R, kJP, 0), at(R, kZP, 0)));
    } else {
      at(R, kZP, 1) = mont_mul(at(R, kZP, 0), at(R, kInv, 0));
    }
  });
  t.stage(2, [&](int c) { at(R, kZQ2, c) = team::join(sqr(kZQ2, kZQ), c, X); });
  // x_Q = x z^-2 and 1 / z_Q^3 (three parts each); y_P = y z^-3.
  t.stage(7, [&](int l) {
    if (l < 6) {
      X[l] = team::part(l < 3 ? mul(kQX, kJQ, kZQ2) : mul(kZQ3, kZQ2, kZQ), l % 3, R);
    } else {
      at(R, kPY, 0) = mont_mul(at(R, kJP + 1, 0), at(R, kZP, 1));
    }
  });
  t.stage(4, [&](int l) {
    const team::Prod o = l < 2 ? mul(kQX, kJQ, kZQ2) : mul(kZQ3, kZQ2, kZQ);
    at(R, o.dst, l & 1) = team::join(o, l & 1, X + 3 * (l >> 1));
  });
  team::prods(t, R, X, 1, [&](int) { return mul(kQY, kJQ + 1, kZQ3); });
  // T = (x_Q, y_Q, 1), f = 1, the zero c1 of -x_P and y_P.
  t.stage(20, [&](int l) {
    const int c = l & 1;
    if (l < 12) {
      at(R, kF + (l >> 1), c) = l == 0 ? fq_one() : fq_zero();
    } else if (l < 16) {
      at(R, l < 14 ? kX : kY, c) = at(R, l < 14 ? kQX : kQY, c);
    } else if (l < 18) {
      at(R, kZ, c) = c ? fq_zero() : fq_one();
    } else {
      at(R, l < 19 ? kPXN : kPY, 1) = fq_zero();
    }
  });
}

// f_{x,Q}(P) for a pair in the port's limbs, written as (6, 2, 36) limbs
// of the w basis at out, or 1 where either side is the identity (the
// oracle's None-skip; pairing.py miller_values gates with torch.where).
// A doubling step for each bit of |x| below the top and an addition step
// at each set bit (the X_RUNS schedule), then the conjugate for x < 0.
// p: x, y, z of (36,) limbs; q: of (2, 36).
FQ_HD void value(const Team& t, Fq2* R, Fq* X, const int64_t* px, const int64_t* py,
                 const int64_t* pz, bool p_inf, const int64_t* qx, const int64_t* qy,
                 const int64_t* qz, bool q_inf, int64_t* out) {
  const bool skip = p_inf || q_inf;
  if (!skip) {
    affine(t, R, X, px, py, pz, qx, qy, qz);
    for (int k = 62; k >= 0; --k) {
      dbl_step(t, R, X);
      if ((fq12::kXAbs >> k) & 1u) add_step(t, R, X);
    }
  }
  // conj(f) (h negated) in the w basis: coefficient i at tower::slot_of(i).
  t.stage(12, [&](int l) {
    const int i = l >> 1, c = l & 1;
    Fq v = skip ? (l == 0 ? fq::fq_one() : fq::fq_zero()) : at(R, kF + tower::slot_of(i), c);
    if (i & 1) v = fq::neg(v);
    fq::to_port(v, out + l * fq::kLimbs);
  });
}

}  // namespace ml

// ---------------------------------------------------------------------------
// pair_final on a team of 32 lanes: the tower Fq12 of tower.cuh
// ---------------------------------------------------------------------------

// f^(3 (p^12 - 1) / r) for f at tower::kF, left at tower::kD: the easy part
// f^((p^6 - 1)(p^2 + 1)), then the hard part to the power 3 (p^4 - p^2 + 1)
// / r = (x - 1)^2 (x + p) (x^2 + p^2 - 1) + 3 (pairing.py
// final_exp_is_one; its module notes verify the identity).  That is e^3,
// not e: only is_one of it means anything, and cubing is a bijection on
// the cyclotomic subgroup.  Uses every value slot of the file.
FQ_HD void final_exp(const team::Team& t, Fq2* R, Fq* X) {
  using namespace tower;
  inv(t, R, X, kV, kF);
  conj(t, R, kU, kF);
  mul(t, R, X, kF, kU, kV);  // f1 = f^(p^6 - 1)
  frobenius(t, R, X, kM, kF, 2);
  mul(t, R, X, kM, kM, kF);  // m = f1^(p^2 + 1)
  // safety: cyclotomic squares (pow_x, cyc_sqr) from here on.  For f != 0,
  // m = f^((p^6 - 1)(p^2 + 1)) lies in the cyclotomic subgroup, and so does
  // every value below: products, conj and Frobenius maps of its elements.
  // For f = 0 (a zero Miller value), Fermat gives 0^-1 = 0, so f1 = m = 0;
  // the Granger-Scott square of 0 is 0, every product with it is 0, and
  // is_one(0) is false, as the plain stage's verdict.
  pow_x(t, R, X, kA, kM);
  conj(t, R, kU, kM);
  mul(t, R, X, kA, kA, kU);  // a = m^(x - 1)
  pow_x(t, R, X, kB, kA);
  conj(t, R, kU, kA);
  mul(t, R, X, kB, kB, kU);  // b = a^(x - 1)
  pow_x(t, R, X, kC, kB);
  frobenius(t, R, X, kU, kB, 1);
  mul(t, R, X, kC, kC, kU);  // c = b^(x + p)
  pow_x(t, R, X, kU, kC);
  pow_x(t, R, X, kD, kU);    // d = c^(x^2)
  frobenius(t, R, X, kU, kC, 2);
  mul(t, R, X, kD, kD, kU);
  conj(t, R, kU, kC);
  mul(t, R, X, kD, kD, kU);  // g = d c^(p^2) c^-1
  cyc_sqr(t, R, X, kU, kM);
  mul(t, R, X, kU, kU, kM);
  mul(t, R, X, kD, kD, kU);  // g m^3
}

// One subset's verdict: the product of its pairs' Miller values in the
// order given, one final exponentiation, is_one.  ``fs`` holds (n, 6, 2,
// 36) port limbs; ``members`` the subset's pair indices.  The Frobenius
// constants are loaded (tower::load_gammas).
FQ_HD bool subset_is_one(const team::Team& t, Fq2* R, Fq* X, const int64_t* fs,
                         const int32_t* members, int count) {
  constexpr int kPairLimbs = 12 * fq::kLimbs;
  if (count == 0) tower::set_one(t, R, tower::kF);
  for (int k = 0; k < count; ++k) {
    const int64_t* f = fs + static_cast<int64_t>(members[k]) * kPairLimbs;
    tower::load(t, R, k == 0 ? tower::kF : tower::kL, f);
    if (k > 0) tower::mul(t, R, X, tower::kF, tower::kF, tower::kL);
  }
  final_exp(t, R, X);
  return tower::is_one(R, tower::kD);
}

}  // namespace pairing
