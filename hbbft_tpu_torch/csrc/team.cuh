// Lane teams: several lanes of one warp share the work of one row (the
// rows of scan_g1_rows and scan_g2_rows), of one addition (scan_g2_sums'
// tree) or of one subset (pair_final), so that the independent Fq products
// of a step run side by side instead of as one thread's chain.
//
// A team's state lives in shared memory: a file of slots (Fq2 slots and an
// exchange buffer of Fq parts; Fq slots for the G1 rows).  The work is a sequence of stages.  In a
// stage each lane runs the stage's function for its own lane index (and for
// index + width, index + 2 width, ... when a stage has more tasks than the
// team has lanes), then the warp meets at a barrier.  No lane reads, within
// a stage, a location another lane writes in it; so on the host, where one
// thread runs the lanes one after another (host_check.cc), a stage computes
// exactly what the card computes.  Values a formula keeps outside the
// stages (flags, slot choices) are the same for every lane of a team: each
// lane of the card computes them alike, the host once.
//
// The Fq2 products are split by Karatsuba part: a product a b is the three
// Fq products a0 b0, a1 b1 and (a0 + a1)(b0 + b1), a square a^2 the two
// (a0 + a1)(a0 - a1) and a0 (2 a1); each part is one lane's product (the
// out-of-line part function, operands read from shared memory).  A join
// stage then builds each component of the result on its own lane.  Over
// Fq slots a product is one lane's and needs no join, so a round of
// products is one stage (fq_round).

#pragma once

#include "fq.cuh"

// One out-of-line copy of each lane's product and join per kernel.
// Inlined at every bundle, a G2 step alone would hold a dozen copies of the
// CIOS code, more than the instruction cache keeps.
#if defined(__CUDACC__)
#define TEAM_CALL static __host__ __device__ __noinline__
#else
#define TEAM_CALL static inline
#endif

namespace team {

using fq::Fq;
using fq::Fq2;

struct Team {
  int lane;       // this thread's lane in the team (card only)
  int width;      // lanes in the team
  unsigned mask;  // the warp's lanes that meet at every barrier (card only)

  template <class F>
  FQ_HD void stage(int n, F&& f) const {
#if defined(__CUDA_ARCH__)
    for (int l = lane; l < n; l += width) f(l);
    __syncwarp(mask);
#else
    // One lane after another; the critical path takes the longest lane.
    const uint64_t start = fq::host_path;
    uint64_t longest = 0;
    for (int lane0 = 0; lane0 < width && lane0 < n; ++lane0) {
      fq::host_path = start;
      for (int l = lane0; l < n; l += width) f(l);
      if (fq::host_path - start > longest) longest = fq::host_path - start;
    }
    fq::host_path = start + longest;
#endif
  }
};

FQ_HD Fq& comp(Fq2& a, int c) { return c ? a.c1 : a.c0; }
FQ_HD const Fq& comp(const Fq2& a, int c) { return c ? a.c1 : a.c0; }

// Component c of xi a, xi = 1 + u: a0 - a1, a0 + a1.
FQ_HD Fq xi_comp(const Fq2& a, int c) { return c ? fq::add(a.c0, a.c1) : fq::sub(a.c0, a.c1); }

// One Fq2 product of a bundle: file[dst] = file[a] * file[b], or
// file[a]^2 when sq.
struct Prod {
  int dst, a, b;
  bool sq;
};

FQ_HD Prod mul(int dst, int a, int b) { return Prod{dst, a, b, false}; }
FQ_HD Prod sqr(int dst, int a) { return Prod{dst, a, a, true}; }
FQ_HD int parts(const Prod& o) { return o.sq ? 2 : 3; }

// Part k of the product o over the slot file R: one Fq product.
TEAM_CALL Fq part(Prod o, int k, const Fq2* R) {
  const Fq2& a = R[o.a];
  const Fq2& b = R[o.b];
  Fq x, y;
  if (o.sq) {
    x = k == 0 ? fq::add(a.c0, a.c1) : a.c0;
    y = k == 0 ? fq::sub(a.c0, a.c1) : fq::dbl(a.c1);
  } else {
    x = k == 0 ? a.c0 : k == 1 ? a.c1 : fq::add(a.c0, a.c1);
    y = k == 0 ? b.c0 : k == 1 ? b.c1 : fq::add(b.c0, b.c1);
  }
  return fq::mont_mul_in(x, y);
}

// Component c of the product o from its parts t: a square is (t0, t1); a
// product (t0 - t1, t2 - t0 - t1).
TEAM_CALL Fq join(Prod o, int c, const Fq* t) {
  if (o.sq) return t[c];
  return c ? fq::sub(fq::sub(t[2], t[0]), t[1]) : fq::sub(t[0], t[1]);
}

// A bundle of n independent products, desc(i) the i-th: one stage of
// parts (op i's parts packed after op i-1's in X) and one of joins.  No
// product of a bundle may read another's destination.
template <class D>
FQ_HD void prods(const Team& t, Fq2* R, Fq* X, int n, const D& desc) {
  int total = 0;
  for (int i = 0; i < n; ++i) total += parts(desc(i));
  t.stage(total, [&](int p) {
    int i = 0, base = 0;
    while (p >= base + parts(desc(i))) base += parts(desc(i++));
    X[p] = part(desc(i), p - base, R);
  });
  t.stage(2 * n, [&](int q) {
    const int i = q >> 1;
    int base = 0;
    for (int j = 0; j < i; ++j) base += parts(desc(j));
    const Prod o = desc(i);
    comp(R[o.dst], q & 1) = join(o, q & 1, X + base);
  });
}

// n products of one kind (all squares or all products), desc(i) the i-th:
// op i's parts at X[stride i ..], so no lane searches for its op.
template <class D>
FQ_HD void prods_of(const Team& t, Fq2* R, Fq* X, int n, bool sq, const D& desc) {
  const int stride = sq ? 2 : 3;
  t.stage(stride * n, [&](int p) { X[p] = part(desc(p / stride), p % stride, R); });
  t.stage(2 * n, [&](int q) {
    const Prod o = desc(q >> 1);
    comp(R[o.dst], q & 1) = join(o, q & 1, X + stride * (q >> 1));
  });
}

// Two or three products given one by one.
FQ_HD void prods(const Team& t, Fq2* R, Fq* X, const Prod& o0, const Prod& o1) {
  prods(t, R, X, 2, [&](int i) { return i == 0 ? o0 : o1; });
}

FQ_HD void prods(const Team& t, Fq2* R, Fq* X, const Prod& o0, const Prod& o1,
                 const Prod& o2) {
  prods(t, R, X, 3, [&](int i) { return i == 0 ? o0 : i == 1 ? o1 : o2; });
}

// A round of Fq products of up to three formulas run side by side (Fq
// slots, no join): n0 + n1 + n2 products in one stage; part(i, k) runs
// product k of the round's formula i, one out-of-line call.
template <class P>
FQ_HD void fq_round(const Team& t, int n0, int n1, int n2, const P& part) {
  t.stage(n0 + n1 + n2, [&](int task) {
    const int i = task < n0 ? 0 : task < n0 + n1 ? 1 : 2;
    part(i, task - (i > 0 ? n0 : 0) - (i > 1 ? n1 : 0));
  });
}

}  // namespace team
