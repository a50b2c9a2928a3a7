// Host harness for the kernel arithmetic of fq.cuh, curve.cuh, fq12.cuh
// and pairing.cuh.
//
// Built with a host C++ compiler (g++ -x c++ -std=c++17), so the headers'
// portable path runs on the CPU; tests/test_torch_kernel_host.py and
// tests/test_torch_pair_host.py drive it and hold every answer against
// Python integers and the BLS oracle.  The port's entry points never load
// it.
//
// One request per input line, whitespace-separated decimal integers after a
// tag; one answer line each:
//
//   M  a[36] b[36]           -> the port's mont_mul: 36 limbs
//   R  a[36]                 -> a through the entry and exit conversions
//                               (port form -> kernel form -> port form)
//   F2 a[72] b[72]           -> Fq2 mul, sqr, conj, mul_by_xi, add, sub,
//                               neg of the kernel ops, 7 x 72 limbs
//   G1 x[36] y[36] z[36] inf c[4]
//                            -> [c]P as x, y, z limbs, inf, then the
//                               subgroup verdict (0 or 1), by the
//                               eight-lane team of scan_g1_rows
//   G2 x[72] y[72] z[72] inf s[2] q[3]
//                            -> [c]Q likewise, c = q |x| + s, by the
//                               two six-lane teams of scan_g2_rows
//   G2S n n_pieces n_seg (x[72] y[72] z[72] inf) x n pieces[n_pieces + 1]
//       segments[n_seg + 1]
//                            -> scan_g2_sums' two passes over the n
//                               points (pieces of points, then segments
//                               of pieces): each segment's sum as x, y,
//                               z limbs and inf
//   G1S n n_pieces n_seg (x[36] y[36] z[36] inf) x n pieces[n_pieces + 1]
//       segments[n_seg + 1]
//                            -> scan_g1_sums' two passes likewise
//   I  a[36]                 -> the Fermat inverse: 36 limbs
//   I2 a[72] s[36]           -> the Fq2 inverse of a, then a * s: 2 x 72
//   GAM g[144]               -> (empty) sets the Frobenius constants for
//                               k = 1, 2, (2, 6, 2, 36) limbs
//   F12 a[432] b[432]        -> pair_miller's a^2 and a (b0 + b2 w^2 + b3
//                               w^3) on its team, the w-basis conj(a),
//                               then pair_final's tower ops mul(a, b),
//                               conj(a), frobenius(a, k) for k = 1, 2 and
//                               inv(a): 8 x 432 limbs, then is_one(a)
//   CS f[432]                -> for f in the cyclotomic subgroup: the
//                               Granger-Scott square, the product f f and
//                               f^x: 3 x 432 limbs
//   TW a[432]                -> a in the tower's slot order, then back in
//                               the w basis: 2 x 432 limbs
//   ML x[36] y[36] z[36] inf x[72] y[72] z[72] inf
//                            -> pair_miller's value for one (G1, G2)
//                               pair on its team of 32 lanes: 432 limbs
//   FE f[432]                -> the final exponentiation f^(3 (p^12-1)/r):
//                               432 limbs, then is_one of it
//   PF n n_sub f[n * 432] offsets[n_sub + 1] members[n]
//                            -> pair_final's verdicts, n_sub values
//   N                        -> the Fq products since the last N and their
//                               critical path (2 values)
//
// The lane-team code (the rows of scan_g1_rows and scan_g2_rows, the
// trees of scan_g1_sums and scan_g2_sums, pair_miller's pairs and
// pair_final's subsets) runs its lanes, and the
// teams and blocks that the card runs side by side, one after another here
// (team.cuh); the critical path takes the longest of each.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <iostream>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "curve.cuh"
#include "pairing.cuh"

namespace {

std::vector<int64_t> read_ints(std::istringstream& in, int n) {
  std::vector<int64_t> v(n);
  for (int i = 0; i < n; ++i) in >> v[i];
  if (!in) throw std::runtime_error("short request");
  return v;
}

void put(const int64_t* v, int n) {
  for (int i = 0; i < n; ++i) std::cout << ' ' << v[i];
}

void put_fq2(const fq::Fq2& a) {
  int64_t limbs[2 * fq::kLimbs];
  fq::to_port2(a, limbs);
  put(limbs, 2 * fq::kLimbs);
}

constexpr int kFq12Limbs = 12 * fq::kLimbs;

void put_fq12(const fq12::Fq12& a) {
  int64_t limbs[kFq12Limbs];
  fq12::to_port12(a, limbs);
  put(limbs, kFq12Limbs);
}

curve::G1 read_g1(std::istringstream& in) {
  auto x = read_ints(in, fq::kLimbs), y = read_ints(in, fq::kLimbs),
       z = read_ints(in, fq::kLimbs), inf = read_ints(in, 1);
  return curve::G1{fq::from_port(x.data()), fq::from_port(y.data()), fq::from_port(z.data()),
                   inf[0] != 0 ? 1u : 0u};
}

curve::G2 read_g2(std::istringstream& in) {
  auto x = read_ints(in, 2 * fq::kLimbs), y = read_ints(in, 2 * fq::kLimbs),
       z = read_ints(in, 2 * fq::kLimbs), inf = read_ints(in, 1);
  return curve::G2{fq::from_port2(x.data()), fq::from_port2(y.data()),
                   fq::from_port2(z.data()), inf[0] != 0 ? 1u : 0u};
}

// pair_final's shared file, its exchange buffer and its team of 32 lanes;
// GAM loads the Frobenius constants into the file.
fq::Fq2 pf_file[tower::kSlots];
fq::Fq pf_xch[tower::kParts];
const team::Team pf_team{0, tower::kLanes, 0};

// A w-basis value into the file's slots at `at`, and back.
void put_tower(const fq12::Fq12& a, int at) {
  for (int i = 0; i < 6; ++i) pf_file[at + tower::slot_of(i)] = a.c[i];
}

fq12::Fq12 get_tower(int at) {
  fq12::Fq12 r;
  for (int i = 0; i < 6; ++i) r.c[i] = pf_file[at + tower::slot_of(i)];
  return r;
}

// scan_g2_sums' block: its file, flags and exchange buffers, and its
// teams one after another.
namespace g2tree = curve::g2team;
fq::Fq2 tree_file[g2tree::kTreeSlots];
uint32_t tree_flag[g2tree::kTreePoints];
fq::Fq tree_xch[g2tree::kLanes * g2tree::kTreeTeams];

struct HostTeams {
  template <class F>
  void run(int m, F&& f) const {
    team::Team{0, m, 0}.stage(m, [&](int j) {
      f(team::Team{0, g2tree::kLanes, 0}, j, tree_xch + g2tree::kLanes * j);
    });
  }
};

constexpr int kG2Words = 6 * fq::kWords;  // a point's words; its flag follows

// One block of scan_g2_sums: records [lo, hi) of recs (kG2Words + 1 words
// each) summed into point 0 of the block's file.
void block_sum(const std::vector<uint32_t>& recs, int lo, int hi) {
  g2tree::sum(HostTeams{}, tree_file, tree_flag, hi - lo, [&](int dst, int from, int m) {
    for (int r = 0; r < m; ++r) {
      const uint32_t* src = &recs[static_cast<size_t>(lo + from + r) * (kG2Words + 1)];
      std::memcpy(&tree_file[3 * (dst + r)], src, kG2Words * sizeof(uint32_t));
      tree_flag[dst + r] = src[kG2Words];
    }
  });
}

// scan_g1_sums' block likewise, teams of four lanes.
namespace g1tree = curve::g1team;
fq::Fq g1_tree_file[g1tree::kTreeSlots];
uint32_t g1_tree_flag[g1tree::kTreePoints];

struct HostG1Teams {
  template <class F>
  void run(int m, F&& f) const {
    team::Team{0, m, 0}.stage(m, [&](int j) { f(team::Team{0, g1tree::kSumLanes, 0}, j); });
  }
};

constexpr int kG1Words = 3 * fq::kWords;

void g1_block_sum(const std::vector<uint32_t>& recs, int lo, int hi) {
  g1tree::sum(HostG1Teams{}, g1_tree_file, g1_tree_flag, hi - lo, [&](int dst, int from, int m) {
    for (int r = 0; r < m; ++r) {
      const uint32_t* src = &recs[static_cast<size_t>(lo + from + r) * (kG1Words + 1)];
      std::memcpy(&g1_tree_file[3 * (dst + r)], src, kG1Words * sizeof(uint32_t));
      g1_tree_flag[dst + r] = src[kG1Words];
    }
  });
}

namespace ml = pairing::ml;

// pair_miller's f^2 and f * (l0 + l2 w^2 + l3 w^3) alone, on f at ml::kF
// and the line at ml::kL0, kL2, kL3: the task functions of its steps,
// each product bundle and linear stage on its own.
void ml_sqr(const team::Team& t, fq::Fq2* R, fq::Fq* X) {
  t.stage(36, [&](int l) { ml::at(R, ml::kSS + (l >> 1), l & 1) = ml::sq_sum(R, l >> 1, l & 1); });
  team::prods(t, R, X, 12, [&](int i) { return ml::sq_prod(i); });
  t.stage(12, [&](int l) { ml::sq_fq6(R, l); });
  t.stage(12, [&](int l) { ml::sq_out(R, l); });
}

void ml_line(const team::Team& t, fq::Fq2* R, fq::Fq* X) {
  t.stage(16, [&](int l) {
    if (l < 10) {
      ml::line_sum(R, l);
      return;
    }
    ml::line_sums(R, l - 10, ml::at(R, ml::kL0, l & 1));
  });
  team::prods(t, R, X, 13, [&](int i) { return ml::line_prod(i); });
  t.stage(12, [&](int l) { ml::line_out(R, l); });
}

// pair_miller's file and exchange buffer, and its team of 32 lanes.
fq::Fq2 ml_file[pairing::ml::kSlots];
fq::Fq ml_xch[pairing::ml::kParts];
const team::Team ml_team{0, pairing::ml::kLanes, 0};

}  // namespace

int main() {
  std::ios::sync_with_stdio(false);
  std::string line;
  while (std::getline(std::cin, line)) {
    std::istringstream in(line);
    std::string tag;
    in >> tag;
    if (tag.empty()) continue;
    if (tag == "M") {
      auto a = read_ints(in, fq::kLimbs), b = read_ints(in, fq::kLimbs);
      int64_t out[fq::kLimbs];
      fq::port_mont_mul(a.data(), b.data(), out);
      put(out, fq::kLimbs);
    } else if (tag == "R") {
      auto a = read_ints(in, fq::kLimbs);
      int64_t out[fq::kLimbs];
      fq::to_port(fq::from_port(a.data()), out);
      put(out, fq::kLimbs);
    } else if (tag == "F2") {
      auto a = read_ints(in, 2 * fq::kLimbs), b = read_ints(in, 2 * fq::kLimbs);
      const fq::Fq2 x = fq::from_port2(a.data()), y = fq::from_port2(b.data());
      put_fq2(fq::mul(x, y));
      put_fq2(fq::sqr(x));
      put_fq2(fq::conj(x));
      put_fq2(fq::mul_by_xi(x));
      put_fq2(fq::add(x, y));
      put_fq2(fq::sub(x, y));
      put_fq2(fq::neg(x));
    } else if (tag == "G1") {
      auto x = read_ints(in, fq::kLimbs), y = read_ints(in, fq::kLimbs),
           z = read_ints(in, fq::kLimbs), inf = read_ints(in, 1), c = read_ints(in, 4);
      uint32_t words[4];
      for (int i = 0; i < 4; ++i) words[i] = static_cast<uint32_t>(c[i]);
      fq::Fq file[curve::g1team::kSlots];
      const team::Team t{0, curve::g1team::kLanes, 0};
      curve::g1team::load(t, file, x.data(), y.data(), z.data());
      uint32_t acc_inf = 0;
      const bool ok = curve::g1team::row(t, file, inf[0] != 0 ? 1u : 0u, words, &acc_inf);
      // The kernel writes internal records: the limbs here are not counted.
      const uint64_t products = fq::host_products, path = fq::host_path;
      int64_t limbs[fq::kLimbs];
      for (int k = 0; k < 3; ++k) {
        fq::to_port(file[curve::g1team::kAcc + k], limbs);
        put(limbs, fq::kLimbs);
      }
      fq::host_products = products;
      fq::host_path = path;
      std::cout << ' ' << acc_inf << ' ' << (ok ? 1 : 0);
    } else if (tag == "G2") {
      auto x = read_ints(in, 2 * fq::kLimbs), y = read_ints(in, 2 * fq::kLimbs),
           z = read_ints(in, 2 * fq::kLimbs), inf = read_ints(in, 1), sq = read_ints(in, 5);
      uint32_t words[5];
      for (int i = 0; i < 5; ++i) words[i] = static_cast<uint32_t>(sq[i]);
      const uint32_t base_inf = inf[0] != 0 ? 1u : 0u;
      // The two teams scan_g2_rows gives a row, each on its own file and in
      // its own warp: two lanes of an outer team, for the path count.
      const team::Team t{0, curve::g2team::kLanes, 0};
      fq::Fq2 scan_file[curve::g2team::kSlots], check_file[curve::g2team::kSlots];
      fq::Fq xch[curve::g2team::kLanes];
      uint32_t acc_inf = 0;
      bool ok = false;
      team::Team{0, 2, 0}.stage(2, [&](int warp) {
        fq::Fq2* file = warp == 0 ? scan_file : check_file;
        curve::g2team::load(t, file, x.data(), y.data(), z.data());
        if (warp == 0) {
          acc_inf = curve::g2team::scan_row(t, file, xch, base_inf, words);
        } else {
          ok = curve::g2team::check_row(t, file, xch, base_inf);
        }
      });
      for (int c = 0; c < 3; ++c) put_fq2(scan_file[curve::g2team::kP3 + c]);
      std::cout << ' ' << acc_inf << ' ' << (ok ? 1 : 0);
    } else if (tag == "G2S") {
      auto dims = read_ints(in, 3);
      const int n = static_cast<int>(dims[0]), n_pieces = static_cast<int>(dims[1]),
                n_seg = static_cast<int>(dims[2]);
      // The row records, converted outside the counts (scan_g2_rows writes
      // them on the card).
      std::vector<uint32_t> rows(static_cast<size_t>(n) * (kG2Words + 1));
      const uint64_t products = fq::host_products, path = fq::host_path;
      for (int i = 0; i < n; ++i) {
        const curve::G2 p = read_g2(in);
        uint32_t* rec = &rows[static_cast<size_t>(i) * (kG2Words + 1)];
        std::memcpy(rec, &p, kG2Words * sizeof(uint32_t));
        rec[kG2Words] = p.inf;
      }
      fq::host_products = products;
      fq::host_path = path;
      auto pieces = read_ints(in, n_pieces + 1), segments = read_ints(in, n_seg + 1);
      // Pass 1: a block per piece, side by side; pass 2: a block per segment.
      std::vector<uint32_t> partial(static_cast<size_t>(n_pieces) * (kG2Words + 1));
      team::Team{0, n_pieces, 0}.stage(n_pieces, [&](int q) {
        block_sum(rows, static_cast<int>(pieces[q]), static_cast<int>(pieces[q + 1]));
        uint32_t* rec = &partial[static_cast<size_t>(q) * (kG2Words + 1)];
        std::memcpy(rec, tree_file, kG2Words * sizeof(uint32_t));
        rec[kG2Words] = tree_flag[0];
      });
      std::vector<int64_t> limbs(static_cast<size_t>(n_seg) * (6 * fq::kLimbs + 1));
      team::Team{0, n_seg, 0}.stage(n_seg, [&](int g) {
        block_sum(partial, static_cast<int>(segments[g]), static_cast<int>(segments[g + 1]));
        int64_t* out = &limbs[static_cast<size_t>(g) * (6 * fq::kLimbs + 1)];
        g2tree::store(team::Team{0, g2tree::kLanes, 0}, tree_file, 0, out, out + 2 * fq::kLimbs,
                      out + 4 * fq::kLimbs);
        out[6 * fq::kLimbs] = tree_flag[0];
      });
      put(limbs.data(), static_cast<int>(limbs.size()));
    } else if (tag == "G1S") {
      auto dims = read_ints(in, 3);
      const int n = static_cast<int>(dims[0]), n_pieces = static_cast<int>(dims[1]),
                n_seg = static_cast<int>(dims[2]);
      // The row records, converted outside the counts (scan_g1_rows writes
      // them on the card).
      std::vector<uint32_t> rows(static_cast<size_t>(n) * (kG1Words + 1));
      const uint64_t products = fq::host_products, path = fq::host_path;
      for (int i = 0; i < n; ++i) {
        const curve::G1 p = read_g1(in);
        uint32_t* rec = &rows[static_cast<size_t>(i) * (kG1Words + 1)];
        std::memcpy(rec, &p, kG1Words * sizeof(uint32_t));
        rec[kG1Words] = p.inf;
      }
      fq::host_products = products;
      fq::host_path = path;
      auto pieces = read_ints(in, n_pieces + 1), segments = read_ints(in, n_seg + 1);
      // Pass 1: a block per piece, side by side; pass 2: a block per segment.
      std::vector<uint32_t> partial(static_cast<size_t>(n_pieces) * (kG1Words + 1));
      team::Team{0, n_pieces, 0}.stage(n_pieces, [&](int q) {
        g1_block_sum(rows, static_cast<int>(pieces[q]), static_cast<int>(pieces[q + 1]));
        uint32_t* rec = &partial[static_cast<size_t>(q) * (kG1Words + 1)];
        std::memcpy(rec, g1_tree_file, kG1Words * sizeof(uint32_t));
        rec[kG1Words] = g1_tree_flag[0];
      });
      std::vector<int64_t> limbs(static_cast<size_t>(n_seg) * (3 * fq::kLimbs + 1));
      team::Team{0, n_seg, 0}.stage(n_seg, [&](int g) {
        g1_block_sum(partial, static_cast<int>(segments[g]), static_cast<int>(segments[g + 1]));
        int64_t* out = &limbs[static_cast<size_t>(g) * (3 * fq::kLimbs + 1)];
        // Three lanes write x, y, z.
        team::Team{0, 3, 0}.stage(3, [&](int c) {
          fq::to_port(g1_tree_file[c], out + c * fq::kLimbs);
        });
        out[3 * fq::kLimbs] = g1_tree_flag[0];
      });
      put(limbs.data(), static_cast<int>(limbs.size()));
    } else if (tag == "I") {
      auto a = read_ints(in, fq::kLimbs);
      int64_t out[fq::kLimbs];
      fq::to_port(fq::inv(fq::from_port(a.data())), out);
      put(out, fq::kLimbs);
    } else if (tag == "I2") {
      auto a = read_ints(in, 2 * fq::kLimbs), s = read_ints(in, fq::kLimbs);
      const fq::Fq2 x = fq::from_port2(a.data());
      put_fq2(fq::inv(x));
      put_fq2(fq::mul_fq(x, fq::from_port(s.data())));
    } else if (tag == "GAM") {
      auto g = read_ints(in, 2 * 6 * 2 * fq::kLimbs);
      tower::load_gammas(pf_team, pf_file, g.data());
    } else if (tag == "F12") {
      auto a = read_ints(in, kFq12Limbs), b = read_ints(in, kFq12Limbs);
      const fq12::Fq12 x = fq12::from_port12(a.data()), y = fq12::from_port12(b.data());
      // pair_miller's square and line product on its team: f at ml::kF,
      // the line at ml::kL0, kL2, kL3.
      for (int k = 0; k < 2; ++k) {
        for (int i = 0; i < 6; ++i) ml_file[ml::kF + tower::slot_of(i)] = x.c[i];
        ml_file[ml::kL0] = y.c[0];
        ml_file[ml::kL2] = y.c[2];
        ml_file[ml::kL3] = y.c[3];
        if (k == 0) {
          ml_sqr(ml_team, ml_file, ml_xch);
        } else {
          ml_line(ml_team, ml_file, ml_xch);
        }
        fq12::Fq12 r;
        for (int i = 0; i < 6; ++i) r.c[i] = ml_file[ml::kF + tower::slot_of(i)];
        put_fq12(r);
      }
      put_fq12(fq12::conj(x));
      put_tower(x, tower::kA);
      put_tower(y, tower::kB);
      const team::Team& t = pf_team;
      tower::mul(t, pf_file, pf_xch, tower::kC, tower::kA, tower::kB);
      put_fq12(get_tower(tower::kC));
      tower::conj(t, pf_file, tower::kC, tower::kA);
      put_fq12(get_tower(tower::kC));
      for (int k : {1, 2}) {
        tower::frobenius(t, pf_file, pf_xch, tower::kC, tower::kA, k);
        put_fq12(get_tower(tower::kC));
      }
      tower::inv(t, pf_file, pf_xch, tower::kC, tower::kA);
      put_fq12(get_tower(tower::kC));
      std::cout << ' ' << (tower::is_one(pf_file, tower::kA) ? 1 : 0);
    } else if (tag == "CS") {
      auto f = read_ints(in, kFq12Limbs);
      put_tower(fq12::from_port12(f.data()), tower::kA);
      const team::Team& t = pf_team;
      tower::cyc_sqr(t, pf_file, pf_xch, tower::kC, tower::kA);
      put_fq12(get_tower(tower::kC));
      tower::mul(t, pf_file, pf_xch, tower::kC, tower::kA, tower::kA);
      put_fq12(get_tower(tower::kC));
      tower::pow_x(t, pf_file, pf_xch, tower::kC, tower::kA);
      put_fq12(get_tower(tower::kC));
    } else if (tag == "TW") {
      auto a = read_ints(in, kFq12Limbs);
      put_tower(fq12::from_port12(a.data()), tower::kA);
      for (int s = 0; s < 6; ++s) put_fq2(pf_file[tower::kA + s]);
      put_fq12(get_tower(tower::kA));
    } else if (tag == "ML") {
      auto x = read_ints(in, fq::kLimbs), y = read_ints(in, fq::kLimbs),
           z = read_ints(in, fq::kLimbs), inf = read_ints(in, 1);
      auto qx = read_ints(in, 2 * fq::kLimbs), qy = read_ints(in, 2 * fq::kLimbs),
           qz = read_ints(in, 2 * fq::kLimbs), qinf = read_ints(in, 1);
      int64_t out[kFq12Limbs];
      pairing::ml::value(ml_team, ml_file, ml_xch, x.data(), y.data(), z.data(), inf[0] != 0,
                         qx.data(), qy.data(), qz.data(), qinf[0] != 0, out);
      put(out, kFq12Limbs);
    } else if (tag == "FE") {
      auto f = read_ints(in, kFq12Limbs);
      tower::load(pf_team, pf_file, tower::kF, f.data());
      pairing::final_exp(pf_team, pf_file, pf_xch);
      put_fq12(get_tower(tower::kD));
      std::cout << ' ' << (tower::is_one(pf_file, tower::kD) ? 1 : 0);
    } else if (tag == "PF") {
      auto dims = read_ints(in, 2);
      const int n = static_cast<int>(dims[0]), n_sub = static_cast<int>(dims[1]);
      auto fs = read_ints(in, n * kFq12Limbs);
      auto offsets = read_ints(in, n_sub + 1), members = read_ints(in, n);
      std::vector<int32_t> idx(members.begin(), members.end());
      for (int s = 0; s < n_sub; ++s) {
        const int lo = static_cast<int>(offsets[s]);
        const bool ok = pairing::subset_is_one(pf_team, pf_file, pf_xch, fs.data(), idx.data() + lo,
                                               static_cast<int>(offsets[s + 1]) - lo);
        std::cout << ' ' << (ok ? 1 : 0);
      }
    } else if (tag == "N") {
      std::cout << ' ' << fq::host_products << ' ' << fq::host_path;
      fq::host_products = 0;
      fq::host_path = 0;
    } else {
      std::cerr << "unknown request " << tag << "\n";
      return 2;
    }
    std::cout << '\n';
  }
  return 0;
}
