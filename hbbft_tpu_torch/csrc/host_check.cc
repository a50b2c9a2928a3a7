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
//                               subgroup verdict (0 or 1)
//   G2 x[72] y[72] z[72] inf s[2] q[3]
//                            -> [c]Q likewise, c = q |x| + s
//   I  a[36]                 -> the Fermat inverse: 36 limbs
//   I2 a[72] s[36]           -> the Fq2 inverse of a, then a * s: 2 x 72
//   GAM g[360]               -> (empty) sets the Frobenius constants for
//                               k = 1, 2, 4, 8, 10, (5, 6, 2, 36) limbs
//   F12 a[432] b[432]        -> Fq12 mul(a, b), sqr(a), sparse_mul(a, b0,
//                               b2, b3), conj(a), frobenius(a, k) for k =
//                               1, 2, 4, 8, 10, inv(a), pow_x_abs(a):
//                               11 x 432 limbs, then is_one(a)
//   ML x[36] y[36] z[36] inf x[72] y[72] z[72] inf
//                            -> pair_miller's value for one (G1, G2)
//                               pair: 432 limbs
//   FE f[432]                -> the final exponentiation f^(3 (p^12-1)/r):
//                               432 limbs, then is_one of it
//   PF n n_sub f[n * 432] offsets[n_sub + 1] members[n]
//                            -> pair_final's verdicts, n_sub values
//   N                        -> the Fq products since the last N (1 value)

#include <cstdint>
#include <cstdio>
#include <iostream>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

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

// The Frobenius constants, as pair_final converts them into shared memory.
fq::Fq2 gammas[fq12::kGammaSlots * 6];

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
      const curve::G1 base{fq::from_port(x.data()), fq::from_port(y.data()),
                           fq::from_port(z.data()), inf[0] != 0 ? 1u : 0u};
      uint32_t words[4];
      for (int i = 0; i < 4; ++i) words[i] = static_cast<uint32_t>(c[i]);
      bool ok = false;
      const curve::G1 s = curve::rlc_g1_row(base, words, &ok);
      int64_t limbs[fq::kLimbs];
      for (const fq::Fq* f : {&s.x, &s.y, &s.z}) {
        fq::to_port(*f, limbs);
        put(limbs, fq::kLimbs);
      }
      std::cout << ' ' << s.inf << ' ' << (ok ? 1 : 0);
    } else if (tag == "G2") {
      auto x = read_ints(in, 2 * fq::kLimbs), y = read_ints(in, 2 * fq::kLimbs),
           z = read_ints(in, 2 * fq::kLimbs), inf = read_ints(in, 1), sq = read_ints(in, 5);
      const curve::G2 base{fq::from_port2(x.data()), fq::from_port2(y.data()),
                           fq::from_port2(z.data()), inf[0] != 0 ? 1u : 0u};
      uint32_t words[5];
      for (int i = 0; i < 5; ++i) words[i] = static_cast<uint32_t>(sq[i]);
      bool ok = false;
      const curve::G2 s = curve::rlc_g2_row(base, words, &ok);
      put_fq2(s.x);
      put_fq2(s.y);
      put_fq2(s.z);
      std::cout << ' ' << s.inf << ' ' << (ok ? 1 : 0);
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
      auto g = read_ints(in, fq12::kGammaSlots * 6 * 2 * fq::kLimbs);
      for (int t = 0; t < fq12::kGammaSlots * 6; ++t)
        gammas[t] = fq::from_port2(g.data() + 2 * fq::kLimbs * t);
    } else if (tag == "F12") {
      auto a = read_ints(in, kFq12Limbs), b = read_ints(in, kFq12Limbs);
      const fq12::Fq12 x = fq12::from_port12(a.data()), y = fq12::from_port12(b.data());
      put_fq12(fq12::mul(x, y));
      put_fq12(fq12::sqr(x));
      put_fq12(fq12::sparse_mul(x, y.c[0], y.c[2], y.c[3]));
      put_fq12(fq12::conj(x));
      for (int k : {1, 2, 4, 8, 10}) put_fq12(fq12::frobenius(x, k, gammas));
      put_fq12(fq12::inv(x, gammas));
      put_fq12(fq12::pow_x_abs(x));
      std::cout << ' ' << (fq12::is_one(x) ? 1 : 0);
    } else if (tag == "ML") {
      const curve::G1 p = read_g1(in);
      const curve::G2 q = read_g2(in);
      put_fq12(pairing::miller_value(p, q));
    } else if (tag == "FE") {
      auto f = read_ints(in, kFq12Limbs);
      const fq12::Fq12 e = pairing::final_exp(fq12::from_port12(f.data()), gammas);
      put_fq12(e);
      std::cout << ' ' << (fq12::is_one(e) ? 1 : 0);
    } else if (tag == "PF") {
      auto dims = read_ints(in, 2);
      const int n = static_cast<int>(dims[0]), n_sub = static_cast<int>(dims[1]);
      auto fs = read_ints(in, n * kFq12Limbs);
      auto offsets = read_ints(in, n_sub + 1), members = read_ints(in, n);
      std::vector<int32_t> idx(members.begin(), members.end());
      for (int s = 0; s < n_sub; ++s) {
        const int lo = static_cast<int>(offsets[s]);
        const bool ok = pairing::subset_is_one(fs.data(), idx.data() + lo,
                                               static_cast<int>(offsets[s + 1]) - lo, gammas);
        std::cout << ' ' << (ok ? 1 : 0);
      }
    } else if (tag == "N") {
      std::cout << ' ' << fq::host_products;
      fq::host_products = 0;
    } else {
      std::cerr << "unknown request " << tag << "\n";
      return 2;
    }
    std::cout << '\n';
  }
  return 0;
}
