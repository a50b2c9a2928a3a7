// Host harness for the kernel arithmetic of fq.cuh and curve.cuh.
//
// Built with a host C++ compiler (g++ -x c++ -std=c++17), so the headers'
// portable path runs on the CPU; tests/test_torch_kernel_host.py drives it
// and holds every answer against Python integers and the BLS oracle.  The
// port's entry points never load it.
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

#include <cstdint>
#include <cstdio>
#include <iostream>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "curve.cuh"

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
    } else {
      std::cerr << "unknown request " << tag << "\n";
      return 2;
    }
    std::cout << '\n';
  }
  return 0;
}
