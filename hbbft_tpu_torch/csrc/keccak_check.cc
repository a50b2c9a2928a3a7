// Host harness for keccak.cuh: the Keccak kernels' per-thread code, run on
// the CPU one thread after another.
//
// Built with a host C++ compiler (g++ -x c++ -std=c++17) in seconds;
// tests/test_torch_keccak_host.py drives it and holds every digest against
// hashlib, the port's plain sponge and tree, and the JAX package.  The
// port's entry points never load it.  Binary input on stdin, binary output
// on stdout:
//
//   keccak_check sponge BATCH NB OFFSET
//       stdin (BATCH, NB * 136) pre-padded bytes -> stdout (BATCH, 32)
//       digests, each message run as sha3_256_kernel's thread runs it
//   keccak_check tree V N S THREADS OFFSET
//       stdin (V, N, S) shard bytes -> stdout (V, 2 size - 1, 32): every
//       level of each value's tree, as merkle_tree_kernel's block runs it
//       with THREADS threads (0: the kernel's own count), its threads one
//       after another between the block's barriers
//
// OFFSET places the input that many bytes past a 16-byte boundary; the
// 16 bytes before and after it hold a filler, which no digest may see.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <iostream>
#include <stdexcept>
#include <string>
#include <vector>

#include "keccak.cuh"

namespace {

constexpr uint8_t kFiller = 0xA5;

// The input read from stdin at `offset` past a 16-byte boundary inside a
// 16-byte-aligned buffer, with `kFiller` around it.
struct Input {
  std::vector<uint8_t> buf;
  uint8_t* data;
};

Input read_input(size_t n, int offset) {
  Input in;
  in.buf.assign(n + offset + 64, kFiller);
  uint8_t* base = in.buf.data();
  base += (16 - reinterpret_cast<uintptr_t>(base) % 16) % 16;
  in.data = base + 16 + offset;
  if (n && std::fread(in.data, 1, n, stdin) != n) throw std::runtime_error("short input");
  return in;
}

void write_output(const std::vector<uint8_t>& out) {
  std::fwrite(out.data(), 1, out.size(), stdout);
}

struct Slots {
  alignas(16) uint32_t w[2][keccak::kSlotWords] = {};
  keccak::Ring ring() { return keccak::Ring{{w[0], w[1]}}; }
};

void sponge(long long batch, int nb, int offset) {
  const int64_t len = int64_t{nb} * keccak::kRate;
  Input in = read_input(static_cast<size_t>(batch * len), offset);
  std::vector<uint8_t> out(static_cast<size_t>(batch) * 32);
  Slots slots;
  for (long long msg = 0; msg < batch; ++msg) {
    const keccak::Message m{reinterpret_cast<uintptr_t>(in.data + msg * len), 0, len, -1, nb};
    keccak::State a;
    keccak::clear(a);
    keccak::absorb(a, m, slots.ring());
    uint32_t d[keccak::kDigestWords];
    keccak::digest(a, d);
    std::memcpy(out.data() + msg * 32, d, 32);
  }
  write_output(out);
}

void tree(int values, int n, int s, int threads, int offset) {
  Input in = read_input(static_cast<size_t>(values) * n * s, offset);
  const int size = keccak::tree_size(n);
  std::vector<uint8_t> out(static_cast<size_t>(values) * (2 * size - 1) * 32 + 16);
  uint8_t* o = out.data();
  o += (16 - reinterpret_cast<uintptr_t>(o) % 16) % 16;
  const keccak::Tree t{in.data, o, n, s, size};
  const int T = threads > 0 ? threads : keccak::tree_threads(size);
  Slots slots;
  for (int v = 0; v < values; ++v) {
    for (int th = 0; th < T; ++th) keccak::tree_leaves(t, v, th, T, slots.ring());
    int64_t at = size;
    for (int width = size / 2; width >= 1; width /= 2) {
      for (int th = 0; th < T; ++th) keccak::tree_level(t, v, th, T, at, width);
      at += width;
    }
  }
  write_output(std::vector<uint8_t>(o, o + static_cast<size_t>(values) * (2 * size - 1) * 32));
}

}  // namespace

int main(int argc, char** argv) {
  try {
    const std::string what = argc > 1 ? argv[1] : "";
    if (what == "sponge" && argc == 5) {
      sponge(std::atoll(argv[2]), std::atoi(argv[3]), std::atoi(argv[4]));
    } else if (what == "tree" && argc == 7) {
      tree(std::atoi(argv[2]), std::atoi(argv[3]), std::atoi(argv[4]), std::atoi(argv[5]),
           std::atoi(argv[6]));
    } else {
      std::cerr << "usage: keccak_check sponge BATCH NB OFFSET | tree V N S THREADS OFFSET\n";
      return 2;
    }
  } catch (const std::exception& e) {
    std::cerr << e.what() << "\n";
    return 1;
  }
  return 0;
}
