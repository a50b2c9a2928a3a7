"""Measure the integer issue rate behind the Keccak kernels on one CUDA card.

The Keccak kernels (``hbbft_tpu_torch/csrc/keccak.cu``) are bound by
32-bit logic instructions: LOP3 (three-input logic) and SHF (funnel
shift).  ``chip_smoke.py``'s bound takes the data sheet's 64 of them per
SM per clock.  This script measures what the card sustains and where the
sponge kernel's time goes, from probes in ``csrc/keccak_probe.cu``:

1. LOP3 and SHF alone: 16 independent chains a thread, one block per SM
   at 1, 2, 4 and 8 warps per SM partition; each block's SM clocks from
   ``clock64``, the rate as instructions per SM per clock;
2. ``keccak_sha3_256`` (the port's wrapper) at 1, 2 and 4 warps per
   partition (16,896, 33,792 and 67,584 messages, blocks of 128 threads)
   at 1 and 14 blocks a message, as 32-bit operations of the bound's
   count (4,343 a permutation) per SM per clock;
3. at the data plane's leaf shape (10,816 messages x 14 blocks): the
   kernel, its staging and absorb without the permutation, and the
   permutations without the loads.

Clock rates are the probes' SM clocks over their CUDA-event times.  Run
from the repository root on a machine with one CUDA card:

    python3 benchmarks_torch/keccak_rate.py

It prints one line per measurement and, last, one JSON object with every
number.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from hbbft_tpu_torch import build  # noqa: E402
from hbbft_tpu_torch.ops.device import keccak as K  # noqa: E402

SMS = 132
PARTITIONS = 4 * SMS
ITERS = 20_000
CHAINS = 16
VARIANTS = {"loads only": 0, "permutations only": 1}


def probes():
    lib = build.load("keccak_probe")
    alu, sponge = lib.hbbft_probe_alu, lib.hbbft_probe_sponge
    alu.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    sponge.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
    alu.restype = sponge.restype = ctypes.c_int
    return alu, sponge


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def alu_rate(alu, op: int, warps_per_partition: int) -> dict:
    threads = 4 * 32 * warps_per_partition
    out = torch.empty(SMS * threads, dtype=torch.int32, device="cuda")
    cycles = torch.empty(SMS, dtype=torch.int64, device="cuda")
    run = lambda: build.check(alu(op, SMS, threads, ITERS, out.data_ptr(), cycles.data_ptr(),
                                  stream()), "hbbft_probe_alu")
    ms = cs.cuda_time_ms(run, 5)
    clocks = int(cycles.max())
    per_clock = threads * ITERS * CHAINS / clocks
    return {"per_sm_per_clock": per_clock, "sm_clocks": clocks, "ms": ms,
            "clock_ghz": clocks / (ms * 1e6)}


def sponge_ms(sponge, variant: int, padded: torch.Tensor, out: torch.Tensor) -> float:
    batch, nb = padded.shape[0], padded.shape[1] // K.RATE
    run = lambda: build.check(sponge(variant, padded.data_ptr(), out.data_ptr(), batch, nb,
                                     stream()), "hbbft_probe_sponge")
    return cs.cuda_time_ms(run, 20)


def main() -> int:
    if not torch.cuda.is_available():
        print("keccak_rate: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    build.build_all(["keccak", "keccak_probe"], verbose=True)
    for source, fn in (("keccak", "sha3_256_kernel"), ("keccak", "merkle_tree_kernel"),
                       ("keccak_probe", "loads_only"), ("keccak_probe", "perm_only")):
        print(cs.sass_summary(source, fn, function=fn), flush=True)
    alu, sponge = probes()
    result = {"card": card, "alu": {}, "sponge": {}, "leaf_shape": {}}

    clock = []
    for name, op in (("LOP3", 0), ("SHF", 1)):
        for w in (1, 2, 4, 8):
            r = alu_rate(alu, op, w)
            clock.append(r["clock_ghz"])
            result["alu"][f"{name} {w} warps/partition"] = r
            print(f"{name} at {w} warps per partition: {r['per_sm_per_clock']:.2f} per SM per "
                  f"clock ({r['sm_clocks']} SM clocks, {r['ms']:.4f} ms, "
                  f"{r['clock_ghz']:.3f} GHz)  [{card}]", flush=True)
    ghz = statistics.median(clock)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for nb in (1, 14):
        for w in (1, 2, 4):
            batch = PARTITIONS * 32 * w
            msgs = torch.randint(0, 256, (batch, nb * K.RATE - 1), dtype=torch.uint8,
                                 device="cuda", generator=gen)
            padded = K.pad_tensor(msgs)
            ms = cs.cuda_time_ms(lambda: K.sha3_256_kernel(padded), 20)
            ops = batch * nb * cs.KECCAK_INT32_OPS_PER_PERM
            per_clock = ops / (ms * 1e-3 * ghz * 1e9) / SMS
            result["sponge"][f"{batch}x{nb}"] = {"ms": ms, "ops_per_sm_per_clock": per_clock}
            print(f"keccak_sha3_256 {batch} msgs x {nb} blocks ({w} warps per partition): "
                  f"{ms:.4f} ms = {per_clock:.2f} bound-count int32 ops per SM per clock at "
                  f"{ghz:.3f} GHz  [{card}]", flush=True)

    batch, nb = 104 * 104, 14
    msgs = torch.randint(0, 256, (batch, nb * K.RATE - 1), dtype=torch.uint8, device="cuda",
                         generator=gen)
    padded = K.pad_tensor(msgs)
    out = torch.empty((batch, 32), dtype=torch.uint8, device="cuda")
    if not torch.equal(K.sha3_256_kernel(padded), K.sha3_256_padded(padded)):
        raise AssertionError("keccak_sha3_256 != plain sponge at the leaf shape")
    for name, variant in VARIANTS.items():
        ms = sponge_ms(sponge, variant, padded, out)
        result["leaf_shape"][name] = ms
        print(f"leaf shape {batch} x {nb}, {name}: {ms:.4f} ms  [{card}]", flush=True)
    result["leaf_shape"]["keccak_sha3_256"] = cs.cuda_time_ms(lambda: K.sha3_256_kernel(padded),
                                                              20)
    print(f"leaf shape, keccak_sha3_256 itself: {result['leaf_shape']['keccak_sha3_256']:.4f} ms"
          f"  [{card}]", flush=True)

    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
