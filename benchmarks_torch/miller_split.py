"""Split ``pair_miller``'s time on one CUDA card into its parts.

``pair_miller`` (``hbbft_tpu_torch/csrc/pair.cu``, the Miller loop of
``csrc/pairing.cuh`` on one warp per pair) runs three kinds of work: the
affine conversion (two Fermat inverses side by side), the product
bundles of the loop's steps (``team::prods``: each lane's Karatsuba part,
then the joins) and the linear stages between them (additions, one Fq2
component a lane).  This script builds variants of the kernel from the
checkout's sources with a part of that work left out and times each at
the firehose's 10 pairs:

    full        the kernel as it is;
    no-loop     the affine conversion and the output only;
    prods-only  the loop without its linear stages;
    linear-only the loop without its product bundles;
    neither     the loop's control alone.

The variants compute wrong values and are only timed; the kernel itself
is held against its plain version by ``chip_smoke.py``.  The variant
sources and libraries go to ``hbbft_tpu_torch/build/miller_split/``.

Run from the repository root on a machine with one CUDA card:

    python3 benchmarks_torch/miller_split.py

It prints one line per variant (full is timed first and last) and, last,
one JSON object with the times in ms.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from hbbft_tpu_torch import build  # noqa: E402
from hbbft_tpu_torch.crypto.bls import curve as oc  # noqa: E402
from hbbft_tpu_torch.crypto.bls.suite import BLSSuite  # noqa: E402
from hbbft_tpu_torch.crypto.device import curve as dc  # noqa: E402

OUT = build.BUILD_DIR / "miller_split"
SWITCHES = """
#ifndef MILLER_STEPS
#define MILLER_STEPS 62
#endif
#if SPLIT_NO_LINEAR
#define LIN_STAGE(t, ...) ((void)0)
#else
#define LIN_STAGE(t, ...) t.stage(__VA_ARGS__)
#endif
#if SPLIT_NO_PRODS
#define PRODS(...) ((void)0)
#else
#define PRODS(...) team::prods(__VA_ARGS__)
#endif
"""
VARIANTS = {
    "full": [],
    "no-loop": ["-DMILLER_STEPS=-1"],
    "prods-only": ["-DSPLIT_NO_LINEAR=1"],
    "linear-only": ["-DSPLIT_NO_PRODS=1"],
    "neither": ["-DSPLIT_NO_LINEAR=1", "-DSPLIT_NO_PRODS=1"],
}


def variant_source() -> None:
    """pairing.cuh with switches around the loop's steps, and pair.cu."""
    src = (build.CSRC / "pairing.cuh").read_text()
    lo, hi = src.index("FQ_HD void dbl_step("), src.index("// The pair's points from the port")
    steps = src[lo:hi].replace("t.stage(", "LIN_STAGE(t, ").replace("team::prods(", "PRODS(")
    src = src[:lo] + steps + src[hi:]
    loop = "    for (int k = 62; k >= 0; --k) {"
    assert loop in src and '#include "tower.cuh"\n' in src
    src = src.replace(loop, "    for (int k = 62; k >= 62 - MILLER_STEPS; --k) {")
    src = src.replace('#include "tower.cuh"\n', '#include "tower.cuh"\n' + SWITCHES, 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "pairing.cuh").write_text(src)
    (OUT / "pair.cu").write_text((build.CSRC / "pair.cu").read_text())


def compile_variant(name: str) -> str:
    lib = OUT / f"{name}.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *VARIANTS[name], f"-I{build.CSRC}",
           "-o", str(lib), str(OUT / "pair.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
    return str(lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("miller_split: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    variant_source()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(compile_variant, VARIANTS)))
    suite = BLSSuite()
    g1 = [oc.jac_mul(oc.FQ_OPS, suite.g1_generator().jac, k + 2) for k in range(10)]
    g2 = [oc.jac_mul(oc.FQ2_OPS, suite.g2_generator().jac, k + 3) for k in range(10)]
    ptrs = [t.data_ptr() for t in dc.g1_to_dev(g1, "cuda") + dc.g2_to_dev(g2, "cuda")]
    out = torch.empty((10, 6, 2, 36), dtype=torch.int64, device="cuda")
    times = {}
    for name in [*VARIANTS, "full"]:
        fn = ctypes.CDLL(libs[name]).hbbft_pair_miller
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

        def launch():
            stream = torch.cuda.current_stream().cuda_stream
            build.check(fn(*ptrs, 10, out.data_ptr(), stream), "hbbft_pair_miller")

        ms = cs.cuda_time_ms(launch, 10)
        times.setdefault(name, []).append(ms)
        print(f"pair_miller {name} at 10 pairs: {ms:.3f} ms  [{card}]", flush=True)
    print(json.dumps({"card": card, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
