"""Time the flush's bisection two ways on one CUDA card.

``TorchBackend`` checks every half of one bisection level in one scan
stage and one pair stage.  The reference (``hbbft_tpu/crypto/tpu/backend.py``
``TpuBackend._bisect``) recurses depth-first with one scan and one pair
stage per half.  This script runs both orders on the same 512-request
mixed batch that ``chip_smoke.py`` verifies (two bad shares and one forged
non-subgroup point), through the same stage functions, and prints each
order's time, its number of stages and its verdicts, which must agree.

Run from the repository root on a machine with one CUDA card:

    python3 benchmarks_torch/bisect_ab.py

The depth-first order makes 49 aggregate checks on this batch and the
level-wide order 10; with the K2 and K3 kernels a run takes seconds.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import _mixed_512, card_line  # noqa: E402
from hbbft_tpu_torch.crypto import keys  # noqa: E402
from hbbft_tpu_torch.crypto.backend import VerifyRequest, request_well_formed  # noqa: E402
from hbbft_tpu_torch.crypto.bls import curve as oc  # noqa: E402
from hbbft_tpu_torch.crypto.bls.suite import BLSSuite, G2Elem  # noqa: E402
from hbbft_tpu_torch.crypto.device.backend import TorchBackend  # noqa: E402


def depth_first(be: TorchBackend, reqs):
    """The reference's one-chunk ``verify_batch`` and ``_bisect``: one
    aggregate check (scan + pair stage) for the chunk, then one per half,
    depth-first.  Returns (verdicts, number of aggregate checks)."""
    out = [False] * len(reqs)
    checks = 0

    def aggregate_ok(idxs) -> bool:
        nonlocal checks
        checks += 1
        return be._aggregate_ok_many([[reqs[i] for i in idxs]])[0]

    def bisect(idxs) -> None:
        if len(idxs) == 1:
            out[idxs[0]] = be._eager.verify_batch([reqs[idxs[0]]])[0]
            return
        mid = len(idxs) // 2
        for half in (idxs[:mid], idxs[mid:]):
            if aggregate_ok(half):
                for i in half:
                    out[i] = True
            else:
                bisect(half)

    idxs = [i for i, r in enumerate(reqs) if request_well_formed(be.suite, r, subgroup=False)]
    if aggregate_ok(idxs):
        for i in idxs:
            out[i] = True
    else:
        bisect(idxs)
    return out, checks


def main() -> int:
    if not torch.cuda.is_available():
        print("bisect_ab: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    suite = BLSSuite()
    reqs, bad = _mixed_512(keys, VerifyRequest, suite, G2Elem, oc._twist_sample_point())
    be = TorchBackend(suite, device="cuda")
    be.verify_batch(reqs[:4])  # warm-up: allocator, first launches
    torch.cuda.synchronize()

    stages = 0
    level_many = be._aggregate_ok_many

    def counted(subsets):
        nonlocal stages
        stages += 1
        return level_many(subsets)

    be._aggregate_ok_many = counted
    t0 = time.perf_counter()
    level = be.verify_batch(reqs)
    level_s = time.perf_counter() - t0
    del be._aggregate_ok_many
    # verify_batch's first check is _check_parts, not _aggregate_ok_many.
    level_stages = stages + 1

    t0 = time.perf_counter()
    depth, checks = depth_first(be, reqs)
    depth_s = time.perf_counter() - t0

    rejected = [i for i, v in enumerate(level) if not v]
    if level != depth or rejected != bad:
        raise AssertionError(f"verdicts differ: level {rejected}, depth "
                             f"{[i for i, v in enumerate(depth) if not v]}, expected {bad}")
    print(f"mixed-512, rejected {bad}: level-wide {level_s:.2f} s over {level_stages} "
          f"scan+pair stages; depth-first {depth_s:.2f} s over {checks} scan+pair stages  "
          f"[{card}]", flush=True)
    print(json.dumps({"level_s": level_s, "level_stages": level_stages,
                      "depth_first_s": depth_s, "depth_first_stages": checks,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
