"""Time the port's hand kernels in several checkouts, in turns, on one CUDA card.

Each argument is the root of a checkout: this repository, or another
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists.  For each root, in the order given, a fresh process imports that
root's ``chip_smoke.py`` and ``hbbft_tpu_torch``, builds its kernels into
that root's build directory, and runs ``chip_smoke.py``'s kernel phases:
K1 at the data plane's leaf shape (and the Merkle tree kernel at N = 104,
where the root has it), K4 on 2,048 rows, the four K2 kernels at one
firehose chunk and the two K3 kernels at the firehose's pairs, each held
against its plain version as ``chip_smoke.py`` holds it.  More times
come from this script's own code, the same for every root:
``pair_miller`` at the last level of the mixed-512 bisection; the own
kernel times, from ``torch.profiler``'s kernel records, of
``fq_mont_mul`` at 2,048 rows and of ``keccak_sha3_256`` at 65,536 x 1
and 10,816 x 14 blocks (one wrapper call under CUDA events also times
its host dispatch, which is most of a short kernel's time); and the data
plane's leaf and level hashing (K6, ``tree_levels``) at N = 104,
64,000-byte proposals, whatever kernels the root runs it on.  The phases' own lines go to standard output as they come; the
last lines are one JSON object per run, ``{"root": ..., "ms": {kernel:
ms}}``.

Run from the repository root on a machine with one CUDA card, parent and
change in turns so that drift shows:

    python3 benchmarks_torch/kernel_ab.py parent . . parent
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs
from hbbft_tpu_torch import build
from hbbft_tpu_torch.crypto import keys
from hbbft_tpu_torch.crypto.backend import VerifyRequest
from hbbft_tpu_torch.crypto.bls import curve as oc
from hbbft_tpu_torch.crypto.bls.suite import BLSSuite, G2Elem

card = cs.card_line()
build.build_all(["keccak", "fq", "scan", "pair"])
suite = BLSSuite()
firehose = cs._firehose(keys, VerifyRequest, suite)
mixed, bad = cs._mixed_512(keys, VerifyRequest, suite, G2Elem, oc._twist_sample_point())
kernels = cs.phase_kernels(card, leaf_shape=(104 * 104, 14))
kernels.append(cs.phase_field(card))
kernels += cs.phase_scan(card, firehose, mixed)
kernels += cs.phase_pair(card, firehose, mixed, bad)
ms = {k["name"]: k["ms"] for k in kernels}

import torch
from torch.profiler import ProfilerActivity, profile
from hbbft_tpu_torch.crypto.device import fq, pair as dpair
from hbbft_tpu_torch.crypto.device.backend import TorchBackend

be = TorchBackend(device="cuda")
level = cs._bisection_levels(be, mixed)[-1]
_, llhs, lrhs, _ = be._scan([[mixed[i] for i in h] for h in level])
ms["pair_miller_last_level"] = cs.cuda_time_ms(lambda: dpair.miller_values_kernel(llhs, lrhs), 5)
gen = torch.Generator(device="cuda")
gen.manual_seed(4)
a = torch.randint(0, 2048, (2048, fq.NL), dtype=torch.int64, device="cuda", generator=gen)
a[:, -1] = 0
b = a.flip(0).contiguous()
fq.mont_mul_kernel(a, b)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(200):
        fq.mont_mul_kernel(a, b)
    torch.cuda.synchronize()
ev = [e for e in prof.key_averages() if "fq_mont_mul_kernel" in e.key and e.self_device_time_total > 0]
ms["fq_mont_mul_kernel_only"] = (sum(e.self_device_time_total for e in ev)
                                 / max(sum(e.count for e in ev), 1) / 1e3)
import numpy as np
from hbbft_tpu_torch.ops.device import dataplane as dp
from hbbft_tpu_torch.ops.device import keccak as K
gen.manual_seed(5)
for batch, nb in ((65_536, 1), (104 * 104, 14)):
    padded = K.pad_tensor(torch.randint(0, 256, (batch, nb * K.RATE - 1), dtype=torch.uint8,
                                        device="cuda", generator=gen))
    key = f"keccak_sha3_256_{batch}x{nb}_kernel_only"
    ms[key] = cs.profiled_kernel_ms(lambda: K.sha3_256_kernel(padded), "sha3_256_kernel", 50)
    print(f"keccak_sha3_256 kernel alone (profiler, 50 launches) at {batch} x {nb}: "
          f"{ms[key]:.5f} ms  [{card}]", flush=True)
rng = np.random.default_rng(104)
values = [rng.integers(0, 256, 64_000, dtype=np.uint8).tobytes() for _ in range(104)]
data = torch.as_tensor(np.stack([dp._pack(v, 36)[0] for v in values]), device="cuda")
with torch.inference_mode():
    shards = dp.rs_shards(data, 104)
    ms["K6_tree_levels"] = cs.cuda_time_ms(lambda: dp.tree_levels(shards, 104), 10)
print(f"K6 tree_levels at N=104: {ms['K6_tree_levels']:.4f} ms  [{card}]", flush=True)
print(f"pair_miller at the last mixed-512 level ({llhs[3].shape[0]} pairs): "
      f"{ms['pair_miller_last_level']:.3f} ms; fq_mont_mul kernel alone (profiler, 200 "
      f"launches at 2048 rows): {ms['fq_mont_mul_kernel_only']:.5f} ms  [{card}]", flush=True)
print("KERNEL_MS " + json.dumps(ms), flush=True)
"""


def run(root: str) -> dict:
    proc = subprocess.Popen([sys.executable, "-c", CHILD, root], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    ms = None
    for line in proc.stdout:
        if line.startswith("KERNEL_MS "):
            ms = json.loads(line[len("KERNEL_MS "):])
        else:
            print(f"[{root}] {line}", end="", flush=True)
    if proc.wait() != 0 or ms is None:
        raise RuntimeError(f"the kernel phases failed in {root}")
    return {"root": root, "ms": ms}


def main() -> int:
    roots = sys.argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    results = [run(root) for root in roots]
    for r in results:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
