"""Run ``chip_smoke.py``'s phase 7 runs alone on one CUDA card, and probe
the crypto service's waits on the interpreter lock.

Steps, in the order given on the command line:

* ``b`` — chaos-10-mixed (``chip_smoke._chaos_mixed``);
* ``a`` — traffic-16-wan (``chip_smoke._traffic_wan``);
* ``probe`` — the crypto plane's in-process service cluster
  (``chip_smoke._plane_service``) with the interpreter's switch interval
  at 0.5 ms instead of 5 ms (``sys.setswitchinterval``): if the service's
  host prep waits on the GIL beside the nodes' threads, its time a flush
  falls.

Each step's checks and numbers are ``chip_smoke.py``'s; a failing step is
logged and the next one runs.  Run from the repository root on a machine
with one CUDA card:

    python3 benchmarks_torch/phase7_alone.py b a probe
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import scan as dscan

    card = cs.card_line()
    cs.log(f"card: {card}")
    t0 = time.perf_counter()
    build.build_all(["keccak", "fq", "scan", "pair"], verbose=False)
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    flush_kernels = (*dscan.KERNELS, *dpair.KERNELS)
    steps = {"a": cs._traffic_wan, "b": cs._chaos_mixed, "probe": cs._plane_service}
    for step in sys.argv[1:]:
        t0 = time.perf_counter()
        build.reset_launches()
        interval = sys.getswitchinterval()
        if step == "probe":
            sys.setswitchinterval(0.0005)
        try:
            steps[step](card, flush_kernels)
        except Exception as exc:
            cs.log(f"STEP {step} FAILED: {exc!r}")
        finally:
            sys.setswitchinterval(interval)
        cs.log(f"STEP {step}: {time.perf_counter() - t0:.1f} s; launches {dict(build.LAUNCHES)}")
