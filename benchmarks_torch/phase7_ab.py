"""Time ``chip_smoke.py``'s phase 7 alone, in several checkouts in turns, on
one CUDA card: an A/B of the host code that phase 7 runs.

Each argument is an arm, ``ROOT`` or ``ROOT:no_native``: a checkout of the
repository (``.`` for this one; unpack another with ``git archive`` into a
``.gitignore``d directory such as ``chipcheck/``).  An arm runs in a process
of its own with ``ROOT`` as its working directory, builds that checkout's
CUDA kernels (and its host data plane, where it has one), then starts
phase 7's two runs, traffic-16-wan (a) and chaos-10-mixed (b), each in a
process of its own as ``chip_smoke.py`` does, with nothing else beside
them, and waits for both.  ``:no_native`` sets ``HBBFT_TORCH_NO_NATIVE=1``
for the arm, so RS and Merkle take their numpy and hashlib paths.

Each arm's whole output goes to ``chiprun_out/phase7_ab_<i>.log``; one line
per arm is printed, and the last line is one JSON object of every arm's
(a) and (b) seconds.  Run from the repository root:

    python3 benchmarks_torch/phase7_ab.py chipcheck/parent . .:no_native . chipcheck/parent
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out")


def arm() -> None:
    """One arm, in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from hbbft_tpu_torch import build

    card = cs.card_line()
    t0 = time.perf_counter()
    build.build_all(["keccak", "fq", "scan", "pair"], verbose=False)
    if hasattr(build, "build_host") and not os.environ.get("HBBFT_TORCH_NO_NATIVE"):
        build.build_host("native")
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs = cs.start_phase_traffic(card)
    try:
        cs.phase_traffic(card, runs, t0 + cs.TRAFFIC_DEADLINE_S)
    finally:
        cs.stop_phase_traffic(runs)
    cs.log(f"phase 7 alone {time.perf_counter() - t0:.1f} s  [{card}]")


def main(arms: list) -> int:
    os.makedirs(OUT, exist_ok=True)
    here = os.path.abspath(__file__)
    results = []
    failed = 0
    for i, spec in enumerate(arms):
        root, _, opt = spec.partition(":")
        env = dict(os.environ)
        env.pop("HBBFT_TORCH_NO_NATIVE", None)
        if opt == "no_native":
            env["HBBFT_TORCH_NO_NATIVE"] = "1"
        elif opt:
            raise SystemExit(f"unknown arm option {opt!r}")
        log_path = os.path.join(OUT, f"phase7_ab_{i}.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as f:
            rc = subprocess.call([sys.executable, here, "--arm"], cwd=os.path.abspath(root),
                                 env=env, stdout=f, stderr=subprocess.STDOUT)
        wall = time.perf_counter() - t0
        with open(log_path) as f:
            text = f.read()
        m = re.search(r"\(a\) ([0-9.]+) s, \(b\) ([0-9.]+) s", text)
        a, b = (float(m.group(1)), float(m.group(2))) if m else (None, None)
        failed += rc != 0
        results.append({"arm": spec, "rc": rc, "a_s": a, "b_s": b, "wall_s": round(wall, 1)})
        print(f"arm {i} {spec}: rc {rc}, (a) {a} s, (b) {b} s, wall {wall:.1f} s", flush=True)
    print(json.dumps({"arms": results}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--arm"]:
        arm()
    else:
        sys.exit(main(sys.argv[1:]))
