"""The port's hand kernels under NVIDIA Compute Sanitizer.

Usage (on a machine with a CUDA card and the CUDA toolkit)::

    python -m hbbft_tpu_torch.tools.kernel_sanitizer                  # all four tools
    python -m hbbft_tpu_torch.tools.kernel_sanitizer --tool racecheck
    python -m hbbft_tpu_torch.tools.kernel_sanitizer --bare           # the launches alone

:func:`run` builds the kernels, then runs one child python per tool under
``compute-sanitizer --tool T --error-exitcode 1``, the tool's checks
restricted to the nine kernels of ``csrc/`` (:data:`KERNELS`, one
``--kernel-name kns=`` filter each; PyTorch's own kernels go unchecked).
The child (:func:`exercise`) launches every kernel once, at the smallest
shapes that still take every branch, and holds each output against the
kernel's plain version:

* K1 ``sha3_256_kernel``: three messages of three blocks each;
  ``merkle_tree_kernel``: one tree of 130 two-block leaves, more leaves
  than the block's 128 threads;
* K4 ``fq_mont_mul_kernel``: 64 rows with the range's edge values;
* K2, the four scan kernels: four subsets: one whose 34 G1 rows of one
  leg and 35 G2 rows are more than a piece of ``scan.PIECE_ROWS``, so
  the second sum launch adds pieces; one with a forged share off the
  subgroup; one with a bad share; one of a decryption share alone, whose
  G2 sum is a single identity row;
* K3 ``pair_miller`` and ``pair_final``: the scan's pairs (four subsets
  of two to four pairs) and one G1-identity and one G2-identity pair.

A tool's run is clean when the child exits 0 having held every kernel
to its plain version and the tool's summary counts 0 errors
(``ERROR SUMMARY: 0 errors``; racecheck's ``RACECHECK SUMMARY`` counts
hazards and errors).  A
driver that does not let the tool attach to the card answers "Device not
supported"; the result then says ``supported: False``, with the tool's
own lines.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import random
import re
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# The __global__ functions of csrc/keccak.cu, fq.cu, scan.cu and pair.cu
# (the Keccak rate probes' measurement kernels are on no path).
KERNELS = ("sha3_256_kernel", "merkle_tree_kernel", "fq_mont_mul_kernel", "scan_g1_rows",
           "scan_g2_rows", "scan_g1_sums", "scan_g2_sums", "pair_miller", "pair_final")
UNSUPPORTED = "Device not supported"
CHILD_TIMEOUT_S = 900
MODULE = "hbbft_tpu_torch.tools.kernel_sanitizer"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sanitizer_path() -> Optional[str]:
    """``compute-sanitizer`` on PATH, else beside the toolkit's ``nvcc``;
    None when the toolkit has none."""
    return (shutil.which("compute-sanitizer")
            or shutil.which("compute-sanitizer", path="/usr/local/cuda/bin"))


def _canonical(limbs) -> list:
    from hbbft_tpu_torch.crypto.device import fq

    return [fq.from_limbs_int(row) % fq.P for row in limbs.reshape(-1, fq.NL).cpu()]


def _same_points(p, q, group: int) -> bool:
    from hbbft_tpu_torch.crypto.bls import curve as oc
    from hbbft_tpu_torch.crypto.device import curve as dc

    frm, ops = (dc.g1_from_dev, oc.FQ_OPS) if group == 1 else (dc.g2_from_dev, oc.FQ2_OPS)
    return all(oc.jac_eq(ops, frm(p, i), frm(q, i)) for i in range(p[3].shape[0]))


def _subsets(suite) -> list:
    """K2's four subsets (module notes)."""
    from hbbft_tpu_torch.crypto import keys
    from hbbft_tpu_torch.crypto.backend import VerifyRequest
    from hbbft_tpu_torch.crypto.bls import curve as oc
    from hbbft_tpu_torch.crypto.bls.suite import G2Elem

    rng = random.Random(21)
    sks = keys.SecretKeySet.random(1, rng, suite)
    pks = sks.public_keys()

    def share(i: int, msg: bytes):
        return VerifyRequest.sig_share(pks.public_key_share(i), msg,
                                       sks.secret_key_share(i).sign(msg))

    ct = pks.public_key().encrypt(b"tx", rng)
    dec = VerifyRequest.dec_share(pks.public_key_share(2), ct,
                                  sks.secret_key_share(2).decryption_share(ct))
    forged = VerifyRequest.sig_share(pks.public_key_share(3), b"doc 1",
                                     keys.SignatureShare(G2Elem(oc._twist_sample_point()), suite))
    bad = VerifyRequest.sig_share(pks.public_key_share(4), b"doc 0",
                                  sks.secret_key_share(5).sign(b"doc 0"))
    return [[share(i, b"leg") for i in range(34)] + [VerifyRequest.ciphertext(ct)],
            [share(1, b"doc 1"), forged], [bad], [dec]]


def exercise(device: str = "cuda") -> Dict[str, str]:
    """Launch each of :data:`KERNELS` once on ``device`` (a CUDA card) at
    the shapes of the module notes, each output held against the plain
    version; raises ``AssertionError`` on a difference.  Returns kernel
    -> what its launch was held to."""
    import numpy as np
    import torch

    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
    from hbbft_tpu_torch.crypto.device import backend as dbackend
    from hbbft_tpu_torch.crypto.device import curve as dc
    from hbbft_tpu_torch.crypto.device import fq
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import pairing as dpairing
    from hbbft_tpu_torch.crypto.device import scan as dscan
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend
    from hbbft_tpu_torch.ops.device import dataplane as dp
    from hbbft_tpu_torch.ops.device import keccak as K

    dev = torch.device(device)
    rng = np.random.default_rng(13)
    held: Dict[str, str] = {}
    build.reset_launches()

    msgs = rng.integers(0, 256, size=(3, 2 * K.RATE + 5), dtype=np.uint8)
    padded = K.pad_tensor(torch.as_tensor(msgs, device=dev))
    got = K.sha3_256_kernel(padded)
    assert torch.equal(got, K.sha3_256_padded(padded)), "sha3_256_kernel"
    assert [r.tobytes() for r in got.cpu().numpy()] == [
        hashlib.sha3_256(m.tobytes()).digest() for m in msgs], "sha3_256_kernel"
    held["sha3_256_kernel"] = "3 messages x 3 blocks: plain sponge, hashlib"

    shards = torch.as_tensor(rng.integers(0, 256, size=(1, 130, K.RATE + 1), dtype=np.uint8),
                             device=dev)
    got = K.merkle_tree_kernel(shards)
    assert torch.equal(got, dp.tree_levels_plain(shards, 130)), "merkle_tree_kernel"
    held["merkle_tree_kernel"] = "1 tree of 130 two-block leaves: tree_levels_plain"

    vals = [int.from_bytes(rng.bytes(49), "little") % (1 << 386) for _ in range(64)]
    vals[:5] = [0, 1, fq.P - 1, fq.P, (1 << 386) - 1]
    a = torch.as_tensor(fq.ints_to_limbs_batch(vals), device=dev)
    b = a.flip(0).contiguous()
    assert _canonical(fq.mont_mul(a, b)) == _canonical(fq.mont_mul_plain(a, b)), "fq_mont_mul"
    held["fq_mont_mul_kernel"] = "64 rows with edge values: mont_mul_plain"

    suite = BLSSuite()
    be = TorchBackend(suite, device=dev)
    subsets = _subsets(suite)
    inp, pair_sub = be._scan_prep(subsets, kernel=True)
    plain_args, _ = be._scan_prep(subsets, kernel=False)
    pieces, segments = inp.g1_pieces.cpu().numpy(), inp.g1_segments.cpu().numpy()
    assert int(np.diff(pieces[segments]).max()) > dscan.PIECE_ROWS
    sub_ok, lhs, rhs = dscan.scan_stage_kernel(inp)
    want_ok, want_lhs, want_rhs = dbackend.scan_stage(*plain_args)
    assert sub_ok.tolist() == want_ok.tolist() == [True, False, True, True], "scan sub_ok"
    assert _same_points(lhs, want_lhs, 1) and _same_points(rhs, want_rhs, 2), "scan sums"
    for name in dscan.KERNELS:
        held[name] = "4 subsets (34-row leg, forged, bad, identity row): plain scan_stage"

    g1_id = dc.g1_to_dev([(1, 1, 0)], dev)
    g2_id = dc.g2_to_dev([((1, 0), (1, 0), (0, 0))], dev)
    lhs = tuple(torch.cat([c, i, c[:1]]).contiguous() for c, i in zip(lhs, g1_id))
    rhs = tuple(torch.cat([c, c[:1], i]).contiguous() for c, i in zip(rhs, g2_id))
    pair_sub = [*pair_sub, 0, 1]
    fs = dpair.miller_values_kernel(lhs, rhs)
    offsets, members = (torch.as_tensor(x, device=dev)
                        for x in dpair.subset_members(pair_sub, len(subsets)))
    ok = dpair.final_kernel(fs, offsets, members, len(subsets))
    assert _canonical(fs) == _canonical(dpairing.miller_values(lhs, rhs)), "pair_miller"
    want = dbackend.pair_stage_plain(lhs, rhs, pair_sub, len(subsets))
    assert ok.tolist() == want.tolist(), "pair_final"
    held["pair_miller"] = f"{len(pair_sub)} pairs, 2 of them identity pairs: miller_values"
    sizes = [pair_sub.count(s) for s in range(len(subsets))]
    held["pair_final"] = f"{len(subsets)} subsets of {min(sizes)} to {max(sizes)} pairs: pair_stage_plain"

    torch.cuda.synchronize(dev)
    launched = {name: build.LAUNCHES[name] for name in
                (K.KERNEL, K.TREE_KERNEL, fq.KERNEL, *dscan.KERNELS, *dpair.KERNELS)}
    assert all(launched.values()), launched
    return held


def verdict(tool: str, rc: int, stdout: str, stderr: str, seconds: float) -> dict:
    """One tool's result from its child's exit code and output: ``tool``,
    ``rc``, ``seconds``, ``supported`` (False when the tool cannot attach
    to the card), ``clean``, ``summary`` (the tool's summary line:
    ``ERROR SUMMARY``, or ``RACECHECK SUMMARY`` for racecheck),
    ``kernels`` (those the child held to their plain versions), ``report``
    (the tool's own lines) and the end of ``stderr``."""
    out = stdout + stderr
    report = [ln for ln in out.splitlines() if ln.startswith("=========")]
    summary = next((ln.strip("= ") for ln in report if "SUMMARY:" in ln), "")
    kernels = [ln.split()[1] for ln in stdout.splitlines() if ln.startswith("HELD ")]
    return {
        "tool": tool, "rc": rc, "seconds": seconds, "supported": UNSUPPORTED not in out,
        "clean": (rc == 0 and re.search(r"\b0 errors\b", summary) is not None
                  and sorted(kernels) == sorted(KERNELS)),
        "summary": summary, "kernels": kernels, "report": report, "stderr": stderr[-4000:],
    }


def run(tools: Sequence[str] = TOOLS) -> List[dict]:
    """One child python per tool under ``compute-sanitizer`` (module
    notes); one :func:`verdict` per tool.  Raises if the toolkit has no
    ``compute-sanitizer``."""
    from hbbft_tpu_torch import build

    exe = sanitizer_path()
    if exe is None:
        raise RuntimeError("compute-sanitizer not found: it ships with the CUDA toolkit")
    build.build_all(["keccak", "fq", "scan", "pair"])
    filters = [arg for name in KERNELS for arg in ("--kernel-name", f"kns={name}")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    results = []
    for tool in tools:
        cmd = [exe, "--tool", tool, "--error-exitcode", "1", *filters,
               sys.executable, "-m", MODULE, "--bare"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S, env=env)
        results.append(verdict(tool, res.returncode, res.stdout, res.stderr,
                               time.perf_counter() - t0))
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tool", action="append", choices=TOOLS,
                    help="one tool (repeatable); default: all four")
    ap.add_argument("--bare", action="store_true",
                    help="launch and check the kernels in this process, with no tool "
                         "(what each tool's child runs)")
    args = ap.parse_args(argv)
    if args.bare:
        t0 = time.perf_counter()
        held = exercise()
        for name, what in held.items():
            print(f"HELD {name} {what}", flush=True)
        print(f"{len(held)} kernels held to their plain versions in "
              f"{time.perf_counter() - t0:.1f} s")
        return 0
    ok = True
    for r in run(args.tool or TOOLS):
        ok &= r["clean"]
        state = "clean" if r["clean"] else ("cannot attach" if not r["supported"] else "FAILED")
        print(f"{r['tool']}: {state}, rc {r['rc']}, {r['summary'] or 'no summary'}, "
              f"{r['seconds']:.1f} s, kernels {' '.join(r['kernels']) or 'none'}")
        if not r["clean"]:
            print("\n".join(r["report"][:12]))
            if r["stderr"].strip():
                print(r["stderr"][-2000:])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
