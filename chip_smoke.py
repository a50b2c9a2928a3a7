"""Drive the PyTorch/H100 port on the card and check it end to end.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

0. setup: the card's name and power limit, torch version, and the
   build of every hand-written CUDA kernel (one ``nvcc`` per source, all
   started together);
1. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, with its time, the plain version's time and the
   least time the card could take (its bound);
2. the reliable-broadcast data plane at N = 104 validators, 64,000-byte
   proposals (one HoneyBadger epoch): every proof checked, sampled proofs
   and parity held against the host Merkle tree and Reed-Solomon code, and
   the kernels' launch counts over that run;
3. the share-verification flush: the 10,240-request sig-share firehose
   (all valid, 5 chunks) and a 512-request mixed batch with two bad
   shares and one forged non-subgroup point, whose verdicts must equal
   the host ``BatchedBackend``/``EagerBackend``.

The last three lines are one JSON object with every kernel's numbers,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.  With no CUDA card, or
without the package beside it, the script exits nonzero and prints no
result.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Peak rates of one H100 SXM (NVIDIA data sheet and Hopper whitepaper):
# memory 3.35 TB/s; 32-bit integer ALU 132 SMs x 64 lanes x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# The fewest 32-bit integer instructions one Keccak-f[1600] permutation
# needs on the card, which has a 3-input logic instruction (LOP3) and a
# funnel shift (SHF); every 64-bit lane is two 32-bit halves.  Per round:
# theta's five 5-input column parities 5 x 2 LOP3 x 2 halves = 20; their
# five 1-bit rotations 5 x 2 SHF = 10; D applied to 25 lanes, one LOP3
# (a ^ c[x-1] ^ rot(c[x+1])) per half = 50; rho's 24 rotations (none by 0
# or 32) x 2 SHF = 48; chi's a ^ (~b & c), one LOP3 per half = 50.  Iota
# XORs each nonzero 32-bit half of the round constant (24 low + 13 high
# halves over 24 rounds); absorbing a block XORs 17 lanes = 34.
KECCAK_INT32_OPS_PER_ROUND = 20 + 10 + 50 + 48 + 50
KECCAK_IOTA_HALVES = 24 + 13
KECCAK_INT32_OPS_PER_PERM = 24 * KECCAK_INT32_OPS_PER_ROUND + KECCAK_IOTA_HALVES + 2 * 17


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_time_ms(fn, repeats: int) -> float:
    """Median over ``repeats`` of one call's device time (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sass_summary(source: str, name: str) -> str:
    """Instruction counts of the built kernel's machine code, by opcode
    (``cuobjdump -sass`` from the toolkit beside ``nvcc``): a check on the
    operation count its bound assumes."""
    import re
    from collections import Counter

    from hbbft_tpu_torch import build

    lib = build.build_all([source])[source]
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    ops = Counter(m.group(1).split(".")[0] for m in
                  re.finditer(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)",
                              sass, re.M))
    top = ", ".join(f"{op} {n}" for op, n in ops.most_common(8))
    return f"{name} SASS: {sum(ops.values())} instructions ({top})"


def phase_kernels(card: str, leaf_shape) -> list:
    from hbbft_tpu_torch.ops.device import keccak as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for batch, nb in ((65_536, 1), (4_096, 14)):
        msgs = torch.randint(0, 256, (batch, nb * K.RATE - 1), dtype=torch.uint8,
                             device="cuda", generator=gen)
        padded = K.pad_tensor(msgs)
        got = K.sha3_256_kernel(padded)
        torch.cuda.synchronize()
        want = K.sha3_256_padded(padded)
        if not torch.equal(got, want):
            raise AssertionError(f"keccak kernel != plain version at {batch}x{nb} blocks")
        host = msgs[:16].cpu().numpy()
        dig = got[:16].cpu().numpy()
        for i in range(16):
            if dig[i].tobytes() != hashlib.sha3_256(host[i].tobytes()).digest():
                raise AssertionError(f"keccak kernel != hashlib at {batch}x{nb} row {i}")
        ms = cuda_time_ms(lambda: K.sha3_256_kernel(padded), 20)
        log(f"keccak_sha3_256 {batch} msgs x {nb} blocks: byte-identical to plain "
            f"and hashlib; kernel {ms:.4f} ms  [{card}]")

    # Timing at the main path's leaf-hash shape (the data plane's largest call).
    batch, nb = leaf_shape
    msgs = torch.randint(0, 256, (batch, nb * K.RATE - 1), dtype=torch.uint8,
                         device="cuda", generator=gen)
    padded = K.pad_tensor(msgs)
    got = K.sha3_256_kernel(padded)
    want = K.sha3_256_padded(padded)
    err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    if err:
        raise AssertionError("keccak kernel != plain version at the leaf shape")
    ms = cuda_time_ms(lambda: K.sha3_256_kernel(padded), 20)
    plain_ms = cuda_time_ms(lambda: K.sha3_256_padded(padded), 3)
    n_bytes = batch * nb * K.RATE + batch * 32
    n_ops = batch * nb * KECCAK_INT32_OPS_PER_PERM
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    log(sass_summary("keccak", K.KERNEL))
    log(f"keccak_sha3_256 at leaf shape {batch} x {nb} blocks: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"(bytes {bytes_ms:.4f}, int32 ops {ops_ms:.4f}), library none  [{card}]")
    return [{
        "name": K.KERNEL,
        "route": "cuda",
        "source": "hbbft_tpu_torch/csrc/keccak.cu",
        "replaces": "hbbft_tpu/ops/jaxops/keccak_pallas.py:50",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]


def phase_dataplane(card: str) -> dict:
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.ops.device.dataplane import encode_and_prove
    from hbbft_tpu_torch.ops.gf256 import ReedSolomon
    from hbbft_tpu_torch.ops.merkle import MerkleTree

    n, f = 104, 34  # the HoneyBadgerBFT paper's deployment size
    k = n - 2 * f
    rng = np.random.default_rng(104)
    values = [rng.integers(0, 256, 64_000, dtype=np.uint8).tobytes() for _ in range(n)]
    encode_and_prove(values[:2], k, n, device="cuda")  # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()

    build.reset_launches()
    t0 = time.perf_counter()
    proofs = encode_and_prove(values, k, n, device="cuda")
    epoch_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)

    if len(proofs) != n or any(len(row) != n for row in proofs):
        raise AssertionError("data plane did not return N x N proofs")
    rs = ReedSolomon(k, n)
    for v in (0, 51, 103):
        shards = [p.value for p in proofs[v]]
        if len(shards[0]) != 1778:
            raise AssertionError(f"shard length {len(shards[0])} != 1778")
        if rs.encode(shards[:k]) != shards:
            raise AssertionError(f"value {v}: parity != host ReedSolomon.encode")
        tree = MerkleTree(shards)
        for i in range(n):
            p = proofs[v][i]
            if p.root != tree.root or p.path != tree.proof(i).path or not p.validate(n):
                raise AssertionError(f"value {v} shard {i}: proof does not verify")
    roots_ok = all(proofs[v][i].root == proofs[v][0].root for v in range(n) for i in range(n))
    if not roots_ok:
        raise AssertionError("proofs of one value disagree on the root")
    # One launch for the leaves and one per tree level (128 leaves: 7).
    if launches.get("keccak_sha3_256", 0) != 1 + 7:
        raise AssertionError(f"keccak launches {launches} != 8 over one data-plane epoch")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        encode_and_prove(values, k, n, device="cuda")
        times.append(time.perf_counter() - t0)
    log(f"data plane N={n} k={k} 64000-byte values: {n}x{n} proofs verified; "
        f"keccak launches {launches.get('keccak_sha3_256', 0)}; first run {epoch_s:.3f} s, "
        f"median of 3 warm runs {statistics.median(times):.3f} s per epoch  [{card}]")
    return launches


def _firehose(keys, Request, suite):
    """benchmarks/config5_firehose.py:35-47 over the port's host copies."""
    rng = random.Random(13)
    sks = keys.SecretKeySet.random(3, rng, suite)
    pks = sks.public_keys()
    msg = b"firehose epoch document"
    shares = [sks.secret_key_share(i % 10).sign(msg) for i in range(10)]
    return [
        Request.sig_share(pks.public_key_share(i % 10), msg, shares[i % 10])
        for i in range(10_240)
    ]


def _mixed_512(keys, Request, suite, G2Elem, rogue_pt):
    """512 requests of all three kinds; two bad shares and one forged
    non-subgroup point at seeded positions."""
    rng = random.Random(512)
    sks = keys.SecretKeySet.random(3, rng, suite)
    pks = sks.public_keys()
    docs = [b"mixed epoch doc %d" % d for d in range(4)]
    sig = [(i % 10, docs[i % 4]) for i in range(320)]
    sig_shares = {}
    reqs = []
    for i, d in sig:
        if (i, d) not in sig_shares:
            sig_shares[(i, d)] = sks.secret_key_share(i).sign(d)
        reqs.append(Request.sig_share(pks.public_key_share(i), d, sig_shares[(i, d)]))
    for c in range(64):
        ct = pks.public_key().encrypt(b"contribution %d" % c, rng)
        reqs.append(Request.ciphertext(ct))
        for j in (c % 10, (c + 3) % 10):
            reqs.append(Request.dec_share(
                pks.public_key_share(j), ct, sks.secret_key_share(j).decryption_share(ct)))
    order = list(range(len(reqs)))
    rng.shuffle(order)
    reqs = [reqs[i] for i in order]
    sig_at = [i for i, r in enumerate(reqs) if r.kind == "sig_share"]
    dec_at = [i for i, r in enumerate(reqs) if r.kind == "dec_share"]
    bad_sig, forged = rng.sample(sig_at, 2)
    bad_dec = rng.choice(dec_at)
    pk, doc, _ = reqs[bad_sig].payload
    reqs[bad_sig] = Request.sig_share(pk, doc, sks.secret_key_share(0).sign(b"wrong document"))
    pk, doc, _ = reqs[forged].payload
    reqs[forged] = Request.sig_share(pk, doc, keys.SignatureShare(G2Elem(rogue_pt), suite))
    pk, ct, share = reqs[bad_dec].payload
    other = sks.secret_key_share(9 if pk.to_bytes() != pks.public_key_share(9).to_bytes() else 8)
    reqs[bad_dec] = Request.dec_share(pk, ct, other.decryption_share(ct))
    return reqs, sorted([bad_sig, forged, bad_dec])


def phase_flush(card: str) -> None:
    from hbbft_tpu_torch.crypto import keys
    from hbbft_tpu_torch.crypto.backend import (
        BatchedBackend,
        EagerBackend,
        VerifyRequest,
    )
    from hbbft_tpu_torch.crypto.bls import curve as oc
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite, G2Elem
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend

    from hbbft_tpu_torch.crypto.device import fq

    # The field layer under both stages (K4): one product and one
    # difference at 8 rows and at a chunk's 2048 rows, host clock around
    # synchronised calls.  Equal times at both sizes mean launch-bound.
    rng = np.random.default_rng(5)
    a = torch.as_tensor(fq.to_mont_batch(
        [int.from_bytes(rng.bytes(48), "big") % fq.P for _ in range(2048)]), device="cuda")
    b = a.flip(0).contiguous()
    with torch.inference_mode():
        for name, fn in (("mont_mul", fq.mont_mul), ("sub", fq.sub)):
            for rows in (8, 2048):
                fn(a[:rows], b[:rows])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    fn(a[:rows], b[:rows])
                torch.cuda.synchronize()
                log(f"fq.{name} at {rows} rows: {(time.perf_counter() - t0) / 50 * 1e6:.1f} us "
                    f"per call  [{card}]")
        # Device busy share over 20 products at 2048 rows, from a
        # torch.profiler trace (kernel time / wall time under the profiler).
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fq.mont_mul(a, b)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us = sum(e.self_device_time_total for e in prof.key_averages())
        share = f"{100 * busy_us / wall_us:.1f}%" if busy_us > 0 else "not measured"
        log(f"fq.mont_mul x20 at 2048 rows under torch.profiler: device busy {busy_us:.0f} us "
            f"of {wall_us:.0f} us wall = {share}  [{card}]")

    suite = BLSSuite()
    t0 = time.perf_counter()
    reqs = _firehose(keys, VerifyRequest, suite)
    log(f"firehose: built {len(reqs)} requests on the host in {time.perf_counter() - t0:.1f} s")
    be = TorchBackend(suite, device="cuda")

    # First flush: each stage timed with a sync around it.
    stage = {"scan": 0.0, "pair": 0.0}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            stage[name] += time.perf_counter() - t0
            return out
        return run

    be._scan = timed("scan", be._scan)
    be._check_parts = timed("pair", be._check_parts)
    t0 = time.perf_counter()
    first = be.verify_batch(reqs)
    first_s = time.perf_counter() - t0
    del be._scan, be._check_parts
    if not all(first):
        raise AssertionError("firehose: a valid share was rejected")

    # Second flush: end to end, no extra syncs.
    t0 = time.perf_counter()
    warm = be.verify_batch(reqs)
    warm_s = time.perf_counter() - t0
    if not all(warm):
        raise AssertionError("firehose (warm): a valid share was rejected")
    n_chunks = -(-len(reqs) // be.chunk)
    log(f"flush firehose {len(reqs)} sig shares, {n_chunks} chunks of {be.chunk}: all True; "
        f"warm {warm_s:.2f} s = {len(reqs) / warm_s:.1f} verifies/s; first (stage-timed) "
        f"{first_s:.2f} s: scan {stage['scan']:.2f} s over {n_chunks} chunks, "
        f"pair {stage['pair']:.2f} s  [{card}]")

    rogue = oc._twist_sample_point()
    mixed, bad = _mixed_512(keys, VerifyRequest, suite, G2Elem, rogue)
    t0 = time.perf_counter()
    got = be.verify_batch(mixed)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = BatchedBackend(suite).verify_batch(mixed)
    host_s = time.perf_counter() - t0
    if got != want:
        raise AssertionError("mixed batch: TorchBackend != BatchedBackend")
    if [i for i, v in enumerate(got) if not v] != bad:
        raise AssertionError(f"mixed batch: rejected {[i for i, v in enumerate(got) if not v]}, expected {bad}")
    sample = bad + [i for i in range(0, len(mixed), 97) if i not in bad]
    eager = EagerBackend(suite).verify_batch([mixed[i] for i in sample])
    if eager != [got[i] for i in sample]:
        raise AssertionError("mixed batch: TorchBackend != EagerBackend on the sample")
    log(f"flush mixed {len(mixed)} requests (sig/dec/ciphertext, 2 bad + 1 forged non-subgroup): "
        f"verdicts == BatchedBackend and EagerBackend sample; rejected {bad}; "
        f"TorchBackend {dev_s:.2f} s, BatchedBackend (host) {host_s:.2f} s  [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from hbbft_tpu_torch import build

    t0 = time.perf_counter()
    build.build_all(["keccak"], verbose=True)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    kernels = phase_kernels(card, leaf_shape=(104 * 104, 14))
    launches = phase_dataplane(card)
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    phase_flush(card)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
