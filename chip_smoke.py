"""Drive the PyTorch/H100 port on the card and check it end to end.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

0. setup: the card's name and power limit, torch version, and the
   build of every hand-written CUDA kernel (one ``nvcc`` per source, all
   started together: keccak, fq, scan, pair), with the host C++ of
   ``hbbft_tpu_torch/csrc/native/`` (the protocol engine and the host
   data plane, ``g++``) built beside them;
1. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, with its time, the plain version's time and the
   least time the card could take (its bound): the Keccak sponge kernel
   (K1) at the data plane's leaf shape, and its Merkle tree kernel (the
   leaves and every level of each value's tree in one launch) at the data
   plane's N = 104 and at a padded odd shape, with its critical path in
   permutations and the machine code's instruction counts of both; the
   Fq product (K4) on 2,048 rows with
   edge limbs; the scan-stage kernels (K2) on one firehose chunk (2,048
   G1 + 2,048 G2 rows) and on the mixed-512 batch in one subset, whose
   forged non-subgroup point must clear its verdict; the pair-stage
   kernels (K3) on the firehose's combined pairs and on every mixed-512
   bisection level (down to subsets of two and one request), verdicts
   and Miller values equal to the plain pair stage;
2. the reliable-broadcast data plane at N = 104 validators, 64,000-byte
   proposals (one HoneyBadger epoch): all N x N proofs verified, sampled
   proofs and parity held against the host Merkle tree and Reed-Solomon
   code, the kernels' launch counts over that run (one tree launch, no
   sponge launch), and the times and bounds of its two device stages (the
   RS bit product, K5; the leaf and level hashing, K6);
3. the share-verification flush: the 10,240-request sig-share firehose
   (all valid, 5 chunks) split into host prep, scan and pair, the
   device's busy share over one warm flush, and the launches of K2 and
   K3 over a flush; then a 512-request mixed batch with two bad shares
   and one forged non-subgroup point, whose verdicts must equal the host
   ``BatchedBackend``/``EagerBackend``;
4. the consensus plane: (a) one HoneyBadger epoch at 16 validators (the
   last 5 silent) and 256 transactions over BLS, every share check of
   every node's pool flushed through ``TorchBackend`` on the card (K2,
   K3, K4), committing one identical batch on every correct node with
   every verdict True, its first 4 flushes held against the host
   ``BatchedBackend``, with the flush sizes, the backend's stages and
   the device's busy share over the epoch; (b) two 4-node epochs with a
   tampering validator whose doubled shares the card must reject, every
   flush held against the host; (c) ``batch_propose`` over 16 Broadcast
   instances on the card (K1's tree kernel, K5), its proofs equal to
   per-instance ``handle_input``;
5. the dynamic stack: (a) a BLS era change at N = 4 (config 4's phases:
   a plain epoch of QueueingHoneyBadger, node 3 voted out through
   SyncKeyGen run inside consensus, one epoch of the new era), every share
   check on the card, batches and the new key set alike on every correct
   node, its first 4 flushes and its first new-era flush held against the
   host ``BatchedBackend``, with the backend's stages, the device's busy
   share and the host seconds of the checks that do not go through the
   ``VerifySink`` (SyncKeyGen, DynamicHoneyBadger's signatures); (b) the
   port's simulation example at the reference's defaults (10 nodes, 128
   transactions) over BLS with ``--backend torch``, every node committing
   every transaction;
6. the crypto plane: (a) a live cluster of 4 BLS validators over
   localhost TCP (``LocalCluster``; phase 7 (a) runs 16) whose every
   node's share checks one shared ``CryptoPlaneService`` merges into
   ``TorchBackend`` flushes on the card, until every node has committed
   all 4 transactions: the nodes' streams alike, no handler error, no fault, no fallback to a
   node's host backend, the scan and pair kernels launched on every
   service flush, the first 4 service flushes held against the host
   ``BatchedBackend``, with the flushes, requests per flush, the
   service's wait against the backend's time, the backend's stages and
   the device's busy share; (b) the same service in a process of its own
   (``ServiceProcess(backend="torch")``) serving a 4-node BLS cluster until
   every node has 2 batches, its log line naming the card, the worker
   exiting 0 with no flush error, with the worker's own launches; (c)
   ``HybridBackend`` sending a 63-request flush to the host and a
   64-request flush to the card, a raising device propagating, and the
   sharded flush (``TorchBackend(devices=["cuda:0", "cuda:0"])``, K7's
   counterpart) on the firehose, the firehose with a bad share in a chunk
   scanned on ``devices[1]``, and mixed-512, with the unsharded verdicts
   and launches;
7. traffic and chaos, each in a process of its own started right after
   the build and run beside phases 1-6 (both are host-paced and together
   outlast what the time limit leaves; beside them phase 1's kernel times
   stay within their spread from call to call, PERF.md §6): (a)
   traffic-16-wan, open-loop clients (``ClientFleet(32, 80/16^2 txn/s
   each)`` for 2 s through a ``TrafficDriver``) over a 16-node BLS cluster whose every link a seeded
   ``FaultInjector`` shapes as a WAN (``wan_profile("wan")``), its share
   checks merged by one service into ``TorchBackend`` flushes, scraped once
   mid-run (``serve_obs``: ``/healthz``, ``/metrics``, ``/trace.json``):
   every transaction committed exactly once on every node, the streams
   alike, the first 4 service flushes held against the host
   ``BatchedBackend``, with submit-to-commit latency, epochs, flushes, the
   backend's stages and the busy share; (b) chaos-10-mixed, a 10-node BLS
   cluster with three live Byzantine nodes (corrupt shares, equivocation,
   garbage) under open-loop traffic homed on the honest nodes:
   ``ChaosOracle.check_all()`` (safety, progress, exactly-once,
   attribution), the corrupt shares rejected on the card by bisection and
   only they, the first 4 flushes holding one held against the host;
8. the native engine: native-bls-16, BASELINE config 3's fused stack
   (``benchmarks/config3_native_bls.py`` as the reference's battery ran
   it, 64 transactions): ``NativeQhbNet(16, seed=0, batch_size=256,
   num_faulty=0, flush_every=0)`` over BLS, the whole network's message
   loop in the C++ engine, every verify flush of its per-node pools
   handed to ``TorchBackend`` on the card, run until every node has
   committed all 64: every transaction on all 16 nodes, the batches
   alike, no fault, the flush counts equal to the reference's at the
   same seed, the scan and pair kernels launched on every flush, the
   first 4 flushes held against the host ``BatchedBackend``, with the
   epoch walls, the backend's stages and the device's busy share;
9. the sanitizer tier over the card: the engine built under UBSan and
   under ASan (``build.build_host(..., sanitizer=...)``, beside phases
   1-8), each driven in a child python with its runtime ``LD_PRELOAD``ed
   (ASan with ``protect_shadow_gap=0``, which the CUDA driver needs):
   ``NativeQhbNet(4, ...)`` over BLS with external crypto through
   ``TorchBackend(device="cuda")`` for one committed epoch, its batches
   equal to the normal engine's in this process, K2 and K3 launched on
   every flush, then a ``TorchBackend`` whose second flush raises
   ``DeviceFlushError``: the error reaches the caller, no fault is
   recorded and later calls raise; each child exits 0 with no sanitizer
   report.

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
import types

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

# The Fq kernels (K2, K4) are bound by 32-bit integer multiply-adds
# (IMAD, IMAD.HI, IMAD.WIDE), a different unit from the ALU rate above:
# 64 per SM per clock (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 132 SMs x 1.98 GHz.  The fewest a
# 12-word Montgomery product needs, schoolbook CIOS: 12 x 12 lo/hi pairs
# for a*b, 12 quotient words, 12 x 12 lo/hi pairs for m*P.  Additions run
# on the ALU pipe beside them and are not counted.
IMAD_PER_S = 132 * 64 * 1.98e9
FQ_MUL_IMAD = 12 * 12 * 2 + 12 + 12 * 12 * 2  # 588
# Fq products per point operation (crypto/device/curve.py formulas): an
# Fq2 square takes 2 Fq products, an Fq2 product 3 (Karatsuba).
# G1 as (products, squares): 2 + 5, 12 + 4, 6 + 2 (an Fq square is cheaper,
# FQ_SQR_IMAD below).  G2 in products only: an Fq2 square is 2 Fq products,
# neither of them a square.
G1_DBL, G1_ADD, G1_EQ = (2, 5), (12, 4), (6, 2)
G2_DBL, G2_ADD, G2_EQ = 5 * 2 + 2 * 3, 4 * 2 + 12 * 3, 2 * 2 + 6 * 3
PSI = 2 * 3  # two Fq2 products
# Fq products as the kernels run them (tests/test_torch_kernel_host.py and
# tests/test_torch_pair_host.py count them on the host build of the same
# code), as (all products, critical path).  The critical path is the
# products of the longest chain: each stage's busiest lane (and the
# busiest team and block) of the lane-team kernels.  A G1 row of
# scan_g1_rows (the RLC addition at every step, its limb conversions in);
# the G1 and G2 sums' two launches at a firehose chunk (2,048 rows in one
# segment, pieces of 32: 2,047 additions, 11 tree levels of 5 rounds (G1)
# or 8 (G2), and the output conversions); a G2 row of scan_g2_rows (both
# its warps; the path is the RLC scan's warp); a pair_miller warp, with
# both affine inversions (side by side) and the limb conversions, or one
# whose pair has an identity side; pair_final's final exponentiation,
# reading one Miller value, and one Fq12 product; the Frobenius constants
# each warp of pair_final converts.  The paths explain the kernels' times;
# the bounds count the work below instead.
G1_ROW_PRODUCTS, G1_ROW_PATH = 3_221, 660
G1_SUMS_PRODUCTS, G1_SUMS_PATH = 32_755, 56
G2_SUMS_PRODUCTS, G2_SUMS_PATH = 90_074, 89
G2_ROW_PRODUCTS, G2_ROW_PATH = 5_268, 731
MILLER_PRODUCTS, MILLER_PATH = 8_219, 774
MILLER_IDENTITY_PRODUCTS, MILLER_IDENTITY_PATH = 12, 1
FINAL_EXP_PRODUCTS, FINAL_EXP_PATH = 8_208, 913
FQ12_READ_PRODUCTS, FQ12_READ_PATH = 12, 1
FQ12_MUL_PRODUCTS, FQ12_MUL_PATH = 54, 2
GAMMA_PRODUCTS = 24
# The least work of the pair check, as (Fq products, Fq squares).  An Fq
# square needs 456 multiply-adds: its 66 cross products once (doubled by
# a shift), 12 squares, then the 300 of the reduction.  Fq2 (Karatsuba):
# a product 3 products, a square 2 ((a+b)(a-b) and ab), a product by an
# Fq value 2.  Fq12 over the Fq6 tower (Beuchat et al., "High-speed
# software implementation of the optimal ate pairing over Barreto-Naehrig
# curves", 2010), in Fq2 products: a product 18, a square 12, a product
# by a line (Fq2 coefficients at w^0, w^2, w^3) 13, an inverse 2 Fq6
# squares (2 products and 3 squares each), 2 Fq6 products (6 each) and
# an Fq6 inverse (9 products, 3 squares and an Fq2 inverse: 2 Fq squares,
# 2 Fq products, one Fq inverse);
# a square in the cyclotomic subgroup 9 Fq2 squares (Granger and Scott,
# "Faster squaring in the cyclotomic subgroup of sixth degree
# extensions", 2010); a Frobenius map 5 Fq2 coefficients by a constant in
# Fq (p^2) or Fq2 (p).  An Fq inverse by Fermat needs at least 380
# squares (P - 2 has 381 bits), and one inverse serves a whole launch
# (Montgomery's trick: 3 products per further value).
FQ_SQR_IMAD = 12 * 11 + 12 * 2 + 12 + 12 * 12 * 2  # 456
FQ2_MUL, FQ2_SQR, FQ2_BY_FQ = 3, 2, 2
FQ12_MUL, FQ12_SQR, FQ12_LINE, FQ12_CYC_SQR = 18 * 3, 12 * 3, 13 * 3, 9 * FQ2_SQR
FQ12_INV = (2 * (2 * FQ2_MUL + 3 * FQ2_SQR) + 2 * 6 * FQ2_MUL + 9 * FQ2_MUL + 3 * FQ2_SQR
            + 2)  # and 2 Fq squares and one Fq inverse
FROB_P, FROB_P2 = 5 * FQ2_MUL, 5 * FQ2_BY_FQ
INV_SQUARES = 380
# The Miller loop's own step formulas (crypto/device/pairing.py
# miller_loop, whose line scaling fixes the Miller values): a doubling 5
# Fq2 products, 6 squares and 2 products by P's coordinates; an addition
# 10, 3 and 2 (Z3 = 2 H Z reuses H Z).  f starts at 1, so of the 63
# doublings and 5 additions the first square and line product are free.
DBL_STEP = 5 * FQ2_MUL + 6 * FQ2_SQR + 2 * FQ2_BY_FQ
ADD_STEP = 10 * FQ2_MUL + 3 * FQ2_SQR + 2 * FQ2_BY_FQ
MILLER_NEED = 62 * FQ12_SQR + 67 * FQ12_LINE + 63 * DBL_STEP + 5 * ADD_STEP
# Jacobian to affine: G1 3 products and a square; G2 the norm's 2
# squares, 2 products by its inverse, then a square and 3 products of Fq2.
AFFINE_NEED = (3 + 2 + FQ2_SQR + 3 * FQ2_MUL, 1 + 2)
# f^(3 (p^12 - 1) / r) as the kernel's chain (pairing.cuh final_exp):
# the easy part an inverse, 2 products and a p^2 map; the hard part 5
# powers by |x| (63 cyclotomic squares and 5 products each), 7 products,
# a p and a p^2 map, and the square of m.
POW_X = 63 * FQ12_CYC_SQR + 5 * FQ12_MUL
FINAL_EXP_NEED = (FQ12_INV + 2 * FQ12_MUL + FROB_P2 + 5 * POW_X + 7 * FQ12_MUL + FROB_P
                  + FROB_P2 + FQ12_CYC_SQR)
# The RS product is a GF(2) bit product: bits fit int8 and its sums (at
# most 8k <= 2040) an int32 accumulator, so its least time counts its
# multiply-adds at the int8 tensor-core peak (H100 SXM data sheet, dense).
INT8_OPS_PER_S = 1.979e15


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


def profiled_kernel_ms(fn, kernel: str, repeats: int) -> float:
    """Mean device time of one launch of the CUDA function ``kernel``
    over ``repeats`` calls of ``fn``, from ``torch.profiler``'s kernel
    records: the kernel's own time, without the host dispatch around it.
    The profiler now and then records no kernel at all late in a long
    process, so a session that saw none is run again, up to three."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if kernel in e.key and e.self_device_time_total > 0]
        count = sum(e.count for e in events)
        if count:
            return sum(e.self_device_time_total for e in events) / count / 1e3
    raise AssertionError(f"torch.profiler recorded no device time for {kernel} in 3 sessions")


_SASS_INSN = r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)(.*)$"
_SASS_LABEL = r"^\s*(\.L_x_\d+):"
_SASS_BRANCH = r"^\s*(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))"


def sass_loops(listing: str) -> tuple:
    """The opcodes of one function's SASS listing (``cuobjdump -sass``) in
    order, and its loops as (first, last) opcode indices: a branch back to
    an earlier label or address, and the code from there to the branch."""
    import re

    ops, at, labels, branches = [], {}, {}, []
    for line in listing.splitlines():
        label = re.match(_SASS_LABEL, line)
        if label:
            labels[label.group(1)] = len(ops)
            continue
        insn = re.match(_SASS_INSN, line)
        if not insn:
            continue
        op = insn.group(2).split(".")[0]
        at[int(insn.group(1), 16)] = len(ops)
        if op == "BRA":
            target = re.match(_SASS_BRANCH, insn.group(3).split(",")[-1])
            if target:
                branches.append((len(ops), target.group(1) or int(target.group(2), 16)))
        ops.append(op)
    loops = []
    for last, target in branches:
        first = labels.get(target) if isinstance(target, str) else at.get(target)
        if first is not None and first <= last:
            loops.append((first, last))
    return ops, loops


def sass_round_loop(listing: str, rounds: int = 24) -> str:
    """What a permutation's round loop executes: the innermost loop with
    the most LOP3s (one round's code, run ``rounds`` times), and the loop
    around it (a sponge's block loop: its other instructions run once a
    block for each round loop it holds).  Empty if there is no such loop
    (rounds as straight-line code)."""
    from collections import Counter

    ops, loops = sass_loops(listing)
    inner = [(f, l) for f, l in loops
             if not any((f2, l2) != (f, l) and f <= f2 and l2 <= l for f2, l2 in loops)]
    if not inner:
        return ""
    f, l = max(inner, key=lambda fl: ops[fl[0]:fl[1] + 1].count("LOP3"))
    body = Counter(ops[f:l + 1])
    size = l - f + 1
    text = (f"round loop {size} instructions (LOP3 {body['LOP3']}, SHF {body['SHF']}): "
            f"{rounds} x {size} = {rounds * size} executed a permutation")
    around = [(f2, l2) for f2, l2 in loops if (f2, l2) != (f, l) and f2 <= f and l <= l2]
    if around:
        f2, l2 = min(around, key=lambda fl: fl[1] - fl[0])
        held = [(g, h) for g, h in inner if f2 <= g and h <= l2 and h - g + 1 == size]
        rest = (l2 - f2 + 1 - len(held) * size) / len(held)
        text += (f"; the loop around it holds {len(held)} round loop(s) and "
                 f"{l2 - f2 + 1 - len(held) * size} other instructions: "
                 f"{rounds * size + rest:.0f} executed a block")
    return text


def sass_summary(source: str, name: str, function: str = "") -> str:
    """Instruction counts of the built kernel's machine code, by opcode
    (``cuobjdump -sass`` from the toolkit beside ``nvcc``), of the whole
    library or of its functions whose name holds ``function``: the code's
    size.  For one function, also what its round loop executes
    (``sass_round_loop``): a check on the operation count its bound
    assumes."""
    import re
    from collections import Counter

    from hbbft_tpu_torch import build

    lib = build.build_all([source])[source]
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    parts = re.split(r"^\s*Function : ", sass, flags=re.M)
    if function:
        parts = [p for p in parts[1:] if function in p.split("\n", 1)[0]]
    ops = Counter(m.group(2).split(".")[0] for p in parts
                  for m in re.finditer(_SASS_INSN, p, re.M))
    top = ", ".join(f"{op} {n}" for op, n in ops.most_common(8))
    text = f"{name} SASS: {sum(ops.values())} instructions of code ({top})"
    loop = sass_round_loop(parts[0]) if function and len(parts) == 1 else ""
    return f"{text}; {loop}" if loop else text


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
    log(sass_summary("keccak", K.KERNEL, function="sha3_256_kernel"))
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
    }, phase_tree(card)]


def tree_work(values: int, n: int, s: int) -> tuple:
    """Permutations and bytes of the Merkle trees of ``values`` values of
    n shards of s bytes (each shard read once, every level written once),
    and the permutations on one thread's critical path (a leaf's blocks,
    then one node a level)."""
    from hbbft_tpu_torch.ops.device import keccak as K
    from hbbft_tpu_torch.ops.merkle import _depth

    size = 1 << _depth(n)
    leaf_blocks = (1 + s) // K.RATE + 1
    perms = values * (n * leaf_blocks + size - 1)
    n_bytes = values * (n * s + (2 * size - 1) * 32)
    return perms, n_bytes, leaf_blocks + _depth(n)


def phase_tree(card: str) -> dict:
    """keccak_merkle_tree against its plain version (tree_levels_plain on
    the card) and the host Merkle tree, at the data plane's N = 104 shape
    and at a padded odd one; timed at N = 104."""
    from hbbft_tpu_torch.ops.device import dataplane as dp
    from hbbft_tpu_torch.ops.device import keccak as K
    from hbbft_tpu_torch.ops.merkle import MerkleTree

    rng = np.random.default_rng(7)
    err = 0
    for values, n, s in ((104, 104, 1778), (3, 7, 135)):
        shards = rng.integers(0, 256, size=(values, n, s), dtype=np.uint8)
        on_card = torch.as_tensor(shards, device="cuda")
        got = K.merkle_tree_kernel(on_card)
        want = dp.tree_levels_plain(on_card, n)
        torch.cuda.synchronize()
        err = max(err, int((got.to(torch.int16) - want.to(torch.int16)).abs().max()))
        if err:
            raise AssertionError(f"keccak_merkle_tree != tree_levels_plain at {values}x{n}x{s}")
        host = got.cpu().numpy()
        for v in (0, values - 1):
            tree = MerkleTree([shards[v, i].tobytes() for i in range(n)])
            if host[v].tobytes() != b"".join(h for level in tree.levels for h in level):
                raise AssertionError(f"keccak_merkle_tree != host MerkleTree at value {v}, "
                                     f"{values}x{n}x{s}")
        log(f"keccak_merkle_tree {values} values x {n} shards x {s} bytes: byte-identical to "
            f"tree_levels_plain and the host MerkleTree  [{card}]")
    # Timed at N = 104 (the loop's last shape is the padded one; redo it).
    values, n, s = 104, 104, 1778
    on_card = torch.as_tensor(rng.integers(0, 256, size=(values, n, s), dtype=np.uint8),
                              device="cuda")
    ms = cuda_time_ms(lambda: K.merkle_tree_kernel(on_card), 20)
    plain_ms = cuda_time_ms(lambda: dp.tree_levels_plain(on_card, n), 3)
    perms, n_bytes, path = tree_work(values, n, s)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = perms * KECCAK_INT32_OPS_PER_PERM / INT32_OPS_PER_S * 1e3
    log(sass_summary("keccak", K.TREE_KERNEL, function="merkle_tree_kernel"))
    log(f"keccak_merkle_tree at N={n} ({values} trees, {s}-byte shards): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
        f"int32 ops {ops_ms:.4f}; {perms} permutations, {n_bytes} bytes); critical path {path} "
        f"permutations on one thread = {ms * 1e3 / path:.2f} us each  [{card}]")
    return {
        "name": K.TREE_KERNEL, "route": "cuda", "source": "hbbft_tpu_torch/csrc/keccak.cu",
        "replaces": "hbbft_tpu/ops/jaxops/keccak_pallas.py:50", "launches": None,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None,
    }


def free_mib() -> float:
    """The card's free memory after the queued work, MiB
    (``cudaMemGetInfo``): a kernel's first launch lowers it by the local
    memory CUDA reserves for its stack frame."""
    torch.cuda.synchronize()
    return torch.cuda.mem_get_info()[0] / 2**20


def bound(n_bytes: float, n_imad: float) -> tuple:
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_imad / IMAD_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def canonical(limbs: torch.Tensor) -> list:
    from hbbft_tpu_torch.crypto.device import fq

    return [fq.from_limbs_int(row) % fq.P for row in limbs.reshape(-1, fq.NL).cpu()]


def phase_field(card: str) -> dict:
    """K4 against the plain product on 2,048 rows, edge limbs included."""
    from hbbft_tpu_torch.crypto.device import fq

    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(49), "little") % (1 << 386) for _ in range(2048)]
    vals[:6] = [0, 1, fq.P - 1, fq.P, 2 * fq.P, (1 << 386) - 1]
    a = torch.as_tensor(fq.ints_to_limbs_batch(vals), device="cuda")
    a[6, :35:3] = 4096  # limbs at the top of the range, value < 2^386
    a[6, 35] = 0
    a[7, :35] = 4095
    a[7, 35] = 0
    b = a.flip(0).contiguous()
    got = fq.mont_mul_kernel(a, b)
    want = fq.mont_mul_plain(a, b)
    torch.cuda.synchronize()
    if int(got.min()) < 0 or int(got.max()) >= 2048:
        raise AssertionError("fq_mont_mul: output limbs are not strict")
    bad = sum(x != y for x, y in zip(canonical(got), canonical(want)))
    if bad:
        raise AssertionError(f"fq_mont_mul != plain mont_mul on {bad} of 2048 rows")
    # The kernel's own time (the profiler's kernel records); one wrapper
    # call under CUDA events mostly times its host dispatch.
    ms = profiled_kernel_ms(lambda: fq.mont_mul_kernel(a, b), "fq_mont_mul_kernel", 200)
    call_ms = cuda_time_ms(lambda: fq.mont_mul_kernel(a, b), 50)
    plain_ms = cuda_time_ms(lambda: fq.mont_mul_plain(a, b), 10)
    n = a.shape[0]
    bound_ms, bound_by = bound(n * 3 * fq.NL * 8, n * 2 * FQ_MUL_IMAD)
    log(f"fq_mont_mul 2048 rows (edge limbs 4096, values up to 2^386 - 1, 0, P - 1): "
        f"== plain canonically; kernel {ms:.5f} ms (profiler, mean of 200 launches; one "
        f"wrapper call {call_ms:.4f} ms under CUDA events), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by})  [{card}]")
    return {
        "name": fq.KERNEL, "route": "cuda", "source": "hbbft_tpu_torch/csrc/fq.cu",
        "replaces": "hbbft_tpu/crypto/tpu/fq.py:208", "launches": None, "max_abs_err": bad,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


def _same_points(p, q, group: int) -> bool:
    from hbbft_tpu_torch.crypto.bls import curve as oc
    from hbbft_tpu_torch.crypto.device import curve as dc

    frm, ops = (dc.g1_from_dev, oc.FQ_OPS) if group == 1 else (dc.g2_from_dev, oc.FQ2_OPS)
    host = tuple(c.cpu() for c in p), tuple(c.cpu() for c in q)
    return all(oc.jac_eq(ops, frm(host[0], i), frm(host[1], i)) for i in range(p[3].shape[0]))


def _scan_work(inp) -> dict:
    """Bytes, Fq products and Fq squares each K2 kernel needs for these
    inputs, from the curve.py formulas: doublings always run; an addition
    costs nothing when an operand is the identity (add_unsafe routes on the
    flag), so the first set bit of a scan and identity rows add nothing."""
    w1 = inp.g1_words.cpu().numpy().view(np.uint32).astype(object)
    w2 = inp.g2_words.cpu().numpy().view(np.uint32).astype(object)
    inf1 = inp.g1_pts[3].cpu().numpy()
    inf2 = inp.g2_pts[3].cpu().numpy()
    xabs = 0xD201000000010000
    prod1 = sqr1 = 0
    for words, inf in zip(w1, inf1):
        c = sum(int(v) << (32 * i) for i, v in enumerate(words))
        adds = 0 if inf else max(bin(c).count("1") - 1, 0) + 16
        prod1 += 3 + 127 * G1_DBL[0] + adds * G1_ADD[0] + 1 + G1_EQ[0]
        sqr1 += 127 * G1_DBL[1] + adds * G1_ADD[1] + G1_EQ[1]
    prod2 = 0
    for words, inf in zip(w2, inf2):
        sq = sum(int(v) << (32 * i) for i, v in enumerate(words))
        s, q = sq & ((1 << 64) - 1), sq >> 64
        steps = sum(1 for k in range(65) if (s >> k) & 1 or (q >> k) & 1)
        adds = 0 if inf else 1 + max(steps - 1, 0) + 5
        prod2 += 6 + PSI + (65 + 63) * G2_DBL + adds * G2_ADD + PSI + G2_EQ
    n1, n2 = len(w1), len(w2)
    p1, s1 = inp.g1_pieces.shape[0] - 1, inp.g1_segments.shape[0] - 1
    p2, s2 = inp.g2_pieces.shape[0] - 1, inp.g2_segments.shape[0] - 1
    rec1, rec2 = 37 * 4, 73 * 4
    return {
        "scan_g1_rows": (n1 * (3 * 36 * 8 + 8 + 16 + 4 + 4) + n1 * rec1, prod1, sqr1),
        "scan_g2_rows": (n2 * (3 * 72 * 8 + 8 + 20 + 4 + 4) + n2 * rec2, prod2, 0),
        "scan_g1_sums": ((n1 + 2 * p1) * rec1 + s1 * (3 * 36 * 8 + 8),
                         (n1 - s1) * G1_ADD[0] + 3 * s1, (n1 - s1) * G1_ADD[1]),
        "scan_g2_sums": ((n2 + 2 * p2) * rec2 + s2 * (3 * 72 * 8 + 8),
                         (n2 - s2) * G2_ADD + 6 * s2, 0),
    }


def _check_scan(be, subsets, what: str, want_ok: list, card: str) -> None:
    """K2 against the plain scan_stage on the same subsets, on the card."""
    from hbbft_tpu_torch.crypto.device import backend as dbackend
    from hbbft_tpu_torch.crypto.device import scan as dscan

    inp, _ = be._scan_prep(subsets)
    args, _ = be._scan_prep(subsets, kernel=False)
    got = dscan.scan_stage_kernel(inp)
    want = dbackend.scan_stage(*args)
    torch.cuda.synchronize()
    if got[0].tolist() != want[0].tolist() or got[0].tolist() != want_ok:
        raise AssertionError(f"scan kernels at {what}: sub_ok {got[0].tolist()} != plain "
                             f"{want[0].tolist()} (expected {want_ok})")
    bad = sum(not _same_points(tuple(c[i:i + 1] for c in got[k]),
                               tuple(c[i:i + 1] for c in want[k]), k)
              for k in (1, 2) for i in range(got[k][3].shape[0]))
    if bad:
        raise AssertionError(f"scan kernels at {what}: {bad} pairs != plain scan_stage")
    log(f"scan kernels at {what} ({inp.g1_words.shape[0]} G1 + {inp.g2_words.shape[0]} G2 rows, "
        f"{got[1][3].shape[0]} pairs): sub_ok {got[0].tolist()} and pairs == plain scan_stage  "
        f"[{card}]")
    return bad


def phase_scan(card: str, firehose: list, mixed: list) -> list:
    """K2: each kernel timed at one firehose chunk against its plain
    counterpart; the whole stage held against the plain scan_stage at the
    chunk and at the mixed-512 batch in one subset."""
    from hbbft_tpu_torch.crypto.backend import request_well_formed
    from hbbft_tpu_torch.crypto.device import backend as dbackend
    from hbbft_tpu_torch.crypto.device import curve as dc
    from hbbft_tpu_torch.crypto.device import scan as dscan
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend

    be = TorchBackend(device="cuda")
    chunk = [firehose[: be.chunk]]
    inp, _ = be._scan_prep(chunk)
    before = free_mib()
    dscan.scan_stage_kernel(inp)
    log(f"device free memory at the first K2 launches: {before:.0f} MiB before, "
        f"{free_mib():.0f} MiB after (the drop is mostly local memory for their stack "
        f"frames)  [{card}]")
    err = _check_scan(be, chunk, "one firehose chunk", [True], card)
    wf = [r for r in mixed if request_well_formed(be.suite, r, subgroup=False)]
    err += _check_scan(be, [wf], "the mixed-512 batch (forged point in it)", [False], card)

    args, _ = be._scan_prep(chunk, kernel=False)
    g1_pts, g1_bits, _, seg, _, g2_pts, bits_s, bits_q, _, g2_sub, _, _ = args
    sub_ok = torch.ones((1,), dtype=torch.int32, device="cuda")
    scaled1 = dscan.rows(1, inp, sub_ok)
    scaled2 = dscan.rows(2, inp, sub_ok)
    timed = {
        dscan.G1_ROWS: (lambda: dscan.rows(1, inp, sub_ok), 5),
        dscan.G2_ROWS: (lambda: dscan.rows(2, inp, sub_ok), 5),
        dscan.G1_SUMS: (lambda: dscan.sums(1, inp, scaled1), 20),
        dscan.G2_SUMS: (lambda: dscan.sums(2, inp, scaled2), 20),
    }
    with torch.inference_mode():
        p_scaled1, _ = dc.scalar_mul_rlc_g1(g1_pts, g1_bits)
        p_scaled2, _ = dc.scalar_mul_rlc_g2(g2_pts, bits_s, bits_q)

        def plain_rows1():
            _, chain = dc.scalar_mul_rlc_g1(g1_pts, g1_bits)
            return dc.endo_subgroup_eq(dc.G1_OPS, g1_pts, chain)

        def plain_rows2():
            _, chain = dc.scalar_mul_rlc_g2(g2_pts, bits_s, bits_q)
            return dc.endo_subgroup_eq(dc.G2_OPS, g2_pts, chain)

        plain = {
            dscan.G1_ROWS: plain_rows1,
            dscan.G2_ROWS: plain_rows2,
            dscan.G1_SUMS: lambda: dbackend._masked_sums(dc.G1_OPS, p_scaled1, seg),
            dscan.G2_SUMS: lambda: dbackend._masked_sums(dc.G2_OPS, p_scaled2, g2_sub),
        }
        work = _scan_work(inp)
        rows1, rows2 = inp.g1_words.shape[0], inp.g2_words.shape[0]
        # The lane-team kernels' own work and critical path (host-counted
        # constants; the G2 sums' are those of this chunk's layout).
        team_work = {
            dscan.G1_ROWS: (G1_ROW_PRODUCTS * rows1, G1_ROW_PATH),
            dscan.G2_ROWS: (G2_ROW_PRODUCTS * rows2, G2_ROW_PATH),
            dscan.G1_SUMS: (G1_SUMS_PRODUCTS, G1_SUMS_PATH),
            dscan.G2_SUMS: (G2_SUMS_PRODUCTS, G2_SUMS_PATH),
        }
        out = []
        for name in dscan.KERNELS:
            fn, repeats = timed[name]
            ms = cuda_time_ms(fn, repeats)
            plain_ms = cuda_time_ms(plain[name], 1)
            n_bytes, products, squares = work[name]
            bound_ms, bound_by = bound(n_bytes, products * FQ_MUL_IMAD + squares * FQ_SQR_IMAD)
            chain = ""
            if name in team_work:
                products_run, path = team_work[name]
                chain = (f"; the kernel's work {products_run} Fq products, its critical path "
                         f"{path} = {ms * 1e3 / path:.3f} us per product")
            log(f"{name} at one firehose chunk: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {products} Fq products and {squares} squares, "
                f"{n_bytes} bytes){chain}  [{card}]")
            out.append({
                "name": name, "route": "cuda", "source": "hbbft_tpu_torch/csrc/scan.cu",
                "replaces": "hbbft_tpu/crypto/tpu/backend.py:79", "launches": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
            })
    log(sass_summary("scan", "scan kernels"))
    return out


def _pair_work(lhs, rhs, pair_sub, n_sub: int) -> dict:
    """Bytes and least multiply-adds of each K3 kernel's function for
    these pairs, the kernel's critical path in Fq products (that of the
    busiest warp) and all the Fq products the kernel runs.  A pair with an
    identity side needs no work (its value is 1); a subset of c pairs
    multiplies c - 1 Miller values; each launch shares one Fermat inverse
    among its values."""
    skip = (lhs[3] | rhs[3]).cpu().tolist()
    counts = np.bincount(pair_sub, minlength=n_sub).tolist()
    n, live, fq12_bytes = len(skip), skip.count(False), 12 * 36 * 8

    def imad(products: int, squares: int, inverses: int) -> int:
        products += 3 * max(inverses - 1, 0)
        squares += INV_SQUARES if inverses else 0
        return products * FQ_MUL_IMAD + squares * FQ_SQR_IMAD

    miller_need = imad(live * (MILLER_NEED + AFFINE_NEED[0]), live * AFFINE_NEED[1], 2 * live)
    final_need = imad(sum(FINAL_EXP_NEED + FQ12_MUL * (c - 1) for c in counts if c),
                      2 * sum(1 for c in counts if c), sum(1 for c in counts if c))
    miller_chain = MILLER_IDENTITY_PATH if all(skip) else MILLER_PATH
    final_chain = FINAL_EXP_PATH + FQ12_READ_PATH * max(counts) + FQ12_MUL_PATH * max(
        max(counts) - 1, 0)
    final_work = sum(GAMMA_PRODUCTS + FINAL_EXP_PRODUCTS + FQ12_READ_PRODUCTS * c
                     + FQ12_MUL_PRODUCTS * max(c - 1, 0) for c in counts)
    return {
        "pair_miller": (n * (3 * 36 * 8 + 8 + 3 * 72 * 8 + 8 + fq12_bytes), miller_need,
                        miller_chain,
                        MILLER_IDENTITY_PRODUCTS * (n - live) + MILLER_PRODUCTS * live),
        "pair_final": (n * fq12_bytes + (n_sub + 1 + n + n_sub) * 4 + 12 * 72 * 8, final_need,
                       final_chain, final_work),
    }


def _bisection_levels(be, mixed: list) -> list:
    """The subsets TorchBackend's bisection checks in one flush of the
    mixed batch, level by level, as request indices (recorded from
    ``_aggregate_ok_many``, so they follow whatever halving ``_bisect``
    does)."""
    seen = []
    check = be._aggregate_ok_many

    def record(subsets):
        seen.append([list(s) for s in subsets])
        return check(subsets)

    be._aggregate_ok_many = record
    try:
        be.verify_batch(mixed)
    finally:
        del be._aggregate_ok_many
    index = {id(r): i for i, r in enumerate(mixed)}
    return [[[index[id(r)] for r in s] for s in level] for level in seen]


def _check_pair(lhs, rhs, pair_sub, n_sub: int, what: str, card: str):
    """K3 against the plain pair stage on the same pairs, on the card:
    verdicts equal, Miller values equal as canonical Fq12."""
    from hbbft_tpu_torch.crypto.device import backend as dbackend
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import pairing as dpairing

    fs = dpair.miller_values_kernel(lhs, rhs)
    got = dpair.pair_stage_kernel(lhs, rhs, pair_sub, n_sub)
    want_fs = dpairing.miller_values(lhs, rhs)
    want = dbackend.pair_stage_plain(lhs, rhs, pair_sub, n_sub)
    torch.cuda.synchronize()
    if got.tolist() != want.tolist():
        raise AssertionError(f"pair kernels at {what}: verdicts {got.tolist()} != plain "
                             f"{want.tolist()}")
    bad = sum(x != y for x, y in zip(canonical(fs), canonical(want_fs)))
    if bad:
        raise AssertionError(f"pair_miller at {what}: {bad} Fq values != plain miller_values")
    if int(fs.min()) < 0 or int(fs.max()) >= 2048:
        raise AssertionError(f"pair_miller at {what}: output limbs are not strict")
    log(f"pair kernels at {what} ({fs.shape[0]} pairs, {n_sub} subsets): verdicts "
        f"{got.tolist()} and Miller values == plain pair stage  [{card}]")
    return got, bad


def phase_pair(card: str, firehose: list, mixed: list, bad: list) -> list:
    """K3: the pair stage held against the plain one on the firehose's
    combined pairs (5 chunks, one subset) and on every mixed-512
    bisection level; each kernel timed at the firehose pairs against its
    plain counterpart, and at the last level."""
    from hbbft_tpu_torch.crypto.device import backend as dbackend
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import pairing as dpairing
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend

    be = TorchBackend(device="cuda")
    chunks = [firehose[s: s + be.chunk] for s in range(0, len(firehose), be.chunk)]
    scans = [be._scan([c]) for c in chunks]
    lhs = tuple(torch.cat([s[1][c] for s in scans]) for c in range(4))
    rhs = tuple(torch.cat([s[2][c] for s in scans]) for c in range(4))
    pair_sub = [0] * lhs[3].shape[0]
    free = [free_mib()]
    dpair.miller_values_kernel(lhs, rhs)
    free.append(free_mib())
    dpair.pair_stage_kernel(lhs, rhs, pair_sub, 1)
    free.append(free_mib())
    log(f"device free memory at the first K3 launches: {free[0]:.0f} MiB before, {free[1]:.0f} "
        f"after pair_miller, {free[2]:.0f} after pair_final (the drops are mostly local memory "
        f"for stack frames larger than the earlier kernels')  [{card}]")
    got, err = _check_pair(lhs, rhs, pair_sub, 1, f"the firehose's {len(chunks)} chunks", card)
    if got.tolist() != [True]:
        raise AssertionError("pair kernels: the firehose's valid shares were rejected")

    levels = _bisection_levels(be, mixed)
    if not any(max(len(h) for h in lv) <= 2 for lv in levels):
        raise AssertionError("the mixed-512 bisection never checked subsets of two or one")
    for level in levels:
        sub_ok, llhs, lrhs, lsub = be._scan([[mixed[i] for i in h] for h in level])
        lgot, lerr = _check_pair(llhs, lrhs, lsub, len(level),
                                 f"a mixed-512 bisection level ({len(level)} halves of "
                                 f"{sorted({len(h) for h in level})} requests)", card)
        want = [not (set(h) & set(bad)) for h in level]
        if (lgot & sub_ok).tolist() != want:
            raise AssertionError(f"bisection level: verdicts {(lgot & sub_ok).tolist()} != {want}")
        err += lerr

    offsets, members = dpair.subset_members(pair_sub, 1)
    off_t = torch.as_tensor(offsets, device="cuda")
    mem_t = torch.as_tensor(members, device="cuda")
    fs = dpair.miller_values_kernel(lhs, rhs)
    with torch.inference_mode():
        # pair_final's plain counterpart is the plain stage less its
        # Miller values: the ordered products and the final exponentiation.
        plain_miller_ms = cuda_time_ms(lambda: dpairing.miller_values(lhs, rhs), 1)
        plain_stage_ms = cuda_time_ms(
            lambda: dbackend.pair_stage_plain(lhs, rhs, pair_sub, 1), 1)
        timed = {
            dpair.MILLER: (lambda: dpair.miller_values_kernel(lhs, rhs), plain_miller_ms),
            dpair.FINAL: (lambda: dpair.final_kernel(fs, off_t, mem_t, 1),
                          plain_stage_ms - plain_miller_ms),
        }
        work = _pair_work(lhs, rhs, pair_sub, 1)
        out = []
        for name in dpair.KERNELS:
            kernel, plain_ms = timed[name]
            ms = cuda_time_ms(kernel, 10)
            n_bytes, n_imad, serial, products = work[name]
            bound_ms, bound_by = bound(n_bytes, n_imad)
            log(f"{name} at the firehose's {len(pair_sub)} pairs: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.1f} ms, bound {bound_ms:.5f} ms ({bound_by}; {n_imad} multiply-adds "
                f"of the pair check, {n_bytes} bytes); the kernel's work {products} Fq products, "
                f"its critical path {serial} = {ms * 1e3 / serial:.3f} us per product  [{card}]")
            out.append({
                "name": name, "route": "cuda", "source": "hbbft_tpu_torch/csrc/pair.cu",
                "replaces": "hbbft_tpu/crypto/tpu/backend.py:137", "launches": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
            })
        stage_ms = cuda_time_ms(lambda: dpair.pair_stage_kernel(lhs, rhs, pair_sub, 1), 10)
        level_ms = cuda_time_ms(
            lambda: dpair.pair_stage_kernel(llhs, lrhs, lsub, len(level)), 5)
        l_off, l_mem = (torch.as_tensor(a, device="cuda")
                        for a in dpair.subset_members(lsub, len(level)))
        l_fs = dpair.miller_values_kernel(llhs, lrhs)
        level_miller_ms = cuda_time_ms(lambda: dpair.miller_values_kernel(llhs, lrhs), 5)
        level_final_ms = cuda_time_ms(
            lambda: dpair.final_kernel(l_fs, l_off, l_mem, len(level)), 5)
    log(f"pair stage at the firehose's pairs: K3 {stage_ms:.3f} ms, plain {plain_stage_ms:.1f} ms; "
        f"K3 at the last bisection level ({llhs[3].shape[0]} pairs, {len(level)} subsets) "
        f"{level_ms:.3f} ms, its pair_miller {level_miller_ms:.3f} ms, its pair_final "
        f"{level_final_ms:.3f} ms  [{card}]")
    log(sass_summary("pair", "pair kernels"))
    return out


def phase_dataplane(card: str) -> dict:
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.ops.device import keccak as K
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
            if proofs[v][i].root != tree.root or proofs[v][i].path != tree.proof(i).path:
                raise AssertionError(f"value {v} shard {i}: proof != host MerkleTree's")
    bad = [(v, i) for v in range(n) for i in range(n)
           if not proofs[v][i].validate(n) or proofs[v][i].root != proofs[v][0].root]
    if bad:
        raise AssertionError(f"{len(bad)} proofs do not verify, first {bad[:3]}")
    # One tree launch for the leaves and every level; no sponge launch.
    if launches.get(K.TREE_KERNEL, 0) != 1 or launches.get(K.KERNEL, 0) != 0:
        raise AssertionError(f"keccak launches {launches} over one data-plane epoch: expected "
                             f"1 {K.TREE_KERNEL} and no {K.KERNEL}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        encode_and_prove(values, k, n, device="cuda")
        times.append(time.perf_counter() - t0)
    log(f"data plane N={n} k={k} 64000-byte values: all {n}x{n} proofs verified; "
        f"keccak launches {json.dumps(launches, sort_keys=True)}; first run {epoch_s:.3f} s, "
        f"median of 3 warm runs {statistics.median(times):.3f} s per epoch  [{card}]")

    # Its two device stages alone: the RS bit product (K5) and the leaf and
    # level hashing on the tree kernel (K6); the rest of an epoch is host
    # packing and proof assembly.
    from hbbft_tpu_torch.ops.device.dataplane import _pack, rs_shards, tree_levels

    with torch.inference_mode():
        data = torch.as_tensor(np.stack([_pack(v, k)[0] for v in values]), device="cuda")
        shards = rs_shards(data, n)
        rs_ms = cuda_time_ms(lambda: rs_shards(data, n), 10)
        tree_ms = cuda_time_ms(lambda: tree_levels(shards, n), 10)
    s = shards.shape[2]
    rs_bytes = len(values) * (k + n) * s
    rs_ops = 2 * (8 * (n - k)) * (8 * k) * len(values) * s
    rs_bound, rs_by = max((rs_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                          (rs_ops / INT8_OPS_PER_S * 1e3, "operations"))
    perms, tree_bytes, _ = tree_work(len(values), n, s)
    tree_bound, tree_by = max((tree_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                              (perms * KECCAK_INT32_OPS_PER_PERM / INT32_OPS_PER_S * 1e3,
                               "operations"))
    log(f"data plane stages at N={n}: RS bit product (K5, plain matmul) {rs_ms:.4f} ms, bound "
        f"{rs_bound:.4f} ms ({rs_by}; {rs_ops} int8 multiply-add ops, {rs_bytes} bytes); leaf and "
        f"level hashing (K6, tree_levels: one {K.TREE_KERNEL} launch) {tree_ms:.4f} ms, "
        f"bound {tree_bound:.4f} ms ({tree_by}; {perms} permutations, {tree_bytes} bytes)  "
        f"[{card}]")
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


class FlushLog:
    """A ``CryptoBackend`` in front of another: passes every flush on,
    keeps its requests and verdicts (checked against the host afterwards,
    outside the timed run), and times it on the host clock."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.flushes: list = []  # (requests, verdicts)
        self.seconds = 0.0

    def verify_batch(self, reqs):
        reqs = list(reqs)
        t0 = time.perf_counter()
        out = self.inner.verify_batch(reqs)
        self.seconds += time.perf_counter() - t0
        self.flushes.append((reqs, list(out)))
        return out

    def sizes(self) -> list:
        return [len(r) for r, _ in self.flushes]

    def verdicts(self) -> list:
        return [v for _, out in self.flushes for v in out]


def instrument(be) -> dict:
    """Time ``TorchBackend`` ``be``'s stages over the flushes that follow,
    each with a sync around it: host prep, scan (``_scan``'s time, the
    prep inside it included), the pair check of each flush, the bisections
    after a failed check (their own prep, scan and pair included) and the
    levels inside them (one scan and one pair stage a level), and the
    single failing requests that bisection sends to the host
    ``EagerBackend``."""
    stats = {"prep": 0.0, "scan": 0.0, "pair": 0.0, "bisect": 0.0, "bisections": 0,
             "level": 0.0, "levels": 0, "eager": 0.0, "eager_requests": 0}

    def timed(name, fn, count=None, of=lambda args: 1):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stats[name] += time.perf_counter() - t0
            if count:
                stats[count] += of(args)
            return out
        return run

    be._scan_prep = timed("prep", be._scan_prep)
    be._scan = timed("scan", be._scan)
    be._check_parts = timed("pair", be._check_parts)
    be._bisect = timed("bisect", be._bisect, "bisections")
    be._aggregate_ok_many = timed("level", be._aggregate_ok_many, "levels")
    be._eager.verify_batch = timed("eager", be._eager.verify_batch, "eager_requests",
                                   lambda args: len(args[0]))
    return stats


def uninstrument(be) -> None:
    """Take :func:`instrument`'s timers off ``be``."""
    for name in ("_scan_prep", "_scan", "_check_parts", "_bisect", "_aggregate_ok_many"):
        delattr(be, name)
    del be._eager.verify_batch


def phase_flush(card: str, suite, reqs: list, mixed: list, bad: list) -> dict:
    """The flush end to end on the card; returns the kernels' launches
    over one warm firehose flush (the counts set to 0 just before it)."""
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.backend import EagerBackend
    from hbbft_tpu_torch.crypto.device import fq
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import scan as dscan
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend

    # The field layer under both stages: one product (K4) and one plain
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

    be = TorchBackend(suite, device="cuda")

    # First flush: host prep, scan and pair each timed with a sync around
    # it (the scan's own time is _scan's less the prep inside it).
    stage = instrument(be)
    t0 = time.perf_counter()
    first = be.verify_batch(reqs)
    first_s = time.perf_counter() - t0
    uninstrument(be)
    if not all(first):
        raise AssertionError("firehose: a valid share was rejected")
    scan_s = stage["scan"] - stage["prep"]

    # Second flush: end to end, no extra syncs, launches counted.
    build.reset_launches()
    t0 = time.perf_counter()
    warm = be.verify_batch(reqs)
    warm_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if not all(warm):
        raise AssertionError("firehose (warm): a valid share was rejected")
    missing = [k for k in (*dscan.KERNELS, *dpair.KERNELS) if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"the flush launched no {missing}: launches {launches}")
    n_chunks = -(-len(reqs) // be.chunk)
    log(f"flush firehose {len(reqs)} sig shares, {n_chunks} chunks of {be.chunk}: all True; "
        f"warm {warm_s:.3f} s = {len(reqs) / warm_s:.1f} verifies/s; first (stage-timed) "
        f"{first_s:.3f} s: host prep {stage['prep']:.3f} s, scan {scan_s:.3f} s over {n_chunks} "
        f"chunks, pair {stage['pair']:.3f} s  [{card}]")
    log(f"flush firehose launches over the warm flush: {json.dumps(launches, sort_keys=True)}")

    # Third flush under torch.profiler: the device's busy share.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        be.verify_batch(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    share = f"{100 * busy_us / wall_us:.2f}%" if busy_us > 0 else "not measured"
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:6]
    log(f"flush firehose under torch.profiler: device busy {busy_us:.0f} us of {wall_us:.0f} us "
        f"wall = {share}; by kernel: "
        + "; ".join(f"{e.key[:40]} {e.self_device_time_total:.0f} us x{e.count}" for e in top)
        + f"  [{card}]")

    t0 = time.perf_counter()
    got = be.verify_batch(mixed)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = _host_verdicts_split(suite, mixed)
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
        f"TorchBackend {dev_s:.3f} s, BatchedBackend (host, {os.cpu_count()} processes) "
        f"{host_s:.2f} s  [{card}]")
    return launches


def _hb_run(NetBuilder, HoneyBadger, EncryptionSchedule, suite, backend, n: int, seed: int,
            contributions, adversary=None, num_faulty=None):
    """``tests/test_honey_badger.py`` ``build_hb_net`` + ``run_epochs`` on
    ``suite`` and ``backend`` (a ``FlushLog``), pools flushed when the net
    idles, one epoch per entry of ``contributions`` (each a function of
    the node id); returns the net and the proposed contributions."""
    b = (NetBuilder(n, seed=seed).suite(suite).backend(lambda s: backend)
         .flush_every(100_000)
         .protocol(lambda ni, sink, rng: HoneyBadger(
             ni, sink, session_id=b"hb-test", max_future_epochs=3,
             encryption_schedule=EncryptionSchedule.always())))
    if adversary is not None:
        b = b.adversary(adversary)
    if num_faulty is not None:
        b = b.num_faulty(num_faulty)
    net = b.build()
    proposed = []
    for epoch, contribution in enumerate(contributions):
        txs = {nid: contribution(nid) for nid in net.correct_ids}
        proposed.append(txs)
        for nid in net.correct_ids:
            net.send_input(nid, txs[nid])
        net.crank_until(lambda nn: all(len(nn.node(i).outputs) > epoch for i in nn.correct_ids),
                        max_cranks=2_000_000)
    return net, proposed


def _check_batches(net, proposed, what: str) -> None:
    """Every correct node commits the same batch per epoch, with at least
    N - f contributions, each exactly as proposed."""
    for epoch, txs in enumerate(proposed):
        batches = [net.node(i).outputs[epoch] for i in net.correct_ids]
        if any(b != batches[0] for b in batches):
            raise AssertionError(f"{what}: epoch {epoch} batches differ between correct nodes")
        got = batches[0].contribution_map()
        if batches[0].epoch != epoch or len(got) < net.node(net.correct_ids[0]).netinfo.num_correct:
            raise AssertionError(f"{what}: epoch {epoch} batch {batches[0]} too small")
        wrong = [p for p, c in got.items() if p in txs and c != txs[p]]
        if wrong:
            raise AssertionError(f"{what}: epoch {epoch} contributions of {wrong} != proposed")


def _host_verdicts(args) -> list:
    """One flush's verdicts from the host ``BatchedBackend`` (a worker of
    the process pools of :func:`_host_check` and :func:`_host_verdicts_split`)."""
    from hbbft_tpu_torch.crypto.backend import BatchedBackend

    suite, reqs = args
    return BatchedBackend(suite).verify_batch(reqs)


def _host_verdicts_split(suite, reqs: list) -> list:
    """The host ``BatchedBackend``'s verdicts on ``reqs``, one contiguous
    part a worker process: a verdict is a function of its request alone,
    so the parts' verdicts, joined, are the whole batch's."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    step = -(-len(reqs) // (os.cpu_count() or 1))
    parts = [(suite, reqs[s:s + step]) for s in range(0, len(reqs), step)]
    with ProcessPoolExecutor(max_workers=len(parts),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return [v for part in pool.map(_host_verdicts, parts) for v in part]


def _host_check(suite, log_, first: int | None, what: str, also: tuple = ()) -> float:
    """Hold the card's verdicts of the first ``first`` flushes (all when
    None), and of the flushes at the indices ``also``, against the host
    ``BatchedBackend`` on the same requests, one flush per worker process
    (host pairings take ~1 s a flush), and return the wall time that took."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    flushes = log_.flushes[:first] + [log_.flushes[i] for i in also]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=min(len(flushes), os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        host = list(pool.map(_host_verdicts, [(suite, reqs) for reqs, _ in flushes]))
    for i, ((reqs, card), want) in enumerate(zip(flushes, host)):
        if want != card:
            raise AssertionError(f"{what}: flush {i} ({len(reqs)} requests): "
                                 f"TorchBackend verdicts != BatchedBackend's")
    return time.perf_counter() - t0


def _stage_line(stats: dict, total: float) -> str:
    return (f"TorchBackend {total:.3f} s over the flushes: host prep {stats['prep']:.3f} s, "
            f"scan {stats['scan'] - stats['prep']:.3f} s, pair {stats['pair']:.3f} s, "
            f"bisection {stats['bisect']:.3f} s in {stats['bisections']} flushes (its own "
            f"prep and scan counted above too), EagerBackend leaf {stats['eager']:.3f} s for "
            f"{stats['eager_requests']} requests")


def phase_consensus(card: str) -> dict:
    """The consensus plane on the card: a 16-validator HoneyBadger epoch
    (a), a 4-node epoch pair with a tampering validator (b), and the
    proposers' data plane from the protocol layer (c).  Returns the
    kernels' launches over (a)-(c), the counts set to 0 just before."""
    from torch.profiler import ProfilerActivity, profile

    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import scan as dscan
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend
    from hbbft_tpu_torch.net import NetBuilder, TamperingAdversary
    from hbbft_tpu_torch.ops.device import keccak as K
    from hbbft_tpu_torch.protocols import broadcast as pbc
    from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule, HoneyBadger
    from hbbft_tpu_torch.utils import serde

    suite = BLSSuite()
    hb = (NetBuilder, HoneyBadger, EncryptionSchedule, suite)
    flush_kernels = (*dscan.KERNELS, *dpair.KERNELS)
    build.reset_launches()

    # (a) honeybadger-16: BASELINE.json:9, tests/test_honey_badger.py:84's
    # shape: 16 validators, the last f = 5 silent, 256 transactions.
    be = TorchBackend(suite)
    stats = instrument(be)
    rec = FlushLog(be)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net, proposed = _hb_run(*hb, rec, n=16, seed=4, contributions=[
            lambda nid: [f"tx-{nid}-{i}" for i in range(256 // 16)]])
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
    launches_a = dict(build.LAUNCHES)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    share = f"{100 * busy_us / (epoch_s * 1e6):.2f}%" if busy_us > 0 else "not measured"
    _check_batches(net, proposed, "honeybadger-16")
    faults = [(nid, f.node_id, f.kind) for nid in net.correct_ids for f in net.node(nid).faults]
    if faults:
        raise AssertionError(f"honeybadger-16: faults recorded with no faulty sender: {faults[:5]}")
    verdicts = rec.verdicts()
    if not all(verdicts):
        raise AssertionError(f"honeybadger-16: {verdicts.count(False)} of {len(verdicts)} "
                             f"verdicts False, though no share was forged")
    missing = [k for k in flush_kernels if launches_a.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"honeybadger-16 launched no {missing}: {launches_a}")
    held = 4
    host_s = _host_check(suite, rec, held, "honeybadger-16")
    sizes = rec.sizes()
    log(f"consensus (a) honeybadger-16: 16 validators (5 silent), 256 tx, BLS, one epoch: "
        f"{len(net.node(0).outputs[0].contributions)} contributions committed alike on all 11 "
        f"correct nodes, no fault; epoch {epoch_s:.3f} s wall under torch.profiler; "
        f"{len(sizes)} flushes, {sum(sizes)} requests, largest {max(sizes)}, median "
        f"{statistics.median(sizes)}; all verdicts True; first {held} flushes == "
        f"BatchedBackend (host, {os.cpu_count()} processes, {host_s:.2f} s)  [{card}]")
    log(f"consensus (a) {_stage_line(stats, rec.seconds)}; device busy {busy_us:.0f} us of "
        f"{epoch_s * 1e6:.0f} us = {share}  [{card}]")
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:6]
    log("consensus (a) device time by kernel: " + "; ".join(
        f"{e.key[:40]} {e.self_device_time_total:.0f} us x{e.count}" for e in top))
    log(f"consensus (a) launches: {json.dumps(launches_a, sort_keys=True)}")

    # (b) honeybadger-4-tamper: tests/test_tampering_adversary.py:67 at
    # seed 101: one faulty validator runs the real algorithm and doubles
    # its signature and decryption shares; two epochs.
    before = dict(build.LAUNCHES)
    be = TorchBackend(suite)
    stats = instrument(be)
    rec = FlushLog(be)
    t0 = time.perf_counter()
    net, proposed = _hb_run(*hb, rec, n=4, seed=101, contributions=[
        lambda nid: [f"tx-{nid}"], lambda nid: [f"tx2-{nid}"]],
        adversary=TamperingAdversary(tamper_p=0.5), num_faulty=1)
    tamper_s = time.perf_counter() - t0
    launches_b = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                  if v - before.get(k, 0)}
    _check_batches(net, proposed, "honeybadger-4-tamper")
    if net.correct_faults():
        raise AssertionError(f"honeybadger-4-tamper: correct nodes faulted: {net.correct_faults()}")
    accused = {f.node_id for nid in net.correct_ids for f in net.node(nid).faults}
    if not accused <= set(net.faulty_ids):
        raise AssertionError(f"honeybadger-4-tamper: faults name {accused}, faulty {net.faulty_ids}")
    verdicts = rec.verdicts()
    if all(verdicts):
        raise AssertionError("honeybadger-4-tamper: no forged share was rejected on the card")
    host_s = _host_check(suite, rec, None, "honeybadger-4-tamper")
    sizes = rec.sizes()
    n_faults = sum(len(net.node(nid).faults) for nid in net.correct_ids)
    log(f"consensus (b) honeybadger-4-tamper: 4 nodes (1 tampering), BLS, two epochs committed "
        f"alike; {n_faults} faults, all against node {sorted(accused)}; {tamper_s:.3f} s wall; "
        f"{len(sizes)} flushes, {sum(sizes)} requests, largest {max(sizes)}; "
        f"{verdicts.count(False)} verdicts False; every flush == BatchedBackend (host, "
        f"{os.cpu_count()} processes, {host_s:.2f} s)  [{card}]")
    log(f"consensus (b) {_stage_line(stats, rec.seconds)}  [{card}]")
    log(f"consensus (b) launches: {json.dumps(launches_b, sort_keys=True)}")

    # (c) The proposers' data plane from the protocol layer: batch_propose
    # over 16 fresh Broadcast instances (n = 16), payloads the length of
    # (a)'s encrypted contributions, against per-instance handle_input.
    pks = net.node(0).netinfo.public_key_set  # any BLS key set gives the length
    length = len(serde.dumps(pks.public_key().encrypt(
        serde.dumps([f"tx-15-{i}" for i in range(16)]), random.Random(16))))
    rng = random.Random(length)
    values = [rng.randbytes(length) for _ in range(16)]

    def instances():
        bnet = (NetBuilder(16, seed=4).num_faulty(0)
                .protocol(lambda ni, sink, r: pbc.Broadcast(ni, ni.our_id)).build())
        return [bnet.node(i).protocol for i in bnet.correct_ids]

    def wire(step):
        return [(repr(tm.target), serde.dumps(tm.message)) for tm in step.messages]

    pbc.batch_propose(instances(), values, device="cuda")  # warm-up
    before = dict(build.LAUNCHES)
    pbc.HOST_ROUTE.clear()
    t0 = time.perf_counter()
    steps = pbc.batch_propose(instances(), values, device="cuda")
    propose_s = time.perf_counter() - t0
    launches_c = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                  if v - before.get(k, 0)}
    host_route = dict(pbc.HOST_ROUTE)
    t0 = time.perf_counter()
    want = [wire(bc.handle_input(v, None)) for bc, v in zip(instances(), values)]
    host_propose_s = time.perf_counter() - t0
    if [wire(s) for s in steps] != want:
        raise AssertionError("batch_propose on cuda: messages != per-instance handle_input")
    if host_route:
        raise AssertionError(f"batch_propose at n = 16: {host_route} took the host route")
    if launches_c.get(K.TREE_KERNEL, 0) != 1 or launches_c.get(K.KERNEL, 0):
        raise AssertionError(f"batch_propose launches {launches_c}: expected one "
                             f"{K.TREE_KERNEL} and no {K.KERNEL}")
    log(f"consensus (c) batch_propose: 16 Broadcast instances (n = 16), {length}-byte values: "
        f"proofs == per-instance handle_input; host route {sum(host_route.values())} instances; "
        f"{propose_s * 1e3:.1f} ms on the card (warm) against {host_propose_s * 1e3:.1f} ms for "
        f"16 handle_input calls on the host; launches {json.dumps(launches_c, sort_keys=True)}"
        f"  [{card}]")
    return dict(build.LAUNCHES)


class HostTimers:
    """Time, from outside, the host work of the dynamic stack that does not
    go through the ``VerifySink``: ``SyncKeyGen``'s ``handle_part``,
    ``handle_ack`` and ``generate``; the ciphertext checks inside
    ``SecretKey.decrypt`` (each a hash to G2 and a pairing check, counted
    where the ciphertext's validity memo was still empty); the signature
    checks of DynamicHoneyBadger's votes and key-gen messages (its
    ``_memo_sig_verdict`` misses); and ``SecretKey.sign``, which signs them.
    The library's methods are wrapped while the timers are on and put back
    by :meth:`close`."""

    def __init__(self) -> None:
        from hbbft_tpu_torch.crypto import keys
        from hbbft_tpu_torch.protocols import dynamic_honey_badger as dhb
        from hbbft_tpu_torch.protocols.sync_key_gen import SyncKeyGen

        self.stats: dict = {}
        self._saved: list = []
        for name in ("handle_part", "handle_ack", "generate"):
            self._wrap(SyncKeyGen, name, self._timed(getattr(SyncKeyGen, name), f"skg.{name}"))
        self._wrap(keys.SecretKey, "sign", self._timed(keys.SecretKey.sign, "SecretKey.sign"))
        decrypt = keys.SecretKey.decrypt
        ct_check = self._timed(lambda ct: ct.verify(), "decrypt.ct_check")

        def timed_decrypt(sk, ct):
            if isinstance(ct, keys.Ciphertext) and "_verify_ok" not in ct.__dict__:
                ct_check(ct)  # the check decrypt would make; its verdict is memoized
            return decrypt(sk, ct)

        self._wrap(keys.SecretKey, "decrypt", self._timed(timed_decrypt, "SecretKey.decrypt"))
        memo = dhb._memo_sig_verdict

        def timed_memo(obj, pk, check):
            return memo(obj, pk, self._timed(check, "dhb.sig_check"))

        self._wrap(dhb, "_memo_sig_verdict", timed_memo)

    def _timed(self, fn, key: str):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                entry = self.stats.setdefault(key, [0, 0.0])
                entry[0] += 1
                entry[1] += time.perf_counter() - t0
        return run

    def _wrap(self, owner, name: str, fn) -> None:
        self._saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, fn)

    def close(self) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []

    def line(self) -> str:
        return "; ".join(f"{k} {n} calls {t:.3f} s" for k, (n, t) in sorted(self.stats.items()))


def _dhb_batches(net, nid) -> list:
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import DhbBatch

    return [o for o in net.node(nid).outputs if isinstance(o, DhbBatch)]


def _committed(net, nid) -> list:
    return [t for b in _dhb_batches(net, nid) for _, c in b.contributions for t in c]


def _dynamic_era(card: str, flush_kernels: tuple) -> None:
    """(a) qhb-era-4: a BLS era change on the card."""
    from torch.profiler import ProfilerActivity, profile

    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend
    from hbbft_tpu_torch.net import NetBuilder
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import Change
    from hbbft_tpu_torch.protocols.queueing_honey_badger import Input, QueueingHoneyBadger

    suite = BLSSuite()
    be = TorchBackend(suite)
    stats = instrument(be)
    rec = FlushLog(be)
    timers = HostTimers()
    net = (NetBuilder(4, seed=4).num_faulty(0).suite(suite).backend(lambda s: rec)
           .flush_every(100_000).max_cranks(10_000_000)
           .protocol(lambda ni, sink, rng: QueueingHoneyBadger(
               ni, sink, batch_size=4, session_id=b"cfg4"))
           .build())
    ids = list(net.correct_ids)
    old_pks = net.node(0).netinfo.public_key_set.to_bytes()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_all = time.perf_counter()
            # Phase 1: a plain epoch, one user transaction a node.
            t0, d0 = time.perf_counter(), net.delivered
            for nid in ids:
                net.send_input(nid, Input.user(f"pre-{nid}"))
            net.crank_until(lambda n: all(_dhb_batches(n, i) for i in ids))
            plain_s, plain_d = time.perf_counter() - t0, net.delivered - d0
            epochs_before = max(len(_dhb_batches(net, i)) for i in ids)
            plain_flushes = len(rec.flushes)
            # Phase 2: vote node 3 out; the era change runs SyncKeyGen among
            # nodes 0-2 through consensus.
            ni = net.node(0).protocol.netinfo
            new_map = {i: ni.public_key(i) for i in ni.all_ids if i != 3}
            t0, d0 = time.perf_counter(), net.delivered
            for nid in ids:
                net.send_input(nid, Input.change(Change.node_change(new_map)))
                net.send_input(nid, Input.user(f"churn-{nid}"))
            net.crank_until(lambda n: all(
                any(b.change.kind == "complete" for b in _dhb_batches(n, i)) for i in ids))
            era_s, era_d = time.perf_counter() - t0, net.delivered - d0
            epochs_era = max(len(_dhb_batches(net, i)) for i in ids) - epochs_before
            era_flushes = len(rec.flushes) - plain_flushes
            # Phase 3: one epoch of the new era, a transaction from each
            # remaining validator.
            t0, d0 = time.perf_counter(), net.delivered
            new_txns = [f"era1-{nid}" for nid in (0, 1, 2)]
            for nid in (0, 1, 2):
                net.send_input(nid, Input.user(f"era1-{nid}"))
            net.crank_until(lambda n: all(set(new_txns) <= set(_committed(n, i))
                                          for i in (0, 1, 2)))
            new_s, new_d = time.perf_counter() - t0, net.delivered - d0
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t_all
    finally:
        timers.close()
    launches = dict(build.LAUNCHES)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    share = f"{100 * busy_us / (total_s * 1e6):.2f}%" if busy_us > 0 else "not measured"

    # Checks.
    common = min(len(_dhb_batches(net, i)) for i in ids)
    if any(_dhb_batches(net, i)[:common] != _dhb_batches(net, 0)[:common] for i in ids):
        raise AssertionError("qhb-era-4: the correct nodes' batches differ")
    new_pks = {net.node(i).protocol.netinfo.public_key_set.to_bytes() for i in ids}
    if len(new_pks) != 1 or old_pks in new_pks:
        raise AssertionError(f"qhb-era-4: {len(new_pks)} new PublicKeySets, old kept: "
                             f"{old_pks in new_pks}")
    if net.node(3).protocol.netinfo.is_validator():
        raise AssertionError("qhb-era-4: node 3 is still a validator")
    if any(not net.node(i).protocol.netinfo.is_validator() for i in (0, 1, 2)):
        raise AssertionError("qhb-era-4: a remaining node is not a validator")
    if net.correct_faults():
        raise AssertionError(f"qhb-era-4: faults {net.correct_faults()[:5]}")
    verdicts = rec.verdicts()
    if not all(verdicts):
        raise AssertionError(f"qhb-era-4: {verdicts.count(False)} of {len(verdicts)} verdicts False")
    missing = [k for k in flush_kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"qhb-era-4 launched no {missing}: {launches}")
    # The first flush whose shares carry the PublicKeySet SyncKeyGen made.
    pks = net.node(0).protocol.netinfo.public_key_set
    shares = {pks.public_key_share(i).to_bytes() for i in range(3)}
    first_new = next((i for i, (reqs, _) in enumerate(rec.flushes)
                      if any(r.kind != "ciphertext" and r.payload[0].to_bytes() in shares
                             for r in reqs)), None)
    if first_new is None:
        raise AssertionError("qhb-era-4: no flush checked a share of the new key set")
    held = 4
    host_s = _host_check(suite, rec, held, "qhb-era-4", also=(first_new,))
    sizes = rec.sizes()
    log(f"dynamic (a) qhb-era-4: benchmarks/config4_dynamic_hb.py's phases at N = 4 (not 64: "
        f"BLS DKG is host Python growing ~N^3, N = 32 took 13,199 s natively, "
        f"BLS_ERA32_r05.json), BLS, QueueingHoneyBadger batch 4, every share check on the "
        f"card: plain epoch {plain_s:.3f} s, {plain_d} deliveries, {plain_flushes} flushes; "
        f"era change (node 3 voted out) {era_s:.3f} s, {epochs_era} epochs, {era_d} "
        f"deliveries, {era_flushes} flushes; new-era epoch {new_s:.3f} s, {new_d} deliveries; "
        f"all {len(ids)} correct nodes' batches alike, one new PublicKeySet, node 3 an "
        f"observer, no fault  [{card}]")
    log(f"dynamic (a) {len(sizes)} flushes, {sum(sizes)} requests, largest {max(sizes)}, "
        f"median {statistics.median(sizes)}; all verdicts True; first {held} flushes and "
        f"flush {first_new} (the first with a share of the new key set) == BatchedBackend "
        f"(host, {os.cpu_count()} processes, {host_s:.2f} s)  [{card}]")
    log(f"dynamic (a) {_stage_line(stats, rec.seconds)}; device busy {busy_us:.0f} us of "
        f"{total_s * 1e6:.0f} us = {share}  [{card}]")
    log(f"dynamic (a) host work off the VerifySink over {total_s:.3f} s: {timers.line()}  "
        f"[{card}]")
    log(f"dynamic (a) launches: {json.dumps(launches, sort_keys=True)}")


def _dynamic_simulation(card: str, flush_kernels: tuple) -> None:
    """(b) simulation-10: the port's simulation example on the card at the
    reference's defaults with the BLS suite and ``--backend torch``."""
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.examples import simulation as sim

    before = dict(build.LAUNCHES)
    args = sim.parse_args(["--suite", "bls", "--backend", "torch", "--seed", "0",
                           "--flush-every", "1"])
    net = sim.build_network(args)
    stats = instrument(net.backend)
    net.backend = rec = FlushLog(net.backend)
    txns, wall = sim.run(net, args)
    sim.report(net, args, wall)
    launches = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                if v - before.get(k, 0)}
    missing = [n.id for n in net.nodes.values() if not set(txns) <= set(n.committed)]
    if missing:
        raise AssertionError(f"simulation-10: nodes {missing} did not commit every transaction")
    if len(txns) != 128 or len(net.nodes) != 10:
        raise AssertionError("simulation-10: not the reference's defaults")
    verdicts = rec.verdicts()
    if not all(verdicts):
        raise AssertionError(f"simulation-10: {verdicts.count(False)} verdicts False")
    missing = [k for k in flush_kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"simulation-10 launched no {missing}: {launches}")
    sizes = rec.sizes()
    msgs = sum(n.sent_msgs for n in net.nodes.values())
    mbytes = sum(n.sent_bytes for n in net.nodes.values()) / 1e6
    log(f"dynamic (b) simulation-10: python3 -m hbbft_tpu_torch.examples.simulation --suite bls "
        f"--backend torch (10 nodes, 128 txns of 16 bytes, batch 128, 100 ms, 2,000 kbps, "
        f"seed 0, flush every delivery): every node committed all {len(txns)}; {msgs} msgs, "
        f"{mbytes:.2f} MB on the wire; {len(sizes)} flushes, {sum(sizes)} requests, largest "
        f"{max(sizes)}; all verdicts True; wall {wall:.3f} s  [{card}]")
    log(f"dynamic (b) {_stage_line(stats, rec.seconds)}  [{card}]")
    log(f"dynamic (b) launches: {json.dumps(launches, sort_keys=True)}")


def phase_dynamic(card: str) -> dict:
    """The dynamic stack on the card: a BLS era change (a) and the
    simulation example (b).  Returns the kernels' launches over both, the
    counts set to 0 just before."""
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import scan as dscan

    flush_kernels = (*dscan.KERNELS, *dpair.KERNELS)
    build.reset_launches()
    t0 = time.perf_counter()
    _dynamic_era(card, flush_kernels)
    t1 = time.perf_counter()
    _dynamic_simulation(card, flush_kernels)
    log(f"dynamic: (a) {t1 - t0:.1f} s, (b) {time.perf_counter() - t1:.1f} s  [{card}]")
    return dict(build.LAUNCHES)


def _cluster_txns(cluster, nid) -> set:
    return {t for b in cluster.batches(nid) for _, c in b.contributions for t in (c or [])}


def _cluster_streams_alike(cluster, ids, what: str) -> int:
    """Every node's committed stream is a prefix of one stream; returns the
    shortest stream's length."""
    streams = [[(b.era, b.epoch, b.contributions) for b in cluster.batches(i)] for i in ids]
    common = min(len(s) for s in streams)
    if common == 0 or any(s[:common] != streams[0][:common] for s in streams):
        raise AssertionError(f"{what}: the nodes' committed streams differ")
    return common


def _cluster_clean(m, what: str) -> None:
    bad = {k: m.counters.get(k, 0) for k in ("cluster.handler_errors", "cluster.bad_payload",
                                             "cluster.protocol_faults", "crypto.fallbacks",
                                             "crypto.rpc.fallbacks", "crypto.flush_errors")}
    if any(bad.values()):
        raise AssertionError(f"{what}: {bad}")


def _launch_delta(before: dict) -> dict:
    from hbbft_tpu_torch import build

    return {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items() if v - before.get(k, 0)}


def _service_backend(suite, what: str) -> tuple:
    """``TorchBackend`` on the card for a crypto service: its kernels loaded
    and one flush run before any node waits on the service (a first flush
    that loads them must not outlast a client's timeout), its stages timed
    (:func:`instrument`) and a :class:`FlushLog` in front of its flushes.
    Returns (backend, stage stats, flush log, warm-up seconds)."""
    from hbbft_tpu_torch.crypto import keys
    from hbbft_tpu_torch.crypto.backend import VerifyRequest
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend

    be = TorchBackend(suite)
    t0 = time.perf_counter()
    be.load_kernels()
    sks = keys.SecretKeySet.random(1, random.Random(3), suite)
    pks = sks.public_keys()
    warm = [VerifyRequest.sig_share(pks.public_key_share(i), b"warm",
                                    sks.secret_key_share(i).sign(b"warm")) for i in range(4)]
    if not all(be.verify_batch(warm)):
        raise AssertionError(f"{what}: the warm-up flush rejected a valid share")
    warm_s = time.perf_counter() - t0
    stats = instrument(be)
    rec = FlushLog(types.SimpleNamespace(verify_batch=be.verify_batch))
    be.verify_batch = rec.verify_batch  # the service still holds TorchBackend
    return be, stats, rec, warm_s


def _busy_share(prof, wall: float) -> tuple:
    """The card's busy microseconds under ``prof`` and their share of
    ``wall`` seconds ("not measured" when the profiler saw no device time)."""
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    return busy_us, (f"{100 * busy_us / (wall * 1e6):.2f}%" if busy_us > 0 else "not measured")


def _plane_service(card: str, flush_kernels: tuple) -> None:
    """(a) cryptoplane-4: 4 BLS validators over TCP, one shared service over
    ``TorchBackend``.  Cut from 16 validators to 4 for the script's time
    limit: phase 7 (a) drives the same service at 16."""
    from torch.profiler import ProfilerActivity, profile

    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
    from hbbft_tpu_torch.cryptoplane import CryptoPlaneService
    from hbbft_tpu_torch.obs.trace import TraceBuffer
    from hbbft_tpu_torch.protocols.queueing_honey_badger import Input
    from hbbft_tpu_torch.transport import LocalCluster

    n = 4
    what = f"cryptoplane-{n}"
    suite = BLSSuite()
    be, stats, rec, warm_s = _service_backend(suite, what)
    service = CryptoPlaneService(be, window_s=0.002, trace=TraceBuffer("cryptoplane"))
    cluster = LocalCluster(n, seed=0, node_impl="python", suite=suite, crypto="service",
                           crypto_service=service)
    txns = [f"tx-{i}" for i in range(n)]
    for i in range(n):
        cluster.submit(i, Input.user(txns[i]))
    before = dict(build.LAUNCHES)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cluster.start()
            done = cluster.wait(lambda cl: all(set(txns) <= _cluster_txns(cl, i)
                                               for i in range(n)), 300.0, poll_s=0.05)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
    finally:
        cluster.stop()  # every node's flushes answered: the counts below are final
        service.stop()
    m = cluster.merged_metrics(fresh=True)
    launches = _launch_delta(before)
    if not done:
        raise AssertionError(f"{what}: not every node committed all {n} transactions "
                             f"within 300 s: {[len(_cluster_txns(cluster, i)) for i in range(n)]}")
    batches = _cluster_streams_alike(cluster, range(n), what)
    _cluster_clean(m, what)
    flushes, reqs = m.counters.get("crypto.flushes", 0), m.counters.get("crypto.requests", 0)
    if flushes == 0 or flushes != len(rec.flushes):
        raise AssertionError(f"{what}: {flushes} service flushes, {len(rec.flushes)} logged")
    short = [k for k in flush_kernels if launches.get(k, 0) < flushes]
    if short:
        raise AssertionError(f"{what}: {short} launched fewer times than the {flushes} "
                             f"service flushes: {launches}")
    verdicts = rec.verdicts()
    if not all(verdicts):
        raise AssertionError(f"{what}: {verdicts.count(False)} verdicts False")
    held = 4
    host_s = _host_check(suite, rec, held, what)
    wait = m.timers["crypto.wait"]
    busy_us, share = _busy_share(prof, wall)
    sizes = rec.sizes()
    log(f"crypto plane (a) {what}: LocalCluster({n}, seed=0, python nodes, BLS, "
        f"crypto=service) over localhost TCP, one Input.user a node: every node committed all "
        f"{n} in {batches} batch(es), streams alike, no handler error, fault or fallback; wall "
        f"{wall:.3f} s (warm-up {warm_s:.2f} s before it)  [{card}]")
    log(f"crypto plane (a) {wait.count} node pool flushes (jobs) -> {flushes} service flushes, "
        f"{reqs} requests, {reqs / flushes:.2f} requests and {wait.count / flushes:.2f} jobs a "
        f"service flush, largest {max(sizes)}, median {statistics.median(sizes)}; first {held} "
        f"service flushes == BatchedBackend (host, {host_s:.2f} s)  [{card}]")
    log(f"crypto plane (a) service wait (window 2 ms + queue) {wait.total_s:.3f} s over "
        f"{wait.count} jobs = {1e3 * wait.total_s / wait.count:.2f} ms a job (max "
        f"{1e3 * wait.max_s:.2f} ms); backend {rec.seconds:.3f} s over {flushes} flushes = "
        f"{1e3 * rec.seconds / flushes:.2f} ms a flush  [{card}]")
    log(f"crypto plane (a) {_stage_line(stats, rec.seconds)}; device busy {busy_us:.0f} us of "
        f"{wall * 1e6:.0f} us = {share}  [{card}]")
    log(f"crypto plane (a) launches: {json.dumps(launches, sort_keys=True)}")


def _plane_process(card: str, flush_kernels: tuple) -> dict:
    """(b) cryptoplane-proc-4: the service in a process of its own on the
    card, serving a 4-node BLS cluster.  Returns the worker's launches."""
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
    from hbbft_tpu_torch.protocols.queueing_honey_badger import Input
    from hbbft_tpu_torch.transport import LocalCluster

    n = 4
    t0 = time.perf_counter()
    cluster = LocalCluster(n, seed=0, node_impl="python", suite=BLSSuite(),
                           crypto="service-proc",
                           service_kwargs=dict(backend="torch", device="cuda",
                                               ready_timeout_s=180.0))
    start_s = time.perf_counter() - t0
    svc = cluster.crypto_service
    try:
        for i in range(n):
            cluster.submit(i, Input.user(f"tx-{i}"))
        t0 = time.perf_counter()
        cluster.start()
        done = cluster.wait(lambda cl: all(cl.batch_count(i) >= 2 for i in range(n)), 240.0,
                            poll_s=0.05)
        wall = time.perf_counter() - t0
        m = cluster.merged_metrics(fresh=True)
        stats = svc.stats()["counters"]
    finally:
        cluster.stop()  # stops the owned worker; its summary carries its launches
    if not done:
        raise AssertionError(f"cryptoplane-proc-4: not every node had 2 batches within 240 s: "
                             f"{[cluster.batch_count(i) for i in range(n)]}")
    line = svc.log[0] if svc.log else ""
    if "cuda" not in line:
        raise AssertionError(f"cryptoplane-proc-4: the worker's log line names no cuda device: "
                             f"{svc.log}")
    _cluster_streams_alike(cluster, range(n), "cryptoplane-proc-4")
    _cluster_clean(m, "cryptoplane-proc-4")
    calls = m.counters.get("crypto.rpc.calls", 0)
    if calls == 0 or stats.get("crypto.flushes", 0) == 0:
        raise AssertionError(f"cryptoplane-proc-4: {calls} RPC flushes, service {stats}")
    summary = svc.summary or {}
    if summary.get("flush_errors", 1) != 0 or svc.proc.returncode != 0:
        raise AssertionError(f"cryptoplane-proc-4: the worker exited {svc.proc.returncode}, "
                             f"its summary {svc.summary}, its log {svc.log}")
    launches = summary.get("launches", {})
    missing = [k for k in flush_kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"cryptoplane-proc-4: the worker launched no {missing}: {svc.summary}")
    rt = m.timers.get("crypto.rpc.round_trip")
    log(f"crypto plane (b) cryptoplane-proc-4: LocalCluster(4, seed=0, python nodes, BLS, "
        f"crypto=service-proc, backend=torch): worker up in {start_s:.2f} s, its log line: "
        f"{line!r}; every node has 2 batches, streams alike, no fallback; the worker exited 0 "
        f"with no flush error; wall {wall:.3f} s  [{card}]")
    log(f"crypto plane (b) {calls} RPC flushes from the nodes ({m.counters.get('crypto.rpc.requests', 0)} "
        f"requests; round trip {rt.total_s:.3f} s in all, max {1e3 * rt.max_s:.1f} ms) -> "
        f"{stats['crypto.flushes']} service flushes, {stats['crypto.requests']} requests "
        f"= {stats['crypto.requests'] / stats['crypto.flushes']:.2f} a flush; worker launches "
        f"{json.dumps(launches, sort_keys=True)}  [{card}]")
    return launches


class _RaisingDevice:
    """A device backend whose flush fails."""

    calls = 0

    def verify_batch(self, reqs):
        self.calls += 1
        raise RuntimeError("device flush failed")


def _plane_routing(card: str, flush_kernels: tuple, firehose: list, mixed: list,
                   bad: list) -> None:
    """(c) ``HybridBackend``'s size routing and the sharded flush (K7)."""
    from hbbft_tpu_torch.crypto.backend import BatchedBackend, VerifyRequest
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.device.backend import HybridBackend, TorchBackend

    suite = BLSSuite()
    hb = HybridBackend(suite)  # device None: TorchBackend on cuda
    if not isinstance(hb.device, TorchBackend) or hb.device.device.type != "cuda":
        raise AssertionError(f"HybridBackend: device {hb.device!r} is not TorchBackend on cuda")
    out = {}
    for size in (63, 64):
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        got = hb.verify_batch(firehose[:size])
        out[size] = (time.perf_counter() - t0, _launch_delta(before))
        if not all(got):
            raise AssertionError(f"HybridBackend: a valid share rejected at {size}")
    if out[63][1]:
        raise AssertionError(f"HybridBackend: a 63-request flush launched {out[63][1]}")
    if any(out[64][1].get(k, 0) == 0 for k in flush_kernels):
        raise AssertionError(f"HybridBackend: a 64-request flush launched only {out[64][1]}")
    host = BatchedBackend(suite)
    host_calls = []
    orig = host.verify_batch
    host.verify_batch = lambda reqs: host_calls.append(len(reqs)) or orig(reqs)
    raising = HybridBackend(suite, device=_RaisingDevice(), host=host)
    try:
        raising.verify_batch(firehose[:64])
        raise AssertionError("HybridBackend: a raising device flush did not raise")
    except RuntimeError as exc:
        if "device flush failed" not in str(exc):
            raise
    if host_calls or raising.device.calls != 1:
        raise AssertionError(f"HybridBackend failed over: host calls {host_calls}")
    log(f"crypto plane (c) HybridBackend(min_device_batch=64): 63 requests -> host "
        f"BatchedBackend {out[63][0]:.3f} s, 0 launches; 64 -> TorchBackend on the card "
        f"{out[64][0]:.3f} s, launches {json.dumps(out[64][1], sort_keys=True)}; a raising "
        f"device flush raised, no host call  [{card}]")
    # Every card, or the one card listed twice.
    devices = [f"cuda:{k}" for k in range(torch.cuda.device_count())]
    devices = devices * 2 if len(devices) == 1 else devices
    plain, sharded = TorchBackend(suite), TorchBackend(suite, devices=devices)
    sharded.load_kernels()
    # A bad share in the firehose's fourth chunk, which the sharded flush
    # scans on devices[3 % len]: that chunk's failure path (its recheck
    # gathered on devices[0], then its bisection) runs.  mixed-512 is one
    # chunk.
    at = 3 * plain.chunk + 100
    a, b = firehose[at], firehose[at + 1]  # two signers
    firehose_bad = list(firehose)
    firehose_bad[at] = VerifyRequest.sig_share(a.payload[0], a.payload[1], b.payload[2])
    for name, reqs, want_rejected in (("firehose-10240", firehose, []),
                                      (f"firehose-10240 with a bad share at {at}", firehose_bad,
                                       [at]),
                                      ("mixed-512", mixed, bad)):
        runs = {}
        for label, be in (("unsharded", plain), ("sharded", sharded), ("sharded", sharded),
                          ("unsharded", plain)):
            before = dict(build.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = be.verify_batch(reqs)
            torch.cuda.synchronize()
            runs.setdefault(label, []).append((time.perf_counter() - t0, got,
                                               _launch_delta(before)))
        want = runs["unsharded"][0][1]
        if any(r[1] != want for rs in runs.values() for r in rs):
            raise AssertionError(f"K7 {name}: sharded verdicts != unsharded")
        rejected = [i for i, v in enumerate(want) if not v]
        if rejected != want_rejected:
            raise AssertionError(f"K7 {name}: rejected {rejected}")
        counts = [r[2] for rs in runs.values() for r in rs]
        if any(c != counts[0] for c in counts):
            raise AssertionError(f"K7 {name}: launches differ: {counts}")
        log(f"crypto plane (c) K7 TorchBackend(devices={devices}) on {name}: "
            f"verdicts == unsharded, rejected {rejected}; launches == unsharded "
            f"{json.dumps(counts[0], sort_keys=True)}; seconds unsharded/sharded/sharded/"
            f"unsharded {runs['unsharded'][0][0]:.3f} / {runs['sharded'][0][0]:.3f} / "
            f"{runs['sharded'][1][0]:.3f} / {runs['unsharded'][1][0]:.3f}  [{card}]")


def phase_cryptoplane(card: str, firehose: list, mixed: list, bad: list) -> dict:
    """The crypto plane on the card: the shared service over TCP (a), the
    service process (b), ``HybridBackend`` and the sharded flush (c).
    Returns the kernels' launches over (a)-(c), the counts set to 0 just
    before, the service worker's own launches added."""
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import scan as dscan

    flush_kernels = (*dscan.KERNELS, *dpair.KERNELS)
    build.reset_launches()
    t0 = time.perf_counter()
    _plane_service(card, flush_kernels)
    t1 = time.perf_counter()
    worker = _plane_process(card, flush_kernels)
    t2 = time.perf_counter()
    _plane_routing(card, flush_kernels, firehose, mixed, bad)
    log(f"crypto plane: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{time.perf_counter() - t2:.1f} s  [{card}]")
    launches = dict(build.LAUNCHES)
    for k, v in worker.items():
        launches[k] = launches.get(k, 0) + v
    return launches


# Phase 7's deadlines.  Alone on the card (PERF.md §6), traffic-16-wan
# drained its 4 epochs in 416.7 s, and chaos-10-mixed drained in 473.6 s
# and the oracle's 2 more epochs took 65.1 s; the script gives up on
# phase 7 at TRAFFIC_DEADLINE_S from its start, inside its 1,200 s limit.
TRAFFIC_DRAIN_S = 700.0
CHAOS_PROGRESS_S = 300.0
TRAFFIC_DEADLINE_S = 1140.0


def _scrape_once(cluster, service, out: dict):
    """Scrape the cluster's scrape server once, from a thread of its own,
    as soon as the service has flushed: ``/healthz`` (its status and
    body), ``/metrics`` and ``/trace.json`` go into ``out``.  Returns the
    thread; setting ``out["stop"]`` ends its wait."""
    import threading
    import urllib.request

    def get(url: str):
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()

    def run():
        try:
            base = f"http://127.0.0.1:{cluster.serve_obs().port}"
            while service.metrics.counters.get("crypto.flushes", 0) == 0 and "stop" not in out:
                time.sleep(0.05)
            t0 = time.perf_counter()
            out["healthz"] = get(base + "/healthz")
            out["metrics"] = get(base + "/metrics")[1].decode()
            out["trace"] = json.loads(get(base + "/trace.json")[1])
            out["seconds"] = time.perf_counter() - t0
        except Exception as exc:  # reported by the caller's check
            out["error"] = repr(exc)

    th = threading.Thread(target=run, name="obs-scrape", daemon=True)
    th.start()
    return th


def _covered(cluster, ids, admitted: set) -> bool:
    from hbbft_tpu_torch.chaos import stream_txns
    from hbbft_tpu_torch.traffic import txn_id_of

    return all(admitted <= {txn_id_of(t) for t in stream_txns(cluster, i)} for i in ids)


def _traffic_wan(card: str, flush_kernels: tuple) -> None:
    """(a) traffic-16-wan: open-loop clients over a WAN-shaped 16-node BLS
    cluster whose share checks one service merges into ``TorchBackend``
    flushes, scraped once while it runs."""
    from torch.profiler import ProfilerActivity, profile

    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.chaos import ChaosOracle
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
    from hbbft_tpu_torch.cryptoplane import CryptoPlaneService
    from hbbft_tpu_torch.obs.trace import TraceBuffer
    from hbbft_tpu_torch.traffic import ClientFleet, TrafficDriver
    from hbbft_tpu_torch.transport import FaultInjector, LocalCluster, wan_profile

    n = 16
    suite = BLSSuite()
    be, stats, rec, warm_s = _service_backend(suite, "traffic-16-wan")
    service = CryptoPlaneService(be, window_s=0.002, trace=TraceBuffer("cryptoplane"))
    inj = FaultInjector(seed=0, default=wan_profile("wan"))
    cluster = LocalCluster(n, seed=0, node_impl="python", suite=suite, crypto="service",
                           crypto_service=service, injector=inj)
    fleet = ClientFleet(32, 80 / n ** 2, seed=0)
    driver = TrafficDriver(cluster, fleet)
    scrape: dict = {}
    before = dict(build.LAUNCHES)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cluster.start()
            scraper = _scrape_once(cluster, service, scrape)
            res = driver.run_open_loop(2.0, drain_timeout_s=TRAFFIC_DRAIN_S)
            drained_s = time.perf_counter() - t0
            admitted = {tid for _, _, tid, _ in ClientFleet(32, 80 / n ** 2, seed=0).take(
                res["admitted"])}
            covered = cluster.wait(lambda cl: _covered(cl, range(n), admitted), 120.0,
                                   poll_s=0.05)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        scrape["stop"] = True
        scraper.join(300)
        epochs = min(cluster.batch_count(i) for i in range(n))
    finally:
        cluster.stop()  # every node's flushes answered: the counts below are final
        service.stop()
    m = cluster.merged_metrics(fresh=True)
    launches = _launch_delta(before)
    hist = driver.recorder.hist
    flushes, reqs = m.counters.get("crypto.flushes", 0), m.counters.get("crypto.requests", 0)
    busy_us, share = _busy_share(prof, wall)
    fstats = {k: getattr(inj.stats, k) for k in inj.stats.NAMES}
    log(f"traffic (a) traffic-16-wan: LocalCluster(16, seed=0, python nodes, BLS, "
        f"SenderQueue(QueueingHoneyBadger) batch 8, crypto=service over TorchBackend, "
        f"window 2 ms), FaultInjector(seed=0, wan_profile('wan')) on every link, "
        f"ClientFleet(32, {80 / n ** 2} txn/s each, seed=0) open loop for 2.0 s: offered "
        f"{res['arrived']}, admitted {res['admitted']}, committed {res['committed']}, "
        f"outstanding {res['outstanding']}; drained at {drained_s:.3f} s, every node's stream "
        f"covered at {wall:.3f} s (warm-up {warm_s:.2f} s before it); {epochs} epochs  [{card}]")
    log(f"traffic (a) submit->commit p50 {hist.quantile(0.5):.3f} s, p99 "
        f"{hist.quantile(0.99):.3f} s, max {hist.max:.3f} s over {hist.count} transactions; "
        f"{flushes} service flushes, {reqs} requests = {reqs / max(flushes, 1):.2f} a flush "
        f"(largest {max(rec.sizes(), default=0)}); injector {json.dumps(fstats)}  [{card}]")
    log(f"traffic (a) {_stage_line(stats, rec.seconds)}; device busy {busy_us:.0f} us of "
        f"{wall * 1e6:.0f} us = {share}  [{card}]")
    log(f"traffic (a) launches: {json.dumps(launches, sort_keys=True)}")
    if "error" in scrape or "healthz" not in scrape:
        raise AssertionError(f"traffic-16-wan: the live scrape failed: {scrape.get('error')}")
    status, body = scrape["healthz"]
    health = json.loads(body)
    if status != 200 or not health["ok"] or len(health["nodes"]) != n:
        raise AssertionError(f"traffic-16-wan: /healthz answered {status}: {health}")
    if 'hbbft_count{name="crypto.flushes"}' not in scrape["metrics"]:
        raise AssertionError("traffic-16-wan: /metrics carries no crypto.flushes counter")
    tracks = {e["args"]["name"] for e in scrape["trace"]["traceEvents"]
              if e["name"] == "process_name"}
    log(f"traffic (a) live scrape after the first service flush: /healthz 200 ok, {n} nodes "
        f"alive; /metrics {len(scrape['metrics'])} bytes with crypto.flushes; /trace.json "
        f"{len(scrape['trace']['traceEvents'])} events on {len(tracks)} tracks; "
        f"{scrape['seconds']:.3f} s  [{card}]")
    if res["outstanding"] or not covered:
        raise AssertionError(f"traffic-16-wan: {res['outstanding']} transactions outstanding "
                             f"after the drain; every node's stream covered: {covered}")
    oracle = ChaosOracle(cluster, driver=driver)
    once = oracle.assert_exactly_once()
    if once != res["admitted"] or res["admitted"] != res["arrived"] or not admitted:
        raise AssertionError(f"traffic-16-wan: {once} committed of {res}")
    _cluster_streams_alike(cluster, range(n), "traffic-16-wan")
    _cluster_clean(m, "traffic-16-wan")
    if flushes == 0 or flushes != len(rec.flushes):
        raise AssertionError(f"traffic-16-wan: {flushes} service flushes, "
                             f"{len(rec.flushes)} logged")
    short = [k for k in flush_kernels if launches.get(k, 0) < flushes]
    if short:
        raise AssertionError(f"traffic-16-wan: {short} launched fewer times than the "
                             f"{flushes} service flushes: {launches}")
    if not all(rec.verdicts()) or fstats["shaped"] == 0:
        raise AssertionError(f"traffic-16-wan: {rec.verdicts().count(False)} verdicts False, "
                             f"{fstats['shaped']} frames shaped")
    host_s = _host_check(suite, rec, 4, "traffic-16-wan")
    log(f"traffic (a) every admitted transaction committed exactly once on all {n} nodes, "
        f"streams alike, no handler error, fault, fallback or flush error; first 4 service "
        f"flushes == BatchedBackend (host, {host_s:.2f} s)  [{card}]")


def _chaos_mixed(card: str, flush_kernels: tuple) -> None:
    """(b) chaos-10-mixed: three live Byzantine nodes (corrupt shares,
    equivocation, garbage) in a 10-node BLS cluster under open-loop
    traffic; the corrupt shares reach the service, fail the RLC check and
    are bisected out on the card."""
    from torch.profiler import ProfilerActivity, profile

    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.chaos import ChaosOracle, fault_entries
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
    from hbbft_tpu_torch.cryptoplane import CryptoPlaneService
    from hbbft_tpu_torch.obs.trace import TraceBuffer
    from hbbft_tpu_torch.traffic import ClientFleet, TrafficDriver
    from hbbft_tpu_torch.transport import LocalCluster

    n = 10
    byzantine = {7: "corrupt-share", 8: "equivocate", 9: "flood"}
    suite = BLSSuite()
    be, stats, rec, warm_s = _service_backend(suite, "chaos-10-mixed")
    service = CryptoPlaneService(be, window_s=0.002, trace=TraceBuffer("cryptoplane"))
    cluster = LocalCluster(n, seed=0, node_impl="python", suite=suite, crypto="service",
                           crypto_service=service, byzantine=byzantine)
    honest = cluster.honest_ids
    driver = TrafficDriver(cluster, ClientFleet(14, 80 / n ** 2, seed=0),
                           assign=lambda cid: cid % len(honest))
    before = dict(build.LAUNCHES)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cluster.start()
            res = driver.run_open_loop(2.0, drain_timeout_s=TRAFFIC_DRAIN_S)
            drained_s = time.perf_counter() - t0
            evidence = ChaosOracle(cluster, driver=driver).check_all(timeout_s=CHAOS_PROGRESS_S)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
    finally:
        cluster.stop()  # every node's flushes answered: the counts below are final
        service.stop()
    m = cluster.merged_metrics(fresh=True)
    accused = sorted({s for i in honest for s, _ in fault_entries(cluster.nodes[i])})
    signer7 = cluster.nodes[0].netinfo.public_key_share(7).to_bytes()
    launches = _launch_delta(before)
    flushes, reqs = m.counters.get("crypto.flushes", 0), m.counters.get("crypto.requests", 0)
    busy_us, share = _busy_share(prof, wall)
    c = m.counters
    tampered = c.get("chaos.tampered_shares", 0)
    rejected = [(k, r) for k, (rs, out) in enumerate(rec.flushes)
                for r, ok in zip(rs, out) if not ok]
    by7 = sum(1 for _, r in rejected if r.kind != "ciphertext"
              and r.payload[0].to_bytes() == signer7)
    bad_flushes = sorted({k for k, _ in rejected})
    log(f"chaos (b) chaos-10-mixed: LocalCluster(10, seed=0, python nodes, BLS, byzantine="
        f"{byzantine}, crypto=service over TorchBackend, window 2 ms), ClientFleet(14, "
        f"{80 / n ** 2} txn/s each, seed=0) homed on nodes 0-6, open loop for 2.0 s: offered "
        f"{res['arrived']}, committed {res['committed']}, drained at {drained_s:.3f} s; "
        f"check_all {json.dumps(evidence, sort_keys=True)} at {wall:.3f} s (warm-up "
        f"{warm_s:.2f} s before it); honest fault logs accuse {accused}  [{card}]")
    log(f"chaos (b) chaos.tampered_shares {tampered}, equivocated "
        f"{c.get('chaos.equivocated', 0)}, garbage payloads {c.get('chaos.garbage_payloads', 0)}, "
        f"raw corrupt frames {c.get('chaos.raw_corrupt_frames', 0)}; transport strikes "
        f"{c.get('transport.peer_misbehavior', 0)}, bans {c.get('transport.peer_bans', 0)}, "
        f"rejected reconnects {c.get('transport.ban_rejects', 0)}; bad payloads "
        f"{c.get('cluster.bad_payload', 0)}, protocol faults {c.get('cluster.protocol_faults', 0)}"
        f"  [{card}]")
    log(f"chaos (b) {flushes} service flushes, {reqs} requests = {reqs / max(flushes, 1):.2f} a "
        f"flush; {len(rejected)} requests rejected ({by7} signed as node 7) in "
        f"{len(bad_flushes)} flushes; {stats['bisections']} flushes bisected over "
        f"{stats['levels']} levels; {_stage_line(stats, rec.seconds)}; device busy "
        f"{busy_us:.0f} us of {wall * 1e6:.0f} us = {share}  [{card}]")
    log(f"chaos (b) launches: {json.dumps(launches, sort_keys=True)}")
    if 7 not in accused or not set(accused) <= set(byzantine):
        raise AssertionError(f"chaos-10-mixed: honest fault logs accuse {accused}")
    if tampered == 0 or not rejected or by7 != len(rejected):
        raise AssertionError(f"chaos-10-mixed: {tampered} tampered shares, {len(rejected)} "
                             f"rejected, {by7} of them node 7's")
    if stats["bisections"] == 0 or stats["levels"] == 0:
        raise AssertionError(f"chaos-10-mixed: no bisection on the card: {stats}")
    bad = {k: c.get(k, 0) for k in ("cluster.handler_errors", "crypto.fallbacks",
                                    "crypto.rpc.fallbacks", "crypto.flush_errors")}
    if any(bad.values()):
        raise AssertionError(f"chaos-10-mixed: {bad}")
    if flushes == 0 or flushes != len(rec.flushes):
        raise AssertionError(f"chaos-10-mixed: {flushes} service flushes, "
                             f"{len(rec.flushes)} logged")
    missing = [k for k in flush_kernels if launches.get(k, 0) < flushes]
    if missing:
        raise AssertionError(f"chaos-10-mixed: {missing} launched fewer times than the "
                             f"{flushes} service flushes: {launches}")
    held = tuple(bad_flushes[:4])
    host_s = _host_check(suite, rec, 0, "chaos-10-mixed", also=held)
    log(f"chaos (b) the {len(held)} first service flushes holding a rejected share {list(held)} "
        f"== BatchedBackend (host, {host_s:.2f} s); no handler error, fallback or flush error"
        f"  [{card}]")


def _traffic_child(which: str, card: str, out_path: str) -> None:
    """One run of phase 7 in a process of its own: (a) or (b), the launch
    counts set to 0 just before it and written to ``out_path`` (JSON)
    just after.  An exception exits the process nonzero."""
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import scan as dscan

    flush_kernels = (*dscan.KERNELS, *dpair.KERNELS)
    run = {"a": _traffic_wan, "b": _chaos_mixed}[which]
    build.reset_launches()
    t0 = time.perf_counter()
    run(card, flush_kernels)
    with open(out_path, "w") as f:
        json.dump({"launches": dict(build.LAUNCHES), "seconds": time.perf_counter() - t0}, f)


def start_phase_traffic(card: str) -> list:
    """Start phase 7's two runs, (a) and (b), each in a process of its own
    beside phases 1-6: both are host-paced (the card busy
    3-5%; PERF.md §5) and, one after another, outlast what the script's
    time limit leaves.  Each process has its own interpreter, so neither
    waits on the other's GIL or on this one's.  Returns the handles for
    :func:`phase_traffic`."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_traffic_")
    runs = []
    for which in ("a", "b"):
        path = os.path.join(out_dir, f"{which}.json")
        proc = ctx.Process(target=_traffic_child, args=(which, card, path),
                           name=f"phase7-{which}")
        proc.start()
        runs.append((which, proc, path))
    return runs


def stop_phase_traffic(runs: list) -> None:
    """Stop whatever of phase 7 still runs (the script failed elsewhere)."""
    for _, proc, _ in runs:
        if proc.is_alive():
            proc.terminate()
            proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join()


def phase_traffic(card: str, runs: list, deadline: float) -> dict:
    """Traffic and chaos on the card: open-loop clients over a WAN-shaped
    16-node BLS cluster (a), and three live Byzantine nodes in a 10-node
    BLS cluster whose corrupt shares the card's bisection rejects (b).
    Waits (until ``deadline`` on the ``time.perf_counter`` clock) for the
    processes :func:`start_phase_traffic` started and returns the kernels'
    launches over (a) and (b), each run's counts set to 0 just before it."""
    launches: dict = {}
    took = {}
    for which, proc, path in runs:
        proc.join(max(0.0, deadline - time.perf_counter()))
        if proc.is_alive():
            stop_phase_traffic(runs)
            raise AssertionError(f"traffic and chaos: ({which}) still ran at the deadline")
        if proc.exitcode != 0:
            raise AssertionError(f"traffic and chaos: ({which}) exited {proc.exitcode}")
        with open(path) as f:
            out = json.load(f)
        took[which] = out["seconds"]
        for k, v in out["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"traffic and chaos: (a) {took['a']:.1f} s, (b) {took['b']:.1f} s, each in a process "
        f"of its own beside phases 1-6  [{card}]")
    return launches


# native-bls-16's flush counts and deliveries at seed 0 (BASELINE config 3,
# benchmarks/config3_native_bls.py with 64 transactions): the reference's
# battery gave them on its TPU host (BATTERY_r04.jsonl, BATTERY_r05.jsonl,
# hybrid backend), and the reference gives them again on a CPU with its
# host BatchedBackend (BENCH_BACKEND=batched BENCH_TXNS=64).  Verdicts are
# pure, so the counts follow from the protocol and the seed alone.
NATIVE_BLS_16_FLUSH_STATS = {"flushes": 352, "requests": 22_832, "backend_requests": 1_520,
                             "max_batch": 240}
NATIVE_BLS_16_DELIVERED = 100_000


def _config3_run(backend, suite, n_txns: int = 64, on_epoch=None):
    """``benchmarks/config3_native_bls.py``'s run on the port's engine:
    16 validators, all correct, batch 256, deferred flushes, the
    transactions of ``random.Random(7)`` round-robin, run in chunks of
    5,000 deliveries until every node has committed all of them.  Returns
    (net, transactions, epoch walls)."""
    from hbbft_tpu_torch.native_engine import NativeQhbNet
    from hbbft_tpu_torch.protocols.queueing_honey_badger import Input

    n = 16
    nat = NativeQhbNet(n, seed=0, batch_size=256, num_faulty=0, session_id=b"config3-bls",
                       suite=suite, backend=backend, flush_every=0)
    rng = random.Random(7)
    txns = [rng.randbytes(16) for _ in range(n_txns)]
    for i, txn in enumerate(txns):
        nat.send_input(i % n, Input.user(txn))
    want = set(txns)
    walls = []
    last = time.perf_counter()
    while not all(want <= _native_committed(nat, i) for i in nat.correct_ids):
        prev = len(nat.nodes[0].outputs)
        nat.run_until(lambda e, w=prev + 1: all(len(e.nodes[i].outputs) >= w
                                                for i in e.correct_ids), chunk=5000)
        now = time.perf_counter()
        walls.append(now - last)
        last = now
        if on_epoch is not None:
            on_epoch(nat, walls[-1], len(_native_committed(nat, 0) & want))
    return nat, txns, walls


def _native_committed(nat, nid: int) -> set:
    return {t for b in nat.nodes[nid].outputs for _, c in b.contributions
            if isinstance(c, (list, tuple)) for t in c}


def phase_native(card: str) -> dict:
    """Phase 8, native-bls-16: BASELINE config 3's fused stack on the card
    (module docstring).  Returns the kernels' launches over the run, the
    counts set to 0 just before it."""
    from torch.profiler import ProfilerActivity, profile

    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import scan as dscan
    from hbbft_tpu_torch.utils import serde

    suite = BLSSuite()
    flush_kernels = (*dscan.KERNELS, *dpair.KERNELS)
    be, stats, rec, warm_s = _service_backend(suite, "native-bls-16")
    # Each flush's own launches: the engine hands a flush to the backend
    # only when it holds a request not verified before.
    per_flush = []
    logged = be.verify_batch

    def counted(reqs):
        before = {k: build.LAUNCHES.get(k, 0) for k in flush_kernels}
        out = logged(reqs)
        per_flush.append({k: build.LAUNCHES.get(k, 0) - before[k] for k in flush_kernels})
        return out

    be.verify_batch = counted

    def on_epoch(nat, wall, committed):
        log(f"native-bls-16 epoch {nat.nodes[0].outputs[-1].epoch}: {wall:.3f} s wall, "
            f"{committed} of 64 transactions committed, {nat.delivered} deliveries  [{card}]")

    build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nat, txns, walls = _config3_run(be, suite, on_epoch=on_epoch)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    busy_us, share = _busy_share(prof, run_s)

    want = set(txns)
    missing = [i for i in range(16) if not want <= _native_committed(nat, i)]
    if missing or nat.correct_ids != list(range(16)):
        raise AssertionError(f"native-bls-16: nodes {missing} lack a transaction")
    streams = {serde.dumps([(b.era, b.epoch, b.contributions) for b in nat.nodes[i].outputs])
               for i in range(16)}
    if len(streams) != 1:
        raise AssertionError("native-bls-16: the nodes' batches differ")
    faults = {i: nat.faults(i) for i in range(16) if nat.faults(i)}
    if faults:
        raise AssertionError(f"native-bls-16: faults recorded: {faults}")
    if nat.flush_stats != NATIVE_BLS_16_FLUSH_STATS or nat.delivered != NATIVE_BLS_16_DELIVERED:
        raise AssertionError(f"native-bls-16: flush_stats {nat.flush_stats}, delivered "
                             f"{nat.delivered} != the reference's {NATIVE_BLS_16_FLUSH_STATS}, "
                             f"{NATIVE_BLS_16_DELIVERED}")
    bare = [k for k, got in enumerate(per_flush) if any(got[name] < 1 for name in flush_kernels)]
    if bare or len(per_flush) != len(rec.flushes):
        raise AssertionError(f"native-bls-16: flushes {bare[:5]} launched no "
                             f"{flush_kernels} ({len(per_flush)} flushes)")
    verdicts = rec.verdicts()
    if not all(verdicts):
        raise AssertionError(f"native-bls-16: {verdicts.count(False)} verdicts False")
    held = 4
    host_s = _host_check(suite, rec, held, "native-bls-16")
    sizes = rec.sizes()
    delivered = nat.delivered
    nat.close()
    log(f"native-bls-16: 16 validators, 64 tx, BLS, the C++ engine's message loop: all 64 "
        f"committed alike on all 16 nodes in {len(walls)} epochs, no fault; {run_s:.3f} s wall "
        f"under torch.profiler, epoch walls {[round(w, 3) for w in walls]} s; "
        f"{delivered} deliveries; flush_stats {json.dumps(nat.flush_stats)} == the reference's "
        f"at seed 0; "
        f"{len(sizes)} TorchBackend flushes, {sum(sizes)} requests, largest {max(sizes)}, median "
        f"{statistics.median(sizes)}; scan and pair kernels on every flush; first {held} "
        f"flushes == BatchedBackend (host, {host_s:.2f} s); kernels warm {warm_s:.1f} s  [{card}]")
    log(f"native-bls-16 {_stage_line(stats, rec.seconds)}; device busy {busy_us:.0f} us of "
        f"{run_s * 1e6:.0f} us = {share}  [{card}]")
    log(f"native-bls-16 launches: {json.dumps(launches, sort_keys=True)}")
    return launches


# Phase 9 (a): the sanitized engines over the card.  Each runs in a child
# python with its runtime LD_PRELOADed (python itself is not instrumented).
# ASan also needs protect_shadow_gap=0: the CUDA driver maps memory inside
# the shadow gap, which ASan protects by default.  Without it a python
# that only starts CUDA under ASan dies in ASan's __cxa_throw interceptor
# ("CHECK failed: ... real___cxa_throw") (H100, CUDA 12.9, GCC 13's libasan).
SANITIZED_ENV = {
    "undefined": {},
    "address": {"ASAN_OPTIONS": "protect_shadow_gap=0:detect_leaks=0"},
}
SANITIZER_REPORT = {"undefined": "runtime error", "address": "AddressSanitizer"}
SANITIZED_BUILDS = ("undefined", "address")
SANITIZED_CHILD_S = 600


def build_sanitized_engines() -> float:
    """Build the UBSan and ASan engines of width 4 (phase 9); returns the
    seconds taken.  Runs in the host build pool beside phases 1-8."""
    from hbbft_tpu_torch import build

    t0 = time.perf_counter()
    for sanitizer in SANITIZED_BUILDS:
        build.build_host("engine", 4, sanitizer=sanitizer)
    return time.perf_counter() - t0


def _ext_net(backend):
    """``NativeQhbNet(4, ...)`` over BLS with external crypto through
    ``backend``, node 3 silent, every correct node given one transaction."""
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
    from hbbft_tpu_torch.native_engine import NativeQhbNet
    from hbbft_tpu_torch.protocols.queueing_honey_badger import Input

    nat = NativeQhbNet(4, seed=9, batch_size=4, session_id=b"sanitized-card", suite=BLSSuite(),
                       external_crypto=True, backend=backend, flush_every=0)
    for i in nat.correct_ids:
        nat.send_input(i, Input.user(f"tx-{i}".encode()))
    return nat


def _first_epoch(nat) -> list:
    """Run ``nat`` until every correct node has a batch; returns the first
    batches of the correct nodes."""
    nat.run_until(lambda e: all(len(e.nodes[i].outputs) >= 1 for i in e.correct_ids),
                  chunk=5000)
    return [[(b.era, b.epoch, b.contributions) for b in nat.nodes[i].outputs[:1]]
            for i in nat.correct_ids]


def _card_epoch() -> dict:
    """:func:`_first_epoch` of :func:`_ext_net` on ``TorchBackend(device="cuda")`` with each
    flush's launches of the scan (K2) and pair (K3) kernels, the counts set
    to 0 just before the run; then the abort leg: a ``TorchBackend`` whose
    second flush raises ``DeviceFlushError`` stops the engine there, the
    error reaches the caller, no fault is recorded and later calls raise."""
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import scan as dscan
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend
    from hbbft_tpu_torch.cryptoplane.service import DeviceFlushError
    from hbbft_tpu_torch.utils import serde

    be = TorchBackend(BLSSuite(), device="cuda")
    be.load_kernels()
    inner = be.verify_batch
    per_flush = []

    def counted(reqs):
        before = dict(build.LAUNCHES)
        out = inner(reqs)
        per_flush.append({k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                          for k in (*dscan.KERNELS, *dpair.KERNELS)})
        return out

    be.verify_batch = counted
    nat = _ext_net(be)
    build.reset_launches()
    t0 = time.perf_counter()
    batches = _first_epoch(nat)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    faults = {i: nat.faults(i) for i in range(4) if nat.faults(i)}
    nat.close()

    failing = TorchBackend(BLSSuite(), device="cuda")
    calls = []
    ok_flush = failing.verify_batch

    def fail_second(reqs):
        calls.append(len(reqs))
        if len(calls) == 2:
            raise DeviceFlushError("flush 2 failed on the device")
        return ok_flush(reqs)

    failing.verify_batch = fail_second
    abort = {"raised": None}
    nat_a = _ext_net(failing)
    try:
        _first_epoch(nat_a)
    except DeviceFlushError as exc:
        abort["raised"] = str(exc)
    abort["flushes"] = len(calls)
    abort["faults"] = sum(len(nat_a.faults(i)) for i in range(4))
    abort["later_calls_raise"] = []
    for call in (nat_a.run, nat_a.flush):
        try:
            call()
        except RuntimeError as exc:
            abort["later_calls_raise"].append("stopped at a failed verify flush" in str(exc))
        else:
            abort["later_calls_raise"].append(False)
    nat_a.close()
    return {"batches": serde.dumps(batches).hex(), "per_flush": per_flush, "launches": launches,
            "faults": faults, "run_s": run_s, "abort": abort, "engine": nat.lib._name}


def sanitized_engine_child(sanitizer: str, out_path: str) -> int:
    """Phase 9 (a)'s child: :func:`_card_epoch` on the ``sanitizer``
    engine (``native_engine.use_engine_build``), its result written to
    ``out_path`` as JSON."""
    from hbbft_tpu_torch import native_engine

    native_engine.use_engine_build(sanitizer)
    result = _card_epoch()
    with open(out_path, "w") as fh:
        json.dump(result, fh)
    return 0


def _check_card_epoch(got: dict, want_batches: str, what: str) -> None:
    """Phase 9 (a)'s checks of one :func:`_card_epoch` result."""
    from hbbft_tpu_torch.crypto.device import pair as dpair
    from hbbft_tpu_torch.crypto.device import scan as dscan

    if got["batches"] != want_batches:
        raise AssertionError(f"{what}: the committed batches differ from the normal engine's")
    if got["faults"]:
        raise AssertionError(f"{what}: faults recorded: {got['faults']}")
    bare = [k for k, f in enumerate(got["per_flush"])
            if sum(f[n] for n in dscan.KERNELS) < 1 or sum(f[n] for n in dpair.KERNELS) < 1]
    if not got["per_flush"] or bare:
        raise AssertionError(f"{what}: flushes {bare} launched no scan or no pair kernel "
                             f"({len(got['per_flush'])} flushes)")
    unused = [n for n in (*dscan.KERNELS, *dpair.KERNELS) if not got["launches"].get(n)]
    if unused:
        raise AssertionError(f"{what}: {unused} never launched")
    ab = got["abort"]
    if not (ab["raised"] and "flush 2 failed" in ab["raised"] and ab["flushes"] == 2
            and ab["faults"] == 0 and ab["later_calls_raise"] == [True, True]):
        raise AssertionError(f"{what}: the abort leg failed: {ab}")


def phase_sanitized(card: str, builds) -> dict:
    """Phase 9 (a): the UBSan and the ASan engine, each in a child process
    with its runtime preloaded, commit the same batches over the card as
    the normal engine in this process, K2 and K3 launched on every flush,
    and stop at a failed device flush (module docstring).  ``builds`` is
    the future of :func:`build_sanitized_engines`.  Returns the children's
    launches, each child's counts set to 0 just before its run."""
    from hbbft_tpu_torch import build

    build_s = builds.result()
    log(f"sanitized engines {SANITIZED_BUILDS} (width 4) built in {build_s:.1f} s beside "
        f"phases 1-8")
    t0 = time.perf_counter()
    want = _card_epoch()
    _check_card_epoch(want, want["batches"], "sanitized-4 (normal engine)")
    log(f"sanitized-4 normal engine: one BLS epoch at N = 4 in {want['run_s']:.3f} s, "
        f"{len(want['per_flush'])} TorchBackend flushes; abort leg at flush 2 ok; "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")
    launches: dict = {}
    for sanitizer in SANITIZED_BUILDS:
        t0 = time.perf_counter()
        out_path = os.path.join(build.BUILD_DIR, f"phase9-{sanitizer}-{os.getpid()}.json")
        env = dict(os.environ, LD_PRELOAD=build.sanitizer_runtime(sanitizer),
                   **SANITIZED_ENV[sanitizer])
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--sanitized-engine",
                              sanitizer, out_path], env=env, capture_output=True, text=True,
                             timeout=SANITIZED_CHILD_S)
        child_s = time.perf_counter() - t0
        report = SANITIZER_REPORT[sanitizer]
        if res.returncode != 0 or report in res.stderr:
            raise AssertionError(f"sanitized-4 {sanitizer}: rc {res.returncode}\n"
                                 f"{res.stderr[-6000:]}")
        with open(out_path) as fh:
            got = json.load(fh)
        os.unlink(out_path)
        what = f"sanitized-4 {sanitizer}"
        if f"_w4_{sanitizer}-" not in got["engine"]:
            raise AssertionError(f"{what}: the child loaded {got['engine']}")
        _check_card_epoch(got, want["batches"], what)
        for k, v in got["launches"].items():
            launches[k] = launches.get(k, 0) + v
        options = " ".join(f"{k}={v}" for k, v in SANITIZED_ENV[sanitizer].items())
        log(f"{what}: {os.path.basename(got['engine'])}, LD_PRELOAD "
            f"{os.path.basename(env['LD_PRELOAD'])} {options}: the normal "
            f"engine's batches, {len(got['per_flush'])} flushes each launching K2 and K3, epoch "
            f"{got['run_s']:.3f} s; abort leg ok; rc 0, no report; child {child_s:.1f} s  [{card}]")
    log(f"sanitized-4 launches: {json.dumps(launches, sort_keys=True)}")
    return launches


def _requests() -> tuple:
    """The flush's workloads, built on the host: the suite, firehose-10240
    and mixed-512 with its bad indices."""
    from hbbft_tpu_torch.crypto import keys
    from hbbft_tpu_torch.crypto.backend import VerifyRequest
    from hbbft_tpu_torch.crypto.bls import curve as oc
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite, G2Elem

    suite = BLSSuite()
    t0 = time.perf_counter()
    firehose = _firehose(keys, VerifyRequest, suite)
    mixed, bad = _mixed_512(keys, VerifyRequest, suite, G2Elem, oc._twist_sample_point())
    log(f"built {len(firehose)} firehose and {len(mixed)} mixed requests on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    return suite, firehose, mixed, bad


def _phases_2_to_6(card: str, suite, firehose: list, mixed: list, bad: list) -> dict:
    """Phases 2-6; returns each main path's launches, its counts set to 0
    just before it."""
    paths = {"dataplane": phase_dataplane(card)}
    paths["flush"] = phase_flush(card, suite, firehose, mixed, bad)
    paths["consensus"] = phase_consensus(card)
    paths["dynamic"] = phase_dynamic(card)
    paths["cryptoplane"] = phase_cryptoplane(card, firehose, mixed, bad)
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from hbbft_tpu_torch import build

    log(f"device free memory before any kernel: {free_mib():.0f} MiB")
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(1)
    # The host C++ (g++) beside the kernels' nvcc processes: its own lock.
    # Phase 9's sanitized engines build after it, beside phases 1-8.
    host = pool.submit(lambda: [build.build_host("engine", 4), build.build_host("native"),
                                time.perf_counter() - t0][-1])
    sanitized = pool.submit(build_sanitized_engines)
    pool.shutdown(wait=False)
    build.build_all(["keccak", "fq", "scan", "pair"], verbose=True)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    log(f"host C++ (engine, data plane) built in {host.result():.1f} s")
    # Phase 7 from here on, beside phases 1-6.  Each main path's launches,
    # its counts set to 0 just before it; a kernel's "launches" is their sum.
    traffic = start_phase_traffic(card)
    try:
        suite, firehose, mixed, bad = _requests()
        t0 = time.perf_counter()
        kernels = phase_kernels(card, leaf_shape=(104 * 104, 14))
        kernels.append(phase_field(card))
        kernels += phase_scan(card, firehose, mixed)
        kernels += phase_pair(card, firehose, mixed, bad)
        log(f"phase 1 {time.perf_counter() - t0:.1f} s  [{card}]")
        paths = _phases_2_to_6(card, suite, firehose, mixed, bad)
        t0 = time.perf_counter()
        paths["native"] = phase_native(card)
        log(f"phase 8 {time.perf_counter() - t0:.1f} s  [{card}]")
        t0 = time.perf_counter()
        paths["sanitized"] = phase_sanitized(card, sanitized)
        log(f"phase 9 {time.perf_counter() - t0:.1f} s  [{card}]")
        paths["traffic"] = phase_traffic(card, traffic, t_start + TRAFFIC_DEADLINE_S)
    finally:
        stop_phase_traffic(traffic)
    for k in kernels:
        k["launches_by_path"] = {p: launches.get(k["name"], 0) for p, launches in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
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
    if sys.argv[1:2] == ["--sanitized-engine"]:
        sys.exit(sanitized_engine_child(*sys.argv[2:4]))
    sys.exit(main())
