"""The Keccak kernels' code (``csrc/keccak.cuh``) on the CPU, against
hashlib, the port's plain sponge and tree, and the JAX package.

A CUDA kernel does not run here, but ``keccak.cuh`` is ``__host__
__device__`` code: ``csrc/keccak_check.cc`` includes it and is compiled
with the host C++ compiler into a temporary directory (about a second),
and these tests drive it.  It runs ``merkle_tree_kernel``'s block one
thread after another and level after level, and ``sha3_256_kernel``'s
threads one message after another, with the same staging of 16-byte
chunks (a copy in place of ``cp.async``), word assembly, masking and
padding as on the card; the input starts past a 16-byte boundary with a
filler around it that no digest may see.  ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold the kernels against the plain versions on the
card.

The JAX reference is ``hbbft_tpu/ops/jaxops/keccak.py``'s
``sha3_256_batch`` for the leaves and ``merkle_level`` chained level by
level, as its ``dataplane.encode_and_prove`` builds a tree, batched over
every tree of the same shard length (an eager JAX permutation costs a
tenth of a second whatever the batch).  Tolerance: exact, every byte of
every level.
"""

import hashlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hbbft_tpu.ops.jaxops import keccak as jk
from hbbft_tpu_torch.ops import merkle as port_merkle
from hbbft_tpu_torch.ops.device import dataplane as tdp
from hbbft_tpu_torch.ops.device import keccak as tk
from torch_low_priority import low_priority

# Small tensors: intra-op threads only contend with the other test workers.
torch.set_num_threads(1)

CSRC = Path(tk.__file__).resolve().parents[2] / "csrc"
SHARD_LENS = (1, 134, 135, 136, 1778)
SHAPES = [(v, n, s) for v in (1, 3) for n in (1, 2, 3, 7, 10, 104) for s in SHARD_LENS]
PAD_LEAF = hashlib.sha3_256(b"\x00").digest()


@pytest.fixture(scope="module")
def keccak_check(tmp_path_factory):
    """The host build of keccak.cuh (skips only without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel header for the host")
    exe = tmp_path_factory.mktemp("keccak_host") / "keccak_check"
    subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O2", "-Wall", "-Werror", f"-I{CSRC}",
         "-o", str(exe), str(CSRC / "keccak_check.cc")],
        check=True, capture_output=True, text=True, timeout=120,
    )

    def run(args, data: bytes) -> bytes:
        return subprocess.run([str(exe), *map(str, args)], input=data, check=True,
                              capture_output=True, timeout=120).stdout

    return run


def _shards(values: int, n: int, s: int) -> np.ndarray:
    rng = np.random.default_rng(values * 100_000 + n * 10_000 + s)
    return rng.integers(0, 256, size=(values, n, s), dtype=np.uint8)


def host_tree(run, shards: np.ndarray, threads: int = 0, offset: int = 0) -> np.ndarray:
    """merkle_tree_kernel's blocks on the host: (V, 2 size - 1, 32)."""
    values, n, s = shards.shape
    out = run(["tree", values, n, s, threads, offset], shards.tobytes())
    return np.frombuffer(out, dtype=np.uint8).reshape(values, 2 * tk.tree_size(n) - 1, 32)


def hashlib_tree(shards_v: np.ndarray) -> bytes:
    """Every level of one value's tree, bottom up, from hashlib."""
    tree = port_merkle.MerkleTree([row.tobytes() for row in shards_v])
    return b"".join(h for level in tree.levels for h in level)


@pytest.fixture(scope="module")
@low_priority
def jax_trees():
    """The JAX package's trees of every shape: leaves by ``sha3_256_batch``
    (one call per shard length, all trees of that length together), then
    each level by ``merkle_level`` (one call per depth, every tree still
    above its root together), as (V, 2 size - 1, 32) arrays."""
    levels = {}
    for s in SHARD_LENS:
        shapes = [shape for shape in SHAPES if shape[2] == s]
        msgs = np.concatenate([
            np.concatenate([np.zeros((v * n, 1), np.uint8), _shards(v, n, s).reshape(v * n, s)],
                           axis=1)
            for v, n, _ in shapes])
        digests = np.asarray(jk.sha3_256_batch(msgs))
        at = 0
        for v, n, _ in shapes:
            leaves = digests[at:at + v * n].reshape(v, n, 32)
            at += v * n
            pad = np.broadcast_to(np.frombuffer(PAD_LEAF, np.uint8),
                                  (v, tk.tree_size(n) - n, 32))
            levels[(v, n, s)] = [np.concatenate([leaves, pad], axis=1)]
    while True:
        todo = [k for k, lv in levels.items() if lv[-1].shape[1] > 1]
        if not todo:
            break
        pairs = [levels[k][-1].reshape(-1, 64) for k in todo]
        nodes = np.asarray(jk.merkle_level(0x01, np.concatenate(pairs)))
        at = 0
        for k, p in zip(todo, pairs):
            v = k[0]
            levels[k].append(nodes[at:at + p.shape[0]].reshape(v, -1, 32))
            at += p.shape[0]
    return {k: np.concatenate(lv, axis=1) for k, lv in levels.items()}


@pytest.mark.parametrize("values,n,s", SHAPES)
@low_priority
def test_tree_block_matches_hashlib_plain_and_jax(keccak_check, jax_trees, values, n, s):
    shards = _shards(values, n, s)
    got = host_tree(keccak_check, shards, offset=(n + s) % 16)
    assert got.tobytes() == jax_trees[(values, n, s)].tobytes()
    plain = tdp.tree_levels_plain(torch.as_tensor(shards), n).numpy()
    assert got.tobytes() == plain.tobytes()
    for v in range(values):
        assert got[v].tobytes() == hashlib_tree(shards[v])


@pytest.mark.parametrize("values,n,s,threads", [
    (3, 10, 135, 3), (1, 104, 1778, 1), (3, 7, 1, 2), (1, 104, 136, 48),
])
@low_priority
def test_tree_block_with_fewer_threads_than_leaves(keccak_check, values, n, s, threads):
    """A block of fewer threads than leaf slots loops over leaves and nodes
    (the kernel does so above 128 leaves) and gives the same tree."""
    shards = _shards(values, n, s)
    got = host_tree(keccak_check, shards, threads=threads, offset=7)
    for v in range(values):
        assert got[v].tobytes() == hashlib_tree(shards[v])


@pytest.mark.parametrize("m", [0, 1, 135, 136, 300, 1779])
@pytest.mark.parametrize("offset", [0, 3, 8])
@low_priority
def test_sponge_thread_matches_hashlib_and_plain(keccak_check, m, offset):
    """sha3_256_kernel's thread over pre-padded messages, from any start
    address: the message ending one byte before a block, on one, and
    spanning many."""
    rng = np.random.default_rng(m * 10 + offset)
    msgs = rng.integers(0, 256, size=(5, m), dtype=np.uint8)
    padded = tk.pad_multi(msgs)
    nb = padded.shape[1] // tk.RATE
    got = np.frombuffer(keccak_check(["sponge", 5, nb, offset], padded.tobytes()),
                        dtype=np.uint8).reshape(5, 32)
    np.testing.assert_array_equal(got, tk.sha3_256_padded(torch.as_tensor(padded)).numpy())
    for i in range(5):
        assert got[i].tobytes() == hashlib.sha3_256(msgs[i].tobytes()).digest()


def _sass(body: list, labels: bool) -> str:
    """A ``cuobjdump -sass`` listing of ``body``: opcodes, or ("loop", n)
    for a label and ("back", n) for a predicated branch back to it."""
    lines, marks, at = ["        Function : _Z6kernelv"], {}, 0
    for op in body:
        if isinstance(op, tuple) and op[0] == "loop":
            marks[op[1]] = at
            if labels:
                lines.append(f".L_x_{op[1]}:")
            continue
        if isinstance(op, tuple):
            target = f"`(.L_x_{op[1]})" if labels else f"0x{marks[op[1]]:x}"
            op = f"@P0 BRA {target}"
        lines.append(f"        /*{at:04x}*/                   {op} ;   /* 0x000fe20000000f00 */")
        lines.append("                                                      /* 0x000fca0000000000 */")
        at += 16
    return "\n".join(lines)


@pytest.mark.parametrize("labels", [True, False])
def test_sass_round_loop_counts_the_executed_rounds(labels):
    """``chip_smoke.py``'s reading of a permutation's round loop: the
    innermost loop with the most LOP3s, run 24 times, and the block loop
    around it (here unrolled by two: two round loops and 3 other
    instructions, 1.5 a block), whether the listing names its branch
    targets by label or by address."""
    import chip_smoke as cs

    rnd = ["LOP3.LUT R2, R3, R4, R5, 0x96, !PT"] * 3 + ["SHF.L.W.U32.HI R6, R7, 0x1, R8",
                                                        "IADD3 R0, R0, 0x1, RZ"]
    body = (["S2R R0, SR_TID.X", ("loop", 0), "LDS.128 R8, [R1]", ("loop", 1), *rnd, ("back", 1),
             "STS.128 [R1], R8", ("loop", 2), *rnd, ("back", 2), ("back", 0), "EXIT",
             ("loop", 3), ("back", 3)])
    listing = _sass(body, labels)
    ops, loops = cs.sass_loops(listing)
    assert len(ops) == 18 and len(loops) == 4
    assert cs.sass_round_loop(listing) == (
        "round loop 6 instructions (LOP3 3, SHF 1): 24 x 6 = 144 executed a permutation; "
        "the loop around it holds 2 round loop(s) and 3 other instructions: 146 executed a block")
    assert cs.sass_round_loop(_sass(["LOP3.LUT R2, R3, R4, R5, 0x96, !PT", "EXIT"], labels)) == ""
