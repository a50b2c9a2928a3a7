"""Port Keccak / SHA3-256 vs the JAX package's plain jnp reference and
hashlib, on the CPU (the plain PyTorch path; the CUDA kernel is held
against the same plain path on the card by chip_smoke.py).

The Pallas kernel itself is not run here: the JAX package's own test
skips it off-TPU because interpret-mode compile time is unbounded, so the
reference is its jnp ``keccak_f``/``sha3_256_batch``.  Tolerance: exact
equality of every lane and every digest byte.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.ops import merkle as ref_merkle
from hbbft_tpu.ops.jaxops import keccak as jk
from hbbft_tpu_torch import build
from hbbft_tpu_torch.ops.device import dataplane as tdp
from hbbft_tpu_torch.ops.device import keccak as tk

# Small tensors: intra-op threads only contend with the other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(9)


def test_keccak_f_matches_jax(rng):
    states = rng.integers(0, 2**32, size=(6, 25, 2), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jk.keccak_f(jnp.asarray(states))).astype(np.int64)
    got = tk.keccak_f(torch.as_tensor(states.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [0, 1, 64, 65, 135, 136, 300, 2000])
def test_sha3_batch_matches_hashlib_and_jax(rng, m):
    msgs = rng.integers(0, 256, size=(4, m), dtype=np.uint8)
    got = tk.sha3_256_batch(msgs, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(jk.sha3_256_batch(msgs)))
    for i in range(4):
        assert got[i].tobytes() == hashlib.sha3_256(msgs[i].tobytes()).digest()


def test_padding_helpers_match_reference(rng):
    for m in (0, 70, 135, 136, 500):
        msgs = rng.integers(0, 256, size=(3, m), dtype=np.uint8)
        np.testing.assert_array_equal(tk.pad_multi(msgs), jk.pad_multi(msgs))
        np.testing.assert_array_equal(
            tk.pad_tensor(torch.as_tensor(msgs)).numpy(), jk.pad_multi(msgs)
        )
        if m < jk.RATE:
            np.testing.assert_array_equal(tk.pad_block(msgs), jk.pad_block(msgs))
    block = jk.pad_block(rng.integers(0, 256, size=(2, 40), dtype=np.uint8))
    np.testing.assert_array_equal(tk.block_words(block), jk.block_words(block))
    state = rng.integers(0, 2**32, size=(2, 25, 2), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        tk.digest_from_state(state), jk.digest_from_state(state)
    )


def test_merkle_level_matches_jax_and_host(rng):
    pairs = rng.integers(0, 256, size=(8, 64), dtype=np.uint8)
    got = tk.merkle_level(0x01, pairs, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jk.merkle_level(0x01, pairs)))
    for i in range(8):
        left, right = bytes(pairs[i, :32]), bytes(pairs[i, 32:])
        assert got[i].tobytes() == ref_merkle._h_branch(left, right)


def test_cpu_path_never_counts_a_kernel_launch(rng):
    build.reset_launches()
    tk.sha3_256_batch(rng.integers(0, 256, size=(3, 10), dtype=np.uint8), device="cpu")
    shards = torch.as_tensor(rng.integers(0, 256, size=(2, 3, 5), dtype=np.uint8))
    tdp.tree_levels(shards, 3)
    assert build.LAUNCHES[tk.KERNEL] == 0
    assert build.LAUNCHES[tk.TREE_KERNEL] == 0
    with pytest.raises(ValueError):
        tk.sha3_256_kernel(tk.pad_tensor(torch.zeros((1, 3), dtype=torch.uint8)))
    with pytest.raises(ValueError):
        tk.merkle_tree_kernel(shards)
