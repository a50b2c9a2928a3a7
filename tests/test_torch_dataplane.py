"""Port RBC data plane (RS bit product + Merkle proofs) vs the JAX
package's ``ReedSolomonJax``/``encode_and_prove`` and the host Broadcast
data plane, on the CPU.  Tolerance: exact — every shard byte and every
proof field (value, index, path, root) compared byte for byte.
"""

import itertools
import random

import numpy as np
import pytest
import torch

from hbbft_tpu.ops import gf256 as ref_gf
from hbbft_tpu.ops.jaxops import dataplane as jdp
from hbbft_tpu.ops.jaxops import gf256 as jgf
from hbbft_tpu.ops.merkle import MerkleTree as RefMerkleTree
from hbbft_tpu_torch.ops import gf256 as port_gf
from hbbft_tpu_torch.ops import merkle as port_merkle
from hbbft_tpu_torch.ops.device import dataplane as tdp
from hbbft_tpu_torch.ops.device import gf256 as tgf

# Small tensors: intra-op threads only contend with the other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(9)


def _fields(proofs):
    return [[(p.value, p.index, tuple(p.path), p.root) for p in row] for row in proofs]


@pytest.mark.parametrize("k,n", [(2, 3), (4, 7), (6, 10)])
def test_rs_encode_matches_jax_and_host(rng, k, n):
    data = [bytes(rng.integers(0, 256, 48, dtype=np.uint8)) for _ in range(k)]
    got = tgf.ReedSolomonTorch(k, n, device="cpu").encode(data)
    assert got == jgf.ReedSolomonJax(k, n).encode(data)
    assert got == ref_gf.ReedSolomon(k, n).encode(data)
    assert got == port_gf.ReedSolomon(k, n).encode(data)
    np.testing.assert_array_equal(tgf._enc_bits(k, n), jgf._enc_bits(k, n))


def test_rs_reconstruct_roundtrip_matches_jax(rng):
    k, n = 4, 7
    rs = tgf.ReedSolomonTorch(k, n, device="cpu")
    ref = jgf.ReedSolomonJax(k, n)
    data = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(k)]
    shards = rs.encode(data)
    for idxs in itertools.combinations(range(n), k):
        sub = {i: shards[i] for i in idxs}
        assert rs.reconstruct(sub) == data == ref.reconstruct(sub)
        assert port_gf.ReedSolomon(k, n).reconstruct(sub) == data


def test_dataplane_matches_jax_and_host_broadcast():
    rng = random.Random(17)
    k, n = 5, 7
    values = [rng.randbytes(rng.randrange(200, 220)).ljust(220, b"\x00") for _ in range(6)]
    got = tdp.encode_and_prove(values, k, n, device="cpu")
    assert _fields(got) == _fields(jdp.encode_and_prove(values, k, n))
    rs = ref_gf.ReedSolomon(k, n)
    for v, value in enumerate(values):
        packed, _ = jdp._pack(value, k)
        tree = RefMerkleTree(rs.encode([bytes(r) for r in packed]))
        for i in range(n):
            want = tree.proof(i)
            assert _fields([[got[v][i]]]) == _fields([[want]])
            assert got[v][i].validate(n)


def test_dataplane_config2_shape_matches_jax(rng):
    """Config 2's 10-node / 1 KB shape: multi-block leaves, exact proofs."""
    from hbbft_tpu.protocols.broadcast import _pack

    k, n = 4, 10
    value = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    got = tdp.encode_and_prove([value], k, n, device="cpu")
    assert _fields(got) == _fields(jdp.encode_and_prove([value], k, n))
    shards = ref_gf.ReedSolomon(k, n).encode(list(_pack(value, k)))
    tree = port_merkle.MerkleTree(shards)
    assert tree.root == RefMerkleTree(shards).root
    for i in range(n):
        assert _fields([[got[0][i]]]) == _fields([[tree.proof(i)]])


def test_tree_levels_are_views_of_one_tree_and_proofs_hold(rng):
    """The plain tree path: every level, bottom up, in one (V, 2 size - 1,
    32) tensor (the reference's ``merkle_levels`` layout), the levels as
    views into it, each equal to the host MerkleTree's; and proofs of a
    padded tree (n = 3, size 4) equal the JAX package's and the host's."""
    V, n, s = 3, 5, 40
    shards = torch.as_tensor(rng.integers(0, 256, size=(V, n, s), dtype=np.uint8))
    tree = tdp.merkle_tree(shards, n)
    assert tree.shape == (V, 2 * 8 - 1, 32)
    levels = tdp.level_views(tree)
    assert [lv.shape[1] for lv in levels] == [8, 4, 2, 1]
    base = tree.untyped_storage().data_ptr()
    assert all(lv.untyped_storage().data_ptr() == base for lv in levels)
    assert [lv.tolist() for lv in tdp.tree_levels(shards, n)] == [lv.tolist() for lv in levels]
    for v in range(V):
        host = RefMerkleTree([bytes(shards[v, i].numpy()) for i in range(n)])
        assert [[bytes(h.numpy()) for h in lv[v]] for lv in levels] == host.levels

    k, n = 2, 3
    values = [bytes(rng.integers(0, 256, 90, dtype=np.uint8)) for _ in range(4)]
    got = tdp.encode_and_prove(values, k, n, device="cpu")
    assert _fields(got) == _fields(jdp.encode_and_prove(values, k, n))
    rs = ref_gf.ReedSolomon(k, n)
    for v, value in enumerate(values):
        packed, _ = jdp._pack(value, k)
        host = RefMerkleTree(rs.encode([bytes(r) for r in packed]))
        assert _fields([got[v]]) == _fields([[host.proof(i) for i in range(n)]])
