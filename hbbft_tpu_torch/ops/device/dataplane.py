"""Batched broadcast data plane on the card: RS-encode + Merkle prove.

Counterpart of ``hbbft_tpu/ops/jaxops/dataplane.py``.  Reference
behaviour: the proposer side of ``Broadcast.handle_input`` —
``reed-solomon-erasure`` encode + ``tiny-keccak`` Merkle tree + per-node
proofs — for MANY values at once (one RBC instance per validator runs
per epoch, so the proposers' data plane is a batch problem: V values × N
shards).  Three device stages:

1. RS parity for all values in ONE GF(2) bit product (the per-value
   encode matrices are identical, so values concatenate along the column
   axis of a single ``ENC_BITS @ data_bits``),
2. leaf hashes for all V×N shards,
3. each tree level for all values.

Stage 1 is :func:`rs_shards`, stages 2 and 3 :func:`merkle_tree` (and its
per-level views, :func:`tree_levels`).

On a CUDA device stages 2 and 3 are one launch of the hand-written Merkle
tree kernel (``csrc/keccak.cu``), which reads the shards as they are; on
the CPU they run :func:`tree_levels_plain`, the plain sponge once for the
leaves and once per level.  Bit-exact with the host path
(:class:`~hbbft_tpu_torch.ops.merkle.MerkleTree`,
:class:`~hbbft_tpu_torch.ops.gf256.ReedSolomon`).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.device import DeviceLike, resolve
from hbbft_tpu_torch.ops.device import gf256 as dgf
from hbbft_tpu_torch.ops.device import keccak as dk
from hbbft_tpu_torch.ops.merkle import Proof, _depth

# The reference's per-call shard bound (16 blocks ~= 2 KB): callers route
# larger shards to the host path, as they do for the reference.
MAX_DEV_SHARD = 16 * dk.RATE - 2


def _pack(value: bytes, k: int) -> Tuple[np.ndarray, int]:
    """Length-prefix and pad into (k, shard_len) uint8."""
    payload = len(value).to_bytes(8, "big") + value
    shard_len = max(1, -(-len(payload) // k))
    payload = payload.ljust(k * shard_len, b"\x00")
    return (
        np.frombuffer(payload, dtype=np.uint8).reshape(k, shard_len),
        shard_len,
    )


def rs_shards(data: torch.Tensor, n: int) -> torch.Tensor:
    """Stage 1: (V, k, s) uint8 data shards -> (V, n, s) data and parity
    shards, every value's parity in one bit product (K5)."""
    V, k, shard_len = data.shape
    flat = data.transpose(0, 1).reshape(k, V * shard_len)
    parity = dgf.gf2_matmul(dgf._enc_bits(k, n), flat).reshape(n - k, V, shard_len)
    return torch.cat([data, parity.transpose(0, 1)], dim=1)


def _sha3_plain(msgs: torch.Tensor) -> torch.Tensor:
    return dk.sha3_256_padded(dk.pad_tensor(msgs))


def tree_levels_plain(shards_vn: torch.Tensor, n: int) -> torch.Tensor:
    """Stages 2 and 3 in plain PyTorch on the shards' device: the leaf
    hashes H(0x00 || shard) of all V*n shards in one sponge call, then one
    call per tree level.  Returns every level, bottom up, as one (V,
    2 size - 1, 32) uint8 tensor (size = the next power of two >= n)."""
    V, _, shard_len = shards_vn.shape
    dev = shards_vn.device
    size = 1 << _depth(n)
    leaves_in = torch.zeros((V * n, 1 + shard_len), dtype=torch.uint8, device=dev)
    leaves_in[:, 1:] = shards_vn.reshape(V * n, shard_len)
    leaf_hashes = _sha3_plain(leaves_in).reshape(V, n, 32)
    if size > n:
        pad = torch.as_tensor(
            np.frombuffer(hashlib.sha3_256(b"\x00").digest(), dtype=np.uint8).copy(),
            device=dev,
        )
        leaf_hashes = torch.cat(
            [leaf_hashes, pad.expand(V, size - n, 32)], dim=1
        )
    levels = [leaf_hashes]  # (V, width, 32)
    width = size
    while width > 1:
        pairs = levels[-1].reshape(V * (width // 2), 64)
        head = torch.ones((pairs.shape[0], 1), dtype=torch.uint8, device=dev)
        levels.append(_sha3_plain(torch.cat([head, pairs], dim=1)).reshape(V, width // 2, 32))
        width //= 2
    return torch.cat(levels, dim=1)


def merkle_tree(shards_vn: torch.Tensor, n: int) -> torch.Tensor:
    """Stages 2 and 3 (K6): every level of each value's tree, bottom up, as
    one (V, 2 size - 1, 32) uint8 tensor — the layout of the reference's
    ``ops/native.py`` ``merkle_levels``.  A CUDA tensor goes through the
    tree kernel (one launch), a CPU tensor through :func:`tree_levels_plain`."""
    if shards_vn.shape[1] != n:
        raise ValueError(f"{shards_vn.shape[1]} shards per value, expected {n}")
    if shards_vn.device.type == "cuda":
        return dk.merkle_tree_kernel(shards_vn.contiguous())
    return tree_levels_plain(shards_vn, n)


def level_views(tree):
    """The levels of a (V, 2 size - 1, 32) tree (tensor or array) as views,
    [(V, width, 32)] from the leaves up to the roots."""
    width = (tree.shape[1] + 1) // 2
    at = 0
    levels = []
    while True:
        levels.append(tree[:, at:at + width])
        at += width
        if width == 1:
            return levels
        width //= 2


def tree_levels(shards_vn: torch.Tensor, n: int) -> List[torch.Tensor]:
    """Stages 2 and 3: [(V, width, 32) uint8] from the leaves up to the
    roots, views into :func:`merkle_tree`'s tensor."""
    return level_views(merkle_tree(shards_vn, n))


@torch.inference_mode()
def encode_and_prove(
    values: Sequence[bytes], k: int, n: int, device: DeviceLike = None
) -> List[List[Proof]]:
    """RS-encode + Merkle-prove a batch of equal-shard-size values.

    Returns ``proofs[v][i]`` — the proof of value v's shard i, exactly
    what ``Broadcast`` sends node i as its ``Value`` message.  All values
    must pack to one common shard length.  Runs on ``device`` (``cuda``
    unless the caller passes ``"cpu"``).
    """
    dev = resolve(device)
    if not values:
        raise ValueError("empty batch")
    packs = [_pack(v, k) for v in values]
    shard_len = packs[0][1]
    if any(s != shard_len for _, s in packs):
        raise ValueError("mixed shard lengths")
    V = len(values)
    data = torch.as_tensor(np.stack([p for p, _ in packs]), device=dev)  # (V, k, s)
    shards_vn = rs_shards(data, n)
    tree = merkle_tree(shards_vn, n)

    # One copy of the tree back to the host; proofs are assembled there.
    host_levels = level_views(tree.cpu().numpy())
    shards_np = shards_vn.cpu().numpy()
    roots = host_levels[-1][:, 0, :]
    out: List[List[Proof]] = []
    for v in range(V):
        root = roots[v].tobytes()
        proofs_v = []
        for i in range(n):
            path = []
            idx = i
            for level in host_levels[:-1]:
                path.append(level[v, idx ^ 1].tobytes())
                idx >>= 1
            proofs_v.append(
                Proof(
                    value=shards_np[v, i].tobytes(),
                    index=i,
                    path=tuple(path),
                    root=root,
                )
            )
        out.append(proofs_v)
    return out
