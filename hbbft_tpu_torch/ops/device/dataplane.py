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
2. leaf hashes for all V×N shards in one batched SHA3 call,
3. each tree level for all values in one batched SHA3 call.

Stage 1 is :func:`rs_shards`, stages 2 and 3 :func:`tree_levels`.

Stages 2 and 3 run the hand-written Keccak kernel on a CUDA device: one
launch for the leaves and one per level.  Bit-exact with the host path
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


def tree_levels(shards_vn: torch.Tensor, n: int) -> List[torch.Tensor]:
    """Stages 2 and 3: the leaf hashes H(0x00 || shard) of all V*n shards
    in one call, then one call per tree level (K6, on the Keccak kernel):
    [(V, width, 32) uint8] from the leaves up to the roots."""
    V, _, shard_len = shards_vn.shape
    dev = shards_vn.device
    size = 1 << _depth(n)
    leaves_in = torch.zeros((V * n, 1 + shard_len), dtype=torch.uint8, device=dev)
    leaves_in[:, 1:] = shards_vn.reshape(V * n, shard_len)
    leaf_hashes = dk.sha3_256_batch(leaves_in).reshape(V, n, 32)
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
        cur = levels[-1].reshape(V * (width // 2), 64)
        levels.append(dk.merkle_level(0x01, cur).reshape(V, width // 2, 32))
        width //= 2
    return levels


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
    levels = tree_levels(shards_vn, n)

    # One copy back to the host; proofs are assembled there.
    host_levels = [lv.cpu().numpy() for lv in levels]
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
