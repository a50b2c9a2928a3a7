"""SHA3-256 Merkle trees and inclusion proofs.

Reference: upstream ``src/broadcast/merkle.rs`` (``MerkleTree``, ``Proof``
over ``tiny-keccak`` SHA3-256) — SURVEY.md §2 #4.  Domain-separated leaf
vs branch hashing prevents proof-length forgeries.

Copy of ``hbbft_tpu/ops/merkle.py``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Sequence, Tuple

try:
    from hbbft_tpu_torch.ops import native as _native
except Exception:  # pragma: no cover - native plane is optional
    _native = None


def _h_leaf(data: bytes) -> bytes:
    return hashlib.sha3_256(b"\x00" + data).digest()


def _h_branch(left: bytes, right: bytes) -> bytes:
    return hashlib.sha3_256(b"\x01" + left + right).digest()


@dataclass(frozen=True)
class Proof:
    """Inclusion proof: the leaf value, its index, and the sibling path."""

    value: bytes
    index: int
    path: Tuple[bytes, ...]
    root: bytes

    def well_formed(self) -> bool:
        """Structural check — fields may be arbitrary Byzantine objects."""
        return (
            isinstance(self.value, bytes)
            and isinstance(self.index, int)
            and not isinstance(self.index, bool)
            and isinstance(self.path, tuple)
            and all(isinstance(p, bytes) and len(p) == 32 for p in self.path)
            and isinstance(self.root, bytes)
            and len(self.root) == 32
        )

    def validate(self, n_leaves: int) -> bool:
        """Check the path hashes from ``value`` up to ``root``.

        ``n_leaves`` bounds the expected path length so a forged deeper/
        shallower proof is rejected.
        """
        if not self.well_formed():
            return False
        if not 0 <= self.index < n_leaves:
            return False
        if len(self.path) != _depth(n_leaves):
            return False
        h = _h_leaf(self.value)
        idx = self.index
        for sib in self.path:
            if idx & 1:
                h = _h_branch(sib, h)
            else:
                h = _h_branch(h, sib)
            idx >>= 1
        return h == self.root


def _depth(n_leaves: int) -> int:
    d = 0
    size = 1
    while size < n_leaves:
        size <<= 1
        d += 1
    return d


class MerkleTree:
    """Complete binary tree over the leaves (padded with empty hashes)."""

    def __init__(self, leaves: Sequence[bytes]) -> None:
        assert leaves, "empty tree"
        self.leaves = list(leaves)
        n = len(self.leaves)
        leaf_len = len(self.leaves[0])
        if (
            _native is not None
            and _native.available()
            and all(len(v) == leaf_len for v in self.leaves)
        ):
            # Native C++ fast path (equal-length leaves, the Broadcast
            # shard case); bit-identical to the fallback below.
            self.levels = _native.merkle_levels(self.leaves)
            return
        size = 1 << _depth(n)
        level = [_h_leaf(v) for v in self.leaves]
        level += [_h_leaf(b"")] * (size - n)
        self.levels: List[List[bytes]] = [level]
        while len(level) > 1:
            level = [
                _h_branch(level[i], level[i + 1]) for i in range(0, len(level), 2)
            ]
            self.levels.append(level)

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    def proof(self, index: int) -> Proof:
        assert 0 <= index < len(self.leaves)
        path = []
        idx = index
        for level in self.levels[:-1]:
            path.append(level[idx ^ 1])
            idx >>= 1
        return Proof(self.leaves[index], index, tuple(path), self.root)
