"""Small shared utilities (canonical hashing, deterministic RNG)."""

from __future__ import annotations

import hashlib
from typing import Union


def sha3_256(data: bytes) -> bytes:
    return hashlib.sha3_256(data).digest()


def canonical_bytes(*parts: Union[bytes, str, int]) -> bytes:
    """Length-prefixed concatenation — collision-free framing for hashing."""
    out = bytearray()
    for p in parts:
        if isinstance(p, str):
            p = p.encode("utf-8")
        elif isinstance(p, int):
            p = p.to_bytes((max(p.bit_length(), 1) + 7) // 8, "big", signed=False)
        out += len(p).to_bytes(8, "big")
        out += p
    return bytes(out)


def xor_bytes(a: bytes, b: bytes) -> bytes:
    """XOR of the common prefix (wide-int XOR: ~10x the per-byte loop,
    which showed up in epoch profiles via the KEM mask path)."""
    n = min(len(a), len(b))
    return (
        int.from_bytes(a[:n], "little") ^ int.from_bytes(b[:n], "little")
    ).to_bytes(n, "little")


def kdf_stream(seed: bytes, n: int) -> bytes:
    """Expand ``seed`` into ``n`` bytes via SHA3-256 in counter mode."""
    out = bytearray()
    ctr = 0
    while len(out) < n:
        out += hashlib.sha3_256(seed + ctr.to_bytes(8, "big")).digest()
        ctr += 1
    return bytes(out[:n])
