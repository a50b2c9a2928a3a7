"""GF(256) arithmetic and systematic Reed-Solomon erasure coding.

Reference: the ``reed-solomon-erasure`` crate used by upstream
``src/broadcast/broadcast.rs`` (SURVEY.md §2 #4): N shards = K data +
(N-K) parity over GF(2^8), any K shards reconstruct.

Field: GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11d),
generator 2.  The encoding matrix is a Vandermonde matrix normalized so
its top K x K block is the identity (systematic: data shards pass
through unchanged) — the same construction the reference crate uses.

Implementation: numpy log/exp-table arithmetic, with the native C++
fast path of :mod:`hbbft_tpu_torch.ops.native` where it builds (the same
bytes).  The device path (:mod:`hbbft_tpu_torch.ops.device.gf256`)
expresses the same encode/decode as GF(2) bit-matrix products.

Copy of ``hbbft_tpu/ops/gf256.py``, GF(2^16) codec for validator sets
over 255 included (host only, as in the reference).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Sequence

import numpy as np

try:
    from hbbft_tpu_torch.ops import native as _native
except Exception:  # pragma: no cover - native plane is optional
    _native = None

_POLY = 0x11D

EXP = np.zeros(512, dtype=np.uint8)
LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    EXP[_i] = _x
    LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _POLY
EXP[255:510] = EXP[:255]  # wraparound so exp[log a + log b] needs no mod


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(EXP[255 - LOG[a]])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(256); uint8 arrays (m,k) @ (k,n) -> (m,n)."""
    assert a.shape[1] == b.shape[0]
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[1]):  # rank-1 accumulation, vectorized over cells
        col = a[:, i]
        row = b[i, :]
        nz = (col[:, None].astype(np.int32) != 0) & (row[None, :].astype(np.int32) != 0)
        prod = EXP[(LOG[col][:, None] + LOG[row][None, :])]
        out ^= np.where(nz, prod, 0).astype(np.uint8)
    return out


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(256)."""
    n = m.shape[0]
    assert m.shape == (n, n)
    a = m.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        pivot = None
        for r in range(col, n):
            if a[r, col] != 0:
                pivot = r
                break
        if pivot is None:
            raise ValueError("singular matrix over GF(256)")
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        pinv = gf_inv(int(a[col, col]))
        a[col] = _row_scale(a[col], pinv)
        inv[col] = _row_scale(inv[col], pinv)
        for r in range(n):
            if r != col and a[r, col] != 0:
                factor = int(a[r, col])
                a[r] ^= _row_scale(a[col], factor)
                inv[r] ^= _row_scale(inv[col], factor)
    return inv


def _row_scale(row: np.ndarray, s: int) -> np.ndarray:
    if s == 0:
        return np.zeros_like(row)
    nz = row != 0
    out = np.zeros_like(row)
    out[nz] = EXP[LOG[row[nz]] + LOG[s]]
    return out


@lru_cache(maxsize=256)
def encoding_matrix(k: int, n: int) -> "np.ndarray":
    """Systematic n x k encoding matrix (top k rows = identity).

    Vandermonde rows [a_i^0 .. a_i^(k-1)] with distinct points a_i =
    exp(i) (distinct for n <= 255), right-multiplied by the inverse of
    the top k x k block; any k rows stay independent under that
    normalization.
    """
    assert 0 < k <= n <= 255
    vand = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        for j in range(k):
            vand[i, j] = EXP[(i * j) % 255]
    top_inv = gf_mat_inv(vand[:k])
    return gf_matmul(vand, top_inv)


class ReedSolomon:
    """Systematic RS(k-of-n) erasure codec over byte shards."""

    shard_align = 1  # GF(256) symbols are single bytes

    def __init__(self, k: int, n: int) -> None:
        assert 0 < k <= n <= 255, "GF(256) Vandermonde supports at most 255 shards"
        self.k = k
        self.n = n
        self.matrix = encoding_matrix(k, n)

    def encode(self, data_shards: Sequence[bytes]) -> List[bytes]:
        """k equal-length data shards -> n shards (data + parity)."""
        assert len(data_shards) == self.k
        size = len(data_shards[0])
        assert all(len(s) == size for s in data_shards)
        if _native is not None and _native.available():
            out = _native.rs_encode(data_shards, self.n)
            if out is not None:
                return out
        data = np.frombuffer(b"".join(data_shards), dtype=np.uint8).reshape(
            self.k, size
        )
        parity = gf_matmul(self.matrix[self.k :], data)
        return [bytes(s) for s in data] + [bytes(p) for p in parity]

    def reconstruct(self, shards: Dict[int, bytes]) -> List[bytes]:
        """Any k shards (by index) -> the k data shards."""
        if len(shards) < self.k:
            raise ValueError(f"need {self.k} shards, got {len(shards)}")
        if _native is not None and _native.available():
            out = _native.rs_reconstruct(shards, self.k, self.n)
            if out is not None:
                return out
        idxs = sorted(shards)[: self.k]
        size = len(shards[idxs[0]])
        sub = self.matrix[idxs]
        dec = gf_mat_inv(sub)
        have = np.frombuffer(
            b"".join(shards[i] for i in idxs), dtype=np.uint8
        ).reshape(self.k, size)
        data = gf_matmul(dec, have)
        return [bytes(r) for r in data]


# ---------------------------------------------------------------------------
# GF(2^16): the large-validator-set codec
# ---------------------------------------------------------------------------
#
# GF(256) runs out of distinct Vandermonde evaluation points at 255
# shards; validator sets beyond that erasure-code over GF(2^16)
# (poly 0x1100B, generator 2 — verified primitive; 65535 points).
# Symbols are 2 bytes, big-endian on the wire ('>u2'), so shard lengths
# must be even (`ReedSolomon16.shard_align`).  The native engine carries
# the same tables/construction (csrc/native/sha3_gf.h) — pinned bit-for-bit
# by tests/test_torch_native_dataplane.py.

_POLY16 = 0x1100B


@lru_cache(maxsize=1)
def _tables16():
    exp = np.zeros(131070, dtype=np.uint16)
    log = np.zeros(65536, dtype=np.int64)
    x = 1
    for i in range(65535):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x10000:
            x ^= _POLY16
    exp[65535:131070] = exp[:65535]
    return exp, log


def gf16_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    exp, log = _tables16()
    return int(exp[log[a] + log[b]])


def gf16_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^16) inverse of 0")
    exp, log = _tables16()
    return int(exp[65535 - log[a]])


def gf16_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^16); uint16 arrays (m,k) @ (k,n) -> (m,n)."""
    assert a.shape[1] == b.shape[0]
    exp, log = _tables16()
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint16)
    for i in range(a.shape[1]):
        col = a[:, i]
        row = b[i, :]
        nz = (col[:, None].astype(np.int64) != 0) & (row[None, :].astype(np.int64) != 0)
        prod = exp[(log[col][:, None] + log[row][None, :])]
        out ^= np.where(nz, prod, 0).astype(np.uint16)
    return out


def _row_scale16(row: np.ndarray, s: int) -> np.ndarray:
    if s == 0:
        return np.zeros_like(row)
    exp, log = _tables16()
    nz = row != 0
    out = np.zeros_like(row)
    out[nz] = exp[log[row[nz]] + log[s]]
    return out


def gf16_mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^16)."""
    n = m.shape[0]
    assert m.shape == (n, n)
    a = m.astype(np.uint16).copy()
    inv = np.eye(n, dtype=np.uint16)
    for col in range(n):
        pivot = None
        for r in range(col, n):
            if a[r, col] != 0:
                pivot = r
                break
        if pivot is None:
            raise ValueError("singular matrix over GF(2^16)")
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        pinv = gf16_inv(int(a[col, col]))
        a[col] = _row_scale16(a[col], pinv)
        inv[col] = _row_scale16(inv[col], pinv)
        for r in range(n):
            if r != col and a[r, col] != 0:
                factor = int(a[r, col])
                a[r] ^= _row_scale16(a[col], factor)
                inv[r] ^= _row_scale16(inv[col], factor)
    return inv


@lru_cache(maxsize=64)
def encoding_matrix16(k: int, n: int) -> "np.ndarray":
    """Systematic n x k encoding matrix over GF(2^16) (n <= 65535)."""
    assert 0 < k <= n <= 65535
    exp, _ = _tables16()
    i = np.arange(n, dtype=np.int64)[:, None]
    j = np.arange(k, dtype=np.int64)[None, :]
    vand = exp[(i * j) % 65535].astype(np.uint16)
    top_inv = gf16_mat_inv(vand[:k])
    return gf16_matmul(vand, top_inv)


class ReedSolomon16:
    """Systematic RS(k-of-n) over GF(2^16); shard bytes must be even."""

    shard_align = 2

    def __init__(self, k: int, n: int) -> None:
        assert 0 < k <= n <= 65535
        self.k = k
        self.n = n
        self.matrix = encoding_matrix16(k, n)

    @staticmethod
    def _sym(shard_bytes: bytes) -> np.ndarray:
        assert len(shard_bytes) % 2 == 0, "GF(2^16) shards must be even-length"
        return np.frombuffer(shard_bytes, dtype=">u2").astype(np.uint16)

    @staticmethod
    def _bytes(sym_row: np.ndarray) -> bytes:
        return sym_row.astype(">u2").tobytes()

    def encode(self, data_shards: Sequence[bytes]) -> List[bytes]:
        assert len(data_shards) == self.k
        size = len(data_shards[0])
        assert all(len(s) == size for s in data_shards)
        if _native is not None and _native.available():
            out = _native.rs16_encode(data_shards, self.n)
            if out is not None:
                return out
        data = np.stack([self._sym(s) for s in data_shards])
        parity = gf16_matmul(self.matrix[self.k:], data)
        return [bytes(s) for s in data_shards] + [self._bytes(p) for p in parity]

    def reconstruct(self, shards: Dict[int, bytes]) -> List[bytes]:
        if len(shards) < self.k:
            raise ValueError(f"need {self.k} shards, got {len(shards)}")
        if _native is not None and _native.available():
            out = _native.rs16_reconstruct(shards, self.k, self.n)
            if out is not None:
                return out
        idxs = sorted(shards)[: self.k]
        sub = self.matrix[idxs]
        dec = gf16_mat_inv(sub)
        have = np.stack([self._sym(shards[i]) for i in idxs])
        data = gf16_matmul(dec, have)
        return [self._bytes(r) for r in data]


def rs_codec(k: int, n: int):
    """The RBC erasure codec for an n-validator network: GF(256) keeps
    the reference-matching byte layout up to 255 shards; larger sets
    use GF(2^16)."""
    return ReedSolomon(k, n) if n <= 255 else ReedSolomon16(k, n)
