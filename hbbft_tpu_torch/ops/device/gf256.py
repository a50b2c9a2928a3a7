"""Reed-Solomon over GF(256) as a GF(2) bit-matrix product in PyTorch.

Counterpart of ``hbbft_tpu/ops/jaxops/gf256.py``: multiplication by a
FIXED GF(256) element is GF(2)-linear on the 8 bits of a byte, so the
systematic encode (parity = M ⊗ data over GF(256)) becomes

    parity_bits = (ENC_BITS @ data_bits) mod 2

— one matrix product over {0,1} matrices, batched over shard columns.
Reconstruction inverts the surviving rows' submatrix on the host (k x k
bytes) and applies the same product to the bulk data.

CUDA has no integer ``torch.matmul``, so the product runs in float32 with
TF32 off: every entry is 0 or 1 and every sum is at most 8k <= 2040 <
2^24, so float32 is exact.  (bf16 is not: its sums round above 256.)
This product is a plain matrix product outside any kernel, as the
reference leaves its own to XLA outside any Pallas kernel (K5).
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from hbbft_tpu_torch.device import DeviceLike, resolve
from hbbft_tpu_torch.ops import gf256 as host


def _mul_matrix_gf2(c: int) -> np.ndarray:
    """The 8x8 GF(2) matrix of y -> c·y in GF(256).

    Column j is the bit pattern of c·x^j (x = 0x02 basis powers).
    """
    m = np.zeros((8, 8), dtype=np.int32)
    for j in range(8):
        prod = host.gf_mul(c, 1 << j)
        for i in range(8):
            m[i, j] = (prod >> i) & 1
    return m


def _expand_bits(mat: np.ndarray) -> np.ndarray:
    """GF(256) matrix (r, c) -> GF(2) bit matrix (8r, 8c)."""
    r, c = mat.shape
    out = np.zeros((8 * r, 8 * c), dtype=np.int32)
    for i in range(r):
        for j in range(c):
            if mat[i, j]:
                out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = _mul_matrix_gf2(
                    int(mat[i, j])
                )
    return out


@lru_cache(maxsize=64)
def _enc_bits(k: int, n: int) -> np.ndarray:
    """Bit-expanded parity rows of the systematic encoding matrix."""
    return _expand_bits(host.encoding_matrix(k, n)[k:])


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """(r, s) uint8 -> (8r, s) float32 bits (LSB-first per byte)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data[:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(data.shape[0] * 8, data.shape[1]).to(torch.float32)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(8r, s) {0,1} -> (r, s) uint8 (LSB-first per byte)."""
    arr = bits.to(torch.int32).reshape(-1, 8, bits.shape[-1])
    weights = 1 << torch.arange(8, device=bits.device, dtype=torch.int32)
    return (arr * weights[None, :, None]).sum(dim=1).to(torch.uint8)


@contextmanager
def _exact_fp32() -> Iterator[None]:
    """Run float32 products in full float32: TF32 off for the duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gf2_matmul(mat_bits: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """(mat_bits @ bits(data)) mod 2 packed back to bytes: the GF(256)
    product of the bit-expanded matrix with (rows, cols) uint8 data."""
    mat = torch.as_tensor(mat_bits, dtype=torch.float32, device=data.device)
    with _exact_fp32():
        prod = mat @ bytes_to_bits(data)
    return bits_to_bytes(prod.to(torch.int32) & 1)


class ReedSolomonTorch:
    """Systematic RS(k-of-n) with encode/reconstruct on ``device``."""

    def __init__(self, k: int, n: int, device: DeviceLike = None) -> None:
        if not 0 < k <= n <= 255:
            raise ValueError(f"need 0 < k <= n <= 255, got k={k}, n={n}")
        self.k = k
        self.n = n
        self.device = resolve(device)
        self._host = host.ReedSolomon(k, n)

    def encode(self, data_shards: Sequence[bytes]) -> List[bytes]:
        if len(data_shards) != self.k:
            raise ValueError(f"need {self.k} data shards, got {len(data_shards)}")
        size = len(data_shards[0])
        data = np.frombuffer(b"".join(data_shards), dtype=np.uint8).reshape(
            self.k, size
        )
        parity = gf2_matmul(
            _enc_bits(self.k, self.n), torch.as_tensor(data.copy(), device=self.device)
        )
        return [bytes(r) for r in data] + [bytes(r) for r in parity.cpu().numpy()]

    def reconstruct(self, shards: Dict[int, bytes]) -> List[bytes]:
        if len(shards) < self.k:
            raise ValueError(f"need {self.k} shards, got {len(shards)}")
        idxs = sorted(shards)[: self.k]
        sub = self._host.matrix[idxs]
        dec = host.gf_mat_inv(sub)  # host: tiny k x k inverse
        size = len(shards[idxs[0]])
        have = np.frombuffer(
            b"".join(shards[i] for i in idxs), dtype=np.uint8
        ).reshape(self.k, size)
        data = gf2_matmul(
            _expand_bits(dec), torch.as_tensor(have.copy(), device=self.device)
        )
        return [bytes(r) for r in data.cpu().numpy()]
