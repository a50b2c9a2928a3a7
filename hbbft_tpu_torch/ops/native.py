"""ctypes bindings for the native (C++) host data plane.

Reference behavior: the reference's data-plane hot loops are native
(Rust ``tiny-keccak``/``reed-solomon-erasure``; SURVEY.md §2 #4 + the
native-components note).  Here the equivalents live in
``csrc/native/hbbft_native.cpp``; this module builds it with
:func:`hbbft_tpu_torch.build.build_host` at first use and exposes thin
typed wrappers.

Loading is lazy and never raises: if no compiler/library is available,
or ``HBBFT_TORCH_NO_NATIVE`` is set, ``available()`` is False and
callers use the pure-Python/numpy paths.  These are host paths only;
correctness is pinned by tests comparing both paths bit-for-bit
(tests/test_torch_native_dataplane.py).

Copy of ``hbbft_tpu/ops/native.py``; the reference's ``build_and_load``
is ``build.build_host`` here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, List, Optional, Sequence

import numpy as np


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("HBBFT_TORCH_NO_NATIVE"):
        return None
    from hbbft_tpu_torch import build

    try:
        lib = ctypes.CDLL(str(build.build_host("native")))
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.hb_sha3_256.argtypes = [u8p, ctypes.c_uint64, u8p]
    lib.hb_sha3_256_batch.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64, u8p]
    lib.hb_merkle_levels.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64, u8p]
    lib.hb_rs_encode.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64,
                                 ctypes.c_uint64, u8p]
    lib.hb_rs_encode.restype = ctypes.c_int
    lib.hb_rs_reconstruct.argtypes = [u8p, u64p, ctypes.c_uint64,
                                      ctypes.c_uint64, ctypes.c_uint64, u8p]
    lib.hb_rs_reconstruct.restype = ctypes.c_int
    lib.hb_rs16_encode.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64,
                                   ctypes.c_uint64, u8p]
    lib.hb_rs16_encode.restype = ctypes.c_int
    lib.hb_rs16_reconstruct.argtypes = [u8p, u64p, ctypes.c_uint64,
                                        ctypes.c_uint64, ctypes.c_uint64, u8p]
    lib.hb_rs16_reconstruct.restype = ctypes.c_int
    return lib


_LIB: Optional[ctypes.CDLL] = None
_LOADED = False


def _get() -> Optional[ctypes.CDLL]:
    """Lazy memoized loader: the g++ build (first run only) must not be
    an import-time side effect of merely importing gf256/merkle."""
    global _LIB, _LOADED
    if not _LOADED:
        _LIB = _load()
        _LOADED = True
    return _LIB


def available() -> bool:
    return _get() is not None


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def sha3_256(data: bytes) -> bytes:
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(0, np.uint8)
    out = np.zeros(32, dtype=np.uint8)
    _get().hb_sha3_256(_u8(np.ascontiguousarray(buf)), len(data), _u8(out))
    return out.tobytes()


def sha3_256_batch(msgs: np.ndarray) -> np.ndarray:
    """(batch, m) uint8 -> (batch, 32) uint8."""
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    n, m = msgs.shape
    out = np.zeros((n, 32), dtype=np.uint8)
    _get().hb_sha3_256_batch(_u8(msgs), n, m, _u8(out))
    return out


def merkle_levels(leaves: Sequence[bytes]) -> List[List[bytes]]:
    """Equal-length leaves -> all tree levels, bottom-up (padded)."""
    n = len(leaves)
    leaf_len = len(leaves[0])
    assert all(len(v) == leaf_len for v in leaves)
    size = 1
    while size < n:
        size <<= 1
    flat = np.frombuffer(b"".join(leaves), dtype=np.uint8) if leaf_len else \
        np.zeros(0, np.uint8)
    out = np.zeros((2 * size - 1, 32), dtype=np.uint8)
    _get().hb_merkle_levels(_u8(np.ascontiguousarray(flat)), n, leaf_len, _u8(out))
    levels: List[List[bytes]] = []
    off = 0
    width = size
    while width >= 1:
        levels.append([out[off + i].tobytes() for i in range(width)])
        off += width
        if width == 1:
            break
        width >>= 1
    return levels


def rs_encode(data_shards: Sequence[bytes], n: int) -> Optional[List[bytes]]:
    """k data shards -> n total shards (data + parity); None on error."""
    k = len(data_shards)
    size = len(data_shards[0])
    data = np.frombuffer(b"".join(data_shards), dtype=np.uint8).reshape(k, size)
    data = np.ascontiguousarray(data)
    parity = np.zeros((n - k, size), dtype=np.uint8)
    rc = _get().hb_rs_encode(_u8(data), k, n, size, _u8(parity))
    if rc != 0:
        return None
    return [bytes(s) for s in data] + [bytes(p) for p in parity]


def rs_reconstruct(shards: Dict[int, bytes], k: int, n: int) -> Optional[List[bytes]]:
    """Any k of n shards (by index) -> the k data shards; None on error."""
    idxs = sorted(shards)[:k]
    size = len(shards[idxs[0]])
    have = np.frombuffer(
        b"".join(shards[i] for i in idxs), dtype=np.uint8
    ).reshape(k, size)
    have = np.ascontiguousarray(have)
    idx_arr = np.asarray(idxs, dtype=np.uint64)
    out = np.zeros((k, size), dtype=np.uint8)
    rc = _get().hb_rs_reconstruct(
        _u8(have),
        idx_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        k, n, size, _u8(out),
    )
    if rc != 0:
        return None
    return [bytes(r) for r in out]


def rs16_encode(data_shards: Sequence[bytes], n: int) -> Optional[List[bytes]]:
    """GF(2^16) variant of :func:`rs_encode` (even shard lengths)."""
    k = len(data_shards)
    size = len(data_shards[0])
    data = np.frombuffer(b"".join(data_shards), dtype=np.uint8).reshape(k, size)
    data = np.ascontiguousarray(data)
    parity = np.zeros((n - k, size), dtype=np.uint8)
    rc = _get().hb_rs16_encode(_u8(data), k, n, size, _u8(parity))
    if rc != 0:
        return None
    return [bytes(s) for s in data] + [bytes(p) for p in parity]


def rs16_reconstruct(
    shards: Dict[int, bytes], k: int, n: int
) -> Optional[List[bytes]]:
    """GF(2^16) variant of :func:`rs_reconstruct`."""
    idxs = sorted(shards)[:k]
    size = len(shards[idxs[0]])
    have = np.frombuffer(
        b"".join(shards[i] for i in idxs), dtype=np.uint8
    ).reshape(k, size)
    have = np.ascontiguousarray(have)
    idx_arr = np.asarray(idxs, dtype=np.uint64)
    out = np.zeros((k, size), dtype=np.uint8)
    rc = _get().hb_rs16_reconstruct(
        _u8(have),
        idx_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        k, n, size, _u8(out),
    )
    if rc != 0:
        return None
    return [bytes(r) for r in out]
