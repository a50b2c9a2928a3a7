"""Batched Keccak-f[1600] / SHA3-256 for the data plane.

Counterpart of ``hbbft_tpu/ops/jaxops/keccak.py`` and
``hbbft_tpu/ops/jaxops/keccak_pallas.py``.  Reference behaviour:
``tiny-keccak`` SHA3-256 as used by upstream ``src/broadcast/merkle.rs``,
bit-identical to :func:`hashlib.sha3_256`.

* :func:`keccak_f` and :func:`sha3_256_padded` are the plain PyTorch
  versions: 64-bit lanes in ``int64`` tensors, one batched op per step of
  a round.  The CPU tests use them and the chip check compares the kernel
  against them.
* :func:`sha3_256_kernel` launches the hand-written CUDA kernel
  (``csrc/keccak.cu``): one thread per message, the whole sponge in one
  launch.  It counts its launches in ``build.LAUNCHES["keccak_sha3_256"]``.
* :func:`merkle_tree_kernel` launches the Merkle tree kernel of the same
  source: every level of one tree per value, leaves hashed straight from
  the shards, in one launch (``build.LAUNCHES["keccak_merkle_tree"]``).
  Its plain version is ``dataplane.tree_levels_plain``.
* :func:`sha3_256_batch` pads and routes by the tensor's device: the
  kernel for a CUDA tensor, the plain version for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from hbbft_tpu_torch import build
from hbbft_tpu_torch.device import DeviceLike, resolve

RATE = 136  # SHA3-256 rate in bytes
RATE_WORDS = RATE // 8
KERNEL = "keccak_sha3_256"
TREE_KERNEL = "keccak_merkle_tree"

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets, indexed [x][y] with lane index x + 5y.
_RHO = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _signed(v: int) -> int:
    """A 64-bit pattern as the int64 holding the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _tables() -> dict:
    """Index/shift tables of the vectorised round (lane index x + 5y)."""
    rot = np.zeros(25, dtype=np.int64)
    src = np.zeros(25, dtype=np.int64)  # b[dst] = rotl(a[src[dst]], rot[dst])
    for x in range(5):
        for y in range(5):
            dst = y + 5 * ((2 * x + 3 * y) % 5)
            src[dst] = x + 5 * y
            rot[dst] = _RHO[x][y]
    lane = np.arange(25)
    xs, ys = lane % 5, lane // 5
    return {
        "rot": rot,
        "rot_mask": np.array([(1 << int(r)) - 1 for r in rot], dtype=np.int64),
        "rot_right": (64 - rot) % 64,
        "pi_src": src,
        "chi1": (xs + 1) % 5 + 5 * ys,
        "chi2": (xs + 2) % 5 + 5 * ys,
        "theta_prev": np.array([(x + 4) % 5 for x in range(5)]),
        "theta_next": np.array([(x + 1) % 5 for x in range(5)]),
        "rc": np.array([_signed(v) for v in _ROUND_CONSTANTS], dtype=np.int64),
    }


_TABLES = _tables()


@lru_cache(maxsize=None)
def _t(name: str, device: torch.device) -> torch.Tensor:
    """A round table as a tensor on ``device`` (cached)."""
    return torch.as_tensor(_TABLES[name], device=device)


@lru_cache(maxsize=1)
def _launcher():
    """The sponge kernel's C entry point, built and loaded at first use."""
    fn = build.load("keccak").hbbft_sha3_256
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=1)
def _tree_launcher():
    """The tree kernel's C entry point, built and loaded at first use."""
    fn = build.load("keccak").hbbft_merkle_tree
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rotl(x: torch.Tensor, r: torch.Tensor, mask: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Rotate int64 lanes left by per-lane amounts ``r``.  ``>>`` on int64
    is arithmetic, so the wrapped-in bits are masked to ``r`` bits (and a
    rotation by 0 keeps no wrapped bits at all)."""
    return (x << r) | ((x >> right) & mask)


def _permute_lanes(a: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] over ``(..., 25)`` int64 lanes (plain PyTorch)."""
    dev = a.device
    rot, mask, right = _t("rot", dev), _t("rot_mask", dev), _t("rot_right", dev)
    pi, chi1, chi2 = _t("pi_src", dev), _t("chi1", dev), _t("chi2", dev)
    prev, nxt = _t("theta_prev", dev), _t("theta_next", dev)
    one = torch.ones((), dtype=torch.int64, device=dev)
    rc = _t("rc", dev)
    batch = a.shape[:-1]
    for rnd in range(24):
        # theta
        rows = a.reshape(*batch, 5, 5)  # [y][x]
        c = rows[..., 0, :] ^ rows[..., 1, :] ^ rows[..., 2, :] ^ rows[..., 3, :] ^ rows[..., 4, :]
        cn = c[..., nxt]
        d = c[..., prev] ^ ((cn << one) | ((cn >> 63) & one))
        a = (rows ^ d[..., None, :]).reshape(*batch, 25)
        # rho + pi
        b = _rotl(a[..., pi], rot, mask, right)
        # chi
        a = b ^ (~b[..., chi1] & b[..., chi2])
        # iota
        a[..., 0] ^= rc[rnd]
    return a


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """One permutation over ``(..., 25, 2)`` (lo, hi) 32-bit halves held in
    an integer tensor — the reference's layout at this public function."""
    s = state.to(torch.int64)
    lanes = (s[..., 0] & 0xFFFFFFFF) | (s[..., 1] << 32)
    out = _permute_lanes(lanes)
    return torch.stack([out & 0xFFFFFFFF, (out >> 32) & 0xFFFFFFFF], dim=-1)


def pad_block(msgs: np.ndarray) -> np.ndarray:
    """(batch, m) uint8 messages (m <= RATE-1) -> (batch, RATE) padded."""
    batch, m = msgs.shape
    if m > RATE - 1:
        raise ValueError("single-block SHA3 only")
    out = np.zeros((batch, RATE), dtype=np.uint8)
    out[:, :m] = msgs
    out[:, m] = 0x06
    out[:, RATE - 1] ^= 0x80
    return out


def n_blocks_for(m: int) -> int:
    """SHA3 blocks absorbed for an m-byte message (padding adds >= 1)."""
    return m // RATE + 1


def pad_multi(msgs: np.ndarray) -> np.ndarray:
    """(batch, m) uint8 -> (batch, n_blocks*RATE) SHA3-padded."""
    batch, m = msgs.shape
    total = n_blocks_for(m) * RATE
    out = np.zeros((batch, total), dtype=np.uint8)
    out[:, :m] = msgs
    out[:, m] = 0x06
    out[:, total - 1] ^= 0x80
    return out


def pad_tensor(msgs: torch.Tensor) -> torch.Tensor:
    """:func:`pad_multi` on a (batch, m) uint8 tensor, on its device."""
    batch, m = msgs.shape
    total = n_blocks_for(m) * RATE
    out = torch.zeros((batch, total), dtype=torch.uint8, device=msgs.device)
    out[:, :m] = msgs
    out[:, m] = 0x06
    out[:, total - 1] ^= 0x80
    return out


def block_words(block: np.ndarray) -> np.ndarray:
    """(batch, RATE) uint8 -> (batch, RATE//8, 2) uint32 (lo, hi) lanes."""
    batch = block.shape[0]
    as_u32 = block.reshape(batch, RATE // 4, 4).astype(np.uint32)
    vals = (
        as_u32[..., 0]
        | (as_u32[..., 1] << 8)
        | (as_u32[..., 2] << 16)
        | (as_u32[..., 3] << 24)
    )
    return np.stack([vals[:, 0::2], vals[:, 1::2]], axis=-1)


def digest_from_state(state: np.ndarray) -> np.ndarray:
    """(batch, 25, 2) uint32 permuted states -> (batch, 32) digests."""
    batch = state.shape[0]
    dig = np.asarray(state)[:, :4, :].astype(np.uint64)
    flat = np.zeros((batch, 32), dtype=np.uint8)
    for i in range(4):
        for half in range(2):
            v = dig[:, i, half]
            for b in range(4):
                flat[:, 8 * i + 4 * half + b] = (v >> np.uint64(8 * b)) & 0xFF
    return flat


def _check_padded(padded: torch.Tensor) -> Tuple[int, int]:
    if padded.dtype != torch.uint8 or padded.dim() != 2:
        raise ValueError("padded messages must be a (batch, n*136) uint8 tensor")
    batch, total = padded.shape
    if total == 0 or total % RATE:
        raise ValueError(f"padded length {total} is not a positive multiple of {RATE}")
    return batch, total // RATE


def sha3_256_padded(padded: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sponge: (batch, nb*RATE) padded -> (batch, 32) uint8."""
    batch, nb = _check_padded(padded)
    words = padded.contiguous().view(torch.int64).reshape(batch, nb, RATE_WORDS)
    state = torch.zeros((batch, 25), dtype=torch.int64, device=padded.device)
    for blk in range(nb):
        state[:, :RATE_WORDS] ^= words[:, blk]
        state = _permute_lanes(state)
    return state[:, :4].contiguous().view(torch.uint8)


def sha3_256_kernel(padded: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on a (batch, nb*RATE) uint8 CUDA tensor -> (batch,
    32) digests.  Launches on the current stream; does not synchronise."""
    batch, nb = _check_padded(padded)
    if padded.device.type != "cuda":
        raise ValueError("sha3_256_kernel needs a CUDA tensor")
    if not padded.is_contiguous():
        raise ValueError("padded messages must be contiguous")
    out = torch.empty((batch, 32), dtype=torch.uint8, device=padded.device)
    if batch == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(padded.data_ptr(), out.data_ptr(), batch, nb, stream)
    build.LAUNCHES[KERNEL] += 1
    build.check(rc, "hbbft_sha3_256")
    return out


def tree_size(n: int) -> int:
    """Leaf slots of a Merkle tree over n leaves: the next power of two."""
    return 1 << (n - 1).bit_length()


def merkle_tree_kernel(shards: torch.Tensor) -> torch.Tensor:
    """The tree kernel on a (V, n, s) uint8 CUDA tensor of shards -> (V,
    2 size - 1, 32) digests: every level of each value's tree, bottom up
    (leaves SHA3-256(0x00 || shard) padded with H(0x00) to size = the next
    power of two, then SHA3-256(0x01 || left || right)).  Launches on the
    current stream; does not synchronise."""
    if shards.dtype != torch.uint8 or shards.dim() != 3:
        raise ValueError("shards must be a (V, n, s) uint8 tensor")
    if shards.device.type != "cuda":
        raise ValueError("merkle_tree_kernel needs a CUDA tensor")
    if not shards.is_contiguous():
        raise ValueError("shards must be contiguous")
    values, n, s = shards.shape
    if n == 0:
        raise ValueError("a Merkle tree needs at least one leaf")
    if max(values, n, s) >= 2**31:
        raise ValueError("shard tensor dimensions must fit 32 bits")
    out = torch.empty((values, 2 * tree_size(n) - 1, 32), dtype=torch.uint8,
                      device=shards.device)
    if values == 0:
        return out
    fn = _tree_launcher()
    with torch.cuda.device(shards.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(shards.data_ptr(), out.data_ptr(), values, n, s, stream)
    build.LAUNCHES[TREE_KERNEL] += 1
    build.check(rc, "hbbft_merkle_tree")
    return out


def _as_tensor(msgs, device: DeviceLike) -> torch.Tensor:
    if isinstance(msgs, torch.Tensor):
        return msgs if device is None else msgs.to(resolve(device))
    return torch.as_tensor(np.ascontiguousarray(msgs, dtype=np.uint8), device=resolve(device))


def sha3_256_batch(msgs, device: DeviceLike = None) -> torch.Tensor:
    """Batched SHA3-256 over equal-length messages: (batch, m) uint8 ->
    (batch, 32) uint8 tensor on the messages' device.

    A numpy input goes to ``device`` (``cuda`` unless told otherwise); a
    tensor stays where it is.  A CUDA tensor goes through the kernel, a
    CPU tensor through the plain version — no other fallback.
    """
    m = _as_tensor(msgs, device)
    padded = pad_tensor(m)
    if padded.device.type == "cuda":
        return sha3_256_kernel(padded)
    return sha3_256_padded(padded)


def merkle_level(prefix: int, pairs, device: DeviceLike = None) -> torch.Tensor:
    """Hash one Merkle level: (batch, 64) sibling pairs -> (batch, 32).

    ``prefix`` is the domain-separation byte (0x01 for branches, matching
    :func:`hbbft_tpu_torch.ops.merkle._h_branch`).
    """
    p = _as_tensor(pairs, device)
    head = torch.full((p.shape[0], 1), prefix, dtype=torch.uint8, device=p.device)
    return sha3_256_batch(torch.cat([head, p], dim=1))
