"""Batched BLS12-381 base-field arithmetic in PyTorch (int64 tensors).

Counterpart of ``hbbft_tpu/crypto/tpu/fq.py``.  The representation and
every algorithm are the reference's, so each intermediate can be held
against the JAX function limb for limb:

* an Fq element is ``(..., NL)`` limbs, little-endian, radix ``2^B =
  2^11``, ``NL = 36`` (396 bits), all limbs nonnegative in ``[0, 4096]``,
  in Montgomery form (``x·R mod P``, ``R = 2^396``);
* products, convolutions and carries follow the reference's bounds
  (module docstring there).  The limbs are held in ``int64`` rather than
  ``int32``; every limb and limb sum stays below ``2^30``, so nothing
  overflows and ``>>`` on nonnegative limbs is the logical shift the
  reference uses.

Invariant (every public op requires and guarantees):
    limbs in [0, 4096],  value in [0, 2^385.9).
``mont_mul`` tolerates values < 2^386 and returns < 2^382.5.

Differences from the reference that change no limb:

* ``_conv_const`` (the reference's int32 Toeplitz ``jnp.matmul``) is a
  float64 product: CUDA has no integer matmul, and float32 is not exact
  for its sums (up to ~2^28.2).  Every product is < 2^23 and every
  partial sum < 2^29 < 2^53, so float64 is exact in any summation order.
* ``lax.scan`` becomes a Python loop; ``pow_fixed``'s windows are static,
  so the table lookup is a Python index.
* ``is_zero``'s exact test carries 5-limb (55-bit) groups instead of
  single limbs: the same predicate in 8 sequential steps instead of 36.

The product has a hand-written CUDA kernel (K4, ``csrc/fq.cu`` on
``csrc/fq.cuh``).  :func:`mont_mul` routes by the tensors' device: the
kernel for CUDA tensors, :func:`mont_mul_plain` (the reference's
algorithm, limb for limb) for CPU tensors.  The kernel's output is the
same value mod P, fully reduced with strict limbs — inside every op's
input bound, but not the plain limbs — so kernel results are compared
with the plain version as canonical values.  Every op here that
multiplies (``mont_sqr``, ``is_zero``, ``pow_fixed``, ``inv``) and every
module above (fq2, fq12, curve, pairing) reaches the kernel through
:func:`mont_mul`.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as Fn

from hbbft_tpu_torch import build
from hbbft_tpu_torch.crypto.bls.fields import P

B = 11
NL = 36
MASK = (1 << B) - 1
R_BITS = B * NL  # 396
R = 1 << R_BITS
R2 = (R * R) % P
NPRIME = (-pow(P, -1, R)) % R  # P * NPRIME ≡ -1 (mod R)
FOLD_AT = B * (NL - 1)  # 385: the value-fold boundary (limb 35's weight)

I64 = torch.int64


def to_limbs_np(x: int, n: int = NL) -> np.ndarray:
    """Host: nonnegative int -> strict little-endian limbs (int64)."""
    if not 0 <= x < (1 << (B * n)):
        raise ValueError("value does not fit")
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        out[i] = x & MASK
        x >>= B
    return out


def from_limbs_int(a) -> int:
    """Host: limbs (numpy or tensor) -> Python int value."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    arr = np.asarray(a).astype(object).reshape(-1)
    acc = 0
    for i, v in enumerate(arr):
        acc += int(v) << (B * i)
    return acc


# Precomputed constants (strict limbs).
P_LIMBS = to_limbs_np(P)
NPRIME_LIMBS = to_limbs_np(NPRIME)
ONE_MONT = to_limbs_np(R % P)  # Montgomery form of 1
FOLD385 = to_limbs_np((1 << FOLD_AT) % P, n=NL - 1)
ZERO = np.zeros(NL, dtype=np.int64)
# Subtraction complement (reference module docstring): CVEC has every
# limb 2^15-1; DELTA ≡ -value(CVEC) (mod P).  a - b is computed as
# a + (CVEC - b) + DELTA, the same integer limbs as a - b + (CVEC + DELTA).
CVEC = np.full(NL, 32767, dtype=np.int64)
_CVEC_VAL = from_limbs_int(CVEC)
DELTA = to_limbs_np((-_CVEC_VAL) % P)
CVEC_DELTA = CVEC + DELTA


def to_mont_np(x: int) -> np.ndarray:
    """Host: canonical int mod P -> Montgomery-form strict limbs."""
    return to_limbs_np((x % P) * R % P)


_LIMB_WEIGHTS = 1 << np.arange(B, dtype=np.int64)


def ints_to_limbs_batch(vals) -> np.ndarray:
    """Host: list of nonnegative ints (< 2^396) -> (N, NL) int64 limbs."""
    if not vals:
        return np.zeros((0, NL), dtype=np.int64)
    limit = 1 << (B * NL)
    for v in vals:
        if not 0 <= v < limit:
            raise ValueError("value does not fit")
    data = np.frombuffer(
        b"".join(v.to_bytes(50, "little") for v in vals), dtype=np.uint8
    ).reshape(len(vals), 50)
    bits = np.unpackbits(data, axis=1, bitorder="little")[:, : B * NL]
    return (bits.reshape(len(vals), NL, B).astype(np.int64) * _LIMB_WEIGHTS).sum(
        axis=2, dtype=np.int64
    )


def to_mont_batch(vals) -> np.ndarray:
    """Host: canonical ints mod P -> (N, NL) Montgomery limbs."""
    return ints_to_limbs_batch([(v % P) * R % P for v in vals])


def from_mont_int(a) -> int:
    """Host: Montgomery limbs -> canonical int mod P."""
    return (from_limbs_int(a) * pow(R, -1, P)) % P


def _conv_mat(b_limbs: np.ndarray) -> np.ndarray:
    """(NL, 2*NL-1) Toeplitz matrix M[i, i:i+NL] = b for a constant operand."""
    M = np.zeros((NL, 2 * NL - 1), dtype=np.float64)
    for i in range(NL):
        M[i, i : i + NL] = b_limbs
    return M


_HOST_CONSTS = {
    "one": ONE_MONT,
    "zero": ZERO,
    "p": P_LIMBS,
    "p2": to_limbs_np(2 * P),
    "fold": FOLD385,
    "cvec_delta": CVEC_DELTA,
    "nprime_mat": _conv_mat(NPRIME_LIMBS),
    "p_mat": _conv_mat(P_LIMBS),
    "fold_w": np.array([1, 1 << B, 1 << (2 * B)], dtype=np.int64),
}


@lru_cache(maxsize=None)
def const(name: str, device: torch.device) -> torch.Tensor:
    """A named constant of this module as a tensor on ``device`` (cached)."""
    return torch.as_tensor(_HOST_CONSTS[name], device=device)


def register_const(name: str, arr: np.ndarray) -> None:
    """Let a sibling module (fq2, curve, pairing) cache its own constants."""
    _HOST_CONSTS[name] = arr


def _carry(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """Redistribute nonneg limbs down to [0, 4096]; value preserved.

    Pads rounds+1 limbs so the top limb never receives a carry (carries
    travel one limb per round).  Same limbs as the reference's
    ``lo + pad(c[..., :-1])``, computed in place on the fresh padded copy.
    """
    x = Fn.pad(x, (0, rounds + 1))
    for _ in range(rounds):
        c = x >> B
        x &= MASK
        x[..., 1:] += c[..., :-1]
    return x


def _fold(x: torch.Tensor, stages: int) -> torch.Tensor:
    """Fold value bits above 2^385 back in via 2^385 mod P, ``stages``
    times, then truncate to NL limbs (reference ``_fold``)."""
    fold = const("fold", x.device)
    w = const("fold_w", x.device)
    for _ in range(stages):
        top = min(x.shape[-1], NL + 2)
        e = (x[..., NL - 1 : top] * w[: top - NL + 1]).sum(-1)
        folded = x[..., : NL - 1] + e[..., None] * fold
        x = _carry(folded, rounds=2)
    return x[..., :NL]


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb convolution (..., NL) x (..., NL) -> (..., 2*NL-1) by the
    reference's skew-reshape: padding each outer row to width 2*NL and
    re-reading the flat array with stride 2*NL-1 shifts row i right by i,
    so one axis sum yields the anti-diagonal sums."""
    outer = a[..., :, None] * b[..., None, :]
    batch = outer.shape[:-2]
    padded = Fn.pad(outer, (0, NL))
    flat = padded.reshape(*batch, NL * 2 * NL)
    skewed = flat[..., : NL * (2 * NL - 1)].reshape(*batch, NL, 2 * NL - 1)
    return skewed.sum(-2)


def _conv_const(a: torch.Tensor, name: str) -> torch.Tensor:
    """Limb convolution with a constant operand: a float64 Toeplitz
    product, exact because every partial sum is < 2^29 (module notes)."""
    mat = const(name, a.device)
    return (a.to(torch.float64) @ mat).to(I64)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a·b·R^-1 (mod P), batched (broadcasting): the
    plain version, the reference's algorithm limb for limb.

    SOS with redundant nonneg limbs: T = a·b; m ≡ T·N' (mod R);
    t = (T + m·P)/R.  The carried low part's value is exactly corr·R
    with corr in {0, 1, 2}, read off limb 35.  Inputs: value < 2^386.
    Output: value < 2^382.5.
    """
    t = _carry(_conv(a, b), rounds=3)
    m = _carry(_conv_const(t[..., :NL], "nprime_mat"), rounds=3)[..., :NL]
    mp = _conv_const(m, "p_mat")
    t[..., : mp.shape[-1]] += mp
    full = _carry(t, rounds=3)
    # value(lo) = corr·R exactly; limb 35 sits in [2048·corr - 3, 2048·corr].
    corr = (full[..., NL - 1] + 3) >> B
    hi = full[..., NL : 2 * NL]
    hi[..., 0] += corr
    return _carry(hi, rounds=1)[..., :NL]


KERNEL = "fq_mont_mul"


@lru_cache(maxsize=1)
def _launcher():
    """The kernel's C entry point, built and loaded at first use."""
    fn = build.load("fq").hbbft_fq_mont_mul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mont_mul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on (..., NL) int64 limb tensors on one card
    (broadcasting): a·b·R^-1 (mod P), fully reduced, strict limbs.
    Launches on the current stream; does not synchronise."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("mont_mul_kernel needs both operands on one CUDA device")
    if a.dtype != I64 or b.dtype != I64:
        raise ValueError(f"mont_mul_kernel needs int64 limbs, got {a.dtype}, {b.dtype}")
    a, b = torch.broadcast_tensors(a, b)
    if a.dim() == 0 or a.shape[-1] != NL:
        raise ValueError(f"mont_mul_kernel needs (..., {NL}) limbs, got {tuple(a.shape)}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(a.shape, dtype=I64, device=a.device)
    n = out.numel() // NL
    if n == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, stream)
    build.LAUNCHES[KERNEL] += 1
    build.check(rc, "hbbft_fq_mont_mul")
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a·b·R^-1 (mod P), batched (broadcasting): the
    kernel for CUDA tensors, the plain version for CPU tensors — no other
    fallback."""
    if a.device.type == "cuda" or b.device.type == "cuda":
        return mont_mul_kernel(a, b)
    return mont_mul_plain(a, b)


def mont_sqr(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fold(_carry(a + b, rounds=2), stages=1)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (mod P) via the borrow-free complement.  Accepts limbs up to
    2^15-1 (raw coefficient sums), value < 2^389."""
    d = a - b + const("cvec_delta", a.device)
    return _fold(_carry(d, rounds=2), stages=3)


def neg(a: torch.Tensor) -> torch.Tensor:
    d = const("cvec_delta", a.device) - a
    return _fold(_carry(d, rounds=2), stages=3)


def small_mul(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small positive constant (k <= 16)."""
    if not 0 < k <= 16:
        raise ValueError(f"small_mul factor {k} outside (0, 16]")
    return _fold(_carry(a * k, rounds=2), stages=1)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Re-settle into the invariant range; value unchanged mod P."""
    return _fold(_carry(a, rounds=2), stages=1)


_GROUP = 5  # limbs per group in the exact zero test: 55-bit groups


def _is_exact_zero(x: torch.Tensor) -> torch.Tensor:
    """Exact value == 0 test for limbs that may be signed (|limb| < 2^13).

    Limbs are summed into 55-bit groups (|group| < 2^60), then one
    sequential floor-carry pass over the 8 groups: the value is zero iff
    every group residue and the final carry are zero.
    """
    n = x.shape[-1]
    pad = (-n) % _GROUP
    g = Fn.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, _GROUP)
    w = torch.tensor(
        [1 << (B * i) for i in range(_GROUP)], dtype=I64, device=x.device
    )
    groups = (g * w).sum(-1)
    gbits = B * _GROUP
    gmask = (1 << gbits) - 1
    c = torch.zeros(x.shape[:-1], dtype=I64, device=x.device)
    ok = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    for i in range(groups.shape[-1]):
        s = groups[..., i] + c
        c = s >> gbits
        ok = ok & ((s & gmask) == 0)
    return ok & (c == 0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Value ≡ 0 (mod P)?  One Montgomery shrink maps a (value < 2^386)
    into [0, 2.1P); that is ≡ 0 iff it equals 0, P or 2P."""
    v = mont_mul(a, const("one", a.device))
    cands = torch.stack(
        [v, v - const("p", a.device), v - const("p2", a.device)]
    )
    return _is_exact_zero(cands).any(0)


def pow_fixed(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e (Montgomery), e a fixed Python int: 4-bit windows MSB-first,
    14 table muls + per window 4 squarings and one table mul."""
    one = const("one", a.device).expand(a.shape)
    if e == 0:
        return one.clone()
    W = 4
    nwin = (e.bit_length() + W - 1) // W
    wins = [(e >> (W * (nwin - 1 - i))) & 15 for i in range(nwin)]
    table = [one, a]
    for _ in range(2, 16):
        table.append(mont_mul(table[-1], a))
    acc = table[wins[0]]
    for w in wins[1:]:
        acc = mont_sqr(mont_sqr(mont_sqr(mont_sqr(acc))))
        if w:
            acc = mont_mul(acc, table[w])
    return acc


def inv(a: torch.Tensor) -> torch.Tensor:
    """Field inverse by Fermat: a^(P-2).  ~490 muls — use sparingly."""
    return pow_fixed(a, P - 2)
