"""The flush's pair stage on the card: the K3 kernels (``csrc/pair.cu``).

Counterpart of the reference's ``hbbft_tpu/crypto/tpu/backend.py``
``_pair_kernel`` and of the port's plain :func:`backend.pair_stage_plain`, with
the same output: one verdict "the product of the subset's pairings is 1"
per subset.  Two launches:

* ``pair_miller``, one warp per pair: affine conversion, the Miller
  loop over the Fq6 tower, and the factor 1 where either side is the
  identity — the values of the plain :func:`pairing.miller_values`,
  coefficient by coefficient, as (n, 6, 2, 36) limbs;
* ``pair_final``, one warp per subset: the product of the subset's
  Miller values in pair order, the final exponentiation over the Fq6
  tower and ``is_one``.

The host layout, made by :func:`subset_members`: each subset's pair
indices as a CSR list (int32 offsets and members, pair order kept inside
a subset), and the Frobenius constants for k = 1, 2 as one (2, 6, 2, 36)
buffer of the limbs the plain version registers
(:func:`pairing._gamma_name`).

The kernel wrappers check device, dtype, shape and contiguity, launch on
the current stream without a host sync and count each launch in
``build.LAUNCHES[name]``.  They run only on CUDA tensors; there is no
fallback (the plain ``pair_stage_plain`` is the CPU path).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch import build
from hbbft_tpu_torch.crypto.device import curve as dcurve
from hbbft_tpu_torch.crypto.device import fq
from hbbft_tpu_torch.crypto.device import pairing as dpairing
from hbbft_tpu_torch.crypto.device.scan import _check, _check_points

MILLER = "pair_miller"
FINAL = "pair_final"
KERNELS = (MILLER, FINAL)

GAMMA_KS = (1, 2)  # the Frobenius powers pair_final takes constants for
FQ12_SHAPE = (6, 2, fq.NL)

I32 = torch.int32
I64 = torch.int64


def subset_members(pair_sub: Sequence[int], n_sub: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host: the pairs of each subset as a CSR list — offsets (n_sub + 1,)
    and members (n_pairs,), both int32, subset by subset and in pair order
    inside a subset (the plain stage's product order)."""
    sub = np.asarray(pair_sub, dtype=np.int64)
    if sub.size and (sub.min() < 0 or sub.max() >= n_sub):
        raise ValueError(f"pair subsets must lie in [0, {n_sub})")
    members = np.argsort(sub, kind="stable").astype(np.int32)
    counts = np.bincount(sub, minlength=n_sub)
    offsets = np.zeros(n_sub + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    return offsets, members


@lru_cache(maxsize=None)
def gamma_limbs(device: torch.device) -> torch.Tensor:
    """The Frobenius constants of :data:`GAMMA_KS`, (2, 6, 2, 36) int64."""
    return torch.stack(
        [fq.const(dpairing._gamma_name(k), device) for k in GAMMA_KS]).contiguous()


@lru_cache(maxsize=None)
def _launcher(name: str):
    """One of the kernels' C entry points, built and loaded at first use."""
    fn = getattr(build.load("pair"), f"hbbft_{name}")
    ptr = ctypes.c_void_p
    if name == MILLER:
        fn.argtypes = [ptr] * 8 + [ctypes.c_int, ptr, ptr]
    else:
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, *args) -> None:
    fn = _launcher(name)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*ptrs, stream)
    build.LAUNCHES[name] += 1
    build.check(rc, f"hbbft_{name}")


def check_pairs(lhs: dcurve.Point, rhs: dcurve.Point) -> None:
    """Raise unless (lhs, rhs) are n >= 1 G1 and G2 port points on one
    CUDA device, int64, contiguous."""
    dev = lhs[0].device
    if dev.type != "cuda":
        raise ValueError("the pair kernels need CUDA tensors")
    n = lhs[3].numel()
    if n < 1:
        raise ValueError("the pair stage needs at least one pair")
    _check_points(lhs, "lhs", n, (fq.NL,), dev)
    _check_points(rhs, "rhs", n, (2, fq.NL), dev)


def miller_values_kernel(lhs: dcurve.Point, rhs: dcurve.Point) -> torch.Tensor:
    """``pair_miller``: every pair's Miller value (1 for an identity side)
    as (n, 6, 2, 36) int64 limbs, fully reduced.  No sync."""
    check_pairs(lhs, rhs)
    dev, n = lhs[0].device, lhs[3].shape[0]
    out = torch.empty((n, *FQ12_SHAPE), dtype=I64, device=dev)
    with torch.cuda.device(dev):
        _launch(MILLER, *lhs, *rhs, n, out)
    return out


def final_kernel(fs: torch.Tensor, offsets: torch.Tensor, members: torch.Tensor,
                 n_sub: int) -> torch.Tensor:
    """``pair_final``: (n_sub,) bool verdicts from the Miller values ``fs``
    and the CSR list (int32 tensors on the same card).  No sync."""
    dev = fs.device
    if dev.type != "cuda":
        raise ValueError("the pair kernels need CUDA tensors")
    n = fs.shape[0]
    if n_sub < 1:
        raise ValueError("the pair stage needs at least one subset")
    _check(fs, "fs", I64, (n, *FQ12_SHAPE), dev)
    _check(offsets, "offsets", I32, (n_sub + 1,), dev)
    _check(members, "members", I32, (n,), dev)
    ok = torch.empty((n_sub,), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        _launch(FINAL, fs, offsets, members, n_sub, gamma_limbs(dev), ok)
    return ok.bool()


def pair_stage_kernel(lhs: dcurve.Point, rhs: dcurve.Point, pair_sub: Sequence[int],
                      n_sub: int) -> torch.Tensor:
    """The pair stage on the card: (n_sub,) bool, subset s True iff the
    product of e(lhs_i, rhs_i) over the pairs i with ``pair_sub[i] == s``
    is 1.  Two launches on the current stream; no sync."""
    check_pairs(lhs, rhs)
    if len(pair_sub) != lhs[3].shape[0]:
        raise ValueError(f"{len(pair_sub)} pair subsets for {lhs[3].shape[0]} pairs")
    # The CSR list goes up from pinned memory without a host sync (a
    # pageable copy would wait for the kernels already queued).
    dev = lhs[0].device
    offsets, members = (torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                        for a in subset_members(pair_sub, n_sub))
    return final_kernel(miller_values_kernel(lhs, rhs), offsets, members, n_sub)
