"""Batched Fq2 = Fq[u]/(u^2+1) arithmetic on torch limbs.

Counterpart of ``hbbft_tpu/crypto/tpu/fq2.py``.  Elements are
``(..., 2, NL)`` int64 limb tensors (c0 + c1·u), components in Montgomery
form.  Componentwise ops lift directly from :mod:`fq`; mul/sqr use
Karatsuba (3 base muls).  The independent base-field products of one
mul/sqr are stacked into a single :func:`fq.mont_mul` call, which gives
the same limbs as separate calls (every op is elementwise over the
batch) with a third of the launches.
"""

from __future__ import annotations

import numpy as np
import torch

from hbbft_tpu_torch.crypto.device import fq

NL = fq.NL

ZERO = np.zeros((2, NL), dtype=np.int64)
ONE = np.stack([fq.ONE_MONT, fq.ZERO])
fq.register_const("fq2_one", ONE)
fq.register_const("fq2_zero", ZERO)


def to_mont_np(c: tuple) -> np.ndarray:
    """Host: oracle (c0, c1) int tuple -> (2, NL) Montgomery limbs."""
    return np.stack([fq.to_mont_np(c[0]), fq.to_mont_np(c[1])])


def from_mont_int(a) -> tuple:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    arr = np.asarray(a)
    return (fq.from_mont_int(arr[..., 0, :]), fq.from_mont_int(arr[..., 1, :]))


add = fq.add
sub = fq.sub
neg = fq.neg
small_mul = fq.small_mul
normalize = fq.normalize


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    s = fq.add(torch.stack([a0, b0]), torch.stack([a1, b1]))  # a0+a1, b0+b1
    t = fq.mont_mul(torch.stack([a0, a1, s[0]]), torch.stack([b0, b1, s[1]]))
    t0, t1, t2 = t[0], t[1], t[2]
    d = fq.sub(torch.stack([t0, t2]), torch.stack([t1, t0]))  # c0, t2 - t0
    c1 = fq.sub(d[1], t1)
    return torch.stack([d[0], c1], dim=-2)


def sqr(a: torch.Tensor) -> torch.Tensor:
    a0, a1 = a[..., 0, :], a[..., 1, :]
    t = fq.mont_mul(
        torch.stack([a0, fq.add(a0, a1)]), torch.stack([a1, fq.sub(a0, a1)])
    )
    c1 = fq.add(t[0], t[0])
    return torch.stack([t[1], c1], dim=-2)


def mul_fq(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Multiply by a base-field scalar s: (..., NL)."""
    return fq.mont_mul(a, s[..., None, :])


def conj(a: torch.Tensor) -> torch.Tensor:
    """Frobenius on Fq2: c0 - c1·u."""
    return torch.stack([a[..., 0, :], fq.neg(a[..., 1, :])], dim=-2)


def mul_by_xi(a: torch.Tensor) -> torch.Tensor:
    """Multiply by the sextic non-residue xi = 1 + u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([fq.sub(a0, a1), fq.add(a0, a1)], dim=-2)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return fq.is_zero(a).all(-1)


def inv(a: torch.Tensor) -> torch.Tensor:
    """(a0 + a1·u)^-1 = (a0 - a1·u) / (a0^2 + a1^2).  One Fq inversion."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    sq = fq.mont_sqr(a)
    norm = fq.add(sq[..., 0, :], sq[..., 1, :])
    ninv = fq.inv(norm)
    prod = fq.mont_mul(a, ninv[..., None, :])
    return torch.stack([prod[..., 0, :], fq.neg(prod[..., 1, :])], dim=-2)
