"""Batched optimal-ate pairing in PyTorch: Fq12 tower, Miller loop, final exp.

Counterpart of ``hbbft_tpu/crypto/tpu/pairing.py`` (same math):

* Fq12 elements are ``(..., 6, 2, NL)`` limb tensors (coefficients of w,
  ``w^6 = xi``), so a full Fq12 multiply is ONE batched Fq2 multiply over
  the 6x6 coefficient cross plus anti-diagonal reductions.
* The Miller loop walks the 63 fixed bits of |x| in run-length form
  (``X_RUNS``): doubling steps, with the add step only at the 5 set bits.
  T is tracked in Jacobian coordinates and every line is scaled by a
  nonzero Fq2 factor (killed by the final exponentiation), so there are
  NO field inversions in the loop.
* The final exponentiation's hard part uses the verified identity
      3·(p^4 - p^2 + 1)/r = (x-1)^2·(x+p)·(x^2+p^2-1) + 3
  (checked at import).  Raising to 3·hard instead of hard is sound for
  the ==1 check because 3 ∤ p^4-p^2+1, so cubing is a bijection on the
  cyclotomic subgroup.

Everything is batched over a leading "pairs" axis; the pairing-product
check shares one final exponentiation across all pairs.  Plain PyTorch:
the CPU path, and the reference the hand-written K3 kernels
(``csrc/pair.cu`` on ``csrc/fq12.cuh`` and ``csrc/pairing.cuh``) are held
against.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from hbbft_tpu_torch.crypto.bls import fields as OF
from hbbft_tpu_torch.crypto.bls.fields import BLS_X, P, R
from hbbft_tpu_torch.crypto.device import curve as dcurve
from hbbft_tpu_torch.crypto.device import fq, fq2

NL = fq.NL
X_ABS = -BLS_X

# The hard-part chain identity (module docstring); kept as an executable
# guard so a wrong refactor of the chain can't silently ship.
if 3 * ((P**4 - P**2 + 1) // R) != (BLS_X - 1) ** 2 * (BLS_X + P) * (
    BLS_X**2 + P**2 - 1
) + 3:
    raise AssertionError("final-exponentiation hard-part identity broken")
if (P**4 - P**2 + 1) % 3 == 0:
    raise AssertionError("3 divides p^4 - p^2 + 1: cubing is not a bijection")

# Bits of |x| below the MSB, MSB-first — the Miller/x-exp schedule.
X_BITS = np.array([int(b) for b in bin(X_ABS)[3:]], dtype=np.int64)


def _bit_runs(bits) -> Tuple[Tuple[int, bool], ...]:
    """Static run-length form of an MSB-first bit schedule: maximal runs
    of steps where only the LAST bit is set -> (run_length, ends_set)."""
    runs = []
    count = 0
    for b in bits:
        count += 1
        if b:
            runs.append((count, True))
            count = 0
    if count:
        runs.append((count, False))
    return tuple(runs)


X_RUNS = _bit_runs(X_BITS)

FQ12_ONE = np.zeros((6, 2, NL), dtype=np.int64)
FQ12_ONE[0, 0] = fq.ONE_MONT
fq.register_const("fq12_one", FQ12_ONE)


@lru_cache(maxsize=None)
def _gamma_name(k: int) -> str:
    """Frobenius constants gamma[k][i] = xi^(i(p^k-1)/6), registered in
    the fq constant cache; returns the cache name."""
    name = f"gamma{k}"
    fq.register_const(name, np.stack([fq2.to_mont_np(c) for c in OF._gamma(k)]))
    return name


# ---------------------------------------------------------------------------
# Fq12 arithmetic
# ---------------------------------------------------------------------------


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full Fq12 multiply: one batched 6x6 Fq2 cross + xi-reduction."""
    prod = fq2.mul(a[..., :, None, :, :], b[..., None, :, :, :])
    return _reduce_cross(prod, range(6), range(6))


def _reduce_cross(prod: torch.Tensor, ioffs, joffs) -> torch.Tensor:
    """Sum prod[..., i, j, :, :] into w^(ioffs[i]+joffs[j]) buckets and
    fold w^(6+k) = xi·w^k.  Raw limb sums stay far inside the sub bound."""
    out_lo = [None] * 6
    out_hi = [None] * 6
    for i, io in enumerate(ioffs):
        for j, jo in enumerate(joffs):
            k = int(io + jo)
            term = prod[..., i, j, :, :]
            if k < 6:
                out_lo[k] = term if out_lo[k] is None else out_lo[k] + term
            else:
                out_hi[k - 6] = term if out_hi[k - 6] is None else out_hi[k - 6] + term
    coeffs = []
    for k in range(6):
        lo = out_lo[k]
        hi = out_hi[k]
        if lo is None and hi is None:
            raise AssertionError("empty bucket")
        if hi is None:
            coeffs.append(fq2.normalize(lo))
        elif lo is None:
            coeffs.append(fq2.mul_by_xi(hi))
        else:
            coeffs.append(fq.add(lo, fq2.mul_by_xi(hi)))
    return torch.stack(coeffs, dim=-3)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def sparse_mul(a: torch.Tensor, l0: torch.Tensor, l2: torch.Tensor, l3: torch.Tensor) -> torch.Tensor:
    """a · (l0 + l2·w^2 + l3·w^3) — the Miller-line shape."""
    line = torch.stack([l0, l2, l3], dim=-3)
    prod = fq2.mul(a[..., :, None, :, :], line[..., None, :, :, :])
    return _reduce_cross(prod, range(6), (0, 2, 3))


def conj(a: torch.Tensor) -> torch.Tensor:
    """a^(p^6): inverse on the cyclotomic unit circle."""
    return frobenius(a, 6)


def frobenius(a: torch.Tensor, k: int) -> torch.Tensor:
    g = fq.const(_gamma_name(k), a.device)
    c = fq2.conj(a) if k % 2 == 1 else a
    return fq2.mul(c, g)


def inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse via the norm to Fq2 (mirrors the oracle's fq12_inv)."""
    prod_conj = None
    for k in (2, 4, 6, 8, 10):
        fr = frobenius(a, k)
        prod_conj = fr if prod_conj is None else mul(prod_conj, fr)
    norm12 = mul(a, prod_conj)
    ninv = fq2.inv(norm12[..., 0, :, :])
    return fq2.mul(prod_conj, ninv[..., None, :, :])


def pow_x_abs(f: torch.Tensor) -> torch.Tensor:
    """f^|x| — square-only runs + a mul at each of the 5 set bits."""
    acc = f
    for length, ends_set in X_RUNS:
        for _ in range(length):
            acc = sqr(acc)
        if ends_set:
            acc = mul(acc, f)
    return acc


def pow_x(f: torch.Tensor) -> torch.Tensor:
    """f^x for the (negative) BLS parameter; f must be unitary."""
    return conj(pow_x_abs(f))


def is_one(a: torch.Tensor) -> torch.Tensor:
    """Batched check a == 1."""
    ok = fq.is_zero(fq.sub(a[..., 0, 0, :], fq.const("one", a.device)))
    ok = ok & fq.is_zero(a[..., 0, 1, :])
    return ok & fq2.is_zero(a[..., 1:, :, :]).all(-1)


# ---------------------------------------------------------------------------
# Miller loop (Jacobian T on the twist, scaled lines)
# ---------------------------------------------------------------------------


def miller_loop(px: torch.Tensor, py: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """f_{|x|,Q}(P) conjugated for x<0; batched over leading axes.

    px, py: (..., NL) affine G1; qx, qy: (..., 2, NL) affine twist point.
    Lines are scaled by 2YZ^3 (doubling) and HZ (addition) — nonzero Fq2
    factors the final exponentiation kills.
    """
    px_neg = fq.neg(px)
    one = fq.const("fq2_one", qx.device).expand(qx.shape)
    f0 = fq.const("fq12_one", qx.device).expand(*qx.shape[:-2], 6, 2, NL)

    def dbl_step(X, Y, Z, f):
        A = fq2.sqr(X)
        B = fq2.sqr(Y)
        Z1Z1 = fq2.sqr(Z)
        l0 = fq.sub(fq2.small_mul(fq2.mul(X, A), 3), fq2.small_mul(B, 2))
        l2 = fq.neg(fq2.mul_fq(fq2.small_mul(fq2.mul(A, Z1Z1), 3), px))
        Znew = fq2.small_mul(fq2.mul(Y, Z), 2)
        l3 = fq2.mul_fq(fq2.mul(Znew, Z1Z1), py)
        C = fq2.sqr(B)
        D = fq2.small_mul(fq.sub(fq.sub(fq2.sqr(fq.add(X, B)), A), C), 2)
        E = fq2.small_mul(A, 3)
        F = fq2.sqr(E)
        X3 = fq.sub(F, fq2.small_mul(D, 2))
        Y3 = fq.sub(fq2.mul(E, fq.sub(D, X3)), fq2.small_mul(C, 8))
        f = sqr(f)
        f = sparse_mul(f, l0, l2, l3)
        return X3, Y3, Znew, f

    def add_step(X, Y, Z, f):
        Z1Z1 = fq2.sqr(Z)
        U2 = fq2.mul(qx, Z1Z1)
        S2 = fq2.mul(qy, fq2.mul(Z, Z1Z1))
        H = fq.sub(U2, X)
        theta = fq.sub(S2, Y)
        HZ = fq2.mul(H, Z)
        l0 = fq.sub(fq2.mul(theta, qx), fq2.mul(qy, HZ))
        l2 = fq2.mul_fq(theta, px_neg)
        l3 = fq2.mul_fq(HZ, py)
        HH = fq2.sqr(H)
        I = fq2.small_mul(HH, 4)
        J = fq2.mul(H, I)
        rr = fq2.small_mul(theta, 2)
        V = fq2.mul(X, I)
        X3 = fq.sub(fq.sub(fq2.sqr(rr), J), fq2.small_mul(V, 2))
        Y3 = fq.sub(fq2.mul(rr, fq.sub(V, X3)), fq2.small_mul(fq2.mul(Y, J), 2))
        Z3 = fq2.small_mul(fq2.mul(Z, H), 2)
        f = sparse_mul(f, l0, l2, l3)
        return X3, Y3, Z3, f

    # Static X_RUNS schedule: doubling runs with the add step at the 5
    # set bits of |x|.
    carry = (qx, qy, one, f0)
    for length, ends_set in X_RUNS:
        for _ in range(length):
            carry = dbl_step(*carry)
        if ends_set:
            carry = add_step(*carry)
    # x < 0: f_{x,Q} = conjugate(f_{|x|,Q})
    return conj(carry[3])


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------


def final_exp_is_one(f: torch.Tensor) -> torch.Tensor:
    """Is f^((p^12-1)/r) == 1?  Uses the 3·hard chain (module docstring)."""
    # Easy part: f^((p^6-1)(p^2+1)); result is unitary.
    f1 = mul(conj(f), inv(f))
    m = mul(frobenius(f1, 2), f1)
    # Hard part to the power 3·(p^4-p^2+1)/r = (x-1)^2(x+p)(x^2+p^2-1)+3.
    a = mul(pow_x(m), conj(m))                 # m^(x-1)
    b = mul(pow_x(a), conj(a))                 # a^(x-1)
    c = mul(pow_x(b), frobenius(b, 1))         # b^(x+p)
    d = pow_x(pow_x(c))                        # c^(x^2)
    g = mul(mul(d, frobenius(c, 2)), conj(c))  # c^(x^2+p^2-1)
    res = mul(g, mul(sqr(m), m))               # · m^3
    return is_one(res)


# ---------------------------------------------------------------------------
# Affine conversion + pairing-product check
# ---------------------------------------------------------------------------


def g1_affine(p: dcurve.Point) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobian G1 -> affine; identity becomes garbage (caller gates on
    the inf flag).  One Fq inversion (Fermat)."""
    x, y, z, _inf = p
    zi = fq.inv(fq.normalize(z))
    zi2 = fq.mont_sqr(zi)
    return fq.mont_mul(x, zi2), fq.mont_mul(y, fq.mont_mul(zi2, zi))


def g2_affine(p: dcurve.Point) -> Tuple[torch.Tensor, torch.Tensor]:
    x, y, z, _inf = p
    zi = fq2.inv(fq2.normalize(z))
    zi2 = fq2.sqr(zi)
    return fq2.mul(x, zi2), fq2.mul(y, fq2.mul(zi2, zi))


def miller_values(g1s: dcurve.Point, g2s: dcurve.Point) -> torch.Tensor:
    """f_{x,Q_i}(P_i) for every pair of the batch axis, with the factor 1
    where either side is the identity (the oracle's None-skip)."""
    px, py = g1_affine(g1s)
    qx, qy = g2_affine(g2s)
    fs = miller_loop(px, py, qx, qy)
    skip = (g1s[3] | g2s[3]).bool()
    one = fq.const("fq12_one", fs.device)
    return torch.where(skip.reshape(skip.shape + (1, 1, 1)), one, fs)


def miller_product(g1s: dcurve.Point, g2s: dcurve.Point) -> torch.Tensor:
    """prod_i f_{x,Q_i}(P_i) over the batch axis — the pairing product
    BEFORE the final exponentiation (one Fq12 element).  Splitting this
    from :func:`final_exp_is_one` lets a caller combine several Miller
    products and pay ONE final exponentiation."""
    fs = miller_values(g1s, g2s)
    acc = fs[0]
    for i in range(1, fs.shape[0]):
        acc = mul(acc, fs[i])
    return acc


def pairing_product_is_one(g1s: dcurve.Point, g2s: dcurve.Point) -> torch.Tensor:
    """prod_i e(P_i, Q_i) == 1 over a batch axis; one final exponentiation."""
    return final_exp_is_one(miller_product(g1s, g2s))
