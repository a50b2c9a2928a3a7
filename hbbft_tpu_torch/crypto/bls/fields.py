"""BLS12-381 field tower: Fq, Fq2, Fq12 (direct degree-6 over Fq2).

Representation choices (oracle = simplicity over speed):

* Fq: plain Python ints mod P (functions, not a class — hot enough that
  object overhead matters even host-side).
* Fq2: ``(c0, c1)`` int tuples, ``c0 + c1*u``, ``u^2 = -1``.
* Fq12: 6-tuple of Fq2 coefficients in ``w``, ``w^6 = xi = 1 + u``.
  Frobenius maps are generic: coefficient-wise Fq2 Frobenius times the
  import-time constants ``gamma[k][i] = xi^(i*(p^k - 1)/6)``.
"""

from __future__ import annotations

from typing import List, Tuple

# The base-field modulus of BLS12-381 (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# The group order (scalar field, 255 bits).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# The BLS parameter x (negative): p, r, t are polynomials in x.
BLS_X = -0xD201000000010000

Fq2E = Tuple[int, int]
Fq12E = Tuple[Fq2E, Fq2E, Fq2E, Fq2E, Fq2E, Fq2E]

# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

FQ2_ZERO: Fq2E = (0, 0)
FQ2_ONE: Fq2E = (1, 0)
XI: Fq2E = (1, 1)  # the sextic-twist non-residue 1 + u


def fq2_add(a: Fq2E, b: Fq2E) -> Fq2E:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a: Fq2E, b: Fq2E) -> Fq2E:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a: Fq2E) -> Fq2E:
    return (-a[0] % P, -a[1] % P)


def fq2_mul(a: Fq2E, b: Fq2E) -> Fq2E:
    # (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + (a0b1 + a1b0) u
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fq2_sqr(a: Fq2E) -> Fq2E:
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    t = a[0] * a[1]
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, (t + t) % P)


def fq2_muls(a: Fq2E, s: int) -> Fq2E:
    return (a[0] * s % P, a[1] * s % P)


def fq2_conj(a: Fq2E) -> Fq2E:
    """The p-power Frobenius on Fq2 (conjugation)."""
    return (a[0], -a[1] % P)


def fq2_inv(a: Fq2E) -> Fq2E:
    # (a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    inv = pow(norm, P - 2, P)
    return (a[0] * inv % P, -a[1] * inv % P)


def fq2_eq(a: Fq2E, b: Fq2E) -> bool:
    return a[0] % P == b[0] % P and a[1] % P == b[1] % P


def fq2_is_zero(a: Fq2E) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def fq2_pow(a: Fq2E, e: int) -> Fq2E:
    result = FQ2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sqr(base)
        e >>= 1
    return result


def fq2_legendre_is_square(a: Fq2E) -> bool:
    """Euler criterion in the field of q = p^2 elements."""
    if fq2_is_zero(a):
        return True
    return fq2_eq(fq2_pow(a, (P * P - 1) // 2), FQ2_ONE)


def _find_fq2_nonresidue() -> Fq2E:
    cand = (1, 1)
    while fq2_legendre_is_square(cand):
        cand = ((cand[0] + 1) % P, cand[1])
    return cand


_TS_Q = P * P - 1
_TS_S = (_TS_Q & -_TS_Q).bit_length() - 1  # 2-adic valuation of p^2 - 1
_TS_Q >>= _TS_S
_TS_Z: Fq2E | None = None  # lazily found non-residue


def fq2_sqrt(a: Fq2E) -> Fq2E | None:
    """Tonelli-Shanks in Fq2; returns None for non-squares."""
    global _TS_Z
    if fq2_is_zero(a):
        return FQ2_ZERO
    if not fq2_legendre_is_square(a):
        return None
    if _TS_Z is None:
        _TS_Z = _find_fq2_nonresidue()
    m = _TS_S
    c = fq2_pow(_TS_Z, _TS_Q)
    t = fq2_pow(a, _TS_Q)
    r = fq2_pow(a, (_TS_Q + 1) // 2)
    while not fq2_eq(t, FQ2_ONE):
        # find least i with t^(2^i) == 1
        i = 0
        t2 = t
        while not fq2_eq(t2, FQ2_ONE):
            t2 = fq2_sqr(t2)
            i += 1
        b = c
        for _ in range(m - i - 1):
            b = fq2_sqr(b)
        m = i
        c = fq2_sqr(b)
        t = fq2_mul(t, c)
        r = fq2_mul(r, b)
    assert fq2_eq(fq2_sqr(r), a)
    return r


# ---------------------------------------------------------------------------
# Fq12 = Fq2[w] / (w^6 - xi)
# ---------------------------------------------------------------------------

FQ12_ONE: Fq12E = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO, FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ12_ZERO: Fq12E = (FQ2_ZERO,) * 6


def fq12_from_fq2(c: Fq2E, power: int = 0) -> Fq12E:
    out: List[Fq2E] = [FQ2_ZERO] * 6
    out[power] = c
    return tuple(out)  # type: ignore[return-value]


def fq12_add(a: Fq12E, b: Fq12E) -> Fq12E:
    return tuple(fq2_add(x, y) for x, y in zip(a, b))  # type: ignore[return-value]


def fq12_mul(a: Fq12E, b: Fq12E) -> Fq12E:
    acc: List[Fq2E] = [FQ2_ZERO] * 11
    for i in range(6):
        ai = a[i]
        if ai == FQ2_ZERO:
            continue
        for j in range(6):
            bj = b[j]
            if bj == FQ2_ZERO:
                continue
            acc[i + j] = fq2_add(acc[i + j], fq2_mul(ai, bj))
    # reduce w^(6+k) = xi * w^k
    for k in range(10, 5, -1):
        acc[k - 6] = fq2_add(acc[k - 6], fq2_mul(acc[k], XI))
    return tuple(acc[:6])  # type: ignore[return-value]


def fq12_sqr(a: Fq12E) -> Fq12E:
    return fq12_mul(a, a)


def fq12_eq(a: Fq12E, b: Fq12E) -> bool:
    return all(fq2_eq(x, y) for x, y in zip(a, b))


def fq12_is_one(a: Fq12E) -> bool:
    return fq12_eq(a, FQ12_ONE)


def fq12_pow(a: Fq12E, e: int) -> Fq12E:
    result = FQ12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_mul(base, base)
        e >>= 1
    return result


# Frobenius constants gamma[k][i] = xi^(i * (p^k - 1) / 6) for w^i coeffs.
_GAMMA: dict[int, Tuple[Fq2E, ...]] = {}


def _gamma(k: int) -> Tuple[Fq2E, ...]:
    if k not in _GAMMA:
        e = (pow(P, k) - 1) // 6
        base = fq2_pow(XI, e)
        out = [FQ2_ONE]
        for _ in range(5):
            out.append(fq2_mul(out[-1], base))
        _GAMMA[k] = tuple(out)
    return _GAMMA[k]


def fq12_frobenius(a: Fq12E, k: int = 1) -> Fq12E:
    """a^(p^k).  Coefficient Frobenius (conjugate if k odd) times gamma."""
    g = _gamma(k)
    out = []
    for i in range(6):
        c = a[i]
        if k % 2 == 1:
            c = fq2_conj(c)
        out.append(fq2_mul(c, g[i]))
    return tuple(out)  # type: ignore[return-value]


def fq12_conjugate(a: Fq12E) -> Fq12E:
    """a^(p^6) — inverse for elements on the cyclotomic unit circle."""
    return fq12_frobenius(a, 6)


def fq12_inv(a: Fq12E) -> Fq12E:
    """Inverse via the norm to Fq2: prod of the 6 Galois conjugates."""
    # conj_k = a^(p^(2k)) for k = 1..5; a * prod(conj) = Norm in Fq2.
    prod_conj = FQ12_ONE
    for k in (2, 4, 6, 8, 10):
        prod_conj = fq12_mul(prod_conj, fq12_frobenius(a, k))
    norm12 = fq12_mul(a, prod_conj)
    # norm12 must lie in Fq2 (the w^0 coefficient).
    assert all(fq2_is_zero(norm12[i]) for i in range(1, 6)), "norm not in Fq2"
    ninv = fq2_inv(norm12[0])
    return tuple(fq2_mul(c, ninv) for c in prod_conj)  # type: ignore[return-value]
