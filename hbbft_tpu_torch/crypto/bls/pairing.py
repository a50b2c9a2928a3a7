"""Optimal ate pairing on BLS12-381 (oracle: affine Miller loop).

The Miller loop runs over the twist E'(Fq2); line functions are evaluated
at P in G1 and *untwisted* into sparse Fq12 elements.  With the untwist
(x, y) -> (x/w^2, y/w^3) the chord/tangent line through twist points,
scaled by the harmless factor w^3 (w^3 lies in Fq4, which the final
exponentiation kills), is

    l(P) = (lam * x_T - y_T)  +  (-lam * x_P) w^2  +  (y_P) w^3

with lam the Fq2 chord/tangent slope.  Affine steps cost one cheap Fq2
inversion each — fine for an oracle; the TPU path uses its own
projective formulation.

Final exponentiation: easy part by Frobenius/conjugate/inverse; hard part
by plain square-and-multiply with the integer (p^4 - p^2 + 1) / r.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from hbbft_tpu_torch.crypto.bls import fields as F
from hbbft_tpu_torch.crypto.bls.fields import BLS_X, P, R

X_ABS = -BLS_X  # the Miller-loop scalar (x is negative for BLS12-381)
_X_BITS = bin(X_ABS)[3:]  # bits below the MSB

HARD_EXP = (P**4 - P**2 + 1) // R
assert (P**4 - P**2 + 1) % R == 0, "BLS cyclotomic-polynomial identity broken"


def _line(
    lam: F.Fq2E, px: int, py: int, tx: F.Fq2E, ty: F.Fq2E
) -> F.Fq12E:
    """The (w^3-scaled, untwisted) line l(P) described in the module doc."""
    c0 = F.fq2_sub(F.fq2_mul(lam, tx), ty)
    c2 = F.fq2_neg(F.fq2_muls(lam, px))
    c3 = (py, 0)
    return (c0, F.FQ2_ZERO, c2, c3, F.FQ2_ZERO, F.FQ2_ZERO)


def miller_loop(p_aff: Tuple[int, int], q_aff: Tuple[F.Fq2E, F.Fq2E]) -> F.Fq12E:
    """Miller loop f_{|x|, Q}(P) with the x<0 conjugation applied."""
    px, py = p_aff
    qx, qy = q_aff
    tx, ty = qx, qy
    f = F.FQ12_ONE
    for bit in _X_BITS:
        # Tangent at T.
        lam = F.fq2_mul(
            F.fq2_muls(F.fq2_sqr(tx), 3), F.fq2_inv(F.fq2_add(ty, ty))
        )
        f = F.fq12_mul(F.fq12_sqr(f), _line(lam, px, py, tx, ty))
        x3 = F.fq2_sub(F.fq2_sqr(lam), F.fq2_add(tx, tx))
        ty = F.fq2_sub(F.fq2_mul(lam, F.fq2_sub(tx, x3)), ty)
        tx = x3
        if bit == "1":
            # Chord through T and Q (T != ±Q throughout the ate loop).
            lam = F.fq2_mul(F.fq2_sub(qy, ty), F.fq2_inv(F.fq2_sub(qx, tx)))
            f = F.fq12_mul(f, _line(lam, px, py, qx, qy))
            x3 = F.fq2_sub(F.fq2_sub(F.fq2_sqr(lam), tx), qx)
            ty = F.fq2_sub(F.fq2_mul(lam, F.fq2_sub(tx, x3)), ty)
            tx = x3
    # x < 0: f_{x,Q} = conjugate(f_{|x|,Q})
    return F.fq12_conjugate(f)


def final_exponentiation(f: F.Fq12E) -> F.Fq12E:
    """f^((p^12 - 1) / r)."""
    # Easy part: f^((p^6 - 1)(p^2 + 1)).
    f1 = F.fq12_mul(F.fq12_conjugate(f), F.fq12_inv(f))
    f2 = F.fq12_mul(F.fq12_frobenius(f1, 2), f1)
    # Hard part: ^(p^4 - p^2 + 1)/r.
    return F.fq12_pow(f2, HARD_EXP)


def pairing(p_aff: Tuple[int, int], q_aff: Tuple[F.Fq2E, F.Fq2E]) -> F.Fq12E:
    """e(P, Q) for affine P in G1(Fq), Q on the twist E'(Fq2)."""
    return final_exponentiation(miller_loop(p_aff, q_aff))


def multi_pairing_is_one(
    pairs: Sequence[Tuple[Optional[Tuple[int, int]], Optional[Tuple[F.Fq2E, F.Fq2E]]]]
) -> bool:
    """prod_i e(P_i, Q_i) == 1, sharing one final exponentiation.

    ``None`` for either component means the group identity (the pair
    contributes the factor 1 and is skipped).
    """
    acc = F.FQ12_ONE
    nontrivial = False
    for p_aff, q_aff in pairs:
        if p_aff is None or q_aff is None:
            continue
        acc = F.fq12_mul(acc, miller_loop(p_aff, q_aff))
        nontrivial = True
    if not nontrivial:
        return True
    return F.fq12_is_one(final_exponentiation(acc))
