"""Polynomials over the scalar field and group-element commitments.

Reference: upstream ``threshold_crypto/src/poly.rs`` (``Poly``,
``BivarPoly``, ``Commitment``, ``BivarCommitment``) — these power both key
sharing (SecretKeySet = random degree-f poly) and the SyncKeyGen DKG.
Fork checkout empty at survey time; see SURVEY.md §2 #12/#14.

Evaluation points: share ``i`` is the evaluation at ``x = i + 1`` (0 is
reserved for the master secret), matching the reference convention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def lagrange_coefficients(indices: Sequence[int], modulus: int) -> Dict[int, int]:
    """Lagrange coefficients at 0 for evaluation points ``x_i = i + 1``.

    Returns ``{i: lambda_i}`` with ``sum_i lambda_i * f(i+1) = f(0)`` for
    any poly of degree < len(indices).  One modular inversion total
    (Montgomery batch-inversion trick) — the per-index ``pow(-1)`` was a
    measurable slice of epoch time in the scalar-suite benchmarks.
    """
    idx = list(indices)
    xs = {i: (i + 1) % modulus for i in idx}
    nums: Dict[int, int] = {}
    dens: List[int] = []
    for i in idx:
        num, den = 1, 1
        for j in idx:
            if j == i:
                continue
            num = num * xs[j] % modulus
            den = den * (xs[j] - xs[i]) % modulus
        nums[i] = num
        dens.append(den)
    # Batch-invert dens: prefix[k] = den_0 ... den_{k-1}.
    prefix = [1]
    for d in dens:
        prefix.append(prefix[-1] * d % modulus)
    inv_acc = _inv(prefix[-1], modulus)
    coeffs: Dict[int, int] = {}
    for k in range(len(idx) - 1, -1, -1):
        d_inv = inv_acc * prefix[k] % modulus
        inv_acc = inv_acc * dens[k] % modulus
        coeffs[idx[k]] = nums[idx[k]] * d_inv % modulus
    return coeffs


def interpolate(points: Sequence[Tuple[int, int]], modulus: int) -> int:
    """Interpolate f(0) from arbitrary ``(x, y)`` points."""
    acc = 0
    for k, (xk, yk) in enumerate(points):
        num, den = 1, 1
        for j, (xj, _) in enumerate(points):
            if j == k:
                continue
            num = num * xj % modulus
            den = den * (xj - xk) % modulus
        acc = (acc + yk * num * _inv(den, modulus)) % modulus
    return acc


@dataclass(frozen=True)
class Poly:
    """Univariate polynomial over Z_r, coefficient order low-to-high."""

    coeffs: Tuple[int, ...]
    modulus: int

    @staticmethod
    def random(degree: int, rng: Any, modulus: int) -> "Poly":
        return Poly(
            tuple(rng.randrange(modulus) for _ in range(degree + 1)), modulus
        )

    @staticmethod
    def zero(modulus: int) -> "Poly":
        return Poly((0,), modulus)

    @staticmethod
    def constant(c: int, modulus: int) -> "Poly":
        return Poly((c % modulus,), modulus)

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    def eval(self, x: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % self.modulus
        return acc

    def __add__(self, other: "Poly") -> "Poly":
        n = max(len(self.coeffs), len(other.coeffs))
        a = list(self.coeffs) + [0] * (n - len(self.coeffs))
        b = list(other.coeffs) + [0] * (n - len(other.coeffs))
        return Poly(tuple((x + y) % self.modulus for x, y in zip(a, b)), self.modulus)

    def commitment(self, suite: Any) -> "Commitment":
        g = suite.g1_generator()
        return Commitment(tuple(g * c for c in self.coeffs))


@dataclass(frozen=True)
class Commitment:
    """Commitment to a poly: per-coefficient group elements ``c_k * G``."""

    elems: Tuple[Any, ...]

    @property
    def degree(self) -> int:
        return len(self.elems) - 1

    def eval(self, x: int) -> Any:
        """The committed value of f(x) in the group (Horner), memoized
        per ``x`` (row commitments are shared across nodes in the DKG
        ack checks; see BivarCommitment.row)."""
        cache = self.__dict__.get("_eval_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_eval_cache", cache)
        hit = cache.get(x)
        if hit is not None:
            return hit
        from hbbft_tpu_torch.crypto.suite import ScalarG

        first = self.elems[0] if self.elems else None
        if type(first) is ScalarG:
            # Scalar-suite fast path: Horner over raw ints, ONE group
            # object out.  The generic loop allocates two ScalarG per
            # coefficient, which dominated the N^3 DKG ack checks
            # (protocol-plane benchmarks run this suite).
            m = first.modulus
            acc_i = 0
            for e in reversed(self.elems):
                acc_i = (acc_i * x + e.value) % m
            acc = type(first)(acc_i, m)
        else:
            acc = None
            for e in reversed(self.elems):
                acc = e if acc is None else acc * x + e
        cache[x] = acc
        return acc

    def __add__(self, other: "Commitment") -> "Commitment":
        assert len(self.elems) == len(other.elems)
        return Commitment(tuple(a + b for a, b in zip(self.elems, other.elems)))

    def to_bytes(self) -> bytes:
        from hbbft_tpu_torch.utils import canonical_bytes

        return canonical_bytes(*[e.to_bytes() for e in self.elems])


@dataclass(frozen=True)
class BivarPoly:
    """Symmetric bivariate polynomial p(x, y) of degree ``t`` in each var.

    ``coeffs[i][j]`` multiplies ``x^i y^j``; symmetry ``coeffs[i][j] ==
    coeffs[j][i]`` makes ``p(a, b) == p(b, a)``, the property the DKG
    relies on (node i can compute p(i+1, j+1) from its row and hand it to
    node j as evidence about p(·, j+1)).
    """

    coeffs: Tuple[Tuple[int, ...], ...]
    modulus: int

    @staticmethod
    def random(degree: int, rng: Any, modulus: int) -> "BivarPoly":
        n = degree + 1
        m = [[0] * n for _ in range(n)]
        for i in range(n):
            for j in range(i, n):
                v = rng.randrange(modulus)
                m[i][j] = v
                m[j][i] = v
        return BivarPoly(tuple(tuple(row) for row in m), modulus)

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    def eval(self, x: int, y: int) -> int:
        acc = 0
        for i in reversed(range(len(self.coeffs))):
            row_val = 0
            for c in reversed(self.coeffs[i]):
                row_val = (row_val * y + c) % self.modulus
            acc = (acc * x + row_val) % self.modulus
        return acc

    def row(self, x: int) -> Poly:
        """The univariate polynomial ``y -> p(x, y)``."""
        n = len(self.coeffs)
        out = []
        for j in range(n):
            c = 0
            xp = 1
            for i in range(n):
                c = (c + self.coeffs[i][j] * xp) % self.modulus
                xp = xp * x % self.modulus
            out.append(c)
        return Poly(tuple(out), self.modulus)

    def commitment(self, suite: Any) -> "BivarCommitment":
        g = suite.g1_generator()
        return BivarCommitment(
            tuple(tuple(g * c for c in row) for row in self.coeffs)
        )


@dataclass(frozen=True)
class BivarCommitment:
    """Commitment to a symmetric bivariate poly (matrix of group elems)."""

    elems: Tuple[Tuple[Any, ...], ...]

    @property
    def degree(self) -> int:
        return len(self.elems) - 1

    def eval(self, x: int, y: int) -> Any:
        acc = None
        for i in reversed(range(len(self.elems))):
            row_val = None
            for e in reversed(self.elems[i]):
                row_val = e if row_val is None else row_val * y + e
            acc = row_val if acc is None else acc * x + row_val
        return acc

    def row(self, x: int) -> Commitment:
        """Commitment to the univariate row poly ``y -> p(x, y)``.

        Memoized per ``x`` on the object: during DKG every acker's row
        is evaluated against the same (shared, immutable) commitment by
        every node — N^3-hot at churn without the cache."""
        cache = self.__dict__.get("_row_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_row_cache", cache)
        hit = cache.get(x)
        if hit is not None:
            return hit
        n = len(self.elems)
        out = []
        for j in range(n):
            acc = None
            for i in reversed(range(n)):
                e = self.elems[i][j]
                acc = e if acc is None else acc * x + e
            out.append(acc)
        result = Commitment(tuple(out))
        cache[x] = result
        return result

    def to_bytes(self) -> bytes:
        from hbbft_tpu_torch.utils import canonical_bytes

        return canonical_bytes(
            *[e.to_bytes() for row in self.elems for e in row]
        )
