"""Abstract *group suite*: the algebra the threshold scheme is generic over.

The reference hardwires BLS12-381 via the ``pairing`` crate (upstream
``threshold_crypto/src/lib.rs``).  Here the scheme is written once against
this suite interface and instantiated with:

* :class:`ScalarSuite` — **insecure** arithmetic in Z_r where the "groups"
  are the additive group of integers mod r and the "pairing" is plain
  multiplication.  Structurally identical to BLS (linear scheme, Lagrange
  in the exponent, pairing product equations) but with trivial discrete
  logs — used only to make protocol-logic tests fast and deterministic.
* ``BLSSuite`` (:mod:`hbbft_tpu_torch.crypto.bls`) — real BLS12-381,
  pure-Python oracle implementation.

Conventions (matching ``threshold_crypto``): public keys live in G1,
signatures and hashed messages in G2, decryption shares in G1.
"""

from __future__ import annotations

import abc
import hashlib
from dataclasses import dataclass
from typing import Any, Sequence, Tuple

from hbbft_tpu_torch.utils import canonical_bytes


class Suite(abc.ABC):
    """A pairing-friendly group suite.

    Suites are stateless: two instances of the same class are the same
    suite (value equality), so objects that carry a suite reference —
    keys, ciphertexts, Changes — stay value-comparable across
    serialization round-trips.
    """

    name: str
    scalar_modulus: int  # order r of G1/G2

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self))

    # -- group elements ----------------------------------------------
    @abc.abstractmethod
    def g1_generator(self) -> Any: ...

    @abc.abstractmethod
    def g2_generator(self) -> Any: ...

    @abc.abstractmethod
    def g1_identity(self) -> Any: ...

    @abc.abstractmethod
    def g2_identity(self) -> Any: ...

    # -- membership ---------------------------------------------------
    @abc.abstractmethod
    def is_g1(self, obj: Any, check_subgroup: bool = True) -> bool:
        """Whether ``obj`` is a G1 element of this suite (wire validation).

        ``check_subgroup=False`` skips the expensive r-torsion check for
        elements that are locally derived (trusted) rather than
        wire-sourced.
        """

    @abc.abstractmethod
    def is_g2(self, obj: Any, check_subgroup: bool = True) -> bool:
        """Whether ``obj`` is a G2 element of this suite (wire validation)."""

    # -- hashing ------------------------------------------------------
    @abc.abstractmethod
    def hash_to_g2(self, data: bytes) -> Any:
        """Hash arbitrary bytes to a G2 element of unknown discrete log."""

    def hash_to_scalar(self, data: bytes) -> int:
        """Hash to a scalar in [0, r)."""
        h = hashlib.sha3_256(b"h2s" + data).digest()
        return int.from_bytes(h, "big") % self.scalar_modulus

    # -- wire decoding ------------------------------------------------
    @abc.abstractmethod
    def g1_from_bytes(self, data: bytes) -> Any:
        """Decode (and fully validate) a wire-sourced G1 element.

        Raises ``ValueError`` on anything that is not the canonical
        encoding of a subgroup element — this is the codec-side twin of
        :meth:`is_g1` and MUST enforce the same membership policy,
        because decoded elements reach pairing checks directly.
        """

    @abc.abstractmethod
    def g2_from_bytes(self, data: bytes) -> Any:
        """Decode (and fully validate) a wire-sourced G2 element."""

    # -- pairing ------------------------------------------------------
    @abc.abstractmethod
    def pairing_product_is_one(self, pairs: Sequence[Tuple[Any, Any]]) -> bool:
        """Check ``prod_i e(a_i, b_i) == 1`` for ``(a_i, b_i)`` in G1 x G2."""

    def pairing_eq(self, a1: Any, b1: Any, a2: Any, b2: Any) -> bool:
        """Check ``e(a1, b1) == e(a2, b2)``."""
        return self.pairing_product_is_one([(a1, b1), (-a2, b2)])


@dataclass(frozen=True)
class ScalarG:
    """Element of the insecure scalar "group" (additive Z_r)."""

    value: int
    modulus: int

    # serde hooks (no annotation: class attrs, not dataclass fields).
    # G1 and G2 are the same structure in this suite, so one group id.
    serde_suite_name = "scalar-insecure"
    serde_group = 1

    def __add__(self, other: "ScalarG") -> "ScalarG":
        return ScalarG((self.value + other.value) % self.modulus, self.modulus)

    def __neg__(self) -> "ScalarG":
        return ScalarG(-self.value % self.modulus, self.modulus)

    def __sub__(self, other: "ScalarG") -> "ScalarG":
        return self + (-other)

    def __mul__(self, scalar: int) -> "ScalarG":
        return ScalarG(self.value * (scalar % self.modulus) % self.modulus, self.modulus)

    __rmul__ = __mul__

    def is_identity(self) -> bool:
        return self.value == 0

    def to_bytes(self) -> bytes:
        return self.value.to_bytes(32, "big")


# A 255-bit prime: the BLS12-381 scalar-field order, so scalars are
# interchangeable between the mock and the real suite.
BLS12_381_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


class ScalarSuite(Suite):
    """INSECURE mock suite over Z_r — protocol tests only (see module doc)."""

    name = "scalar-insecure"
    scalar_modulus = BLS12_381_R

    def g1_generator(self) -> ScalarG:
        return ScalarG(1, self.scalar_modulus)

    def g2_generator(self) -> ScalarG:
        return ScalarG(1, self.scalar_modulus)

    def g1_identity(self) -> ScalarG:
        return ScalarG(0, self.scalar_modulus)

    def g2_identity(self) -> ScalarG:
        return ScalarG(0, self.scalar_modulus)

    def is_g1(self, obj: Any, check_subgroup: bool = True) -> bool:
        return (
            isinstance(obj, ScalarG)
            and isinstance(obj.value, int)
            and not isinstance(obj.value, bool)
            and obj.modulus == self.scalar_modulus
            and 0 <= obj.value < obj.modulus
        )

    def is_g2(self, obj: Any, check_subgroup: bool = True) -> bool:
        return self.is_g1(obj)

    def g1_from_bytes(self, data: bytes) -> ScalarG:
        # lint: no-subgroup (prime-order scalar group: every residue in
        # range is a member; the range check IS the membership check)
        if not isinstance(data, bytes) or len(data) != 32:
            raise ValueError("scalar group element: want 32 bytes")
        v = int.from_bytes(data, "big")
        if v >= self.scalar_modulus:
            raise ValueError("scalar group element out of range")
        return ScalarG(v, self.scalar_modulus)

    g2_from_bytes = g1_from_bytes

    def hash_to_g2(self, data: bytes) -> ScalarG:
        h = hashlib.sha3_256(canonical_bytes(b"h2g2", data)).digest()
        # Avoid 0 (identity) so "unknown dlog" shape is preserved.
        v = int.from_bytes(h, "big") % (self.scalar_modulus - 1) + 1
        return ScalarG(v, self.scalar_modulus)

    def pairing_product_is_one(self, pairs: Sequence[Tuple[Any, Any]]) -> bool:
        acc = 0
        for a, b in pairs:
            acc = (acc + a.value * b.value) % self.scalar_modulus
        return acc == 0
