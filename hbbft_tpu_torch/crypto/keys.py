"""Threshold BLS keys, signatures, and hybrid encryption — suite-generic.

Reference: upstream ``threshold_crypto/src/lib.rs`` (``SecretKeySet``,
``PublicKeySet``, ``SecretKeyShare``, ``SignatureShare``, ``Ciphertext``,
``DecryptionShare``; BLS signatures with pk in G1 / sig in G2; hybrid
ElGamal-style KEM with pairing-checkable ciphertext validity).  Fork
checkout empty at survey time; see SURVEY.md §2 #14.

Scheme (conventions as in the reference):

* master secret ``s`` = f(0) of a random degree-``t`` poly f; share i =
  f(i+1); ``PublicKeySet`` = coefficient commitment in G1.
* signature share on msg m: ``sigma_i = s_i * H2(m)`` in G2; verify share:
  ``e(G1, sigma_i) == e(pk_i, H2(m))``; combine t+1 valid shares by
  Lagrange in the exponent -> unique deterministic master signature.
* encryption to master pk ``P = s*G1``: pick r, ``U = r*G1``,
  ``V = m XOR KDF(r*P)``, ``W = r*H2(U||V)``; validity check
  ``e(G1, W) == e(U, H2(U||V))``; decryption share ``w_i = s_i * U`` with
  share validity ``e(w_i, H2(U||V)) == e(pk_i, W)``; combine t+1 shares by
  Lagrange -> ``s*U = r*P`` -> KDF unmasks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

from hbbft_tpu_torch.crypto.poly import Commitment, Poly, lagrange_coefficients
from hbbft_tpu_torch.crypto.suite import Suite
from hbbft_tpu_torch.utils import canonical_bytes, kdf_stream, xor_bytes


# ---------------------------------------------------------------------------
# Regular (non-threshold) keys — used for vote signing and DKG row encryption
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PublicKey:
    g1: Any
    suite: Suite

    def to_bytes(self) -> bytes:
        return self.g1.to_bytes()

    def verify(self, msg: bytes, sig: "Signature") -> bool:
        h = self.suite.hash_to_g2(msg)
        return self.suite.pairing_eq(self.suite.g1_generator(), sig.g2, self.g1, h)

    def encrypt(self, msg: bytes, rng: Any) -> "Ciphertext":
        suite = self.suite
        r = rng.randrange(1, suite.scalar_modulus)
        u = suite.g1_generator() * r
        mask = kdf_stream(canonical_bytes(b"kem", (self.g1 * r).to_bytes()), len(msg))
        v = xor_bytes(msg, mask)
        w = suite.hash_to_g2(_ciphertext_hash_input(u, v)) * r
        return Ciphertext(u, v, w, suite)


@dataclass(frozen=True)
class SecretKey:
    x: int
    suite: Suite

    @staticmethod
    def random(rng: Any, suite: Suite) -> "SecretKey":
        return SecretKey(rng.randrange(1, suite.scalar_modulus), suite)

    def public_key(self) -> PublicKey:
        return PublicKey(self.suite.g1_generator() * self.x, self.suite)

    def sign(self, msg: bytes) -> "Signature":
        return Signature(self.suite.hash_to_g2(msg) * self.x, self.suite)

    def decrypt(self, ct: "Ciphertext") -> Optional[bytes]:
        if not ct.verify():
            return None
        mask = kdf_stream(canonical_bytes(b"kem", (ct.u * self.x).to_bytes()), len(ct.v))
        return xor_bytes(ct.v, mask)


@dataclass(frozen=True)
class Signature:
    g2: Any
    suite: Suite

    def to_bytes(self) -> bytes:
        return self.g2.to_bytes()

    def parity(self) -> bool:
        """A deterministic bit derived from the signature (the common coin)."""
        from hbbft_tpu_torch.utils import sha3_256

        return bool(sha3_256(self.to_bytes())[0] & 1)


# ---------------------------------------------------------------------------
# Threshold keys
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SignatureShare:
    g2: Any
    suite: Suite

    def to_bytes(self) -> bytes:
        return self.g2.to_bytes()


@dataclass(frozen=True)
class SecretKeyShare:
    x: int
    suite: Suite

    def sign(self, msg: bytes) -> SignatureShare:
        return SignatureShare(self.suite.hash_to_g2(msg) * self.x, self.suite)

    def sign_hash_point(self, h: Any) -> SignatureShare:
        return SignatureShare(h * self.x, self.suite)

    def decryption_share(self, ct: "Ciphertext") -> "DecryptionShare":
        return DecryptionShare(ct.u * self.x, self.suite)


@dataclass(frozen=True)
class PublicKeyShare:
    g1: Any
    suite: Suite

    def to_bytes(self) -> bytes:
        return self.g1.to_bytes()

    def verify_share(self, msg: bytes, share: SignatureShare) -> bool:
        h = self.suite.hash_to_g2(msg)
        return self.suite.pairing_eq(
            self.suite.g1_generator(), share.g2, self.g1, h
        )

    def verify_decryption_share(self, ct: "Ciphertext", share: "DecryptionShare") -> bool:
        h = self.suite.hash_to_g2(_ciphertext_hash_input(ct.u, ct.v))
        return self.suite.pairing_eq(share.g1, h, self.g1, ct.w)


@dataclass(frozen=True)
class DecryptionShare:
    g1: Any
    suite: Suite

    def to_bytes(self) -> bytes:
        return self.g1.to_bytes()


def _ciphertext_hash_input(u: Any, v: bytes) -> bytes:
    return canonical_bytes(b"ct", u.to_bytes(), v)


@dataclass(frozen=True)
class Ciphertext:
    """Hybrid threshold ciphertext ``(U, V, W)``; see module docstring."""

    u: Any  # G1
    v: bytes
    w: Any  # G2
    suite: Suite

    def hash_input(self) -> bytes:
        cached = self.__dict__.get("_hash_input")
        if cached is None:
            cached = _ciphertext_hash_input(self.u, self.v)
            object.__setattr__(self, "_hash_input", cached)
        return cached

    def verify(self) -> bool:
        """Ciphertext validity: ``e(G1, W) == e(U, H2(U||V))``.

        Memoized: validity is a pure function of the frozen fields, and
        ``SecretKey.decrypt`` re-verifies per decryptor — every node
        decrypting its slot of a shared DKG ciphertext otherwise pays
        the hash + pairing again."""
        cached = self.__dict__.get("_verify_ok")
        if cached is None:
            h = self.suite.hash_to_g2(self.hash_input())
            cached = self.suite.pairing_eq(
                self.suite.g1_generator(), self.w, self.u, h
            )
            object.__setattr__(self, "_verify_ok", cached)
        return cached

    def to_bytes(self) -> bytes:
        # Memoized: DKG signature payloads serialize the same ciphertext
        # once per receiving node per message otherwise (N^2-hot at
        # churn; pure function of frozen fields, so caching is safe).
        cached = self.__dict__.get("_bytes")
        if cached is None:
            cached = canonical_bytes(
                b"ciphertext", self.u.to_bytes(), self.v, self.w.to_bytes()
            )
            object.__setattr__(self, "_bytes", cached)
        return cached


class SecretKeySet:
    """Dealer-generated master secret: a random degree-``t`` polynomial.

    Any ``t + 1`` shares can sign/decrypt; ``t`` or fewer learn nothing.
    In HoneyBadger ``t = f = num_faulty``.
    """

    def __init__(self, poly: Poly, suite: Suite) -> None:
        self.poly = poly
        self.suite = suite

    @staticmethod
    def random(threshold: int, rng: Any, suite: Suite) -> "SecretKeySet":
        return SecretKeySet(Poly.random(threshold, rng, suite.scalar_modulus), suite)

    @property
    def threshold(self) -> int:
        return self.poly.degree

    def secret_key_share(self, i: int) -> SecretKeyShare:
        return SecretKeyShare(self.poly.eval(i + 1), self.suite)

    def public_keys(self) -> "PublicKeySet":
        return PublicKeySet(self.poly.commitment(self.suite), self.suite)


class PublicKeySet:
    """Public commitment to the master poly; derives master pk and shares."""

    def __init__(self, commitment: Commitment, suite: Suite) -> None:
        self.commitment = commitment
        self.suite = suite

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, PublicKeySet):
            return NotImplemented
        return self.commitment == other.commitment and self.suite == other.suite

    def __hash__(self) -> int:
        return hash((self.commitment, self.suite))

    @property
    def threshold(self) -> int:
        return self.commitment.degree

    def public_key(self) -> PublicKey:
        return PublicKey(self.commitment.elems[0], self.suite)

    def public_key_share(self, i: int) -> PublicKeyShare:
        return PublicKeyShare(self.commitment.eval(i + 1), self.suite)

    def to_bytes(self) -> bytes:
        return self.commitment.to_bytes()

    # -- combination ---------------------------------------------------
    def combine_signatures(self, shares: Mapping[int, SignatureShare]) -> Signature:
        """Lagrange-combine ``threshold + 1`` valid shares (by index)."""
        if len(shares) < self.threshold + 1:
            raise ValueError(
                f"need {self.threshold + 1} shares, got {len(shares)}"
            )
        idxs = sorted(shares)[: self.threshold + 1]
        lam = lagrange_coefficients(idxs, self.suite.scalar_modulus)
        acc = None
        for i in idxs:
            term = shares[i].g2 * lam[i]
            acc = term if acc is None else acc + term
        return Signature(acc, self.suite)

    def combine_decryption_shares(
        self, shares: Mapping[int, DecryptionShare], ct: Ciphertext
    ) -> bytes:
        """Lagrange-combine decryption shares and unmask the plaintext."""
        if len(shares) < self.threshold + 1:
            raise ValueError(
                f"need {self.threshold + 1} shares, got {len(shares)}"
            )
        idxs = sorted(shares)[: self.threshold + 1]
        lam = lagrange_coefficients(idxs, self.suite.scalar_modulus)
        acc = None
        for i in idxs:
            term = shares[i].g1 * lam[i]
            acc = term if acc is None else acc + term
        mask = kdf_stream(canonical_bytes(b"kem", acc.to_bytes()), len(ct.v))
        return xor_bytes(ct.v, mask)

    def verify_signature(self, msg: bytes, sig: Signature) -> bool:
        return self.public_key().verify(msg, sig)


# The reference's native scalar-KEM fast path (``_ScalarKem`` over the
# lazy ``native_engine`` import, and its environment switch)
# is dropped with the native engine: every KEM and combine here takes the
# pure-Python path, which the reference's equivalence tests pin
# byte-identical to it.
