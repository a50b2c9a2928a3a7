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

Copy of ``hbbft_tpu/crypto/keys.py``, with its scalar-suite native KEM
and combine (``_ScalarKem`` over :mod:`hbbft_tpu_torch.native_engine`;
``HBBFT_TORCH_DKG_BATCH=0`` turns the batch paths off).
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

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
        fast = _scalar_kem(suite)
        if fast is not None and isinstance(msg, bytes):
            return fast.encrypt(self, msg, r)
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
        fast = _scalar_kem(self.suite)
        if fast is not None and fast.ct_ok(ct):
            return fast.decrypt(self, ct)
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
        # Scalar-suite vectorized combine: one C Lagrange call, same
        # mod-r sum as the loop below (fast path only for well-formed
        # scalar shares; anything else keeps the pure path).
        fast = _scalar_kem(self.suite)
        if fast is not None and _native_combine_enabled():
            vals = fast.share_values(idxs, shares, "g2")
            if vals is not None:
                acc = fast.combine_at_zero(idxs, vals)
                if acc is not None:
                    return Signature(
                        fast._g_type(acc, fast._mod), self.suite
                    )
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
        # Scalar-suite vectorized combine + kdf + xor in one C call —
        # byte-identical to the pure path below (the combine itself is
        # the same mod-r Lagrange sum; the kdf framing is the shared
        # scalar-KEM code the equivalence suites pin).
        fast = _scalar_kem(self.suite)
        if fast is not None and _native_combine_enabled() and isinstance(ct.v, bytes):
            vals = fast.share_values(idxs, shares, "g1")
            if vals is not None:
                out = fast.combine_unmask(idxs, vals, ct.v)
                if out is not None:
                    return out
        lam = lagrange_coefficients(idxs, self.suite.scalar_modulus)
        acc = None
        for i in idxs:
            term = shares[i].g1 * lam[i]
            acc = term if acc is None else acc + term
        mask = kdf_stream(canonical_bytes(b"kem", acc.to_bytes()), len(ct.v))
        return xor_bytes(ct.v, mask)

    def verify_signature(self, msg: bytes, sig: Signature) -> bool:
        return self.public_key().verify(msg, sig)


# ---------------------------------------------------------------------------
# Native KEM fast path (scalar suite only)
# ---------------------------------------------------------------------------
#
# The DKG threads N^3 KEM operations through consensus at an era change
# (every node encrypts one ack value to every node for every dealer, and
# decrypts its slot of every ack) — the dominant Python cost of config 4
# churn after the engine took over the message loop (BASELINE.md round
# 3).  native/engine.cpp exposes the same KEM byte-for-byte
# (hbe_kem_encrypt/decrypt mirror PublicKey.encrypt / SecretKey.decrypt:
# canonical_bytes framing, kdf_stream, h2g2); randomness stays drawn
# from the caller's rng HERE so the rng consumption stream — and hence
# every equivalence test — is unchanged.  Equivalence is pinned by
# tests/test_crypto_scheme.py::test_native_kem_matches_python.


# Pre-rendered serde encoding of a scalar-suite Ciphertext (the exact
# bytes serde.dumps emits: STRUCT "ct" + 4-field tuple of suite-name
# string, GROUP u, BYTES v, GROUP w — wire.py _pack_ciphertext over the
# serde grammar).  serde._encode consumes the `_serde_cache` memo, so
# the N^2 ack/row ciphertexts a DKG epoch encodes into outgoing
# contributions skip the recursive encoder.  Byte-equality with the
# recursive path is pinned by tests (a wrong rendering here would be a
# silent wire divergence).
_SCALAR_NAME = b"scalar-insecure"
_CT_HEAD = (
    bytes([0x10, 2]) + b"ct" + bytes([0x06]) + (4).to_bytes(4, "big")
    + bytes([0x05]) + len(_SCALAR_NAME).to_bytes(4, "big") + _SCALAR_NAME
)
_GRP_HEAD = (
    bytes([0x11, len(_SCALAR_NAME)]) + _SCALAR_NAME + bytes([1])
    + (32).to_bytes(4, "big")
)


def scalar_ct_serde(u_be32: bytes, v: bytes, w_be32: bytes) -> bytes:
    return (
        _CT_HEAD
        + _GRP_HEAD + u_be32
        + bytes([0x04]) + len(v).to_bytes(4, "big") + v
        + _GRP_HEAD + w_be32
    )


class _ScalarKem:
    def __init__(self, lib: Any, suite: Suite) -> None:
        self._lib = lib
        self._suite = suite
        self._g_type = type(suite.g1_generator())
        self._mod = suite.scalar_modulus
        self._r_be = suite.scalar_modulus.to_bytes(32, "big")

    def ct_ok(self, ct: Any) -> bool:
        """Fast path only for structurally sound scalar ciphertexts; the
        Python path keeps its existing behavior for everything else."""
        g = self._g_type
        return (
            isinstance(ct, Ciphertext)
            and type(ct.u) is g
            and type(ct.w) is g
            and isinstance(ct.v, bytes)
            and isinstance(ct.u.value, int)
            and isinstance(ct.w.value, int)
            and ct.u.modulus == self._mod
            and ct.w.modulus == self._mod
            and ct.suite == self._suite
            and 0 <= ct.u.value < self._mod
            and 0 <= ct.w.value < self._mod
        )

    def encrypt(self, pk: "PublicKey", msg: bytes, r: int) -> "Ciphertext":
        import ctypes

        n = len(msg)
        out_u = (ctypes.c_uint8 * 32)()
        out_v = (ctypes.c_uint8 * n)()
        out_w = (ctypes.c_uint8 * 32)()
        self._lib.hbe_kem_encrypt(
            (ctypes.c_uint8 * 32).from_buffer_copy(pk.g1.value.to_bytes(32, "big")),
            (ctypes.c_uint8 * n).from_buffer_copy(msg) if n else None,
            n,
            (ctypes.c_uint8 * 32).from_buffer_copy(r.to_bytes(32, "big")),
            out_u, out_v, out_w,
        )
        g, m = self._g_type, self._mod
        u_b, v_b, w_b = bytes(out_u), bytes(out_v), bytes(out_w)
        ct = Ciphertext(
            g(int.from_bytes(u_b, "big"), m),
            v_b,
            g(int.from_bytes(w_b, "big"), m),
            self._suite,
        )
        object.__setattr__(ct, "_verify_ok", True)
        object.__setattr__(ct, "_serde_cache", scalar_ct_serde(u_b, v_b, w_b))
        return ct

    def decrypt(self, sk: "SecretKey", ct: "Ciphertext") -> Optional[bytes]:
        import ctypes

        n = len(ct.v)
        out = (ctypes.c_uint8 * n)()
        ok = self._lib.hbe_kem_decrypt(
            (ctypes.c_uint8 * 32).from_buffer_copy(ct.u.value.to_bytes(32, "big")),
            (ctypes.c_uint8 * n).from_buffer_copy(ct.v) if n else None,
            n,
            (ctypes.c_uint8 * 32).from_buffer_copy(ct.w.value.to_bytes(32, "big")),
            (ctypes.c_uint8 * 32).from_buffer_copy(sk.x.to_bytes(32, "big")),
            out,
        )
        object.__setattr__(ct, "_verify_ok", bool(ok))
        return bytes(out) if ok else None

    # -- vectorized Lagrange combines (round 6) ------------------------
    #
    # One C call for the whole Lagrange sum (hbe_scalar_interp_sum /
    # hbe_scalar_combine_unmask mirror crypto/poly.py interpolate and
    # the kem kdf framing exactly) — the per-batch threshold combines
    # are part of the era-change Python tail.  Callers validate the
    # share shapes; a None return means "fall back to the pure path".

    def _xs_ys(self, idxs: Any, values: Any) -> Optional[tuple]:
        import ctypes

        # Explicit int32 bound: ctypes c_int32 arrays silently TRUNCATE
        # oversized Python ints (no OverflowError), which would hand the
        # C Lagrange a wrong-but-positive evaluation point and return a
        # silently wrong combine instead of falling back.
        if any(
            isinstance(i, bool) or not isinstance(i, int)
            or i < 0 or i + 1 >= (1 << 31)
            for i in idxs
        ):
            return None
        xs = (ctypes.c_int32 * len(idxs))(*[i + 1 for i in idxs])
        ys = b"".join(v.to_bytes(32, "big") for v in values)
        return xs, ys

    def combine_at_zero(self, idxs: Any, values: Any) -> Optional[int]:
        """sum_i lam_i * values[i] interpolated at 0 over x_i = i + 1
        (the scalar combine_signatures kernel)."""
        import ctypes

        prep = self._xs_ys(idxs, values)
        if prep is None:
            return None
        xs, ys = prep
        counts = (ctypes.c_int32 * 1)(len(idxs))
        out = (ctypes.c_uint8 * 32)()
        ok = int(
            self._lib.hbe_scalar_interp_sum(xs, ys, counts, 1, self._r_be, out)
        )
        return int.from_bytes(bytes(out), "big") if ok else None

    def combine_unmask(self, idxs: Any, values: Any, v: bytes) -> Optional[bytes]:
        """Lagrange-combine decryption shares and unmask ``v`` in one C
        call (combine + kdf + xor; the combine_decryption_shares
        kernel)."""
        import ctypes

        prep = self._xs_ys(idxs, values)
        if prep is None:
            return None
        xs, ys = prep
        out = (ctypes.c_uint8 * len(v))()
        ok = int(
            self._lib.hbe_scalar_combine_unmask(
                xs, len(idxs), ys, self._r_be, v, len(v), out
            )
        )
        return bytes(out) if ok else None

    def share_values(self, idxs: Any, shares: Any, attr: str) -> Optional[list]:
        """The int group-element values of ``shares[i].<attr>`` for the
        chosen indices — None unless every one is a well-formed scalar
        element of this suite (the fast-path admission check)."""
        vals = []
        for i in idxs:
            if isinstance(i, bool) or not isinstance(i, int) or i < 0:
                return None
            g = getattr(shares[i], attr, None)
            if (
                type(g) is not self._g_type
                or not isinstance(getattr(g, "value", None), int)
                or getattr(g, "modulus", None) != self._mod
                or not 0 <= g.value < self._mod
            ):
                return None
            vals.append(g.value)
        return vals


def dkg_batch_enabled() -> bool:
    """THE kill switch for every round-6 batch-plane fast path — the
    sync_key_gen predigest / vectorized generate AND the scalar
    combines here — so one env var (HBBFT_TORCH_DKG_BATCH=0) A/Bs the
    whole plane against the per-item round-5 behavior.  Single
    definition; sync_key_gen imports it."""
    return os.environ.get("HBBFT_TORCH_DKG_BATCH", "1") != "0"


_native_combine_enabled = dkg_batch_enabled


_KEM_CACHE: Dict[Any, Optional[_ScalarKem]] = {}


def _scalar_kem(suite: Suite) -> Optional[_ScalarKem]:
    if suite.name != "scalar-insecure":
        return None
    kem = _KEM_CACHE.get(suite.name, False)
    if kem is not False:
        return kem
    try:
        from hbbft_tpu_torch import native_engine

        lib = native_engine.get_lib()
        kem = _ScalarKem(lib, suite) if lib is not None else None
    except Exception as exc:
        # Perf path only — the pure-Python KEM is always correct — but
        # the miss is permanent for the process, so say it once.
        warnings.warn(
            f"native KEM unavailable, using the pure-Python path: {exc!r}",
            RuntimeWarning,
            stacklevel=2,
        )
        kem = None
    _KEM_CACHE[suite.name] = kem
    return kem
