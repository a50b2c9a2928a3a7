"""Pluggable ``CryptoBackend``: batch verification of the hot pairing checks.

This is the north-star interface (BASELINE.json:5): protocols accumulate
signature-share / decryption-share / ciphertext verifications and a flush
verifies them as one batch.  Backends:

* :class:`EagerBackend` — per-item pairing checks via the suite (oracle).
* :class:`BatchedBackend` — random-linear-combination collapsing: all
  shares over the same message/ciphertext cost **two** pairings total; on
  aggregate failure it bisects to isolate the bad items (standard batch
  verification with fallback).
* ``TorchBackend`` (:mod:`hbbft_tpu_torch.crypto.device.backend`) — same RLC
  algebra with scalar mults and Miller loops as batched PyTorch on the card.

RLC coefficients are derived deterministically by Fiat-Shamir hashing of
the whole batch, so runs are reproducible and an adversary cannot predict
coefficients before committing to its shares.

Reference behavior being replaced: eager inline ``verify`` calls in
upstream ``src/threshold_sign.rs`` / ``src/threshold_decrypt.rs``.
"""

from __future__ import annotations

import abc
import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

from hbbft_tpu_torch.crypto.keys import Ciphertext, DecryptionShare, PublicKeyShare, SignatureShare
from hbbft_tpu_torch.crypto.suite import Suite
from hbbft_tpu_torch.utils import canonical_bytes

SIG_SHARE = "sig_share"
DEC_SHARE = "dec_share"
CIPHERTEXT = "ciphertext"


@dataclass(frozen=True)
class VerifyRequest:
    """One deferred verification.

    kind == SIG_SHARE:  payload = (pk_share, msg_bytes, SignatureShare)
    kind == DEC_SHARE:  payload = (pk_share, Ciphertext, DecryptionShare)
    kind == CIPHERTEXT: payload = (Ciphertext,)
    """

    kind: str
    payload: Tuple[Any, ...]

    @staticmethod
    def sig_share(pk_share: PublicKeyShare, msg: bytes, share: SignatureShare) -> "VerifyRequest":
        return VerifyRequest(SIG_SHARE, (pk_share, msg, share))

    @staticmethod
    def dec_share(pk_share: PublicKeyShare, ct: Ciphertext, share: DecryptionShare) -> "VerifyRequest":
        return VerifyRequest(DEC_SHARE, (pk_share, ct, share))

    @staticmethod
    def ciphertext(ct: Ciphertext) -> "VerifyRequest":
        return VerifyRequest(CIPHERTEXT, (ct,))


class CryptoBackend(abc.ABC):
    """Verifies a batch of requests, returning one bool per request."""

    #: True for a backend whose flush runs the port's device path.  Such
    #: a flush that raises is a fault to report: the crypto plane passes
    #: it on to its callers and never re-verifies on the host.
    on_device: bool = False

    @abc.abstractmethod
    def verify_batch(self, reqs: Sequence[VerifyRequest]) -> List[bool]: ...


def request_well_formed(
    suite: Suite, req: VerifyRequest, subgroup: bool = True
) -> bool:
    """Structural validation of a request built from wire data.

    Byzantine peers can put arbitrary objects where group elements belong;
    anything that fails this check verifies as False instead of crashing
    the batch.  Full (subgroup) membership checks run only on the
    *wire-sourced* element of each request — the share itself, or the
    ciphertext points of a CIPHERTEXT check.  The public-key share is
    always derived locally from ``NetworkInfo`` and the ciphertext of a
    DEC_SHARE request was already vetted by a prior CIPHERTEXT request
    (``ThresholdDecrypt`` gates share submission on ciphertext validity),
    so those get the cheap structural check.

    ``subgroup=False`` skips the torsion checks entirely (on-curve and
    structure only) — for backends that run the subgroup checks
    themselves, batched on device (``TorchBackend``).  A host subgroup
    check costs one 255-bit scalar multiplication in Python PER REQUEST
    and dominates the whole flush otherwise.
    """
    if req.kind not in (SIG_SHARE, DEC_SHARE, CIPHERTEXT):
        raise ValueError(f"unknown request kind {req.kind!r}")  # local bug
    try:
        if req.kind == SIG_SHARE:
            pk, msg, share = req.payload
            return (
                isinstance(pk, PublicKeyShare)
                and suite.is_g1(pk.g1, check_subgroup=False)
                and isinstance(msg, bytes)
                and isinstance(share, SignatureShare)
                and suite.is_g2(share.g2, check_subgroup=subgroup)
            )
        if req.kind == DEC_SHARE:
            pk, ct, share = req.payload
            return (
                isinstance(pk, PublicKeyShare)
                and suite.is_g1(pk.g1, check_subgroup=False)
                and _ciphertext_well_formed(suite, ct, check_subgroup=False)
                and isinstance(share, DecryptionShare)
                and suite.is_g1(share.g1, check_subgroup=subgroup)
            )
        (ct,) = req.payload
        return _ciphertext_well_formed(suite, ct, check_subgroup=subgroup)
    except Exception:
        return False


def _ciphertext_well_formed(
    suite: Suite, ct: Any, check_subgroup: bool = True
) -> bool:
    return (
        isinstance(ct, Ciphertext)
        and suite.is_g1(ct.u, check_subgroup=check_subgroup)
        and isinstance(ct.v, bytes)
        and suite.is_g2(ct.w, check_subgroup=check_subgroup)
    )


class EagerBackend(CryptoBackend):
    """Per-item verification through the suite — the trusted slow path."""

    def __init__(self, suite: Suite) -> None:
        self.suite = suite

    def verify_batch(self, reqs: Sequence[VerifyRequest]) -> List[bool]:
        out = []
        for r in reqs:
            if not request_well_formed(self.suite, r):
                out.append(False)
            elif r.kind == SIG_SHARE:
                pk, msg, share = r.payload
                out.append(pk.verify_share(msg, share))
            elif r.kind == DEC_SHARE:
                pk, ct, share = r.payload
                out.append(pk.verify_decryption_share(ct, share))
            else:
                (ct,) = r.payload
                out.append(ct.verify())
        return out


def _warm_affine_caches(suite: Suite, reqs: Sequence[VerifyRequest]) -> None:
    """Batch-invert all points about to be serialized (one inversion per
    group instead of two ``pow(·, -1, p)`` per request)."""
    batch_affine = getattr(suite, "batch_affine", None)
    if batch_affine is None:
        return
    pts = []
    for r in reqs:
        for obj in r.payload:
            for attr in ("g1", "g2", "u", "w"):
                v = getattr(obj, attr, None)
                if v is not None:
                    pts.append(v)
    try:
        batch_affine(pts)
    except Exception:
        pass  # fall back to lazy per-element conversion


def _batch_coefficients(suite: Suite, reqs: Sequence[VerifyRequest]) -> List[int]:
    """Deterministic Fiat-Shamir RLC coefficients in [1, 2^128)."""
    _warm_affine_caches(suite, reqs)
    parts = []
    for r in reqs:
        if r.kind == SIG_SHARE:
            pk, msg, share = r.payload
            parts.append(canonical_bytes(r.kind, pk.to_bytes(), msg, share.to_bytes()))
        elif r.kind == DEC_SHARE:
            pk, ct, share = r.payload
            parts.append(canonical_bytes(r.kind, pk.to_bytes(), ct.to_bytes(), share.to_bytes()))
        else:
            (ct,) = r.payload
            parts.append(canonical_bytes(r.kind, ct.to_bytes()))
    seed = hashlib.sha3_256(canonical_bytes(b"rlc", *parts)).digest()
    coeffs = []
    for i in range(len(reqs)):
        h = hashlib.sha3_256(seed + i.to_bytes(8, "big")).digest()
        coeffs.append((int.from_bytes(h[:16], "big") | 1))  # odd => nonzero
    return coeffs


def _rlc_pairs(
    suite: Suite, reqs: Sequence[VerifyRequest], coeffs: Sequence[int]
) -> List[Tuple[Any, Any]]:
    """Build the pairing-product-==-1 pair list for an RLC'd batch.

    Per item (with random r):
      sig_share:  e(G1, r*sigma) * e(-r*pk, H2(msg))          == 1
      dec_share:  e(r*w,  H2(ct)) * e(-r*pk, W)               == 1
      ciphertext: e(G1, r*W) * e(-r*U, H2(ct))                == 1

    G1-generator legs, same-message/-ciphertext H2 legs, and same-W legs
    are collapsed, so k same-message sig shares (or k shares on one
    ciphertext) cost 2 pairings, not 2k.  Hash-to-curve runs once per
    distinct message/ciphertext.
    """
    g1 = suite.g1_generator()
    gen_leg = None  # sum over G2 of everything paired with the G1 generator
    by_hash_g2: Dict[bytes, Tuple[Any, Any]] = {}  # key -> (accum G1, H2 point)
    by_w_leg: Dict[bytes, Tuple[Any, Any]] = {}  # ct key -> (accum G1, W point)

    def add_gen_leg(g2elem: Any) -> None:
        nonlocal gen_leg
        gen_leg = g2elem if gen_leg is None else gen_leg + g2elem

    def add_hashed_leg(key: bytes, g1elem: Any, hash_input: bytes) -> None:
        if key in by_hash_g2:
            acc, h = by_hash_g2[key]
            by_hash_g2[key] = (acc + g1elem, h)
        else:
            by_hash_g2[key] = (g1elem, suite.hash_to_g2(hash_input))

    def add_w_leg(key: bytes, g1elem: Any, w: Any) -> None:
        if key in by_w_leg:
            acc, _ = by_w_leg[key]
            by_w_leg[key] = (acc + g1elem, w)
        else:
            by_w_leg[key] = (g1elem, w)

    for r, c in zip(reqs, coeffs):
        if r.kind == SIG_SHARE:
            pk, msg, share = r.payload
            add_gen_leg(share.g2 * c)
            add_hashed_leg(canonical_bytes(b"m", msg), -(pk.g1 * c), msg)
        elif r.kind == DEC_SHARE:
            pk, ct, share = r.payload
            key = canonical_bytes(b"c", ct.hash_input())
            add_hashed_leg(key, share.g1 * c, ct.hash_input())
            # W is determined by (U, V) for *valid* ciphertexts, but key on W
            # itself so shares of two conflicting ciphertexts never mix.
            add_w_leg(canonical_bytes(b"w", ct.w.to_bytes()), -(pk.g1 * c), ct.w)
        else:
            (ct,) = r.payload
            key = canonical_bytes(b"c", ct.hash_input())
            add_gen_leg(ct.w * c)
            add_hashed_leg(key, -(ct.u * c), ct.hash_input())

    pairs: List[Tuple[Any, Any]] = []
    if gen_leg is not None:
        pairs.append((g1, gen_leg))
    pairs.extend((acc, h) for acc, h in by_hash_g2.values())
    pairs.extend((acc, w) for acc, w in by_w_leg.values())
    return pairs


def default_backend(suite: Suite) -> CryptoBackend:
    """The backend an entry point builds when its caller names none: the
    card's ``TorchBackend`` for BLS (on ``cuda``, which raises with no
    card), :class:`BatchedBackend` for a suite with no device path."""
    from hbbft_tpu_torch.crypto.bls.suite import BLSSuite

    if isinstance(suite, BLSSuite):
        from hbbft_tpu_torch.crypto.device.backend import TorchBackend

        return TorchBackend(suite)
    return BatchedBackend(suite)


class BatchedBackend(CryptoBackend):
    """RLC batch verification with bisection fallback on failure."""

    def __init__(self, suite: Suite) -> None:
        self.suite = suite
        self._eager = EagerBackend(suite)

    def verify_batch(self, reqs: Sequence[VerifyRequest]) -> List[bool]:
        reqs = list(reqs)
        if not reqs:
            return []
        out = [False] * len(reqs)
        # Malformed requests fail immediately and never enter the RLC
        # algebra (where arbitrary objects could raise mid-aggregation).
        idxs = [
            i for i, r in enumerate(reqs) if request_well_formed(self.suite, r)
        ]
        self._verify_range(reqs, idxs, out)
        return out

    def _aggregate_ok(self, reqs: Sequence[VerifyRequest]) -> bool:
        coeffs = _batch_coefficients(self.suite, reqs)
        pairs = _rlc_pairs(self.suite, reqs, coeffs)
        return self.suite.pairing_product_is_one(pairs)

    def _verify_range(
        self, all_reqs: List[VerifyRequest], idxs: List[int], out: List[bool]
    ) -> None:
        if not idxs:
            return
        sub = [all_reqs[i] for i in idxs]
        if self._aggregate_ok(sub):
            for i in idxs:
                out[i] = True
            return
        if len(idxs) == 1:
            out[idxs[0]] = self._eager.verify_batch(sub)[0]
            return
        mid = len(idxs) // 2
        self._verify_range(all_reqs, idxs[:mid], out)
        self._verify_range(all_reqs, idxs[mid:], out)
