"""SyncKeyGen: dealerless distributed key generation (DKG).

Reference: upstream ``src/sync_key_gen.rs`` (SURVEY.md §2 #12) — fork
checkout empty at survey time, reconstructed from the upstream public
crate's documented scheme.

Scheme (Pedersen-style DKG over symmetric bivariate polynomials):

* Each proposer ``d`` deals a random *symmetric* bivariate polynomial
  ``p_d(x, y)`` of degree ``t`` in each variable and publishes a ``Part``:
  the :class:`~hbbft_tpu_torch.crypto.poly.BivarCommitment` plus, for each node
  ``m``, the row polynomial ``p_d(m+1, ·)`` encrypted to ``m``'s public
  key.
* A node ``m`` that receives a valid ``Part`` (its row matches the
  commitment) answers with an ``Ack`` carrying, for each node ``j``, the
  value ``p_d(m+1, j+1)`` encrypted to ``j``.  By symmetry this equals
  ``p_d(j+1, m+1)``, i.e. one evaluation point of ``j``'s row — so ``j``
  can reconstruct its secret even if the dealer equivocates or crashes
  after sending only some rows.
* A proposal is *complete* once ``2t+1`` nodes have acked it; key
  generation is *ready* once ``t+1`` proposals are complete.
* ``generate()``: the joint public-key commitment is the sum over
  complete proposals of the committed master row ``p_d(0, ·)``; node
  ``j``'s secret share is ``sum_d p_d(0, j+1)``, each term interpolated
  at ``x = 0`` from the ``t+1``-plus received evaluations
  ``p_d(m+1, j+1)``.

The synchronous-rounds assumption is satisfied by running the Part/Ack
exchange *through* consensus (DynamicHoneyBadger threads them through
committed batches, SURVEY.md §3.3), so every node processes the same
messages in the same order.  SyncKeyGen itself is a plain
message-in/outcome-out state machine with no Step/Target plumbing.

Copy of ``hbbft_tpu/protocols/sync_key_gen.py`` with its pure-Python
branches only: the reference's native scalar-suite DKG engine (registered
commitments, one-call ack and row checks, batch pre-digest of a committed
batch) is left out, so every check here is the reference's pure path,
which its own tests pin equal to the native one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

from hbbft_tpu_torch.crypto.keys import (
    Ciphertext,
    PublicKey,
    SecretKey,
    SecretKeyShare,
)
from hbbft_tpu_torch.crypto.poly import BivarCommitment, BivarPoly, Commitment, Poly, interpolate
from hbbft_tpu_torch.crypto.suite import Suite

FAULT_MULTIPLE_PARTS = "sync_key_gen:multiple-parts"
FAULT_BAD_PART = "sync_key_gen:invalid-part"
FAULT_BAD_ACK = "sync_key_gen:invalid-ack"
FAULT_UNKNOWN_SENDER = "sync_key_gen:unknown-sender"
FAULT_ACK_BEFORE_PART = "sync_key_gen:ack-without-part"

_SCALAR_BYTES = 32  # BLS12-381 r fits in 255 bits


def _encode_scalars(vals: Tuple[int, ...]) -> bytes:
    """Fixed-width canonical encoding — the decrypted plaintext is
    attacker-chosen, so no pickle here (arbitrary-object deserialization
    of Byzantine bytes would be code execution)."""
    return b"".join(v.to_bytes(_SCALAR_BYTES, "big") for v in vals)


def _decode_scalars(data: Any, count: int, modulus: int) -> Optional[Tuple[int, ...]]:
    if not isinstance(data, bytes) or len(data) != count * _SCALAR_BYTES:
        return None
    vals = tuple(
        int.from_bytes(data[i * _SCALAR_BYTES : (i + 1) * _SCALAR_BYTES], "big")
        for i in range(count)
    )
    if any(v >= modulus for v in vals):
        return None
    return vals


@dataclass(frozen=True)
class Part:
    """A dealer's contribution: commitment + per-node encrypted rows."""

    commitment: BivarCommitment
    rows: Tuple[Ciphertext, ...]  # rows[m] encrypts serde(row poly of node m)

    def __repr__(self) -> str:
        return f"Part(degree={self.commitment.degree}, rows={len(self.rows)})"


@dataclass(frozen=True)
class Ack:
    """Node's confirmation of a dealer's Part: per-node encrypted values."""

    proposer: Any
    values: Tuple[Ciphertext, ...]  # values[j] encrypts int p_d(our+1, j+1)

    def __repr__(self) -> str:
        return f"Ack(proposer={self.proposer!r}, values={len(self.values)})"


@dataclass(frozen=True)
class PartOutcome:
    """Result of handling a Part: an Ack to broadcast, or a fault."""

    ack: Optional[Ack] = None
    fault: Optional[str] = None

    @property
    def is_valid(self) -> bool:
        return self.fault is None


@dataclass(frozen=True)
class AckOutcome:
    fault: Optional[str] = None

    @property
    def is_valid(self) -> bool:
        return self.fault is None


class _ProposalState:
    """Per-dealer accumulation (upstream ``ProposalState``)."""

    def __init__(self, commitment: BivarCommitment) -> None:
        self.commitment = commitment
        # Evaluation point (m+1) -> value p_d(m+1, our+1) == p_d(our+1, m+1).
        self.values: Dict[int, int] = {}
        self.acks: Set[int] = set()  # node indices that acked

    def is_complete(self, threshold: int) -> bool:
        return len(self.acks) > 2 * threshold


class SyncKeyGen:
    """One node's view of a DKG among ``pub_keys``' owners.

    Construct via :meth:`new`, which also returns our ``Part`` to be
    disseminated (``None`` for observers).
    """

    def __init__(
        self,
        our_id: Any,
        secret_key: SecretKey,
        pub_keys: Dict[Any, PublicKey],
        threshold: int,
        suite: Suite,
    ) -> None:
        self.our_id = our_id
        self.secret_key = secret_key
        self.pub_keys = dict(pub_keys)
        self.threshold = threshold
        self.suite = suite
        self._ids: List[Any] = sorted(pub_keys)
        self._index = {n: i for i, n in enumerate(self._ids)}
        self.proposals: Dict[Any, _ProposalState] = {}

    # -- construction --------------------------------------------------
    @staticmethod
    def new(
        our_id: Any,
        secret_key: SecretKey,
        pub_keys: Dict[Any, PublicKey],
        threshold: int,
        rng: Any,
        suite: Suite,
    ) -> Tuple["SyncKeyGen", Optional[Part]]:
        skg = SyncKeyGen(our_id, secret_key, pub_keys, threshold, suite)
        if our_id not in skg._index:
            return skg, None  # observer: no contribution
        poly = BivarPoly.random(threshold, rng, suite.scalar_modulus)
        commitment = poly.commitment(suite)
        rows = tuple(
            pub_keys[n].encrypt(_encode_scalars(poly.row(m + 1).coeffs), rng)
            for m, n in enumerate(skg._ids)
        )
        return skg, Part(commitment, rows)

    # -- introspection -------------------------------------------------
    @property
    def our_index(self) -> Optional[int]:
        return self._index.get(self.our_id)

    def is_node_ready(self, proposer: Any) -> bool:
        state = self.proposals.get(proposer)
        return state is not None and state.is_complete(self.threshold)

    def count_complete(self) -> int:
        return sum(
            1 for s in self.proposals.values() if s.is_complete(self.threshold)
        )

    def is_ready(self) -> bool:
        """Enough complete proposals to generate the joint key."""
        return self.count_complete() > self.threshold

    # -- message handling ----------------------------------------------
    #
    # CRITICAL invariant: whether a Part is *accepted* and whether an Ack
    # is *counted* must depend only on PUBLICLY visible data (the message
    # bytes every node sees in the same consensus order) — never on data
    # only we can decrypt.  Otherwise a Byzantine dealer/acker could
    # corrupt one node's encrypted slot and make the proposal/ack sets —
    # and hence the generated keys — diverge across nodes.  Failures of
    # the *private* checks are reported as faults but do not affect
    # acceptance/counting.

    def handle_part(self, sender: Any, part: Part, rng: Any) -> PartOutcome:
        if sender not in self._index:
            return PartOutcome(fault=FAULT_UNKNOWN_SENDER)
        if not self._part_shape_ok(part):  # public check
            return PartOutcome(fault=FAULT_BAD_PART)
        existing = self.proposals.get(sender)
        if existing is not None:
            if existing.commitment == part.commitment:
                return PartOutcome()  # duplicate: ignore
            return PartOutcome(fault=FAULT_MULTIPLE_PARTS)
        self.proposals[sender] = _ProposalState(part.commitment)

        our_idx = self.our_index
        if our_idx is None:
            return PartOutcome()  # observer: track commitment only

        # Private check: our encrypted row.  On failure the proposal stays
        # tracked (others' acks can still complete it and recover our
        # share); we just cannot ack it ourselves.
        row = self._decrypt_row(part, our_idx)
        if row is None:
            return PartOutcome(fault=FAULT_BAD_PART)
        values = tuple(
            self.pub_keys[n].encrypt(
                _encode_scalars((row.eval(j + 1),)), rng
            )
            for j, n in enumerate(self._ids)
        )
        return PartOutcome(ack=Ack(sender, values))

    def handle_ack(self, sender: Any, ack: Ack) -> AckOutcome:
        if sender not in self._index:
            return AckOutcome(fault=FAULT_UNKNOWN_SENDER)
        if not self._ack_shape_ok(ack):  # public check
            return AckOutcome(fault=FAULT_BAD_ACK)
        try:
            state = self.proposals.get(ack.proposer)
        except TypeError:  # unhashable garbage proposer
            state = None
        if state is None:
            # Part/Ack ordering is guaranteed by consensus; an ack for an
            # unknown proposal is Byzantine (or the proposer never dealt).
            return AckOutcome(fault=FAULT_ACK_BEFORE_PART)
        sender_idx = self._index[sender]
        if sender_idx in state.acks:
            return AckOutcome()  # duplicate: ignore
        # All public checks passed: the ack COUNTS at every node, even if
        # the value encrypted to us turns out bad (see invariant above).
        state.acks.add(sender_idx)

        our_idx = self.our_index
        if our_idx is None:
            return AckOutcome()
        val = self._decrypt_value(ack, our_idx)
        if val is not None:
            # Private consistency: v must equal p_d(sender+1, our+1); check
            # in the group against the committed row of the sender.
            expected = state.commitment.row(sender_idx + 1).eval(our_idx + 1)
            actual = self.suite.g1_generator() * val
            if expected.to_bytes() != actual.to_bytes():
                val = None
        if val is None:
            return AckOutcome(fault=FAULT_BAD_ACK)
        state.values[sender_idx + 1] = val
        return AckOutcome()

    # -- key derivation ------------------------------------------------
    def generate(self) -> Tuple["PublicKeySet", Optional[SecretKeyShare]]:
        """Derive the joint keys from the complete proposals.

        Deterministic across nodes: the proposal set and ack sets are
        identical everywhere because Part/Ack ordering came through
        consensus.
        """
        from hbbft_tpu_torch.crypto.keys import PublicKeySet

        complete = [
            (d, s)
            for d, s in sorted(self.proposals.items(), key=lambda kv: str(kv[0]))
            if s.is_complete(self.threshold)
        ]
        if len(complete) <= self.threshold:
            raise RuntimeError(
                f"not ready: {len(complete)} complete proposals, "
                f"need {self.threshold + 1}"
            )
        commitment: Optional[Commitment] = None
        for _, s in complete:
            row0 = s.commitment.row(0)
            commitment = row0 if commitment is None else commitment + row0
        pk_set = PublicKeySet(commitment, self.suite)

        our_idx = self.our_index
        if our_idx is None:
            return pk_set, None
        modulus = self.suite.scalar_modulus
        groups: List[List[Tuple[int, int]]] = []
        for d, s in complete:
            pts = sorted(s.values.items())[: self.threshold + 1]
            if len(pts) <= self.threshold:
                raise RuntimeError(
                    f"proposal {d!r} complete but only {len(pts)} values known"
                )
            groups.append(pts)
        secret = 0
        for pts in groups:
            secret = (secret + interpolate(pts, modulus)) % modulus
        return pk_set, SecretKeyShare(secret, self.suite)

    # -- internals -----------------------------------------------------
    def _shape_memo_key(self) -> tuple:
        # The verdict depends only on public data + these parameters, so
        # it can be cached on the (shared, immutable) message object —
        # at churn every node re-validates the same decoded Part/Ack
        # otherwise (N^3 ciphertext checks network-wide).
        return (self.threshold, len(self._ids), self.suite.name)

    def _part_shape_ok(self, part: Any) -> bool:
        """Public structural validation (fields may be arbitrary objects)."""
        from hbbft_tpu_torch.crypto.backend import _ciphertext_well_formed

        key = self._shape_memo_key()
        try:
            cached = part.__dict__.get("_shape_ok")
            if cached is not None and cached[0] == key:
                return cached[1]
        except Exception:
            cached = None
        ok = self._part_shape_ok_uncached(part, _ciphertext_well_formed)
        try:
            object.__setattr__(part, "_shape_ok", (key, ok))
        except Exception:
            pass
        return ok

    def _part_shape_ok_uncached(self, part: Any, _ciphertext_well_formed) -> bool:
        try:
            n1 = self.threshold + 1
            return (
                isinstance(part, Part)
                and isinstance(part.commitment, BivarCommitment)
                and isinstance(part.commitment.elems, tuple)
                and len(part.commitment.elems) == n1
                and all(
                    isinstance(row, tuple)
                    and len(row) == n1
                    and all(self.suite.is_g1(e) for e in row)
                    for row in part.commitment.elems
                )
                and isinstance(part.rows, tuple)
                and len(part.rows) == len(self._ids)
                and all(_ciphertext_well_formed(self.suite, c) for c in part.rows)
            )
        except Exception:
            return False

    def _ack_shape_ok(self, ack: Any) -> bool:
        from hbbft_tpu_torch.crypto.backend import _ciphertext_well_formed

        key = self._shape_memo_key()
        try:
            cached = ack.__dict__.get("_shape_ok")
            if cached is not None and cached[0] == key:
                return cached[1]
        except Exception:
            cached = None
        ok = self._ack_shape_ok_uncached(ack, _ciphertext_well_formed)
        try:
            object.__setattr__(ack, "_shape_ok", (key, ok))
        except Exception:
            pass
        return ok

    def _ack_shape_ok_uncached(self, ack: Any, _ciphertext_well_formed) -> bool:
        try:
            return (
                isinstance(ack, Ack)
                and isinstance(ack.values, tuple)
                and len(ack.values) == len(self._ids)
                and all(_ciphertext_well_formed(self.suite, c) for c in ack.values)
            )
        except Exception:
            return False

    def _decrypt_row(self, part: Part, our_idx: int) -> Optional[Poly]:
        try:
            data = self.secret_key.decrypt(part.rows[our_idx])
        except Exception:
            data = None
        if data is None:
            return None
        coeffs = _decode_scalars(
            data, self.threshold + 1, self.suite.scalar_modulus
        )
        if coeffs is None:
            return None
        row = Poly(coeffs, self.suite.scalar_modulus)
        # Validate the row against the public commitment.
        committed = part.commitment.row(our_idx + 1)
        ours = row.commitment(self.suite)
        if committed.to_bytes() != ours.to_bytes():
            return None
        return row

    def _decrypt_value(self, ack: Ack, our_idx: int) -> Optional[int]:
        try:
            data = self.secret_key.decrypt(ack.values[our_idx])
        except Exception:
            data = None
        if data is None:
            return None
        vals = _decode_scalars(data, 1, self.suite.scalar_modulus)
        return None if vals is None else vals[0]
