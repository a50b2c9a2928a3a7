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

Copy of ``hbbft_tpu/protocols/sync_key_gen.py``, with its native
scalar-suite DKG (registered commitments, one-call ack and row checks,
batch pre-digest of a committed batch) over
:mod:`hbbft_tpu_torch.native_engine`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

from hbbft_tpu_torch.crypto.keys import (
    Ciphertext,
    PublicKey,
    SecretKey,
    SecretKeyShare,
    dkg_batch_enabled,
)
from hbbft_tpu_torch.crypto.poly import BivarCommitment, BivarPoly, Commitment, Poly, interpolate
from hbbft_tpu_torch.crypto.suite import Suite

FAULT_MULTIPLE_PARTS = "sync_key_gen:multiple-parts"
FAULT_BAD_PART = "sync_key_gen:invalid-part"
FAULT_BAD_ACK = "sync_key_gen:invalid-ack"
FAULT_UNKNOWN_SENDER = "sync_key_gen:unknown-sender"
FAULT_ACK_BEFORE_PART = "sync_key_gen:ack-without-part"

_SCALAR_BYTES = 32  # BLS12-381 r fits in 255 bits


class _NativeDkg:
    """Scalar-suite fast path for the DKG's N^3 private checks.

    The committed-ack value check (KEM decrypt + commitment row eval +
    compare) and the ack-row construction (poly evals + N encrypts) are
    the measured Python tail of an era change (BASELINE.md round-4/5).
    native/engine.cpp exposes them as single C calls over a registered
    commitment matrix; semantics are byte-identical to the pure path
    (same KEM, same Horner, same fault outcomes — the native engine
    equivalence suites pin this end to end), and ANY mismatch in shape,
    suite, or registry routing falls back to the pure-Python path.
    """

    def __init__(self, lib: Any, suite: Suite) -> None:
        import ctypes

        self._ctypes = ctypes
        self._lib = lib
        self._suite = suite
        self._g = suite.g1_generator().to_bytes()
        self._r = suite.scalar_modulus.to_bytes(_SCALAR_BYTES, "big")
        from hbbft_tpu_torch.crypto.keys import _scalar_kem

        self.kem = _scalar_kem(suite)

    def commit_id(self, commitment: Any) -> int:
        """Register (once, memoized on the shared decoded object)."""
        cached = commitment.__dict__.get("_native_cid")
        if cached is not None:
            return cached
        try:
            flat = b"".join(
                e.value.to_bytes(_SCALAR_BYTES, "big")
                for row in commitment.elems
                for e in row
            )
            cid = int(
                self._lib.hbe_dkg_register(
                    flat, len(commitment.elems), self._g, self._r
                )
            )
        except Exception:
            cid = -1
        object.__setattr__(commitment, "_native_cid", cid)
        return cid

    def refresh_commit_id(self, commitment: Any) -> int:
        """Drop a STALE memoized cid and re-register once (ADVICE round
        5): after a registry generation bump (byte-cap clear) every
        still-live commitment's memo returns -1 from the checks forever
        — correct but permanently stranded on the slow path.  Called on
        an rc == -1 from ack/row checks; the caller retries once with
        the fresh cid and falls back if that one misses too."""
        commitment.__dict__.pop("_native_cid", None)
        return self.commit_id(commitment)

    def ack_check(
        self, cid: int, sender_pos: int, our_pos: int, ct: Any, sk_x: int
    ) -> Tuple[int, int]:
        """(rc, value): rc 1 ok, 2 bad value, 0 bad ciphertext, -1 fall
        back."""
        out = (self._ctypes.c_uint8 * _SCALAR_BYTES)()
        rc = int(
            self._lib.hbe_dkg_ack_check(
                cid, sender_pos, our_pos,
                ct.u.value.to_bytes(_SCALAR_BYTES, "big"), ct.v,
                ct.w.value.to_bytes(_SCALAR_BYTES, "big"),
                sk_x.to_bytes(_SCALAR_BYTES, "big"), out,
            )
        )
        return rc, int.from_bytes(bytes(out), "big")

    def row_check(self, cid: int, our_pos: int, plain: bytes, n1: int) -> int:
        return int(self._lib.hbe_dkg_row_check(cid, our_pos, plain, n1))

    def ack_check_batch(
        self, items: list, our_pos: int, sk_x: int
    ) -> Optional[list]:
        """One C call for a whole batch's ack checks.

        ``items``: ``(cid, sender_pos, ct)`` triples; returns a matching
        ``[(rc, value)]`` list with per-item rc identical to
        :meth:`ack_check`, or None when the native call itself is
        unusable (caller falls back per item)."""
        ctypes = self._ctypes
        n = len(items)
        cids = (ctypes.c_int64 * n)(*[c for c, _, _ in items])
        spos = (ctypes.c_int32 * n)(*[s for _, s, _ in items])
        u = b"".join(
            ct.u.value.to_bytes(_SCALAR_BYTES, "big") for _, _, ct in items
        )
        v = b"".join(ct.v for _, _, ct in items)
        w = b"".join(
            ct.w.value.to_bytes(_SCALAR_BYTES, "big") for _, _, ct in items
        )
        rcs = (ctypes.c_int32 * n)()
        vals = (ctypes.c_uint8 * (_SCALAR_BYTES * n))()
        ok = int(
            self._lib.hbe_dkg_ack_check_batch(
                cids, spos, n, our_pos, u, v, w,
                sk_x.to_bytes(_SCALAR_BYTES, "big"), rcs, vals,
            )
        )
        if not ok:
            return None
        vb = bytes(vals)
        return [
            (
                int(rcs[i]),
                int.from_bytes(
                    vb[_SCALAR_BYTES * i : _SCALAR_BYTES * (i + 1)], "big"
                ),
            )
            for i in range(n)
        ]

    def part_check_batch(
        self, items: list, our_pos: int, n1: int, sk_x: int
    ) -> Optional[list]:
        """One C call for a batch of Part row checks (decrypt our row +
        decode + commitment consistency).  ``items``: ``(cid, ct)``
        pairs whose ``ct.v`` is exactly ``n1 * 32`` bytes; returns
        ``[(rc, row_plain_bytes)]`` (rc 1 ok / 2 fault / 0 bad ct /
        -1 fall back), or None."""
        ctypes = self._ctypes
        n = len(items)
        vlen = n1 * _SCALAR_BYTES
        cids = (ctypes.c_int64 * n)(*[c for c, _ in items])
        u = b"".join(
            ct.u.value.to_bytes(_SCALAR_BYTES, "big") for _, ct in items
        )
        v = b"".join(ct.v for _, ct in items)
        w = b"".join(
            ct.w.value.to_bytes(_SCALAR_BYTES, "big") for _, ct in items
        )
        rcs = (ctypes.c_int32 * n)()
        rows = (ctypes.c_uint8 * (vlen * n))()
        ok = int(
            self._lib.hbe_dkg_part_check_batch(
                cids, n, our_pos, u, v, w, n1,
                sk_x.to_bytes(_SCALAR_BYTES, "big"), rcs, rows,
            )
        )
        if not ok:
            return None
        rb = bytes(rows)
        return [
            (int(rcs[i]), rb[vlen * i : vlen * (i + 1)]) for i in range(n)
        ]

    def interp_sum(self, groups: list) -> Optional[int]:
        """sum over groups of interpolate_at_0(points) mod r in one C
        call (the vectorized Lagrange entry; mirrors poly.interpolate).
        ``groups``: lists of ``(x, y)`` int points.  None = fall back."""
        ctypes = self._ctypes
        xs: list = []
        ys: list = []
        counts: list = []
        for pts in groups:
            counts.append(len(pts))
            for x, y in pts:
                xs.append(x)
                ys.append(y)
        # c_int32 arrays TRUNCATE oversized ints silently (no
        # OverflowError) — bound explicitly so a huge x falls back to
        # the Python oracle instead of interpolating at a wrong point.
        if any(
            isinstance(x, bool) or not isinstance(x, int)
            or x <= 0 or x >= (1 << 31)
            for x in xs
        ):
            return None
        xs_arr = (ctypes.c_int32 * len(xs))(*xs)
        counts_arr = (ctypes.c_int32 * len(counts))(*counts)
        ys_b = b"".join(y.to_bytes(_SCALAR_BYTES, "big") for y in ys)
        out = (ctypes.c_uint8 * _SCALAR_BYTES)()
        ok = int(
            self._lib.hbe_scalar_interp_sum(
                xs_arr, ys_b, counts_arr, len(counts), self._r, out
            )
        )
        if not ok:
            return None
        return int.from_bytes(bytes(out), "big")

    def ack_values(
        self, row: "Poly", pub_keys_g1: list, rng: Any
    ) -> Tuple["Ciphertext", ...]:
        """The ack's encrypted row evaluations, batched: one C call for
        the N poly evals and one for the N KEM encrypts.  The rng draws
        happen HERE in the exact per-encrypt order of the pure path
        (PublicKey.encrypt draws randrange(1, r) once per call), so the
        consumption stream — and every equivalence test — is unchanged.
        """
        ctypes = self._ctypes
        n = len(pub_keys_g1)
        mod = self._suite.scalar_modulus
        coeffs = b"".join(
            c.to_bytes(_SCALAR_BYTES, "big") for c in row.coeffs
        )
        evals = (ctypes.c_uint8 * (_SCALAR_BYTES * n))()
        self._lib.hbe_dkg_row_evals(coeffs, len(row.coeffs), n, evals)
        rs = b"".join(
            rng.randrange(1, mod).to_bytes(_SCALAR_BYTES, "big")
            for _ in range(n)
        )
        pks = b"".join(
            g.value.to_bytes(_SCALAR_BYTES, "big") for g in pub_keys_g1
        )
        out_u = (ctypes.c_uint8 * (_SCALAR_BYTES * n))()
        out_v = (ctypes.c_uint8 * (_SCALAR_BYTES * n))()
        out_w = (ctypes.c_uint8 * (_SCALAR_BYTES * n))()
        self._lib.hbe_kem_encrypt_batch(
            pks, bytes(evals), n, rs, out_u, out_v, out_w
        )
        from hbbft_tpu_torch.crypto.keys import scalar_ct_serde

        g_type = type(self._suite.g1_generator())
        u_b, v_b, w_b = bytes(out_u), bytes(out_v), bytes(out_w)
        cts = []
        for j in range(n):
            s = slice(_SCALAR_BYTES * j, _SCALAR_BYTES * (j + 1))
            ct = Ciphertext(
                g_type(int.from_bytes(u_b[s], "big"), mod),
                v_b[s],
                g_type(int.from_bytes(w_b[s], "big"), mod),
                self._suite,
            )
            object.__setattr__(ct, "_verify_ok", True)
            object.__setattr__(
                ct, "_serde_cache", scalar_ct_serde(u_b[s], v_b[s], w_b[s])
            )
            cts.append(ct)
        return tuple(cts)


_NATIVE_DKG: dict = {}

# Batch-digest observation counters (tests/benchmarks only; protocol
# logic NEVER reads these).  "items" = entries pre-digested, "hits" =
# entries consumed by handle_ack/_decrypt_row.
PREDIGEST_STATS = {"items": 0, "hits": 0}


# Kill switch for the round-6 batch-digest fast paths (predigest,
# vectorized generate/combine) — HBBFT_TORCH_DKG_BATCH=0 restores the
# per-item round-5 behavior for back-to-back A/B measurement.  Single
# definition in crypto.keys so the combines and the digest can never
# disagree about the switch.
_batch_dkg_enabled = dkg_batch_enabled


def _native_dkg(suite: Suite) -> Optional[_NativeDkg]:
    if suite.name != "scalar-insecure":
        return None
    nd = _NATIVE_DKG.get(suite.name, False)
    if nd is not False:
        return nd
    try:
        from hbbft_tpu_torch import native_engine

        lib = native_engine.get_lib()
        nd = _NativeDkg(lib, suite) if lib is not None else None
        if nd is not None and nd.kem is None:
            nd = None
    except Exception:
        nd = None
    _NATIVE_DKG[suite.name] = nd
    return nd


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
        # Batch-digested native check results, keyed by message object
        # identity (see predigest_batch); populated by the engine's
        # batch callback for the duration of ONE committed batch and
        # consumed by handle_part/handle_ack — empty in every other
        # driving mode, so the per-item paths are untouched.
        self._predigest: Dict[tuple, tuple] = {}

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

    # -- batch digest (native fast path) -------------------------------
    #
    # The engine's batch callback hands a whole committed batch of
    # key-gen messages to Python at once; the per-message native checks
    # (one C call per ack/part) were the measured 16M-cycle continuation
    # tail at era changes (CLAUDE.md round-5 envelope profile).  These
    # two methods batch ALL of a committed batch's private checks into
    # one C call per kind; handle_part/handle_ack then consume the
    # stored verdicts instead of re-deriving them.  Everything here is a
    # pure function of message bytes + our secret key — pre-computing
    # results for messages that later fail the public checks changes
    # nothing (the results are simply never consumed), so outputs stay
    # byte-identical by construction.  Any per-item native miss (stale
    # cid, shape mismatch, oversized slot) leaves no entry and the
    # consumer falls back to the existing per-item path, pure-Python
    # oracle last.

    def predigest_batch(self, msgs: Any) -> None:
        """Batch the private DKG checks for ``(sender, payload)`` pairs
        of one committed batch (payloads: Part | Ack, in batch order).

        The admission loop runs ~N^2 times per DKG batch per node, so it
        is written hot: locals pinned, the scalar-ciphertext type checks
        inlined (same predicates as ``_ScalarKem.ct_ok`` + the slot
        length), and any unexpected shape aborts the WHOLE digest via
        the enclosing try — the per-item paths then re-derive every
        verdict, so a Byzantine oddball costs speed, never correctness.
        """
        nd = _native_dkg(self.suite)
        our_idx = self.our_index
        if nd is None or our_idx is None or not _batch_dkg_enabled():
            return
        kem = nd.kem
        g_type = kem._g_type
        mod = kem._mod
        suite = self.suite
        index_get = self._index.get
        proposals_get = self.proposals.get
        predigest = self._predigest
        commit_id = nd.commit_id
        n1 = self.threshold + 1
        part_vlen = n1 * _SCALAR_BYTES
        ack_keys: List[tuple] = []
        ack_items: List[tuple] = []
        part_keys: List[tuple] = []
        part_items: List[tuple] = []
        try:
            for sender, payload in msgs:
                cls = payload.__class__
                if cls is Ack:
                    sender_idx = index_get(sender)
                    if sender_idx is None:
                        continue
                    # A part for this proposer handled LATER in the same
                    # batch is a digest miss; the per-item path covers it.
                    state = proposals_get(payload.proposer)
                    if state is None or sender_idx in state.acks:
                        continue
                    values = payload.values
                    if type(values) is not tuple or len(values) <= our_idx:
                        continue
                    ct = values[our_idx]
                    if type(ct) is not Ciphertext:
                        continue
                    u = ct.u
                    w = ct.w
                    v = ct.v
                    if (
                        type(u) is not g_type
                        or type(w) is not g_type
                        or type(v) is not bytes
                        or len(v) != _SCALAR_BYTES
                        or not 0 <= u.value < mod
                        or not 0 <= w.value < mod
                        or u.modulus != mod
                        or w.modulus != mod
                        or ct.suite != suite
                    ):
                        continue
                    key = ("ack", id(payload), sender_idx)
                    if key in predigest:
                        continue
                    cid = state.commitment.__dict__.get("_native_cid")
                    if cid is None:
                        cid = commit_id(state.commitment)
                    if cid < 0:
                        continue
                    ack_keys.append((key, payload))
                    ack_items.append((cid, sender_idx + 1, ct))
                elif cls is Part:
                    if index_get(sender) is None or sender in self.proposals:
                        continue
                    key = ("part", id(payload))
                    if key in predigest:
                        continue
                    rows = payload.rows
                    if type(rows) is not tuple or len(rows) <= our_idx:
                        continue
                    ct = rows[our_idx]
                    if not (
                        kem.ct_ok(ct) and len(ct.v) == part_vlen
                    ):
                        continue
                    cid = commit_id(payload.commitment)
                    if cid < 0:
                        continue
                    part_keys.append((key, payload))
                    part_items.append((cid, ct))
            sk_x = self.secret_key.x
            stored = 0
            if ack_items:
                res = nd.ack_check_batch(ack_items, our_idx + 1, sk_x)
                if res is not None:
                    for (key, payload), rv in zip(ack_keys, res):
                        if rv[0] >= 0:  # -1 (stale cid) = per-item miss
                            predigest[key] = (payload, rv[0], rv[1])
                            stored += 1
            if part_items:
                res = nd.part_check_batch(part_items, our_idx + 1, n1, sk_x)
                if res is not None:
                    for (key, payload), rv in zip(part_keys, res):
                        if rv[0] >= 0:
                            predigest[key] = (payload, rv[0], rv[1])
                            stored += 1
            PREDIGEST_STATS["items"] += stored
        except Exception:
            # Correctness never depends on the digest: drop everything
            # and let the per-item paths run.
            predigest.clear()

    def clear_predigest(self) -> None:
        """Drop all batch-digested results (end of the committed batch).
        Consumers fall back to the per-item paths for anything still
        unprocessed, so clearing is always safe."""
        self._predigest.clear()

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
        # Our ack: hand every node j one evaluation of its row.
        nd = _native_dkg(self.suite)
        if nd is not None:
            mod = self.suite.scalar_modulus
            pks_g1 = [getattr(self.pub_keys[n], "g1", None) for n in self._ids]
            if all(
                isinstance(getattr(g, "value", None), int)
                and 0 <= g.value < mod
                for g in pks_g1
            ):
                return PartOutcome(
                    ack=Ack(sender, nd.ack_values(row, pks_g1, rng))
                )
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
        # Native fast path: decrypt + decode + commitment consistency in
        # one C call (identical verdicts; _NativeDkg docstring) — batch
        # pre-digested where the engine's batch callback ran first.
        nd = _native_dkg(self.suite)
        ct = ack.values[our_idx]
        if self._predigest:
            pre = self._predigest.get(("ack", id(ack), sender_idx))
            if pre is not None and pre[0] is ack:
                PREDIGEST_STATS["hits"] += 1
                rc, nval = pre[1], pre[2]
                # Mirror SecretKey.decrypt's ciphertext-validity memo
                # (rc 0 = invalid ct; 1/2 = valid ct).
                object.__setattr__(ct, "_verify_ok", rc != 0)
                if rc != 1:
                    return AckOutcome(fault=FAULT_BAD_ACK)
                state.values[sender_idx + 1] = nval
                return AckOutcome()
        if (
            nd is not None
            and nd.kem.ct_ok(ct)
            and len(ct.v) == _SCALAR_BYTES
        ):
            cid = nd.commit_id(state.commitment)
            if cid >= 0:
                rc, nval = nd.ack_check(
                    cid, sender_idx + 1, our_idx + 1, ct, self.secret_key.x
                )
                if rc < 0:
                    # Stale cid (registry generation bump): clear the
                    # memo and re-register once before giving up on the
                    # fast path (ADVICE round 5).
                    cid = nd.refresh_commit_id(state.commitment)
                    if cid >= 0:
                        rc, nval = nd.ack_check(
                            cid, sender_idx + 1, our_idx + 1, ct,
                            self.secret_key.x,
                        )
                if rc >= 0:
                    # Mirror SecretKey.decrypt's ciphertext-validity memo
                    # (rc 0 = invalid ct; 1/2 = valid ct).
                    object.__setattr__(ct, "_verify_ok", rc != 0)
                    if rc != 1:
                        return AckOutcome(fault=FAULT_BAD_ACK)
                    state.values[sender_idx + 1] = nval
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
        # Vectorized Lagrange (one C call sums every proposal's
        # interpolation — same mod-r value as the loop below); any
        # native miss falls back to the pure-Python oracle.
        nd = _native_dkg(self.suite)
        secret: Optional[int] = None
        if nd is not None and _batch_dkg_enabled():
            secret = nd.interp_sum(groups)
        if secret is None:
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
        # Batch-digested verdict (decrypt + decode + row consistency in
        # the one-call batch check): same outcomes as the step-by-step
        # path below, including the ct-validity memo.
        pre = (
            self._predigest.get(("part", id(part)))
            if self._predigest
            else None
        )
        if pre is not None and pre[0] is part:
            PREDIGEST_STATS["hits"] += 1
            rc, data = pre[1], pre[2]
            object.__setattr__(part.rows[our_idx], "_verify_ok", rc != 0)
            if rc != 1:
                return None
            coeffs = _decode_scalars(
                data, self.threshold + 1, self.suite.scalar_modulus
            )
            if coeffs is None:  # defensive: the C check validated ranges
                return None
            return Poly(coeffs, self.suite.scalar_modulus)
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
        # Validate the row against the public commitment (native fast
        # path: per-coefficient g*c comparison against the registered
        # commitment's row — same verdict as the to_bytes comparison).
        nd = _native_dkg(self.suite)
        if nd is not None:
            cid = nd.commit_id(part.commitment)
            if cid >= 0:
                rc = nd.row_check(
                    cid, our_idx + 1, data, self.threshold + 1
                )
                if rc < 0:
                    # Stale cid: re-register once (ADVICE round 5).
                    cid = nd.refresh_commit_id(part.commitment)
                    if cid >= 0:
                        rc = nd.row_check(
                            cid, our_idx + 1, data, self.threshold + 1
                        )
                if rc >= 0:
                    return row if rc == 1 else None
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
