"""Wire-format registry: validating (un)packers for committed-boundary types.

The reference's equivalent is ``bincode``'s derive-generated codecs for the
types that ride inside HoneyBadger contributions (upstream
``src/honey_badger/honey_badger.rs``: contributions are bincode-serialized
before threshold encryption; ``src/dynamic_honey_badger/``: votes and DKG
messages ride inside them).  Every ``unpack`` below is a trust boundary:
its input tuple was authored by a possibly-Byzantine proposer, so it
validates field count, types, and value ranges before constructing, and
raises :class:`~hbbft_tpu_torch.utils.serde.DecodeError` on anything off.

Registered types (everything reachable from a committed contribution):

* crypto:   ``Ciphertext``, ``Signature``, ``PublicKey``,
            ``Commitment``, ``BivarCommitment``
* honey_badger:  ``EncryptionSchedule``
* dynamic_honey_badger:  ``Change``, ``SignedVote``, ``SignedKeyGenMsg``,
            ``InternalContrib``, ``JoinPlan``
* sync_key_gen:  ``Part``, ``Ack``

Transport-boundary types (everything reachable from a live wire
message of the SenderQueue(QueueingHoneyBadger) stack, so a whole
protocol message can ride in one frame):

* crypto shares:  ``SignatureShare``, ``DecryptionShare``
* merkle:   ``Proof``
* broadcast:  ``ValueMsg``, ``EchoMsg``, ``ReadyMsg``, ``EchoHashMsg``,
            ``CanDecodeMsg``
* agreement:  ``BoolSet``, ``BValMsg``, ``AuxMsg``, ``ConfMsg``,
            ``CoinMsg``, ``TermMsg``, ``AbaMessage``
* threshold:  ``SignMessage``, ``DecryptMessage``
* envelopes:  ``SubsetMessage``, ``HbMessage``, ``DhbMessage``,
            ``SqMessage``

Crypto-plane RPC: ``VerifyRequest``.

Copy of ``hbbft_tpu/wire.py`` under the reference's tags, so
``serde.dumps`` gives the reference's bytes: all 35 of its struct tags are
registered here.  The reference's token-level ``ct`` builder, which serves
only its native token scan, is left out with that scan.

These unpackers are *stricter* than the in-process handlers: a frame
whose payload could only have been authored by a broken or malicious
peer (wrong root length, round < 0, unknown envelope kind) is rejected
at the decode boundary — the transport drops the connection and counts
the fault — instead of being handed to a protocol instance.  Handlers
keep their own malformed-message fault paths for in-process use.

Group elements are encoded by the serde core (tag 0x11) through the suite
registry; suites validate structure/on-curve/subgroup in
``g1_from_bytes``/``g2_from_bytes``.

Subgroup-check policy (wire-sourced points MUST get subgroup checks
somewhere): decode does the FULL check, even though the
threshold-decrypt path's verify backend re-checks, because the same
``Ciphertext`` type also reaches ``SecretKey.decrypt`` (DKG rows), where
``ct.u`` is multiplied by a long-term secret with no backend pass — a
torsion component there is the classic invalid-point key-leak.  Cost
context: serde decode handles O(N) committed payloads per epoch; the
O(N^2) share-verification hot loop never crosses this codec (shares are
in-process message objects), so this does not reintroduce round 1's
host-side flush bottleneck.  If decode ever shows up in profiles, the
fast x-based membership tests (Scott 2021: phi/psi endomorphism checks)
cut the torsion cost ~2-4x before any batching is needed.
"""

from __future__ import annotations

from typing import Any

from hbbft_tpu_torch.crypto.backend import (
    CIPHERTEXT,
    DEC_SHARE,
    SIG_SHARE,
    VerifyRequest,
)
from hbbft_tpu_torch.crypto.keys import (
    Ciphertext,
    DecryptionShare,
    PublicKey,
    PublicKeyShare,
    Signature,
    SignatureShare,
)
from hbbft_tpu_torch.crypto.poly import BivarCommitment, Commitment
from hbbft_tpu_torch.crypto.suite import ScalarSuite
from hbbft_tpu_torch.ops.merkle import Proof
from hbbft_tpu_torch.protocols.binary_agreement import (
    AbaMessage,
    ConfMsg,
    CoinMsg,
    TermMsg,
)
from hbbft_tpu_torch.protocols.bool_set import BoolSet
from hbbft_tpu_torch.protocols.broadcast import (
    CanDecodeMsg,
    EchoHashMsg,
    EchoMsg,
    ReadyMsg,
    ValueMsg,
)
from hbbft_tpu_torch.protocols.dynamic_honey_badger import (
    Change,
    DhbMessage,
    InternalContrib,
    JoinPlan,
    SignedKeyGenMsg,
    SignedVote,
)
from hbbft_tpu_torch.protocols.honey_badger import DECRYPT, SUBSET, EncryptionSchedule, HbMessage
from hbbft_tpu_torch.protocols.sbv_broadcast import AuxMsg, BValMsg
from hbbft_tpu_torch.protocols.sender_queue import SqMessage
from hbbft_tpu_torch.protocols.subset import BA, BC, SubsetMessage
from hbbft_tpu_torch.protocols.sync_key_gen import Ack, Part
from hbbft_tpu_torch.protocols.threshold_decrypt import DecryptMessage
from hbbft_tpu_torch.protocols.threshold_sign import SignMessage
from hbbft_tpu_torch.utils.serde import (
    DecodeError,
    get_suite,
    register_struct,
    register_suite,
)

# -- suites -----------------------------------------------------------------

from hbbft_tpu_torch.crypto.bls.suite import BLSSuite  # pure Python

register_suite(ScalarSuite())
register_suite(BLSSuite())


def _suite(name: Any):
    if not isinstance(name, str):
        raise DecodeError("suite name must be a string")
    return get_suite(name)


# -- field validators -------------------------------------------------------


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise DecodeError(what)


def _int(v: Any, what: str) -> int:
    _need(type(v) is int, f"{what}: not an int")
    return v


def _nonneg(v: Any, what: str) -> int:
    _need(type(v) is int and v >= 0, f"{what}: not a non-negative int")
    return v


def _bytes(v: Any, what: str) -> bytes:
    _need(type(v) is bytes, f"{what}: not bytes")
    return v


def _node_id(v: Any, what: str) -> Any:
    """Node ids crossing the boundary must be plain hashable scalars."""
    _need(type(v) in (int, str, bytes), f"{what}: bad node id")
    return v


def _fields(fields: tuple, n: int, what: str) -> tuple:
    _need(len(fields) == n, f"{what}: want {n} fields, got {len(fields)}")
    return fields


def _g1(suite: Any, v: Any, what: str) -> Any:
    # from_bytes already validated; re-check the element belongs to the
    # suite named in the enclosing struct (mixed-suite confusion).
    _need(suite.is_g1(v, check_subgroup=False), f"{what}: not a G1 element")
    return v


def _g2(suite: Any, v: Any, what: str) -> Any:
    _need(suite.is_g2(v, check_subgroup=False), f"{what}: not a G2 element")
    return v


# -- crypto types -----------------------------------------------------------


def _pack_ciphertext(ct: Ciphertext) -> tuple:
    return (ct.suite.name, ct.u, ct.v, ct.w)


def _unpack_ciphertext(f: tuple) -> Ciphertext:
    name, u, v, w = _fields(f, 4, "Ciphertext")
    suite = _suite(name)
    return Ciphertext(
        _g1(suite, u, "Ciphertext.u"),
        _bytes(v, "Ciphertext.v"),
        _g2(suite, w, "Ciphertext.w"),
        suite,
    )


def _pack_signature(sig: Signature) -> tuple:
    return (sig.suite.name, sig.g2)


def _unpack_signature(f: tuple) -> Signature:
    name, g2 = _fields(f, 2, "Signature")
    suite = _suite(name)
    return Signature(_g2(suite, g2, "Signature.g2"), suite)


def _pack_public_key(pk: PublicKey) -> tuple:
    return (pk.suite.name, pk.g1)


def _unpack_public_key(f: tuple) -> PublicKey:
    name, g1 = _fields(f, 2, "PublicKey")
    suite = _suite(name)
    return PublicKey(_g1(suite, g1, "PublicKey.g1"), suite)


def _pack_commitment(c: Commitment) -> tuple:
    return (c.elems,)


def _unpack_commitment(f: tuple) -> Commitment:
    (elems,) = _fields(f, 1, "Commitment")
    _need(type(elems) is tuple and len(elems) >= 1, "Commitment: bad elems")
    cls = type(elems[0])
    _need(
        all(type(e) is cls and hasattr(e, "serde_group") for e in elems),
        "Commitment: mixed/bad element types",
    )
    return Commitment(elems)


def _pack_bivar_commitment(c: BivarCommitment) -> tuple:
    return (c.elems,)


def _unpack_bivar_commitment(f: tuple) -> BivarCommitment:
    (elems,) = _fields(f, 1, "BivarCommitment")
    _need(type(elems) is tuple and len(elems) >= 1, "BivarCommitment: bad elems")
    n = len(elems)
    flat = []
    for row in elems:
        _need(type(row) is tuple and len(row) == n, "BivarCommitment: not square")
        flat.extend(row)
    cls = type(flat[0])
    _need(
        all(type(e) is cls and hasattr(e, "serde_group") for e in flat),
        "BivarCommitment: mixed/bad element types",
    )
    return BivarCommitment(elems)


# -- crypto-plane RPC -------------------------------------------------------


def _pack_verify_request(r: VerifyRequest) -> tuple:
    # Opaque RPC payload of the crypto-plane service.
    # The public-key share rides as its bare G1 element: the share (or
    # ciphertext) in the same tuple pins the suite in-band, so unpack
    # reconstructs PublicKeyShare without a separate registered type.
    if r.kind == SIG_SHARE:
        pk, msg, share = r.payload
        return (r.kind, pk.g1, msg, share)
    if r.kind == DEC_SHARE:
        pk, ct, share = r.payload
        return (r.kind, pk.g1, ct, share)
    (ct,) = r.payload
    return (r.kind, ct)


def _unpack_verify_request(f: tuple) -> VerifyRequest:
    _need(len(f) >= 1, "VerifyRequest: empty")
    kind = f[0]
    if kind == SIG_SHARE:
        _, g1, msg, share = _fields(f, 4, "VerifyRequest[sig]")
        _need(isinstance(share, SignatureShare), "VerifyRequest: bad share")
        suite = share.suite
        return VerifyRequest.sig_share(
            PublicKeyShare(_g1(suite, g1, "VerifyRequest.pk"), suite),
            _bytes(msg, "VerifyRequest.msg"),
            share,
        )
    if kind == DEC_SHARE:
        _, g1, ct, share = _fields(f, 4, "VerifyRequest[dec]")
        _need(isinstance(ct, Ciphertext), "VerifyRequest: bad ciphertext")
        _need(isinstance(share, DecryptionShare), "VerifyRequest: bad share")
        suite = share.suite
        return VerifyRequest.dec_share(
            PublicKeyShare(_g1(suite, g1, "VerifyRequest.pk"), suite),
            ct,
            share,
        )
    if kind == CIPHERTEXT:
        _, ct = _fields(f, 2, "VerifyRequest[ct]")
        _need(isinstance(ct, Ciphertext), "VerifyRequest: bad ciphertext")
        return VerifyRequest.ciphertext(ct)
    raise DecodeError("VerifyRequest: bad kind")


# -- honey badger -----------------------------------------------------------

_SCHEDULE_KINDS = ("always", "never", "every_nth", "tick_tock")


def _pack_schedule(s: EncryptionSchedule) -> tuple:
    return (s.kind, s.n)


def _unpack_schedule(f: tuple) -> EncryptionSchedule:
    kind, n = _fields(f, 2, "EncryptionSchedule")
    _need(kind in _SCHEDULE_KINDS, "EncryptionSchedule: bad kind")
    _need(type(n) is int and n >= 1, "EncryptionSchedule: bad n")
    return EncryptionSchedule(kind, n)


# -- dynamic honey badger ---------------------------------------------------

_CHANGE_KINDS = ("node_change", "encryption_schedule")


def _pack_change(c: Change) -> tuple:
    return (c.kind, c.new_validators, c.schedule)


def _unpack_change(f: tuple) -> Change:
    # Cross-field invariants match the Change.node_change /
    # Change.encryption_schedule constructors: a decoded Change must be
    # one an honest node could have built (a schedule change always
    # carries a schedule; a node change carries >= 1 validator and no
    # schedule) — otherwise adopting a committed winner could crash
    # honest nodes (None.encrypt_on) or derive threshold -1.
    kind, validators, schedule = _fields(f, 3, "Change")
    _need(kind in _CHANGE_KINDS, "Change: bad kind")
    _need(type(validators) is tuple, "Change: bad validators")
    for pair in validators:
        _need(
            type(pair) is tuple and len(pair) == 2, "Change: bad validator pair"
        )
        _node_id(pair[0], "Change validator id")
        _need(isinstance(pair[1], PublicKey), "Change: validator key")
    if kind == "encryption_schedule":
        _need(isinstance(schedule, EncryptionSchedule), "Change: missing schedule")
        _need(len(validators) == 0, "Change: schedule change with validators")
    else:
        _need(schedule is None, "Change: node change with schedule")
        _need(len(validators) >= 1, "Change: empty validator set")
    return Change(kind, validators, schedule)


def _pack_signed_vote(v: SignedVote) -> tuple:
    return (v.voter, v.era, v.num, v.change, v.signature)


def _unpack_signed_vote(f: tuple) -> SignedVote:
    voter, era, num, change, sig = _fields(f, 5, "SignedVote")
    _node_id(voter, "SignedVote.voter")
    _need(isinstance(change, Change), "SignedVote: bad change")
    _need(isinstance(sig, Signature), "SignedVote: bad signature")
    return SignedVote(
        voter, _int(era, "SignedVote.era"), _int(num, "SignedVote.num"), change, sig
    )


def _pack_signed_kg(m: SignedKeyGenMsg) -> tuple:
    return (m.era, m.sender, m.payload, m.signature)


def _unpack_signed_kg(f: tuple) -> SignedKeyGenMsg:
    era, sender, payload, sig = _fields(f, 4, "SignedKeyGenMsg")
    _node_id(sender, "SignedKeyGenMsg.sender")
    _need(isinstance(payload, (Part, Ack)), "SignedKeyGenMsg: bad payload")
    _need(isinstance(sig, Signature), "SignedKeyGenMsg: bad signature")
    return SignedKeyGenMsg(_int(era, "SignedKeyGenMsg.era"), sender, payload, sig)


def _pack_internal_contrib(c: InternalContrib) -> tuple:
    return (c.contribution, c.key_gen_messages, c.votes)


def _unpack_internal_contrib(f: tuple) -> InternalContrib:
    contribution, kg, votes = _fields(f, 3, "InternalContrib")
    _need(type(kg) is tuple, "InternalContrib: bad key_gen_messages")
    _need(
        all(isinstance(m, SignedKeyGenMsg) for m in kg),
        "InternalContrib: bad key_gen message",
    )
    _need(type(votes) is tuple, "InternalContrib: bad votes")
    _need(
        all(isinstance(v, SignedVote) for v in votes), "InternalContrib: bad vote"
    )
    return InternalContrib(contribution, kg, votes)


def _pack_join_plan(p: JoinPlan) -> tuple:
    return (
        p.era,
        p.public_key_set.suite.name,
        p.public_key_set.commitment,
        p.validators,
        p.encryption_schedule,
    )


def _unpack_join_plan(f: tuple) -> JoinPlan:
    from hbbft_tpu_torch.crypto.keys import PublicKeySet

    era, suite_name, commitment, validators, schedule = _fields(f, 5, "JoinPlan")
    suite = _suite(suite_name)
    _need(isinstance(commitment, Commitment), "JoinPlan: bad commitment")
    _need(
        all(suite.is_g1(e, check_subgroup=False) for e in commitment.elems),
        "JoinPlan: commitment elements not in suite G1",
    )
    _need(
        type(validators) is tuple and len(validators) >= 1,
        "JoinPlan: empty validator set",  # (0-1)//3 thresholds go negative
    )
    for pair in validators:
        _need(type(pair) is tuple and len(pair) == 2, "JoinPlan: bad pair")
        _node_id(pair[0], "JoinPlan validator id")
        _need(isinstance(pair[1], PublicKey), "JoinPlan: validator key")
    _need(isinstance(schedule, EncryptionSchedule), "JoinPlan: bad schedule")
    return JoinPlan(
        _nonneg(era, "JoinPlan.era"),
        PublicKeySet(commitment, suite),
        validators,
        schedule,
    )


# -- sync key gen -----------------------------------------------------------


def _pack_part(p: Part) -> tuple:
    return (p.commitment, p.rows)


def _unpack_part(f: tuple) -> Part:
    commitment, rows = _fields(f, 2, "Part")
    _need(isinstance(commitment, BivarCommitment), "Part: bad commitment")
    _need(type(rows) is tuple, "Part: bad rows")
    _need(all(isinstance(c, Ciphertext) for c in rows), "Part: bad row ciphertext")
    return Part(commitment, rows)


def _pack_ack(a: Ack) -> tuple:
    return (a.proposer, a.values)


def _unpack_ack(f: tuple) -> Ack:
    proposer, values = _fields(f, 2, "Ack")
    _node_id(proposer, "Ack.proposer")
    _need(type(values) is tuple, "Ack: bad values")
    _need(
        all(isinstance(c, Ciphertext) for c in values), "Ack: bad value ciphertext"
    )
    return Ack(proposer, values)


# -- transport-boundary types (live wire messages) --------------------------


def _bool(v: Any, what: str) -> bool:
    _need(type(v) is bool, f"{what}: not a bool")
    return v


def _root(v: Any, what: str) -> bytes:
    _need(type(v) is bytes and len(v) == 32, f"{what}: not a 32-byte root")
    return v


def _pack_sig_share(s: SignatureShare) -> tuple:
    return (s.suite.name, s.g2)


def _unpack_sig_share(f: tuple) -> SignatureShare:
    name, g2 = _fields(f, 2, "SignatureShare")
    suite = _suite(name)
    return SignatureShare(_g2(suite, g2, "SignatureShare.g2"), suite)


def _pack_dec_share(s: DecryptionShare) -> tuple:
    return (s.suite.name, s.g1)


def _unpack_dec_share(f: tuple) -> DecryptionShare:
    name, g1 = _fields(f, 2, "DecryptionShare")
    suite = _suite(name)
    return DecryptionShare(_g1(suite, g1, "DecryptionShare.g1"), suite)


def _pack_proof(p: Proof) -> tuple:
    return (p.value, p.index, p.path, p.root)


def _unpack_proof(f: tuple) -> Proof:
    value, index, path, root = _fields(f, 4, "Proof")
    _bytes(value, "Proof.value")
    _nonneg(index, "Proof.index")
    _need(
        type(path) is tuple
        and all(type(h) is bytes and len(h) == 32 for h in path),
        "Proof.path: not a tuple of 32-byte hashes",
    )
    return Proof(value, index, path, _root(root, "Proof.root"))


def _pack_value_msg(m: ValueMsg) -> tuple:
    return (m.proof,)


def _unpack_value_msg(f: tuple) -> ValueMsg:
    (proof,) = _fields(f, 1, "ValueMsg")
    _need(isinstance(proof, Proof), "ValueMsg: bad proof")
    return ValueMsg(proof)


def _pack_echo_msg(m: EchoMsg) -> tuple:
    return (m.proof,)


def _unpack_echo_msg(f: tuple) -> EchoMsg:
    (proof,) = _fields(f, 1, "EchoMsg")
    _need(isinstance(proof, Proof), "EchoMsg: bad proof")
    return EchoMsg(proof)


def _pack_root_msg(m: Any) -> tuple:
    return (m.root,)


def _unpack_ready_msg(f: tuple) -> ReadyMsg:
    (root,) = _fields(f, 1, "ReadyMsg")
    return ReadyMsg(_root(root, "ReadyMsg.root"))


def _unpack_echo_hash_msg(f: tuple) -> EchoHashMsg:
    (root,) = _fields(f, 1, "EchoHashMsg")
    return EchoHashMsg(_root(root, "EchoHashMsg.root"))


def _unpack_can_decode_msg(f: tuple) -> CanDecodeMsg:
    (root,) = _fields(f, 1, "CanDecodeMsg")
    return CanDecodeMsg(_root(root, "CanDecodeMsg.root"))


def _pack_bool_set(b: BoolSet) -> tuple:
    return (b.mask,)


def _unpack_bool_set(f: tuple) -> BoolSet:
    (mask,) = _fields(f, 1, "BoolSet")
    _need(type(mask) is int and 0 <= mask <= 3, "BoolSet: bad mask")
    return BoolSet(mask)


def _pack_bval_msg(m: BValMsg) -> tuple:
    return (m.value,)


def _unpack_bval_msg(f: tuple) -> BValMsg:
    (value,) = _fields(f, 1, "BValMsg")
    return BValMsg(_bool(value, "BValMsg.value"))


def _pack_aux_msg(m: AuxMsg) -> tuple:
    return (m.value,)


def _unpack_aux_msg(f: tuple) -> AuxMsg:
    (value,) = _fields(f, 1, "AuxMsg")
    return AuxMsg(_bool(value, "AuxMsg.value"))


def _pack_conf_msg(m: ConfMsg) -> tuple:
    return (m.vals,)


def _unpack_conf_msg(f: tuple) -> ConfMsg:
    (vals,) = _fields(f, 1, "ConfMsg")
    _need(isinstance(vals, BoolSet), "ConfMsg: bad vals")
    return ConfMsg(vals)


def _pack_term_msg(m: TermMsg) -> tuple:
    return (m.value,)


def _unpack_term_msg(f: tuple) -> TermMsg:
    (value,) = _fields(f, 1, "TermMsg")
    return TermMsg(_bool(value, "TermMsg.value"))


def _pack_sign_msg(m: SignMessage) -> tuple:
    return (m.share,)


def _unpack_sign_msg(f: tuple) -> SignMessage:
    (share,) = _fields(f, 1, "SignMessage")
    _need(isinstance(share, SignatureShare), "SignMessage: bad share")
    return SignMessage(share)


def _pack_coin_msg(m: CoinMsg) -> tuple:
    return (m.inner,)


def _unpack_coin_msg(f: tuple) -> CoinMsg:
    (inner,) = _fields(f, 1, "CoinMsg")
    _need(isinstance(inner, SignMessage), "CoinMsg: bad inner")
    return CoinMsg(inner)


def _pack_decrypt_msg(m: DecryptMessage) -> tuple:
    return (m.share,)


def _unpack_decrypt_msg(f: tuple) -> DecryptMessage:
    (share,) = _fields(f, 1, "DecryptMessage")
    _need(isinstance(share, DecryptionShare), "DecryptMessage: bad share")
    return DecryptMessage(share)


def _pack_aba_msg(m: AbaMessage) -> tuple:
    return (m.round, m.content)


def _unpack_aba_msg(f: tuple) -> AbaMessage:
    rnd, content = _fields(f, 2, "AbaMessage")
    # explicit type tuple (not the _ABA_CONTENT alias): the HBT005
    # delegation analysis reads isinstance targets by name
    _need(
        isinstance(content, (BValMsg, AuxMsg, ConfMsg, CoinMsg, TermMsg)),
        "AbaMessage: bad content",
    )
    return AbaMessage(_nonneg(rnd, "AbaMessage.round"), content)


_BC_CONTENT = (ValueMsg, EchoMsg, ReadyMsg, EchoHashMsg, CanDecodeMsg)


def _pack_subset_msg(m: SubsetMessage) -> tuple:
    return (m.proposer, m.kind, m.inner)


def _unpack_subset_msg(f: tuple) -> SubsetMessage:
    proposer, kind, inner = _fields(f, 3, "SubsetMessage")
    _node_id(proposer, "SubsetMessage.proposer")
    if kind == BC:
        _need(isinstance(inner, _BC_CONTENT), "SubsetMessage: bad bc inner")
    elif kind == BA:
        _need(isinstance(inner, AbaMessage), "SubsetMessage: bad ba inner")
    else:
        raise DecodeError("SubsetMessage: bad kind")
    return SubsetMessage(proposer, kind, inner)


def _pack_hb_msg(m: HbMessage) -> tuple:
    return (m.epoch, m.kind, m.proposer, m.inner)


def _unpack_hb_msg(f: tuple) -> HbMessage:
    epoch, kind, proposer, inner = _fields(f, 4, "HbMessage")
    _nonneg(epoch, "HbMessage.epoch")
    if kind == SUBSET:
        _need(proposer is None, "HbMessage: subset with proposer")
        _need(isinstance(inner, SubsetMessage), "HbMessage: bad subset inner")
    elif kind == DECRYPT:
        _node_id(proposer, "HbMessage.proposer")
        _need(isinstance(inner, DecryptMessage), "HbMessage: bad decrypt inner")
    else:
        raise DecodeError("HbMessage: bad kind")
    return HbMessage(epoch, kind, proposer, inner)


def _pack_dhb_msg(m: DhbMessage) -> tuple:
    return (m.era, m.inner)


def _unpack_dhb_msg(f: tuple) -> DhbMessage:
    era, inner = _fields(f, 2, "DhbMessage")
    _need(isinstance(inner, HbMessage), "DhbMessage: bad inner")
    return DhbMessage(_nonneg(era, "DhbMessage.era"), inner)


def _pack_sq_msg(m: SqMessage) -> tuple:
    return (m.kind, m.value)


def _unpack_sq_msg(f: tuple) -> SqMessage:
    kind, value = _fields(f, 2, "SqMessage")
    if kind == "epoch_started":
        _need(
            type(value) is tuple
            and len(value) == 2
            and all(type(x) is int and x >= 0 for x in value),
            "SqMessage: bad epoch",
        )
    elif kind == "algo":
        # Both the dynamic (DhbMessage) and static (HbMessage) stacks
        # ride through SenderQueue.
        _need(isinstance(value, (DhbMessage, HbMessage)), "SqMessage: bad algo")
    elif kind == "join_plan":
        _need(isinstance(value, JoinPlan), "SqMessage: bad plan")
    else:
        raise DecodeError("SqMessage: bad kind")
    return SqMessage(kind, value)


# -- registration -----------------------------------------------------------

register_struct("ct", Ciphertext, _pack_ciphertext, _unpack_ciphertext)
register_struct("sig", Signature, _pack_signature, _unpack_signature)
register_struct("pk", PublicKey, _pack_public_key, _unpack_public_key)
register_struct("comm", Commitment, _pack_commitment, _unpack_commitment)
register_struct(
    "bicomm", BivarCommitment, _pack_bivar_commitment, _unpack_bivar_commitment
)
register_struct("encsched", EncryptionSchedule, _pack_schedule, _unpack_schedule)
register_struct("change", Change, _pack_change, _unpack_change)
register_struct("svote", SignedVote, _pack_signed_vote, _unpack_signed_vote)
register_struct("skg", SignedKeyGenMsg, _pack_signed_kg, _unpack_signed_kg)
register_struct(
    "icontrib", InternalContrib, _pack_internal_contrib, _unpack_internal_contrib
)
register_struct("joinplan", JoinPlan, _pack_join_plan, _unpack_join_plan)
register_struct("part", Part, _pack_part, _unpack_part)
register_struct("ack", Ack, _pack_ack, _unpack_ack)
# Crypto-plane RPC payloads (the service process boundary).
register_struct("vreq", VerifyRequest, _pack_verify_request, _unpack_verify_request)

# transport-boundary (live wire) types
register_struct("sigshare", SignatureShare, _pack_sig_share, _unpack_sig_share)
register_struct("decshare", DecryptionShare, _pack_dec_share, _unpack_dec_share)
register_struct("proof", Proof, _pack_proof, _unpack_proof)
register_struct("bc_value", ValueMsg, _pack_value_msg, _unpack_value_msg)
register_struct("bc_echo", EchoMsg, _pack_echo_msg, _unpack_echo_msg)
register_struct("bc_ready", ReadyMsg, _pack_root_msg, _unpack_ready_msg)
register_struct("bc_echohash", EchoHashMsg, _pack_root_msg, _unpack_echo_hash_msg)
register_struct(
    "bc_candecode", CanDecodeMsg, _pack_root_msg, _unpack_can_decode_msg
)
register_struct("bools", BoolSet, _pack_bool_set, _unpack_bool_set)
register_struct("ba_bval", BValMsg, _pack_bval_msg, _unpack_bval_msg)
register_struct("ba_aux", AuxMsg, _pack_aux_msg, _unpack_aux_msg)
register_struct("ba_conf", ConfMsg, _pack_conf_msg, _unpack_conf_msg)
register_struct("ba_coin", CoinMsg, _pack_coin_msg, _unpack_coin_msg)
register_struct("ba_term", TermMsg, _pack_term_msg, _unpack_term_msg)
register_struct("ba", AbaMessage, _pack_aba_msg, _unpack_aba_msg)
register_struct("signmsg", SignMessage, _pack_sign_msg, _unpack_sign_msg)
register_struct("decmsg", DecryptMessage, _pack_decrypt_msg, _unpack_decrypt_msg)
register_struct("subsetmsg", SubsetMessage, _pack_subset_msg, _unpack_subset_msg)
register_struct("hbmsg", HbMessage, _pack_hb_msg, _unpack_hb_msg)
register_struct("dhbmsg", DhbMessage, _pack_dhb_msg, _unpack_dhb_msg)
register_struct("sqmsg", SqMessage, _pack_sq_msg, _unpack_sq_msg)
