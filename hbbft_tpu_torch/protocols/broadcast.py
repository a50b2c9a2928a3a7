"""Broadcast: Bracha reliable broadcast with AVID erasure-coded dispersal.

Reference: upstream ``src/broadcast/broadcast.rs`` (SURVEY.md §2 #4,
BASELINE.json:8).  Protocol for proposer p, value v:

* p RS-encodes v into N shards (K = N - 2f data + 2f parity), Merkle-
  hashes them, and sends node i its proof ``Value(proof_i)``.
* On a valid ``Value``, a node gossips ``Echo(proof_i)`` to everyone.
* On N - f valid Echos for one root: send ``Ready(root)``.
* On f + 1 Readys without having sent one: send ``Ready`` (amplification).
* On 2f + 1 Readys and >= K stored shards: reconstruct, re-encode, and
  re-hash to verify the root (catches a proposer that encoded garbage),
  then output the value.

Per-node byte cost is O(|v| * N / K) instead of O(|v| * N).

Later upstream revisions add two bandwidth-optimization messages, both
implemented here (SURVEY.md §2 #4 "EchoHash/CanDecode"):

* ``CanDecode(root)`` — broadcast once a node holds K shards for a root:
  "stop sending me full proofs".
* ``EchoHash(root)`` — sent in place of a full ``Echo(proof)`` to peers
  that have declared ``CanDecode``; counts toward the N - f Echo
  threshold but carries no shard.

Safety is unchanged: decoding still requires K locally-validated shards
and a recomputed Merkle root match; the optimization only drops shard
payloads to peers that declared they no longer need them.

Copy of ``hbbft_tpu/protocols/broadcast.py``; :func:`batch_propose` runs
the proposers' data plane through this package's device data plane.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

from hbbft_tpu_torch.obs import trace as _trace
from hbbft_tpu_torch.ops.gf256 import rs_codec
from hbbft_tpu_torch.ops.merkle import MerkleTree, Proof
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.traits import ConsensusProtocol, Step, Target

if TYPE_CHECKING:  # the device module loads torch: batch_propose imports it
    from hbbft_tpu_torch.device import DeviceLike

FAULT_INVALID_PROOF = "broadcast:invalid-proof"
FAULT_WRONG_INDEX = "broadcast:wrong-shard-index"
FAULT_NOT_PROPOSER = "broadcast:value-from-non-proposer"
FAULT_MULTIPLE_VALUES = "broadcast:multiple-values"
FAULT_DUPLICATE = "broadcast:duplicate-message"
FAULT_BAD_ENCODING = "broadcast:root-mismatch-after-decode"
FAULT_MALFORMED = "broadcast:malformed-message"


@dataclass(frozen=True)
class ValueMsg:
    proof: Proof


@dataclass(frozen=True)
class EchoMsg:
    proof: Proof


@dataclass(frozen=True)
class ReadyMsg:
    root: bytes


@dataclass(frozen=True)
class EchoHashMsg:
    """Echo without the shard, for peers that declared CanDecode."""

    root: bytes


@dataclass(frozen=True)
class CanDecodeMsg:
    """Sender holds K shards for ``root`` and needs no more full Echos."""

    root: bytes


def _pack(value: bytes, k: int, align: int = 1) -> Tuple[bytes, ...]:
    """Length-prefix and pad ``value`` into k equal shards.

    ``align=2`` for the GF(2^16) codec (validator sets > 255): its
    symbols are 2 bytes, so shard lengths must be even.
    """
    payload = len(value).to_bytes(8, "big") + value
    shard_len = max(1, -(-len(payload) // k))
    shard_len = -(-shard_len // align) * align
    payload = payload.ljust(k * shard_len, b"\x00")
    return tuple(payload[i * shard_len : (i + 1) * shard_len] for i in range(k))


def _unpack(data_shards: Tuple[bytes, ...]) -> Optional[bytes]:
    payload = b"".join(data_shards)
    if len(payload) < 8:
        return None
    n = int.from_bytes(payload[:8], "big")
    if 8 + n > len(payload):
        return None
    return payload[8 : 8 + n]


class Broadcast(ConsensusProtocol):
    """One reliable-broadcast instance for a designated proposer."""

    def __init__(self, netinfo: NetworkInfo, proposer_id: Any) -> None:
        self._netinfo = netinfo
        self._proposer = proposer_id
        n, f = netinfo.num_nodes, netinfo.num_faulty
        self._data_shards = n - 2 * f
        # GF(256) up to 255 validators (reference-matching byte layout);
        # GF(2^16) beyond — GF(256) has no 256th Vandermonde point.
        self._rs = rs_codec(self._data_shards, n)
        self._echos: Dict[Any, Proof] = {}
        self._echo_hashes: Dict[Any, bytes] = {}
        self._readys: Dict[Any, bytes] = {}
        self._can_decode: Dict[Any, bytes] = {}  # peer -> root it can decode
        self._can_decode_sent = False
        self._echo_sent = False
        self._ready_sent = False
        self._had_input = False
        self._terminated = False
        self._value: Optional[bytes] = None

    @property
    def our_id(self) -> Any:
        return self._netinfo.our_id

    @property
    def terminated(self) -> bool:
        return self._terminated

    @property
    def value(self) -> Optional[bytes]:
        return self._value

    # -- input (proposer only) ----------------------------------------
    def handle_input(self, input: bytes, rng: Any) -> Step:
        if self.our_id != self._proposer or self._had_input:
            return Step.empty()
        shards = self._rs.encode(
            list(_pack(bytes(input), self._data_shards, self._rs.shard_align))
        )
        tree = MerkleTree(shards)
        return self.propose_with_proofs([tree.proof(i) for i in range(self._netinfo.num_nodes)])

    def propose_with_proofs(self, proofs) -> Step:
        """Proposer fast path: disperse PRECOMPUTED shard proofs.

        ``proofs[i]`` is shard i's proof (index order).  Used by
        :func:`batch_propose` to feed device-computed (batched RS +
        Merkle) proofs into many instances without redoing the data
        plane per instance; ``handle_input`` routes through here too.
        """
        step = Step.empty()
        if self.our_id != self._proposer or self._had_input:
            return step
        self._had_input = True
        for nid in self._netinfo.all_ids:
            proof = proofs[self._netinfo.index(nid)]
            if nid == self.our_id:
                step.extend(self._handle_value(self.our_id, proof))
            else:
                step.send(nid, ValueMsg(proof))
        return step

    # -- messages ------------------------------------------------------
    def handle_message(self, sender: Any, message: Any, rng: Any) -> Step:
        step = Step.empty()
        if self._terminated:
            return step
        if not self._netinfo.is_node_validator(sender):
            return step.fault(sender, FAULT_NOT_PROPOSER)
        if isinstance(message, ValueMsg):
            if sender != self._proposer:
                return step.fault(sender, FAULT_NOT_PROPOSER)
            if not isinstance(message.proof, Proof) or not message.proof.well_formed():
                return step.fault(sender, FAULT_MALFORMED)
            return self._handle_value(sender, message.proof)
        if isinstance(message, EchoMsg):
            if not isinstance(message.proof, Proof) or not message.proof.well_formed():
                return step.fault(sender, FAULT_MALFORMED)
            return self._handle_echo(sender, message.proof)
        if isinstance(message, ReadyMsg):
            if not isinstance(message.root, bytes):
                return step.fault(sender, FAULT_MALFORMED)
            return self._handle_ready(sender, message.root)
        if isinstance(message, EchoHashMsg):
            if not isinstance(message.root, bytes):
                return step.fault(sender, FAULT_MALFORMED)
            return self._handle_echo_hash(sender, message.root)
        if isinstance(message, CanDecodeMsg):
            if not isinstance(message.root, bytes):
                return step.fault(sender, FAULT_MALFORMED)
            return self._handle_can_decode(sender, message.root)
        return step.fault(sender, FAULT_MALFORMED)

    # -- internals -----------------------------------------------------
    def _handle_value(self, sender: Any, proof: Proof) -> Step:
        step = Step.empty()
        if self._echo_sent:
            # A second Value with a different root is proposer equivocation.
            if self._echos.get(self.our_id) and proof.root != self._echos[self.our_id].root:
                step.fault(sender, FAULT_MULTIPLE_VALUES)
            return step
        if proof.index != self._netinfo.our_index or not proof.validate(
            self._netinfo.num_nodes
        ):
            return step.fault(sender, FAULT_INVALID_PROOF)
        self._echo_sent = True
        _trace.emit("rbc.value", proposer=self._proposer)
        # Full Echo (with the shard) to everyone still needing shards —
        # Target.all_except so observers (not in the validator set) keep
        # receiving shards — and hash-only Echo to peers that declared
        # CanDecode for this root.
        hash_only = frozenset(
            nid for nid, r in self._can_decode.items() if r == proof.root
        )
        step.send_targeted(Target.all_except(hash_only), EchoMsg(proof))
        if hash_only:
            step.send_targeted(Target.nodes(hash_only), EchoHashMsg(proof.root))
        step.extend(self._handle_echo(self.our_id, proof))
        return step

    def _handle_echo(self, sender: Any, proof: Proof) -> Step:
        step = Step.empty()
        if sender in self._echos:
            if self._echos[sender] != proof:
                step.fault(sender, FAULT_DUPLICATE)
            return step
        if proof.index != self._netinfo.index(sender):
            return step.fault(sender, FAULT_WRONG_INDEX)
        if not proof.validate(self._netinfo.num_nodes):
            return step.fault(sender, FAULT_INVALID_PROOF)
        if sender in self._echo_hashes and self._echo_hashes[sender] != proof.root:
            return step.fault(sender, FAULT_DUPLICATE)
        self._echos[sender] = proof
        n, f = self._netinfo.num_nodes, self._netinfo.num_faulty
        step.extend(self._maybe_can_decode(proof.root))
        if self._echo_count(proof.root) >= n - f and not self._ready_sent:
            step.extend(self._send_ready(proof.root))
        return step.extend(self._try_decode())

    def _echo_count(self, root: bytes) -> int:
        """Distinct senders vouching for ``root`` via Echo or EchoHash."""
        senders = {s for s, p in self._echos.items() if p.root == root}
        senders |= {s for s, r in self._echo_hashes.items() if r == root}
        return len(senders)

    def _handle_echo_hash(self, sender: Any, root: bytes) -> Step:
        step = Step.empty()
        if sender in self._echo_hashes or sender in self._echos:
            prev = self._echo_hashes.get(sender)
            prev_root = prev if prev is not None else self._echos[sender].root
            if prev_root != root:
                step.fault(sender, FAULT_DUPLICATE)
            return step
        self._echo_hashes[sender] = root
        n, f = self._netinfo.num_nodes, self._netinfo.num_faulty
        if self._echo_count(root) >= n - f and not self._ready_sent:
            step.extend(self._send_ready(root))
        return step.extend(self._try_decode())

    def _handle_can_decode(self, sender: Any, root: bytes) -> Step:
        step = Step.empty()
        if sender in self._can_decode:
            if self._can_decode[sender] != root:
                step.fault(sender, FAULT_DUPLICATE)
            return step
        self._can_decode[sender] = root
        return step

    def _maybe_can_decode(self, root: bytes) -> Step:
        """Announce CanDecode once K shards for ``root`` are stored.

        Observers follow the protocol silently (they are not in the
        validator set, so peers would fault their messages)."""
        step = Step.empty()
        if self._can_decode_sent or self._terminated:
            return step
        if not self._netinfo.is_validator():
            return step
        shards = sum(1 for p in self._echos.values() if p.root == root)
        if shards >= self._data_shards:
            self._can_decode_sent = True
            step.broadcast(CanDecodeMsg(root))
        return step

    def _handle_ready(self, sender: Any, root: bytes) -> Step:
        step = Step.empty()
        if sender in self._readys:
            if self._readys[sender] != root:
                step.fault(sender, FAULT_DUPLICATE)
            return step
        self._readys[sender] = root
        f = self._netinfo.num_faulty
        count = sum(1 for r in self._readys.values() if r == root)
        if count >= f + 1 and not self._ready_sent:
            step.extend(self._send_ready(root))
        return step.extend(self._try_decode())

    def _send_ready(self, root: bytes) -> Step:
        step = Step.empty()
        self._ready_sent = True
        _trace.emit("rbc.ready", proposer=self._proposer)
        step.broadcast(ReadyMsg(root))
        step.extend(self._handle_ready(self.our_id, root))
        return step

    def _try_decode(self) -> Step:
        step = Step.empty()
        if self._terminated:
            return step
        f = self._netinfo.num_faulty
        # A root with 2f+1 Readys is decodable once K shards are stored.
        from collections import Counter

        ready_roots = Counter(self._readys.values())
        for root, count in ready_roots.items():
            if count < 2 * f + 1:
                continue
            shards = {
                p.index: p.value for p in self._echos.values() if p.root == root
            }
            if len(shards) < self._data_shards:
                continue
            # A Byzantine proposer can commit a tree over unequal-length
            # (or otherwise undecodable) leaves; that is its fault, not a
            # crash.
            lengths = {len(s) for s in shards.values()}
            if len(lengths) != 1:
                self._terminated = True
                return step.fault(self._proposer, FAULT_BAD_ENCODING)
            try:
                data = self._rs.reconstruct(shards)
                full = self._rs.encode(data)
            except (ValueError, AssertionError):
                self._terminated = True
                return step.fault(self._proposer, FAULT_BAD_ENCODING)
            # Re-encode and re-hash: the root must commit to a consistent
            # codeword, else the proposer encoded garbage.
            if MerkleTree(full).root != root:
                self._terminated = True  # unrecoverable: proposer Byzantine
                return step.fault(self._proposer, FAULT_BAD_ENCODING)
            value = _unpack(tuple(data))
            if value is None:
                self._terminated = True
                return step.fault(self._proposer, FAULT_BAD_ENCODING)
            self._value = value
            self._terminated = True
            return step.with_output(value)
        return step


# Instances that :func:`batch_propose` sent down the per-instance host
# path instead of the device data plane, by reason: ``"gf16"`` (more
# than 255 validators: GF(2^16) is not on the device), ``"shard"`` (a
# shard over the device bound) or ``"single"`` (the only value of its
# shard length).  Callers reset and read it around a run.
HOST_ROUTE: Counter = Counter()


def batch_propose(broadcasts, values, device: DeviceLike = None):
    """Propose many values across many Broadcast instances at once.

    Computes every instance's RS shards + Merkle proofs with the batched
    device data plane (:mod:`hbbft_tpu_torch.ops.device.dataplane`) when
    shard sizes allow — one bit product and one Merkle tree launch for
    the whole batch — and takes the per-instance host path otherwise,
    counted in :data:`HOST_ROUTE`.  Returns one Step per instance (same
    semantics as calling ``handle_input`` on each).  ``device`` is where
    the data plane runs: ``cuda`` unless the caller passes ``"cpu"``.

    At firehose scale a proposer participates in many concurrent
    sessions/epochs; this is the aggregation point that turns N
    independent O(|v|) data-plane jobs into one device batch.
    """
    from collections import defaultdict

    from hbbft_tpu_torch.device import resolve

    assert len(broadcasts) == len(values)
    dev = resolve(device)
    steps: dict = {}
    groups = defaultdict(list)
    for idx, (bc, value) in enumerate(zip(broadcasts, values)):
        k, n = bc._data_shards, bc._netinfo.num_nodes
        _, shard_len = _dataplane()._pack(bytes(value), k)
        # The device dataplane is GF(256)-only; > 255 validators use the
        # GF(2^16) host codec via the ordinary propose path.
        if n <= 255 and shard_len <= _dataplane().MAX_DEV_SHARD:
            groups[(k, n, shard_len)].append(idx)
        else:
            HOST_ROUTE["gf16" if n > 255 else "shard"] += 1
            steps[idx] = bc.handle_input(bytes(value), None)
    for (k, n, _), idxs in groups.items():
        if len(idxs) == 1:
            i = idxs[0]
            HOST_ROUTE["single"] += 1
            steps[i] = broadcasts[i].handle_input(bytes(values[i]), None)
            continue
        proofs = _dataplane().encode_and_prove(
            [bytes(values[i]) for i in idxs], k, n, device=dev
        )
        for j, i in enumerate(idxs):
            steps[i] = broadcasts[i].propose_with_proofs(proofs[j])
    return [steps[i] for i in range(len(broadcasts))]


def _dataplane():
    from hbbft_tpu_torch.ops.device import dataplane

    return dataplane
