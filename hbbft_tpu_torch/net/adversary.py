"""Adversary framework: scheduling control + Byzantine node control.

Reference: upstream ``tests/net/adversary.rs`` (``Adversary`` trait with
``pre_crank`` and ``tamper``; stock ``NullAdversary``,
``NodeOrderAdversary``, ``ReorderingAdversary``, ``RandomAdversary``).
SURVEY.md §4.

The adversary owns the faulty nodes: messages addressed to a faulty node
are handed to :meth:`Adversary.on_message_to_faulty`, which may inject
arbitrary messages "from" any faulty node in response; ``pre_crank`` may
reorder the pending queue (asynchrony is adversarial scheduling).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, List

if TYPE_CHECKING:
    from hbbft_tpu_torch.net.virtual_net import NetMessage, VirtualNet


class Adversary:
    """Base adversary: does nothing (crash-faulty faulty nodes)."""

    def pre_crank(self, net: "VirtualNet", rng: Any) -> None:
        """Inspect/reorder ``net.queue`` before the next delivery."""

    def on_message_to_faulty(
        self, net: "VirtualNet", msg: "NetMessage", rng: Any
    ) -> List["NetMessage"]:
        """React to a message delivered to an adversary-controlled node.

        Returns messages to inject into the network (sender must be a
        faulty node id).
        """
        return []

    def on_input_to_faulty(
        self, net: "VirtualNet", node_id: Any, input: Any, rng: Any
    ) -> List["NetMessage"]:
        """React to ``broadcast_input`` offering an input to a faulty
        node.  Crash-style adversaries ignore it (return []); algorithm-
        running adversaries feed it to ``net.faulty_nodes[node_id]``."""
        return []


class NullAdversary(Adversary):
    """FIFO delivery, silent faulty nodes."""


class NodeOrderAdversary(Adversary):
    """Delivers pending messages grouped by destination node order."""

    def pre_crank(self, net: "VirtualNet", rng: Any) -> None:
        if net.queue:
            net.queue.sort(key=lambda m: net.node_order.index(m.dest))


class ReorderingAdversary(Adversary):
    """Randomly swaps pending messages (bounded reordering)."""

    def __init__(self, swaps_per_crank: int = 8) -> None:
        self.swaps_per_crank = swaps_per_crank

    def pre_crank(self, net: "VirtualNet", rng: Any) -> None:
        q = net.queue
        for _ in range(min(self.swaps_per_crank, len(q))):
            i = rng.randrange(len(q))
            j = rng.randrange(len(q))
            q[i], q[j] = q[j], q[i]

    def on_message_to_faulty(self, net, msg, rng):
        return []


class TamperingAdversary(Adversary):
    """Runs the REAL algorithm on each faulty node and rewrites its
    outgoing messages: valid types, wrong contents (flipped BVals/Aux,
    corrupted Merkle proofs and roots, wrong-but-well-formed signature
    and decryption shares).  Upstream analog: ``tamper`` in
    ``tests/net/adversary.rs``.

    This exercises the hardest Byzantine class the stock adversaries
    missed: syntactically-valid-but-wrong protocol message streams.
    Correct nodes must still agree, and their fault logs must pin the
    faulty senders.  ``tamper_p`` < 1 interleaves honest and tampered
    traffic from the same faulty node (more adversarial than pure noise,
    which degenerates to crash-faulty behavior).
    """

    def __init__(self, tamper_p: float = 0.5) -> None:
        assert 0.0 <= tamper_p <= 1.0
        self.tamper_p = tamper_p
        self.tampered_count = 0

    # -- harness hooks --------------------------------------------------
    def on_input_to_faulty(self, net, node_id, input, rng):
        node = net.faulty_nodes.get(node_id)
        if node is None:
            return []
        step = node.protocol.handle_input(input, node.rng)
        return self._drive(net, node, step, rng)

    def on_message_to_faulty(self, net, msg, rng):
        node = net.faulty_nodes.get(msg.dest)
        if node is None:
            return []
        step = node.protocol.handle_message(msg.sender, msg.payload, node.rng)
        return self._drive(net, node, step, rng)

    # -- internals ------------------------------------------------------
    def _drive(self, net, node, step, rng) -> List["NetMessage"]:
        """Expand a faulty node's Step (and its deferred-verify flushes)
        into tampered network messages."""
        from hbbft_tpu_torch.net.virtual_net import NetMessage

        out: List[NetMessage] = []
        steps = [step]
        while node.pool:
            steps.append(node.pool.flush(net.backend))
        for s in steps:
            for tm in s.messages:
                payload = tm.message
                if rng.random() < self.tamper_p:
                    tampered = self._tamper(payload, rng)
                    if tampered is not payload:
                        self.tampered_count += 1
                    payload = tampered
                for dest in tm.target.recipients(net.node_order, node.id):
                    out.append(NetMessage(sender=node.id, dest=dest, payload=payload))
        return out

    def _tamper(self, payload: Any, rng: Any) -> Any:
        """Rewrite one protocol message: dispatch on the innermost
        protocol content, rebuilding the (frozen dataclass) envelope
        chain around it.  Unknown leaves pass through untouched."""
        import dataclasses

        from hbbft_tpu_torch.crypto.keys import DecryptionShare, SignatureShare
        from hbbft_tpu_torch.protocols.binary_agreement import ConfMsg, TermMsg
        from hbbft_tpu_torch.protocols.broadcast import (
            CanDecodeMsg,
            EchoHashMsg,
            EchoMsg,
            ReadyMsg,
            ValueMsg,
        )
        from hbbft_tpu_torch.protocols.bool_set import BoolSet
        from hbbft_tpu_torch.protocols.sbv_broadcast import AuxMsg, BValMsg
        from hbbft_tpu_torch.protocols.threshold_decrypt import DecryptMessage
        from hbbft_tpu_torch.protocols.threshold_sign import SignMessage

        def flip_root(root: bytes) -> bytes:
            return bytes([root[0] ^ 1]) + root[1:]

        t = type(payload)
        if t is BValMsg:
            return BValMsg(not payload.value)
        if t is AuxMsg:
            return AuxMsg(not payload.value)
        if t is TermMsg:
            return TermMsg(not payload.value)
        if t is ConfMsg:
            flipped = BoolSet.both() if len(payload.vals) < 2 else BoolSet.single(
                bool(rng.getrandbits(1))
            )
            return ConfMsg(flipped)
        if t is SignMessage:
            s = payload.share
            return SignMessage(SignatureShare(s.g2 * 2, s.suite))
        if t is DecryptMessage:
            s = payload.share
            return DecryptMessage(DecryptionShare(s.g1 * 2, s.suite))
        if t is ReadyMsg:
            return ReadyMsg(flip_root(payload.root))
        if t is EchoHashMsg:
            return EchoHashMsg(flip_root(payload.root))
        if t is CanDecodeMsg:
            return CanDecodeMsg(flip_root(payload.root))
        if t in (ValueMsg, EchoMsg):
            proof = payload.proof
            bad_value = (
                bytes([proof.value[0] ^ 1]) + proof.value[1:]
                if proof.value
                else b"\x01"
            )
            bad = dataclasses.replace(proof, value=bad_value)
            return t(bad)
        if dataclasses.is_dataclass(payload) and not isinstance(payload, type):
            # Envelope (SubsetMessage/HbMessage/DhbMessage/AbaMessage/
            # CoinMsg/SqMessage/...): recurse into its fields.
            changes = {}
            for f in dataclasses.fields(payload):
                v = getattr(payload, f.name)
                nv = self._tamper(v, rng)
                if nv is not v:
                    changes[f.name] = nv
            if changes:
                return dataclasses.replace(payload, **changes)
        return payload


class RandomAdversary(Adversary):
    """Picks a uniformly random pending message to deliver next, and
    echoes garbage-free random replays from faulty nodes with probability
    ``replay_p`` (replay = duplicate of a previously observed message)."""

    def __init__(self, replay_p: float = 0.0) -> None:
        self.replay_p = replay_p
        self._observed: List[Any] = []

    def pre_crank(self, net: "VirtualNet", rng: Any) -> None:
        if len(net.queue) > 1:
            i = rng.randrange(len(net.queue))
            net.queue[0], net.queue[i] = net.queue[i], net.queue[0]

    def on_message_to_faulty(self, net, msg, rng):
        from hbbft_tpu_torch.net.virtual_net import NetMessage

        self._observed.append(msg)
        out: List[NetMessage] = []
        if self.replay_p > 0 and rng.random() < self.replay_p and self._observed:
            replay = self._observed[rng.randrange(len(self._observed))]
            for dest in net.correct_ids:
                out.append(NetMessage(sender=msg.dest, dest=dest, payload=replay.payload))
        return out
