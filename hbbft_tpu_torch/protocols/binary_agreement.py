"""BinaryAgreement: Mostéfaoui-Moumen-Raynal asynchronous binary consensus.

Reference: upstream ``src/binary_agreement/binary_agreement.rs`` (SURVEY.md
§2 #5).  Rounds of: SBV-broadcast (BVal/Aux), a Conf stage, then the
common coin (a ThresholdSign over the round nonce, SURVEY.md §2 #6).
Decide when the singleton conf value equals the coin; ``Term(b)``
broadcast on decision lets others decide without further rounds (f + 1
matching Terms are decisive, and a Term counts as its sender's BVal/Aux
in every later round).

Safety does not rest on the coin (agreement holds for any coin values);
the unpredictable threshold-signature coin defeats the adaptive scheduler
that asynchronous liveness requires (tested by the MITM coin-delay
adversary, per the reference's ``binary_agreement_mitm.rs``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

from hbbft_tpu_torch.crypto.pool import VerifySink
from hbbft_tpu_torch.obs import trace as _trace
from hbbft_tpu_torch.protocols.bool_set import BoolSet
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.sbv_broadcast import AuxMsg, BValMsg, SbvBroadcast
from hbbft_tpu_torch.protocols.threshold_sign import SignMessage, ThresholdSign
from hbbft_tpu_torch.protocols.traits import ConsensusProtocol, Step
from hbbft_tpu_torch.utils import canonical_bytes

FAULT_DUPLICATE_CONF = "binary_agreement:duplicate-conf"
FAULT_DUPLICATE_TERM = "binary_agreement:duplicate-term"
FAULT_MALFORMED = "binary_agreement:malformed-message"


def _content_well_formed(content: Any) -> bool:
    if isinstance(content, (BValMsg, AuxMsg, TermMsg)):
        return isinstance(content.value, bool)
    if isinstance(content, ConfMsg):
        return isinstance(content.vals, BoolSet)
    if isinstance(content, CoinMsg):
        return isinstance(content.inner, SignMessage)
    return False

MAX_FUTURE_ROUNDS = 100  # bound per-sender buffering of rounds ahead of us


@dataclass(frozen=True)
class ConfMsg:
    vals: BoolSet


@dataclass(frozen=True)
class CoinMsg:
    inner: SignMessage


@dataclass(frozen=True)
class TermMsg:
    value: bool


@dataclass(frozen=True)
class AbaMessage:
    """All ABA wire messages are (round, content)-tagged."""

    round: int
    content: Any  # BValMsg | AuxMsg | ConfMsg | CoinMsg | TermMsg


class BinaryAgreement(ConsensusProtocol):
    """Agrees on one bool; ``session_id`` disambiguates coin documents
    across concurrent instances (e.g. per-proposer in Subset)."""

    def __init__(
        self, netinfo: NetworkInfo, session_id: bytes, sink: VerifySink
    ) -> None:
        self._netinfo = netinfo
        self._session_id = bytes(session_id)
        self._sink = sink
        self._round = 0
        self._sbv = SbvBroadcast(netinfo)
        self._conf_sent = False
        self._confs: Dict[Any, BoolSet] = {}
        self._term_confs: Set[Any] = set()  # synthetic entries from Terms
        self._coin: Optional[ThresholdSign] = None
        self._coin_requested = False
        self._coin_value: Optional[bool] = None
        self._conf_vals: Optional[BoolSet] = None
        self._estimate: Optional[bool] = None
        self._terms: Dict[bool, Set[Any]] = {False: set(), True: set()}
        self._term_senders: Set[Any] = set()
        self._future: List[Tuple[Any, AbaMessage]] = []
        self._decision: Optional[bool] = None
        self._terminated = False
        self._make_coin_for_round()  # shares may arrive before our input

    # -- ConsensusProtocol --------------------------------------------
    @property
    def our_id(self) -> Any:
        return self._netinfo.our_id

    @property
    def terminated(self) -> bool:
        return self._terminated

    @property
    def decision(self) -> Optional[bool]:
        return self._decision

    @property
    def round(self) -> int:
        return self._round

    def handle_input(self, input: bool, rng: Any) -> Step:
        if self._estimate is not None or self._terminated:
            return Step.empty()
        self._estimate = bool(input)
        # Flight-recorder milestone (round 16): a BA instance stuck at
        # round 0 emits no ba.round (that fires on ADVANCE), so without
        # this the stall diagnostician cannot tell "BA started, stuck"
        # from "BA never received its input".  Mirrored by the native
        # engine's TR_BA_INPUT.
        _trace.emit("ba.input", round=self._round, value=int(input))
        return self._wrap(self._sbv.input(self._estimate))

    def handle_message(self, sender: Any, message: AbaMessage, rng: Any) -> Step:
        step = Step.empty()
        if (
            not isinstance(message, AbaMessage)
            or not isinstance(message.round, int)
            or isinstance(message.round, bool)
            or not _content_well_formed(message.content)
        ):
            return step.fault(sender, FAULT_MALFORMED)
        content = message.content
        if isinstance(content, TermMsg):
            return self._handle_term(sender, content.value)
        if self._terminated:
            return step
        if message.round < self._round:
            return step  # stale round: drop silently (reference behavior)
        if message.round > self._round:
            if (
                message.round - self._round <= MAX_FUTURE_ROUNDS
                and sum(1 for s, _ in self._future if s == sender) < 4 * MAX_FUTURE_ROUNDS
            ):
                self._future.append((sender, message))
            return step
        if isinstance(content, BValMsg):
            step.extend(self._wrap(self._sbv.handle_bval(sender, content.value)))
        elif isinstance(content, AuxMsg):
            step.extend(self._wrap(self._sbv.handle_aux(sender, content.value)))
        elif isinstance(content, ConfMsg):
            step.extend(self._handle_conf(sender, content.vals))
        elif isinstance(content, CoinMsg):
            step.extend(self._handle_coin_msg(sender, content.inner))
        return step

    # -- step wrapping -------------------------------------------------
    def _wrap(self, sbv_step: Step) -> Step:
        """Lift an SBV step: tag messages with the round; react to output."""
        rnd = self._round
        step = sbv_step.map_messages(lambda m: AbaMessage(rnd, m))
        outputs, step.output = step.output, []
        for vals in outputs:
            step.extend(self._on_sbv_vals(vals))
        return step

    def _on_sbv_vals(self, vals: BoolSet) -> Step:
        step = Step.empty()
        if not self._conf_sent:
            self._conf_sent = True
            step.broadcast(AbaMessage(self._round, ConfMsg(self._sbv.bin_values)))
            step.extend(self._handle_conf(self.our_id, self._sbv.bin_values))
        else:
            step.extend(self._try_start_coin())
        return step

    # -- conf stage ----------------------------------------------------
    def _handle_conf(self, sender: Any, vals: BoolSet) -> Step:
        step = Step.empty()
        if sender in self._confs:
            # A synthetic conf seeded from this sender's Term is not the
            # sender's fault — its real Conf may arrive afterwards.
            if sender not in self._term_confs:
                step.fault(sender, FAULT_DUPLICATE_CONF)
            return step
        self._confs[sender] = vals
        return step.extend(self._try_start_coin())

    def _try_start_coin(self) -> Step:
        step = Step.empty()
        if self._coin_requested or not self._conf_sent:
            return step
        accepted = [
            v for v in self._confs.values() if v.is_subset(self._sbv.bin_values)
        ]
        if len(accepted) < self._netinfo.num_correct:
            return step
        self._coin_requested = True
        vals = BoolSet.none()
        for v in accepted:
            vals = vals.union(v)
        self._conf_vals = vals
        assert self._coin is not None
        step.extend(self._wrap_coin(self._coin.handle_input(None, None)))
        # The coin may already have flipped from peers' shares alone.
        return step.extend(self._maybe_advance())

    # -- common coin ---------------------------------------------------
    def _coin_doc(self) -> bytes:
        return canonical_bytes(b"aba-coin", self._session_id, self._round)

    def _make_coin_for_round(self) -> Step:
        """Create the round's coin instance (receives shares before we
        request our own flip)."""
        rnd = self._round
        sink = self._sink.scoped(lambda s, r=rnd: self._coin_scope_wrap(r, s))
        self._coin = ThresholdSign(self._netinfo, self._coin_doc(), sink)
        return Step.empty()

    def _coin_scope_wrap(self, rnd: int, child_step: Step) -> Step:
        if rnd != self._round or self._terminated:
            # Result of a verification from an already-finished round.
            return Step(output=[], messages=[], fault_log=child_step.fault_log)
        return self._wrap_coin(child_step)

    def _wrap_coin(self, coin_step: Step) -> Step:
        rnd = self._round
        step = coin_step.map_messages(lambda m: AbaMessage(rnd, CoinMsg(m)))
        outputs, step.output = step.output, []
        for sig in outputs:
            step.extend(self._on_coin(sig.parity()))
        return step

    def _handle_coin_msg(self, sender: Any, inner: SignMessage) -> Step:
        assert self._coin is not None
        return self._wrap_coin(self._coin.handle_message(sender, inner, None))

    def _on_coin(self, s: bool) -> Step:
        """Record the coin flip; advance once the conf stage is also done.

        The coin can complete from peers' shares alone, before our own
        conf threshold is reached — stash the value in that case.
        """
        self._coin_value = s
        _trace.emit("ba.coin", round=self._round, value=int(s))
        return self._maybe_advance()

    def _maybe_advance(self) -> Step:
        step = Step.empty()
        if self._terminated or self._coin_value is None or self._conf_vals is None:
            return step
        s = self._coin_value
        definite = self._conf_vals.definite()
        if definite is not None:
            if definite == s:
                return self._decide(definite)
            self._estimate = definite
        else:
            self._estimate = s
        return step.extend(self._next_round())

    # -- rounds and termination ---------------------------------------
    def _next_round(self) -> Step:
        self._round += 1
        _trace.emit("ba.round", round=self._round)
        self._sbv = SbvBroadcast(self._netinfo)
        self._conf_sent = False
        self._confs = {}
        self._coin_requested = False
        self._coin_value = None
        self._conf_vals = None
        step = self._make_coin_for_round()
        # Terms seen so far seed the new round's BVal/Aux/Conf evidence —
        # decided nodes no longer participate, so without this the N - f
        # conf threshold could become unreachable (deadlock).
        for b in (False, True):
            for sender in self._terms[b]:
                step.extend(self._wrap(self._sbv.add_term_evidence(sender, b)))
                self._confs.setdefault(sender, BoolSet.single(b))
                self._term_confs.add(sender)
        step.extend(self._wrap(self._sbv.input(self._estimate)))
        # Replay buffered messages that now belong to the current round.
        future, self._future = self._future, []
        for sender, msg in future:
            step.extend(self.handle_message(sender, msg, None))
        return step

    def _handle_term(self, sender: Any, b: bool) -> Step:
        step = Step.empty()
        if sender in self._term_senders:
            if sender not in self._terms[b]:
                step.fault(sender, FAULT_DUPLICATE_TERM)
            return step
        self._term_senders.add(sender)
        self._terms[b].add(sender)
        if not self._terminated:
            if len(self._terms[b]) >= self._netinfo.num_faulty + 1:
                return step.extend(self._decide(b))
            step.extend(self._wrap(self._sbv.add_term_evidence(sender, b)))
            if sender not in self._confs:
                self._term_confs.add(sender)
                step.extend(self._handle_conf(sender, BoolSet.single(b)))
        return step

    def _decide(self, b: bool) -> Step:
        step = Step.empty()
        if self._terminated:
            return step
        self._decision = b
        self._terminated = True
        _trace.emit("ba.decide", round=self._round, value=int(b))
        step.broadcast(AbaMessage(self._round, TermMsg(b)))
        return step.with_output(b)
