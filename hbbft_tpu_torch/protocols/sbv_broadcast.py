"""Synchronized binary-value broadcast: the BVal/Aux stage of one ABA round.

Reference: upstream ``src/binary_agreement/sbv_broadcast.rs`` (SURVEY.md
§2 #5).  Properties (N = 3f+1): every value in ``bin_values`` was input
by a correct node; all correct nodes eventually share ``bin_values``;
completion delivers a set ``vals`` backed by N - f Aux messages.

Message flow: on input b, broadcast ``BVal(b)``.  On f+1 ``BVal(b)``,
relay ``BVal(b)`` (if not sent).  On 2f+1 ``BVal(b)``, insert b into
``bin_values``; the first insertion broadcasts ``Aux(b)``.  When N - f
``Aux`` messages carry values inside ``bin_values``, output ``vals`` =
the set of those values.

This class emits raw :class:`BValMsg`/:class:`AuxMsg`; the parent
BinaryAgreement wraps them with its round number.  Output: a single
``BoolSet`` in ``Step.output`` on completion (may re-fire with a larger
set if ``bin_values`` grows before the round advances, as upstream does).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Set

from hbbft_tpu_torch.protocols.bool_set import BoolSet
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.traits import Step

FAULT_DUPLICATE_BVAL = "sbv:duplicate-bval"
FAULT_DUPLICATE_AUX = "sbv:duplicate-aux"


@dataclass(frozen=True)
class BValMsg:
    value: bool


@dataclass(frozen=True)
class AuxMsg:
    value: bool


class SbvBroadcast:
    def __init__(self, netinfo: NetworkInfo) -> None:
        self._netinfo = netinfo
        self._bval_received: Dict[bool, Set[Any]] = {False: set(), True: set()}
        self._bval_sent: Set[bool] = set()
        self._aux_received: Dict[bool, Set[Any]] = {False: set(), True: set()}
        self._aux_sent = False
        self._termed_bval: Dict[bool, Set[Any]] = {False: set(), True: set()}
        self._termed_aux: Dict[bool, Set[Any]] = {False: set(), True: set()}
        self.bin_values = BoolSet.none()
        self._last_output: BoolSet | None = None

    def input(self, b: bool) -> Step:
        """Start the stage by broadcasting BVal(b)."""
        return self._send_bval(b)

    def handle_bval(self, sender: Any, b: bool) -> Step:
        step = Step.empty()
        if sender in self._bval_received[b]:
            if sender in self._termed_bval[b]:
                # The one real message racing its own Term evidence.
                self._termed_bval[b].discard(sender)
                return step
            return step.fault(sender, FAULT_DUPLICATE_BVAL)
        self._bval_received[b].add(sender)
        count = len(self._bval_received[b])
        f = self._netinfo.num_faulty
        if count >= f + 1 and b not in self._bval_sent:
            step.extend(self._send_bval(b))
        if count >= 2 * f + 1 and b not in self.bin_values:
            first = not self.bin_values
            self.bin_values = self.bin_values.insert(b)
            if first and not self._aux_sent:
                step.extend(self._send_aux(b))
            step.extend(self._try_output())
        return step

    def handle_aux(self, sender: Any, b: bool) -> Step:
        step = Step.empty()
        if sender in self._aux_received[b]:
            if sender in self._termed_aux[b]:
                # The one real message racing its own Term evidence.
                self._termed_aux[b].discard(sender)
                return step
            return step.fault(sender, FAULT_DUPLICATE_AUX)
        self._aux_received[b].add(sender)
        return step.extend(self._try_output())

    def add_term_evidence(self, sender: Any, b: bool) -> Step:
        """A Term(b) counts as this sender's BVal(b) and Aux(b) forever.

        The sender's genuine BVal/Aux may still be in flight (delivered
        after the Term under reordering); each gets ONE free pass — any
        further duplicate is flagged as Byzantine as usual.
        """
        step = Step.empty()
        if sender not in self._bval_received[b]:
            self._termed_bval[b].add(sender)
            step.extend(self.handle_bval(sender, b))
        if sender not in self._aux_received[b]:
            self._termed_aux[b].add(sender)
            step.extend(self.handle_aux(sender, b))
        return step

    # -- internals -----------------------------------------------------
    def _send_bval(self, b: bool) -> Step:
        step = Step.empty()
        if b in self._bval_sent:
            return step
        self._bval_sent.add(b)
        step.broadcast(BValMsg(b))
        step.extend(self.handle_bval(self._netinfo.our_id, b))
        return step

    def _send_aux(self, b: bool) -> Step:
        step = Step.empty()
        self._aux_sent = True
        step.broadcast(AuxMsg(b))
        step.extend(self.handle_aux(self._netinfo.our_id, b))
        return step

    def _try_output(self) -> Step:
        """Output vals once N - f Aux messages carry bin_values members."""
        step = Step.empty()
        if not self.bin_values:
            return step
        vals = BoolSet.none()
        count = 0
        for b in self.bin_values:
            senders = self._aux_received[b]
            if senders:
                vals = vals.insert(b)
                count += len(senders)
        # A sender may (faultily) Aux both values; count each sender once.
        all_senders = self._aux_received[False] | self._aux_received[True]
        count = min(count, len(all_senders))
        if count >= self._netinfo.num_correct and vals and vals != self._last_output:
            self._last_output = vals
            step.with_output(vals)
        return step
