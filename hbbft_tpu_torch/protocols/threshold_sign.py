"""ThresholdSign: cooperative threshold signature over a fixed document.

Reference: upstream ``src/threshold_sign.rs`` (SURVEY.md §2 #6).  Each
validator broadcasts its signature share of H(doc); incoming shares are
verified against the sender's public-key share (the pairing check — THE
hot loop, BASELINE.json:2/5); ``f + 1`` valid shares Lagrange-combine into
the unique deterministic master signature, which is the output.  Used
standalone and as the common coin of BinaryAgreement (coin value = parity
of the combined signature).

Batch-first deviation: share verification is *deferred* — submitted to the
:class:`~hbbft_tpu_torch.crypto.pool.VerifySink` and counted only once the batch
flush confirms it (SURVEY.md §7 "deferred-verify queue").

Copy of ``hbbft_tpu/protocols/threshold_sign.py``: the acceptance rules
(who is counted, when faults fire, the terminated gate) are the
reference's, so outputs and fault attribution are identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Set

from hbbft_tpu_torch.crypto.backend import VerifyRequest
from hbbft_tpu_torch.crypto.keys import Signature, SignatureShare
from hbbft_tpu_torch.crypto.pool import VerifySink
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.traits import ConsensusProtocol, Step

FAULT_INVALID_SHARE = "threshold_sign:invalid-share"
FAULT_NON_VALIDATOR = "threshold_sign:non-validator"
FAULT_DUPLICATE = "threshold_sign:duplicate-share"
FAULT_MALFORMED = "threshold_sign:malformed-message"


@dataclass(frozen=True)
class SignMessage:
    """Wire message: one signature share."""

    share: SignatureShare


class ThresholdSign(ConsensusProtocol):
    """Signs ``doc`` cooperatively; outputs the combined ``Signature``."""

    def __init__(self, netinfo: NetworkInfo, doc: bytes, sink: VerifySink) -> None:
        self._netinfo = netinfo
        self._doc = doc
        self._sink = sink
        self._verified: Dict[Any, SignatureShare] = {}
        self._seen: Set[Any] = set()
        self._had_input = False
        self._terminated = False
        self._signature: Optional[Signature] = None

    # -- ConsensusProtocol --------------------------------------------
    @property
    def our_id(self) -> Any:
        return self._netinfo.our_id

    @property
    def terminated(self) -> bool:
        return self._terminated

    @property
    def signature(self) -> Optional[Signature]:
        return self._signature

    def handle_input(self, input: Any, rng: Any) -> Step:
        """Start signing (input value is ignored, as in the reference).

        The share is broadcast even if we already terminated via peers'
        shares — otherwise slower peers could be starved of their
        (f+1)-th share forever (liveness).
        """
        if self._had_input:
            return Step.empty()
        self._had_input = True
        step = Step.empty()
        if not self._netinfo.is_validator():
            return step
        share = self._netinfo.secret_key_share.sign(self._doc)
        step.broadcast(SignMessage(share))
        if not self._terminated:
            self._seen.add(self.our_id)
            self._verified[self.our_id] = share  # own share needs no check
            step.extend(self._try_output())
        return step

    def handle_message(self, sender: Any, message: SignMessage, rng: Any) -> Step:
        step = Step.empty()
        if self._terminated:
            return step
        if not self._netinfo.is_node_validator(sender):
            return step.fault(sender, FAULT_NON_VALIDATOR)
        if not isinstance(message, SignMessage) or not isinstance(
            message.share, SignatureShare
        ):
            return step.fault(sender, FAULT_MALFORMED)
        if sender in self._seen:
            return step.fault(sender, FAULT_DUPLICATE)
        self._seen.add(sender)
        share = message.share
        self._sink.submit(
            VerifyRequest.sig_share(
                self._netinfo.public_key_share(sender), self._doc, share
            ),
            lambda ok, s=sender, sh=share: self._on_verified(s, sh, ok),
        )
        return step

    # -- internal ------------------------------------------------------
    def _on_verified(self, sender: Any, share: SignatureShare, ok: bool) -> Step:
        step = Step.empty()
        if self._terminated:
            return step
        if not ok:
            return step.fault(sender, FAULT_INVALID_SHARE)
        self._verified[sender] = share
        return step.extend(self._try_output())

    def _try_output(self) -> Step:
        step = Step.empty()
        pks = self._netinfo.public_key_set
        if self._terminated or len(self._verified) < pks.threshold + 1:
            return step
        by_index = {
            self._netinfo.index(nid): sh for nid, sh in self._verified.items()
        }
        self._signature = pks.combine_signatures(by_index)
        self._terminated = True
        return step.with_output(self._signature)
