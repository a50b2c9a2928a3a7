"""ThresholdDecrypt: cooperative decryption of one threshold ciphertext.

Reference: upstream ``src/threshold_decrypt.rs`` (SURVEY.md §2 #7).  On
receiving the ciphertext each validator checks its validity (pairing
check), emits its decryption share, verifies every incoming share against
the ciphertext and the sender's public-key share (pairing check — hot
loop), and after ``f + 1`` valid shares combines them into the plaintext.

Shares arriving before the ciphertext are buffered raw and verified once
the ciphertext is known — asynchrony means peers may be ahead of us.

Combining is delegated to ``PublicKeySet.combine_decryption_shares``.

Copy of ``hbbft_tpu/protocols/threshold_decrypt.py``: the acceptance rules
(buffering, the terminated gate, fault timing) are the reference's, so
outputs and fault attribution are identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Set

from hbbft_tpu_torch.crypto.backend import VerifyRequest
from hbbft_tpu_torch.crypto.keys import Ciphertext, DecryptionShare
from hbbft_tpu_torch.crypto.pool import VerifySink
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.traits import ConsensusProtocol, Step

FAULT_INVALID_SHARE = "threshold_decrypt:invalid-share"
FAULT_NON_VALIDATOR = "threshold_decrypt:non-validator"
FAULT_DUPLICATE = "threshold_decrypt:duplicate-share"
FAULT_MALFORMED = "threshold_decrypt:malformed-message"


@dataclass(frozen=True)
class DecryptMessage:
    """Wire message: one decryption share."""

    share: DecryptionShare


class ThresholdDecrypt(ConsensusProtocol):
    """Outputs the plaintext ``bytes`` of the input ciphertext.

    If the input ciphertext itself is invalid, ``ciphertext_invalid``
    becomes True and the instance terminates without output — the parent
    (HoneyBadger) is responsible for faulting whoever proposed it.
    """

    def __init__(self, netinfo: NetworkInfo, sink: VerifySink) -> None:
        self._netinfo = netinfo
        self._sink = sink
        self._ciphertext: Optional[Ciphertext] = None
        self._ct_valid = False
        self.ciphertext_invalid = False
        self._buffered: Dict[Any, DecryptionShare] = {}
        self._verified: Dict[Any, DecryptionShare] = {}
        self._seen: Set[Any] = set()
        self._terminated = False
        self._plaintext: Optional[bytes] = None

    @property
    def our_id(self) -> Any:
        return self._netinfo.our_id

    @property
    def terminated(self) -> bool:
        return self._terminated

    @property
    def plaintext(self) -> Optional[bytes]:
        return self._plaintext

    def handle_input(self, input: Ciphertext, rng: Any) -> Step:
        """Provide the ciphertext to decrypt."""
        step = Step.empty()
        if self._ciphertext is not None or self._terminated:
            return step
        self._ciphertext = input
        self._sink.submit(
            VerifyRequest.ciphertext(input),
            lambda ok: self._on_ciphertext_checked(ok),
        )
        return step

    def handle_message(self, sender: Any, message: DecryptMessage, rng: Any) -> Step:
        step = Step.empty()
        if self._terminated:
            return step
        if not self._netinfo.is_node_validator(sender):
            return step.fault(sender, FAULT_NON_VALIDATOR)
        if not isinstance(message, DecryptMessage) or not isinstance(
            message.share, DecryptionShare
        ):
            return step.fault(sender, FAULT_MALFORMED)
        if sender in self._seen:
            return step.fault(sender, FAULT_DUPLICATE)
        self._seen.add(sender)
        if self._ct_valid:
            self._submit_share(sender, message.share)
        else:
            self._buffered[sender] = message.share
        return step

    # -- internal ------------------------------------------------------
    def _on_ciphertext_checked(self, ok: bool) -> Step:
        step = Step.empty()
        if self._terminated:
            return step
        if not ok:
            self.ciphertext_invalid = True
            self._terminated = True
            return step
        self._ct_valid = True
        if self._netinfo.is_validator():
            share = self._netinfo.secret_key_share.decryption_share(self._ciphertext)
            self._seen.add(self.our_id)
            self._verified[self.our_id] = share
            step.broadcast(DecryptMessage(share))
        buffered, self._buffered = self._buffered, {}
        for sender, share in buffered.items():
            self._submit_share(sender, share)
        return step.extend(self._try_output())

    def _submit_share(self, sender: Any, share: DecryptionShare) -> None:
        self._sink.submit(
            VerifyRequest.dec_share(
                self._netinfo.public_key_share(sender), self._ciphertext, share
            ),
            lambda ok, s=sender, sh=share: self._on_verified(s, sh, ok),
        )

    def _on_verified(self, sender: Any, share: DecryptionShare, ok: bool) -> Step:
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
        # One call: Lagrange combine + unmask.
        self._plaintext = pks.combine_decryption_shares(by_index, self._ciphertext)
        self._terminated = True
        return step.with_output(self._plaintext)
