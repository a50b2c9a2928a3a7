"""Typed errors for API misuse (caller bugs, not Byzantine input).

Reference: upstream per-module ``error.rs`` enums behind ``Result<Step,
Error>`` (SURVEY.md §2 #15).  The split here mirrors the reference's
philosophy: *Byzantine* input never raises — it lands in the
:class:`~hbbft_tpu_torch.protocols.fault_log.FaultLog` — while *caller* errors
(bad arguments, unencodable contributions, inputs to the wrong node)
raise typed exceptions the application can catch at the call site.
"""

from __future__ import annotations


class HbbftError(Exception):
    """Base for all typed API-misuse errors in this package."""


class ContributionNotEncodable(HbbftError, TypeError):
    """The proposed contribution (or transaction) contains a type the
    committed-bytes codec refuses.  Raised at the input boundary —
    before any protocol state changes — so a bad transaction cannot
    crash the node epochs later when it is finally sampled."""


class NotAValidator(HbbftError, ValueError):
    """The operation requires this node to be a current validator."""


class InvalidInput(HbbftError, ValueError):
    """Malformed argument to a protocol entry point."""
