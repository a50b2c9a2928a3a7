"""Deferred-verification pool: the accumulate/flush contract.

Protocols submit :class:`~hbbft_tpu_torch.crypto.backend.VerifyRequest`s together
with a callback ``cb(ok: bool) -> Step``; a flush runs the whole pending
batch through the backend in one go and merges the callback steps.  With an
eager flush policy (flush after every delivered message) the observable
behavior matches the reference's inline verification; with an epoch-flush
policy the card sees one big pairing batch (BASELINE.json:5).

Nested protocols (HoneyBadger -> Subset -> BinaryAgreement ->
ThresholdSign) receive *scoped* sinks: each wrapping layer lifts the child
step produced by a verification callback into the parent's message type via
the same step-processing logic used for ordinary child steps — so async
verification results flow up the stack exactly like messages do.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

from hbbft_tpu_torch.crypto.backend import CryptoBackend, VerifyRequest
from hbbft_tpu_torch.protocols.traits import Step

Callback = Callable[[bool], Step]
Wrap = Callable[[Step], Step]


class VerifySink:
    """Interface protocols write verification requests to."""

    def submit(self, req: VerifyRequest, cb: Callback) -> None:
        raise NotImplementedError

    def scoped(self, wrap: Wrap) -> "VerifySink":
        return ScopedSink(self, wrap)


class ScopedSink(VerifySink):
    """Lifts callback steps through one protocol-nesting layer."""

    def __init__(self, inner: VerifySink, wrap: Wrap) -> None:
        self._inner = inner
        self._wrap = wrap

    def submit(self, req: VerifyRequest, cb: Callback) -> None:
        self._inner.submit(req, lambda ok: self._wrap(cb(ok)))


class VerifyPool(VerifySink):
    """Node-level pending-verification queue."""

    def __init__(self) -> None:
        self._items: List[Tuple[VerifyRequest, Callback]] = []

    def submit(self, req: VerifyRequest, cb: Callback) -> None:
        self._items.append((req, cb))

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def flush(self, backend: CryptoBackend) -> Step:
        """Verify everything currently pending; returns the merged step.

        Callbacks may submit *new* requests (e.g. a decrypt started by a
        subset output); those stay queued for the next flush.
        """
        items, self._items = self._items, []
        step = Step.empty()
        if not items:
            return step
        results = backend.verify_batch([req for req, _ in items])
        for (req, cb), ok in zip(items, results):
            step.extend(cb(ok))
        return step
