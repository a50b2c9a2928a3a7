"""TransactionQueue: pending-transaction buffer with random proposal sampling.

Reference: upstream ``src/transaction_queue.rs`` (SURVEY.md §2 #11).
Proposals are a RANDOM sample of the queue — the HoneyBadger paper's
defense against censorship and cross-node duplication: if every node
proposed its queue head, an adversary could predict and suppress
specific transactions, and all nodes would propose the same ones.
"""

from __future__ import annotations

from typing import Any, Iterable, List


class TransactionQueue:
    """Default deque-backed implementation (upstream impl on VecDeque)."""

    def __init__(self, txns: Iterable[Any] = ()) -> None:
        self._txns: List[Any] = list(txns)

    def __len__(self) -> int:
        return len(self._txns)

    def __bool__(self) -> bool:
        return bool(self._txns)

    def extend(self, txns: Iterable[Any]) -> None:
        self._txns.extend(txns)

    def push(self, txn: Any) -> None:
        self._txns.append(txn)

    def remove_multiple(self, txns: Iterable[Any]) -> None:
        """Drop committed transactions (compares by equality).

        One O(queue + committed) pass: multiset-subtract the committed
        transactions (each committed occurrence removes at most one
        queued occurrence, matching per-item ``list.remove`` semantics).
        The old per-item scan was O(committed x queue) — quadratic at
        firehose batch sizes.  Unhashable transactions fall back to the
        equality scan (rare; transactions are normally plain data).
        """
        committed = list(txns)
        if not committed or not self._txns:
            return
        try:
            pending: dict = {}
            for t in committed:
                pending[t] = pending.get(t, 0) + 1
            kept: List[Any] = []
            for t in self._txns:
                n = pending.get(t, 0)
                if n:
                    pending[t] = n - 1
                else:
                    kept.append(t)
            self._txns = kept
        except TypeError:
            for t in committed:
                try:
                    self._txns.remove(t)
                except ValueError:
                    pass

    def choose(self, rng: Any, amount: int) -> List[Any]:
        """A random sample of up to ``amount`` pending transactions."""
        if amount >= len(self._txns):
            return list(self._txns)
        return rng.sample(self._txns, amount)
