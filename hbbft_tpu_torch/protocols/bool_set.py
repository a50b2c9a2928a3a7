"""BoolSet: the four subsets of {True, False} as a tiny value type.

Reference: upstream ``src/binary_agreement/bool_set.rs`` (SURVEY.md §2 #5).
"""

from __future__ import annotations

from typing import Iterator

_NONE = 0
_FALSE = 1
_TRUE = 2
_BOTH = 3


class BoolSet:
    """Immutable subset of {False, True} backed by a 2-bit mask."""

    __slots__ = ("mask",)

    def __init__(self, mask: int = 0) -> None:
        assert 0 <= mask <= 3
        object.__setattr__(self, "mask", mask)

    def __setattr__(self, *a) -> None:  # immutability
        raise AttributeError("BoolSet is immutable")

    @staticmethod
    def none() -> "BoolSet":
        return BoolSet(_NONE)

    @staticmethod
    def both() -> "BoolSet":
        return BoolSet(_BOTH)

    @staticmethod
    def single(b: bool) -> "BoolSet":
        return BoolSet(_TRUE if b else _FALSE)

    def insert(self, b: bool) -> "BoolSet":
        return BoolSet(self.mask | (_TRUE if b else _FALSE))

    def __contains__(self, b: bool) -> bool:
        return bool(self.mask & (_TRUE if b else _FALSE))

    def is_subset(self, other: "BoolSet") -> bool:
        return (self.mask & ~other.mask) == 0

    def union(self, other: "BoolSet") -> "BoolSet":
        return BoolSet(self.mask | other.mask)

    def definite(self) -> bool | None:
        """The single element, if this is a singleton."""
        if self.mask == _TRUE:
            return True
        if self.mask == _FALSE:
            return False
        return None

    def __iter__(self) -> Iterator[bool]:
        if self.mask & _FALSE:
            yield False
        if self.mask & _TRUE:
            yield True

    def __len__(self) -> int:
        return bin(self.mask).count("1")

    def __bool__(self) -> bool:
        return self.mask != 0

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BoolSet) and self.mask == other.mask

    def __hash__(self) -> int:
        return self.mask

    def __repr__(self) -> str:
        return f"BoolSet({set(self) or '{}'})"
