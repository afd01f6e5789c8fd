"""Interning cache: value <-> dense index, insertion-ordered.

Mirrors the reference's IndexedCache (reference:
rust/automerge/src/indexed_cache.rs) plus a byte-rank table used by the
columnar layers: Lamport ties break on actor *bytes*, so device kernels need
an index->rank permutation that sorts identically to the raw bytes.
"""

from __future__ import annotations

from typing import Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")


class IndexedCache(Generic[T]):
    __slots__ = ("items", "_lookup", "_ranks", "_ranks_dirty")

    def __init__(self):
        self.items: List[T] = []
        self._lookup: Dict[T, int] = {}
        self._ranks: List[int] = []
        self._ranks_dirty = False

    def cache(self, value: T) -> int:
        idx = self._lookup.get(value)
        if idx is None:
            idx = len(self.items)
            self.items.append(value)
            self._lookup[value] = idx
            self._ranks_dirty = True
        return idx

    def lookup(self, value: T) -> Optional[int]:
        return self._lookup.get(value)

    def get(self, idx: int) -> T:
        return self.items[idx]

    def safe_get(self, idx: int) -> Optional[T]:
        if 0 <= idx < len(self.items):
            return self.items[idx]
        return None

    def remove_last(self) -> T:
        value = self.items.pop()
        del self._lookup[value]
        self._ranks_dirty = True
        return value

    def __len__(self) -> int:
        return len(self.items)

    def __contains__(self, value: T) -> bool:
        return value in self._lookup

    def __iter__(self):
        return iter(self.items)

    def ranks(self) -> List[int]:
        """rank[i] = position of item i in sorted order of the items.

        Used so (counter, rank[actor_idx]) sorts identically to
        (counter, actor bytes) in packed integer keys on device.
        """
        if self._ranks_dirty or len(self._ranks) != len(self.items):
            order = sorted(range(len(self.items)), key=lambda i: self.items[i])
            self._ranks = [0] * len(self.items)
            for rank, i in enumerate(order):
                self._ranks[i] = rank
            self._ranks_dirty = False
        return self._ranks

    def sorted_order(self) -> List[int]:
        """Indices of items in sorted order (the save-time actor permutation)."""
        return sorted(range(len(self.items)), key=lambda i: self.items[i])

    def copy(self) -> "IndexedCache[T]":
        c = IndexedCache()
        c.items = list(self.items)
        c._lookup = dict(self._lookup)
        c._ranks = list(self._ranks)
        c._ranks_dirty = self._ranks_dirty
        return c
