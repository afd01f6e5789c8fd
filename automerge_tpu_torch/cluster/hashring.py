"""Consistent hashing of document ids onto backend shard groups.

The router tier (cluster/router.py) places every durable document name
on one shard group (a leader plus its followers). Placement must be
stable across router restarts and minimally disruptive when groups join
or leave — the classic consistent-hash ring: each group projects
``vnodes`` points onto a 64-bit circle (sha256 of ``group:replica``),
a document maps to the first point clockwise of its own hash, and
adding or removing one group only moves the keys that landed on its
arcs (~1/N of the keyspace).

The ring is pure placement: migration overrides (a doc moved off its
hash-home by a live shard migration) live in the router, not here.

The port of ``automerge_tpu/cluster/hashring.py``, unchanged: both
packages place every name on the same group.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Hashable, List, Tuple


def _point(key: str) -> int:
    return int.from_bytes(
        hashlib.sha256(key.encode("utf-8")).digest()[:8], "big"
    )


class HashRing:
    """Stable key -> member placement with virtual nodes."""

    def __init__(self, members: List[Hashable] = (), vnodes: int = 64):
        if vnodes <= 0:
            raise ValueError("vnodes must be positive")
        self.vnodes = vnodes
        self._points: List[Tuple[int, Hashable]] = []
        self._members: Dict[Hashable, None] = {}
        for m in members:
            self.add(m)

    @property
    def members(self) -> List[Hashable]:
        return list(self._members)

    def add(self, member: Hashable) -> None:
        if member in self._members:
            return
        self._members[member] = None
        for i in range(self.vnodes):
            self._points.append((_point(f"{member}:{i}"), member))
        self._points.sort()

    def remove(self, member: Hashable) -> None:
        if member not in self._members:
            return
        del self._members[member]
        self._points = [(h, m) for h, m in self._points if m != member]

    def member_for(self, key: str) -> Hashable:
        """The member owning ``key``; raises when the ring is empty."""
        if not self._points:
            raise ValueError("hash ring has no members")
        h = _point(key)
        i = bisect.bisect_right(self._points, (h, ""))
        if i >= len(self._points):
            i = 0
        return self._points[i][1]

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: Hashable) -> bool:
        return member in self._members
