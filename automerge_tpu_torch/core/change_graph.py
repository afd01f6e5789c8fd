"""The change DAG: hash-indexed adjacency lists over applied changes.

Semantics mirror the reference (reference:
rust/automerge/src/change_graph.rs): index-based adjacency for cache-friendly
traversal, ``clock_for_heads`` derives a vector clock by ancestor traversal,
``remove_ancestors`` filters a change set down to those not already implied
by a peer's heads (used by the sync protocol).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Set

from .clock import Clock, ClockData


from ..errors import AutomergeError


class ChangeGraphError(AutomergeError):
    pass


class _Node:
    __slots__ = ("actor_idx", "seq", "max_op", "parents")

    def __init__(self, actor_idx: int, seq: int, max_op: int, parents: List[int]):
        self.actor_idx = actor_idx
        self.seq = seq
        self.max_op = max_op
        self.parents = parents


class ChangeGraph:
    def __init__(self):
        self._nodes: List[_Node] = []
        self._hashes: List[bytes] = []
        self._index: Dict[bytes, int] = {}
        self._clock_cache: Dict[frozenset, Clock] = {}

    def __len__(self) -> int:
        return len(self._nodes)

    def has(self, h: bytes) -> bool:
        return h in self._index

    def add_change(
        self, h: bytes, actor_idx: int, seq: int, max_op: int, deps: Iterable[bytes]
    ) -> None:
        if h in self._index:
            return
        parents = []
        for dep in deps:
            idx = self._index.get(dep)
            if idx is None:
                raise ChangeGraphError(f"missing dependency {dep.hex()}")
            parents.append(idx)
        self._index[h] = len(self._nodes)
        self._hashes.append(h)
        self._nodes.append(_Node(actor_idx, seq, max_op, parents))
        self._clock_cache.clear()

    def clock_for_heads(self, heads: Iterable[bytes]) -> Clock:
        key = frozenset(heads)
        cached = self._clock_cache.get(key)
        if cached is not None:
            return cached.copy()
        clock = Clock()
        stack = []
        for h in key:
            idx = self._index.get(h)
            if idx is None:
                raise ChangeGraphError(f"unknown head {h.hex()}")
            stack.append(idx)
        seen: Set[int] = set()
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            node = self._nodes[i]
            clock.include(node.actor_idx, ClockData(node.max_op, node.seq))
            stack.extend(node.parents)
        if len(self._clock_cache) > 64:
            self._clock_cache.clear()
        self._clock_cache[key] = clock
        return clock.copy()

    def remove_ancestors(self, changes: Set[bytes], heads: Iterable[bytes]) -> None:
        """Remove from ``changes`` every change that is an ancestor of ``heads``."""
        stack = [self._index[h] for h in heads if h in self._index]
        seen: Set[int] = set()
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            changes.discard(self._hashes[i])
            stack.extend(self._nodes[i].parents)

    def ancestor_hashes(self, heads: Iterable[bytes]) -> Set[bytes]:
        """All change hashes reachable from ``heads`` (inclusive)."""
        out: Set[bytes] = set()
        stack = [self._index[h] for h in heads if h in self._index]
        seen: Set[int] = set()
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            out.add(self._hashes[i])
            stack.extend(self._nodes[i].parents)
        return out
