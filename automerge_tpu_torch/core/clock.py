"""Vector clocks over interned actor indices.

Semantics mirror the reference (reference: rust/automerge/src/clock.rs):
``covers`` is THE historical-visibility primitive, the partial order includes
concurrency, and ``isolate`` pins an actor to u64::MAX so an isolated
transaction's own ops stay visible to itself.

The dense-array form of a clock (``as_dense``) is what the device kernel
consumes: historical reads become a vectorized ``counter <= clock[actor]``
mask over op columns.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

_MAX = (1 << 64) - 1


class ClockData(NamedTuple):
    max_op: int
    seq: int


class Clock:
    __slots__ = ("data",)

    def __init__(self, data: Dict[int, ClockData] | None = None):
        self.data: Dict[int, ClockData] = dict(data) if data else {}

    def include(self, actor_idx: int, data: ClockData) -> None:
        """Merge knowledge of ``actor_idx`` up to ``data`` (keep the max)."""
        cur = self.data.get(actor_idx)
        if cur is None or data.max_op > cur.max_op:
            self.data[actor_idx] = data

    def covers(self, opid) -> bool:
        """True iff an op with id (counter, actor_idx) is in this clock's past."""
        ctr, actor = opid
        cur = self.data.get(actor)
        return cur is not None and cur.max_op >= ctr

    def isolate(self, actor_idx: int) -> None:
        """Pin ``actor_idx`` so the isolated actor always sees its own ops."""
        self.data[actor_idx] = ClockData(_MAX, _MAX)

    def merge(self, other: "Clock") -> None:
        for a, d in other.data.items():
            self.include(a, d)

    def copy(self) -> "Clock":
        return Clock(self.data)

    def seq_of(self, actor_idx: int) -> int:
        cur = self.data.get(actor_idx)
        return cur.seq if cur else 0

    def max_op_of(self, actor_idx: int) -> int:
        cur = self.data.get(actor_idx)
        return cur.max_op if cur else 0

    def as_dense(self, n_actors: int) -> list:
        """Dense per-actor max_op vector for device-side visibility masks."""
        return [self.max_op_of(a) for a in range(n_actors)]

    # Partial order: returns "eq" | "lt" | "gt" | "concurrent"
    def compare(self, other: "Clock") -> str:
        le = all(other.max_op_of(a) >= d.max_op for a, d in self.data.items())
        ge = all(self.max_op_of(a) >= d.max_op for a, d in other.data.items())
        if le and ge:
            return "eq"
        if le:
            return "lt"
        if ge:
            return "gt"
        return "concurrent"

    def __eq__(self, other):
        if not isinstance(other, Clock):
            return NotImplemented
        return self.compare(other) == "eq"

    def __repr__(self):
        return f"Clock({self.data})"
