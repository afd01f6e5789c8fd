"""Marks (Peritext-style rich text): span resolution over the op store.

Mark begin/end pairs are zero-width invisible elements in the sequence
(reference: rust/automerge/src/transaction/inner.rs mark → do_insert).
Reading marks walks elements in document order, feeding mark ops through a
state machine that keeps open marks ordered by their begin OpId — the
highest Lamport id wins for each name — and accumulates coalesced spans
(reference: rust/automerge/src/marks.rs MarkStateMachine/MarkAccumulator,
rust/automerge/src/automerge.rs:1370-1413 calculate_marks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..types import ObjType
from .op_store import LIST_ENC, Op, SeqObject, TEXT_ENC


@dataclass
class Mark:
    start: int
    end: int
    name: str
    value: object


def is_mark_begin(op: Op) -> bool:
    return op.is_mark and op.mark_name is not None


def is_mark_end(op: Op) -> bool:
    return op.is_mark and op.mark_name is None


class MarkStateMachine:
    """Open-mark tracking: list of (begin_id, name, value) sorted by id."""

    def __init__(self, lamport_key):
        self._lamport_key = lamport_key
        self._open: List[Tuple[tuple, str, object]] = []

    def process(self, op: Op) -> None:
        if is_mark_begin(op):
            self._open.append((op.id, op.mark_name, op.value.to_py()))
            self._open.sort(key=lambda e: self._lamport_key(e[0]))
        elif is_mark_end(op):
            begin_id = (op.id[0] - 1, op.id[1])
            self._open = [e for e in self._open if e[0] != begin_id]

    def current(self) -> Dict[str, object]:
        """name -> value of the highest-id open mark per name (null values
        included here — they mask lower marks; outputs filter them)."""
        out: Dict[str, object] = {}
        for _, name, value in self._open:  # already lamport-ascending
            out[name] = value
        return out


def visible_or_mark(op: Op, clock) -> bool:
    if op.is_mark:
        return clock is None or clock.covers(op.id)
    return op.visible_at(clock)


def calculate_marks(doc, obj_id, clock=None) -> List[Mark]:
    """Resolved, coalesced mark spans for a sequence object."""
    from .document import AutomergeError

    info = doc.ops.get_obj(obj_id)
    data = info.data
    if not isinstance(data, SeqObject):
        raise AutomergeError("marks on a non-sequence object")
    enc = TEXT_ENC if data.obj_type == ObjType.TEXT else LIST_ENC
    machine = MarkStateMachine(doc.ops.lamport_key)
    index = 0
    spans: Dict[str, List[Mark]] = {}
    for el in data.elements():
        last = None
        for op in el.run():
            if visible_or_mark(op, clock):
                last = op
        if last is None:
            continue
        if last.is_mark:
            machine.process(last)
            continue
        if last.is_inc or last.is_delete:
            continue
        width = last.text_width() if enc == TEXT_ENC else 1
        current = machine.current()
        for name, value in current.items():
            runs = spans.setdefault(name, [])
            if runs and runs[-1].end == index and runs[-1].value == value:
                runs[-1].end = index + width
            else:
                runs.append(Mark(index, index + width, name, value))
        index += width
    out = [
        m
        for runs in spans.values()
        for m in runs
        if m.value is not None  # null-valued spans are unmarks
    ]
    out.sort(key=lambda m: (m.start, m.name))
    return out
