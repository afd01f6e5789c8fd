"""PatchLog: the live observer cursor feeding materialized views.

Reference surface: rust/automerge/src/patches/patch_log.rs — a PatchLog
with an active/inactive switch that every mutating path feeds, drained by
``make_patches``. This implementation records the *heads cursor* instead
of per-op events: draining diffs cursor→current through patches/diff.py.
That one design choice makes every mutation route uniform — per-op apply,
the bulk rebuild (core/bulk_load.py), the device merge kernel, and
load all advance the same cursor — where an event log would need bespoke
instrumentation in each (and could not observe the batched paths at all).
The produced patches are identical to the reference's collapsed event
stream: applying them to the before-state materializes the after-state
(tests/test_patches.py, tests/test_patch_log.py).

Drain cost matches the reference's O(ops applied) event log: the cursor
also records the history length and the cursor CLOCK, so a drain diffs
only the runs touched by the changes appended since (diff_incremental) and
builds the after-clock by extending the cached cursor clock with those
changes — no ancestor traversal, no whole-document walk. The full walk
remains the fallback (first drain, or when the fast path declines).

When inactive, draining is a no-op and nothing is computed — the hot
paths pay nothing (reference: patch_log.rs:105-152 active/inactive).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..core.clock import ClockData
from .diff import diff, diff_incremental
from .patch import Patch


class PatchLog:
    __slots__ = ("active", "_cursor", "text_rep", "_cursor_len", "_cursor_clock")

    def __init__(self, active: bool = True, text_rep: str = "string"):
        self.active = active
        self._cursor: Optional[List[bytes]] = None  # None = materialize all
        self._cursor_len: Optional[int] = None  # history length at cursor
        self._cursor_clock = None  # Clock at cursor (fast-drain cache)
        self.text_rep = text_rep

    def set_active(self, active: bool) -> None:
        self.active = active

    def is_active(self) -> bool:
        return self.active

    def _advance(self, doc, heads, clock) -> None:
        self._cursor = heads
        self._cursor_len = len(doc.history)
        self._cursor_clock = clock

    def reset(self, doc) -> None:
        """Move the cursor to the document's current heads."""
        heads = doc.get_heads()
        self._advance(doc, heads, doc.clock_at(heads))

    def make_patches(self, doc) -> List[Patch]:
        """Drain: patches covering everything since the cursor (or the whole
        current state when the cursor was never set — the load /
        current_state case, reference automerge/current_state.rs).

        Runs under the document's text encoding: patch indices count in
        its width unit."""
        from ..types import using_text_encoding

        with using_text_encoding(getattr(doc, "text_encoding", None)):
            return self._make_patches(doc)

    def _make_patches(self, doc) -> List[Patch]:
        after = doc.get_heads()
        if not self.active:
            self._advance(doc, after, None)
            return []
        before = self._cursor
        if (
            before is not None
            and self._cursor_len is not None
            and self._cursor_clock is not None
        ):
            new = doc.history[self._cursor_len:]
            if not new and before == after:
                return []
            # after-clock = cursor clock + the appended changes' own actor
            # data (their other ancestors are all at-or-before the cursor;
            # AppliedChange carries the translated actor index)
            after_clock = self._cursor_clock.copy()
            for a in new:
                after_clock.include(
                    a.actor_idx, ClockData(a.stored.max_op, a.stored.seq)
                )
            patches = diff_incremental(
                doc, self._cursor_clock, after_clock, new
            )
            if patches is None:
                patches = diff(doc, before, after)
                after_clock = doc.clock_at(after)
            self._advance(doc, after, after_clock)
            return patches
        patches = diff(doc, before if before is not None else [], after)
        self._advance(doc, after, doc.clock_at(after))
        return patches


PatchCallback = Callable[[List[Patch]], None]
