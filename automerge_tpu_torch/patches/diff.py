"""Diff: patches that transform the document state at one set of heads
into the state at another.

Semantics mirror the reference (reference: rust/automerge/src/automerge/
diff.rs log_diff): for every key pick the winning op at each clock and
emit New / Delete / Update / Increment patches; sequences walk elements in
document order with indices tracked against the evolving (before→after)
state so patches apply cleanly in order.

Host implementation over the op store; the per-key winner-at-clock
comparison is the same computation the device kernel performs with clock
masks (``counter <= clock[actor]`` — vectorized Clock::covers), so a
device-resident diff for huge histories is a planned extension of
ops/merge.py rather than a redesign.
"""

from __future__ import annotations

from typing import List, Optional

from ..core.clock import Clock
from ..core.op_store import MapObject, Op, OpStoreError, ROOT_OBJ
from ..types import ObjType, is_make_action
from .patch import (
    DeleteMap,
    DeleteSeq,
    FlagConflict,
    IncrementPatch,
    Insert,
    MarkPatch,
    Patch,
    PutMap,
    PutSeq,
    SpliceText,
)


def diff(doc, before_heads: List[bytes], after_heads: List[bytes]) -> List[Patch]:
    """Patches turning the state at ``before_heads`` into ``after_heads``."""
    before = doc.clock_at(before_heads) if before_heads is not None else Clock()
    after = doc.clock_at(after_heads)
    patches: List[Patch] = []
    _diff_obj(doc, ROOT_OBJ, before, after, patches, path=[])
    return patches


def _winner(ops: List[Op], clock) -> Optional[Op]:
    vis = [o for o in ops if o.visible_at(clock)]
    return vis[-1] if vis else None


def _render(doc, op: Op, clock):
    """Patch value of a winning op: hydrated subtree / counter / scalar."""
    if is_make_action(op.action):
        return doc._hydrate(op.id, clock)
    if op.is_counter:
        return op.counter_value_at(clock)
    return op.value.to_py()


def _diff_obj(doc, obj_id, before, after, patches, path):
    info = doc.ops.get_obj(obj_id)
    exid = doc.export_id(obj_id)
    if isinstance(info.data, MapObject):
        _diff_map(doc, obj_id, exid, info.data, before, after, patches, path)
    elif info.data.obj_type == ObjType.TEXT:
        _diff_text(doc, obj_id, exid, info.data, before, after, patches, path)
        _diff_marks(doc, exid, info.data, before, after, patches, path)
    else:
        _diff_list(doc, obj_id, exid, info.data, before, after, patches, path)
        _diff_marks(doc, exid, info.data, before, after, patches, path)


def _diff_marks(doc, exid, data, before, after, patches, path):
    """Emit a MarkPatch when the resolved mark spans differ between the two
    clocks (reference: diff.rs MarkDiff). Replace-all semantics: the patch
    carries the FULL after-state span set for the object; consumers
    replace its marks wholesale. Span positions shift with plain text
    edits inside marked ranges, so this compares resolved spans, not mark
    ops. Skipped wholesale for never-marked objects (block mark counts)."""
    if not any(b.marks for b in data.blocks):
        return
    mb = doc.marks(exid, clock=before)
    ma = doc.marks(exid, clock=after)

    def key(ms):
        return [(m.start, m.end, m.name, m.value) for m in ms]

    if key(mb) != key(ma):
        patches.append(Patch(exid, list(path), MarkPatch(list(ma))))


def _diff_map_key(doc, exid, key, run, before, after, patches, path):
    """Diff ONE map run; returns the winner when both clocks agree on a
    make op (the caller may recurse into it)."""
    wb = _winner(run, before)
    wa = _winner(run, after)
    if wa is None:
        if wb is not None:
            patches.append(Patch(exid, list(path), DeleteMap(key)))
        return None
    conflict = sum(o.visible_at(after) for o in run) > 1
    if wb is None or wb.id != wa.id:
        patches.append(
            Patch(exid, list(path), PutMap(key, _render(doc, wa, after), conflict))
        )
    elif wa.is_counter:
        delta = wa.counter_value_at(after) - wb.counter_value_at(before)
        if delta:
            patches.append(Patch(exid, list(path), IncrementPatch(key, delta)))
    elif conflict and sum(o.visible_at(before) for o in run) <= 1:
        patches.append(Patch(exid, list(path), FlagConflict(key)))
    if is_make_action(wa.action) and wb is not None and wb.id == wa.id:
        return wa
    return None


def _diff_map(doc, obj_id, exid, data, before, after, patches, path):
    for key_idx in sorted(data.props, key=lambda k: doc.props.get(k)):
        run = data.props[key_idx]
        key = doc.props.get(key_idx)
        wa = _diff_map_key(doc, exid, key, run, before, after, patches, path)
        if wa is not None:
            _diff_obj(doc, wa.id, before, after, patches, path + [(exid, key)])


class _ListEmitter:
    """Per-element list-diff state machine, shared by the full walk (running
    index) and the incremental drain (computed index): emits
    Insert/Delete/Put/Increment/FlagConflict with insert/delete coalescing.

    ``visit`` takes ``idx`` = the element's hybrid position (count of
    after-visible elements before it — identical to the full walk's running
    counter) and returns the winner to recurse into, if any."""

    def __init__(self, doc, exid, path, before, after, patches):
        self.doc, self.exid, self.path = doc, exid, list(path)
        self.before, self.after, self.patches = before, after, patches
        self.pending_ins = None  # (index, [values])

    def _flush(self):
        if self.pending_ins is not None:
            self.patches.append(
                Patch(self.exid, list(self.path), Insert(*self.pending_ins))
            )
            self.pending_ins = None

    def visit(self, el, wb, wa, idx):
        doc, exid, path = self.doc, self.exid, self.path
        before, after, patches = self.before, self.after, self.patches
        if wa is not None and wb is None:
            if (
                self.pending_ins is None
                or self.pending_ins[0] + len(self.pending_ins[1]) != idx
            ):
                self._flush()
                self.pending_ins = (idx, [])
            self.pending_ins[1].append(_render(doc, wa, after))
            return None
        self._flush()
        if wa is None:
            # element disappeared: coalesce with a preceding delete
            last = patches[-1] if patches else None
            if (
                last is not None
                and last.obj == exid
                and isinstance(last.action, DeleteSeq)
                and last.action.index == idx
            ):
                last.action.length += 1
            else:
                patches.append(Patch(exid, list(path), DeleteSeq(idx)))
            return None
        conflict = len(el.visible_ops(after)) > 1
        if wb.id != wa.id:
            patches.append(
                Patch(exid, list(path), PutSeq(idx, _render(doc, wa, after), conflict))
            )
        elif wa.is_counter:
            delta = wa.counter_value_at(after) - wb.counter_value_at(before)
            if delta:
                patches.append(Patch(exid, list(path), IncrementPatch(idx, delta)))
        elif conflict and len(el.visible_ops(before)) <= 1:
            patches.append(Patch(exid, list(path), FlagConflict(idx)))
        if is_make_action(wa.action) and wb.id == wa.id:
            return wa
        return None


class _TextEmitter:
    """Per-element text-diff state machine (splice/delete coalescing);
    ``idx`` is the element's hybrid text position (sum of after-visible
    character lengths before it)."""

    def __init__(self, exid, path, before, after, patches):
        self.exid, self.path = exid, list(path)
        self.before, self.after, self.patches = before, after, patches
        self.pending = None  # [index, str]

    def _flush(self):
        if self.pending is not None:
            self.patches.append(
                Patch(self.exid, list(self.path), SpliceText(*self.pending))
            )
            self.pending = None

    def visit(self, el, wb, wa, idx):
        exid, path, patches = self.exid, self.path, self.patches
        sa = _char(wa) if wa is not None else None
        sb = _char(wb) if wb is not None else None
        if wa is not None and wb is None:
            if self.pending is None or self.pending[0] + len(self.pending[1]) != idx:
                self._flush()
                self.pending = [idx, ""]
            self.pending[1] += sa
            return None
        self._flush()
        if wa is None:
            last = patches[-1] if patches else None
            if (
                last is not None
                and last.obj == exid
                and isinstance(last.action, DeleteSeq)
                and last.action.index == idx
            ):
                last.action.length += len(sb)
            else:
                patches.append(Patch(exid, list(path), DeleteSeq(idx, len(sb))))
            return None
        if wb.id != wa.id and (sa != sb):
            patches.append(Patch(exid, list(path), DeleteSeq(idx, len(sb))))
            patches.append(Patch(exid, list(path), SpliceText(idx, sa)))
        return None


def _diff_list(doc, obj_id, exid, data, before, after, patches, path):
    em = _ListEmitter(doc, exid, path, before, after, patches)
    idx = 0
    for el in data.elements():
        wb = el.winner(before)
        wa = el.winner(after)
        if wa is None and wb is None:
            continue
        w = em.visit(el, wb, wa, idx)
        if w is not None:
            _diff_obj(doc, w.id, before, after, patches, path + [(exid, idx)])
        if wa is not None:
            idx += 1
    em._flush()


def _diff_text(doc, obj_id, exid, data, before, after, patches, path):
    em = _TextEmitter(exid, path, before, after, patches)
    idx = 0
    for el in data.elements():
        wb = el.winner(before)
        wa = el.winner(after)
        if wa is None and wb is None:
            continue
        em.visit(el, wb, wa, idx)
        if wa is not None:
            idx += len(_char(wa))
    em._flush()


def _char(op: Op) -> str:
    return op.value.value if op.value.tag == "str" else "￼"


# -- incremental drain --------------------------------------------------------
#
# The reference's PatchLog costs O(ops applied) because it records events at
# apply time (reference: patches/patch_log.rs:43-103). The heads-cursor
# design here recovers the same asymptotics at DRAIN time instead: the new
# changes since the cursor name exactly the (object, key/element) runs that
# can have changed, each touched run re-diffs in isolation, and sequence
# positions resolve through the block order-statistics index (O(sqrt n))
# rather than a whole-object walk. Anything the fast path cannot prove it
# handles returns None and the caller falls back to the full walk.


def diff_incremental(doc, before, after, new_applied) -> Optional[List[Patch]]:
    """Patches for ``before -> after`` (clocks) derived from the
    ``new_applied`` AppliedChanges only; None when a precondition fails
    (caller uses the full diff).

    Cost: O(new ops) to collect touched runs + O(block) per touched
    sequence element (positions resolve through a per-object block prefix
    sum) + O(run) per touched run — independent of document size.

    Precondition (checked): the op store reflects exactly the ``after``
    clock — a live transaction's eagerly-applied ops would skew
    current-state positions, so callers must drain only at commit
    boundaries (PatchLog falls back to the clock-filtered full walk
    otherwise)."""
    from ..types import get_text_encoding, is_head, is_root

    live = doc._live_transaction()
    if live is not None and live.pending_ops():
        return None

    # 1. touched (object -> keys/elements) from the new changes' ops,
    #    using each change's stored actor translation table
    from ..types import Action

    touched_map: dict = {}  # obj_id -> set of prop names
    touched_seq: dict = {}  # obj_id -> set of element OpIds
    touched_mark_ops: set = set()  # objects with new mark/unmark ops
    for applied in new_applied:
        ch = applied.stored
        amap = applied.actor_map
        author = applied.actor_idx
        for i, cop in enumerate(ch.ops):
            obj = (
                ROOT_OBJ
                if is_root(cop.obj)
                else (cop.obj[0], amap[cop.obj[1]])
            )
            if cop.key.prop is not None:
                touched_map.setdefault(obj, set()).add(cop.key.prop)
                continue
            if cop.action == Action.MARK:
                touched_mark_ops.add(obj)
            if cop.insert:
                elem = (ch.start_op + i, author)
            else:
                e = cop.key.elem
                if is_head(e):
                    return None  # malformed: non-insert at HEAD
                elem = (e[0], amap[e[1]])
            touched_seq.setdefault(obj, set()).add(elem)

    # 2. eligibility: content patches apply to X only when every ancestor
    #    link's winner is the same make op at both clocks (the full walk's
    #    recursion condition); otherwise an ancestor patch re-renders X.
    #    A stale store rebuilds on this first read, outside any handler:
    #    a failure of the rebuild propagates and the cursor stays put.
    ops = doc.ops
    eligible: dict = {ROOT_OBJ: True}

    def obj_eligible(obj_id) -> bool:
        cached = eligible.get(obj_id)
        if cached is not None:
            return cached
        try:
            info = ops.get_obj(obj_id)
        except OpStoreError:  # an object the store does not hold
            eligible[obj_id] = False
            return False
        ok = obj_eligible(info.parent)
        if ok:
            pdata = ops.get_obj(info.parent).data
            if info.parent_key is not None:
                run = pdata.props.get(info.parent_key)
                wb = _winner(run, before) if run else None
                wa = _winner(run, after) if run else None
            elif pdata.obj_type == ObjType.TEXT:
                # the full walk never recurses into objects nested in TEXT
                # (_TextEmitter yields no winners) — mirror that, or the
                # fast path would emit patches the fallback suppresses
                wb = wa = None
            else:
                el = pdata.by_id.get(info.parent_elem)
                wb = el.winner(before) if el is not None else None
                wa = el.winner(after) if el is not None else None
            ok = wb is not None and wa is not None and wb.id == wa.id == obj_id
        eligible[obj_id] = ok
        return ok

    # 3. path + depth per eligible object (parents first in output)
    def obj_path(obj_id):
        return list(reversed(doc.parents(doc.export_id(obj_id))))

    work = []
    for obj_id in set(touched_map) | set(touched_seq):
        if not obj_eligible(obj_id):
            continue
        path = obj_path(obj_id)
        work.append((len(path), doc.export_id(obj_id), obj_id, path))
    work.sort(key=lambda w: (w[0], w[1]))

    patches: List[Patch] = []
    for _, exid, obj_id, path in work:
        info = ops.get_obj(obj_id)
        data = info.data
        if isinstance(data, MapObject):
            for key in sorted(touched_map.get(obj_id, ())):
                key_idx = doc.props.lookup(key)
                run = data.props.get(key_idx) if key_idx is not None else None
                if run is None:
                    return None  # op applied but run absent: fall back
                _diff_map_key(doc, exid, key, run, before, after, patches, path)
            continue
        is_text = data.obj_type == ObjType.TEXT
        if is_text and get_text_encoding() != "unicode":
            return None  # width units diverge from the walk's len() accounting
        # touched elements in document order: (block position, slot in block)
        elems = []
        for eid in touched_seq.get(obj_id, ()):
            el = data.by_id.get(eid)
            if el is None:
                return None
            elems.append(el)
        # per-object block position + visible-width prefix, scanning only
        # until every touched element's block has been seen — drain cost
        # is bounded by the FURTHEST touched block, not the object size
        need = {id(el.block) for el in elems}
        if None in (el.block for el in elems):
            return None
        block_pos = {}
        prefix = {}
        acc = 0
        for i, b in enumerate(data.blocks):
            bid = id(b)
            block_pos[bid] = i
            prefix[i] = acc
            acc += b.width if is_text else b.vis
            need.discard(bid)
            if not need:
                break

        def doc_order(el):
            b = el.block
            if b is None or id(b) not in block_pos:
                return None
            return (block_pos[id(b)], b.els.index(el))

        def pos_of(el):
            b = el.block
            at = prefix[block_pos[id(b)]]
            for e in b.els:
                if e is el:
                    return at
                w = e.winner()
                if w is not None:
                    at += w.text_width() if is_text else 1
            return None

        keyed = []
        for el in elems:
            k = doc_order(el)
            if k is None:
                return None
            keyed.append((k, el))
        keyed.sort(key=lambda t: t[0])
        em = (
            _TextEmitter(exid, path, before, after, patches)
            if is_text
            else _ListEmitter(doc, exid, path, before, after, patches)
        )
        min_idx = None
        for _, el in keyed:
            wb = el.winner(before)
            wa = el.winner(after)
            if wa is None and wb is None:
                continue
            idx = pos_of(el)
            if idx is None:
                return None
            if min_idx is None or idx < min_idx:
                min_idx = idx
            # NOTE: unlike the full walk, do NOT recurse into an unchanged
            # child winner — a touched child diffs via its own entry, and
            # recursing here would emit its patches twice
            em.visit(el, wb, wa, idx)
        em._flush()
        # Mark spans can only change when (a) mark/unmark ops touched the
        # object, or (b) an edit landed at or before the marked region
        # (positions shift; expand grows at boundaries). The bound — the
        # width prefix through one block past the last block holding mark
        # ops — costs O(#blocks); edits past it skip the O(object) span
        # resolution, preserving the drain's O(edit) asymptotics.
        if obj_id in touched_mark_ops:
            _diff_marks(doc, exid, data, before, after, patches, path)
        else:
            blocks = data.blocks
            last_marked = -1
            for bi, b in enumerate(blocks):
                if b.marks:
                    last_marked = bi
            if last_marked >= 0 and min_idx is not None:
                # width prefix through one block past the last marked one
                # (the slack covers expand-at-boundary growth)
                upto = min(last_marked + 1, len(blocks) - 1)
                bound = sum(
                    blocks[bi].width if is_text else blocks[bi].vis
                    for bi in range(upto + 1)
                )
                if min_idx <= bound:
                    _diff_marks(doc, exid, data, before, after, patches, path)
    return patches
