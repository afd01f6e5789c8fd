"""Host op store: per-object op runs with RGA ordering and visibility.

This is the host-side equivalent of the reference's OpSet/OpTree
(reference: rust/automerge/src/op_set.rs, op_tree.rs) with the same
semantics — Lamport-ordered runs per key/element, succ/pred visibility
flips, RGA sibling ordering — but a different shape: sequences are a doubly
linked list of element runs with O(1) id lookup and a moving cursor for
index resolution (sequential edits cost O(jump distance), the dominant
pattern in real editing traces), and maps are per-prop sorted runs. The
device merge kernel (ops/) is the batched alternative for N-way merges;
this structure serves local edits and incremental remote applies.

Key invariants (reference: types.rs:712-744, op_tree.rs:212-239):
  - op visible iff succ empty; counter put visible iff all succ are incs;
    increment and mark ops are never visible themselves
  - ops for one key/element are in ascending Lamport order (ties broken by
    actor bytes)
  - a new insert op is placed after its reference element, skipping over
    sibling elements whose insert op has a greater Lamport id
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from ..types import Action, ObjType, OpId, ScalarValue, is_make_action, str_width

LIST_ENC = 0
TEXT_ENC = 1


from ..errors import AutomergeError


class OpStoreError(AutomergeError):
    pass


class Op:
    __slots__ = (
        "id",
        "action",
        "key",  # prop index (int) for map ops, None for seq ops
        "elem",  # reference element OpId for seq ops, None for map ops
        "insert",
        "value",
        "pred",  # List[OpId], sorted by lamport
        "succ",  # List[OpId], sorted by lamport
        "mark_name",
        "expand",
        "incs",  # List[(OpId, int)] for counter puts
    )

    def __init__(
        self,
        id: OpId,
        action: int,
        value: ScalarValue,
        key: Optional[int] = None,
        elem: Optional[OpId] = None,
        insert: bool = False,
        pred: Optional[List[OpId]] = None,
        mark_name: Optional[str] = None,
        expand: bool = False,
    ):
        self.id = id
        self.action = action
        self.key = key
        self.elem = elem
        self.insert = insert
        self.value = value
        self.pred = pred or []
        self.succ: List[OpId] = []
        self.mark_name = mark_name
        self.expand = expand
        self.incs: List[Tuple[OpId, int]] = []

    @property
    def is_counter(self) -> bool:
        return self.action == Action.PUT and self.value.tag == "counter"

    @property
    def is_inc(self) -> bool:
        return self.action == Action.INCREMENT

    @property
    def is_mark(self) -> bool:
        return self.action == Action.MARK

    @property
    def is_delete(self) -> bool:
        return self.action == Action.DELETE

    def visible(self) -> bool:
        if self.is_inc or self.is_mark:
            return False
        if self.is_counter:
            return len(self.succ) <= len(self.incs)
        return not self.succ

    def visible_at(self, clock) -> bool:
        """Historical visibility (reference: types.rs visible_at)."""
        if clock is None:
            return self.visible()
        if self.is_inc or self.is_mark:
            return False
        if not clock.covers(self.id):
            return False
        inc_ids = {i for i, _ in self.incs} if self.is_counter else ()
        return not any(clock.covers(s) for s in self.succ if s not in inc_ids)

    def counter_value_at(self, clock=None) -> int:
        base = self.value.value
        for sid, n in self.incs:
            if clock is None or clock.covers(sid):
                base += n
        return base

    def text_width(self) -> int:
        if self.value.tag == "str":
            return str_width(self.value.value)
        return 1

    def __repr__(self):
        return f"Op({self.id}, a={self.action}, v={self.value.tag})"


class Element:
    """A sequence element: its defining insert op plus overwriting ops."""

    __slots__ = ("op", "updates", "prev", "next", "block", "_wcache", "lkey")

    def __init__(self, op: Optional[Op]):
        self.op = op  # None only for the head sentinel
        self.updates: List[Op] = []
        self.prev: Optional["Element"] = None
        self.next: Optional["Element"] = None
        self.block: Optional["Block"] = None
        self.lkey = None  # cached (ctr, actor-bytes) Lamport key
        # cached current-state winner: () = dirty, (op_or_None,) = valid.
        # Walks touch every element ~hundreds of times between visibility
        # changes; recomputing visible_ops each time dominated the replay
        # profile. Mutation paths call dirty_winner().
        self._wcache = ()

    @property
    def elem_id(self) -> OpId:
        return self.op.id

    def dirty_winner(self) -> None:
        self._wcache = ()

    def run(self) -> Iterator[Op]:
        if self.op is not None:
            yield self.op
        yield from self.updates

    def visible_ops(self, clock=None) -> List[Op]:
        return [o for o in self.run() if o.visible_at(clock)]

    def winner(self, clock=None) -> Optional[Op]:
        """Last visible op in Lamport order — the current value."""
        if clock is None:
            cached = self._wcache
            if cached:
                return cached[0]
            vis = self.visible_ops(None)
            w = vis[-1] if vis else None
            self._wcache = (w,)
            return w
        vis = self.visible_ops(clock)
        return vis[-1] if vis else None


class Block:
    """A run of consecutive elements with visibility aggregates.

    The order-statistics index over the element list: blocks carry
    (visible count, visible text width) so index resolution skips whole
    blocks instead of walking elements — the role the reference's B-tree
    node ``Index`` plays (reference: op_tree/node.rs:88-144,
    query/list_state.rs:76-120), in flat-block form.
    """

    __slots__ = ("els", "vis", "width", "min_key", "marks")

    def __init__(self):
        self.els: List[Element] = []
        self.vis = 0
        self.width = 0
        # minimum (ctr, actor-bytes) insert-op key in this block: lets the
        # RGA sibling skip scan jump whole blocks whose every element has a
        # greater Lamport id (the dense-concurrency quadratic case)
        self.min_key = None
        # count of mark begin/end elements: blocks with vis == 0 and
        # marks == 0 are skippable wholesale by insert-reference scans
        self.marks = 0


# block split threshold: nth costs O(#blocks + BLOCK_MAX); with ~n/128
# blocks both terms stay small through million-element sequences
BLOCK_MAX = 256


class SeqObject:
    __slots__ = (
        "obj_type",
        "actors",  # the document's actor cache (Lamport ties use bytes)
        "head",
        "tail",
        "by_id",
        "blocks",
        "visible_len",
        "text_width",
        "_cursor",  # (Element, list_index, text_index) of a visible element
        "_text_cache",  # current-state text (TEXT objects, bulk rebuild)
    )

    def __init__(self, obj_type: ObjType, actors=None):
        self.obj_type = obj_type
        self.actors = actors
        self.head = Element(None)
        self.tail = self.head
        self.by_id: Dict[OpId, Element] = {}
        self.blocks: List[Block] = []
        self.visible_len = 0
        self.text_width = 0
        self._cursor = None
        # current-state text, filled by rebuild_blocks for TEXT objects;
        # any element mutation drops it (every seq mutation path calls
        # invalidate_cursor)
        self._text_cache: Optional[str] = None

    def invalidate_cursor(self) -> None:
        self._cursor = None
        self._text_cache = None

    # -- block index maintenance ------------------------------------------

    def _block_key(self, el: Element):
        k = el.lkey
        if k is None:
            opid = el.op.id
            k = (opid[0], self.actors.get(opid[1]).bytes)
            el.lkey = k
        return k

    def block_insert_after(self, prev: Element, el: Element) -> None:
        """Register ``el`` (just linked after ``prev``) in the block index."""
        if prev.op is None:  # head sentinel -> front of the first block
            if not self.blocks:
                self.blocks.append(Block())
            b = self.blocks[0]
            b.els.insert(0, el)
        else:
            b = prev.block
            b.els.insert(b.els.index(prev) + 1, el)
        el.block = b
        w = el.winner()
        if w is not None:
            b.vis += 1
            b.width += w.text_width()
        if el.op.is_mark:
            b.marks += 1
        key = self._block_key(el)
        if b.min_key is None or key < b.min_key:
            b.min_key = key
        if len(b.els) > BLOCK_MAX:
            self._split_block(b)

    def _split_block(self, b: Block) -> None:
        half = len(b.els) // 2
        nb = Block()
        nb.els = b.els[half:]
        b.els = b.els[:half]
        for el in nb.els:
            el.block = nb
            w = el.winner()
            if w is not None:
                nb.vis += 1
                nb.width += w.text_width()
            if el.op.is_mark:
                nb.marks += 1
        b.vis -= nb.vis
        b.width -= nb.width
        b.marks -= nb.marks
        b.min_key = min(map(self._block_key, b.els)) if b.els else None
        nb.min_key = min(map(self._block_key, nb.els)) if nb.els else None
        self.blocks.insert(self.blocks.index(b) + 1, nb)

    def block_remove(self, el: Element) -> None:
        b = el.block
        if b is None:
            return
        w = el.winner()
        if w is not None:
            b.vis -= 1
            b.width -= w.text_width()
        if el.op.is_mark:
            b.marks -= 1
        b.els.remove(el)
        el.block = None
        if not b.els:
            self.blocks.remove(b)
        elif self._block_key(el) == b.min_key:
            b.min_key = min(map(self._block_key, b.els))

    def block_vis_delta(self, el: Element, dvis: int, dwidth: int) -> None:
        b = el.block
        if b is not None and (dvis or dwidth):
            b.vis += dvis
            b.width += dwidth

    def rebuild_blocks(self) -> None:
        """Partition the element list into fresh blocks (bulk load path).

        For TEXT objects the same winner sweep also assembles the
        current-state text cache, so the first text() read after a bulk
        rebuild (the sync catch-up read pattern) is a plain string return
        instead of a second full element walk."""
        self.blocks = []
        cache_text = self.obj_type == ObjType.TEXT
        parts: List[str] = []
        b = None
        el = self.head.next
        while el is not None:
            if b is None or len(b.els) >= BLOCK_MAX:
                b = Block()
                self.blocks.append(b)
            b.els.append(el)
            el.block = b
            w = el.winner()
            if w is not None:
                b.vis += 1
                b.width += w.text_width()
                if cache_text:
                    v = w.value
                    parts.append(v.value if v.tag == "str" else "￼")
            if el.op.is_mark:
                b.marks += 1
            key = self._block_key(el)
            if b.min_key is None or key < b.min_key:
                b.min_key = key
            el = el.next
        self.visible_len = sum(x.vis for x in self.blocks)
        self.text_width = sum(x.width for x in self.blocks)
        if cache_text:
            self._text_cache = "".join(parts)

    def next_visible_from(self, el: Optional[Element]) -> Optional[Element]:
        """First CURRENT-STATE-visible element strictly after ``el``
        (None = from HEAD). Whole blocks with no visible elements are
        skipped via the index — tombstone runs cost O(#blocks crossed),
        not O(run length) (the never_seen_puts fast path's role,
        reference query/list_state.rs:73-97)."""
        cur = el.next if el is not None else self.head.next
        while cur is not None:
            b = cur.block
            if b is not None and b.vis == 0:
                cur = b.els[-1].next
                continue
            if cur.winner() is not None:
                return cur
            cur = cur.next
        return None

    def seed_cursor(self, el, at: int, encoding: int) -> None:
        """Re-seed the position cursor after local edits (the analogue of
        the reference's last_insert hint, op_tree.rs:36-45)."""
        if encoding == LIST_ENC:
            self._cursor = (el, at, 0, encoding)
        else:
            self._cursor = (el, 0, at, encoding)

    def elements(self) -> Iterator[Element]:
        e = self.head.next
        while e is not None:
            yield e
            e = e.next

    def ops_in_order(self) -> Iterator[Tuple[Element, Op]]:
        for e in self.elements():
            for op in e.run():
                yield e, op


class MapObject:
    __slots__ = ("obj_type", "props")

    def __init__(self, obj_type: ObjType = ObjType.MAP):
        self.obj_type = obj_type
        self.props: Dict[int, List[Op]] = {}


class ObjInfo:
    __slots__ = ("data", "parent", "parent_key", "parent_elem")

    def __init__(self, data, parent: Optional[OpId], parent_key, parent_elem):
        self.data = data  # MapObject | SeqObject
        self.parent = parent
        self.parent_key = parent_key  # prop index in parent map
        self.parent_elem = parent_elem  # elem id in parent seq


ROOT_OBJ: OpId = (0, 0)


class OpStore:
    """All objects of a document, keyed by object id."""

    def __init__(self, actors):
        # ``actors`` is the document's IndexedCache of ActorIds; Lamport
        # comparisons go through it because ties break on actor *bytes*.
        self.actors = actors
        self.objects: Dict[OpId, ObjInfo] = {
            ROOT_OBJ: ObjInfo(MapObject(), None, None, None)
        }

    # -- Lamport order -----------------------------------------------------

    def lamport_key(self, opid: OpId):
        return (opid[0], self.actors.get(opid[1]).bytes)

    def lamport_lt(self, a: OpId, b: OpId) -> bool:
        if a[0] != b[0]:
            return a[0] < b[0]
        return self.actors.get(a[1]).bytes < self.actors.get(b[1]).bytes

    def sort_opids(self, ids: List[OpId]) -> List[OpId]:
        return sorted(ids, key=self.lamport_key)

    # -- object management -------------------------------------------------

    def get_obj(self, obj_id: OpId) -> ObjInfo:
        info = self.objects.get(obj_id)
        if info is None:
            raise OpStoreError(f"missing object {obj_id}")
        return info

    def has_obj(self, obj_id: OpId) -> bool:
        return obj_id in self.objects

    def obj_type(self, obj_id: OpId) -> ObjType:
        return self.get_obj(obj_id).data.obj_type

    def _register_make(self, obj_id: OpId, op: Op) -> None:
        from ..types import objtype_for_action

        t = objtype_for_action(op.action)
        if t is None:
            return
        if op.id in self.objects:
            return
        data = (
            MapObject(t)
            if t in (ObjType.MAP, ObjType.TABLE)
            else SeqObject(t, self.actors)
        )
        # For insert-created objects the element id is the make op's own id
        # (op.elem is only the RGA reference element it was inserted after).
        parent_elem = op.id if op.insert else op.elem
        self.objects[op.id] = ObjInfo(data, obj_id, op.key, parent_elem)

    # -- the apply path ----------------------------------------------------

    def add_succ(self, target: Op, op: Op) -> None:
        if op.id not in target.succ:
            target.succ.append(op.id)
            target.succ.sort(key=self.lamport_key)
        if op.is_inc and target.is_counter:
            target.incs.append((op.id, op.value.value))

    def remove_succ(self, target: Op, op: Op) -> None:
        target.succ = [s for s in target.succ if s != op.id]
        if op.is_inc and target.is_counter:
            target.incs = [(i, n) for i, n in target.incs if i != op.id]

    def insert_op(self, obj_id: OpId, op: Op) -> None:
        """Apply one (already actor-translated) op to an object.

        Mirrors the reference's seek → add_succ → insert flow
        (automerge.rs:1258-1280): predecessors named by ``op.pred`` get this
        op added to their succ (flipping their visibility); the op itself is
        stored unless it is a delete.
        """
        info = self.get_obj(obj_id)
        if is_make_action(op.action):
            self._register_make(obj_id, op)
        if isinstance(info.data, MapObject):
            self._insert_map_op(info.data, op)
        else:
            self._insert_seq_op(info.data, op)

    def _insert_map_op(self, obj: MapObject, op: Op) -> None:
        if op.key is None:
            raise OpStoreError("seq-keyed op applied to map object")
        run = obj.props.setdefault(op.key, [])
        pred = set(op.pred)
        pos = 0
        for i, existing in enumerate(run):
            if existing.id in pred:
                self.add_succ(existing, op)
            if not self.lamport_lt(op.id, existing.id):
                pos = i + 1
        if not op.is_delete:
            run.insert(pos, op)

    def _insert_seq_op(self, obj: SeqObject, op: Op) -> None:
        obj.invalidate_cursor()
        if op.insert:
            self._insert_seq_insert(obj, op)
        else:
            self._insert_seq_update(obj, op)

    def _insert_seq_insert(self, obj: SeqObject, op: Op) -> None:
        if op.elem is None:
            raise OpStoreError("insert op without reference element")
        if op.elem[0] == 0:  # HEAD
            ref = obj.head
        else:
            ref = obj.by_id.get(op.elem)
            if ref is None:
                raise OpStoreError(f"insert references missing element {op.elem}")
        # RGA: skip sibling elements with greater insert-op id
        # (reference: query/opid.rs SimpleOpIdSearch). Whole blocks whose
        # minimum id exceeds ours are skipped in O(1) via the index —
        # without this, dense concurrency (many replicas inserting at the
        # same anchors) makes the element-wise scan quadratic.
        after = self._rga_skip(obj, ref.next, op.id)
        el = Element(op)
        prev = after.prev if after is not None else obj.tail
        el.prev = prev
        el.next = after
        prev.next = el
        if after is not None:
            after.prev = el
        else:
            obj.tail = el
        obj.by_id[op.id] = el
        obj.block_insert_after(prev, el)
        if op.visible():
            obj.visible_len += 1
            obj.text_width += op.text_width()

    def _rga_skip(self, obj: SeqObject, after, op_id: OpId):
        """First element at/after ``after`` whose insert-op id is less than
        ``op_id`` (Lamport); None past the end."""
        key = self.lamport_key(op_id)
        while after is not None:
            b = after.block
            if b is None:  # not indexed (shouldn't happen); element-wise
                if not self.lamport_lt(op_id, after.op.id):
                    return after
                after = after.next
                continue
            i = b.els.index(after)
            if i == 0 and b.min_key is not None and key < b.min_key:
                after = b.els[-1].next  # every id in the block is greater
                continue
            n = len(b.els)
            while i < n:
                el2 = b.els[i]
                if not self.lamport_lt(op_id, el2.op.id):
                    return el2
                i += 1
            after = b.els[n - 1].next

    def _insert_seq_update(self, obj: SeqObject, op: Op) -> None:
        if op.elem is None:
            raise OpStoreError("seq update without element id")
        el = obj.by_id.get(op.elem)
        if el is None:
            raise OpStoreError(f"op targets missing element {op.elem}")
        before_vis, before_w = self._elem_visibility(el)
        el.dirty_winner()
        pred = set(op.pred)
        for existing in el.run():
            if existing.id in pred:
                self.add_succ(existing, op)
        if not op.is_delete:
            pos = 0
            for i, existing in enumerate(el.updates):
                if self.lamport_lt(op.id, existing.id):
                    break
                pos = i + 1
            el.updates.insert(pos, op)
        after_vis, after_w = self._elem_visibility(el)
        obj.visible_len += after_vis - before_vis
        obj.text_width += after_w - before_w
        obj.block_vis_delta(el, after_vis - before_vis, after_w - before_w)

    @staticmethod
    def _elem_visibility(el: Element) -> Tuple[int, int]:
        w = el.winner()
        if w is None:
            return 0, 0
        return 1, w.text_width()

    def remove_op(self, obj_id: OpId, op: Op) -> None:
        """Rollback support: remove the most recently applied op.

        Mirrors reference rollback (transaction/inner.rs:158-184): un-succ
        the op's predecessors and delete the op itself from the store.
        """
        info = self.get_obj(obj_id)
        if is_make_action(op.action) and op.id in self.objects:
            del self.objects[op.id]
        if isinstance(info.data, MapObject):
            run = info.data.props.get(op.key, [])
            for existing in run:
                if existing.id in op.pred:
                    self.remove_succ(existing, op)
            info.data.props[op.key] = [o for o in run if o.id != op.id]
        else:
            obj = info.data
            obj.invalidate_cursor()
            if op.insert:
                el = obj.by_id.pop(op.id, None)
                if el is not None:
                    obj.block_remove(el)
                    if el.op.visible():
                        obj.visible_len -= 1
                        obj.text_width -= el.op.text_width()
                    el.prev.next = el.next
                    if el.next is not None:
                        el.next.prev = el.prev
                    else:
                        obj.tail = el.prev
            else:
                el = obj.by_id.get(op.elem)
                if el is not None:
                    before_vis, before_w = self._elem_visibility(el)
                    el.dirty_winner()
                    for existing in el.run():
                        if existing.id in op.pred:
                            self.remove_succ(existing, op)
                    el.updates = [o for o in el.updates if o.id != op.id]
                    after_vis, after_w = self._elem_visibility(el)
                    obj.visible_len += after_vis - before_vis
                    obj.text_width += after_w - before_w
                    obj.block_vis_delta(el, after_vis - before_vis, after_w - before_w)

    # -- reads -------------------------------------------------------------

    def map_ops(self, obj_id: OpId, key: int) -> List[Op]:
        info = self.get_obj(obj_id)
        if not isinstance(info.data, MapObject):
            raise OpStoreError("map read on sequence object")
        return info.data.props.get(key, [])

    def visible_map_ops(self, obj_id: OpId, key: int, clock=None) -> List[Op]:
        return [o for o in self.map_ops(obj_id, key) if o.visible_at(clock)]

    def seq_length(self, obj_id: OpId, encoding: int = LIST_ENC, clock=None) -> int:
        info = self.get_obj(obj_id)
        obj = info.data
        if not isinstance(obj, SeqObject):
            raise OpStoreError("seq read on map object")
        if clock is None:
            return obj.visible_len if encoding == LIST_ENC else obj.text_width
        total = 0
        for el in obj.elements():
            w = el.winner(clock)
            if w is not None:
                total += 1 if encoding == LIST_ENC else w.text_width()
        return total

    def nth(
        self, obj_id: OpId, index: int, encoding: int = LIST_ENC, clock=None
    ) -> Optional[Element]:
        """The visible element at ``index`` (width-aware for text)."""
        obj = self.get_obj(obj_id).data
        if not isinstance(obj, SeqObject):
            raise OpStoreError("nth on map object")
        if clock is not None:
            return self._nth_scan(obj, index, encoding, clock)[0]
        cur = obj._cursor
        if cur is not None and encoding == cur[3]:
            el, li, ti = cur[0], cur[1], cur[2]
            at = li if encoding == LIST_ENC else ti
            # local walks beat the block scan only for short jumps (the
            # sequential-editing pattern); long jumps go through the index
            if abs(index - at) <= BLOCK_MAX and el.winner() is not None:
                if at <= index:
                    found = self._walk_forward(obj, el, at, index, encoding)
                else:
                    found = self._walk_backward(obj, el, at, index, encoding)
                if found is not None:
                    return found
        return self._nth_scan(obj, index, encoding, None)[0]

    def _walk_forward(self, obj, el, at, index, encoding):
        while el is not None:
            w = el.winner()
            if w is not None:
                width = 1 if encoding == LIST_ENC else w.text_width()
                if at <= index < at + width:
                    self._set_cursor(obj, el, at, encoding)
                    return el
                at += width
            el = el.next
        return None

    def _walk_backward(self, obj, el, at, index, encoding):
        """Walk toward the front from a visible element starting at ``at``."""
        while True:
            p = el.prev
            while p is not None and p.op is not None and p.winner() is None:
                p = p.prev
            if p is None or p.op is None:
                return None  # reached HEAD without covering index
            w = p.winner()
            width = 1 if encoding == LIST_ENC else w.text_width()
            at -= width
            el = p
            if at <= index:
                if index < at + width:
                    self._set_cursor(obj, el, at, encoding)
                    return el
                return None

    def _nth_scan(self, obj, index, encoding, clock):
        """(element, span start) of the visible element covering ``index``."""
        if clock is None:
            return self._nth_blocks(obj, index, encoding)
        at = 0
        for el in obj.elements():
            w = el.winner(clock)
            if w is None:
                continue
            width = 1 if encoding == LIST_ENC else w.text_width()
            if at <= index < at + width:
                return el, at
            at += width
        return None, -1

    def _nth_blocks(self, obj, index, encoding):
        """Current-state nth via the block index: skip whole blocks by
        their visibility aggregates, walk only the target block
        (vectorized Nth/ListState node skipping, query/list_state.rs)."""
        if index < 0:
            return None, -1
        at = 0
        for b in obj.blocks:
            span = b.vis if encoding == LIST_ENC else b.width
            if index < at + span:
                for el in b.els:
                    w = el.winner()
                    if w is None:
                        continue
                    width = 1 if encoding == LIST_ENC else w.text_width()
                    if at <= index < at + width:
                        self._set_cursor(obj, el, at, encoding)
                        return el, at
                    at += width
                return None, -1  # unreachable if aggregates are consistent
            at += span
        return None, -1

    def position_of(self, obj_id: OpId, el: Element, encoding: int = LIST_ENC) -> int:
        """Span-start position of ``el`` in current state: the sum of
        visible widths before it — O(#blocks + block size) via the index
        (reference: seek_opid / SeekOpId resolving a cursor to an index,
        automerge.rs:1484-1518)."""
        obj = self.get_obj(obj_id).data
        if not isinstance(obj, SeqObject):
            raise OpStoreError("position_of on map object")
        b = el.block
        if b is None:
            raise OpStoreError("element not indexed")
        at = 0
        for blk in obj.blocks:
            if blk is b:
                break
            at += blk.vis if encoding == LIST_ENC else blk.width
        for e in b.els:
            if e is el:
                return at
            w = e.winner()
            if w is not None:
                at += 1 if encoding == LIST_ENC else w.text_width()
        raise OpStoreError("element missing from its block")

    def _set_cursor(self, obj, el, at, encoding):
        if encoding == LIST_ENC:
            obj._cursor = (el, at, 0, encoding)
        else:
            obj._cursor = (el, 0, at, encoding)

    def seed_cursor(self, obj, el, at: int, encoding: int) -> None:
        obj.seed_cursor(el, at, encoding)

    def nth_with_pos(
        self, obj_id: OpId, index: int, encoding: int = LIST_ENC, clock=None
    ):
        """(element, start position) of the visible element covering ``index``.

        The start position is where the element's span begins — strictly less
        than ``index`` when a multi-width text element crosses it (the
        reference's Nth query reports this as ``query.index()``,
        transaction/inner.rs:631-637).
        """
        obj = self.get_obj(obj_id).data
        if clock is not None:
            return self._nth_scan(obj, index, encoding, clock)
        el = self.nth(obj_id, index, encoding, None)
        if el is None:
            return None, -1
        cur = obj._cursor
        if cur is not None and cur[0] is el:
            return el, cur[1] if encoding == LIST_ENC else cur[2]
        return self._nth_scan(obj, index, encoding, None)

    def visible_elements(self, obj_id: OpId, clock=None) -> Iterator[Tuple[Element, Op]]:
        obj = self.get_obj(obj_id).data
        if not isinstance(obj, SeqObject):
            raise OpStoreError("sequence read on map object")
        for el in obj.elements():
            w = el.winner(clock)
            if w is not None:
                yield el, w

    def visible_elements_range(
        self, obj_id: OpId, start: int, end: Optional[int] = None, clock=None
    ) -> Iterator[Tuple[Element, Op]]:
        """Visible (element, winner) pairs for list indices in [start, end).

        Current-state reads resolve ``start`` through the block index and
        walk only the requested span instead of rendering the whole list
        (reference: read.rs list_range's bounded ListRange iterator)."""
        start = max(start, 0)
        if end is not None and end <= start:
            return
        if clock is not None:
            idx = 0
            for el, w in self.visible_elements(obj_id, clock):
                if end is not None and idx >= end:
                    return
                if idx >= start:
                    yield el, w
                idx += 1
            return
        el = self.nth(obj_id, start, LIST_ENC, None)
        idx = start
        while el is not None:
            if el.op is not None:
                w = el.winner()
                if w is not None:
                    if end is not None and idx >= end:
                        return
                    yield el, w
                    idx += 1
            el = el.next

    def text(self, obj_id: OpId, clock=None) -> str:
        if clock is None:
            cached = getattr(self.get_obj(obj_id).data, "_text_cache", None)
            if cached is not None:
                return cached
        parts = []
        for _, w in self.visible_elements(obj_id, clock):
            if w.value.tag == "str":
                parts.append(w.value.value)
            else:
                parts.append("￼")  # object replacement char, like the reference
        return "".join(parts)

    def map_keys(self, obj_id: OpId, clock=None) -> List[int]:
        info = self.get_obj(obj_id)
        if not isinstance(info.data, MapObject):
            raise OpStoreError("keys read on sequence object")
        out = []
        for key, run in info.data.props.items():
            if any(o.visible_at(clock) for o in run):
                out.append(key)
        return out
