"""Transactions: local op creation, commit/rollback, autocommit.

Semantics mirror the reference's transaction layer (reference:
rust/automerge/src/transaction/inner.rs, autocommit.rs): ops apply to the op
store immediately as they are created (local reads see them), commit encodes
a columnar change chunk and updates history, rollback removes ops in reverse
and un-succs their predecessors. ``scope`` (a Clock) gives isolated
transactions at historical heads with an actor suffix to avoid opid
collisions (reference: automerge.rs isolate_actor).

This is the Python path of ``automerge_tpu/core/transaction.py``: every op
goes through the op store as it is made, and commit encodes the change
from them. The reference's native edit sessions (text splices and map puts
in C++, exported in bulk at commit) write the same change bytes and are
not part of this module.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..storage.change import (
    ChangeOp,
    ROOT_STORED,
    StoredChange,
    build_change,
    chunk_local_ops,
)
from ..types import (
    Action,
    ActorId,
    HEAD,
    Key,
    ObjType,
    OpId,
    ScalarValue,
    action_for_objtype,
)
from .clock import Clock
from .document import AppliedChange, AutomergeError, Document, ROOT
from .. import obs
from ..errors import InvalidOp, MissingCounter
from .op_store import LIST_ENC, TEXT_ENC, MapObject, Op, ROOT_OBJ, SeqObject


class Transaction:
    """A manual transaction over a Document."""

    def __init__(
        self,
        doc: Document,
        message: Optional[str] = None,
        timestamp: Optional[int] = None,
        scope: Optional[Clock] = None,
        actor: Optional[ActorId] = None,
    ):
        # the reference prevents two live transactions statically via the
        # &mut borrow on Automerge (manual_transaction.rs); here the check
        # is dynamic: a second concurrent transaction would mint colliding
        # op ids from the same doc.max_op and produce a document that
        # fails to reload ("incorrect max_op in document change").
        if doc._live_transaction() is not None:
            raise AutomergeError(
                "a transaction is already open on this document; "
                "commit or roll it back first"
            )
        self.doc = doc
        self.message = message
        self.timestamp = timestamp
        actor = actor or doc.actor
        self.actor_idx = doc.actors.cache(actor)
        self.seq = len(doc.states.get(self.actor_idx, ())) + 1
        self.start_op = doc.max_op + 1
        self.deps = doc.get_heads()
        self.scope = scope
        if scope is not None:
            scope.isolate(self.actor_idx)
        self.operations: List[Tuple[OpId, Op]] = []
        self._done = False
        doc.open_transactions.add(self)

    def __del__(self):
        # an abandoned transaction rolls back, like the reference's
        # `impl Drop for Transaction` (manual_transaction.rs): its ops were
        # applied to the op store eagerly and must not outlive it.
        # ONLY when nothing was committed since this transaction opened —
        # rolling back underneath later commits (which Rust's &mut borrow
        # rules out statically) would tear out ops they built on.
        if not getattr(self, "_done", True):
            try:
                if self.doc.max_op == self.start_op - 1:
                    self.rollback()
                else:
                    # can't surgically remove our ops from under later
                    # commits — mark the materialized view stale instead so
                    # the next read rebuilds the store from history, which
                    # erases the uncommitted ops (history is the source of
                    # truth; see Document._materialize_ops).
                    self._done = True
                    self.doc.open_transactions.discard(self)
                    self.doc._ops_stale = True
            except Exception:
                pass

    # -- helpers -----------------------------------------------------------

    def _next_id(self) -> OpId:
        return (self.start_op + len(self.operations), self.actor_idx)

    def _check_open(self) -> None:
        if self._done:
            raise AutomergeError("transaction already committed or rolled back")

    def _apply(self, obj_id: OpId, op: Op) -> None:
        self.doc.ops.insert_op(obj_id, op)
        self.operations.append((obj_id, op))

    def _obj(self, obj: str) -> OpId:
        return self.doc.import_obj(obj)

    def _pred_for_map(self, obj_id: OpId, key_idx: int) -> List[OpId]:
        ops = self.doc.ops.visible_map_ops(obj_id, key_idx, self.scope)
        return self.doc.ops.sort_opids([o.id for o in ops])

    def _pred_for_elem(self, el) -> List[OpId]:
        return self.doc.ops.sort_opids(
            [o.id for o in el.visible_ops(self.scope)]
        )

    # -- map mutations -----------------------------------------------------

    def put(self, obj: str, prop, value) -> None:
        self._check_open()
        obj_id = self._obj(obj)
        info = self.doc.ops.get_obj(obj_id)
        sv = ScalarValue.from_py(value)
        if isinstance(info.data, MapObject):
            self._map_op(obj_id, prop, Action.PUT, sv)
        else:
            self._seq_set(obj_id, prop, Action.PUT, sv)

    def put_object(self, obj: str, prop, obj_type: ObjType) -> str:
        self._check_open()
        obj_id = self._obj(obj)
        info = self.doc.ops.get_obj(obj_id)
        action = action_for_objtype(obj_type)
        if isinstance(info.data, MapObject):
            op = self._map_op(obj_id, prop, action, ScalarValue.null())
        else:
            op = self._seq_set(obj_id, prop, action, ScalarValue.null())
        return self.doc.export_id(op.id)

    def _map_op(self, obj_id: OpId, prop: str, action: int, value: ScalarValue) -> Op:
        if not isinstance(prop, str):
            raise AutomergeError("map keys must be strings")
        if prop == "":
            raise AutomergeError("map keys may not be empty")
        key_idx = self.doc.props.cache(prop)
        pred = self._pred_for_map(obj_id, key_idx)
        op = Op(
            id=self._next_id(),
            action=action,
            value=value,
            key=key_idx,
            pred=pred,
        )
        self._apply(obj_id, op)
        return op

    def delete(self, obj: str, prop) -> None:
        self._check_open()
        obj_id = self._obj(obj)
        info = self.doc.ops.get_obj(obj_id)
        if isinstance(info.data, MapObject):
            if not isinstance(prop, str):
                raise AutomergeError(
                    f"map delete requires a string key, got {prop!r}"
                )
            key_idx = self.doc.props.lookup(prop)
            # deleting a missing key is a silent no-op (reference:
            # transaction/inner.rs:422-423 — empty ops + Delete -> Ok(None))
            if key_idx is None:
                return
            pred = self._pred_for_map(obj_id, key_idx)
            if not pred:
                return
            op = Op(
                id=self._next_id(),
                action=Action.DELETE,
                value=ScalarValue.null(),
                key=key_idx,
                pred=pred,
            )
            self._apply(obj_id, op)
        else:
            enc = self._encoding(info.data)
            el = self.doc.ops.nth(obj_id, prop, enc, self.scope)
            if el is None:
                raise AutomergeError(f"index {prop} out of bounds")
            op = Op(
                id=self._next_id(),
                action=Action.DELETE,
                value=ScalarValue.null(),
                elem=el.elem_id,
                pred=self._pred_for_elem(el),
            )
            self._apply(obj_id, op)

    def increment(self, obj: str, prop, by: int) -> None:
        self._check_open()
        obj_id = self._obj(obj)
        info = self.doc.ops.get_obj(obj_id)
        if isinstance(info.data, MapObject):
            key_idx = self.doc.props.lookup(prop) if isinstance(prop, str) else None
            pred_ops = (
                self.doc.ops.visible_map_ops(obj_id, key_idx, self.scope)
                if key_idx is not None
                else []
            )
            if not any(o.is_counter for o in pred_ops):
                raise MissingCounter(f"no counter at {prop!r} to increment")
            # pred covers EVERY visible op at the slot: a conflicting
            # non-counter value gains a (non-increment-surviving) successor
            # and disappears (reference: inner.rs local_map_op + the
            # visibility rule types.rs:712-744)
            op = Op(
                id=self._next_id(),
                action=Action.INCREMENT,
                value=ScalarValue("int", by),
                key=key_idx,
                pred=self.doc.ops.sort_opids([o.id for o in pred_ops]),
            )
            self._apply(obj_id, op)
        else:
            enc = self._encoding(info.data)
            el = self.doc.ops.nth(obj_id, prop, enc, self.scope)
            if el is None:
                raise AutomergeError(f"index {prop} out of bounds")
            visible = el.visible_ops(self.scope)
            if not any(o.is_counter for o in visible):
                raise MissingCounter(f"no counter at index {prop} to increment")
            # pred covers every visible op at the element (see the map
            # branch above for why)
            op = Op(
                id=self._next_id(),
                action=Action.INCREMENT,
                value=ScalarValue("int", by),
                elem=el.elem_id,
                pred=self.doc.ops.sort_opids([o.id for o in visible]),
            )
            self._apply(obj_id, op)

    # -- sequence mutations ------------------------------------------------

    @staticmethod
    def _encoding(data: SeqObject) -> int:
        return TEXT_ENC if data.obj_type == ObjType.TEXT else LIST_ENC

    def _seq_set(self, obj_id: OpId, index, action: int, value: ScalarValue) -> Op:
        """Overwrite the element at ``index`` (width-aware for text)."""
        if not isinstance(index, int):
            raise InvalidOp(msg="sequence positions must be integers")
        info = self.doc.ops.get_obj(obj_id)
        enc = self._encoding(info.data)
        el = self.doc.ops.nth(obj_id, index, enc, self.scope)
        if el is None:
            raise AutomergeError(f"index {index} out of bounds")
        op = Op(
            id=self._next_id(),
            action=action,
            value=value,
            elem=el.elem_id,
            pred=self._pred_for_elem(el),
        )
        self._apply(obj_id, op)
        return op

    def insert(self, obj: str, index: int, value) -> None:
        self._check_open()
        obj_id = self._obj(obj)
        self._insert_op(obj_id, index, Action.PUT, ScalarValue.from_py(value))

    def insert_object(self, obj: str, index: int, obj_type: ObjType) -> str:
        self._check_open()
        obj_id = self._obj(obj)
        op = self._insert_op(
            obj_id, index, action_for_objtype(obj_type), ScalarValue.null()
        )
        return self.doc.export_id(op.id)

    def _insert_ref(self, obj_id: OpId, index: int, enc: int) -> OpId:
        """Reference element for an insert at ``index``.

        Scans forward over invisible elements applying Peritext "sticky"
        mark boundaries (reference: query/insert.rs
        identify_valid_insertion_spot): insertion moves past an expanding
        MarkBegin (new text joins the span) and past a non-expanding
        MarkEnd (new text stays outside the span); a whole begin/end pair
        encountered in between is ignored.
        """
        obj = self.doc.ops.get_obj(obj_id).data
        if index == 0:
            anchor = None
        else:
            anchor = self.doc.ops.nth(obj_id, index - 1, enc, self.scope)
            if anchor is None:
                raise AutomergeError(f"index {index} out of bounds")
        return self._insert_ref_from(obj, anchor)

    def _insert_ref_from(self, obj, anchor) -> OpId:
        """Sticky-boundary scan starting after ``anchor`` (None = HEAD)."""
        from .marks import is_mark_begin, is_mark_end

        if anchor is None:
            floor = HEAD
            cur = obj.head.next
        else:
            floor = anchor.elem_id
            cur = anchor.next
        candidates = []  # mark elements pushing the insertion point right
        current = self.scope is None
        while cur is not None:
            # tombstone runs: jump whole blocks with no visible and no mark
            # elements (only valid against current state, not an isolation
            # clock — a scoped read may see through current tombstones)
            if current:
                b = cur.block
                if b is not None and b.vis == 0 and b.marks == 0:
                    cur = b.els[-1].next
                    continue
            if cur.winner(self.scope) is not None:
                break  # next visible element: insert lands before it
            op = cur.op
            if op.is_mark:
                if is_mark_end(op):
                    begin_id = (op.id[0] - 1, op.id[1])
                    hit = next(
                        (
                            i
                            for i, c in enumerate(candidates)
                            if c.op.id == begin_id
                        ),
                        None,
                    )
                    if hit is not None:
                        # a whole begin/end pair: points inside are invalid
                        del candidates[hit:]
                        cur = cur.next
                        continue
                    if not op.expand:
                        candidates.append(cur)
                elif is_mark_begin(op) and op.expand:
                    candidates.append(cur)
            cur = cur.next
        if candidates:
            return candidates[-1].elem_id
        return floor

    def _insert_op(self, obj_id: OpId, index: int, action: int, value: ScalarValue) -> Op:
        info = self.doc.ops.get_obj(obj_id)
        if not isinstance(info.data, SeqObject):
            raise InvalidOp(msg="insert on a non-sequence object")
        enc = self._encoding(info.data)
        elem = self._insert_ref(obj_id, index, enc)
        op = Op(
            id=self._next_id(),
            action=action,
            value=value,
            elem=elem,
            insert=True,
        )
        self._apply(obj_id, op)
        return op

    def splice_text(self, obj: str, pos: int, delete: int, text: str) -> None:
        self._check_open()
        obj_id = self._obj(obj)
        info = self.doc.ops.get_obj(obj_id)
        # text splices apply only to TEXT objects (reference: InvalidOp,
        # transaction/inner.rs splice_text via automerge.rs op checks)
        if not isinstance(info.data, SeqObject) or info.data.obj_type != ObjType.TEXT:
            raise InvalidOp(msg="splice_text on a non-text object")
        enc = self._encoding(info.data)
        values = [ScalarValue("str", ch) for ch in text]
        self._splice(obj_id, pos, delete, values, enc)

    def splice_text_many(self, obj: str, edits, clamp: bool = True) -> int:
        """Bulk text ingest: apply many (pos, delete, text) splices, each
        clamped to the text's bounds when ``clamp``. Returns the number of
        ops issued."""
        self._check_open()
        obj_id = self._obj(obj)
        info = self.doc.ops.get_obj(obj_id)
        if not isinstance(info.data, SeqObject) or info.data.obj_type != ObjType.TEXT:
            raise InvalidOp(msg="splice_text_many on a non-text object")
        from ..types import str_width

        n0 = self.pending_ops()
        ln = self.length(obj)  # width units, like pos/ndel
        for e in edits:
            pos, ndel = e[0], e[1]
            text = "".join(e[2:]) if len(e) > 2 else ""
            if clamp:
                pos = min(pos, ln)
                ndel = min(ndel, ln - pos)
            self.splice_text(obj, pos, ndel, text)
            ln += str_width(text) - ndel
        return self.pending_ops() - n0

    def splice(self, obj: str, pos: int, delete: int, values) -> None:
        self._check_open()
        obj_id = self._obj(obj)
        info = self.doc.ops.get_obj(obj_id)
        if not isinstance(info.data, SeqObject):
            raise InvalidOp(msg="splice on a non-sequence object")
        svals = [ScalarValue.from_py(v) for v in values]
        self._splice(obj_id, pos, delete, svals, self._encoding(info.data))

    def _splice(self, obj_id, pos, delete, values, enc) -> None:
        """Delete then insert at ``pos`` (reference: inner.rs inner_splice).

        Anchors once at ``pos - 1`` and walks elements directly instead of
        re-seeking per op; the position cursor is re-seeded afterwards so a
        run of sequential splices costs O(1) seek each — the analogue of the
        reference's ``last_insert`` hint (op_tree.rs:36-45).
        """
        ops = self.doc.ops
        obj = ops.get_obj(obj_id).data
        if delete > 0 and enc == TEXT_ENC:
            target, t_start = ops.nth_with_pos(obj_id, pos, enc, self.scope)
            if target is not None and t_start < pos:
                # deletion begins mid-way through a multi-width element:
                # rewind to the element start and expand the deleted span
                # (reference inner_splice's adjusted_index, inner.rs:631-637)
                delete += pos - t_start
                pos = t_start
        # anchor: the visible element just before pos (None at HEAD)
        if pos == 0:
            anchor = None
            anchor_at = None
        else:
            anchor = ops.nth(obj_id, pos - 1, enc, self.scope)
            if anchor is None:
                raise AutomergeError(f"splice: index {pos} out of bounds")
            anchor_at = obj._cursor[1 if enc == LIST_ENC else 2] if obj._cursor else None

        def next_visible(el):
            if self.scope is None:
                return obj.next_visible_from(el)
            el = el.next if el is not None else obj.head.next
            while el is not None and el.winner(self.scope) is None:
                el = el.next
            return el

        # -- deletes: walk forward from the anchor -------------------------
        remaining = delete
        cur = next_visible(anchor)
        while remaining > 0:
            if cur is None:
                raise AutomergeError(f"splice: delete past end of sequence")
            w = cur.winner(self.scope)
            width = w.text_width() if enc == TEXT_ENC else 1
            op = Op(
                id=self._next_id(),
                action=Action.DELETE,
                value=ScalarValue.null(),
                elem=cur.elem_id,
                pred=self._pred_for_elem(cur),
            )
            self._apply(obj_id, op)
            remaining -= width
            cur = next_visible(cur)

        # -- inserts: chain off one another (reference inner.rs:672-683) ---
        last_el = None
        insert_at = pos
        if values:
            elem = self._insert_ref_from(obj, anchor)
            for v in values:
                op = Op(
                    id=self._next_id(),
                    action=Action.PUT,
                    value=v,
                    elem=elem,
                    insert=True,
                )
                self._apply(obj_id, op)
                elem = op.id
            last_el = obj.by_id[elem]
            insert_at = pos + sum(_sv_width(v, enc) for v in values[:-1])

        # -- re-seed the cursor so the next sequential splice is O(1) ------
        if self.scope is None:
            if last_el is not None:
                ops.seed_cursor(obj, last_el, insert_at, enc)
            elif anchor is not None and anchor_at is not None:
                ops.seed_cursor(obj, anchor, anchor_at, enc)

    # -- marks -------------------------------------------------------------

    def mark(self, obj: str, start: int, end: int, name: str, value, expand="after") -> None:
        """Mark a span [start, end) of a sequence (Peritext-style rich text).

        Begin/end are inserted as zero-width invisible elements so that
        concurrent edits at the boundaries resolve by the expand policy
        (reference: inner.rs mark inserts MarkBegin/MarkEnd via do_insert).
        The end op id is always begin id + 1 — the pairing key.
        """
        self._check_open()
        obj_id = self._obj(obj)
        info = self.doc.ops.get_obj(obj_id)
        if not isinstance(info.data, SeqObject):
            raise InvalidOp(msg="mark on a non-sequence object")
        if end <= start:
            raise AutomergeError("mark span must be non-empty")
        enc = self._encoding(info.data)
        # validate both anchors before creating any op: a failed end lookup
        # must not leave a dangling unpaired MarkBegin behind
        if self.doc.ops.nth(obj_id, start, enc, self.scope) is None and start != 0:
            raise AutomergeError(f"mark start {start} out of bounds")
        if self.doc.ops.nth(obj_id, end - 1, enc, self.scope) is None:
            raise AutomergeError(f"mark end {end} out of bounds")
        expand_start = expand in ("before", "both")
        expand_end = expand in ("after", "both")
        begin = Op(
            id=self._next_id(),
            action=Action.MARK,
            value=ScalarValue.from_py(value),
            elem=self._insert_ref(obj_id, start, enc),
            insert=True,
            mark_name=name,
            expand=expand_start,
        )
        self._apply(obj_id, begin)
        end_op = Op(
            id=self._next_id(),
            action=Action.MARK,
            value=ScalarValue.null(),
            elem=self._insert_ref(obj_id, end, enc),
            insert=True,
            mark_name=None,
            expand=expand_end,
        )
        self._apply(obj_id, end_op)

    def unmark(self, obj: str, start: int, end: int, name: str, expand="none") -> None:
        """A null-valued mark span: clears ``name`` over [start, end).
        ``expand`` governs whether edits at the boundaries fall inside the
        cleared span (reference: transaction/inner.rs unmark)."""
        self.mark(obj, start, end, name, None, expand=expand)

    # -- commit / rollback -------------------------------------------------

    def pending_ops(self) -> int:
        return len(self.operations)

    # -- reads (reference: Transactable is a ReadDoc, transactable.rs) -----
    #
    # Reads resolve through the transaction's scope clock: an isolated
    # transaction sees the historical state plus its own pending ops (the
    # scope pins this transaction's actor), a plain transaction sees the
    # current state plus pending ops.

    def get(self, obj: str, prop):
        return self.doc.get(obj, prop, clock=self.scope)

    def get_all(self, obj: str, prop):
        return self.doc.get_all(obj, prop, clock=self.scope)

    def text(self, obj: str) -> str:
        return self.doc.text(obj, clock=self.scope)

    def length(self, obj: str) -> int:
        return self.doc.length(obj, clock=self.scope)

    def keys(self, obj: str = ROOT):
        return self.doc.keys(obj, clock=self.scope)

    def list_items(self, obj: str):
        return self.doc.list_items(obj, clock=self.scope)

    def map_entries(self, obj: str = ROOT):
        return self.doc.map_entries(obj, clock=self.scope)

    def commit(self) -> Optional[bytes]:
        """Encode the pending ops as a change and append it to history."""
        self._check_open()
        self._done = True
        self.doc.open_transactions.discard(self)
        if not self.operations and self.message is None:
            return None
        if obs.enabled():
            obs.event("commit", ops=self.pending_ops(), seq=self.seq)
        change = self._export_change()
        applied = AppliedChange(
            change, self.actor_idx, self._export_actor_map(change)
        )
        self.doc._update_history(applied)
        return change.hash

    def rollback(self) -> int:
        self._check_open()
        self._done = True
        self.doc.open_transactions.discard(self)
        n = len(self.operations)
        for obj_id, op in reversed(self.operations):
            self.doc.ops.remove_op(obj_id, op)
        self.operations = []
        return n

    def _change_rows(self) -> List[ChangeOp]:
        doc = self.doc
        return [
            ChangeOp(
                obj=ROOT_STORED if obj_id == ROOT_OBJ else obj_id,
                key=(
                    Key.map(doc.props.get(op.key))
                    if op.key is not None
                    else Key.seq(op.elem)
                ),
                insert=op.insert,
                action=op.action,
                value=op.value,
                pred=list(op.pred),
                expand=op.expand,
                mark_name=op.mark_name,
            )
            for obj_id, op in self.operations
        ]

    def _export_change(self) -> StoredChange:
        doc = self.doc
        author = self.actor_idx
        rows = self._change_rows()
        ops, other, _ = chunk_local_ops(
            rows, author, lambda g: doc.actors.get(g).bytes
        )
        ts = self.timestamp if self.timestamp is not None else 0
        return build_change(
            StoredChange(
                dependencies=list(self.deps),
                actor=doc.actors.get(author).bytes,
                other_actors=[doc.actors.get(g).bytes for g in other],
                seq=self.seq,
                start_op=self.start_op,
                timestamp=ts,
                message=self.message,
                ops=ops,
            )
        )

    def _export_actor_map(self, change: StoredChange) -> List[int]:
        return [
            self.doc.actors.cache(ActorId(a)) for a in change.actors
        ]


def _sv_width(v: ScalarValue, enc: int) -> int:
    if enc == TEXT_ENC and v.tag == "str":
        from ..types import str_width

        return str_width(v.value)
    return 1


# -- per-document text-encoding activation (see core/document.py) -------------


def _tx_width_ctx(fn):
    import functools

    from ..types import using_text_encoding

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        enc = self.doc.text_encoding
        if enc is None:
            return fn(self, *args, **kwargs)
        with using_text_encoding(enc):
            return fn(self, *args, **kwargs)

    return wrapped


for _name in (
    "put",
    "put_object",
    "delete",
    "increment",
    "insert",
    "insert_object",
    "splice_text",
    "splice_text_many",
    "splice",
    "mark",
    "unmark",
    "commit",
    "rollback",
    "get",
    "get_all",
    "text",
    "length",
    "keys",
    "list_items",
    "map_entries",
):
    setattr(Transaction, _name, _tx_width_ctx(getattr(Transaction, _name)))
del _name
