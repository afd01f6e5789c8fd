"""Transactions: local op creation, commit/rollback, autocommit.

Semantics mirror the reference's transaction layer (reference:
rust/automerge/src/transaction/inner.rs, autocommit.rs): ops apply to the op
store immediately as they are created (local reads see them), commit encodes
a columnar change chunk and updates history, rollback removes ops in reverse
and un-succs their predecessors. ``scope`` (a Clock) gives isolated
transactions at historical heads with an actor suffix to avoid opid
collisions (reference: automerge.rs isolate_actor).

The port of ``automerge_tpu/core/transaction.py``, native edit sessions
included: an ``AutoDoc`` transaction routes text splices through
``native.EditSession`` and map puts through ``native.MapSession`` (C++,
the ops exported as arrays and encoded straight into the change at
commit); any other access drains them into the op store first. Both
paths write the same change bytes. One difference, on purpose: where the
reference quietly keeps the Python path when its native library or its
fastcall extension is missing, the port raises ``NativeUnavailable``
(the port's native rule: no fallback). Eligibility (no marks, no
conflicted element or key, actor ranks below 2^20, no isolation scope)
is routing, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..storage.change import (
    ChangeOp,
    HEAD_STORED,
    LazyOps,
    ROOT_STORED,
    StoredChange,
    build_change,
    chunk_local_ops,
    encode_map_tail_cols,
    encode_ops_with_tail,
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
        # native text-edit sessions (native/session.cpp): obj_id -> session.
        # Enabled by AutoDoc; splice_text routes through C++ and ops are
        # exported in bulk at commit (or drained to the python path when a
        # non-splice access touches the document mid-transaction).
        self.enable_sessions = False
        self._sessions: Dict[OpId, object] = {}
        # native map-put sessions (native/map_session.cpp): obj_id -> session.
        # Same lifecycle as text sessions; per-op puts route through the
        # fastcall map_put entry (api.AutoDoc.put cache).
        self._msessions: Dict[OpId, object] = {}
        self._session_ops = 0
        self._had_session_ops = False
        # the text session this transaction's commit keeps for the next
        # autocommit transaction: (obj, session, drained mark) or None
        self._carry = None
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
                    for ent in self._sessions.values():
                        ent[0].close()
                    self._sessions.clear()
                    for ent in self._msessions.values():
                        ent[0].close()
                    self._msessions.clear()
                    self.doc._ops_stale = True
            except Exception:
                pass

    # -- helpers -----------------------------------------------------------

    def _next_id(self) -> OpId:
        return (
            self.start_op + len(self.operations) + self._session_ops,
            self.actor_idx,
        )

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

    # -- native edit sessions ----------------------------------------------

    from ..types import ACTOR_BITS as _ID_RANK_BITS  # ctr << bits | doc actor idx

    def _session_for(self, obj_id: OpId, info):
        """Existing or newly-eligible native session for ``obj_id``.

        Eligible: sessions enabled (AutoDoc transactions), current-state
        scope, TEXT object with no marks and no conflicted (multi-winner)
        elements, all actor indices < 2^20. A missing native library
        raises ``NativeUnavailable``."""
        ent = self._sessions.get(obj_id)
        if ent is not None:
            return ent[0]
        if not self.enable_sessions or self.scope is not None:
            return None
        from .. import native

        native.load()
        if self.actor_idx >= (1 << self._ID_RANK_BITS):
            return None
        data = info.data
        if any(b.marks for b in data.blocks):
            return None
        import numpy as np

        bits = self._ID_RANK_BITS
        lim = 1 << bits
        elem_ids: List[int] = []
        winner_ids: List[int] = []
        widths: List[int] = []
        for el in data.elements():
            vis = el.visible_ops(None)
            if not vis:
                continue
            if len(vis) > 1:
                return None  # conflicted element: python path handles preds
            w = vis[0]
            if el.op.id[1] >= lim or w.id[1] >= lim:
                return None
            elem_ids.append((el.op.id[0] << bits) | el.op.id[1])
            winner_ids.append((w.id[0] << bits) | w.id[1])
            widths.append(w.text_width())
        sess = native.EditSession(self.actor_idx)
        sess.init(
            np.asarray(elem_ids, np.int64),
            np.asarray(winner_ids, np.int64),
            np.asarray(widths, np.int32),
        )
        self._sessions[obj_id] = [sess, 0]  # [session, drained watermark]
        return sess

    def adopt_session_carry(self) -> None:
        """Take over the text session that the document's last commit
        kept (``_close_sessions``), if nothing has changed the document
        since: its history still ends at the change that commit saw last,
        and the actor and the text encoding are the same. The session's
        element state is then the document's, so the first splice needs
        neither the op store nor, after a large session commit, its
        rebuild from the whole history. Any other carry is closed."""
        carry = self.doc._session_carry
        if carry is None:
            return
        self.doc._session_carry = None
        obj_id, sess, mark, actor_idx, n_hist, head, enc = carry
        from ..types import get_text_encoding

        hist = self.doc.history
        if (
            self.enable_sessions
            and self.scope is None
            and not self.operations
            and not self._sessions
            and sess._h
            and actor_idx == self.actor_idx
            and n_hist == len(hist)
            and hist[-1].hash == head
            and enc == get_text_encoding()
        ):
            self._sessions[obj_id] = [sess, mark]
        else:
            sess.close()

    def _close_sessions(self) -> None:
        """Close every session at commit, but keep a lone text session, all
        of whose ops the change holds, in ``_carry`` for the next
        autocommit transaction (``adopt_session_carry``). Such a session
        saw no per-op mutation since it was built (those close every
        session), so its state is the document's once the change lands."""
        if len(self._sessions) == 1 and self.enable_sessions:
            ((obj_id, ent),) = self._sessions.items()
            if ent[0]._h and ent[0].op_count() == ent[1]:
                self._carry = (obj_id, ent[0], ent[1])
                self._sessions.clear()
        for ent in self._sessions.values():
            ent[0].close()
        self._sessions.clear()
        for ent in self._msessions.values():
            ent[0].close()
        self._msessions.clear()

    def fast_splice_fn(self, obj: str):
        """A minimal per-splice closure for the typing hot path, or None.

        Collapses the AutoDoc -> Transaction -> EditSession -> ctypes chain
        (4+ Python frames and a ~1us libffi call per edit) into one closure
        frame and one METH_FASTCALL C call. The closure returns False when
        it can no longer serve (session drained/closed) so the caller falls
        back to the general path and drops its cache. Raises the same typed
        error as splice_text on out-of-bounds."""
        from .. import native

        fc = native.fastcall()
        obj_id = self.doc.import_id(obj)
        ent = self._sessions.get(obj_id)
        if ent is None:
            return None
        sess = ent[0]
        if not sess._h:
            return None
        h = sess._h
        fsplice = fc.splice
        from ..types import get_text_encoding

        enc = {"unicode": 0, "utf8": 1, "utf16": 2}[get_text_encoding()]
        splice_err = native._splice_error
        start = self.start_op

        def fast(pos: int, ndel: int, text: str) -> bool:
            if sess._h is None or self._done:
                return False
            n = fsplice(
                h,
                start + len(self.operations) + self._session_ops,
                pos, ndel, text, enc,
            )
            if n < 0:
                raise splice_err(n)
            self._session_ops += n
            return True

        return fast

    def map_session_for(self, obj_id: OpId):
        """Existing or newly-eligible native map session for ``obj_id``
        (None when ineligible: non-map object, a conflicted key, wide
        actor ranks; a missing native library raises)."""
        from .. import native

        ent = self._msessions.get(obj_id)
        if ent is not None:
            return ent[0]
        native.load()
        info = self.doc.ops.get_obj(obj_id)
        if not isinstance(info.data, MapObject):
            return None
        import numpy as np

        bits = self._ID_RANK_BITS
        lim = 1 << bits
        props = self.doc.props
        keys: List[str] = []
        winners: List[int] = []
        for key_idx, run in info.data.props.items():
            vis = [o for o in run if o.visible_at(None)]
            if not vis:
                continue
            if len(vis) > 1:
                return None  # conflicted key: python path handles preds
            w = vis[0]
            if w.id[1] >= lim:
                return None
            keys.append(props.get(key_idx))
            winners.append((w.id[0] << bits) | w.id[1])
        sess = native.MapSession(self.actor_idx)
        sess.init(keys, np.asarray(winners, np.int64))
        self._msessions[obj_id] = [sess, 0]  # [session, drained watermark]
        return sess

    def fast_put_fn(self, obj: str):
        """A minimal per-put closure for the map hot path, or None.

        The map analogue of fast_splice_fn: collapses AutoDoc -> Transaction
        -> MapSession into one closure frame and one METH_FASTCALL C call
        that dispatches the value type, encodes the column payload, and
        resolves pred (the key's current winner) natively. Returns an int:
        1 = handled, 0 = session gone (caller may rebuild after the generic
        path), -1 = key/value not session-eligible (caller must stop
        rebuilding for this transaction or every ineligible value would pay
        an O(keys) session preload)."""
        from .. import native

        if not self.enable_sessions or self.scope is not None or self._done:
            return None
        if self.actor_idx >= (1 << self._ID_RANK_BITS):
            return None
        fput = native.fastcall().map_put
        obj_id = self._obj(obj)
        if obj_id not in self._msessions and (
            self.operations
            or any(
                ent[0].op_count() > ent[1]
                for ent in (*self._sessions.values(), *self._msessions.values())
            )
        ):
            # this commit already holds per-op rows or another session's
            # ops, so it would drain a new session through the per-op path
            # (_export_change): the session would only add its own cost
            return None
        sess = self.map_session_for(obj_id)
        if sess is None or not sess._h:
            return None
        h = sess._h
        start = self.start_op

        def fast(key, value) -> int:
            if sess._h is None or self._done:
                return 0
            n = fput(
                h,
                start + len(self.operations) + self._session_ops,
                key, value,
            )
            if n < 0:
                return -1
            self._session_ops += n
            return 1

        return fast

    def _drain_all(self, drop: bool = False) -> None:
        """Materialize pending (undrained) session ops through the python
        per-op path (id order), so the op store reflects them.

        With ``drop=False`` (reads) the session stays live — its element
        state and the store now agree, and the drained watermark prevents
        re-materialization; ``drop=True`` (python mutations, which could
        invalidate session state) closes sessions entirely."""
        if not self._sessions and not self._msessions:
            return
        bits = self._ID_RANK_BITS
        mask = (1 << bits) - 1
        rows = []  # (id_int, is_map, obj_id, export dict, row index)
        for obj_id, ent in list(self._sessions.items()):
            e = ent[0].export(ent[1])
            ent[1] += len(e["id"])
            if drop:
                ent[0].close()
                del self._sessions[obj_id]
            for k in range(len(e["id"])):
                rows.append((int(e["id"][k]), False, obj_id, e, k))
        for obj_id, ent in list(self._msessions.items()):
            e = ent[0].export(ent[1])
            ent[1] += len(e["id"])
            if drop:
                ent[0].close()
                del self._msessions[obj_id]
            # per-row payload offsets: prefix-sum of the vmeta byte lengths
            offs = [0]
            for vm in e["vmeta"]:
                offs.append(offs[-1] + (int(vm) >> 4))
            e["raw_off"] = offs
            for k in range(len(e["id"])):
                rows.append((int(e["id"][k]), True, obj_id, e, k))
        self._session_ops = 0
        rows.sort(key=lambda r: r[0])
        for id_int, is_map, obj_id, e, k in rows:
            opid = (id_int >> bits, id_int & mask)
            if is_map:
                key_idx = self.doc.props.cache(e["keys"][int(e["key_idx"][k])])
                vm = int(e["vmeta"][k])
                off = e["raw_off"][k]
                p = int(e["pred"][k])
                op = Op(
                    id=opid,
                    action=Action.PUT,
                    value=_scalar_from_vmeta(vm, e["raw"][off:off + (vm >> 4)]),
                    key=key_idx,
                    pred=[] if p == 0 else [(p >> bits, p & mask)],
                )
            elif e["is_del"][k]:
                ref = int(e["elem_ref"][k])
                p = int(e["pred"][k])
                op = Op(
                    id=opid,
                    action=Action.DELETE,
                    value=ScalarValue.null(),
                    elem=HEAD if ref == 0 else (ref >> bits, ref & mask),
                    pred=[(p >> bits, p & mask)],
                )
            else:
                ref = int(e["elem_ref"][k])
                op = Op(
                    id=opid,
                    action=Action.PUT,
                    value=ScalarValue("str", chr(int(e["cp"][k]))),
                    elem=HEAD if ref == 0 else (ref >> bits, ref & mask),
                    insert=True,
                )
            self.doc.ops.insert_op(obj_id, op)
            self.operations.append((obj_id, op))

    def session_length(self, obj_id: OpId) -> Optional[int]:
        """Width of a session-held object without draining (AutoDoc's
        length fast path); None when no session holds it."""
        ent = self._sessions.get(obj_id)
        return None if ent is None else ent[0].length()

    def _export_change_session(self, obj_id: OpId, ent) -> StoredChange:
        """Array-native commit: encode the session's undrained tail straight
        into change columns (storage/change.encode_ops_with_tail) without
        materializing per-op python objects. Already-drained session ops sit
        in ``operations`` (lower ids), encoded as prefix rows."""
        import numpy as np

        doc = self.doc
        author = self.actor_idx
        bits = self._ID_RANK_BITS
        mask = (1 << bits) - 1
        e = ent[0].export(ent[1])
        ent[1] += len(e["id"])
        self._close_sessions()
        self._had_session_ops = True

        refs = e["elem_ref"]
        preds = e["pred"]
        extra = set((refs[refs != 0] & mask).tolist())
        extra |= set((preds[preds != 0] & mask).tolist())
        extra.add(obj_id[1])
        rows = self._change_rows()
        ops_local, other, local = chunk_local_ops(
            rows, author, lambda g: doc.actors.get(g).bytes,
            extra_refs=sorted(extra),
        )
        lut = np.full(max(local) + 1, -1, np.int64)
        for g, l in local.items():
            lut[g] = l

        is_del = e["is_del"]
        cps = e["cp"]
        ins = ~is_del
        raw = (
            cps[ins].astype("<u4").tobytes().decode("utf-32-le").encode("utf-8")
            if ins.any()
            else b""
        )
        u8len = (
            1 + (cps > 0x7F) + (cps > 0x7FF) + (cps > 0xFFFF)
        ).astype(np.int64)
        tail = {
            "obj_ctr": obj_id[0],
            "obj_actor": local[obj_id[1]],
            "elem_ctr": (refs >> bits).astype(np.int64),
            "elem_actor": np.where(refs == 0, -1, lut[refs & mask]).astype(np.int64),
            "insert": ins.astype(np.uint8),
            "action": np.where(is_del, int(Action.DELETE), int(Action.PUT)).astype(np.int64),
            "val_meta": np.where(is_del, 0, (u8len << 4) | 6).astype(np.int64),
            "val_raw": raw,
            "pred_ctr": np.where(preds == 0, -1, preds >> bits).astype(np.int64),
            "pred_actor": np.where(preds == 0, 0, lut[preds & mask]).astype(np.int64),
        }
        cols = encode_ops_with_tail(ops_local, tail)
        n_total = len(rows) + len(cps)
        ts = self.timestamp if self.timestamp is not None else 0
        stored = StoredChange(
            dependencies=list(self.deps),
            actor=doc.actors.get(author).bytes,
            other_actors=[doc.actors.get(g).bytes for g in other],
            seq=self.seq,
            start_op=self.start_op,
            timestamp=ts,
            message=self.message,
            ops=LazyOps({}, n_total),
        )
        built = build_change(stored, cols=cols)
        built.ops = LazyOps(built.op_col_data, n_total)
        return built

    # -- map mutations -----------------------------------------------------

    def put(self, obj: str, prop, value) -> None:
        self._check_open()
        self._drain_all(drop=True)
        obj_id = self._obj(obj)
        info = self.doc.ops.get_obj(obj_id)
        sv = ScalarValue.from_py(value)
        if isinstance(info.data, MapObject):
            self._map_op(obj_id, prop, Action.PUT, sv)
        else:
            self._seq_set(obj_id, prop, Action.PUT, sv)

    def put_object(self, obj: str, prop, obj_type: ObjType) -> str:
        self._check_open()
        self._drain_all(drop=True)
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
        self._drain_all(drop=True)
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
        self._drain_all(drop=True)
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
        self._drain_all(drop=True)
        obj_id = self._obj(obj)
        self._insert_op(obj_id, index, Action.PUT, ScalarValue.from_py(value))

    def insert_object(self, obj: str, index: int, obj_type: ObjType) -> str:
        self._check_open()
        self._drain_all(drop=True)
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
        # hot path: an existing session needs no store access at all
        ent = self._sessions.get(self.doc.import_id(obj)) if self._sessions else None
        if ent is not None:
            n = ent[0].splice(
                self.start_op + len(self.operations) + self._session_ops,
                pos, delete, text,
            )
            self._session_ops += n
            return
        obj_id = self._obj(obj)
        # session creation only reads obj_id's state, which no OTHER
        # session can have touched — no drain needed yet
        info = self.doc.ops.get_obj(obj_id)
        # text splices apply only to TEXT objects (reference: InvalidOp,
        # transaction/inner.rs splice_text via automerge.rs op checks)
        if not isinstance(info.data, SeqObject) or info.data.obj_type != ObjType.TEXT:
            raise InvalidOp(msg="splice_text on a non-text object")
        sess = self._session_for(obj_id, info)
        if sess is not None:
            n = sess.splice(
                self.start_op + len(self.operations) + self._session_ops,
                pos, delete, text,
            )
            self._session_ops += n
            return
        # python fallback: other sessions' pending ops must land in
        # ``operations`` BEFORE this op so the encoded change stays in
        # implicit-id order (ids derive from row position on decode)
        self._drain_all()
        enc = self._encoding(info.data)
        values = [ScalarValue("str", ch) for ch in text]
        self._splice(obj_id, pos, delete, values, enc)

    def splice_text_many(self, obj: str, edits, clamp: bool = True) -> int:
        """Bulk text ingest: apply many (pos, delete, text) splices in one
        native call (requires session eligibility — TEXT object, no marks,
        no conflicts; falls back to per-edit splice_text otherwise).
        Returns the number of ops issued."""
        self._check_open()
        obj_id = self._obj(obj)
        info = self.doc.ops.get_obj(obj_id)
        if not isinstance(info.data, SeqObject) or info.data.obj_type != ObjType.TEXT:
            raise InvalidOp(msg="splice_text_many on a non-text object")
        sess = self._session_for(obj_id, info)
        if sess is None:
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
        n = sess.splice_batch(
            self.start_op + len(self.operations) + self._session_ops,
            edits, clamp=clamp,
        )
        self._session_ops += n
        return n

    def splice(self, obj: str, pos: int, delete: int, values) -> None:
        self._check_open()
        self._drain_all(drop=True)
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
        self._drain_all(drop=True)
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
        return len(self.operations) + self._session_ops

    # -- reads (reference: Transactable is a ReadDoc, transactable.rs) -----
    #
    # Reads resolve through the transaction's scope clock: an isolated
    # transaction sees the historical state plus its own pending ops (the
    # scope pins this transaction's actor), a plain transaction sees the
    # current state plus pending ops. Pending native-session ops drain
    # into the store first so reads observe them.

    def get(self, obj: str, prop):
        self._drain_all()
        return self.doc.get(obj, prop, clock=self.scope)

    def get_all(self, obj: str, prop):
        self._drain_all()
        return self.doc.get_all(obj, prop, clock=self.scope)

    def text(self, obj: str) -> str:
        self._drain_all()
        return self.doc.text(obj, clock=self.scope)

    def length(self, obj: str) -> int:
        n = self.session_length(self.doc.import_id(obj)) if self._sessions else None
        if n is not None:
            return n
        self._drain_all()
        return self.doc.length(obj, clock=self.scope)

    def keys(self, obj: str = ROOT):
        self._drain_all()
        return self.doc.keys(obj, clock=self.scope)

    def list_items(self, obj: str):
        self._drain_all()
        return self.doc.list_items(obj, clock=self.scope)

    def map_entries(self, obj: str = ROOT):
        self._drain_all()
        return self.doc.map_entries(obj, clock=self.scope)

    def commit(self) -> Optional[bytes]:
        """Encode the pending ops as a change and append it to history."""
        self._check_open()
        self._done = True
        self.doc.open_transactions.discard(self)
        if not self.operations and not self._session_ops and self.message is None:
            # nothing changed: an adopted session goes on to the next one
            self._close_sessions()
            self._keep_carry(self.doc.history[-1].hash if self.doc.history else None)
            return None
        from .. import obs

        if obs.enabled():
            obs.event("commit", ops=self.pending_ops(), seq=self.seq)
        change = self._export_change()
        applied = AppliedChange(
            change, self.actor_idx, self._export_actor_map(change)
        )
        self.doc._update_history(applied)
        if self._had_session_ops:
            # the op store never saw the session ops — it is now a stale
            # view of history and rebuilds on the next read
            self.doc._ops_stale = True
        self._keep_carry(change.hash)
        return change.hash

    def _keep_carry(self, head: Optional[bytes]) -> None:
        """Hand ``_carry`` to the document for the next autocommit
        transaction, keyed by the history's length and last change."""
        carry, self._carry = self._carry, None
        if carry is None:
            return
        if head is None:
            carry[1].close()
            return
        from ..types import get_text_encoding

        self.doc._session_carry = (
            *carry, self.actor_idx, len(self.doc.history), head,
            get_text_encoding(),
        )

    def rollback(self) -> int:
        self._check_open()
        self._done = True
        self.doc.open_transactions.discard(self)
        n = len(self.operations) + self._session_ops
        for ent in self._sessions.values():
            ent[0].close()
        self._sessions.clear()
        for ent in self._msessions.values():
            ent[0].close()
        self._msessions.clear()
        self._session_ops = 0
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

    # session tails at or below this drain through the per-op path at
    # commit: the store stays live (no full-history rebuild on next read),
    # which keeps the commit-per-keystroke pattern O(tail) instead of O(doc)
    SMALL_TAIL_OPS = 256

    def _export_change_map_session(self, obj_id: OpId, ent) -> StoredChange:
        """Array-native commit for a pure map-session transaction: encode
        the session's undrained puts straight into change columns
        (storage/change.encode_map_tail_cols) without materializing per-op
        python objects. Guarded by the caller: ``self.operations`` empty."""
        import numpy as np

        doc = self.doc
        author = self.actor_idx
        bits = self._ID_RANK_BITS
        mask = (1 << bits) - 1
        e = ent[0].export(ent[1])
        self._close_sessions()
        self._had_session_ops = True

        preds = e["pred"]
        extra = set((preds[preds != 0] & mask).tolist())
        if obj_id != ROOT_OBJ:
            extra.add(obj_id[1])
        _, other, local = chunk_local_ops(
            [], author, lambda g: doc.actors.get(g).bytes,
            extra_refs=sorted(extra),
        )
        lut = np.full(max(local) + 1, -1, np.int64)
        for g, l in local.items():
            lut[g] = l

        tail = {
            "obj_ctr": 0 if obj_id == ROOT_OBJ else obj_id[0],
            "obj_actor": -1 if obj_id == ROOT_OBJ else local[obj_id[1]],
            "key_idx": e["key_idx"],
            "keys": e["keys"],
            "val_meta": e["vmeta"],
            "val_raw": e["raw"],
            "pred_ctr": np.where(preds == 0, -1, preds >> bits).astype(np.int64),
            "pred_actor": np.where(preds == 0, 0, lut[preds & mask]).astype(np.int64),
        }
        cols = encode_map_tail_cols(tail)
        n_total = len(e["key_idx"])
        ts = self.timestamp if self.timestamp is not None else 0
        stored = StoredChange(
            dependencies=list(self.deps),
            actor=doc.actors.get(author).bytes,
            other_actors=[doc.actors.get(g).bytes for g in other],
            seq=self.seq,
            start_op=self.start_op,
            timestamp=ts,
            message=self.message,
            ops=LazyOps({}, n_total),
        )
        built = build_change(stored, cols=cols)
        built.ops = LazyOps(built.op_col_data, n_total)
        return built

    def _export_change(self) -> StoredChange:
        live = {
            (False, o): ent for o, ent in self._sessions.items()
            if ent[0].op_count() > ent[1]
        }
        live.update({
            (True, o): ent for o, ent in self._msessions.items()
            if ent[0].op_count() > ent[1]
        })
        undrained = sum(ent[0].op_count() - ent[1] for ent in live.values())
        if live and (
            len(live) > 1
            or (
                undrained <= self.SMALL_TAIL_OPS
                # ...but only when the tail is also a small FRACTION of the
                # document: the session-export path marks the op store stale
                # (next read rebuilds from the whole history), which beats
                # per-op drain only when the tail isn't most of the doc
                and undrained * 4 < self.doc.max_op
                # ...and the store is live: a drain into a stale store
                # would rebuild it from the whole history first
                and not self.doc._ops_stale
            )
        ):
            # multi-session commits interleave objects; small tails are
            # cheaper applied incrementally than via a stale-store rebuild.
            # A lone session stays open, drained, for _close_sessions
            self._drain_all(drop=len(live) > 1)
            live = {}
        if live:
            (((is_map, obj_id), ent),) = live.items()
            if is_map:
                if self.operations:
                    # the map tail encoder takes no prefix rows; mixed
                    # commits go through the materialized path
                    self._drain_all(drop=True)
                else:
                    return self._export_change_map_session(obj_id, ent)
            else:
                return self._export_change_session(obj_id, ent)
        self._close_sessions()
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


def _scalar_from_vmeta(vmeta: int, raw: bytes) -> ScalarValue:
    """Decode a map-session payload (value_meta code + raw bytes) back into
    a ScalarValue for the materialized drain path."""
    code = vmeta & 0xF
    if code == 0:
        return ScalarValue.null()
    if code == 1:
        return ScalarValue("bool", False)
    if code == 2:
        return ScalarValue("bool", True)
    if code == 3:
        from ..utils.leb128 import decode_uleb

        return ScalarValue("uint", decode_uleb(raw, 0)[0])
    if code in (4, 8, 9):
        from ..utils.leb128 import decode_sleb

        tag = {4: "int", 8: "counter", 9: "timestamp"}[code]
        return ScalarValue(tag, decode_sleb(raw, 0)[0])
    if code == 5:
        import struct

        return ScalarValue("f64", struct.unpack("<d", raw)[0])
    if code == 6:
        return ScalarValue("str", raw.decode("utf-8"))
    if code == 7:
        return ScalarValue("bytes", raw)
    raise AutomergeError(f"unexpected map-session value code {code}")


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
    "fast_splice_fn",
    "adopt_session_carry",
    "_drain_all",
    "session_length",
):
    setattr(Transaction, _name, _tx_width_ctx(getattr(Transaction, _name)))
del _name
