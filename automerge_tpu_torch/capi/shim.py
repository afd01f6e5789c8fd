"""Python side of the C ABI frontend (see am.h / am_embed.cpp).

The embedded interpreter calls ONE entry point, ``call(fn, *args)``, which
returns a flat list of (tag, payload) item tuples — the AMitem model of
the reference's C frontend (reference: automerge-c/src/item.rs tagged
AMitem values, result.rs AMresult item sequences). Keeping the
marshalling here means the C layer never touches framework objects, only
ints/floats/str/bytes.

Documents and sync states are held in registries keyed by int64 handles;
the C ``AMdoc``/``AMsyncState`` structs wrap those handles.

The device. ``am.h`` has no device argument, so every document this shim
makes (``create``, ``load``, ``fork``, ``fork_at``, ``clone``) lives on the
one device that ``AUTOMERGE_TPU_TORCH_DEVICE`` names, read once, at the
first document, through ``device.resolve_device``: the CUDA card when it
is unset, ``cpu`` for the plain PyTorch path. With no setting and no GPU
the call that makes a document fails with the device error (``am_create``
and ``am_load`` then return NULL); it never falls back to the CPU. Every
bulk catch-up (``load``, ``merge``, ``apply_change_bytes``, the sync calls)
and every stale read after a large session commit runs through the merge
kernels on that device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from ..api import AutoDoc
from ..device import resolve_device
from ..sync import SyncState
from ..types import ActorId, ObjType, ScalarValue

# item tags — MUST match the AMvalType enum in am.h
VOID = 0
NULL = 1
BOOL = 2
INT = 3
UINT = 4
F64 = 5
STR = 6
BYTES = 7
COUNTER = 8
TIMESTAMP = 9
OBJ_ID = 10
HANDLE = 11

_OBJTYPE = {0: ObjType.MAP, 1: ObjType.LIST, 2: ObjType.TEXT, 3: ObjType.TABLE}
_OBJTYPE_CODE = {v: k for k, v in _OBJTYPE.items()}

_docs: Dict[int, AutoDoc] = {}
_syncs: Dict[int, SyncState] = {}
_next_handle = 1
_device = None  # resolved at the first document (see the module docstring)

Item = Tuple[int, object]


def _register(table, value) -> int:
    global _next_handle
    h = _next_handle
    _next_handle += 1
    table[h] = value
    return h


def _doc_device():
    """The device of every document this shim makes."""
    global _device
    if _device is None:
        _device = resolve_device(os.environ.get("AUTOMERGE_TPU_TORCH_DEVICE") or None)
    return _device


def _doc(h: int) -> AutoDoc:
    doc = _docs.get(h)
    if doc is None:
        raise ValueError(f"invalid document handle {h}")
    return doc


def _scalar(tag: int, payload) -> object:
    if tag == NULL:
        return ScalarValue("null")
    if tag == BOOL:
        return ScalarValue("bool", bool(payload))
    if tag == INT:
        return ScalarValue("int", int(payload))
    if tag == UINT:
        return ScalarValue("uint", int(payload))
    if tag == F64:
        return ScalarValue("f64", float(payload))
    if tag == STR:
        return ScalarValue("str", payload)
    if tag == BYTES:
        return ScalarValue("bytes", payload)
    if tag == COUNTER:
        return ScalarValue("counter", int(payload))
    if tag == TIMESTAMP:
        return ScalarValue("timestamp", int(payload))
    raise ValueError(f"unsupported value tag {tag}")


def _render_item(rendered, exid) -> List[Item]:
    kind = rendered[0]
    if kind == "obj":
        return [(OBJ_ID, exid)]
    if kind == "counter":
        return [(COUNTER, int(rendered[1]))]
    sv = rendered[1]
    tag = {
        "null": NULL, "bool": BOOL, "int": INT, "uint": UINT, "f64": F64,
        "str": STR, "bytes": BYTES, "counter": COUNTER, "timestamp": TIMESTAMP,
    }.get(sv.tag)
    if tag is None:
        return [(BYTES, bytes(sv.value[1]))]  # unknown: raw payload
    if tag == BOOL:
        return [(BOOL, 1 if sv.value else 0)]
    if tag == NULL:
        return [(NULL, 0)]
    return [(tag, sv.value)]


# -- entry points (dispatched by name from C) ---------------------------------


def create(actor: bytes) -> List[Item]:
    doc = AutoDoc(actor=ActorId(actor) if actor else None, device=_doc_device())
    return [(HANDLE, _register(_docs, doc))]


def load(data: bytes) -> List[Item]:
    return [(HANDLE, _register(_docs, AutoDoc.load(data, device=_doc_device())))]


def fork(h: int, actor: bytes) -> List[Item]:
    doc = _doc(h).fork(actor=ActorId(actor) if actor else None)
    return [(HANDLE, _register(_docs, doc))]


def free(h: int) -> List[Item]:
    _docs.pop(h, None)
    return []


def save(h: int) -> List[Item]:
    return [(BYTES, _doc(h).save())]


def commit(h: int, message) -> List[Item]:
    hash_ = _doc(h).commit(message=message or None)
    return [(BYTES, hash_)] if hash_ is not None else []


def merge(h: int, other: int) -> List[Item]:
    return [(BYTES, x) for x in _doc(h).merge(_doc(other))]


def put(h: int, obj: str, key: str, tag: int, payload) -> List[Item]:
    _doc(h).put(obj, key, _scalar(tag, payload))
    return []


def put_object(h: int, obj: str, key: str, objtype: int) -> List[Item]:
    return [(OBJ_ID, _doc(h).put_object(obj, key, _OBJTYPE[objtype]))]


def insert(h: int, obj: str, index: int, tag: int, payload) -> List[Item]:
    _doc(h).insert(obj, index, _scalar(tag, payload))
    return []


def insert_object(h: int, obj: str, index: int, objtype: int) -> List[Item]:
    return [(OBJ_ID, _doc(h).insert_object(obj, index, _OBJTYPE[objtype]))]


def list_put(h: int, obj: str, index: int, tag: int, payload) -> List[Item]:
    _doc(h).put(obj, index, _scalar(tag, payload))
    return []


def delete(h: int, obj: str, key: str) -> List[Item]:
    _doc(h).delete(obj, key)
    return []


def list_delete(h: int, obj: str, index: int) -> List[Item]:
    _doc(h).delete(obj, index)
    return []


def increment(h: int, obj: str, key: str, by: int) -> List[Item]:
    _doc(h).increment(obj, key, by)
    return []


def list_increment(h: int, obj: str, index: int, by: int) -> List[Item]:
    _doc(h).increment(obj, index, by)
    return []


def splice_text(h: int, obj: str, pos: int, delete_n: int, text: str) -> List[Item]:
    _doc(h).splice_text(obj, pos, delete_n, text)
    return []


def text(h: int, obj: str) -> List[Item]:
    return [(STR, _doc(h).text(obj))]


def length(h: int, obj: str) -> List[Item]:
    return [(UINT, _doc(h).length(obj))]


def keys(h: int, obj: str) -> List[Item]:
    return [(STR, k) for k in _doc(h).keys(obj)]


def get(h: int, obj: str, key: str) -> List[Item]:
    got = _doc(h).get(obj, key)
    return _render_item(*got) if got is not None else []


def list_get(h: int, obj: str, index: int) -> List[Item]:
    got = _doc(h).get(obj, index)
    return _render_item(*got) if got is not None else []


def get_all(h: int, obj: str, key) -> List[Item]:
    out: List[Item] = []
    for rendered, exid in _doc(h).get_all(obj, key):
        out.extend(_render_item(rendered, exid))
    return out


def get_heads(h: int) -> List[Item]:
    return [(BYTES, x) for x in _doc(h).get_heads()]


def actor_id(h: int) -> List[Item]:
    return [(BYTES, _doc(h).get_actor().bytes)]


_EXPANDS = ("none", "before", "after", "both")


def _check_expand(expand: str) -> str:
    if expand not in _EXPANDS:
        raise ValueError(f"expand must be one of {_EXPANDS}, got {expand!r}")
    return expand


def mark_str(h: int, obj: str, start: int, end: int, name: str, value: str, expand: str) -> List[Item]:
    _doc(h).mark(obj, start, end, name, value, expand=_check_expand(expand))
    return []


def mark_null(h: int, obj: str, start: int, end: int, name: str, expand: str) -> List[Item]:
    # a null-valued mark clears ``name`` over the span (Peritext unmark)
    _doc(h).mark(obj, start, end, name, None, expand=_check_expand(expand))
    return []


def mark_bool(h: int, obj: str, start: int, end: int, name: str, value: int, expand: str) -> List[Item]:
    _doc(h).mark(obj, start, end, name, bool(value), expand=_check_expand(expand))
    return []


def unmark(h: int, obj: str, start: int, end: int, name: str) -> List[Item]:
    _doc(h).unmark(obj, start, end, name)
    return []


def marks(h: int, obj: str) -> List[Item]:
    return _marks_items(_doc(h).marks(obj))


def get_cursor(h: int, obj: str, pos: int) -> List[Item]:
    return [(STR, _doc(h).get_cursor(obj, pos))]


def get_cursor_position(h: int, obj: str, cursor: str) -> List[Item]:
    return [(UINT, _doc(h).get_cursor_position(obj, cursor))]


def apply_change_bytes(h: int, data: bytes) -> List[Item]:
    _doc(h).load_incremental(data, on_partial="error")
    return []


def save_incremental(h: int, heads_blob: bytes) -> List[Item]:
    return [(BYTES, _doc(h).save_incremental_after(_heads(heads_blob)))]


def sync_state_new() -> List[Item]:
    return [(HANDLE, _register(_syncs, SyncState()))]


def sync_state_free(h: int) -> List[Item]:
    _syncs.pop(h, None)
    return []


def generate_sync_message(h: int, sh: int) -> List[Item]:
    msg = _doc(h).generate_sync_message(_syncs[sh])
    return [(BYTES, msg.encode())] if msg is not None else []


def receive_sync_message(h: int, sh: int, data: bytes) -> List[Item]:
    from ..sync.protocol import Message

    _doc(h).receive_sync_message(_syncs[sh], Message.decode(data))
    return []


# -- historical reads (*_at) --------------------------------------------------
#
# Heads travel as concatenated 32-byte hashes (the am_get_heads item bytes
# back to back) — the same convention am_save_incremental established.


def _heads(blob: bytes) -> List[bytes]:
    if len(blob) % 32:
        raise ValueError("heads blob must be a multiple of 32 bytes")
    return [blob[i : i + 32] for i in range(0, len(blob), 32)]


def get_at(h: int, obj: str, key: str, heads: bytes) -> List[Item]:
    got = _doc(h).get(obj, key, heads=_heads(heads))
    return _render_item(*got) if got is not None else []


def get_all_at(h: int, obj: str, key: str, heads: bytes) -> List[Item]:
    out: List[Item] = []
    for rendered, exid in _doc(h).get_all(obj, key, heads=_heads(heads)):
        out.extend(_render_item(rendered, exid))
    return out


def list_get_at(h: int, obj: str, index: int, heads: bytes) -> List[Item]:
    got = _doc(h).get(obj, index, heads=_heads(heads))
    return _render_item(*got) if got is not None else []


def keys_at(h: int, obj: str, heads: bytes) -> List[Item]:
    return [(STR, k) for k in _doc(h).keys(obj, heads=_heads(heads))]


def length_at(h: int, obj: str, heads: bytes) -> List[Item]:
    return [(UINT, _doc(h).length(obj, heads=_heads(heads)))]


def text_at(h: int, obj: str, heads: bytes) -> List[Item]:
    return [(STR, _doc(h).text(obj, heads=_heads(heads)))]


def marks_at(h: int, obj: str, heads: bytes) -> List[Item]:
    return _marks_items(_doc(h).marks(obj, heads=_heads(heads)))


def fork_at(h: int, heads: bytes, actor: bytes) -> List[Item]:
    doc = _doc(h).fork_at(_heads(heads), actor=ActorId(actor) if actor else None)
    return [(HANDLE, _register(_docs, doc))]


# -- richer object/item surface ----------------------------------------------


def object_type(h: int, obj: str) -> List[Item]:
    return [(UINT, _OBJTYPE_CODE[_doc(h).object_type(obj)])]


def list_put_object(h: int, obj: str, index: int, objtype: int) -> List[Item]:
    return [(OBJ_ID, _doc(h).put_object(obj, index, _OBJTYPE[objtype]))]


def list_items(h: int, obj: str) -> List[Item]:
    out: List[Item] = []
    for rendered, exid in _doc(h).list_items(obj):
        out.extend(_render_item(rendered, exid))
    return out


def map_entries(h: int, obj: str) -> List[Item]:
    """Per entry: STR key then the value item (2 items per entry)."""
    out: List[Item] = []
    for key, rendered, exid in _doc(h).map_entries(obj):
        out.append((STR, key))
        out.extend(_render_item(rendered, exid))
    return out


def get_changes(h: int, heads: bytes) -> List[Item]:
    return [(BYTES, c.raw_bytes) for c in _doc(h).get_changes(_heads(heads))]


# -- patches ------------------------------------------------------------------
#
# Each patch flattens to a fixed 6-item record so C callers can walk
# results without variable framing:
#   STR obj exid | STR path ("key/3/sub") | STR kind | STR prop |
#   UINT index-or-length | value item (VOID when the kind carries none)
# Insert patches emit one record per inserted value (index ascending),
# matching the reference's per-value patch items.


def _patch_records(patches) -> List[Item]:
    out: List[Item] = []

    def rec(p, kind, prop, index, value_item):
        path = "/".join(str(k) for _, k in p.path)
        out.extend(
            [(STR, p.obj), (STR, path), (STR, kind), (STR, prop), (UINT, index)]
        )
        out.append(value_item)

    val_item = _scalar_item

    for p in patches:
        a = p.action
        k = type(a).__name__
        if k == "PutMap":
            rec(p, "put_map", a.key, 0, val_item(a.value))
        elif k == "PutSeq":
            rec(p, "put_seq", "", a.index, val_item(a.value))
        elif k == "Insert":
            for j, v in enumerate(a.values):
                rec(p, "insert", "", a.index + j, val_item(v))
        elif k == "SpliceText":
            rec(p, "splice_text", "", a.index, (STR, a.value))
        elif k == "DeleteMap":
            rec(p, "del_map", a.key, 0, (VOID, 0))
        elif k == "DeleteSeq":
            rec(p, "del_seq", "", a.index, (UINT, a.length))
        elif k == "IncrementPatch":
            prop = a.prop if isinstance(a.prop, str) else ""
            idx = a.prop if isinstance(a.prop, int) else 0
            rec(p, "increment", prop, idx, (INT, a.value))
        elif k == "FlagConflict":
            prop = a.prop if isinstance(a.prop, str) else ""
            idx = a.prop if isinstance(a.prop, int) else 0
            rec(p, "flag_conflict", prop, idx, (VOID, 0))
        elif k == "MarkPatch":
            # replace-all framing: one ("mark_clear") record, then two
            # records per span — ("mark", name, start, value) and
            # ("mark_end", name, end, VOID). The clear record makes the
            # empty set (unmark removed the last span) observable and lets
            # C consumers implement replace-all without extra state.
            rec(p, "mark_clear", "", 0, (VOID, 0))
            for m in a.marks:
                rec(p, "mark", m.name, m.start, _scalar_item(m.value))
                rec(p, "mark_end", m.name, m.end, (VOID, 0))
        else:
            rec(p, k.lower(), "", 0, (VOID, 0))
    return out


def diff(h: int, before: bytes, after: bytes) -> List[Item]:
    return _patch_records(_doc(h).diff(_heads(before), _heads(after)))


def pop_patches(h: int) -> List[Item]:
    """Drain patches since the last pop (the observer surface from C); the
    first call activates the log at the current heads."""
    doc = _doc(h)
    if not doc.patch_log.is_active():
        doc.patch_log.set_active(True)
        doc.patch_log.reset(doc.doc)
        return []
    return _patch_records(doc.make_patches())


# -- round-3 breadth: the remaining reference doc.rs surface ------------------


def clone(h: int) -> List[Item]:
    """AMclone: same history, same actor (fork mints a fresh actor)."""
    doc = _doc(h)
    cloned = doc.fork(actor=doc.get_actor())
    return [(HANDLE, _register(_docs, cloned))]


def set_actor(h: int, actor: bytes) -> List[Item]:
    _doc(h).set_actor(ActorId(actor))
    return []


def equal(h: int, other: int) -> List[Item]:
    """AMequal: get_heads() equality after autocommit (reference:
    automerge-c doc.rs:42-44 is_equal_to) — same history heads, not
    content. Two docs with identical content but different histories are
    NOT equal; see equal_content for the content semantic."""
    return [(BOOL, 1 if sorted(_doc(h).get_heads()) == sorted(_doc(other).get_heads()) else 0)]


def equal_content(h: int, other: int) -> List[Item]:
    """am_equal_content: current-state content equality (hydrated trees) —
    an extension beyond the reference's AMequal for callers that want
    value comparison across divergent histories."""
    return [(BOOL, 1 if _doc(h).hydrate() == _doc(other).hydrate() else 0)]


def get_change_by_hash(h: int, hash_: bytes) -> List[Item]:
    doc = _doc(h)
    doc.commit()  # autocommit boundary, like every history accessor
    ch = doc.doc.get_change_by_hash(hash_)
    return [(BYTES, ch.raw_bytes)] if ch is not None else []


def get_changes_added(h: int, other: int) -> List[Item]:
    doc, src = _doc(h), _doc(other)
    doc.commit()
    src.commit()  # the result must equal what am_merge would apply
    added = doc.doc.get_changes_added(src.doc)
    return [(BYTES, c.raw_bytes) for c in added]


def get_missing_deps(h: int, heads: bytes) -> List[Item]:
    doc = _doc(h)
    doc.commit()
    return [(BYTES, x) for x in doc.doc.get_missing_deps(_heads(heads))]


def get_last_local_change(h: int) -> List[Item]:
    ch = _doc(h).get_last_local_change()
    return [(BYTES, ch.raw_bytes)] if ch is not None else []


def pending_ops(h: int) -> List[Item]:
    return [(UINT, _doc(h).pending_ops())]


def rollback(h: int) -> List[Item]:
    return [(UINT, _doc(h).rollback())]


def list_range(h: int, obj: str, start: int, end: int) -> List[Item]:
    """AMlistRange: value items for visible indices in [start, end)."""
    doc = _doc(h)
    out: List[Item] = []
    for i, (rendered, exid) in enumerate(doc.list_items(obj)):
        if start <= i < end:
            out.extend(_render_item(rendered, exid))
    return out


def map_range(h: int, obj: str, begin: str, end: str) -> List[Item]:
    """AMmapRange: (STR key, value item) pairs for keys in [begin, end)
    (empty ``end`` = unbounded)."""
    doc = _doc(h)
    out: List[Item] = []
    for key, rendered, exid in doc.map_entries(obj):
        if key >= begin and (not end or key < end):
            out.append((STR, key))
            out.extend(_render_item(rendered, exid))
    return out


def list_splice(h: int, obj: str, pos: int, delete_n: int) -> List[Item]:
    """AMsplice's delete side; insertions go through the typed insert
    calls (the item-array marshalling the reference uses has no analogue
    in this frontend's scalar ABI)."""
    _doc(h).splice(obj, pos, delete_n, [])
    return []


def sync_state_shared_heads(sh: int) -> List[Item]:
    return [(BYTES, x) for x in _syncs[sh].shared_heads]


# -- sync state codecs --------------------------------------------------------


def sync_state_encode(sh: int) -> List[Item]:
    return [(BYTES, _syncs[sh].encode())]


def sync_state_decode(data: bytes) -> List[Item]:
    return [(HANDLE, _register(_syncs, SyncState.decode(data)))]


def _scalar_item(v) -> Item:
    """One raw Python value -> item (shared by marks + patch records)."""
    if isinstance(v, bool):
        return (BOOL, 1 if v else 0)
    if isinstance(v, int):
        return (INT, v)
    if isinstance(v, float):
        return (F64, v)
    if isinstance(v, (bytes, bytearray)):
        return (BYTES, bytes(v))
    if isinstance(v, str):
        return (STR, v)
    if v is None:
        return (NULL, 0)
    return (STR, str(v))  # hydrated subtree: stringified


def _marks_items(marks_list) -> List[Item]:
    out: List[Item] = []
    for m in marks_list:
        out.append((UINT, m.start))
        out.append((UINT, m.end))
        out.append((STR, m.name))
        out.append(_scalar_item(m.value))
    return out


# -- C fast path (am_embed.cpp hot-call cache) --------------------------------
#
# Per-op C callers (am_splice_text / am_map_put_*) were interpreter-bound:
# every call built a Python tuple and ran shim dispatch.
# fast_begin exposes the SAME native session the Python fast paths use
# (core/transaction.py fast_splice_fn / fast_put_fn) as raw handles, so the
# embedder drives am_edit_splice / am_map_put directly with NO Python in
# the loop. Safety contract: the C side clears its cache and dispatches
# fast_sync before ANY other shim call, so Python-side op-id accounting
# (tx._session_ops) resynchronizes before anything else can mint ids.
# An error raised here (no native library, say) is the C call's error; only
# an empty answer means "ineligible, dispatch instead".


def fast_addrs() -> List[Item]:
    """Native entry addresses for the C fast path; raises
    ``NativeUnavailable`` when the native library cannot be built."""
    import ctypes

    from .. import native

    lib = native.load()
    cast = lambda f: (UINT, ctypes.cast(f, ctypes.c_void_p).value)  # noqa: E731
    return [
        cast(lib.am_edit_splice), cast(lib.am_edit_op_count),
        cast(lib.am_map_put), cast(lib.am_map_op_count),
    ]


_ENC_CODE = {"unicode": 0, "utf8": 1, "utf16": 2}


def fast_begin(h: int, obj: str, kind: int) -> List[Item]:
    """Arm the C hot-call cache for (doc, obj): kind 0 = text splice,
    1 = map put. Returns [(HANDLE, session_addr), (INT, base_ctr),
    (INT, enc_code)] — the next op counter is base_ctr + the session's
    live op_count — or [] when the object is ineligible (the C side then
    neg-caches and keeps dispatching). A text session that the last commit
    kept and this transaction adopted (``Transaction.adopt_session_carry``)
    carries its drained mark, so ``tx._session_ops`` counts only the ops
    past it and the base stays right."""
    from ..types import get_text_encoding

    doc = _doc(h)
    tx = doc._ensure_tx()
    # a session the transaction holds (one it adopted from the last commit,
    # say) is armed without the op store, which a large session commit
    # leaves stale: reading it would rebuild it through the merge kernels
    ent = tx._sessions.get(doc.doc.import_id(obj)) if kind == 0 else None
    if ent is not None:
        sess = ent[0]
    elif kind == 0:
        obj_id = tx._obj(obj)
        info = tx.doc.ops.get_obj(obj_id)
        from ..core.op_store import SeqObject

        # TEXT only: splice_text on a LIST must keep raising through the
        # dispatch path exactly like the python frontend
        if not isinstance(info.data, SeqObject) or info.data.obj_type != ObjType.TEXT:
            return []
        sess = tx._session_for(obj_id, info)
    else:
        obj_id = tx._obj(obj)
        if not tx.enable_sessions or tx.scope is not None:
            return []
        if tx.actor_idx >= (1 << tx._ID_RANK_BITS):
            return []
        sess = tx.map_session_for(obj_id)
    if sess is None or not sess._h:
        return []
    base = tx.start_op + len(tx.operations) + tx._session_ops - sess.op_count()
    enc = _ENC_CODE[doc.doc.text_encoding or get_text_encoding()]
    return [(HANDLE, sess._h), (INT, base), (INT, enc)]


def fast_sync(h: int) -> List[Item]:
    """Re-account ops the C fast path pushed straight into native
    sessions (their op ids are consumed; tx._session_ops must agree
    before any other operation mints ids)."""
    doc = _docs.get(h)
    tx = doc._tx if doc is not None else None
    if tx is not None:
        tx._session_ops = sum(
            s[0].op_count() - s[1] for s in tx._sessions.values()
        ) + sum(
            s[0].op_count() - s[1] for s in tx._msessions.values()
        )
    return []


def call(fn: str, *args) -> List[Item]:
    """The single dispatch point the C layer uses."""
    impl = globals().get(fn)
    if impl is None or fn.startswith("_"):
        raise ValueError(f"unknown C API function {fn!r}")
    return impl(*args)
