"""The idiomatic functional API: immutable document values + proxy trees.

The analogue of the reference's JS wrapper (reference:
javascript/src/stable.ts:194-1183 init/change/merge/..., proxies.ts:506-567
mapProxy/listProxy/textProxy): documents are treated as immutable values —
``change(doc, fn)`` hands ``fn`` a mutable proxy of the root and returns a
NEW document value; the input is untouched. Under the hood each value
wraps an AutoDoc; "immutability" is by-construction (operations fork
before mutating), not by copying state.

    import automerge_tpu_torch.functional as am

    d1 = am.init(device="cpu")
    d2 = am.change(d1, lambda d: d.update({"title": "hello"}))
    d3 = am.change(d2, lambda d: d["items"].append("first"))
    d4 = am.merge(d3, other)
    data = am.save(d4)

A document value's batched work (the bulk rebuild after a large apply,
the stale reads before it, the save's document order) runs through the
merge kernels on its device: the card unless ``init``, ``from_dict`` or
``load`` are given ``device`` (``"cpu"``: the kernels' plain PyTorch
versions). Every value derived from a document (``change``, ``merge``,
``clone``, ``view``, the snapshots of ``get_history``) lives on the
document's device.
"""

from __future__ import annotations

import copy as _copy
from typing import Callable, List, Optional

from .api import AutoDoc
from .types import ActorId, ObjType, ScalarValue

__all__ = [
    "Counter",
    "Doc",
    "Text",
    "apply_changes",
    "change",
    "change_at",
    "clone",
    "decode_change",
    "decode_sync_message",
    "decode_sync_state",
    "delete_at",
    "diff",
    "dump",
    "empty_change",
    "encode_change",
    "encode_sync_message",
    "encode_sync_state",
    "equals",
    "free",
    "generate_sync_message",
    "get_all_changes",
    "get_changes",
    "get_conflicts",
    "get_cursor",
    "get_cursor_position",
    "get_history",
    "get_last_local_change",
    "get_missing_deps",
    "get_object_id",
    "init_sync_state",
    "insert_at",
    "is_automerge",
    "load_incremental",
    "mark",
    "marks",
    "fork",
    "from_dict",
    "get_actor",
    "get_heads",
    "init",
    "load",
    "merge",
    "receive_sync_message",
    "save",
    "save_incremental",
    "save_since",
    "splice",
    "to_dict",
    "unmark",
    "view",
]


class Doc:
    """An immutable document value. Read like a dict; mutate via change()."""

    __slots__ = ("_auto", "_superseded", "_saved_heads")

    def __init__(self, auto: AutoDoc):
        object.__setattr__(self, "_auto", auto)
        object.__setattr__(self, "_superseded", False)
        # save_incremental() bookkeeping: heads as of the last save()/
        # save_incremental() on this value line (stable.ts saveIncremental
        # keeps the same cursor inside the wasm handle).
        object.__setattr__(self, "_saved_heads", [])

    # reads (delegate to a read-only proxy of the root)
    def __getitem__(self, key):
        return _read_value(self._auto, "_root", key)

    def __contains__(self, key) -> bool:
        return key in self._auto.keys("_root")

    def __iter__(self):
        return iter(self._auto.keys("_root"))

    def __len__(self) -> int:
        return len(self._auto.keys("_root"))

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        return self._auto.keys("_root")

    def to_py(self):
        return self._auto.hydrate()

    def __eq__(self, other):
        if isinstance(other, Doc):
            return self._auto.hydrate() == other._auto.hydrate()
        return self._auto.hydrate() == other

    # content equality without content hashing: unhashable, loudly
    __hash__ = None

    def __repr__(self):
        return f"Doc({self._auto.hydrate()!r})"

    def __setattr__(self, *_):
        raise TypeError("documents are immutable; use change(doc, fn)")


class Counter:
    """Wraps an int so change() writes a CRDT counter, not a plain int."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = value


class Text:
    """Wraps a string so change() creates a TEXT object (char-wise CRDT)."""

    __slots__ = ("value",)

    def __init__(self, value: str = ""):
        self.value = value


# -- construction / lifecycle -------------------------------------------------


def init(actor: Optional[bytes] = None, device=None) -> Doc:
    """An empty document on ``device`` (None: the card, raising without
    one)."""
    return Doc(AutoDoc(actor=ActorId(actor) if actor else None, device=device))


def from_dict(contents: dict, actor: Optional[bytes] = None, device=None) -> Doc:
    """init + one change installing ``contents`` (reference: stable.ts from())."""
    return change(init(actor, device=device), lambda d: d.update(contents))


def load(data: bytes, actor: Optional[bytes] = None, device=None) -> Doc:
    doc = Doc(AutoDoc.load(data, actor=ActorId(actor) if actor else None,
                           device=device))
    # loaded history counts as saved: save_incremental() right after load()
    # returns nothing, like the wasm handle (stable.ts load + saveIncremental)
    object.__setattr__(doc, "_saved_heads", doc._auto.get_heads())
    return doc


def save(doc: Doc) -> bytes:
    data = doc._auto.save()
    # save() resets the incremental cursor, like the wasm handle
    # (stable.ts saveIncremental returns nothing new after a save()).
    object.__setattr__(doc, "_saved_heads", doc._auto.get_heads())
    return data


def clone(doc: Doc, actor: Optional[bytes] = None) -> Doc:
    """A writable copy under a new actor, on ``doc``'s device."""
    return Doc(doc._auto.fork(actor=ActorId(actor) if actor else None))


fork = clone


def get_heads(doc: Doc) -> List[bytes]:
    return doc._auto.get_heads()


def get_actor(doc: Doc) -> bytes:
    return doc._auto.get_actor().bytes


def merge(doc: Doc, other: Doc) -> Doc:
    """A new value containing both histories; the local input is consumed
    (reference: stable.ts:750-763 progressDocument). Merge itself creates
    no changes, but the new value continues the same actor/seq line — a
    later change() on both the pre- and post-merge values would mint two
    different changes with one (actor, seq), splitting the history."""
    merged = _take(doc)
    try:
        merged.merge(other._auto)
    except BaseException:
        _untake(doc)
        raise
    return _progress(doc, merged)


def get_changes(doc: Doc, have_deps: List[bytes] = ()) -> List[bytes]:
    """Raw change chunks not covered by ``have_deps`` (the JS wrapper's
    getChanges, stable.ts getChanges)."""
    return [c.raw_bytes for c in doc._auto.get_changes(list(have_deps))]


def get_last_local_change(doc: Doc) -> Optional[bytes]:
    c = doc._auto.get_last_local_change()
    return c.raw_bytes if c is not None else None


def apply_changes(doc: Doc, changes) -> Doc:
    """A new value with the raw change chunks applied; the input is
    consumed like merge() (stable.ts applyChanges via progressDocument)."""
    out = _take(doc)
    try:
        out.load_incremental(b"".join(changes), on_partial="error")
    except BaseException:
        _untake(doc)
        raise
    return _progress(doc, out)


def diff(doc: Doc, before: List[bytes], after: List[bytes]):
    """Patches transforming the view at ``before`` into the view at
    ``after`` (stable.ts diff)."""
    return doc._auto.diff(list(before), list(after))


def get_conflicts(doc, prop):
    """Conflicting values at ``prop`` as {opid-exid: value}, or None when
    at most one writer is visible (reference: stable.ts:829 getConflicts
    via conflicts.ts conflictAt — the keys are the writers' op ids, the
    values every concurrent candidate including the winner).

    ``doc`` is a Doc (root) or a nested Map/List proxy obtained through
    subscripting, matching the JS idiom ``getConflicts(doc.pets[0],
    "name")``."""
    if isinstance(doc, Doc):
        auto, obj = doc._auto, "_root"
    elif isinstance(doc, (MapProxy, ListProxy, TextProxy)):
        auto, obj = doc._auto, doc._obj
    else:
        raise TypeError("get_conflicts needs a Doc or an object proxy")
    all_vals = auto.get_all(obj, prop)
    if len(all_vals) <= 1:
        return None
    return {exid: _render(auto, rendered) for rendered, exid in all_vals}


def marks(doc: Doc, key: str):
    """Mark spans of a text field: ``doc[key].marks()`` (next.ts marks).
    Nested texts are reached through the proxies: ``doc["a"]["b"].marks()``."""
    v = doc[key]
    if not isinstance(v, TextProxy):
        raise ValueError(f"{key!r} is not a text field")
    return v.marks()


def _take(doc: Doc) -> AutoDoc:
    """Consume ``doc`` for a mutating operation: the new value keeps the
    SAME actor (seq continues), so the old value may no longer author
    changes — using it again raises, exactly like the JS wrapper's
    "attempting to change an outdated document" (stable.ts _change)."""
    if doc._superseded:
        raise RuntimeError(
            "attempting to change an outdated document; clone() it first"
        )
    # mark consumed BEFORE the operation runs so a reentrant take (e.g. a
    # change() callback calling change() on the same value, or a concurrent
    # thread) can't mint two changes with one (actor, seq); _untake() rolls
    # the flag back if the operation fails — the fork never touches
    # doc._auto, so no (actor, seq) was consumed and the value stays usable.
    object.__setattr__(doc, "_superseded", True)
    return doc._auto.fork(actor=doc._auto.get_actor())


def _untake(doc: Doc) -> None:
    object.__setattr__(doc, "_superseded", False)


def _progress(doc: Doc, auto: AutoDoc) -> Doc:
    """Wrap ``auto`` as the successor value of ``doc``, carrying the
    incremental-save cursor forward (stable.ts progressDocument)."""
    out = Doc(auto)
    object.__setattr__(out, "_saved_heads", list(doc._saved_heads))
    return out


def change(doc: Doc, fn_or_message, fn: Callable = None) -> Doc:
    """Apply ``fn(root_proxy)`` as one transaction on a NEW document value
    (reference: stable.ts:355 change())."""
    if fn is None:
        message, fn = None, fn_or_message
    else:
        message = fn_or_message
    auto = _take(doc)
    try:
        fn(MapProxy(auto, "_root"))
        auto.commit(message=message)
    except BaseException:
        _untake(doc)
        raise
    return _progress(doc, auto)


def change_at(doc: Doc, heads: List[bytes], fn: Callable) -> Doc:
    """Change the document as of ``heads`` — the edit lands concurrent with
    everything since (reference: stable.ts changeAt / isolation)."""
    auto = _take(doc)
    try:
        auto.isolate(list(heads))
        fn(MapProxy(auto, "_root"))
        auto.integrate()
        auto.commit()
    except BaseException:
        _untake(doc)
        raise
    return _progress(doc, auto)


# -- proxies ------------------------------------------------------------------


def _render(auto: AutoDoc, rendered):
    """One rendered (kind, payload) from get/get_all -> proxy or value."""
    if rendered[0] == "obj":
        t, exid = rendered[1], rendered[2]
        if t in (ObjType.MAP, ObjType.TABLE):
            return MapProxy(auto, exid)
        if t == ObjType.TEXT:
            return TextProxy(auto, exid)
        return ListProxy(auto, exid)
    if rendered[0] == "counter":
        return rendered[1]
    return rendered[1].to_py()


def _read_value(auto: AutoDoc, obj: str, key):
    got = auto.get(obj, key)
    if got is None:
        raise KeyError(key) if isinstance(key, str) else IndexError(key)
    return _render(auto, got[0])


def write_value(
    auto,
    obj: str,
    key,
    value,
    insert: bool = False,
    str_as_text: bool = False,
    sort_keys: bool = False,
):
    """Recursively assign a plain Python value at key/index, creating CRDT
    objects for containers. The one tree writer shared by the functional
    proxies (strings as scalars, like the reference's next API) and the
    CLI JSON importer (strings as TEXT objects, like the reference CLI —
    pass ``str_as_text=True, sort_keys=True``)."""

    def put_or_insert(v):
        if insert:
            auto.insert(obj, key, v)
        else:
            auto.put(obj, key, v)

    def make(obj_type):
        if insert:
            return auto.insert_object(obj, key, obj_type)
        return auto.put_object(obj, key, obj_type)

    if isinstance(value, Counter):
        put_or_insert(ScalarValue("counter", value.value))
    elif isinstance(value, Text) or (str_as_text and isinstance(value, str)):
        text = value.value if isinstance(value, Text) else value
        t = make(ObjType.TEXT)
        if text:
            auto.splice_text(t, 0, 0, text)
    elif isinstance(value, dict):
        m = make(ObjType.MAP)
        for k in sorted(value) if sort_keys else value:
            write_value(auto, m, k, value[k], str_as_text=str_as_text, sort_keys=sort_keys)
    elif isinstance(value, (list, tuple)):
        lst = make(ObjType.LIST)
        for i, v in enumerate(value):
            write_value(
                auto, lst, i, v,
                insert=True, str_as_text=str_as_text, sort_keys=sort_keys,
            )
    elif isinstance(value, (MapProxy, ListProxy, TextProxy)):
        raise TypeError("cannot re-assign a live proxy; build plain values")
    else:
        put_or_insert(value)


_write_value = write_value


class MapProxy:
    """dict-like view over a map object inside an open change()."""

    __slots__ = ("_auto", "_obj")

    def __init__(self, auto: AutoDoc, obj: str):
        self._auto = auto
        self._obj = obj

    def __getitem__(self, key: str):
        return _read_value(self._auto, self._obj, key)

    def __setitem__(self, key: str, value):
        _write_value(self._auto, self._obj, key, value)

    def __delitem__(self, key: str):
        self._auto.delete(self._obj, key)

    def __contains__(self, key: str) -> bool:
        return key in self._auto.keys(self._obj)

    def __iter__(self):
        return iter(self._auto.keys(self._obj))

    def __len__(self) -> int:
        return len(self._auto.keys(self._obj))

    def keys(self):
        return self._auto.keys(self._obj)

    def get(self, key, default=None):
        if key in self:
            return _read_value(self._auto, self._obj, key)
        return default

    def update(self, entries: dict):
        for k, v in entries.items():
            self[k] = v

    def increment(self, key: str, by: int = 1):
        self._auto.increment(self._obj, key, by)

    def to_py(self):
        return self._auto.hydrate(self._obj)

    def __repr__(self):
        return f"MapProxy({self.to_py()!r})"


class ListProxy:
    """list-like view over a list object inside an open change()."""

    __slots__ = ("_auto", "_obj")

    def __init__(self, auto: AutoDoc, obj: str):
        self._auto = auto
        self._obj = obj

    def _norm(self, i: int) -> int:
        n = len(self)
        if i < 0:
            i += n
        return i

    def __getitem__(self, i: int):
        return _read_value(self._auto, self._obj, self._norm(i))

    def __setitem__(self, i: int, value):
        _write_value(self._auto, self._obj, self._norm(i), value)

    def __delitem__(self, i: int):
        self._auto.delete(self._obj, self._norm(i))

    def __len__(self) -> int:
        return self._auto.length(self._obj)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def append(self, value):
        _write_value(self._auto, self._obj, len(self), value, insert=True)

    def insert(self, i: int, value):
        _write_value(self._auto, self._obj, self._norm(i), value, insert=True)

    def extend(self, values):
        for v in values:
            self.append(v)

    def pop(self, i: int = -1):
        i = self._norm(i)
        v = self[i]
        del self[i]
        return v

    def entries(self):
        """(index, value) pairs, like the JS list proxy's entries()
        (reference: proxies.ts listMethods entries)."""
        return enumerate(self)

    def values(self):
        return iter(self)

    def keys(self):
        return iter(range(len(self)))

    def splice(self, start: int, delete_count: int = None, *items):
        """JS Array.splice semantics (reference: proxies.ts list splice
        tests): remove ``delete_count`` entries at ``start`` (to the end
        when omitted), insert ``items`` there, return the removed values
        as plain python values."""
        n = len(self)
        start = max(0, min(start + n if start < 0 else start, n))
        if delete_count is None:
            delete_count = n - start
        delete_count = max(0, min(delete_count, n - start))
        removed = [
            v.to_py() if hasattr(v, "to_py") else v
            for v in (self[start + k] for k in range(delete_count))
        ]
        # one ranged primitive for the deletions (api.AutoDoc.splice),
        # then the shared tree writer per inserted item so containers
        # still become CRDT objects
        if delete_count:
            self._auto.splice(self._obj, start, delete_count, [])
        for off, v in enumerate(items):
            self.insert(start + off, v)
        return removed

    def increment(self, i: int, by: int = 1):
        self._auto.increment(self._obj, self._norm(i), by)

    def to_py(self):
        return self._auto.hydrate(self._obj)

    def __repr__(self):
        return f"ListProxy({self.to_py()!r})"


class TextProxy:
    """str-like view over a text object inside an open change()."""

    __slots__ = ("_auto", "_obj")

    def __init__(self, auto: AutoDoc, obj: str):
        self._auto = auto
        self._obj = obj

    def __str__(self) -> str:
        return self._auto.text(self._obj)

    def __len__(self) -> int:
        return self._auto.length(self._obj)

    def splice(self, pos: int, delete: int, text: str = ""):
        self._auto.splice_text(self._obj, pos, delete, text)

    def insert(self, pos: int, text: str):
        self.splice(pos, 0, text)

    def delete(self, pos: int, length: int = 1):
        self.splice(pos, length, "")

    def append(self, text: str):
        self.splice(len(self), 0, text)

    def mark(self, start: int, end: int, name: str, value, expand="after"):
        self._auto.mark(self._obj, start, end, name, value, expand)

    def unmark(self, start: int, end: int, name: str, expand="none"):
        self._auto.unmark(self._obj, start, end, name, expand)

    def marks(self):
        return self._auto.marks(self._obj)

    def to_py(self) -> str:
        return str(self)

    def __repr__(self):
        return f"TextProxy({str(self)!r})"


def to_dict(doc: Doc):
    return doc._auto.hydrate()


# -- lifecycle extras (stable.ts parity) --------------------------------------


def free(doc: Doc) -> None:
    """No-op: memory is GC-managed here (stable.ts:281 free() exists only
    for the wasm heap)."""


def is_automerge(value) -> bool:
    """True when ``value`` is a functional document value (stable.ts:1171)."""
    return isinstance(value, Doc)


def view(doc: Doc, heads: List[bytes]) -> Doc:
    """A read-only value of the document as of ``heads`` (stable.ts:235).
    change() on a view raises, exactly like the reference; clone() it to
    get a writable copy at those heads."""
    v = Doc(doc._auto.fork_at(list(heads)))
    object.__setattr__(v, "_superseded", True)  # writes must go via clone()
    return v


def empty_change(doc: Doc, message: Optional[str] = None,
                 timestamp: Optional[int] = None) -> Doc:
    """A new value with one change containing no ops — useful to ACK merged
    history (stable.ts:579 emptyChange)."""
    auto = _take(doc)
    try:
        # "" and absent encode identically in the chunk; a non-None message
        # is what arms the empty-commit path.
        auto.transaction(message=message or "", timestamp=timestamp).commit()
    except BaseException:
        _untake(doc)
        raise
    return _progress(doc, auto)


def equals(a, b) -> bool:
    """Deep value equality over documents and plain values (stable.ts:999) —
    history and actor ids are NOT compared, only contents. Doc.__eq__
    already hydrates both sides for every Doc/plain combination."""
    return a == b


def get_object_id(value) -> Optional[str]:
    """The exid of an object value, '_root' for a Doc, None for scalars
    (stable.ts:864 getObjectId)."""
    if isinstance(value, Doc):
        return "_root"
    if isinstance(value, (MapProxy, ListProxy, TextProxy)):
        return value._obj
    return None


def dump(doc: Doc, file=None) -> None:
    """Debug-print the op store (stable.ts:1157 dump)."""
    doc._auto.doc.dump(file)


# -- incremental save / load --------------------------------------------------


def save_incremental(doc: Doc) -> bytes:
    """The changes made since the last save()/save_incremental() on this
    value line, as raw chunk bytes (stable.ts:711 saveIncremental). The
    cursor travels with the value through change()/merge()."""
    data = doc._auto.save_incremental_after(list(doc._saved_heads))
    object.__setattr__(doc, "_saved_heads", doc._auto.get_heads())
    return data


def load_incremental(doc: Doc, data: bytes) -> Doc:
    """A new value with the raw chunk bytes applied; the input is consumed
    like merge() (stable.ts:673 loadIncremental)."""
    out = _take(doc)
    try:
        out.load_incremental(data, on_partial="error")
    except BaseException:
        _untake(doc)
        raise
    return _progress(doc, out)


def save_since(doc: Doc, heads: List[bytes]) -> bytes:
    """Changes not covered by ``heads`` as raw chunk bytes
    (stable.ts:1183 saveSince)."""
    return doc._auto.save_incremental_after(list(heads))


def get_all_changes(doc: Doc) -> List[bytes]:
    """Every change in the document's history (stable.ts:895)."""
    return get_changes(doc, [])


def get_missing_deps(doc: Doc, heads: List[bytes] = ()) -> List[bytes]:
    """Dependency hashes referenced but not present (stable.ts:1143)."""
    return doc._auto.get_missing_deps(list(heads))


# -- history ------------------------------------------------------------------


class HistoryState:
    """One entry of get_history(): a lazily-decoded change plus the lazily-
    materialised document snapshot after it (stable.ts:942 State<T>)."""

    __slots__ = ("_raw", "_index", "_device")

    def __init__(self, raw: List[bytes], index: int, device=None):
        self._raw = raw
        self._index = index
        self._device = device

    @property
    def change(self) -> dict:
        return decode_change(self._raw[self._index])

    @property
    def snapshot(self) -> Doc:
        return apply_changes(init(device=self._device),
                             self._raw[: self._index + 1])

    def __repr__(self):
        return f"HistoryState(#{self._index}: {self.change['hash']})"


def get_history(doc: Doc) -> List[HistoryState]:
    """The document's change history in causal order, with lazy snapshots
    (stable.ts:942 getHistory — snapshot i applies changes 0..i to an
    empty doc, exactly like the reference)."""
    raw = get_all_changes(doc)
    device = doc._auto.doc.device
    return [HistoryState(raw, i, device) for i in range(len(raw))]


# -- change codec -------------------------------------------------------------


def decode_change(data: bytes) -> dict:
    """Parse one raw change chunk into its JSON form (stable.ts:1126
    decodeChange): actor/seq/startOp/time/message/deps/hash/ops."""
    from .expanded import expand_change
    from .storage.change import parse_change

    change_, _ = parse_change(bytes(data))
    return expand_change(change_)


def encode_change(expanded: dict) -> bytes:
    """Build the raw chunk bytes for a JSON-form change (stable.ts:1121
    encodeChange); decode_change(encode_change(x)) preserves the hash."""
    from .expanded import collapse_change

    return collapse_change(expanded).raw_bytes


# -- sync ---------------------------------------------------------------------


def init_sync_state():
    """Fresh per-peer sync state (stable.ts:1116 initSyncState)."""
    from .sync.protocol import SyncState

    return SyncState()


def encode_sync_state(state) -> bytes:
    """Persistable form of a sync state — only the durable part
    (shared heads) survives, like the reference (stable.ts:1016)."""
    return state.encode()


def decode_sync_state(data: bytes):
    """Inverse of encode_sync_state (stable.ts:1028)."""
    from .sync.protocol import SyncState

    return SyncState.decode(data)


def generate_sync_message(doc: Doc, state):
    """(new_state, message_bytes | None): the next message for the peer
    tracked by ``state`` (stable.ts:1046 — returns a fresh state instead
    of mutating the argument, matching the functional idiom)."""
    new_state = _copy.deepcopy(state)
    msg = doc._auto.generate_sync_message(new_state)
    return new_state, (msg.encode() if msg is not None else None)


def receive_sync_message(doc: Doc, state, message):
    """(new_doc, new_state) after applying a peer's sync message; the doc
    input is consumed like merge() (stable.ts:1074)."""
    from .sync.protocol import Message

    out = _take(doc)
    new_state = _copy.deepcopy(state)
    try:
        msg = Message.decode(message) if isinstance(message, (bytes, bytearray)) else message
        out.receive_sync_message(new_state, msg)
    except BaseException:
        _untake(doc)
        raise
    return _progress(doc, out), new_state


def encode_sync_message(message) -> bytes:
    """Message object -> wire bytes (stable.ts:1131)."""
    return message.encode()


def decode_sync_message(data: bytes):
    """Wire bytes -> Message object for inspection (stable.ts:1136)."""
    from .sync.protocol import Message

    return Message.decode(data)


# -- path-addressed edits & cursors (next.ts parity) --------------------------


def _resolve_path(root, path):
    cur = root
    for p in path:
        cur = cur[p]
    return cur


def insert_at(list_proxy, index: int, *values):
    """Insert values into a list or text draft inside change()
    (stable.ts:108 insertAt — splice semantics, so a negative index is
    normalised ONCE against the pre-insert length)."""
    if isinstance(list_proxy, TextProxy):
        list_proxy.insert(index if index >= 0 else len(list_proxy) + index,
                          "".join(values))
        return
    if not isinstance(list_proxy, ListProxy):
        raise TypeError("insert_at needs a list or text draft from change()")
    if index < 0:
        index += len(list_proxy)
    for off, v in enumerate(values):
        list_proxy.insert(index + off, v)


def delete_at(list_proxy, index: int, num: int = 1):
    """Delete ``num`` values from a list/text draft (stable.ts:122
    deleteAt — splice semantics, so a negative index is normalised ONCE
    against the pre-delete length)."""
    if index < 0:
        index += len(list_proxy)
    if isinstance(list_proxy, TextProxy):
        list_proxy.delete(index, num)
        return
    if not isinstance(list_proxy, ListProxy):
        raise TypeError("delete_at needs a list or text draft from change()")
    for _ in range(num):
        del list_proxy[index]


def splice(draft, path: list, index, delete: int, new_text: str = ""):
    """Splice a text (or list) found at ``path`` under a change() draft
    (next.ts:289 splice). ``index`` may be a cursor string."""
    target = _resolve_path(draft, path)
    if not isinstance(target, (TextProxy, ListProxy)):
        raise TypeError("splice needs a text or list at the given path")
    if isinstance(index, str):
        index = target._auto.get_cursor_position(target._obj, index)
    if isinstance(target, TextProxy):
        target.splice(index, delete, new_text)
    else:
        delete_at(target, index, delete)
        insert_at(target, index, *new_text)


def get_cursor(doc, path: list, index: int) -> str:
    """A stable cursor for position ``index`` of the text/list at ``path``
    (next.ts:336 getCursor)."""
    target = _resolve_path(doc, path)
    if not isinstance(target, (TextProxy, ListProxy)):
        raise TypeError("get_cursor needs a text or list at the given path")
    return target._auto.get_cursor(target._obj, index)


def get_cursor_position(doc, path: list, cursor: str) -> int:
    """The current index of ``cursor`` in the text/list at ``path``
    (next.ts:366 getCursorPosition)."""
    target = _resolve_path(doc, path)
    if not isinstance(target, (TextProxy, ListProxy)):
        raise TypeError("get_cursor_position needs a text or list at the given path")
    return target._auto.get_cursor_position(target._obj, cursor)


def mark(draft, path: list, range_, name: str, value):
    """Mark a span of the text at ``path`` inside change() (next.ts:387).
    ``range_`` is (start, end) or {'start':..., 'end':..., 'expand':...}."""
    target = _resolve_path(draft, path)
    if not isinstance(target, TextProxy):
        raise TypeError("mark needs a text at the given path")
    if isinstance(range_, dict):
        start, end = range_["start"], range_["end"]
        expand = range_.get("expand", "after")
    else:
        start, end = range_
        expand = "after"
    target.mark(start, end, name, value, expand)


def unmark(draft, path: list, range_, name: str):
    """Remove a mark from a span (next.ts:413 unmark)."""
    target = _resolve_path(draft, path)
    if not isinstance(target, TextProxy):
        raise TypeError("unmark needs a text at the given path")
    if isinstance(range_, dict):
        start, end = range_["start"], range_["end"]
        expand = range_.get("expand", "none")
    else:
        start, end = range_
        expand = "none"
    target.unmark(start, end, name, expand)
