"""The document/history layer: apply, merge, fork, save, load, reads.

Semantics mirror the reference's Automerge struct (reference:
rust/automerge/src/automerge.rs): a causally-ordered change history with a
queue for not-yet-ready changes, a change DAG for clock derivation, an op
store for current state, and a uniform read API with ``*_at(heads)``
historical variants driven by vector clocks.

Public object ids use the Automerge convention: "_root" or "<ctr>@<actorhex>".

A document runs its batched work on a device (``device``, the card unless
the caller asks for the CPU): the bulk rebuild's element order, the stale
reads after a bulk apply and the save's document order all come from one
merge of the history through the port's kernels (core/bulk_load.py,
ops/merge.py). A failure of those kernels or of the native library
propagates.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..device import resolve_device
from ..native import NativeUnavailable
from ..storage.change import (
    ChangeOp,
    HEAD_STORED,
    ROOT_STORED,
    StoredChange,
    build_change,
    chunk_local_ops,
    parse_change,
)
from ..storage.chunk import CHUNK_DOCUMENT, MAGIC_BYTES
from ..storage.document import (
    DocChangeMeta,
    DocOp,
    ParsedDocument,
    build_document,
    parse_document,
)
from ..types import (
    Action,
    ActorId,
    HEAD,
    Key,
    ObjType,
    OpId,
    ScalarValue,
    is_make_action,
    objtype_for_action,
)
from ..utils.indexed_cache import IndexedCache
from .change_graph import ChangeGraph
from .clock import Clock
from .op_store import (
    LIST_ENC,
    TEXT_ENC,
    MapObject,
    Op,
    OpStore,
    ROOT_OBJ,
    SeqObject,
)

ROOT = "_root"


class FastSaveUnavailable(ValueError):
    """Expected fast-save fallback (not a bug): the array-native encoder
    cannot serve this document; the per-op python path takes over."""

# the typed hierarchy lives in automerge_tpu.errors (error.rs analogue);
# re-exported here because this module historically defined it
from .. import obs  # noqa: E402
from ..errors import AutomergeError, DuplicateSeqNumber  # noqa: E402,F401


class AppliedChange:
    """A change in the history with its actor translation table."""

    __slots__ = ("stored", "actor_idx", "actor_map")

    def __init__(self, stored: StoredChange, actor_idx: int, actor_map: List[int]):
        self.stored = stored
        self.actor_idx = actor_idx
        self.actor_map = actor_map  # chunk-local actor index -> global index

    @property
    def hash(self) -> bytes:
        return self.stored.hash


class Document:
    """A CRDT document: nested maps/lists/text/counters with full history."""

    def __init__(
        self,
        actor: Optional[ActorId] = None,
        text_encoding: Optional[str] = None,
        device=None,
    ):
        from ..types import TEXT_ENCODINGS

        if text_encoding is not None and text_encoding not in TEXT_ENCODINGS:
            raise ValueError(f"unknown text encoding {text_encoding!r}")
        # the text index unit of THIS document (reference: a per-build
        # property, text_value.rs:5-15); None = follow the process default.
        # Activated via a context stack around every width-sensitive entry
        # point (see _width_ctx below), so documents with different
        # encodings coexist in one process.
        self.text_encoding = text_encoding
        # where the merges of the history run (ops/merge.py); None = the card
        self.device = resolve_device(device)
        self.actor = actor or ActorId()
        self.actors: IndexedCache[ActorId] = IndexedCache()
        self.props: IndexedCache[str] = IndexedCache()
        self._ops = OpStore(self.actors)
        self._ops_stale = False
        self.history: List[AppliedChange] = []
        self.history_index: Dict[bytes, int] = {}
        self.states: Dict[int, List[int]] = {}
        self.queue: List[StoredChange] = []
        self.deps: Set[bytes] = set()
        self.change_graph = ChangeGraph()
        self.max_op = 0
        # set by the last salvage load (on_error="salvage"), else None
        self.salvage_report = None
        # exid-string -> OpId memo: actor interning is append-only, so a
        # resolved id never changes (misses are NOT cached)
        self._exid_cache: Dict[str, OpId] = {}
        # the history's op log and one merge of it, with the stale text
        # reads made from them (_history_merge); history is append-only so
        # its length keys the doc state
        self._merge_memo = None
        # live manual transactions (registered by Transaction); a device
        # merge or save while one is open would silently miss its ops.
        # Weak refs: an abandoned (unreachable, never committed) transaction
        # must not block the document forever.
        import weakref

        self.open_transactions = weakref.WeakSet()
        # called with each StoredChange as it enters history — the durable
        # write path (storage/durable.py) journals through this hook so a
        # commit/merge/sync-receive only acks once the change is on disk.
        # An exception here propagates: the caller must not ack.
        self.change_listeners = []

    def _live_transaction(self):
        """The live (un-done) manual transaction, if any."""
        for live in self.open_transactions:
            if not getattr(live, "_done", True):
                return live
        return None

    def _check_no_pending_tx(self, what: str) -> None:
        """Exports built from history (save / incremental save / change
        export) silently miss a live transaction's eagerly-applied ops —
        refuse rather than emit bytes that diverge from local reads."""
        live = self._live_transaction()
        if live is not None and live.pending_ops():
            raise AutomergeError(
                f"cannot {what} while a transaction with pending ops is "
                "open; commit or roll it back first"
            )

    # -- op store (lazily materialized) ------------------------------------
    #
    # The change history is the document's source of truth; the op store is
    # a materialized view of it. Bulk applies (merge / sync catch-up / fork)
    # only mark the view stale — the first read or local edit rebuilds it
    # once, so K consecutive bulk applies pay ONE rebuild, not K. This is
    # the host-side mirror of the device design (op columns are derived
    # from changes on demand); the reference has no analogue because its
    # reads and writes share the eagerly-maintained B-tree (op_set.rs:28).

    @property
    def ops(self) -> OpStore:
        if self._ops_stale:
            self._materialize_ops()
        return self._ops

    @ops.setter
    def ops(self, store: OpStore) -> None:
        self._ops = store
        self._ops_stale = False

    def _materialize_ops(self) -> None:
        from .bulk_load import MalformedHistory, rebuild_op_store

        self._ops_stale = False  # cleared first: rebuild reads doc state
        try:
            try:
                rebuild_op_store(self)
            except MalformedHistory:
                # the rebuild's validation refused the history: the per-op
                # replay raises the precise error (or builds the store)
                self._rebuild_slow()
        except BaseException:
            # a half-built store must never serve reads: keep the view
            # stale so EVERY read raises, not just the first
            self._ops_stale = True
            raise

    # -- identity ----------------------------------------------------------

    def set_actor(self, actor: ActorId) -> None:
        self.actor = actor

    def get_actor(self) -> ActorId:
        return self.actor

    # -- object id conversion ----------------------------------------------

    def export_id(self, obj: OpId) -> str:
        if obj[0] == 0:
            return ROOT
        return f"{obj[0]}@{self.actors.get(obj[1]).to_hex()}"

    def import_id(self, exid: str) -> OpId:
        if exid == ROOT:
            return ROOT_OBJ
        hit = self._exid_cache.get(exid)
        if hit is not None:
            return hit
        try:
            ctr_s, actor_hex = exid.split("@", 1)
            ctr = int(ctr_s)
            idx = self.actors.lookup(ActorId.from_hex(actor_hex))
        except (ValueError, AttributeError) as e:
            raise AutomergeError(f"invalid object id {exid!r}") from e
        if idx is None:
            raise AutomergeError(f"object id {exid!r} references unknown actor")
        opid = (ctr, idx)
        self._exid_cache[exid] = opid
        return opid

    def import_obj(self, exid: str) -> OpId:
        obj = self.import_id(exid)
        if not self.ops.has_obj(obj):
            raise AutomergeError(f"no such object {exid!r}")
        return obj

    # -- heads / clocks ----------------------------------------------------

    def get_heads(self) -> List[bytes]:
        return sorted(self.deps)

    def clock_at(self, heads: Optional[Iterable[bytes]]) -> Optional[Clock]:
        if heads is None:
            return None
        return self.change_graph.clock_for_heads(heads)

    # -- change application ------------------------------------------------

    # Large batches skip per-op python apply: the op store is rebuilt in
    # bulk on the first read or edit (core/bulk_load.py), its element order
    # from the merge kernels, and a read-only consumer never builds it
    # (stale reads). Threshold balances the
    # linear rebuild of the whole history against the per-op cost of the
    # incremental path.
    BULK_MIN_OPS = 8_000

    def apply_changes(self, changes: Iterable[StoredChange]) -> None:
        changes = list(changes)
        if obs.enabled():
            obs.event(
                "apply_changes", changes=len(changes),
                ops=sum(len(c.ops) for c in changes),
            )
        if self._bulk_eligible(changes):
            try:
                self._apply_changes_bulk(changes)
                return
            except ValueError:
                # the batch's bookkeeping refused it (a duplicate seq):
                # the incremental apply below reports the precise failure
                pass
        for change in changes:
            if change.hash in self.history_index:
                continue
            if self._is_duplicate_seq(change):
                raise DuplicateSeqNumber(change.seq, change.actor.hex())
            if self._is_causally_ready(change):
                self._apply_change(change)
            else:
                self.queue.append(change)
        self._drain_queue()
        # Changes still in the queue wait for their dependencies; the
        # reference likewise holds not-yet-ready changes without erroring.

    def _bulk_eligible(self, changes: List[StoredChange]) -> bool:
        new_ops = sum(
            len(c.ops) for c in changes if c.hash not in self.history_index
        )
        if new_ops < self.BULK_MIN_OPS:
            return False
        existing = sum(len(a.stored.ops) for a in self.history)
        # small increment on a big doc: incremental wins
        return new_ops * 8 >= existing

    def _apply_changes_bulk(self, changes: List[StoredChange]) -> None:
        """History bookkeeping per change, one bulk op-store rebuild.

        Same causal-queue / dup-seq semantics as the incremental path; the
        op store is marked stale and rebuilt from the full history on the
        next read (core/bulk_load.py), so per-op python apply never runs.

        Structural validation of op payloads is deferred with the rebuild:
        a malformed change accepted here raises on every subsequent read
        (fail-loud; the store is never partially served), where the per-op
        path would have raised at apply time.
        """
        ready: List[StoredChange] = []
        pending: List[StoredChange] = []
        seen_hashes = set()
        seen_seqs = set()
        for change in changes:
            if change.hash in self.history_index or change.hash in seen_hashes:
                continue
            if self._is_duplicate_seq(change) or (change.actor, change.seq) in seen_seqs:
                raise DuplicateSeqNumber(change.seq, change.actor.hex())
            seen_hashes.add(change.hash)
            seen_seqs.add((change.actor, change.seq))
            pending.append(change)
        known = set(self.history_index)
        progress = True
        while progress:
            progress = False
            still = []
            for change in pending:
                if all(d in known for d in change.dependencies):
                    ready.append(change)
                    known.add(change.hash)
                    progress = True
                else:
                    still.append(change)
            pending = still
        # also pull anything already queued whose deps are now satisfied
        queued_ready = True
        while queued_ready:
            queued_ready = False
            remaining = []
            for change in self.queue:
                if change.hash in known:
                    continue
                if all(d in known for d in change.dependencies):
                    ready.append(change)
                    known.add(change.hash)
                    queued_ready = True
                else:
                    remaining.append(change)
            self.queue = remaining
        self.queue.extend(pending)
        if not ready:
            return
        for change in ready:
            actor_map = [self.actors.cache(ActorId(a)) for a in change.actors]
            self._update_history(AppliedChange(change, actor_map[0], actor_map))
        # defer the op-store rebuild to the first read/edit (see `ops`)
        self._ops_stale = True

    def _rebuild_slow(self) -> None:
        """Replay the whole history through the per-op apply path into a
        fresh store, for a history the bulk rebuild's validation refused
        (``MalformedHistory``): the per-op path raises the precise error.
        Installed only on success, so a mid-replay failure never leaves a
        partial store behind."""
        from .op_store import OpStore

        store = OpStore(self.actors)
        for applied in self.history:
            actor_map = applied.actor_map
            for obj_id, op in self._import_ops(applied.stored, actor_map):
                store.insert_op(obj_id, op)
        self.ops = store

    def _drain_queue(self) -> None:
        applied = True
        while applied:
            applied = False
            remaining = []
            for change in self.queue:
                if change.hash in self.history_index:
                    applied = True
                    continue
                if self._is_causally_ready(change):
                    self._apply_change(change)
                    applied = True
                else:
                    remaining.append(change)
            self.queue = remaining

    def _is_causally_ready(self, change: StoredChange) -> bool:
        return all(d in self.history_index for d in change.dependencies)

    def _is_duplicate_seq(self, change: StoredChange) -> bool:
        actor_idx = self.actors.lookup(ActorId(change.actor))
        if actor_idx is None:
            return False
        for hist_idx in self.states.get(actor_idx, []):
            if self.history[hist_idx].stored.seq == change.seq:
                return True
        return False

    def get_missing_deps(self, heads: Iterable[bytes]) -> List[bytes]:
        """Dependencies required before queued changes (and ``heads``) apply."""
        in_queue = {c.hash for c in self.queue}
        missing = set()
        for change in self.queue:
            for dep in change.dependencies:
                if dep not in self.history_index and dep not in in_queue:
                    missing.add(dep)
        for h in heads:
            if h not in self.history_index and h not in in_queue:
                missing.add(h)
        return sorted(missing)

    def _apply_change(self, change: StoredChange) -> None:
        actor_map = [self.actors.cache(ActorId(a)) for a in change.actors]
        applied = AppliedChange(change, actor_map[0], actor_map)
        if self._ops_stale:
            # the store is already due a full rebuild from history — fold
            # this change into it instead of materializing mid-apply
            self._update_history(applied)
            return
        ops = self._import_ops(change, actor_map)
        self._update_history(applied)
        for obj_id, op in ops:
            self.ops.insert_op(obj_id, op)

    def _import_ops(
        self, change: StoredChange, actor_map: List[int]
    ) -> List[Tuple[OpId, Op]]:
        """Translate chunk-local ChangeOps to store ops with global indices.

        Mirrors reference import_ops (automerge.rs:860-914).
        """
        out = []
        author = actor_map[0]
        for i, cop in enumerate(change.ops):
            opid = (change.start_op + i, author)
            obj = self._import_objid(cop.obj, actor_map)
            key = None
            elem = None
            if cop.key.prop is not None:
                key = self.props.cache(cop.key.prop)
            else:
                e = cop.key.elem
                elem = HEAD if e[0] == 0 else (e[0], actor_map[e[1]])
            pred = self.ops.sort_opids(
                [(p[0], actor_map[p[1]]) for p in cop.pred]
            )
            op = Op(
                id=opid,
                action=cop.action,
                value=cop.value,
                key=key,
                elem=elem,
                insert=cop.insert,
                pred=pred,
                mark_name=cop.mark_name,
                expand=cop.expand,
            )
            out.append((obj, op))
        return out

    @staticmethod
    def _import_objid(obj: OpId, actor_map: List[int]) -> OpId:
        if obj[0] == 0:
            return ROOT_OBJ
        return (obj[0], actor_map[obj[1]])

    def _update_history(self, applied: AppliedChange) -> None:
        idx = len(self.history)
        self.history.append(applied)
        self.history_index[applied.hash] = idx
        self.states.setdefault(applied.actor_idx, []).append(idx)
        self.change_graph.add_change(
            applied.hash,
            applied.actor_idx,
            applied.stored.seq,
            applied.stored.max_op,
            applied.stored.dependencies,
        )
        for dep in applied.stored.dependencies:
            self.deps.discard(dep)
        self.deps.add(applied.hash)
        self.max_op = max(self.max_op, applied.stored.max_op)
        if self.change_listeners:
            try:
                for cb in self.change_listeners:
                    cb(applied.stored)
            except Exception:
                # the change is in history but the caller's op-store
                # bookkeeping for it will never complete (the exception
                # unwinds through it): force a rebuild from history so
                # reads stay consistent with the heads we now advertise
                self._ops_stale = True
                raise

    # -- transactions ------------------------------------------------------

    def transaction(self, message=None, timestamp=None):
        """Open a manual transaction at the current heads
        (reference: automerge.rs transaction())."""
        from .transaction import Transaction

        return Transaction(self, message=message, timestamp=timestamp)

    def isolate_actor(self, heads: List[bytes]):
        """(scope clock, actor) for an isolated transaction at ``heads``.

        Walks concurrency-suffix levels until it finds an actor whose
        existing ops are all covered by the clock — pinning that actor in
        the scope then cannot leak ops from a previous isolation session
        at the same heads (reference: automerge.rs isolate_actor
        1072-1092, get_isolated_actor_index)."""
        scope = self.clock_at(heads)
        actor = self.actor
        level = 1
        while True:
            idx = self.actors.cache(actor)
            idxs = self.states.get(idx)
            max_op = self.history[idxs[-1]].stored.max_op if idxs else 0
            if max_op == 0 or scope.covers((max_op, idx)):
                return scope, actor
            actor = self.actor.with_concurrency_suffix(level)
            level += 1

    def transaction_at(self, heads: List[bytes], message=None, timestamp=None):
        """Open a manual transaction scoped to the state at ``heads``:
        reads and position resolution see only ops the heads' clock covers,
        and the transaction's actor gets a concurrency suffix so its opids
        cannot collide with edits made since (reference:
        automerge.rs:295-298 transaction_at, isolate_actor 1072-1092)."""
        from .transaction import Transaction

        scope, actor = self.isolate_actor(heads)
        tx = Transaction(
            self, message=message, timestamp=timestamp, scope=scope, actor=actor
        )
        tx.deps = list(heads)
        return tx

    # -- merge / fork ------------------------------------------------------

    def get_changes(self, have_deps: List[bytes]) -> List[StoredChange]:
        """Changes not reachable from ``have_deps``, in causal order."""
        self._check_no_pending_tx("export changes")
        known = self.change_graph.ancestor_hashes(have_deps)
        return [c.stored for c in self.history if c.hash not in known]

    def get_change_by_hash(self, h: bytes) -> Optional[StoredChange]:
        idx = self.history_index.get(h)
        return self.history[idx].stored if idx is not None else None

    def get_changes_added(self, other: "Document") -> List[StoredChange]:
        """Changes in ``other`` that this document lacks (reference:
        automerge.rs get_changes_added — DFS from other's heads)."""
        return [
            c.stored for c in other.history if c.hash not in self.history_index
        ]

    def merge(self, other: "Document") -> List[bytes]:
        other._check_no_pending_tx("merge from")  # exports other's history
        changes = self.get_changes_added(other)
        self.apply_changes(changes)
        return self.get_heads()

    def fork(self, actor: Optional[ActorId] = None) -> "Document":
        self._check_no_pending_tx("fork")
        doc = Document(actor or ActorId(), text_encoding=self.text_encoding,
                       device=self.device)
        doc.apply_changes(c.stored for c in self.history)
        return doc

    def fork_at(self, heads: List[bytes], actor: Optional[ActorId] = None) -> "Document":
        self._check_no_pending_tx("fork_at")
        keep = self.change_graph.ancestor_hashes(heads)
        missing = [h for h in heads if h not in self.history_index]
        if missing:
            raise AutomergeError(f"fork_at: unknown heads {missing}")
        doc = Document(actor or ActorId(), text_encoding=self.text_encoding,
                       device=self.device)
        doc.apply_changes(c.stored for c in self.history if c.hash in keep)
        return doc

    # -- reads -------------------------------------------------------------

    def object_type(self, obj: str) -> ObjType:
        return self.ops.obj_type(self.import_obj(obj))

    def _render_op(self, op: Op, clock) -> object:
        """The public value of a visible op: obj / counter / scalar tuple."""
        if is_make_action(op.action):
            return ("obj", objtype_for_action(op.action), self.export_id(op.id))
        if op.is_counter:
            return ("counter", op.counter_value_at(clock))
        return ("scalar", op.value)

    def _resolve_clock(self, heads, clock):
        return clock if clock is not None else self.clock_at(heads)

    def get(self, obj: str, prop, heads=None, clock=None):
        """Winner value at ``prop`` (a key or an index): (value, id) or None."""
        vals = self.get_all(obj, prop, heads, clock)
        return vals[-1] if vals else None

    def get_all(self, obj: str, prop, heads=None, clock=None) -> List[Tuple[object, str]]:
        """All conflicting values at ``prop``, winner last."""
        obj_id = self.import_obj(obj)
        clock = self._resolve_clock(heads, clock)
        info = self.ops.get_obj(obj_id)
        if isinstance(info.data, MapObject):
            if not isinstance(prop, str):
                raise AutomergeError("map lookup requires a string key")
            key = self.props.lookup(prop)
            if key is None:
                return []
            vis = self.ops.visible_map_ops(obj_id, key, clock)
        else:
            if not isinstance(prop, int):
                raise AutomergeError("sequence lookup requires an integer index")
            # index by the object's own encoding: character position for
            # TEXT (reference get_all_for passes obj.encoding,
            # automerge.rs:1544-1556)
            enc = TEXT_ENC if info.data.obj_type == ObjType.TEXT else LIST_ENC
            el = self.ops.nth(obj_id, prop, enc, clock)
            if el is None:
                return []
            vis = el.visible_ops(clock)
        return [(self._render_op(op, clock), self.export_id(op.id)) for op in vis]

    def keys(self, obj: str, heads=None, clock=None) -> List[str]:
        obj_id = self.import_obj(obj)
        clock = self._resolve_clock(heads, clock)
        idxs = self.ops.map_keys(obj_id, clock)
        return sorted(self.props.get(i) for i in idxs)

    def length(self, obj: str, heads=None, clock=None) -> int:
        obj_id = self.import_obj(obj)
        info = self.ops.get_obj(obj_id)
        clock = self._resolve_clock(heads, clock)
        if isinstance(info.data, MapObject):
            return len(self.ops.map_keys(obj_id, clock))
        enc = TEXT_ENC if info.data.obj_type == ObjType.TEXT else LIST_ENC
        return self.ops.seq_length(obj_id, enc, clock)

    def text(self, obj: str, heads=None, clock=None) -> str:
        clock = self._resolve_clock(heads, clock)
        if clock is None and self._ops_stale:
            # read-only consumer after a bulk apply (the sync catch-up
            # pattern): answer from history arrays without materializing
            # the op store (bulk_load.stale_text)
            t = self._stale_text(obj)
            if t is not None:
                return t
        obj_id = self.import_obj(obj)
        return self.ops.text(obj_id, clock)

    def _stale_text(self, obj: str):
        from .bulk_load import stale_read_state, stale_text

        memo = self._history_merge()
        cache = memo["text"]
        if obj not in cache:
            state = stale_read_state(self)
            # None memoized too: the store answers that object
            cache[obj] = None if state is None else stale_text(self, obj, state)
        return cache[obj]

    def _history_merge(self) -> dict:
        """The whole history's op log (``OpLog.from_changes``) and one
        merge of it on ``self.device`` (``merge_columns`` with
        ``DeviceDoc.READ_FETCH``; None for an empty history), memoised by
        the history's length: {"n", "log", "res", "text"}. The stale reads
        (``bulk_load.stale_read_state``), the op-store rebuild's document
        order (``bulk_load._seq_export``) and the save's
        (``_doc_op_cols_fast``) at one history length share this one
        merge; "text" keeps the stale reads' answers by object. A new
        change lengthens the history and so drops the memo; a load or a
        fork is a new document with none. A failed merge memoises
        nothing."""
        memo = self._merge_memo
        if memo is not None and memo["n"] == len(self.history):
            return memo
        from ..ops.device_doc import DeviceDoc
        from ..ops.merge import merge_columns
        from ..ops.oplog import OpLog

        n = len(self.history)
        log = OpLog.from_changes([a.stored for a in self.history])
        res = None
        if log.n:
            res = merge_columns(
                log.columns(), fetch=DeviceDoc.READ_FETCH, n_objs=log.n_objs,
                n_props=len(log.props), device=self.device,
            )
        self._merge_memo = {"n": n, "log": log, "res": res, "text": {}}
        return self._merge_memo

    def list_items(self, obj: str, heads=None, clock=None) -> List[Tuple[object, str]]:
        obj_id = self.import_obj(obj)
        clock = self._resolve_clock(heads, clock)
        return [
            (self._render_op(w, clock), self.export_id(w.id))
            for _, w in self.ops.visible_elements(obj_id, clock)
        ]

    def map_entries(self, obj: str, heads=None, clock=None) -> List[Tuple[str, object, str]]:
        obj_id = self.import_obj(obj)
        clock = self._resolve_clock(heads, clock)
        out = []
        for key_idx in self.ops.map_keys(obj_id, clock):
            run = self.ops.visible_map_ops(obj_id, key_idx, clock)
            if run:
                w = run[-1]
                out.append(
                    (self.props.get(key_idx), self._render_op(w, clock), self.export_id(w.id))
                )
        out.sort(key=lambda kv: kv[0])
        return out

    def map_range(
        self, obj: str, start: Optional[str] = None, end: Optional[str] = None,
        heads=None, clock=None,
    ) -> List[Tuple[str, object, str]]:
        """(key, winner value, value id) for map keys in [start, end)
        (reference: read.rs map_range/map_range_at)."""
        from ..utils.ranges import filter_map_range

        return filter_map_range(self.map_entries(obj, heads=heads, clock=clock), start, end)

    def list_range(
        self, obj: str, start: int = 0, end: Optional[int] = None,
        heads=None, clock=None,
    ) -> List[Tuple[int, object, str]]:
        """(index, winner value, value id) for indices in [start, end)
        (reference: read.rs list_range/list_range_at). Walks only the
        requested span — O(end-start + index seek), not O(list length)."""
        obj_id = self.import_obj(obj)
        clock = self._resolve_clock(heads, clock)
        out: List[Tuple[int, object, str]] = []
        idx = max(start, 0)
        for _, w in self.ops.visible_elements_range(obj_id, start, end, clock):
            out.append((idx, self._render_op(w, clock), self.export_id(w.id)))
            idx += 1
        return out

    def values(self, obj: str, heads=None, clock=None) -> List[Tuple[object, str]]:
        """Winner (value, id) pairs of an object, map or sequence
        (reference: read.rs values/values_at)."""
        info = self.ops.get_obj(self.import_obj(obj))
        if isinstance(info.data, MapObject):
            return [
                (val, vid) for _, val, vid in self.map_entries(obj, heads=heads, clock=clock)
            ]
        return self.list_items(obj, heads=heads, clock=clock)

    def parents(self, obj: str, heads=None, clock=None) -> List[Tuple[str, object]]:
        """Path from ``obj`` up to the root: [(parent id, key-or-index), ...]
        (reference: read.rs parents/parents_at — sequence indices resolve
        at the given heads)."""
        obj_id = self.import_obj(obj)
        clock = self._resolve_clock(heads, clock)
        path = []
        while obj_id != ROOT_OBJ:
            info = self.ops.get_obj(obj_id)
            parent = info.parent
            if info.parent_key is not None:
                path.append((self.export_id(parent), self.props.get(info.parent_key)))
            else:
                # resolve the element's index in the parent sequence at the
                # read clock (None when invisible there)
                idx = self._elem_index(parent, info.parent_elem, clock)
                path.append((self.export_id(parent), idx))
            obj_id = parent
        return path

    def _elem_index(self, parent: OpId, elem: OpId, clock=None) -> Optional[int]:
        if clock is None:
            # current state: O(sqrt n) via the block order-statistics index
            info = self.ops.get_obj(parent)
            el = info.data.by_id.get(elem)
            if el is None or el.winner() is None:
                return None
            return self.ops.position_of(parent, el)
        for i, (el, _) in enumerate(self.ops.visible_elements(parent, clock)):
            if el.elem_id == elem:
                return i
        return None

    # -- cursors -------------------------------------------------------------

    def get_cursor(self, obj: str, position: int, heads=None, clock=None) -> str:
        """A stable reference to the element at ``position`` — the element
        op's id, exported as "<ctr>@<actorhex>" (reference: cursor.rs)."""
        obj_id = self.import_obj(obj)
        info = self.ops.get_obj(obj_id)
        if not isinstance(info.data, SeqObject):
            raise AutomergeError("cursors only apply to sequences")
        clock = self._resolve_clock(heads, clock)
        enc = TEXT_ENC if info.data.obj_type == ObjType.TEXT else LIST_ENC
        el = self.ops.nth(obj_id, position, enc, clock)
        if el is None:
            raise AutomergeError(f"cursor position {position} out of bounds")
        return self.export_id(el.elem_id)

    def get_cursor_position(self, obj: str, cursor: str, heads=None, clock=None) -> int:
        """Current index of the element ``cursor`` refers to; if that element
        is gone, the index it would occupy (reference: automerge.rs
        seek_opid)."""
        obj_id = self.import_obj(obj)
        info = self.ops.get_obj(obj_id)
        if not isinstance(info.data, SeqObject):
            raise AutomergeError("cursors only apply to sequences")
        clock = self._resolve_clock(heads, clock)
        enc = TEXT_ENC if info.data.obj_type == ObjType.TEXT else LIST_ENC
        target = self.import_id(cursor)
        el = info.data.by_id.get(target)
        if el is None:
            raise AutomergeError(f"cursor {cursor!r} not found in {obj!r}")
        if clock is None:
            # O(blocks + block size) via the order-statistics index
            return self.ops.position_of(obj_id, el, enc)
        index = 0
        for e in info.data.elements():
            if e is el:
                return index
            w = e.winner(clock)
            if w is not None:
                index += w.text_width() if enc == TEXT_ENC else 1
        raise AutomergeError(f"cursor {cursor!r} not found in {obj!r}")

    # -- marks ---------------------------------------------------------------

    def marks(self, obj: str, heads=None, clock=None):
        """Resolved mark spans for a sequence (reference: ReadDoc::marks)."""
        from .marks import calculate_marks

        obj_id = self.import_obj(obj)
        return calculate_marks(self, obj_id, self._resolve_clock(heads, clock))

    # -- diff ----------------------------------------------------------------

    def diff(self, before_heads: List[bytes], after_heads: List[bytes]):
        """Patches transforming the state at ``before_heads`` into the state
        at ``after_heads`` (reference: automerge.rs diff via two clocks)."""
        from ..patches.diff import diff as _diff

        return _diff(self, before_heads, after_heads)

    # -- materialization ---------------------------------------------------

    def dump(self, file=None) -> None:
        """Print the full op table — id/ins/obj/key/value/pred/succ per op,
        in document order (reference: automerge.rs:1190-1239 dump())."""
        import sys

        out = file or sys.stdout

        def short(opid: OpId) -> str:
            if opid[0] == 0:
                return "_root"
            return f"{opid[0]}@{self.actors.get(opid[1]).to_hex()[:4]}"

        def render(op: Op) -> str:
            if is_make_action(op.action):
                return f"make({objtype_for_action(op.action).name.lower()})"
            if op.is_inc:
                return f"inc({op.value.value})"
            if op.is_delete:
                return "del"
            if op.is_mark:
                name = op.mark_name if op.mark_name is not None else "/"
                return f"mark({name},{op.value.to_py()!r})"
            return f"{op.value.tag}:{op.value.to_py()!r}"

        print(
            f"  {'id':12} {'ins':3} {'obj':12} {'key':12} "
            f"{'value':16} {'pred':16} {'succ':16}",
            file=out,
        )
        for obj_id in sorted(
            self.ops.objects, key=lambda o: (o[0], o[1] if o[0] else -1)
        ):
            info = self.ops.get_obj(obj_id)
            rows = []
            if isinstance(info.data, MapObject):
                for key_idx in sorted(
                    info.data.props, key=lambda k: self.props.get(k)
                ):
                    for op in info.data.props[key_idx]:
                        rows.append((self.props.get(key_idx), op))
            else:
                for el, op in info.data.ops_in_order():
                    rows.append((short(el.elem_id), op))
            for key, op in rows:
                pred = ",".join(short(p) for p in op.pred)
                succ = ",".join(short(s) for s in op.succ)
                ins = "t" if op.insert else "f"
                print(
                    f"  {short(op.id):12} {ins:3} {short(obj_id):12} "
                    f"{key:12} {render(op):16} {pred:16} {succ:16}",
                    file=out,
                )

    def convert_scalar_strings_to_text(self) -> None:
        """Replace every visible string scalar in a map or list with a TEXT
        object holding the same content — the reference's StringMigration::
        ConvertToText load option (automerge.rs:1567-1610).

        Parity quirk preserved: a key holding CONFLICTING strings converts
        each visible value in turn, so the last conversion wins and the
        conflict collapses — exactly what the reference's per-op
        ``tx.put_object`` loop does (automerge.rs:1603-1609)."""
        to_convert = []
        for obj_id, info in list(self.ops.objects.items()):
            data = info.data
            if isinstance(data, MapObject):
                if data.obj_type not in (ObjType.MAP, ObjType.TABLE):
                    continue
                for key_idx, run in data.props.items():
                    for op in run:
                        if op.visible() and op.action == Action.PUT and op.value.tag == "str":
                            to_convert.append(
                                (self.export_id(obj_id), self.props.get(key_idx), op.value.value)
                            )
            elif data.obj_type == ObjType.LIST:
                index = 0
                for el in data.elements():
                    w = el.winner()
                    if w is None:
                        continue
                    if w.action == Action.PUT and w.value.tag == "str":
                        to_convert.append((self.export_id(obj_id), index, w.value.value))
                    index += 1
        if not to_convert:
            return
        tx = self.transaction()
        for obj, prop, text in to_convert:
            text_id = tx.put_object(obj, prop, ObjType.TEXT)
            tx.splice_text(text_id, 0, 0, text)
        tx.commit()

    def hydrate(self, obj: str = ROOT, heads=None, clock=None):
        """Materialize an object tree into plain Python values."""
        obj_id = self.import_obj(obj)
        return self._hydrate(obj_id, self._resolve_clock(heads, clock))

    def _hydrate(self, obj_id: OpId, clock):
        info = self.ops.get_obj(obj_id)
        if isinstance(info.data, MapObject):
            out = {}
            for key_idx in self.ops.map_keys(obj_id, clock):
                run = self.ops.visible_map_ops(obj_id, key_idx, clock)
                if run:
                    out[self.props.get(key_idx)] = self._hydrate_op(run[-1], clock)
            return out
        if info.data.obj_type == ObjType.TEXT:
            return self.ops.text(obj_id, clock)
        return [
            self._hydrate_op(w, clock)
            for _, w in self.ops.visible_elements(obj_id, clock)
        ]

    def _hydrate_op(self, op: Op, clock):
        if is_make_action(op.action):
            return self._hydrate(op.id, clock)
        if op.is_counter:
            return op.counter_value_at(clock)
        return op.value.to_py()

    # -- save / load -------------------------------------------------------

    def save(self, deflate: bool = True, retain_orphans: bool = True) -> bytes:
        """Compact document chunk; queued (causally-unready) changes are
        appended as trailing change chunks so they survive a save/load
        cycle (reference: SaveOptions{retain_orphans}, automerge.rs:959-963)
        unless ``retain_orphans=False``."""
        self._check_no_pending_tx("save")
        with obs.span("save"):
            data = self._save_document(deflate)
        if retain_orphans:
            for orphan in self.queue:
                if orphan.raw_bytes:
                    data += orphan.raw_bytes
        return data

    def save_and_verify(self, deflate: bool = True) -> bytes:
        """Save, then load the result back before returning — slow, for
        debugging corrupt-save suspicions (reference: automerge.rs:973)."""
        data = self.save(deflate)
        Document.load(data, device=self.device)
        return data

    def _save_document(self, deflate: bool = True) -> bytes:
        sorted_idx = self.actors.sorted_order()  # sorted position -> global idx
        remap = [0] * len(sorted_idx)  # global idx -> sorted position
        for pos, g in enumerate(sorted_idx):
            remap[g] = pos
        actors = [self.actors.get(g).bytes for g in sorted_idx]

        try:
            op_cols = self._doc_op_cols_fast(remap)
        except FastSaveUnavailable:
            op_cols = None  # documented route (empty doc, unresolved refs)
        doc_ops = self._doc_ops(remap) if op_cols is None else []
        changes = [
            DocChangeMeta(
                actor=remap[c.actor_idx],
                seq=c.stored.seq,
                max_op=c.stored.max_op,
                timestamp=c.stored.timestamp,
                message=c.stored.message,
                deps=sorted(self.history_index[d] for d in c.stored.dependencies),
                extra=c.stored.extra_bytes,
            )
            for c in self.history
        ]
        heads = [(h, self.history_index[h]) for h in self.get_heads()]
        return build_document(actors, heads, doc_ops, changes, deflate, op_cols=op_cols)

    def _doc_op_cols_fast(self, remap: List[int]):
        """Array-native doc-op columns straight from change history.

        The change history (not the python op store) is the source: the
        native batch decoder flattens it into Lamport-ordered columns
        (ops/oplog.py), one merge of them on the document's device ranks
        element order (the linearize kernel's ``elem_index``; the merge is
        ``_history_merge``'s, shared with the stale reads and the rebuild
        at this history length), and the
        document-order permutation + succ lists are numpy joins:
        byte-identical output to the per-op ``_doc_ops`` +
        ``encode_doc_ops`` path, without materializing a single python
        op. Raises FastSaveUnavailable where it cannot serve (an empty
        history, an eager value list, unresolved refs); the caller then
        takes the per-op path.
        """
        import numpy as np

        from ..ops.extract import LazyValues
        from ..ops.oplog import ACTOR_BITS, ACTOR_MASK, ELEM_HEAD, ELEM_MISSING
        from ..storage.document import encode_doc_ops_arrays

        memo = self._history_merge()
        log = memo["log"]
        n = log.n
        if n == 0 or not isinstance(log.values, LazyValues):
            raise FastSaveUnavailable("needs a non-empty lazy value heap")
        if np.any(log.elem_ref == ELEM_MISSING):
            raise FastSaveUnavailable("unresolved element reference in history")
        ids = log.id_key
        action = log.action.astype(np.int64)
        insert = log.insert
        rank_to_save = np.asarray(
            [remap[self.actors.lookup(a)] for a in log.actors], np.int64
        )

        # document-order permutation: objects by packed id (root first),
        # map keys by string, sequence runs by element order, then Lamport
        elem_index = np.asarray(memo["res"]["elem_index"][:n]).astype(np.int64)
        is_map = log.prop >= 0
        if log.props:
            order_p = sorted(range(len(log.props)), key=lambda i: log.props[i])
            str_rank = np.empty(len(log.props), np.int64)
            for r, i in enumerate(order_p):
                str_rank[i] = r
        else:
            str_rank = np.zeros(1, np.int64)
        rows_all = np.arange(n, dtype=np.int64)
        run_row = np.where(
            insert, rows_all, np.where(log.elem_ref >= 0, log.elem_ref, 0)
        )
        sec = np.where(
            is_map, str_rank[np.clip(log.prop, 0, None)], elem_index[run_row]
        )
        rows = np.flatnonzero(action != int(Action.DELETE))
        perm = rows[np.lexsort((ids[rows], sec[rows], log.obj_key[rows]))]
        m = len(perm)

        ok = log.obj_key[perm]
        kr = log.elem_ref[perm].astype(np.int64)
        seq_m = ~is_map[perm]
        head_m = seq_m & (kr == ELEM_HEAD)
        elem_m = seq_m & (kr >= 0)
        src_ids = ids[np.clip(kr, 0, n - 1)]
        lv = log.values
        code = lv.code[perm].astype(np.int64)
        ln = lv.ln[perm].astype(np.int64)
        off = lv.off[perm].astype(np.int64)
        total = int(ln.sum())
        if total:
            run_start = np.concatenate([[0], np.cumsum(ln)[:-1]])
            pos = np.repeat(off, ln) + (
                np.arange(total, dtype=np.int64) - np.repeat(run_start, ln)
            )
            val_raw = np.frombuffer(lv.raw, np.uint8)[pos].tobytes()
        else:
            val_raw = b""

        # succ lists: pred edges reversed, grouped by doc position of the
        # target, ascending source id (op_store add_succ order)
        pos_of = np.full(n, -1, np.int64)
        pos_of[perm] = np.arange(m, dtype=np.int64)
        et = log.pred_tgt.astype(np.int64)
        es = log.pred_src.astype(np.int64)
        ev = et >= 0
        if ev.any():
            tp = pos_of[et[ev]]
            if np.any(tp < 0):
                raise FastSaveUnavailable("succ targets a non-stored row")
            sid = ids[es[ev]]
            eorder = np.lexsort((sid, tp))
            sid = sid[eorder]
            succ_ctr = (sid >> ACTOR_BITS).astype(np.int64)
            succ_actor = rank_to_save[sid & ACTOR_MASK]
            succ_num = np.bincount(tp, minlength=m).astype(np.int64)
        else:
            succ_ctr = np.empty(0, np.int64)
            succ_actor = np.empty(0, np.int64)
            succ_num = np.zeros(m, np.int64)

        pid = ids[perm]
        return encode_doc_ops_arrays(
            {
                "obj_mask": (ok != 0).astype(np.uint8),
                "obj_ctr": (ok >> ACTOR_BITS).astype(np.int64),
                "obj_actor": np.where(ok != 0, rank_to_save[ok & ACTOR_MASK], 0),
                "key_str_ids": np.where(is_map[perm], log.prop[perm], -1).astype(np.int64),
                "key_str_table": log.props,
                "key_ctr": np.where(elem_m, src_ids >> ACTOR_BITS, 0).astype(np.int64),
                "key_ctr_mask": (head_m | elem_m).astype(np.uint8),
                "key_actor": np.where(elem_m, rank_to_save[src_ids & ACTOR_MASK], 0),
                "key_actor_mask": elem_m.astype(np.uint8),
                "id_ctr": (pid >> ACTOR_BITS).astype(np.int64),
                "id_actor": rank_to_save[pid & ACTOR_MASK],
                "insert": insert[perm].astype(np.uint8),
                "action": action[perm],
                "val_meta": ((ln << 4) | code).astype(np.int64),
                "val_raw": val_raw,
                "succ_num": succ_num,
                "succ_ctr": succ_ctr,
                "succ_actor": succ_actor,
                "expand": log.expand[perm].astype(np.uint8),
                "mark_ids": log.mark_name_idx[perm].astype(np.int64),
                "mark_table": log.mark_names,
            }
        )

    def _doc_ops(self, remap: List[int]) -> List[DocOp]:
        """All stored ops in document order with save-time actor indices."""

        def rid(opid: OpId) -> OpId:
            return (opid[0], remap[opid[1]])

        out: List[DocOp] = []
        objs = sorted(
            self.ops.objects.keys(),
            key=lambda o: (o[0], remap[o[1]] if o[0] else -1),
        )
        for obj_id in objs:
            info = self.ops.get_obj(obj_id)
            stored_obj = ROOT_STORED if obj_id == ROOT_OBJ else rid(obj_id)
            if isinstance(info.data, MapObject):
                for key_idx in sorted(
                    info.data.props.keys(), key=lambda k: self.props.get(k)
                ):
                    for op in info.data.props[key_idx]:
                        out.append(
                            self._doc_op(op, stored_obj, Key.map(self.props.get(key_idx)), rid)
                        )
            else:
                for el in info.data.elements():
                    first = True
                    for op in el.run():
                        if first:
                            e = op.elem
                            key = (
                                Key.seq(HEAD_STORED)
                                if e[0] == 0
                                else Key.seq(rid(e))
                            )
                            first = False
                        else:
                            key = Key.seq(rid(el.elem_id))
                        out.append(self._doc_op(op, stored_obj, key, rid))
        return out

    def _doc_op(self, op: Op, stored_obj, key, rid) -> DocOp:
        return DocOp(
            id=rid(op.id),
            obj=stored_obj,
            key=key,
            insert=op.insert,
            action=op.action,
            value=op.value,
            succ=[rid(s) for s in op.succ],
            expand=op.expand,
            mark_name=op.mark_name,
        )

    def save_incremental_after(self, heads: List[bytes]) -> bytes:
        """Concatenated change chunks for everything not covered by ``heads``."""
        self._check_no_pending_tx("save_incremental_after")
        out = bytearray()
        for c in self.get_changes(heads):
            out += c.raw_bytes
        return bytes(out)

    @classmethod
    def load(
        cls,
        data: bytes,
        actor: Optional[ActorId] = None,
        verify: bool = True,
        on_partial: str = "error",
        string_migration: str = "none",
        text_encoding: Optional[str] = None,
        on_error: Optional[str] = None,
        device=None,
    ) -> "Document":
        """Strict by default: any malformed chunk rejects the whole load
        (the reference's LoadOptions defaults to OnPartialLoad::Error for
        ``load``; pass on_partial="ignore" to keep the valid prefix —
        automerge.rs:41-47,601-705). ``string_migration="convert_to_text"``
        rewrites scalar strings into TEXT objects after loading
        (StringMigration, automerge.rs:1567-1610). ``text_encoding`` fixes
        the loaded document's text index unit (LoadOptions analogue of the
        reference's per-build TextValue width).

        ``on_error`` is an alias for ``on_partial`` that also admits
        ``"salvage"``: skip checksum-invalid or truncated chunks, resume at
        the next magic marker, apply every chunk that still verifies, and
        leave a ``SalvageReport`` of what was dropped on
        ``doc.salvage_report``. ``device`` is the document's (None: the
        card).
        """
        if on_error is not None:
            on_partial = on_error
        doc = cls(actor, text_encoding=text_encoding, device=device)
        with obs.span("load", bytes=len(data)):
            doc.load_incremental(data, verify=verify, on_partial=on_partial)
        if string_migration == "convert_to_text":
            doc.convert_scalar_strings_to_text()
        elif string_migration != "none":
            raise ValueError(f"unknown string_migration {string_migration!r}")
        return doc

    def load_incremental(
        self,
        data: bytes,
        verify: bool = True,
        on_partial: str = "ignore",
        on_error: Optional[str] = None,
    ) -> int:
        """Apply every chunk in ``data``; returns the number applied.

        A malformed tail stops the scan: with ``on_partial="ignore"`` (the
        default, matching the reference's incremental load tolerating
        trailing garbage — automerge.rs:730-769, OnPartialLoad::Ignore
        automerge.rs:41-47) the valid prefix is kept; "error" re-raises;
        "salvage" skips corrupt spans and keeps going (see ``load``).
        """
        if on_error is not None:
            on_partial = on_error
        if on_partial == "salvage":
            return self._load_salvage(data, verify)
        if on_partial not in ("ignore", "error"):
            raise ValueError(f"unknown on_partial {on_partial!r}")
        pos = 0
        applied = 0
        while pos < len(data):
            try:
                if pos + 9 > len(data):
                    raise AutomergeError("truncated chunk header")
                if data[pos : pos + 4] != MAGIC_BYTES:
                    raise AutomergeError("invalid chunk magic bytes")
                chunk_type = data[pos + 8]
                if chunk_type == CHUNK_DOCUMENT:
                    parsed, pos = parse_document(data, pos)
                    changes = _reconstruct(parsed, verify)
                else:
                    change, pos = parse_change(data, pos)
                    changes = [change]
            except NativeUnavailable:
                raise  # not a malformed chunk: the library cannot be built
            except Exception:
                if on_partial == "error":
                    raise
                break
            self.apply_changes(changes)
            applied += 1
        return applied

    def _load_salvage(self, data: bytes, verify: bool) -> int:
        """Degrade-gracefully load: apply every verifiable chunk, record
        every dropped span in ``self.salvage_report``, never raise on
        corrupt input."""
        from ..storage.change import parse_change_data
        from ..storage.chunk import write_chunk
        from ..storage.document import (
            DroppedChunk,
            parse_document_chunk,
            salvage_scan,
        )

        chunks, report = salvage_scan(data)
        applied = 0
        for chunk in chunks:
            try:
                if chunk.chunk_type == CHUNK_DOCUMENT:
                    changes = _reconstruct(parse_document_chunk(chunk), verify)
                else:
                    # scan_chunks already verified framing + checksum; just
                    # rebuild canonical raw bytes (hash identity + future
                    # sync need them) and parse the body
                    raw = write_chunk(chunk.chunk_type, chunk.data)
                    changes = [parse_change_data(chunk.data, chunk.hash, raw)]
                self.apply_changes(changes)
                applied += 1
            except NativeUnavailable:
                raise  # not a corrupt chunk: the library cannot be built
            except Exception as e:
                # framing verified but the body (or its application) did
                # not: drop this chunk too, with its real identity
                report.dropped.append(
                    DroppedChunk(
                        offset=chunk.offset,
                        end=-1,  # body-level rejection: span end not tracked
                        reason=f"chunk body rejected: {e}",
                        checksum=chunk.checksum,
                        computed_hash=chunk.hash,
                    )
                )
        report.applied_chunks = applied
        self.salvage_report = report
        obs.count("load.salvaged_chunks", n=applied)
        if report.dropped:
            obs.count("load.dropped_chunks", n=len(report.dropped))
        return applied


def _reconstruct(parsed: ParsedDocument, verify: bool) -> List[StoredChange]:
    """The vectorized reconstruction; an irregular input shape
    (ExtractError) goes to the per-op python path, which decides it. Any
    other failure, of the native library too, propagates."""
    from ..ops.extract import ExtractError

    try:
        return reconstruct_changes_fast(parsed, verify=verify)
    except ExtractError:
        return reconstruct_changes(parsed, verify=verify)


class _ReOp:
    """An op reconstructed from the document format, with rebuilt pred."""

    __slots__ = ("id", "obj", "key", "insert", "action", "value", "pred", "expand", "mark_name")

    def __init__(self, id, obj, key, insert, action, value, pred, expand, mark_name):
        self.id = id
        self.obj = obj
        self.key = key
        self.insert = insert
        self.action = action
        self.value = value
        self.pred = pred
        self.expand = expand
        self.mark_name = mark_name


def reconstruct_changes_fast(doc: ParsedDocument, verify: bool = True) -> List[StoredChange]:
    """Vectorized change reconstruction from a document chunk.

    The array mirror of ``reconstruct_changes`` (reference:
    storage/load/reconstruct_document.rs, load/change_collector.rs):
    native column decode, numpy pred-from-succ + delete synthesis +
    change assignment, array-native per-change column re-encode for head
    hashing. Raises ExtractError on irregular input: the caller hands it
    to the per-op python path, which reports precise errors for genuinely
    malformed files.
    """
    import numpy as np

    from ..ops.extract import ExtractError, doc_op_arrays, validate_doc_arrays
    from ..storage.change import LazyOps, encode_change_cols_arrays

    a = getattr(doc, "op_arrays", None)
    if a is None:
        a = doc_op_arrays(doc.op_col_data or {})
        validate_doc_arrays(a, len(doc.actors))
    n = a["n"]
    n_actors = len(doc.actors)
    from ..types import ACTOR_BITS as B
    if n_actors >= (1 << B):
        raise ExtractError("too many actors for the packed fast path")

    rid = (a["id_ctr"] << B) | a["id_actor"]
    okey = np.where(a["obj_mask"], (a["obj_ctr"] << B) | a["obj_actor"], 0)

    # object segments (doc ops are object-grouped, objects ascending)
    if n:
        bnd = np.concatenate([[True], okey[1:] != okey[:-1]])
        seg_first = np.flatnonzero(bnd)
        seg_keys = okey[seg_first]
        if len(seg_keys) > 1 and np.any(np.diff(seg_keys) <= 0):
            raise AutomergeError("document ops out of object order")
        seg = (np.cumsum(bnd) - 1).astype(np.int64)
        n_segs = len(seg_first)
    else:
        seg = np.zeros(0, np.int64)
        seg_keys = np.zeros(0, np.int64)
        n_segs = 0

    # succ edges -> stored targets or synthesized deletes
    er = np.repeat(np.arange(n, dtype=np.int64), a["succ_num"])
    eid = (a["succ_ctr"] << B) | a["succ_actor"]
    eseg = seg[er] if len(er) else np.zeros(0, np.int64)
    order = np.lexsort((rid, seg)) if n else np.zeros(0, np.int64)
    srid = rid[order] if n else rid
    sseg = seg[order] if n else seg
    seg_start = np.searchsorted(sseg, np.arange(n_segs))
    seg_end = np.searchsorted(sseg, np.arange(n_segs), side="right")
    etgt = np.full(len(er), -1, np.int64)
    if len(er):
        # eseg is non-decreasing (er ascending, seg non-decreasing): each
        # segment's edges are one contiguous slice — O(E log) total
        e_lo = np.searchsorted(eseg, np.arange(n_segs))
        e_hi = np.searchsorted(eseg, np.arange(n_segs), side="right")
        for s in range(n_segs):
            lo, hi = int(e_lo[s]), int(e_hi[s])
            if lo == hi:
                continue
            idxs = np.arange(lo, hi)
            s0, s1 = int(seg_start[s]), int(seg_end[s])
            block = srid[s0:s1]
            p = np.searchsorted(block, eid[idxs])
            pc = np.clip(p, 0, max(len(block) - 1, 0))
            hit = (p < len(block)) & (block[pc] == eid[idxs]) if len(block) else np.zeros(len(idxs), bool)
            etgt[idxs[hit]] = order[s0 + p[hit]]

    # synthesized delete ops: one per unique dangling (segment, succ id)
    miss = np.flatnonzero(etgt < 0)
    if len(miss):
        dkey = np.stack([eseg[miss], eid[miss]], axis=1)
        uniq, inv = np.unique(dkey, axis=0, return_inverse=True)
        d = len(uniq)
        del_seg = uniq[:, 0]
        del_id = uniq[:, 1]
        # the min-id pred source carries the key the delete targets
        src_id_miss = rid[er[miss]]
        min_src_row = np.full(d, -1, np.int64)
        ordm = np.lexsort((src_id_miss, inv))
        first = np.concatenate([[True], inv[ordm][1:] != inv[ordm][:-1]])
        min_src_row[inv[ordm][first]] = er[miss][ordm][first]
        src_act = a["action"][min_src_row]
        if not np.all(np.isin(src_act, (0, 1, 2, 4, 6))):
            raise AutomergeError("no set op found for delete")
    else:
        d = 0
        del_seg = np.zeros(0, np.int64)
        del_id = np.zeros(0, np.int64)
        min_src_row = np.zeros(0, np.int64)
        inv = np.zeros(0, np.int64)

    # combined op table: stored rows [0, n) + deletes [n, n + d)
    N = n + d
    c_id = np.concatenate([rid, del_id])
    c_obj = np.concatenate([okey, seg_keys[del_seg] if d else np.zeros(0, np.int64)])
    c_action = np.concatenate([a["action"], np.full(d, int(Action.DELETE), np.int64)])
    c_insert = np.concatenate([a["insert"], np.zeros(d, np.uint8)])
    c_expand = np.concatenate([a["expand"], np.zeros(d, np.uint8)])
    c_mark = np.concatenate([a["mark_ids"], np.full(d, -1, np.int32)])
    # delete keys inherit the min source's key (set_keys in the python path):
    # its map key id, or its element (own id when insert, else its key elem)
    ms = min_src_row
    d_key_ids = a["key_ids"][ms] if d else np.zeros(0, np.int32)
    ms_ins = a["insert"][ms].astype(bool) if d else np.zeros(0, bool)
    d_elem_from_key = (a["key_ctr"][ms] << B) | a["key_actor"][ms] if d else np.zeros(0, np.int64)
    d_elem_head = ~ms_ins & (a["key_ctr"][ms] == 0) & ~a["key_actor_mask"][ms] if d else np.zeros(0, bool)
    d_elem = np.where(ms_ins, rid[ms] if d else 0, d_elem_from_key) if d else np.zeros(0, np.int64)
    d_seqkey = d_key_ids < 0
    c_key_ids = np.concatenate([a["key_ids"], d_key_ids])
    # element key per combined op: ctr/actor/masks
    s_head = a["key_ctr_mask"] & (a["key_ctr"] == 0) & ~a["key_actor_mask"]
    s_elem_m = a["key_ctr_mask"] & a["key_actor_mask"]
    bad_key = (a["key_ids"] < 0) & ~s_head & ~s_elem_m
    if bad_key.any():
        raise AutomergeError("neither map key nor elem id present")
    c_key_ctr = np.concatenate([
        np.where(s_head, 0, a["key_ctr"]),
        np.where(d_seqkey & ~d_elem_head, d_elem >> B, 0),
    ])
    c_key_ctr_m = np.concatenate([
        (s_head | s_elem_m).astype(np.uint8),
        (d_seqkey).astype(np.uint8),
    ])
    c_key_actor = np.concatenate([
        np.where(s_elem_m, a["key_actor"], 0),
        np.where(d_seqkey & ~d_elem_head, d_elem & ((1 << B) - 1), 0),
    ])
    c_key_actor_m = np.concatenate([
        s_elem_m.astype(np.uint8),
        (d_seqkey & ~d_elem_head).astype(np.uint8),
    ])
    c_vlen = np.concatenate([a["vlen"], np.zeros(d, np.int64)])
    c_voff = np.concatenate([a["voff"], np.zeros(d, np.int64)])
    c_vcode = np.concatenate([a["vcode"].astype(np.int64), np.zeros(d, np.int64)])

    # pred lists: every succ edge reversed; per combined op, ascending src id
    if len(er):
        e_tgt_all = np.where(etgt >= 0, etgt, n + inv_full(miss, inv, len(er)))
    else:
        e_tgt_all = np.zeros(0, np.int64)
    e_src_id = rid[er] if len(er) else np.zeros(0, np.int64)
    eo = np.lexsort((e_src_id, e_tgt_all)) if len(er) else np.zeros(0, np.int64)
    pred_tgt_sorted = e_tgt_all[eo]
    pred_src_sorted = e_src_id[eo]
    pred_num_c = np.bincount(e_tgt_all, minlength=N).astype(np.int64) if len(er) else np.zeros(N, np.int64)
    pred_off_c = np.concatenate([[0], np.cumsum(pred_num_c)]).astype(np.int64)

    # change assignment: per actor, first change with max_op >= op counter
    metas = doc.changes
    by_actor: Dict[int, List[int]] = {}
    for i, ch in enumerate(metas):
        by_actor.setdefault(ch.actor, []).append(i)
    for lst in by_actor.values():
        prev = -1
        for i in lst:
            if metas[i].max_op < prev:
                raise AutomergeError("document changes out of order")
            prev = metas[i].max_op
    c_actor = (c_id & ((1 << B) - 1)).astype(np.int64)
    c_ctr = (c_id >> B).astype(np.int64)
    change_of = np.full(N, -1, np.int64)
    for act in np.unique(c_actor) if N else []:
        lst = by_actor.get(int(act))
        rows_a = np.flatnonzero(c_actor == act)
        if not lst:
            raise AutomergeError(f"op has no owning change (actor {act})")
        maxops = np.asarray([metas[i].max_op for i in lst], np.int64)
        pos = np.searchsorted(maxops, c_ctr[rows_a], side="left")
        if np.any(pos == len(lst)):
            raise AutomergeError("op beyond last change of its actor")
        change_of[rows_a] = np.asarray(lst, np.int64)[pos]

    # per-change chunk build (ops ascending by id within a change)
    actor_bytes = doc.actors
    rawbuf = np.frombuffer(a["vraw"], np.uint8) if len(a["vraw"]) else np.zeros(0, np.uint8)
    changes_out: List[StoredChange] = []
    hash_by_index: Dict[int, bytes] = {}
    derived_heads: Set[bytes] = set()
    order_c = np.lexsort((c_id, change_of)) if N else np.zeros(0, np.int64)
    co_sorted = change_of[order_c] if N else change_of
    starts = np.searchsorted(co_sorted, np.arange(len(metas)))
    ends = np.searchsorted(co_sorted, np.arange(len(metas)), side="right")
    for idx, meta in enumerate(metas):
        rows_c = order_c[int(starts[idx]) : int(ends[idx])]
        num_ops = len(rows_c)
        if num_ops > meta.max_op:
            raise AutomergeError("incorrect max_op in document change")
        start_op = meta.max_op - num_ops + 1
        if start_op < 1:
            raise AutomergeError("change start_op underflow")
        author = meta.actor
        # ragged pred slice for these ops
        pn = pred_num_c[rows_c]
        tp = int(pn.sum())
        if tp:
            rs = np.concatenate([[0], np.cumsum(pn)[:-1]])
            pidx = np.repeat(pred_off_c[rows_c], pn) + (
                np.arange(tp, dtype=np.int64) - np.repeat(rs, pn)
            )
            p_ids = pred_src_sorted[pidx]
        else:
            p_ids = np.zeros(0, np.int64)
        # chunk-local actor table: author first, referenced sorted by bytes
        refs = set()
        ob = c_obj[rows_c]
        refs.update((ob[ob != 0] & ((1 << B) - 1)).tolist())
        kam = c_key_actor_m[rows_c].astype(bool)
        refs.update(c_key_actor[rows_c][kam].tolist())
        refs.update((p_ids & ((1 << B) - 1)).tolist())
        refs.discard(author)
        other = sorted(refs, key=lambda g: actor_bytes[g])
        lut = np.full(n_actors, -1, np.int64)
        lut[author] = 0
        for j, g in enumerate(other):
            lut[g] = j + 1
        # value raw gather
        vl = c_vlen[rows_c]
        tv = int(vl.sum())
        if tv:
            rs2 = np.concatenate([[0], np.cumsum(vl)[:-1]])
            vpos = np.repeat(c_voff[rows_c], vl) + (
                np.arange(tv, dtype=np.int64) - np.repeat(rs2, vl)
            )
            val_raw = rawbuf[vpos].tobytes()
        else:
            val_raw = b""
        cols = encode_change_cols_arrays(
            {
                "obj_mask": (ob != 0).astype(np.uint8),
                "obj_ctr": (ob >> B).astype(np.int64),
                "obj_actor": np.where(ob != 0, lut[ob & ((1 << B) - 1)], 0),
                "key_str_ids": c_key_ids[rows_c],
                "key_str_table": a["key_table"],
                "key_ctr": c_key_ctr[rows_c],
                "key_ctr_mask": c_key_ctr_m[rows_c],
                "key_actor": np.where(kam, lut[c_key_actor[rows_c]], 0),
                "key_actor_mask": c_key_actor_m[rows_c],
                "insert": c_insert[rows_c],
                "action": c_action[rows_c],
                "val_meta": ((vl << 4) | c_vcode[rows_c]).astype(np.int64),
                "val_raw": val_raw,
                "pred_num": pn.astype(np.int64),
                "pred_ctr": (p_ids >> B).astype(np.int64),
                "pred_actor": lut[p_ids & ((1 << B) - 1)],
                "expand": c_expand[rows_c],
                "mark_ids": c_mark[rows_c],
                "mark_table": a["mark_table"],
            }
        )
        deps = []
        for dd in meta.deps:
            if dd not in hash_by_index:
                raise AutomergeError(f"change {idx} depends on later change {dd}")
            deps.append(hash_by_index[dd])
        stored = StoredChange(
            dependencies=deps,
            actor=actor_bytes[author],
            other_actors=[actor_bytes[g] for g in other],
            seq=meta.seq,
            start_op=start_op,
            timestamp=meta.timestamp,
            message=meta.message,
            ops=LazyOps({}, num_ops),
            extra_bytes=meta.extra,
        )
        change = build_change(stored, cols=cols)
        change.ops = LazyOps(change.op_col_data, num_ops)
        hash_by_index[idx] = change.hash
        for dd in deps:
            derived_heads.discard(dd)
        derived_heads.add(change.hash)
        changes_out.append(change)

    if verify and derived_heads != set(doc.heads):
        raise AutomergeError(
            "mismatching heads: derived "
            f"{sorted(h.hex()[:8] for h in derived_heads)} vs stored "
            f"{sorted(h.hex()[:8] for h in doc.heads)}"
        )
    return changes_out


def inv_full(miss_idx, inv, n_edges):
    """Scatter the unique-delete inverse back onto the full edge array."""
    import numpy as np

    out = np.zeros(n_edges, np.int64)
    out[miss_idx] = inv
    return out


def reconstruct_changes(doc: ParsedDocument, verify: bool = True) -> List[StoredChange]:
    """Rebuild the change chunks encoded in a document chunk.

    Mirrors the reference's reconstruction (reference:
    storage/load/reconstruct_document.rs, load/change_collector.rs):
    rebuild ``pred`` from ``succ``, synthesize delete ops for dangling
    succ entries, regroup ops into per-actor changes by op-counter range,
    re-encode each change, and verify derived head hashes.

    Actor indices in the document are positions in the *sorted* actor table,
    so (counter, index) order equals Lamport order throughout.
    """
    # Changes per actor, ordered by max_op, for counter-range assignment.
    by_actor: Dict[int, List[int]] = {}
    for i, ch in enumerate(doc.changes):
        by_actor.setdefault(ch.actor, []).append(i)
    for lst in by_actor.values():
        prev = -1
        for i in lst:
            if doc.changes[i].max_op < prev:
                raise AutomergeError("document changes out of order")
            prev = doc.changes[i].max_op

    per_change_ops: Dict[int, List[_ReOp]] = {}

    def assign(op: _ReOp) -> None:
        actor_changes = by_actor.get(op.id[1])
        if not actor_changes:
            raise AutomergeError(f"op {op.id} has no owning change")
        lo, hi = 0, len(actor_changes)
        while lo < hi:
            mid = (lo + hi) // 2
            if doc.changes[actor_changes[mid]].max_op < op.id[0]:
                lo = mid + 1
            else:
                hi = mid
        if lo == len(actor_changes):
            raise AutomergeError(f"op {op.id} beyond last change of its actor")
        per_change_ops.setdefault(actor_changes[lo], []).append(op)

    # Walk ops object by object (doc ops are object-grouped), rebuilding
    # pred from succ and synthesizing deletes from dangling succ entries.
    current_obj = None
    preds: Dict[OpId, List[OpId]] = {}
    set_keys: Dict[OpId, Key] = {}
    rows: List[DocOp] = []

    def flush_object() -> None:
        nonlocal preds, set_keys, rows
        if not rows and not preds:
            return
        row_ids = {r.id for r in rows}
        obj = rows[0].obj if rows else ROOT_STORED
        for row in rows:
            assign(
                _ReOp(
                    id=row.id,
                    obj=row.obj,
                    key=row.key,
                    insert=row.insert,
                    action=row.action,
                    value=row.value,
                    pred=sorted(preds.get(row.id, [])),
                    expand=row.expand,
                    mark_name=row.mark_name,
                )
            )
        for opid in sorted(preds.keys()):
            if opid in row_ids:
                continue
            plist = preds[opid]
            key = set_keys.get(plist[0])
            if key is None:
                raise AutomergeError(f"no set op found for delete {opid}")
            assign(
                _ReOp(
                    id=opid,
                    obj=obj,
                    key=key,
                    insert=False,
                    action=int(Action.DELETE),
                    value=ScalarValue.null(),
                    pred=sorted(plist),
                    expand=False,
                    mark_name=None,
                )
            )
        preds, set_keys, rows = {}, {}, []

    last_obj_sort = None
    for row in doc.ops:
        if row.obj != current_obj:
            flush_object()
            current_obj = row.obj
            sort_key = (row.obj[0], row.obj[1]) if row.obj != ROOT_STORED else (-1, -1)
            if last_obj_sort is not None and sort_key < last_obj_sort:
                raise AutomergeError("document ops out of object order")
            last_obj_sort = sort_key
        rows.append(row)
        if row.action in (0, 1, 2, 4, 6):  # put or make: remembers the key
            if row.key.prop is not None:
                set_keys[row.id] = row.key
            else:
                elem = row.id if row.insert else row.key.elem
                set_keys[row.id] = Key.seq(elem)
        for s in row.succ:
            preds.setdefault(s, []).append(row.id)
    flush_object()

    # Build each change chunk: ops sorted by op id, chunk-local actor table.
    changes: List[StoredChange] = []
    hash_by_index: Dict[int, bytes] = {}
    derived_heads: Set[bytes] = set()
    for idx, meta in enumerate(doc.changes):
        ops = sorted(per_change_ops.get(idx, []), key=lambda o: o.id)
        num_ops = len(ops)
        if num_ops > meta.max_op:
            raise AutomergeError("incorrect max_op in document change")
        start_op = meta.max_op - num_ops + 1
        if start_op < 1:
            raise AutomergeError("change start_op underflow")
        author = meta.actor
        change_ops, other, _ = chunk_local_ops(
            ops, author, lambda g: doc.actors[g]
        )
        deps = []
        for d in meta.deps:
            if d not in hash_by_index:
                raise AutomergeError(f"change {idx} depends on later change {d}")
            deps.append(hash_by_index[d])
        change = build_change(
            StoredChange(
                dependencies=deps,
                actor=doc.actors[author],
                other_actors=[doc.actors[g] for g in other],
                seq=meta.seq,
                start_op=start_op,
                timestamp=meta.timestamp,
                message=meta.message,
                ops=change_ops,
                extra_bytes=meta.extra,
            )
        )
        hash_by_index[idx] = change.hash
        for d in deps:
            derived_heads.discard(d)
        derived_heads.add(change.hash)
        changes.append(change)

    if verify and derived_heads != set(doc.heads):
        raise AutomergeError(
            "mismatching heads: derived "
            f"{sorted(h.hex()[:8] for h in derived_heads)} vs stored "
            f"{sorted(h.hex()[:8] for h in doc.heads)}"
        )
    return changes



# -- per-document text-encoding activation ------------------------------------
#
# Every width-sensitive Document entry point runs under the document's text
# encoding (reference: the per-build TextValue width, text_value.rs:5-15).
# Wrapping here — one explicit list — rather than per-def decorators keeps
# the hot paths branch-free for the default case (text_encoding=None skips
# the context entirely) and makes the covered surface auditable at a glance.
# Width math also happens inside Transaction methods; core/transaction.py
# wraps those the same way.


def _width_ctx(fn):
    import functools

    from ..types import using_text_encoding

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        enc = self.text_encoding
        if enc is None:
            return fn(self, *args, **kwargs)
        with using_text_encoding(enc):
            return fn(self, *args, **kwargs)

    return wrapped


for _name in (
    "apply_changes",
    "_materialize_ops",
    "merge",
    "length",
    "text",
    "_stale_text",
    "get",
    "get_all",
    "keys",
    "list_items",
    "map_entries",
    "values",
    "parents",
    "get_cursor",
    "get_cursor_position",
    "marks",
    "diff",
    "hydrate",
    "dump",
    "convert_scalar_strings_to_text",
    "load_incremental",
):
    setattr(Document, _name, _width_ctx(getattr(Document, _name)))
del _name
