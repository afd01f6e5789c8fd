"""AutoDoc: the implicit-transaction document API.

Mirrors the reference's AutoCommit (reference:
rust/automerge/src/autocommit.rs): every mutating call opens a transaction if
none is open; reads and history operations commit it first. This is the
primary user-facing API of the framework (the analogue of the reference's
wasm/JS surface is built on top of it).

    doc = AutoDoc(device="cpu")
    text = doc.put_object("_root", "content", ObjType.TEXT)
    doc.splice_text(text, 0, 0, "hello")
    data = doc.save()
    doc2 = AutoDoc.load(data, device="cpu")
    doc2.merge(doc)

A document's batched work (the bulk rebuild after a large apply, the stale
reads before it, the save's document order) runs through the merge kernels
on ``device``: the card when it is None, and their plain PyTorch versions
with ``device="cpu"``. Two documents sync by exchanging the bytes of
``generate_sync_message(state).encode()`` (``sync/``); a ``SyncSession``
adds framing, retries and a resident ``DeviceDoc`` feed.
``AutoDoc.open(path, device=..., mirror=...)`` opens a crash-safe durable
document (``storage/durable.py``).

Its transactions type through the native edit sessions (``enable_sessions``
on every autocommit transaction; ``put`` and ``splice_text`` keep a
fast-call closure while one transaction lives, and every read drains the
sessions first), as the reference's do. A commit of more than
``Transaction.SMALL_TAIL_OPS`` session ops leaves the op store stale, so
the next read is a stale read and rebuild through the merge kernels on
``device``. Unlike the reference's, a commit keeps its text session for
the next transaction when nothing else changed the document, so typing
across commits never rebuilds the store, and a put takes the per-op path
when its commit would drain the session anyway (the change bytes are the
same either way). A missing native library raises ``NativeUnavailable``.
"""

from __future__ import annotations

from typing import List, Optional

from .core.document import AutomergeError, Document, ROOT
from .core.transaction import Transaction
from .patches.patch_log import PatchCallback, PatchLog
from .types import ActorId, ObjType


class AutoDoc:
    def __init__(
        self,
        actor: Optional[ActorId] = None,
        document: Optional[Document] = None,
        text_encoding: Optional[str] = None,
        device=None,
    ):
        self.doc = document or Document(
            actor, text_encoding=text_encoding, device=device
        )
        self._tx: Optional[Transaction] = None
        self._manual: Optional[Transaction] = None
        self._isolation: Optional[List[bytes]] = None
        # (obj, tx, closure) memo for the per-edit splice hot path; valid
        # only while the same autocommit transaction is live
        self._splice_cache = None
        # same shape for the per-op map-put hot path; _put_block pins the
        # transaction whose values proved session-ineligible
        self._put_cache = None
        self._put_block = None
        self._diff_cursor: List[bytes] = []
        # persistent observer log (reference: autocommit.rs owns a PatchLog);
        # inactive until an observer is attached so the hot path pays nothing
        self.patch_log = PatchLog(active=False)
        self._patch_callback: Optional[PatchCallback] = None

    # -- observers ----------------------------------------------------------

    def set_patch_callback(
        self, callback: Optional[PatchCallback], from_scratch: bool = False
    ) -> None:
        """Attach a live observer: ``callback(patches)`` fires after every
        commit / apply / merge / sync-receive / incremental load.

        ``from_scratch=True`` leaves the log's cursor unset so the first
        notification materializes the whole current state (reference:
        automerge/current_state.rs — load with an active patch log).
        Otherwise only changes made after attachment are reported.
        """
        self._patch_callback = callback
        if callback is None:
            self.patch_log.set_active(False)
            return
        self.patch_log.set_active(True)
        if not from_scratch:
            self.patch_log.reset(self.doc)
        self._notify_patches()

    def make_patches(self):
        """Drain the patch log: patches covering everything since the last
        drain (reference: Automerge::make_patches / autocommit diff cursor)."""
        return self.patch_log.make_patches(self.doc)

    def _notify_patches(self) -> None:
        if self._patch_callback is None or not self.patch_log.is_active():
            return
        patches = self.patch_log.make_patches(self.doc)
        if patches:
            self._patch_callback(patches)

    # -- transaction management --------------------------------------------

    def _check_manual(self) -> None:
        if self._manual is not None:
            if not self._manual._done:
                raise AutomergeError(
                    "a manual transaction is open; commit or roll it back "
                    "before mutating through the document"
                )
            self._manual = None

    def _ensure_tx(self) -> Transaction:
        self._check_manual()
        if self._tx is None:
            if self._isolation is not None:
                self._tx = self.doc.transaction_at(self._isolation)
            else:
                self._tx = Transaction(self.doc)
                # autocommit transactions may route text splices through
                # the native edit session (core/transaction.py), starting
                # from the one the last commit kept
                self._tx.enable_sessions = True
                self._tx.adopt_session_carry()
        return self._tx

    def _sync_reads(self) -> None:
        # pending native-session ops drain into the store before any read
        if self._tx is not None:
            self._tx._drain_all()

    def commit(self, message: Optional[str] = None, timestamp: Optional[int] = None) -> Optional[bytes]:
        tx = self._tx
        self._tx = None
        self._splice_cache = None  # the closures retain the whole tx
        self._put_cache = None
        self._put_block = None
        if tx is None:
            return None
        if message is not None:
            tx.message = message
        if timestamp is not None:
            tx.timestamp = timestamp
        h = tx.commit()
        if h is not None and self._isolation is not None:
            # isolated edits build on each other: advance the isolation
            # point to the committed change (reference: autocommit isolate)
            self._isolation = [h]
        if h is not None:
            self._notify_patches()
        return h

    def rollback(self) -> int:
        tx = self._tx
        self._tx = None
        self._splice_cache = None
        self._put_cache = None
        self._put_block = None
        return tx.rollback() if tx is not None else 0

    def pending_ops(self) -> int:
        return self._tx.pending_ops() if self._tx else 0

    def transaction(self, message=None, timestamp=None) -> Transaction:
        """Open a manual transaction (commit/rollback is the caller's job).

        While it is open, autocommit mutations on this document raise —
        two live transactions would mint duplicate opids.
        """
        self._check_manual()
        self.commit()
        self._manual = Transaction(self.doc, message=message, timestamp=timestamp)
        return self._manual

    def isolate(self, heads: List[bytes]) -> None:
        """Scope subsequent edits to ``heads`` (reference: autocommit isolate)."""
        self.commit()
        self._isolation = list(heads)

    def integrate(self) -> None:
        self.commit()
        self._isolation = None

    # -- identity ----------------------------------------------------------

    def get_actor(self) -> ActorId:
        return self.doc.actor

    def set_actor(self, actor: ActorId) -> "AutoDoc":
        self.commit()
        self.doc.set_actor(actor)
        return self

    # -- mutation (delegates through the open transaction) ------------------

    def put(self, obj: str, prop, value) -> None:
        c = self._put_cache
        if c is not None and c[0] == obj and c[1] is self._tx:
            r = c[2](prop, value)
            if r > 0:
                return
            self._put_cache = None
            if r < 0:
                # key/value not session-eligible: stop rebuilding for this
                # (transaction, object) or every such put would pay an
                # O(keys) preload
                self._put_block = (self._tx, obj)
        tx = self._ensure_tx()
        if self._put_block != (tx, obj):
            # build the session BEFORE the first generic put: a pure-session
            # transaction commits straight from arrays (no prefix rows)
            fn = tx.fast_put_fn(obj)
            if fn is None:
                # ineligible object (conflicted key, wide ranks, no native):
                # memoize or every put repeats the O(keys) eligibility scan
                self._put_block = (tx, obj)
            else:
                r = fn(prop, value)
                if r > 0:
                    self._put_cache = (obj, tx, fn)
                    return
                if r < 0:
                    self._put_block = (tx, obj)
        tx.put(obj, prop, value)

    def put_object(self, obj: str, prop, obj_type: ObjType) -> str:
        return self._ensure_tx().put_object(obj, prop, obj_type)

    def insert(self, obj: str, index: int, value) -> None:
        self._ensure_tx().insert(obj, index, value)

    def insert_object(self, obj: str, index: int, obj_type: ObjType) -> str:
        return self._ensure_tx().insert_object(obj, index, obj_type)

    def delete(self, obj: str, prop) -> None:
        self._ensure_tx().delete(obj, prop)

    def increment(self, obj: str, prop, by: int) -> None:
        self._ensure_tx().increment(obj, prop, by)

    def splice_text(self, obj: str, pos: int, delete: int, text: str) -> None:
        c = self._splice_cache
        if c is not None and c[0] == obj and c[1] is self._tx:
            if c[2](pos, delete, text):
                return
            self._splice_cache = None  # session gone; rebuild below
        tx = self._ensure_tx()
        tx.splice_text(obj, pos, delete, text)
        fn = tx.fast_splice_fn(obj)
        self._splice_cache = (obj, tx, fn) if fn is not None else None

    def splice_text_many(self, obj: str, edits, clamp: bool = True) -> int:
        """Bulk text ingest: (pos, delete, text) edits in one native pass."""
        return self._ensure_tx().splice_text_many(obj, edits, clamp=clamp)

    def splice(self, obj: str, pos: int, delete: int, values) -> None:
        self._ensure_tx().splice(obj, pos, delete, values)

    def mark(self, obj: str, start: int, end: int, name: str, value, expand="after") -> None:
        self._ensure_tx().mark(obj, start, end, name, value, expand)

    def unmark(self, obj: str, start: int, end: int, name: str, expand="none") -> None:
        self._ensure_tx().unmark(obj, start, end, name, expand)

    # -- reads -------------------------------------------------------------
    # Reads see the open transaction's ops in place (the store is updated as
    # ops are created). Under isolation they read at the isolation clock so
    # reads and mutations agree on what is visible.

    def _read_clock(self, heads):
        if heads is not None:
            return self.doc.clock_at(heads)
        if self._isolation is not None:
            if self._tx is not None and self._tx.scope is not None:
                return self._tx.scope
            return self.doc.clock_at(self._isolation)
        return None

    def get(self, obj: str, prop, heads=None):
        self._sync_reads()
        return self.doc.get(obj, prop, clock=self._read_clock(heads))

    def get_all(self, obj: str, prop, heads=None):
        self._sync_reads()
        return self.doc.get_all(obj, prop, clock=self._read_clock(heads))

    def keys(self, obj: str = ROOT, heads=None):
        self._sync_reads()
        return self.doc.keys(obj, clock=self._read_clock(heads))

    def length(self, obj: str = ROOT, heads=None) -> int:
        if heads is None and self._tx is not None and self._tx._sessions:
            n = self._tx.session_length(self.doc.import_id(obj))
            if n is not None:
                return n
        self._sync_reads()
        return self.doc.length(obj, clock=self._read_clock(heads))

    def text(self, obj: str, heads=None) -> str:
        self._sync_reads()
        return self.doc.text(obj, clock=self._read_clock(heads))

    def list_items(self, obj: str, heads=None):
        self._sync_reads()
        return self.doc.list_items(obj, clock=self._read_clock(heads))

    def map_entries(self, obj: str = ROOT, heads=None):
        self._sync_reads()
        return self.doc.map_entries(obj, clock=self._read_clock(heads))

    def hydrate(self, obj: str = ROOT, heads=None):
        self._sync_reads()
        return self.doc.hydrate(obj, clock=self._read_clock(heads))

    def get_cursor(self, obj: str, position: int, heads=None) -> str:
        self._sync_reads()
        return self.doc.get_cursor(obj, position, clock=self._read_clock(heads))

    def get_cursor_position(self, obj: str, cursor: str, heads=None) -> int:
        self._sync_reads()
        return self.doc.get_cursor_position(obj, cursor, clock=self._read_clock(heads))

    def marks(self, obj: str, heads=None):
        self._sync_reads()
        return self.doc.marks(obj, clock=self._read_clock(heads))

    def object_type(self, obj: str) -> ObjType:
        self._sync_reads()
        return self.doc.object_type(obj)

    def map_range(self, obj: str = ROOT, start=None, end=None, heads=None):
        self._sync_reads()
        return self.doc.map_range(obj, start, end, clock=self._read_clock(heads))

    def list_range(self, obj: str, start: int = 0, end=None, heads=None):
        self._sync_reads()
        return self.doc.list_range(obj, start, end, clock=self._read_clock(heads))

    def values(self, obj: str = ROOT, heads=None):
        self._sync_reads()
        return self.doc.values(obj, clock=self._read_clock(heads))

    def parents(self, obj: str, heads=None):
        self._sync_reads()
        return self.doc.parents(obj, clock=self._read_clock(heads))

    # -- history -----------------------------------------------------------

    def get_heads(self) -> List[bytes]:
        self.commit()
        return self.doc.get_heads()

    def merge(self, other: "AutoDoc") -> List[bytes]:
        self.commit()
        other.commit()
        heads = self.doc.merge(other.doc)
        self._notify_patches()
        return heads

    def fork(self, actor: Optional[ActorId] = None) -> "AutoDoc":
        self.commit()
        return AutoDoc(document=self.doc.fork(actor))

    def fork_at(self, heads: List[bytes], actor: Optional[ActorId] = None) -> "AutoDoc":
        self.commit()
        return AutoDoc(document=self.doc.fork_at(heads, actor))

    def apply_changes(self, changes) -> None:
        self.commit()
        self.doc.apply_changes(changes)
        self._notify_patches()

    def get_changes(self, have_deps: List[bytes]):
        self.commit()
        return self.doc.get_changes(have_deps)

    def get_missing_deps(self, heads: List[bytes] = ()) -> List[bytes]:
        """Hashes named as deps (or in ``heads``) but absent from history
        (reference: automerge.rs get_missing_deps)."""
        self.commit()
        return self.doc.get_missing_deps(list(heads))

    def get_last_local_change(self):
        self.commit()
        idxs = self.doc.states.get(self.doc.actors.lookup(self.doc.actor), [])
        return self.doc.history[idxs[-1]].stored if idxs else None

    # -- diff / patches ------------------------------------------------------

    def diff(self, before_heads, after_heads):
        self.commit()
        return self.doc.diff(before_heads, after_heads)

    def diff_incremental(self, commit: bool = True):
        """Patches since the last diff_incremental / update_diff_cursor call
        (reference: autocommit.rs diff cursor).

        ``commit=False`` diffs only up to the last COMMITTED state — the
        open transaction is left intact (its message/timestamp survive a
        later explicit commit) and its patches surface on the pop after
        that commit."""
        if commit:
            self.commit()
        before = self._diff_cursor
        after = self.doc.get_heads()
        self._diff_cursor = after
        return self.doc.diff(before, after)

    def update_diff_cursor(self, commit: bool = True) -> None:
        if commit:
            self.commit()
        self._diff_cursor = self.doc.get_heads()

    def reset_diff_cursor(self) -> None:
        self._diff_cursor = []

    # -- sync ---------------------------------------------------------------

    def generate_sync_message(self, state):
        """Next sync message for the peer tracked by ``state`` (or None).

        Commits any open transaction first (reference: autocommit.rs sync
        adapter).
        """
        from .sync import generate_sync_message

        self.commit()
        return generate_sync_message(self.doc, state)

    def receive_sync_message(self, state, message) -> None:
        from .sync import receive_sync_message

        self.commit()
        receive_sync_message(self.doc, state, message)
        self._notify_patches()

    # -- save / load -------------------------------------------------------

    def save(self, deflate: bool = True, retain_orphans: bool = True) -> bytes:
        self.commit()
        return self.doc.save(deflate, retain_orphans=retain_orphans)

    def save_and_verify(self, deflate: bool = True) -> bytes:
        self.commit()
        return self.doc.save_and_verify(deflate)

    def save_incremental_after(self, heads: List[bytes]) -> bytes:
        self.commit()
        return self.doc.save_incremental_after(heads)

    @classmethod
    def open(cls, path, **kw):
        """Open (or create) a crash-safe durable document at ``path``
        (storage/durable.py): commits and sync-absorbed changes are
        journaled before acking, the journal compacts into atomic
        snapshots, and reopening replays snapshot + journal with
        torn-tail recovery. Returns a ``DurableDocument`` that delegates
        the whole AutoDoc surface. ``device`` is the document's (None:
        the card); ``mirror=True`` also keeps a resident ``DeviceDoc`` on
        it."""
        from .storage.durable import DurableDocument

        return DurableDocument.open(path, doc_factory=cls, **kw)

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
    ) -> "AutoDoc":
        return cls(
            document=Document.load(
                data, actor, verify,
                on_partial=on_partial, string_migration=string_migration,
                text_encoding=text_encoding, on_error=on_error, device=device,
            )
        )

    def load_incremental(
        self,
        data: bytes,
        verify: bool = True,
        on_partial: str = "ignore",
        on_error: Optional[str] = None,
    ) -> int:
        self.commit()
        applied = self.doc.load_incremental(
            data, verify, on_partial=on_partial, on_error=on_error
        )
        self._notify_patches()
        return applied

    @property
    def salvage_report(self):
        """The report left by the last ``on_error="salvage"`` load, or None."""
        return self.doc.salvage_report
