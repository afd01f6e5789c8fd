"""Crash-safe durable documents: journal + atomic snapshots + recovery.

``DurableDocument`` wraps a document (core ``Document`` or autocommit
``AutoDoc``) with a durable write path:

* every change that enters the history — a committed transaction, a
  merge, a change absorbed from sync — is appended to an append-only
  write-ahead journal (storage/journal.py) *before* the mutating call
  returns, so an acked change is on disk (durably, under
  ``fsync="always"``);
* when the journal grows past ``compact_max_records`` /
  ``compact_max_bytes``, the full document is written to a temp file,
  fsynced, atomically renamed over the snapshot, the directory entry is
  fsynced, and only then is the journal truncated — recovery time stays
  bounded by the compaction thresholds, never by the document's age;
* ``open()`` replays snapshot + journal: the snapshot loads in salvage
  mode (a damaged one degrades instead of refusing), the journal
  truncates at the first torn record, and
  ``obs.count("journal.replayed_records" / "journal.truncated_tail")``
  report what recovery did.

The on-disk layout is a directory::

    <path>/snapshot.am    full document save (atomic-rename target)
    <path>/journal.waj    append-only change journal

Use via ``Document.open(path)`` / ``AutoDoc.open(path)``; every other
document method delegates, with the ack-point methods (commit /
apply_changes / merge / load_incremental / receive_sync_message) also
checking compaction thresholds on the way out.

Small latest-wins metadata rides in the journal as ``REC_META`` records
(re-appended after every compaction): the sync layer persists each
peer's ``shared_heads`` + epoch there (``attach_sync_session`` /
``restore_sync_session``), so a restarted durable peer resumes an
interrupted sync through the epoch/reset handshake instead of always
renegotiating from scratch.

Failure semantics: a journal append that raises leaves the in-memory
document *ahead of* disk — indistinguishable from a crash at that
instant, which is exactly the state recovery is built for.

The port of ``automerge_tpu/storage/durable.py``: it writes the same
``snapshot.am`` and ``journal.waj`` bytes, and each package opens the
other's directories. One name differs. ``device`` keeps the port's
meaning, a torch device (None: the card, raising without one), and is
where the host document's merges run; the flag that asks for a resident
``DeviceDoc`` (the reference's ``device: bool``) is ``mirror``. The
mirror is resolved on the document's device, so a CPU document keeps a
CPU mirror. The mirror's builds (``open(mirror=True)``,
``build_device_mirror``) are ``DeviceDoc.resolve`` on the merge kernels;
the journal's replayed changes reach it through ``apply_changes`` (the
served kernels on the card).
"""

from __future__ import annotations

import contextlib
import posixpath
import sys
import threading
from typing import Dict, List, Optional

from .. import obs
from ..degrade import brownout_active
from ..obs import prof as _prof
from ..integrity import DigestState, finalize_digest
from ..utils.leb128 import decode_uleb, encode_uleb
from .change import parse_change
from .journal import (
    Journal,
    OS_FS,
    REC_CHANGE,
    REC_META,
    decode_meta,
    encode_meta,
)

SNAPSHOT_NAME = "snapshot.am"
JOURNAL_NAME = "journal.waj"

_SYNC_META_PREFIX = "sync/"

# follower-side replication state rides in the journal as latest-wins
# meta (cluster/replication.py): the cursor names the leader stream and
# the last applied LSN, re-appended with every replicated batch inside
# the batch's own ack scope — so cursor and changes share one fsync and
# the cursor can never claim records the journal does not hold
REPL_META_PREFIX = "repl/"
REPL_CURSOR_KEY = REPL_META_PREFIX + "cursor"

# what a parsed (CRC-valid) run image raises when its sections decode but
# do not fit together: the hydrations that prefer the image fall back to
# a re-encode on these only, and let every other error (the native
# library, the card) reach the caller
_IMAGE_FAULTS = (ValueError, IndexError)


class DocumentEvicted(Exception):
    """The durable document behind this reference was closed (demoted to
    the cold tier, or shut down) between the caller resolving the handle
    and issuing a mutation. Retrying re-resolves the handle, which
    hydrates a fresh instance — hence retriable. Without this guard a
    mutation could SILENTLY stage state on a closed instance whose
    change listener is gone: never journaled, never acked-visible,
    dropped when the instance is garbage-collected."""

    retriable = True


class DurableDocument:
    """A document whose changes survive the process. See module docstring."""

    # methods that ack durable state to a caller: wrapped so compaction
    # thresholds are checked after each (never DURING — a snapshot taken
    # mid-batch from the listener could race the op-store rebuild)
    _ACK_METHODS = frozenset(
        {"commit", "apply_changes", "merge", "load_incremental",
         "receive_sync_message"}
    )

    # host methods that mutate document state WITHOUT acking durably on
    # the spot (they stage an autocommit transaction). On a live doc they
    # delegate straight through; on a closed one they must refuse — the
    # staged ops would otherwise die with the evicted instance. Reads
    # stay allowed on a closed instance: the op-store is immutable from
    # here on, so a request that resolved the doc just before demotion
    # still answers consistently.
    _MUTATING_METHODS = frozenset({
        "put", "put_object", "insert", "insert_object", "delete",
        "increment", "splice", "splice_text", "splice_text_many",
        "mark", "unmark", "isolate", "integrate", "rollback",
    })

    def __init__(self, host, core, path, journal, *, fs,
                 compact_max_records: int, compact_max_bytes: int,
                 background_compact: bool = False,
                 compact_cost_ratio: float = 0.0):
        self._host = host  # the wrapped Document or AutoDoc
        self._core = core  # the underlying core Document
        self.path = path
        # the per-doc gauge label (doc.journal_bytes{doc=...} etc.); the
        # registry's cardinality cap bounds a many-doc server's series
        self.obs_name = posixpath.basename(path.rstrip("/")) or path
        self._fs = fs
        self._journal = journal
        self.compact_max_records = compact_max_records
        self.compact_max_bytes = compact_max_bytes
        # the per-document mutex the serving layer executes requests
        # under; the background compactor takes the same lock, so a
        # snapshot never races a mutating request
        self.lock = threading.RLock()
        # cost-based compaction gate: while the journal is smaller than
        # ``compact_cost_ratio`` x the last snapshot, skip compaction even
        # past the record threshold — re-snapshotting a large document
        # for a dribble of fresh records costs more than it saves
        # (replay stays bounded by ratio x snapshot size). 0 disables.
        self.compact_cost_ratio = compact_cost_ratio
        self._last_snapshot_bytes = 0
        # background mode (serving layer): threshold crossings schedule
        # compaction on a daemon thread instead of stalling the ack path
        self._background = background_compact
        self._compact_wake = threading.Event()
        self._compact_stop = False
        self._compact_thread: Optional[threading.Thread] = None
        self._meta: Dict[str, bytes] = {}
        self._compacting = False
        self._closed = False
        # set when a journal append failed AFTER its change entered the
        # in-memory history: memory is ahead of disk, so acking anything
        # more would strand dependents. compact() repairs (the snapshot
        # carries the full history) and clears it.
        self._broken = False
        # per-THREAD ack-scope bookkeeping (depth + whether the current
        # scope chain journaled anything). Depth is thread-local on
        # purpose: a scope's deferred boundary fsync must be paid by the
        # thread that owns the scope — were the depth shared, a scope
        # exiting while another thread's scope is still open would ack
        # with its fsync delegated to that OTHER thread, and a fault in
        # that later fsync could strike after this ack already returned
        # (the chaos suite proves exactly this). Concurrent boundary
        # fsyncs stay cheap: the journal's group-commit combiner
        # collapses them.
        self._tl_scope = threading.local()
        # read/write recency stamp (obs monotonic clock) — the tiered
        # store's LRU signal; refreshed by touch() and every ack exit
        self.last_access = obs.now()
        self._touch_exported = 0.0
        self.device_doc = None  # set by open(mirror=True)
        # the parsed run-coded snapshot image (storage/runsnap.py), when
        # the on-disk snapshot is ARSN: a valid prefix of the history
        # forever (history is append-only), so warm→hot promotion and the
        # next compaction rebuild their OpLog from run tables + a tail
        # append instead of re-extracting columns from every change
        self._run_image = None
        # incremental state digest (integrity.py): the XOR-of-change-
        # hashes accumulator tracks the in-memory HISTORY (fed by the
        # change listener, rebuilt on open), so two documents agree on
        # doc_digest() iff they hold the same change set + frontier —
        # the anti-entropy scrubber's comparison unit
        self._digest = DigestState()
        # cluster replication gate (cluster/replication.py): when set,
        # the OUTERMOST ack-scope exit blocks until enough followers
        # hold the batch durably — a raised gate converts the batch to
        # errors instead of acking un-replicated writes
        self.replication_gate = None

    # -- construction --------------------------------------------------------

    @classmethod
    def open(
        cls,
        path: str,
        *,
        doc_factory=None,
        actor=None,
        text_encoding=None,
        fsync: str = "always",
        fsync_interval: int = 16,
        compact_max_records: int = 1024,
        compact_max_bytes: int = 4 << 20,
        background_compact: bool = False,
        compact_cost_ratio: float = 0.0,
        mirror: bool = False,
        device=None,
        fs=None,
    ) -> "DurableDocument":
        """Open (or create) the durable document directory at ``path``.

        ``doc_factory`` picks the wrapped surface — ``AutoDoc`` (default)
        or core ``Document``; it is built on ``device`` (None: the card).
        ``mirror=True`` additionally recovers a resident ``DeviceDoc`` on
        the same device: built once from the snapshot, then warmed with
        the replayed journal changes through the incremental
        ``OpLog.append_changes`` path (``obs.span("device.recover")``).
        """
        if doc_factory is None:
            from ..api import AutoDoc

            doc_factory = AutoDoc
        fs = fs or OS_FS
        path = str(path)
        fs.makedirs(path)
        # the doc directory's OWN entry in its parent must be durable, or
        # a crash right after creation loses the whole directory no matter
        # how diligently the files inside it were fsynced
        fs.sync_dir(posixpath.dirname(path.rstrip("/")) or ".")
        host = doc_factory(actor=actor, text_encoding=text_encoding,
                           device=device)
        core = host.doc if hasattr(host, "doc") else host

        with obs.span("durable.open"):
            # the journal's lock comes FIRST: reading the snapshot before
            # holding it could pair an old snapshot with a journal another
            # process compacted in between, silently losing acked changes
            journal, records, tail = Journal.open(
                posixpath.join(path, JOURNAL_NAME),
                fs=fs, fsync=fsync, fsync_interval=fsync_interval,
            )
            try:
                return cls._recover(
                    host, core, path, journal, records, fs=fs, mirror=mirror,
                    compact_max_records=compact_max_records,
                    compact_max_bytes=compact_max_bytes,
                    background_compact=background_compact,
                    compact_cost_ratio=compact_cost_ratio,
                )
            except Exception:
                journal.close()  # release the flock; don't wedge the dir
                raise

    @classmethod
    def _recover(cls, host, core, path, journal, records, *, fs, mirror,
                 compact_max_records, compact_max_bytes,
                 background_compact=False,
                 compact_cost_ratio=0.0) -> "DurableDocument":
        """Snapshot load + journal replay, under the already-held lock."""
        from . import runsnap

        snap_path = posixpath.join(path, SNAPSHOT_NAME)
        snap_bytes = 0
        run_image = None
        if fs.exists(snap_path):
            snap = fs.read_bytes(snap_path)
            snap_bytes = len(snap)
            if runsnap.is_runsnap(snap):
                try:
                    run_image = runsnap.parse(snap)
                    core.apply_changes(run_image.changes)
                except runsnap.RunSnapError:
                    # corrupt ARSN container: the embedded change chunks
                    # are magic-prefixed, so the legacy salvage scan
                    # carves whatever survives — same degradation as a
                    # damaged chunk snapshot
                    run_image = None
                    core.load_incremental(snap, on_partial="salvage")
            else:
                core.load_incremental(snap, on_partial="salvage")
            obs.count(
                "store.hydrate_bytes", n=snap_bytes,
                labels={"codec": "runsnap" if run_image is not None else "chunk"},
            )
        if run_image is not None and run_image.n_changes != len(core.history):
            # partial apply (causally incomplete container): the image no
            # longer names a history prefix, drop it
            run_image = None
        dev = None
        if mirror:
            from ..ops.device_doc import DeviceDoc
            from ..ops.oplog import OpLog

            # an empty history still gets a resident DeviceDoc: a fresh
            # device-mode doc starts tracking from its first sync feed
            with obs.span("device.recover", phase="snapshot"):
                log = None
                if run_image is not None:
                    try:
                        log = run_image.to_oplog(
                            [a.stored for a in core.history]
                        )
                    except _IMAGE_FAULTS:
                        log = None
                if log is None:
                    if core.history:
                        obs.count("oplog.hydrate_reencode")
                    log = OpLog.from_changes(
                        [a.stored for a in core.history]
                    )
                with _prof.annotate("amtpu.recover"):
                    dev = DeviceDoc.resolve(log, device=core.device)
        meta: Dict[str, bytes] = {}
        replayed: List = []
        for rec in records:
            if rec.rec_type == REC_CHANGE:
                try:
                    change, _ = parse_change(rec.payload)
                except Exception:
                    # CRC-valid record with an unparseable chunk body:
                    # treat like a salvage drop, keep replaying
                    obs.count("journal.rejected_records")
                    continue
                replayed.append(change)
            elif rec.rec_type == REC_META:
                name, blob = decode_meta(rec.payload)
                meta[name] = blob
        obs.count("journal.replayed_records", n=len(replayed))
        if replayed:
            core.apply_changes(replayed)
            if mirror:
                with obs.span("device.recover", changes=len(replayed)):
                    dev.apply_changes(replayed)

        dd = cls(
            host, core, path, journal, fs=fs,
            compact_max_records=compact_max_records,
            compact_max_bytes=compact_max_bytes,
            background_compact=background_compact,
            compact_cost_ratio=compact_cost_ratio,
        )
        dd._meta = meta
        dd.device_doc = dev
        if dev is not None:
            # the resident mirror exports doc.resident_ops /
            # doc.device_bytes under the same per-doc label
            dev.obs_name = dd.obs_name
            dev._export_doc_gauges()
        dd._last_snapshot_bytes = snap_bytes
        dd._run_image = run_image
        # full digest rebuild, once per open — every later change folds
        # in incrementally through the listener below
        dd._digest.recompute(a.stored.hash for a in core.history)
        core.change_listeners.append(dd._on_change)
        dd._export_doc_gauges()
        return dd

    # -- delegation ----------------------------------------------------------

    def __getattr__(self, name):
        # only reached for names this wrapper does not define itself
        attr = getattr(object.__getattribute__(self, "_host"), name)
        if name in DurableDocument._ACK_METHODS and callable(attr):
            # the doc lock excludes the background compactor's snapshot
            # from racing a commit/merge/sync apply; uncontended RLock
            # cost on the single-threaded path is negligible
            def _acked(*a, _attr=attr, **kw):
                if self._closed:
                    raise DocumentEvicted(
                        f"durable document {self.obs_name!r} was demoted "
                        "to cold; retry to reopen"
                    )
                # ack scope OUTSIDE the lock (the same shape the serving
                # layer's batch drain uses): the boundary fsync and the
                # replication ack gate then run lock-free, so a follower
                # snapshot catch-up needing this lock can proceed while
                # a gated commit waits for it
                with self.ack_scope():
                    with self.lock:
                        return _attr(*a, **kw)

            # bound host methods are stable for this instance's lifetime:
            # memoize the wrapper so hot-path calls (commit per edit) skip
            # the __getattr__ fallback + closure rebuild from now on
            self.__dict__[name] = _acked
            return _acked
        if name in DurableDocument._MUTATING_METHODS and callable(attr):
            def _guarded(*a, _attr=attr, **kw):
                if self._closed:
                    raise DocumentEvicted(
                        f"durable document {self.obs_name!r} was demoted "
                        "to cold; retry to reopen"
                    )
                return _attr(*a, **kw)

            self.__dict__[name] = _guarded
            return _guarded
        return attr

    @property
    def _ack_depth(self) -> int:
        """Depth of the CURRENT THREAD's ack-scope chain (0 = outside)."""
        return getattr(self._tl_scope, "depth", 0)

    @contextlib.contextmanager
    def ack_scope(self):
        """Context manager marking one ack boundary: per-change fsyncs
        inside it are deferred to a single policy fsync (plus a compaction
        check) on exit — even on error, whatever DID enter history must be
        durable at ack. The sync session wraps each received message in
        this when the document is durable."""
        tl = self._tl_scope
        tl.depth = getattr(tl, "depth", 0) + 1
        if tl.depth == 1:
            tl.appended = False
        try:
            yield
        finally:
            tl.depth -= 1
            # a double fault in append() can poison the journal closed
            # while the original I/O error is still unwinding — syncing
            # then would only mask it with 'journal is closed'.
            # Nested scopes defer to the OUTERMOST exit ON THIS THREAD:
            # the serving layer wraps a whole drained batch of wrapped
            # ack calls in one scope, and that group pays one fsync
            # (group commit)
            if tl.depth == 0 and not self._journal.closed:
                self._journal.policy_sync()
                if self.replication_gate is not None:
                    # quorum before ack: the ack_replicas contract
                    # ("on K+1 disks when acked") overrides a lazier
                    # fsync policy — force local durability so the
                    # gate's target covers this batch, then wait for
                    # the follower copies the contract promises
                    self._journal.sync()
                    self.replication_gate()
                self.maybe_compact()
                self._export_doc_gauges()
            elif (
                tl.depth == 0
                and self._journal.poisoned
                and getattr(tl, "appended", False)
                and sys.exc_info()[0] is None
            ):
                # ANOTHER thread's failed fsync poisoned the journal
                # while this scope's appends were pending: they can
                # never be made durable, so exiting cleanly here would
                # ack un-fsynced writes. Every covered waiter errors —
                # unless an exception is already unwinding (masking the
                # original fault helps nobody). A scope that journaled
                # nothing (a read batch on the degraded doc) still
                # serves.
                raise self._journal._closed_error()

    def _export_doc_gauges(self) -> None:
        """Per-doc accounting at the ack boundary: journal footprint and
        a last-access stamp (seconds on the obs monotonic clock — age =
        ``obs.now() - value``). These are the residency-admission signals
        the tiered store's policy consumes; the device layer exports
        ``doc.resident_ops`` / ``doc.device_bytes`` alongside."""
        self.last_access = self._touch_exported = obs.now()
        labels = {"doc": self.obs_name}
        obs.gauge_set("doc.journal_bytes", self._journal.size_bytes,
                      labels=labels)
        obs.gauge_set("doc.last_access_seconds", self.last_access,
                      labels=labels)
        obs.gauge_set("doc.digest_changes", self._digest.count,
                      labels=labels)

    # touch() refreshes the exported gauge at most this often: the stamp
    # the eviction policy reads is the plain attribute (free), and a
    # registry-lock + flight-ring write per REQUEST would make every
    # shard thread serialize on two process-global locks
    TOUCH_EXPORT_INTERVAL_S = 1.0

    def touch(self) -> None:
        """Refresh the last-access stamp from the READ path. The write
        path refreshes at every ack-scope exit, but a read-hot document
        that never commits would otherwise look idle to the tiered
        store's LRU policy and be demoted out from under its readers —
        the RPC layer calls this on every document access. The policy
        reads ``self.last_access`` directly, so the hot path is one
        clock read + one attribute store; the scrape-visible gauge
        refreshes at a bounded (1s) cadence."""
        now = obs.now()
        self.last_access = now
        if now - self._touch_exported >= self.TOUCH_EXPORT_INTERVAL_S:
            self._touch_exported = now
            obs.gauge_set("doc.last_access_seconds", now,
                          labels={"doc": self.obs_name})

    # -- device-mirror residency (tiered store hot <-> warm) -----------------

    def drop_device_mirror(self):
        """Demote hot -> warm: release the resident ``DeviceDoc`` (and
        its per-doc device gauges) while the host op-store keeps
        serving. Returns the dropped mirror (for callers that need to
        detach it from live sessions) or None."""
        dev = self.device_doc
        self.device_doc = None
        if dev is not None:
            obs.remove_doc_gauges(self.obs_name, device_only=True)
            # retain the run-coded column image of the dropped mirror: the
            # next warm→hot promotion (or compaction) rebuilds from run
            # tables instead of re-extracting every change — zero-encode
            # residency transitions even before any compact() has written
            # an ARSN snapshot
            from . import runsnap

            if runsnap.enabled():
                try:
                    idx = self._core.history_index
                    if len(dev.log.changes) == len(self._core.history) and all(
                        c.hash in idx for c in dev.log.changes
                    ):
                        self._run_image = runsnap.RunImage.from_log(dev.log)
                except AttributeError:
                    pass  # a stand-in mirror without an op log
        return dev

    def build_device_mirror(self):
        """Promote warm -> hot: build a resident ``DeviceDoc`` from the
        committed history (the same construction ``open(mirror=True)``
        performs). No-op when a mirror already exists."""
        if self.device_doc is not None:
            return self.device_doc
        from ..ops.device_doc import DeviceDoc
        from ..ops.oplog import OpLog

        with self.lock:
            with obs.span("device.recover", phase="promote"):
                hist = [a.stored for a in self._core.history]
                # the retained run image makes promotion decode-only:
                # run tables expand (np.repeat) and the journal tail
                # splices in — no per-change column re-extraction
                log = self._image_log(hist)
                if log is None:
                    if hist:
                        obs.count("oplog.hydrate_reencode")
                    log = OpLog.from_changes(hist)
                with _prof.annotate("amtpu.promote"):
                    dev = DeviceDoc.resolve(log, device=self._core.device)
            dev.obs_name = self.obs_name
            self.device_doc = dev
            dev._export_doc_gauges()
            # the promotion shipped the compressed image (the resolve's
            # H2D staging moves run tables, merge.stage_cols_device);
            # record what warm->hot residency actually costs
            obs.count("store.promote_resident_bytes",
                      n=dev.resident_nbytes())
        return dev

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- the durable write path ----------------------------------------------

    def _on_change(self, stored) -> None:
        """Change listener (core/document.py ``_update_history``): journal
        every change the moment it enters history, before the mutating
        call acks to its caller."""
        from .journal import JournalPoisoned

        # the digest mirrors HISTORY, and this listener fires exactly
        # once per change entering it — fold the hash in before any
        # journaling outcome, so memory and digest never drift even on
        # the broken (memory-ahead-of-disk) paths below
        self._digest.add(stored.hash)
        if self._broken:
            # refusing BEFORE the append keeps every later change un-acked
            # while memory is ahead of disk — no silently stranded deps.
            # JournalPoisoned is retriable: the doc is degraded (read-only)
            # until a compaction or reopen restores it, and in a cluster a
            # failover can restore service before that
            raise JournalPoisoned(
                "durable document degraded: out of sync with its journal "
                "after a failed append; compact() or reopen to recover"
            )
        raw = stored.raw_bytes
        if raw is None:
            from ..errors import AutomergeError

            # the change is already in history: memory is ahead of disk
            # exactly as in the append-failure case below
            self._broken = True
            raise AutomergeError(
                "durable document received a change without raw bytes"
            )
        # inside a wrapped ack call the fsync is deferred to its boundary;
        # an unwrapped path (e.g. a manual Transaction.commit) syncs here
        try:
            self._journal.append(
                REC_CHANGE, raw, auto_sync=self._ack_depth == 0
            )
            self._tl_scope.appended = True
        except Exception:
            # the change is already in history (listeners fire after the
            # bookkeeping): memory is now ahead of disk. Poison until a
            # compaction re-establishes disk >= memory.
            self._broken = True
            raise

    def doc_digest(self) -> Dict[str, object]:
        """The verifiable state digest: accumulator + change count +
        sorted heads under one SHA-256 (integrity.finalize_digest).
        Taken under the doc lock so heads and accumulator describe one
        instant."""
        with self.lock:
            heads = self._core.get_heads()
            acc, count = self._digest.value()
        return {"digest": finalize_digest(acc, count, heads),
                "changes": count}

    @property
    def journal(self) -> Journal:
        return self._journal

    @property
    def degraded(self) -> bool:
        """True while this document cannot ack writes: a journal append
        failed after its change entered history (memory ahead of disk),
        or a failed fsync poisoned the journal outright. Reads still
        serve; mutations raise the retriable ``JournalPoisoned`` until
        ``compact()`` (fresh snapshot re-establishes disk >= memory,
        reviving a poisoned journal) or a reopen recovers."""
        return self._broken or self._journal.poisoned

    @property
    def meta(self) -> Dict[str, bytes]:
        """Latest-wins journal metadata (read the dict, write via set_meta)."""
        return dict(self._meta)

    def set_meta(self, name: str, blob: bytes) -> None:
        self._meta[name] = blob
        # inside an ack scope (e.g. sync-session persistence riding a
        # received message) the record joins the boundary's single fsync
        self._journal.append(
            REC_META, encode_meta(name, blob), auto_sync=self._ack_depth == 0
        )
        self._tl_scope.appended = True

    def sync(self) -> None:
        """Force-fsync the journal regardless of policy."""
        self._journal.sync()

    def close(self) -> None:
        if self._closed:
            return
        # retire the background compactor first: a compaction racing the
        # final commit/close would truncate a journal close() is flushing
        if self._compact_thread is not None:
            self._compact_stop = True
            self._compact_wake.set()
            self._compact_thread.join(timeout=30)
            self._compact_thread = None
        # an AutoDoc host may hold a pending autocommit transaction; every
        # other exit surface (save / sync) auto-commits it, so close must
        # too — silently dropping acked-looking edits would betray the
        # whole layer. (A live MANUAL transaction stays the caller's
        # responsibility, as everywhere else.)
        try:
            commit = getattr(self._host, "commit", None)
            # a degraded doc cannot journal the commit anyway — raising
            # out of close() would only block the reopen that repairs it
            if callable(commit) and not self.degraded:
                commit()  # journals through the listener; close syncs below
        finally:
            # even if that last commit fails, the journal handle (and its
            # flock) must be released or the document is wedged for the
            # life of the process
            self._closed = True
            try:
                self._core.change_listeners.remove(self._on_change)
            except ValueError:
                pass
            self._journal.close()
            # per-doc gauge hygiene: a closed document's label sets must
            # not occupy the registry's cardinality cap forever (at
            # store scale that would collapse every later document's
            # admission signal into {overflow=true})
            obs.remove_doc_gauges(self.obs_name)

    # -- compaction ----------------------------------------------------------

    def maybe_compact(self) -> bool:
        """Compact iff the journal crossed a threshold (and, when a cost
        ratio is set, the journal is worth the snapshot's cost). Called
        after every ack-point method; cheap when below threshold. In
        background mode the actual compaction runs on a daemon thread
        under this document's lock, so it never stalls the ack path."""
        j = self._journal
        if j.closed:
            # a poisoned journal never auto-compacts: recovery from a
            # disk fault is an EXPLICIT compact()/reopen (the fault may
            # still be live — ENOSPC does not clear itself)
            return False
        if (
            j.record_count <= self.compact_max_records
            and j.size_bytes <= self.compact_max_bytes
        ):
            return False
        if (
            self.compact_cost_ratio > 0.0
            and j.size_bytes < self.compact_cost_ratio * self._last_snapshot_bytes
        ):
            obs.count("compact.deferred_by_cost")
            return False
        if brownout_active():
            # brownout: background compaction is exactly the churn a
            # degraded node defers — the journal keeps growing (bounded
            # by disk, not RSS) and compacts once pressure lifts
            obs.count("compact.deferred_brownout")
            return False
        if self._background:
            self._schedule_compact()
            return False
        return self.compact()

    def _schedule_compact(self) -> None:
        if self._compact_thread is None:
            self._compact_thread = threading.Thread(
                target=self._compact_loop,
                name=f"compact:{self.path}",
                daemon=True,
            )
            self._compact_thread.start()
        self._compact_wake.set()

    def _compact_loop(self) -> None:
        while True:
            self._compact_wake.wait()
            self._compact_wake.clear()
            if self._compact_stop:
                return
            try:
                # timed acquire, re-checking the stop flag: close() may be
                # invoked by a thread that already HOLDS the doc lock (the
                # serving worker executing a `free`), and its join() would
                # otherwise wait out the full timeout against us blocking
                # on that very lock
                while not self.lock.acquire(timeout=0.05):
                    if self._compact_stop:
                        return
                try:
                    if not self._closed:
                        self.compact()
                finally:
                    self.lock.release()
            except Exception as e:  # noqa: BLE001 — background must not die
                obs.count("compact.background_error", error=str(e)[:200])

    def _image_log(self, hist):
        """An OpLog covering ``hist`` rebuilt from the retained run image
        (decode + tail append — zero re-encode of covered changes), or
        None when no image applies."""
        img = self._run_image
        if img is None or img.n_changes > len(hist):
            return None
        try:
            hset = set(img.change_hashes())
            idx = self._core.history_index
            if len(hset) != img.n_changes or not all(h in idx for h in hset):
                return None
            log = img.to_oplog()
            tail = [c for c in hist if c.hash not in hset]
            if len(tail) != len(hist) - img.n_changes:
                return None
            if tail and log.append_changes(tail) is None:
                return None
            return log
        except _IMAGE_FAULTS:
            return None

    def _snapshot_log(self):
        """An OpLog of exactly the committed history, preferring sources
        that already hold the run-coded columns: the resident device
        mirror, then the retained snapshot image plus a journal-tail
        append (the incremental merge — only the fresh changes are
        extracted and spliced), and only as a last resort a full
        ``from_changes`` rebuild (counted: ``compact.image_rebuild``)."""
        hist = [a.stored for a in self._core.history]
        dev = self.device_doc
        if dev is not None:
            try:
                idx = self._core.history_index
                if len(dev.log.changes) == len(hist) and all(
                    c.hash in idx for c in dev.log.changes
                ):
                    return dev.log
            except AttributeError:
                pass  # a stand-in mirror without an op log
        log = self._image_log(hist)
        if log is not None:
            return log
        from ..ops.oplog import OpLog

        obs.count("compact.image_rebuild")
        return OpLog.from_changes(hist)

    def _build_snapshot(self):
        """The snapshot file bytes for the current committed history:
        ``(data, image)`` where ``image`` is the parsed run-coded image
        (retained for future hydrations), or ``(legacy bytes, None)``
        when run-coded persistence is disabled or inapplicable."""
        from . import runsnap

        if runsnap.enabled():
            try:
                log = self._snapshot_log()
                data = runsnap.encode_snapshot(log, self._core.get_heads())
                return data, runsnap.parse(data)
            except runsnap.RunSnapError:
                obs.count("compact.runsnap_fallback")
        return self._core.save(), None

    def snapshot_bytes(self) -> bytes:
        """The full-history snapshot in the on-disk codec — the same
        bytes ``compact()`` would write, shipped verbatim by replication
        catch-up (``replSnapshot``/``replReset``) and cold migration so
        the receiver hydrates without a re-encode on either end."""
        with self.lock:
            data, image = self._build_snapshot()
            if image is not None:
                self._run_image = image
            return data

    def compact(self) -> bool:
        """Snapshot-then-truncate: write the full save to a temp file,
        fsync it, atomically rename over the snapshot, fsync the
        directory entry, then truncate the journal (metadata records are
        re-appended so they survive). Every step durable before the next
        — the orderings the crash suite proves are exactly these.

        The snapshot is the run-coded image (storage/runsnap.py) unless
        ``AUTOMERGE_TPU_RUNSNAP=0``; successive compactions merge only
        the journal tail into the retained image (incremental, column-
        by-column) instead of re-extracting the whole history, and the
        ``maybe_compact`` cost gate (``compact_cost_ratio``) bounds
        write amplification: ``compact.bytes_written`` vs
        ``compact.tail_bytes_retired`` is the model's measured ratio."""
        with self.lock:
            if (
                self._compacting
                or self._closed
                or (self._journal.closed and not self._journal.poisoned)
            ):
                return False
            live = self._core._live_transaction()
            if live is not None and live.pending_ops():
                return False  # mid-manual-transaction: defer to the next ack
            self._compacting = True
            try:
                with obs.span("compact.total"):
                    # snapshot the CORE: the journal holds exactly the
                    # committed history, so that is what the snapshot
                    # must cover — and a background compaction must not
                    # side-effect-commit a half-built autocommit tx out
                    # from under a mutating thread (host.save() would)
                    tail_bytes = self._journal.size_bytes
                    data, image = self._build_snapshot()
                    snap = posixpath.join(self.path, SNAPSHOT_NAME)
                    tmp = snap + ".tmp"
                    with obs.span("compact.snapshot", bytes=len(data)):
                        f = self._fs.open(tmp, "wb")
                        try:
                            f.write(data)
                            self._fs.fsync(f)
                        finally:
                            f.close()
                        self._fs.replace(tmp, snap)
                        self._fs.sync_dir(self.path)
                    with obs.span("compact.truncate"):
                        if self._journal.poisoned:
                            # the snapshot above covers the FULL history,
                            # so the unknowable on-disk journal tail can
                            # be discarded: re-acquire the file + flock
                            # as an empty journal (hooks survive)
                            self._journal.revive()
                        else:
                            self._journal.truncate()
                        for name, blob in self._meta.items():
                            self._journal.append(
                                REC_META, encode_meta(name, blob),
                                auto_sync=False,
                            )
                        self._journal.sync()
                obs.count("compact.runs")
                # write-amplification accounting: bytes rewritten vs the
                # journal tail this compaction retired — the cost model's
                # two sides, summable across a run
                obs.count("compact.bytes_written", n=len(data))
                obs.count("compact.tail_bytes_retired", n=tail_bytes)
                if image is not None:
                    self._run_image = image
                self._last_snapshot_bytes = len(data)
                # the snapshot carries the FULL in-memory history, so disk
                # is caught up even if a journal append had failed earlier
                self._broken = False
                # a background compaction shrinks the journal outside any
                # ack scope: refresh the footprint gauge here too
                obs.gauge_set("doc.journal_bytes", self._journal.size_bytes,
                              labels={"doc": self.obs_name})
                return True
            finally:
                self._compacting = False

    # -- replication (cluster/replication.py rides these) --------------------

    @property
    def replication_cursor(self) -> Optional[bytes]:
        """The persisted follower cursor blob (None when this document
        has never followed a leader, or was promoted and compacted)."""
        return self._meta.get(REPL_CURSOR_KEY)

    def acked_prefix(self) -> tuple:
        """(acked, appended) journal seqs: every append <= acked is
        durable on this node's disk — the prefix replication ships and
        promotion compares."""
        j = self._journal
        return j.acked_seq, j.append_seq

    def apply_replicated(self, records, cursor: Optional[bytes],
                         *, device_feed=None) -> int:
        """Apply a batch of shipped journal records through the normal
        listener path: changes enter history (journaled locally before
        ack, deduplicated by hash exactly like a re-delivered sync
        frame), replicated meta overwrites latest-wins (so a peer's
        ``sync/<peer>`` shared_heads survive failover), and the cursor
        meta joins the SAME ack scope — one fsync covers the whole batch
        and the cursor is durable iff the records are.

        ``device_feed(doc, dev, changes)``: when given and a resident
        device mirror exists, the applied changes are handed to it AFTER
        the durable apply — the cluster node's batched follower drain
        collects every drained document's feed into one vectorized
        cross-doc staging pass (ops/host_batch.py) so the mirror keeps
        up at super-batch speed. Without the hook the mirror is left
        alone (the pre-existing serial behavior)."""
        from .change import parse_change

        changes = []
        metas = []
        for rec_type, payload in records:
            if rec_type == REC_CHANGE:
                try:
                    change, _ = parse_change(payload)
                except Exception:
                    # CRC-framed but unparseable — mirror recovery: count
                    # and keep the stream moving (the leader journaled it,
                    # so a reject here is a codec bug, not data loss)
                    obs.count("journal.rejected_records")
                    continue
                changes.append(change)
            elif rec_type == REC_META:
                name, blob = decode_meta(payload)
                if name.startswith(REPL_META_PREFIX):
                    continue  # never adopt another node's own cursor
                metas.append((name, blob))
        with self.lock, self.ack_scope():
            if changes:
                # through the wrapper: the change listener journals each
                # applied change, duplicates drop on the history index
                self.apply_changes(changes)
            for name, blob in metas:
                self.set_meta(name, blob)
            if cursor is not None:
                self.set_meta(REPL_CURSOR_KEY, cursor)
        if changes and device_feed is not None:
            dev = self.device_doc
            if dev is not None:
                device_feed(self, dev, changes)
        return len(changes)

    def apply_replicated_snapshot(self, data: bytes,
                                  cursor: Optional[bytes]) -> None:
        """Catch-up path for a new or lagging follower: load a full
        leader snapshot (known changes deduplicate on the history index,
        so re-snapshotting after failover converges instead of erroring)
        and persist the new cursor under the same ack scope.

        A run-coded (ARSN) snapshot applies through its verbatim change
        chunks — the same bytes the leader's disk holds — and, when this
        follower was empty, the decoded image is adopted so the follower's
        own hydrations and compactions start run-coded too. Corruption
        raises (``on_partial="error"`` semantics: a shipped snapshot is
        never silently partial)."""
        from . import runsnap

        with self.lock, self.ack_scope():
            if runsnap.is_runsnap(data):
                image = runsnap.parse(data)  # RunSnapError on corruption
                was_empty = not self._core.history
                self.apply_changes(image.changes)
                obs.count("store.hydrate_bytes", n=len(data),
                          labels={"codec": "runsnap"})
                if was_empty and len(self._core.history) == image.n_changes:
                    self._run_image = image
            else:
                obs.count("store.hydrate_bytes", n=len(data),
                          labels={"codec": "chunk"})
                self.load_incremental(data, on_partial="error")
            if cursor is not None:
                self.set_meta(REPL_CURSOR_KEY, cursor)

    # -- sync-session persistence (shared_heads survive restarts) ------------

    @staticmethod
    def _sync_key(peer: str) -> str:
        return _SYNC_META_PREFIX + peer

    def attach_sync_session(self, peer: str, session):
        """Persist ``session``'s shared_heads (plus its epoch) under
        ``peer`` whenever they change; returns the session."""
        key = self._sync_key(peer)

        def _persist(encoded: bytes, _sess=session) -> None:
            body = bytearray()
            encode_uleb(_sess.epoch, body)
            body += encoded
            self.set_meta(key, bytes(body))

        session.persist = _persist
        return session

    def restore_sync_session(self, peer: str, *, config=None):
        """Rebuild the sync session for ``peer`` after a restart: the
        persisted shared_heads seed the state and the epoch is bumped so
        the surviving peer runs the epoch/reset handshake instead of a
        full resync. A peer never seen before gets a fresh session."""
        from ..sync.session import SyncSession

        blob = self._meta.get(self._sync_key(peer))
        # the session drives the WRAPPER (self): receives and commits hit
        # the ack path, so batches fsync once and compaction keeps
        # happening mid-sync
        if blob is None:
            sess = SyncSession(self, epoch=1, config=config,
                               device_doc=self.device_doc)
        else:
            epoch, pos = decode_uleb(blob, 0)
            sess = SyncSession.restore(
                self, bytes(blob[pos:]), epoch=epoch + 1, config=config
            )
            sess.device_doc = self.device_doc
        self.attach_sync_session(peer, sess)
        # persist the bumped epoch NOW: a second crash-restart with no
        # sync progress in between must still present a fresh epoch, or
        # the survivor's dup suppression eats the new incarnation's frames
        sess._maybe_persist()
        return sess
