"""Append-only write-ahead journal of change chunks.

The durable write path (storage/durable.py) routes every change through
this journal before acking; recovery replays it on top of the latest
snapshot. The format is deliberately dumb — a fixed header followed by a
flat sequence of CRC-framed records — because torn-write recovery must
be decidable by a forward scan alone:

    header  := b"AMJ1"
    record  := checksum (4 bytes) | rec_type (1 byte) | ULEB(len) | payload

The checksum is the first 4 bytes of ``chunk_hash(rec_type, payload)`` —
the exact machinery that frames automerge chunks (storage/chunk.py), so a
journal record and a chunk verify identically. Unlike a document save the
journal never resynchronises past damage: it is append-only, so the first
record that fails to verify IS the torn tail — everything before it is
intact, everything after it is dropped and the file is truncated back to
the valid prefix (``obs.count("journal.truncated_tail")`` reports the
bytes lost).

Record types:

* ``REC_CHANGE`` (1): payload is a raw change chunk (magic + checksum +
  type + data), exactly the bytes sync puts on the wire.
* ``REC_META`` (3): payload is ``ULEB(len(name)) | name | blob`` — small
  latest-wins key/value state that must ride with the journal (e.g. a
  sync peer's persisted ``shared_heads``).

Durability is governed by the fsync policy:

* ``"always"``  — fsync after every append (an acked record is durable)
* ``"interval"``— fsync every ``fsync_interval`` appends (bounded loss)
* ``"never"``   — no automatic fsync (crash loses the OS write-back
  window; the journal is still torn-tail-consistent)

The journal is thread-safe: appends serialize under an internal lock and
``sync()`` is a leader-elected fsync **combiner** (group commit).
Concurrent callers that arrive while an fsync is in flight wait for the
NEXT one; exactly one leader issues it and every record appended before
the leader sampled the sequence counter is covered — so N threads
committing concurrently pay far fewer than N fsyncs. Each physical fsync
records how many appends it covered in the ``group_commit.batch_size``
histogram, and a caller whose records were made durable by another
thread's fsync counts ``journal.fsync_combined``.

All file operations go through an injectable filesystem object (``fs``)
so the crash-injection harness (storage/crashsim.py) can simulate
kill-at-every-write-boundary, torn writes, and rename reordering; the
default ``OS_FS`` is the real OS.
"""

from __future__ import annotations

import os
import threading
from typing import List, NamedTuple, Optional, Tuple

from .. import obs
from ..utils.leb128 import LEBDecodeError, decode_uleb, encode_uleb
from .chunk import chunk_hash

JOURNAL_MAGIC = b"AMJ1"

REC_CHANGE = 1
REC_META = 3

_REC_TYPES = frozenset({REC_CHANGE, REC_META})

FSYNC_POLICIES = ("always", "interval", "never")


class JournalError(Exception):
    pass


class JournalPoisoned(JournalError):
    """The journal closed itself after an unrecoverable I/O fault (a
    failed fsync, or a failed append whose cleanup also failed): nothing
    more will be acked through it until the document is compacted or
    reopened. Marked retriable — in a cluster the covering document
    answers requests with this error while a failover, reopen, or
    compaction restores service, so clients should back off and retry
    rather than treat the write as permanently rejected."""

    retriable = True


class OsFS:
    """The real filesystem, behind the narrow interface the durable layer
    uses (so storage/crashsim.py can substitute a fault-injecting one)."""

    def open(self, path: str, mode: str):
        return open(path, mode)

    def fsync(self, f) -> None:
        f.flush()
        os.fsync(f.fileno())

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def sync_dir(self, path: str) -> None:
        """Make preceding renames in ``path`` durable (POSIX dir fsync;
        best-effort where the platform cannot)."""
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def getsize(self, path: str) -> int:
        return os.path.getsize(path)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def remove(self, path: str) -> None:
        os.remove(path)

    def lock(self, f) -> None:
        """Advisory exclusive lock on an open file, released automatically
        when the process dies (never a stale-lockfile hazard). Raises
        ``JournalError`` when another live process holds it."""
        try:
            import fcntl
        except ImportError:  # non-POSIX: no cross-process guard
            return
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            raise JournalError(
                f"journal is locked by another process: {e}"
            ) from e


OS_FS = OsFS()


class JournalRecord(NamedTuple):
    rec_type: int
    payload: bytes
    offset: int  # byte position of the record header in the file
    end: int  # byte position just past the payload


class TailReport(NamedTuple):
    """What a scan found past the valid prefix."""

    valid_bytes: int  # file is intact up to here
    total_bytes: int  # physical file size at scan time
    records: int  # records in the valid prefix
    reason: str  # "" when the file ends exactly on a record boundary

    @property
    def torn(self) -> bool:
        return self.valid_bytes < self.total_bytes

    @property
    def dropped_bytes(self) -> int:
        return self.total_bytes - self.valid_bytes


def encode_record(rec_type: int, payload: bytes) -> bytes:
    out = bytearray(chunk_hash(rec_type, payload)[:4])
    out.append(rec_type)
    encode_uleb(len(payload), out)
    out += payload
    return bytes(out)


def encode_meta(name: str, blob: bytes) -> bytes:
    nb = name.encode("utf-8")
    out = bytearray()
    encode_uleb(len(nb), out)
    out += nb
    out += blob
    return bytes(out)


def decode_meta(payload: bytes) -> Tuple[str, bytes]:
    n, pos = decode_uleb(payload, 0)
    if pos + n > len(payload):
        raise JournalError("meta record name runs past payload end")
    return payload[pos : pos + n].decode("utf-8"), bytes(payload[pos + n :])


def scan_records(data: bytes) -> Tuple[List[JournalRecord], TailReport]:
    """Forward scan: every verifiable record plus where the tail tore.

    Read-only — callers that own the file decide whether to truncate
    (``Journal.open`` does; ``journal-info`` reports without modifying).
    """
    n = len(data)
    if n < len(JOURNAL_MAGIC):
        # includes the 0-byte file a crashed create leaves behind: the
        # caller re-initialises it with a fresh header
        return [], TailReport(0, n, 0, "missing journal header")
    if data[: len(JOURNAL_MAGIC)] != JOURNAL_MAGIC:
        return [], TailReport(0, n, 0, "bad journal magic")
    records: List[JournalRecord] = []
    pos = len(JOURNAL_MAGIC)
    reason = ""
    while pos < n:
        # checksum(4) + type(1) before the length field
        if pos + 5 > n:
            reason = "truncated record header"
            break
        checksum = bytes(data[pos : pos + 4])
        rec_type = data[pos + 4]
        if rec_type not in _REC_TYPES:
            reason = f"unknown record type {rec_type}"
            break
        try:
            length, body = decode_uleb(data, pos + 5)
        except LEBDecodeError:
            reason = "truncated record length"
            break
        end = body + length
        if end > n:
            reason = "record payload extends past end of file"
            break
        payload = bytes(data[body:end])
        if chunk_hash(rec_type, payload)[:4] != checksum:
            reason = "record checksum mismatch"
            break
        records.append(JournalRecord(rec_type, payload, pos, end))
        pos = end
    # a clean scan consumes the whole file, so valid == n there; after a
    # break the valid prefix ends at the last verified record
    valid = records[-1].end if records else len(JOURNAL_MAGIC)
    if not reason:
        valid = n
    return records, TailReport(valid, n, len(records), reason)


def scan_record_seq(data: bytes) -> List[JournalRecord]:
    """Parse a bare record sequence (no journal header) — the exact bytes
    the replication layer puts on the wire (cluster/replication.py ships
    journal records verbatim, so a replicated batch and a journal file
    verify through the same scan). Unlike ``scan_records`` a torn or
    corrupt record here is an error: TCP delivered these bytes intact, so
    damage means a framing bug, not a crash mid-write."""
    records, tail = scan_records(JOURNAL_MAGIC + data)
    if tail.torn:
        raise JournalError(
            f"replicated record batch damaged at byte "
            f"{tail.valid_bytes - len(JOURNAL_MAGIC)}: {tail.reason}"
        )
    return records


def salvage_header_scan(data: bytes) -> List[JournalRecord]:
    """Records recoverable from a file whose 4-byte header is damaged:
    they are individually CRC-framed, so they re-verify under a synthetic
    good header. The single source of truth for what ``Journal.open``'s
    header salvage (and ``journal-info``'s report of it) will keep."""
    if len(data) <= len(JOURNAL_MAGIC):
        return []
    records, _ = scan_records(JOURNAL_MAGIC + bytes(data[len(JOURNAL_MAGIC):]))
    return records


class Journal:
    """One open journal file: appends with a configurable fsync policy.

    Construct via ``Journal.open`` — it scans the existing file, truncates
    any torn tail back to the last verifiable record, and returns the
    surviving records for replay.
    """

    def __init__(self, path: str, f, *, fs, fsync: str, fsync_interval: int,
                 size: int, count: int):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"unknown fsync policy {fsync!r}")
        self.path = path
        self.fs = fs
        self.fsync_policy = fsync
        self.fsync_interval = max(1, int(fsync_interval))
        self._f = f
        self._size = size
        self._count = count
        # chaos-soak invariant as a scrapeable level: one open journal ==
        # one held flock; close() (and the append-poison path) decrement,
        # so a nonzero residue after shutdown means a stranded lock
        obs.registry.gauge("serve.flocks_held").add(1)
        # group-commit state: appends bump _append_seq; _synced_seq is the
        # durable prefix. Both only move under _cond's lock, which also
        # serializes the file writes themselves (interleaved buffered
        # writes from two threads would corrupt the record framing).
        self._cond = threading.Condition()
        self._append_seq = 0
        self._synced_seq = 0
        self._fsync_leader = False
        # replication hooks (cluster/replication.py): on_record fires for
        # every successful append (under the journal lock, so callbacks
        # observe appends in exact file order), on_synced after each fsync
        # with the covering append seq (the records now durable locally).
        # A failing hook is counted, never raised — replication is a
        # sidecar of the local durability path, and a follower that
        # misses a record recovers through the cursor-mismatch snapshot
        # catch-up.
        self.on_record = None  # callable(rec_type, payload, append_seq)
        self.on_synced = None  # callable(covering_append_seq)
        # trace contexts of appends not yet covered by an fsync (bounded):
        # the group-commit leader attaches them as span links, so one
        # combined fsync is attributable to every request it covered
        self._pending_traces: List[tuple] = []
        # non-None once an I/O fault closed the journal for good; names
        # the faulting operation (journal.poisoned{reason})
        self.poisoned_reason: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def open(
        cls,
        path: str,
        *,
        fs=None,
        fsync: str = "always",
        fsync_interval: int = 16,
    ) -> Tuple["Journal", List[JournalRecord], TailReport]:
        """Open (creating if absent), recover, and position for appends.

        Returns ``(journal, records, tail_report)``; when the tail was
        torn the file has already been truncated back to the valid prefix
        and ``obs.count("journal.truncated_tail")`` records the bytes
        dropped.
        """
        fs = fs or OS_FS
        # open append-mode: creates the file if absent but NEVER truncates
        # — a losing opener in a create race must not destroy the winner's
        # live journal before its own lock attempt fails. The lock comes
        # before any read or write; O_APPEND keeps every write at the
        # physical end, which is exactly the journal discipline anyway.
        f = fs.open(path, "ab")
        try:
            fs.lock(f)
        except Exception:
            f.close()
            raise
        data = fs.read_bytes(path)
        records, tail = scan_records(data)
        if tail.reason in ("missing journal header", "bad journal magic"):
            # brand new file, a fresh create that crashed mid-header, or a
            # header hit by localized damage. The records BEYOND a corrupt
            # header are still individually CRC-framed
            # (salvage_header_scan); rebuild ATOMICALLY — write the rescued
            # content to a temp file, fsync, rename over the journal — so a
            # crash mid-salvage leaves either the old damaged file (salvage
            # reruns) or the complete new one, never an empty husk.
            salvaged = (
                salvage_header_scan(data)
                if tail.reason == "bad journal magic"
                else []
            )
            kept = sum(r.end - r.offset for r in salvaged)
            dropped = len(data) - kept
            if dropped:
                obs.count("journal.truncated_tail", n=dropped)
            tmp = path + ".tmp"
            nf = fs.open(tmp, "wb")
            try:
                fs.lock(nf)
                nf.write(JOURNAL_MAGIC)
                for r in salvaged:
                    nf.write(encode_record(r.rec_type, r.payload))
                fs.fsync(nf)
                fs.replace(tmp, path)
                # the file's DIRECTORY ENTRY must be durable too, or a
                # crash loses the whole journal regardless of record fsyncs
                fs.sync_dir(os.path.dirname(path) or ".")
            except Exception:
                nf.close()
                raise
            # nf IS the inode now at `path` (and holds its lock); the old
            # handle's inode is unlinked, so its lock guards nothing
            f.close()
            size = len(JOURNAL_MAGIC) + kept
            if not len(data):
                tail = TailReport(size, size, len(salvaged), "")
            return (
                cls(path, nf, fs=fs, fsync=fsync, fsync_interval=fsync_interval,
                    size=size, count=len(salvaged)),
                salvaged,
                tail,
            )
        if tail.torn:
            obs.count("journal.truncated_tail", n=tail.dropped_bytes)
            f.truncate(tail.valid_bytes)
            fs.fsync(f)
        return (
            cls(path, f, fs=fs, fsync=fsync, fsync_interval=fsync_interval,
                size=tail.valid_bytes, count=len(records)),
            records,
            tail,
        )

    @property
    def closed(self) -> bool:
        """True once closed (explicitly, or poisoned by an fsync failure
        or a double fault in ``append``): every further append/sync
        raises."""
        return self._f is None

    @property
    def poisoned(self) -> bool:
        """True when an unrecoverable I/O fault closed the journal (as
        opposed to an orderly ``close()``)."""
        return self.poisoned_reason is not None

    def _poison_locked(self, reason: str) -> None:
        """Close the journal for good after an unrecoverable I/O fault
        (``_cond`` held). Every waiter parked in the fsync combiner wakes
        and raises; nothing is ever acked through this journal again —
        the only recovery is compaction (fresh snapshot) or a reopen."""
        if self._f is None:
            return
        try:
            self._f.close()
        except Exception:  # noqa: BLE001 — the fd is lost either way
            pass
        self._f = None
        self.poisoned_reason = reason
        obs.registry.gauge("serve.flocks_held").add(-1)
        obs.count("journal.poisoned", labels={"reason": reason})
        obs.event("journal.poisoned", path=self.path, reason=reason)
        self._cond.notify_all()

    def _closed_error(self) -> JournalError:
        if self.poisoned_reason is not None:
            return JournalPoisoned(
                f"journal poisoned by a failed {self.poisoned_reason}; "
                "compact or reopen the document to recover"
            )
        return JournalError("journal is closed")

    def close(self) -> None:
        if self._f is None:
            return
        try:
            if self._unsynced:
                self.sync()
        finally:
            with self._cond:
                if self._f is not None:
                    self._f.close()
                    self._f = None
                    obs.registry.gauge("serve.flocks_held").add(-1)
                    self._cond.notify_all()

    @property
    def _unsynced(self) -> int:
        """Appends not yet covered by an fsync."""
        return self._append_seq - self._synced_seq

    @property
    def append_seq(self) -> int:
        """Monotone per-open append counter (does not reset on truncate)."""
        return self._append_seq

    @property
    def acked_seq(self) -> int:
        """The durable acked prefix: every append with seq <= this has
        been covered by an fsync (the replication layer ships exactly
        this prefix, and promotion compares followers by it)."""
        return self._synced_seq

    # -- appends -------------------------------------------------------------

    @property
    def record_count(self) -> int:
        return self._count

    @property
    def size_bytes(self) -> int:
        return self._size

    def append(self, rec_type: int, payload: bytes,
               auto_sync: bool = True) -> None:
        """Append one record; durable on return iff the policy says so.

        ``auto_sync=False`` defers the policy fsync — the caller promises
        to invoke ``policy_sync()`` before acking (the durable layer uses
        this to pay ONE fsync per public call instead of one per change
        in a merge/sync batch)."""
        rec = encode_record(rec_type, payload)
        with obs.span("journal.append", bytes=len(rec)):
            with self._cond:
                if self._f is None:
                    raise self._closed_error()
                try:
                    self._f.write(rec)
                except Exception:
                    # a partial write (ENOSPC/EIO mid-record) would leave
                    # torn bytes MID-file: later successful appends would
                    # land after the tear and be dropped at recovery. Cut
                    # back to the last known-good size; if even that
                    # fails, poison the journal.
                    try:
                        self._f.truncate(self._size)
                    except Exception:
                        self._poison_locked("append")
                    raise
                self._size += len(rec)
                self._count += 1
                self._append_seq += 1
                ctx = obs.current_trace_context()
                if ctx is not None and len(self._pending_traces) < 16:
                    self._pending_traces.append(ctx)
                if self.on_record is not None:
                    try:
                        self.on_record(rec_type, payload, self._append_seq)
                    except Exception as e:  # noqa: BLE001 — sidecar only
                        obs.count("journal.hook_error", error=str(e)[:200])
        if auto_sync:
            self.policy_sync()

    def policy_sync(self) -> None:
        """Apply the fsync policy to whatever is pending: "always" syncs,
        "interval" syncs when the pending count crosses the interval,
        "never" does nothing."""
        if self._unsynced and (
            self.fsync_policy == "always"
            or (
                self.fsync_policy == "interval"
                and self._unsynced >= self.fsync_interval
            )
        ):
            self.sync()

    def append_change(self, raw_chunk: bytes) -> None:
        self.append(REC_CHANGE, raw_chunk)

    def append_meta(self, name: str, blob: bytes) -> None:
        self.append(REC_META, encode_meta(name, blob))

    def sync(self) -> None:
        """Force everything appended so far onto stable storage.

        This is the group-commit combiner: the caller's records are
        durable on return, but not necessarily via its own fsync. If an
        fsync is already in flight the caller waits for it; when that
        fsync (issued before our appends) does not cover us, exactly one
        waiter becomes the next leader and its single fsync covers every
        append made in the meantime — N concurrent committers collapse
        into ~2 physical fsyncs instead of N."""
        with self._cond:
            if self._f is None:
                raise self._closed_error()
            target = self._append_seq
            if self._synced_seq >= target:
                return
            while self._fsync_leader:
                self._cond.wait()
                if self._synced_seq >= target:
                    # another thread's fsync covered our records
                    obs.count("journal.fsync_combined")
                    return
                if self._f is None:
                    raise self._closed_error()
            self._fsync_leader = True
            covering = self._append_seq
            f = self._f
            links, self._pending_traces = self._pending_traces, []
        try:
            with obs.span("journal.fsync", links=links,
                          labels={"policy": self.fsync_policy}):
                self.fs.fsync(f)
        except Exception:
            # a failed fsync POISONS the journal — no retry. After EIO the
            # kernel may have dropped the dirty pages, so a later fsync
            # can "succeed" while the records it claims to cover were
            # never written (the classic fsync-gate). Closing the file
            # here converts every combined-fsync waiter parked above into
            # an error too: an un-fsynced ack is no ack, for every caller
            # this fsync covered. Recovery is compact() (fresh snapshot
            # re-establishes disk >= memory) or a reopen.
            with self._cond:
                self._fsync_leader = False
                self._poison_locked("fsync")
            raise
        with self._cond:
            batch = covering - self._synced_seq
            self._synced_seq = covering
            self._fsync_leader = False
            self._cond.notify_all()
        obs.observe("group_commit.batch_size", batch)
        if self.on_synced is not None:
            try:
                self.on_synced(covering)
            except Exception as e:  # noqa: BLE001 — sidecar only
                obs.count("journal.hook_error", error=str(e)[:200])

    def truncate(self) -> None:
        """Reset to an empty journal (post-compaction): the truncation is
        fsynced before return so stale records cannot resurrect."""
        with self._cond:
            if self._f is None:
                raise self._closed_error()
            # wait out any in-flight fsync: its covering seq refers to
            # the pre-truncation file
            while self._fsync_leader:
                self._cond.wait()
                if self._f is None:
                    raise self._closed_error()
            self._f.truncate(len(JOURNAL_MAGIC))
            self._f.seek(len(JOURNAL_MAGIC))
            with obs.span("journal.fsync",
                          labels={"policy": self.fsync_policy}):
                self.fs.fsync(self._f)
            self._synced_seq = self._append_seq
            self._size = len(JOURNAL_MAGIC)
            self._count = 0

    def revive(self) -> None:
        """Re-open a POISONED journal in place as an empty journal.

        Only the compaction path may call this, and only after a snapshot
        covering the full in-memory history is durable on disk — the
        on-disk journal's contents past the poison point are unknowable
        (the failed fsync may or may not have persisted them), so they
        are discarded wholesale and the snapshot becomes the only truth.
        The Journal object (and the replication hooks installed on it)
        survives; the file handle and flock are re-acquired. Counters:
        the durable acked prefix jumps to cover every append — the
        snapshot now holds them all."""
        with self._cond:
            if self._f is not None:
                return  # live journal: nothing to revive
            if self.poisoned_reason is None:
                raise JournalError("cannot revive an orderly-closed journal")
            # append-mode first (never truncates a file another process
            # may own), lock, THEN cut back to a bare header
            f = self.fs.open(self.path, "ab")
            try:
                self.fs.lock(f)
                f.truncate(len(JOURNAL_MAGIC))
                self.fs.fsync(f)
            except Exception:
                f.close()
                raise
            self._f = f
            self.poisoned_reason = None
            self._size = len(JOURNAL_MAGIC)
            self._count = 0
            self._synced_seq = self._append_seq
            self._fsync_leader = False
            obs.registry.gauge("serve.flocks_held").add(1)
            obs.count("journal.revived")
            self._cond.notify_all()
