"""Journal-shipping replication: leader streams acked journal records.

The change journal is already a checksummed, truncation-safe,
torn-tail-recoverable change log — this module treats it as what it is:
a replication stream. The leader's ``ReplicationHub`` hooks every
durable document's journal (``on_record`` / ``on_synced``) and ships the
locally-durable record prefix to followers **verbatim** — the bytes on
the wire are ``journal.encode_record`` output, parsed on the far side by
the same CRC scan that recovers a journal file (``scan_record_seq``).
There is no second serialization format.

Topology and flow (leader dials follower, both speak the RPC line
framing of serve/server.py):

* every attached document gets a per-hub **LSN** sequence (one per
  appended record) and a bounded in-memory retention buffer of already
  synced records;
* a ``_FollowerLink`` per follower ships, over one pooled connection,
  ``replApply`` requests carrying contiguous record batches (prev/lsn
  cursor arithmetic, so a gap is detected by the follower, answered with
  ``ReplCursorMismatch``, and repaired by a snapshot);
* a new or lagging follower (cursor from another leader incarnation, or
  behind the retention buffer) catches up exactly the way compaction
  recovers: a full **snapshot** (``core.save()``) pinned to an LSN, then
  the journal tail from there;
* the follower applies through the durable listener path
  (``DurableDocument.apply_replicated``), so every replicated change is
  journaled on the follower's own disk before the ack returns, and the
  **replication cursor** rides the same fsync as journal meta;
* ``replPing`` heartbeats flow on idle links so followers can observe
  leader liveness, and the router's failover monitor uses
  ``clusterStatus`` cursors to promote from the longest durable acked
  prefix.

Durability gate: with ``ack_replicas >= 1`` the hub installs a
``replication_gate`` on each attached document — the outermost
``ack_scope`` exit (the moment a batch would ack to clients) blocks
until at least that many followers have *durably* applied the covering
LSN. A client-visible ack therefore implies the write is on
``1 + ack_replicas`` disks, which is what makes kill -9 of the leader
lose zero acked writes.

Observability: ``cluster.replication_lag{follower,doc}`` gauges,
``cluster.records_shipped`` / ``cluster.snapshots_shipped`` counters,
``cluster.follower_up{follower}`` gauges, ``cluster.ship_batch`` span.

The port of ``automerge_tpu/cluster/replication.py``, unchanged: both
packages ship and accept the same ``replApply`` / ``replSnapshot``
frames and cursors, so a node of either package follows a leader of the
other.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional, Tuple

from .. import obs
from ..storage.journal import encode_record, scan_record_seq
from ..utils.leb128 import decode_uleb, encode_uleb


class ReplicationError(Exception):
    pass


class ReplicationTimeout(ReplicationError):
    """The ack gate could not confirm enough follower copies in time —
    the covering batch must surface as errors, never as acks. Retriable:
    the write is journaled locally but unconfirmed; a retry after the
    partition heals (or after failover) deduplicates by change hash."""

    retriable = True


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# -- wire codecs (journal record encoding, verbatim) --------------------------


def encode_batch(records: List[Tuple[int, bytes]]) -> bytes:
    """Concatenated journal records — byte-identical to what the leader's
    journal file holds for the same appends."""
    out = bytearray()
    for rec_type, payload in records:
        out += encode_record(rec_type, payload)
    return bytes(out)


def decode_batch(data: bytes) -> List[Tuple[int, bytes]]:
    """Inverse of ``encode_batch`` via the journal's own CRC scan."""
    return [(r.rec_type, r.payload) for r in scan_record_seq(data)]


def encode_cursor(stream: str, lsn: int) -> bytes:
    """Follower cursor blob: ULEB(lsn) | stream id (utf-8). ``stream``
    names one leader incarnation — a cursor from another stream forces
    snapshot catch-up instead of silently splicing two histories."""
    out = bytearray()
    encode_uleb(lsn, out)
    out += stream.encode("utf-8")
    return bytes(out)


def decode_cursor(blob: bytes) -> Tuple[str, int]:
    lsn, pos = decode_uleb(blob, 0)
    return bytes(blob[pos:]).decode("utf-8"), lsn


# -- leader side --------------------------------------------------------------


class _DocStream:
    """Per-document replication state on the leader."""

    __slots__ = (
        "name", "dd", "lsn", "synced_lsn", "pending", "buffer",
        "buffer_bytes", "base_lsn", "stamps",
    )

    def __init__(self, name: str, dd, stamp_cap: int = 4096):
        self.name = name
        self.dd = dd
        self.lsn = 0  # appended records (this hub incarnation)
        self.synced_lsn = 0  # locally durable prefix — what may ship
        # appended but not yet covered by an fsync: (lsn, append_seq,
        # rec_type, payload)
        self.pending: deque = deque()
        # locally durable, retained for follower tail-shipping:
        # (lsn, rec_type, payload)
        self.buffer: deque = deque()
        self.buffer_bytes = 0
        self.base_lsn = 0  # everything <= this has been trimmed
        # (lsn, leader monotonic append time) — the seconds-based
        # staleness base: a follower behind LSN f is stale by "now minus
        # the append time of the first record it has not applied". The
        # maxlen bound means a VERY deep backlog under-reports (oldest
        # stamp wins), which only ever understates — never invents — lag.
        self.stamps: deque = deque(maxlen=stamp_cap)


class ReplicationHub:
    """Leader-side replication state machine. One per leader node."""

    def __init__(
        self,
        node_id: str,
        *,
        ack_replicas: int = 0,
        heartbeat: Optional[float] = None,
        retain_bytes: int = 16 << 20,
        ack_timeout: Optional[float] = None,
        batch_bytes: int = 4 << 20,
    ):
        self.node_id = node_id
        # one leader INCARNATION: a restarted or newly promoted leader
        # must not be mistaken for the stream a stale cursor names
        self.stream_id = f"{node_id}/{uuid.uuid4().hex[:12]}"
        self.ack_replicas = int(ack_replicas)
        self.heartbeat = (
            heartbeat if heartbeat is not None
            else _env_float("AUTOMERGE_TPU_CLUSTER_HEARTBEAT", 1.0)
        )
        self.ack_timeout = (
            ack_timeout if ack_timeout is not None
            else _env_float("AUTOMERGE_TPU_CLUSTER_ACK_TIMEOUT", 30.0)
        )
        # the bounded tail-retention buffer: a follower whose cursor
        # falls off it catches up via snapshot+tail (the chaos soak
        # shrinks this to force that path constantly)
        self.retain_bytes = int(_env_float(
            "AUTOMERGE_TPU_REPL_RETAIN_BYTES", retain_bytes))
        self.batch_bytes = batch_bytes
        # per-request I/O timeout on follower links: a STALLED follower
        # (black-holed response path) must fail the request and recycle
        # the link rather than freeze the ship loop forever
        self.io_timeout = _env_float("AUTOMERGE_TPU_REPL_IO_TIMEOUT", 10.0)
        # per-doc LSN->append-time stamp ring (staleness accounting)
        self.stamp_cap = max(16, int(_env_float(
            "AUTOMERGE_TPU_REPL_STAMPS", 4096)))
        self._lock = threading.Lock()
        self._acked = threading.Condition(self._lock)
        self._streams: Dict[str, _DocStream] = {}
        self._links: Dict[str, _FollowerLink] = {}
        self._closed = False
        # circuit breaker on the ack gate: repeated ReplicationTimeouts
        # (a partitioned/stalled follower set) trip the gate OPEN —
        # writes ack on leader durability alone (follower-degraded
        # quorum, loudly counted) instead of every ack stalling out the
        # full timeout. After a cooldown one half-open probe waits for
        # real acks again; success re-closes the breaker.
        self.breaker_enabled = (
            os.environ.get("AUTOMERGE_TPU_REPL_BREAKER", "1") != "0")
        self.breaker_threshold = max(1, int(_env_float(
            "AUTOMERGE_TPU_REPL_BREAKER_THRESHOLD", 3)))
        self.breaker_cooldown = _env_float(
            "AUTOMERGE_TPU_REPL_BREAKER_COOLDOWN", 5.0)
        self._breaker_lock = threading.Lock()
        self._breaker_state = "closed"
        self._breaker_failures = 0
        self._breaker_opened_at = 0.0
        self._breaker_gauges()

    # -- document attachment -------------------------------------------------

    def attach(self, name: str, dd) -> None:
        """Start replicating ``dd``'s journal under ``name``. Installs
        the journal hooks and (with ``ack_replicas``) the ack gate.

        Re-attaching the same name with a DIFFERENT document (a
        ``durableReopen`` after a disk fault replaced the wrapper and
        its journal) swaps the stream onto the new incarnation in place:
        the LSN sequence continues (follower cursors stay meaningful —
        everything they hold is still a prefix of what ships next), and
        pending never-fsynced records from the dead journal are dropped
        (they were never acked; the reopened document no longer holds
        them either)."""
        reattached = False
        with self._lock:
            if self._closed:
                return
            st = self._streams.get(name)
            if st is not None:
                if st.dd is dd:
                    return
                old = st.dd
                old.journal.on_record = None
                old.journal.on_synced = None
                old.replication_gate = None
                st.dd = dd
                st.pending.clear()
                reattached = True
                links = list(self._links.values())
            else:
                st = _DocStream(name, dd, stamp_cap=self.stamp_cap)
                self._streams[name] = st
        if reattached:
            # the reopened document's recovered history may contain
            # records the old journal wrote but never confirmed (a
            # poisoned fsync leaves the tail's durability unknowable) —
            # records the LSN bookkeeping can no longer replay from the
            # buffer. One forced snapshot per follower squares every
            # cursor with the recovered state; known changes deduplicate.
            for link in links:
                link.force_snapshot(name)
            obs.count("cluster.catchup_snapshots",
                      labels={"reason": "reattach"})
        j = dd.journal
        j.on_record = lambda rt, pl, seq, _n=name: self._on_record(
            _n, rt, pl, seq)
        j.on_synced = lambda seq, _n=name: self._on_synced(_n, seq)
        if self.ack_replicas > 0:
            dd.replication_gate = lambda _n=name: self.wait_acked(_n)
        with self._lock:
            for link in self._links.values():
                link.note_doc(name)

    def detach(self, name: str) -> None:
        with self._lock:
            st = self._streams.pop(name, None)
        if st is not None:
            st.dd.journal.on_record = None
            st.dd.journal.on_synced = None
            st.dd.replication_gate = None

    def doc_names(self) -> List[str]:
        with self._lock:
            return list(self._streams)

    def lsn(self, name: str) -> int:
        with self._lock:
            st = self._streams.get(name)
            return st.lsn if st is not None else 0

    def doc_lsns(self) -> Dict[str, int]:
        with self._lock:
            return {name: st.lsn for name, st in self._streams.items()}

    # -- seconds-based staleness ---------------------------------------------

    @staticmethod
    def _stamp_after(st: _DocStream, lsn: int) -> Optional[float]:
        """Append time of the first retained record with LSN > ``lsn``
        (the oldest write a follower at ``lsn`` has not applied);
        falls back to the oldest stamp when the ring trimmed past it."""
        for rec_lsn, t in st.stamps:
            if rec_lsn > lsn:
                return t
        return st.stamps[0][1] if st.stamps else None

    def staleness(self, now: Optional[float] = None) -> Dict[str, Dict[str, float]]:
        """Leader-computed ``{follower_addr: {doc: seconds}}``: zero for
        a caught-up follower, else how long ago the first record it is
        missing was appended here (leader monotonic clock). A follower
        with no cursor for a doc yet (mid-handshake) reports nothing for
        it rather than a fake number."""
        if now is None:
            now = obs.now()
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for addr, link in self._links.items():
                per: Dict[str, float] = {}
                for name, st in self._streams.items():
                    f = link.durable_lsn.get(name)
                    if f is None:
                        continue
                    if f >= st.lsn:
                        per[name] = 0.0
                        continue
                    t = self._stamp_after(st, f)
                    per[name] = max(0.0, now - t) if t is not None else 0.0
                out[addr] = per
        return out

    def staleness_report(self, now: Optional[float] = None) -> dict:
        """Both sides of the staleness picture per follower: what this
        leader computes from its stamps, and what the follower last
        self-reported over the ping exchange (its own estimate against
        the RTT-aligned leader clock) — the agreement CI asserts on."""
        computed = self.staleness(now=now)
        out: Dict[str, dict] = {}
        with self._lock:
            links = dict(self._links)
        for addr, per in computed.items():
            link = links.get(addr)
            out[addr] = {
                "computed": per,
                "reported": dict(link.reported_staleness) if link else {},
            }
        return out

    def publish_staleness(self, now: Optional[float] = None) -> Dict[str, Dict[str, float]]:
        """Export the computed view: one ``cluster.staleness_seconds
        {node}`` gauge per follower (worst doc) plus one histogram
        observation per (follower, doc). Called from each link's idle
        ping cycle and from ``clusterStatus``, so the gauges are fresh
        whenever anything looks."""
        stale = self.staleness(now=now)
        for addr, per in stale.items():
            obs.gauge_set("cluster.staleness_seconds",
                          max(per.values(), default=0.0),
                          labels={"node": addr})
            for s in per.values():
                obs.observe("cluster.staleness_seconds", s)
        return stale

    # -- journal hooks (leader write path) -----------------------------------

    def _on_record(self, name: str, rec_type: int, payload: bytes,
                   seq: int) -> None:
        # capture the appending request's trace context (None outside a
        # propagated trace): the ship span and the follower's apply span
        # link back to every request a shipped batch covers
        ctx = obs.current_trace_context()
        with self._lock:
            st = self._streams.get(name)
            if st is None:
                return
            st.lsn += 1
            st.pending.append((st.lsn, seq, rec_type, payload, ctx))
            st.stamps.append((st.lsn, obs.now()))

    def _drain_pending_locked(self, st: _DocStream) -> bool:
        """Promote pending records covered by the journal's durable
        prefix into the ship buffer (hub lock held). Reading
        ``acked_seq`` directly makes the promotion self-synchronizing:
        the group-commit combiner fires ``on_synced`` OUTSIDE the
        journal condition, so a combined-fsync waiter can reach the ack
        gate before the hook ran — draining against the journal's own
        counter closes that window."""
        covering = st.dd.journal.acked_seq
        moved = False
        while st.pending and st.pending[0][1] <= covering:
            lsn, _seq, rec_type, payload, ctx = st.pending.popleft()
            st.buffer.append((lsn, rec_type, payload, ctx))
            st.buffer_bytes += len(payload) + 16
            st.synced_lsn = lsn
            moved = True
        while st.buffer and st.buffer_bytes > self.retain_bytes:
            lsn, _rt, pl, _ctx = st.buffer.popleft()
            st.buffer_bytes -= len(pl) + 16
            st.base_lsn = lsn
        return moved

    def _on_synced(self, name: str, covering: int) -> None:
        """Records up to journal append seq ``covering`` are durable on
        the leader: promote them into the ship buffer and wake links."""
        with self._lock:
            st = self._streams.get(name)
            if st is None:
                return
            if not self._drain_pending_locked(st):
                return
            links = list(self._links.values())
        for link in links:
            link.wake()

    # -- the ack gate --------------------------------------------------------

    def _breaker_gauges(self) -> None:
        for s in ("closed", "open", "half_open"):
            obs.gauge_set("repl.breaker",
                          1.0 if s == self._breaker_state else 0.0,
                          labels={"state": s})

    def _breaker_transition_locked(self, to: str) -> None:
        frm, self._breaker_state = self._breaker_state, to
        self._breaker_gauges()
        obs.count("repl.breaker_transitions", labels={"to": to})
        if to == "open":
            obs.count("repl.breaker_trips")
        obs.event("repl.breaker", frm=frm, to=to,
                  failures=self._breaker_failures)

    def breaker_state(self) -> str:
        with self._breaker_lock:
            return self._breaker_state

    def wait_acked(self, name: str) -> None:
        """The ack gate, behind the circuit breaker: closed -> wait for
        real follower acks; open -> ack on leader durability alone until
        the cooldown elapses (every bypass counted as
        ``repl.breaker_bypass``); half-open -> one probe waits for real
        acks while concurrent callers keep bypassing."""
        probe = False
        if self.breaker_enabled:
            with self._breaker_lock:
                if self._breaker_state == "open":
                    if (time.monotonic() - self._breaker_opened_at
                            < self.breaker_cooldown):
                        obs.count("repl.breaker_bypass")
                        return
                    self._breaker_transition_locked("half_open")
                    probe = True
                elif self._breaker_state == "half_open":
                    # a probe is already in flight; stacking more callers
                    # onto full ack timeouts is the stall being prevented
                    obs.count("repl.breaker_bypass")
                    return
        try:
            self._wait_acked(name)
        except ReplicationTimeout:
            if self.breaker_enabled:
                with self._breaker_lock:
                    self._breaker_failures += 1
                    if (self._breaker_state != "open"
                            and (probe or self._breaker_failures
                                 >= self.breaker_threshold)):
                        self._breaker_opened_at = time.monotonic()
                        self._breaker_transition_locked("open")
            raise
        else:
            if self.breaker_enabled:
                with self._breaker_lock:
                    self._breaker_failures = 0
                    if self._breaker_state != "closed":
                        self._breaker_transition_locked("closed")

    def _wait_acked(self, name: str) -> None:
        """Block until >= ack_replicas followers hold this document's
        current locally-durable LSN on their own disks. Raises
        ``ReplicationTimeout`` after ``ack_timeout`` — an un-replicated
        ack is no ack."""
        deadline = time.monotonic() + self.ack_timeout
        with self._acked:
            st = self._streams.get(name)
            if st is None:
                return
            # the caller's records are journal-durable by now, but the
            # combiner's on_synced hook may not have run yet: drain
            # against the journal's acked counter so the target covers
            # THIS caller's writes, never a stale prefix
            moved = self._drain_pending_locked(st)
            target = st.synced_lsn
            links = list(self._links.values()) if moved else []
        for link in links:
            link.wake()
        with self._acked:
            if target == 0:
                return  # nothing durable to replicate yet
            while True:
                n = sum(
                    1 for link in self._links.values()
                    if not link.quarantined
                    and link.durable_lsn.get(name, 0) >= target
                )
                if n >= self.ack_replicas:
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    raise ReplicationTimeout(
                        f"only {n}/{self.ack_replicas} followers confirmed "
                        f"{name}@{target} within {self.ack_timeout}s"
                    )
                self._acked.wait(timeout=min(remaining, 0.5))

    def _note_follower_ack(self, name: str, lsn: int) -> None:
        with self._acked:
            self._acked.notify_all()
        st = self._streams.get(name)
        if st is not None:
            obs.gauge_set(
                "cluster.replication_lag", max(0, st.synced_lsn - lsn),
                labels={"doc": name},
            )

    # -- snapshots (catch-up) ------------------------------------------------

    def snapshot(self, name: str) -> Tuple[bytes, int]:
        """A full save pinned to an LSN, taken under the document lock so
        save bytes and LSN describe the same instant. Mirrors the
        compaction dance: snapshot first, tail records after."""
        with self._lock:
            st = self._streams.get(name)
        if st is None:
            raise ReplicationError(f"no replicated document {name!r}")
        # timed acquire: the ack gate can hold this lock on the stdio
        # path while waiting for us — back off and let the caller requeue
        if not st.dd.lock.acquire(timeout=self.ack_timeout):
            raise ReplicationError(f"snapshot of {name!r}: doc lock busy")
        try:
            # the on-disk codec verbatim (run-coded when enabled): the
            # follower hydrates the same bytes the leader's disk holds,
            # no encode here / no re-encode there
            data = st.dd.snapshot_bytes()
            with self._lock:
                lsn = st.lsn
        finally:
            st.dd.lock.release()
        obs.count("cluster.snapshots_shipped")
        return data, lsn

    def tail_after(
        self, name: str, lsn: int
    ) -> Tuple[List[Tuple[int, bytes]], int, List[tuple]]:
        """Retained records with LSN > ``lsn`` (bounded by batch_bytes)
        plus the distinct trace contexts of the covered records, or raise
        when the tail has been trimmed past that point."""
        with self._lock:
            st = self._streams.get(name)
            if st is None:
                raise ReplicationError(f"no replicated document {name!r}")
            if lsn < st.base_lsn:
                raise ReplicationError(
                    f"{name!r}: records after {lsn} trimmed "
                    f"(base is {st.base_lsn}); snapshot required"
                )
            out, total, last = [], 0, lsn
            traces: List[tuple] = []
            for rec_lsn, rec_type, payload, ctx in st.buffer:
                if rec_lsn <= lsn:
                    continue
                if out and total + len(payload) > self.batch_bytes:
                    break
                out.append((rec_type, payload))
                total += len(payload)
                last = rec_lsn
                if ctx is not None and ctx not in traces and len(traces) < 8:
                    traces.append(ctx)
            return out, last, traces

    # -- follower management -------------------------------------------------

    def add_follower(self, addr: str) -> None:
        with self._lock:
            if self._closed or addr in self._links:
                return
            link = _FollowerLink(self, addr)
            self._links[addr] = link
        link.start()

    def remove_follower(self, addr: str) -> None:
        with self._lock:
            link = self._links.pop(addr, None)
        if link is not None:
            link.stop()
        with self._acked:
            self._acked.notify_all()

    def followers(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                addr: dict(link.durable_lsn)
                for addr, link in self._links.items()
            }

    def follower_addrs(self) -> List[str]:
        """Addresses of followers currently trusted for quorum (the
        anti-entropy scrub probes exactly this set)."""
        with self._lock:
            return [
                addr for addr, link in self._links.items()
                if not link.quarantined
            ]

    def quarantined_addrs(self) -> List[str]:
        with self._lock:
            return [
                addr for addr, link in self._links.items()
                if link.quarantined
            ]

    def quarantine(self, addr: str) -> bool:
        """Drop a follower from the ack-gate quorum without detaching it.

        The scrub loop calls this when a replica diverges AGAIN after a
        repair — a disk or host that corrupts twice cannot be trusted to
        hold acked writes, so its confirmations stop counting toward
        ``ack_replicas``. Shipping continues (the replica may still
        recover and serve reads); only its vote is revoked. Returns False
        for unknown addresses."""
        with self._lock:
            link = self._links.get(addr)
            if link is None:
                return False
            already = link.quarantined
            link.quarantined = True
            n = sum(1 for l in self._links.values() if l.quarantined)
        if not already:
            obs.count("cluster.quarantine", labels={"follower": addr})
            obs.event("cluster.quarantine", follower=addr)
        obs.gauge_set("cluster.quarantined", n)
        # the quorum just shrank: wake ack waiters so they re-count
        # against the reduced set instead of sleeping out their deadline
        with self._acked:
            self._acked.notify_all()
        return True

    def close(self) -> None:
        with self._lock:
            self._closed = True
            links = list(self._links.values())
            self._links.clear()
            streams = list(self._streams.values())
            self._streams.clear()
        for st in streams:
            st.dd.journal.on_record = None
            st.dd.journal.on_synced = None
            st.dd.replication_gate = None
        for link in links:
            link.stop()
        with self._acked:
            self._acked.notify_all()


class _FollowerLink:
    """One follower: a dialing connection plus a ship worker thread.

    The worker ships every attached document's durable tail in LSN order
    over a single connection — the follower applies the stream serially
    (one replication shard key), so each follower's state is always a
    prefix of the leader's replication log and follower states are
    mutually comparable (what promotion-by-longest-prefix relies on)."""

    def __init__(self, hub: ReplicationHub, addr: str):
        self.hub = hub
        self.addr = addr
        self.durable_lsn: Dict[str, int] = {}  # follower's durable cursor
        self.quarantined = False  # vote revoked (integrity divergence)
        # follower's last self-reported per-doc staleness estimate
        # (seconds, from the ping exchange)
        self.reported_staleness: Dict[str, float] = {}
        self._sent_lsn: Dict[str, int] = {}
        self._needs_snapshot: Dict[str, bool] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._rid = 0
        self._thread = threading.Thread(
            target=self._run, name=f"repl:{addr}", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def wake(self) -> None:
        self._wake.set()

    def note_doc(self, name: str) -> None:
        self._wake.set()

    def force_snapshot(self, name: str) -> None:
        """Next ship for ``name`` starts from a fresh snapshot (the
        reattach/resync path)."""
        self._needs_snapshot[name] = True
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        sock = self._sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._thread.join(timeout=10)

    # -- request plumbing (line framing, serial request/response) ------------

    def _connect(self):
        host, _, port = self.addr.rpartition(":")
        sock = socket.create_connection(
            (host, int(port)), timeout=self.hub.io_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the connect timeout stays as the per-op socket timeout: a
        # stalled follower (response path black-holed) times the request
        # out instead of freezing the ship loop — the link recycles and
        # the ack gate sees an honest zero instead of a hang
        self._sock = sock
        return sock.makefile("r")

    def _request(self, f, method: str, params: dict, trace=None) -> dict:
        self._rid += 1
        req = {"id": self._rid, "method": method, "params": params}
        if trace is not None:
            # parent the follower's request handling into the (first)
            # covered client trace; the full covered set rides in
            # params["traces"] as span links
            req["trace"] = {"t": trace[0], "s": trace[1]}
        line = json.dumps(req) + "\n"
        self._sock.sendall(line.encode("utf-8"))
        raw = f.readline()
        if not raw:
            raise ReplicationError("follower connection closed")
        resp = json.loads(raw)
        if "error" in resp:
            err = resp["error"]
            raise ReplicationError(
                f"{err.get('type')}: {err.get('message')}"
            )
        return resp.get("result") or {}

    # -- the ship loop -------------------------------------------------------

    def _run(self) -> None:
        backoff = 0.05
        while not self._stop.is_set():
            try:
                f = self._connect()
                obs.gauge_set("cluster.follower_up", 1,
                              labels={"follower": self.addr})
                self._handshake(f)
                backoff = 0.05
                self._ship_loop(f)
            except Exception as e:  # noqa: BLE001 — links must self-heal
                if self._stop.is_set():
                    return
                obs.count("cluster.link_error", error=str(e)[:200])
                obs.gauge_set("cluster.follower_up", 0,
                              labels={"follower": self.addr})
                sock, self._sock = self._sock, None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                # a dead follower must not freeze the gate accounting at
                # its last acked values — it no longer counts
                self.durable_lsn.clear()
                self._sent_lsn.clear()
                self.reported_staleness.clear()
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 2.0)

    def _handshake(self, f) -> None:
        """Learn the follower's persisted cursors; decide tail vs
        snapshot per document."""
        status = self._request(f, "clusterStatus", {})
        cursors = {
            name: info.get("cursor")
            for name, info in (status.get("docs") or {}).items()
        }
        for name in self.hub.doc_names():
            cur = cursors.get(name)
            if (
                cur
                and cur.get("stream") == self.hub.stream_id
            ):
                self._sent_lsn[name] = int(cur["lsn"])
                self.durable_lsn[name] = int(cur["lsn"])
                self._needs_snapshot[name] = False
            else:
                self._needs_snapshot[name] = True
        self.hub._note_follower_ack("", 0)

    def _ship_loop(self, f) -> None:
        last_sent = time.monotonic()
        while not self._stop.is_set():
            progressed = False
            for name in self.hub.doc_names():
                if self._needs_snapshot.get(name, True):
                    self._ship_snapshot(f, name)
                    progressed = True
                while self._ship_tail(f, name):
                    progressed = True
            if progressed:
                last_sent = time.monotonic()
                continue
            if not self._wake.wait(timeout=self.hub.heartbeat):
                if time.monotonic() - last_sent >= self.hub.heartbeat:
                    # the idle heartbeat doubles as a clock-sync probe:
                    # the RTT midpoint around the follower's reported
                    # monotonic "now" is what flight-merge uses to put
                    # both processes' spans on one timeline
                    t0 = obs.now()
                    # the ping carries the leader clock and per-doc
                    # latest LSNs out; the response carries the
                    # follower's own staleness estimate back — the two
                    # halves of the RTT exchange the agreement
                    # assertion in run_cluster compares
                    res = self._request(f, "replPing", {
                        "stream": self.hub.stream_id,
                        "now": t0,
                        "docs": self.hub.doc_lsns(),
                    })
                    t1 = obs.now()
                    peer_now = res.get("now")
                    if isinstance(peer_now, (int, float)):
                        obs.flight.note_clock_sync(
                            res.get("nodeId") or self.addr, t0, t1, peer_now)
                    rep = res.get("staleness")
                    if isinstance(rep, dict):
                        self.reported_staleness = {
                            str(k): float(v) for k, v in rep.items()
                            if isinstance(v, (int, float))
                        }
                    self.hub.publish_staleness(now=t1)
                    last_sent = time.monotonic()
            self._wake.clear()

    def _ship_snapshot(self, f, name: str) -> None:
        data, lsn = self.hub.snapshot(name)
        cursor = encode_cursor(self.hub.stream_id, lsn)
        self._request(f, "replSnapshot", {
            "name": name,
            "stream": self.hub.stream_id,
            "lsn": lsn,
            "snapshot": base64.b64encode(data).decode("ascii"),
            "cursor": base64.b64encode(cursor).decode("ascii"),
            # staleness base: a snapshot pinned to the leader's latest
            # LSN makes the follower fresh as of this leader instant
            "now": obs.now(),
            "leaderLsn": lsn,
        })
        self._needs_snapshot[name] = False
        self._sent_lsn[name] = lsn
        self.durable_lsn[name] = lsn
        self.hub._note_follower_ack(name, lsn)

    def _ship_tail(self, f, name: str) -> bool:
        """Ship one contiguous batch after the follower's cursor; True
        when records went out (call again — there may be more)."""
        since = self._sent_lsn.get(name, 0)
        try:
            records, last, traces = self.hub.tail_after(name, since)
        except ReplicationError:
            # the follower's cursor fell off the bounded retention
            # buffer (it stalled, or died and came back late): forced
            # snapshot catch-up instead of a stall — and counted, so
            # the soak can assert the path actually exercised
            obs.count("cluster.catchup_snapshots",
                      labels={"reason": "retention"})
            self._needs_snapshot[name] = True
            self._ship_snapshot(f, name)
            return True
        if not records:
            return False
        cursor = encode_cursor(self.hub.stream_id, last)
        with obs.span("cluster.ship_batch", links=traces,
                      records=len(records)):
            try:
                params = {
                    "name": name,
                    "stream": self.hub.stream_id,
                    "prev": since,
                    "lsn": last,
                    "data": base64.b64encode(
                        encode_batch(records)).decode("ascii"),
                    "cursor": base64.b64encode(cursor).decode("ascii"),
                    # leader ship-time clock + latest LSN: the follower
                    # marks itself fresh-as-of "now" when this batch
                    # brings it level with leaderLsn
                    "now": obs.now(),
                    "leaderLsn": self.hub.lsn(name),
                }
                if traces:
                    params["traces"] = [[t, s] for t, s in traces]
                self._request(f, "replApply", params,
                              trace=traces[0] if traces else None)
            except ReplicationError as e:
                if "ReplCursorMismatch" in str(e):
                    # the follower's journal disagrees with our
                    # bookkeeping (its restart raced an ack): resync
                    # through a snapshot instead of guessing
                    obs.count("cluster.catchup_snapshots",
                              labels={"reason": "cursor_mismatch"})
                    self._needs_snapshot[name] = True
                    self._ship_snapshot(f, name)
                    return True
                raise
        obs.count("cluster.records_shipped", n=len(records))
        self._sent_lsn[name] = last
        self.durable_lsn[name] = last
        self.hub._note_follower_ack(name, last)
        return True
