"""End-to-end integrity: verifiable doc digests, anti-entropy scrub,
and self-healing replicas.

Every robustness layer so far defends against faults that announce
themselves — crashes, partitions, ENOSPC, overload. This module detects
**silent** divergence and heals it, off the ack path and rate-limited:

* **Verifiable doc digests** — a deterministic per-document state
  digest. The accumulator is the XOR of every committed change's 32-byte
  chunk hash, which makes it order-independent by construction (the same
  change set produces the same digest across merge orders, replication
  interleavings, and dense / compressed / run-native residency — the
  digest is a function of history, not representation) and O(1) to
  maintain incrementally: ``DurableDocument`` folds each change's hash
  in as it enters history and only recomputes on open. The exposed
  digest binds the accumulator, the change count, and the sorted heads
  under one SHA-256 (``finalize_digest``), so two documents agree iff
  they hold the same changes *and* the same frontier.
* **Anti-entropy scrubber** (``Scrubber``) — a background loop on every
  serving node. On a replication leader it exchanges digest-at-LSN with
  each follower (compared only when both sides sit at the same stable
  LSN, so live writes can never false-positive); a mismatch counts
  ``cluster.divergence{kind}``, dumps a flight recording, and self-heals
  by resetting the diverged replica from a fresh leader snapshot
  (``replReset`` — a plain catch-up snapshot cannot remove *extra*
  changes, CRDT merge is a union). A replica that re-diverges after a
  repair is quarantined: dropped from the ack-gate quorum
  (``cluster.quarantined`` gauge) rather than silently re-trusted.
* **Device-mirror audit** — sampled spot-checks of the compressed /
  run-native resident image against the dense host oracle
  (``CompressedOpColumns.verify_against``); a mismatch drops the mirror
  for rebuild (``device.mirror_divergence``) instead of serving corrupt
  reads.
* **Durable-tier scrub** — read-back verification of snapshots (strict
  chunk-checksum walk) and journals (the journal's own CRC scan) for
  cold documents and live on-disk files alike, so latent corruption is
  found *before* hydration needs the bytes. A corrupt live doc repairs
  from its own in-memory history (compact = fresh snapshot + truncated
  journal); a corrupt cold doc on a replicated deployment re-fetches
  from a healthy peer (``replHarvest`` union merge) with salvage as the
  last resort for unreplicated docs. Counted as
  ``journal.scrub_corrupt{kind}`` / ``journal.scrub_repaired{kind}``.

The port of ``automerge_tpu/integrity.py``. One ``except`` is narrowed:
a follower repair counts ``scrub.repair_error`` for a refused snapshot
(``ReplicationError``) or a failed call to the follower (a socket's
``OSError``, the follower's error answer, a malformed answer) and lets
any other failure propagate.

Knobs: ``AUTOMERGE_TPU_SCRUB`` (master switch, default on),
``AUTOMERGE_TPU_SCRUB_INTERVAL`` (seconds between rounds, default 15),
``AUTOMERGE_TPU_SCRUB_SAMPLE`` (documents verified per round per
surface, default 8).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import threading
from typing import Iterable, List, NamedTuple, Optional

from . import obs
from .utils.leb128 import encode_uleb

DIGEST_VERSION = b"amtpu-digest-v1"

_ZERO32 = bytes(32)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def scrub_enabled() -> bool:
    """Master switch for the background scrubber
    (``AUTOMERGE_TPU_SCRUB=0`` disables — the bench A/B baseline)."""
    return os.environ.get("AUTOMERGE_TPU_SCRUB", "1") != "0"


# -- verifiable doc digests ----------------------------------------------------


class DigestState:
    """Thread-safe incremental digest accumulator over change hashes.

    XOR of 32-byte SHA-256 change hashes: commutative and associative,
    so the accumulator is independent of the order changes entered
    history — exactly the invariance the digest promises across merge
    orders and replication interleavings. ``add`` is O(1) per change
    (32-byte XOR under a lock), cheap enough to ride the ack path's
    change listener.
    """

    __slots__ = ("_lock", "_acc", "_count")

    def __init__(self):
        self._lock = threading.Lock()
        self._acc = _ZERO32
        self._count = 0

    def add(self, change_hash: Optional[bytes]) -> None:
        if not change_hash:
            return
        with self._lock:
            self._acc = bytes(
                a ^ b for a, b in zip(self._acc, change_hash[:32])
            )
            self._count += 1

    def recompute(self, hashes: Iterable[bytes]) -> None:
        """Full rebuild (open / rebuild path): replace the accumulator
        with the XOR over ``hashes``."""
        acc = bytearray(32)
        count = 0
        for h in hashes:
            if not h:
                continue
            for i, b in enumerate(h[:32]):
                acc[i] ^= b
            count += 1
        with self._lock:
            self._acc = bytes(acc)
            self._count = count

    @property
    def count(self) -> int:
        return self._count

    def value(self) -> tuple:
        with self._lock:
            return self._acc, self._count


def finalize_digest(acc: bytes, count: int, heads: Iterable[bytes]) -> str:
    """Bind accumulator + change count + sorted heads into the exposed
    hex digest. Heads are hashed sorted so the frontier's set identity —
    not any discovery order — is what the digest commits to."""
    h = hashlib.sha256()
    h.update(DIGEST_VERSION)
    buf = bytearray()
    encode_uleb(count, buf)
    h.update(bytes(buf))
    h.update(acc)
    for head in sorted(heads):
        h.update(head)
    return h.hexdigest()


def doc_digest(core) -> dict:
    """Full digest of a core ``Document`` from its history — the
    non-incremental path for plain (non-durable) documents and tests."""
    state = DigestState()
    state.recompute(a.stored.hash for a in core.history)
    acc, count = state.value()
    return {
        "digest": finalize_digest(acc, count, core.get_heads()),
        "changes": count,
    }


def column_digests(log, source: str = "dense") -> dict:
    """Per-column SHA-256 over the canonical dense int64 image of an
    ``OpLog``'s resident columns — the column-level oracle the property
    suite diffs on digest mismatch and the device audit's ground truth.

    ``source="dense"`` hashes the host arrays directly;
    ``source="resident"`` decodes the compressed run tables where one
    exists (dense passthrough otherwise), so equality between the two
    maps proves the encoded image faithful.
    """
    import numpy as np

    from .ops import compressed as C

    comp = log.compressed(sync=True) if source == "resident" else None
    out = {}
    n = log.n
    q = len(log.pred_src)
    for name, _mode, _item in C.ROW_SPEC + C.EDGE_SPEC:
        rows = q if name in ("pred_src", "pred_tgt", "pred_key") else n
        arr = getattr(log, name)
        if arr is None:
            continue
        if name in ("insert", "expand"):
            arr = np.asarray(arr, np.bool_).view(np.int8)
        arr = np.asarray(arr[:rows])
        if comp is not None:
            ent = comp.entries.get(name)
            cov = comp.covered.get(name, 0)
            if ent is not None and ent is not C._DENSE and cov == rows:
                arr = ent.decode()
        canon = np.ascontiguousarray(
            np.asarray(arr).astype(np.int64, copy=False))
        h = hashlib.sha256()
        h.update(name.encode("ascii"))
        h.update(canon.tobytes())
        out[name] = h.hexdigest()
    return out


# -- read-back verification (snapshots + journals) -----------------------------


class VerifyReport(NamedTuple):
    """One file's read-back verification result. ``first_bad_offset`` is
    the byte offset of the first frame that failed its checksum (None
    when the file verified clean end to end)."""

    ok: bool
    kind: str  # "snapshot" | "journal"
    total_bytes: int
    valid_bytes: int
    first_bad_offset: Optional[int]
    units: int  # chunks / records verified before the first failure
    reason: str


def verify_snapshot_bytes(data: bytes) -> VerifyReport:
    """Strict sequential chunk walk over snapshot bytes: every chunk
    must parse at the exact expected offset and carry a valid checksum —
    no resynchronisation (``scan_chunks``'s carving tolerance is a
    recovery posture; verification wants the first bad byte).

    Run-coded (ARSN) snapshots verify section-by-section instead: a
    per-section CRC walk plus a chunk-checksum walk over the embedded
    change chunks and a full structural decode, reporting the offset of
    the first bad section (units = sections)."""
    from .storage import runsnap
    from .storage.chunk import parse_chunk

    if runsnap.is_runsnap(data):
        r = runsnap.verify_container(data)
        return VerifyReport(
            r["ok"], "snapshot", r["total_bytes"], r["valid_bytes"],
            r["first_bad_offset"], r["units"], r["reason"] or "",
        )

    pos = 0
    units = 0
    n = len(data)
    while pos < n:
        try:
            chunk, end = parse_chunk(data, pos)
        except Exception as e:  # noqa: BLE001 — any decode fault is a finding
            return VerifyReport(False, "snapshot", n, pos, pos, units,
                                str(e) or type(e).__name__)
        if not chunk.checksum_valid:
            return VerifyReport(False, "snapshot", n, pos, pos, units,
                                "checksum mismatch")
        units += 1
        pos = end
    return VerifyReport(True, "snapshot", n, n, None, units, "")


def verify_journal_bytes(data: bytes) -> VerifyReport:
    """CRC-verify every journal record via the journal's own read-only
    scan. Any stop short of end-of-file — torn tail or mid-file bit rot
    alike — reports the stop offset; the caller decides whether a torn
    tail is expected (crash recovery) or a finding (a cleanly-closed
    cold journal)."""
    from .storage.journal import scan_records

    records, tail = scan_records(data)
    ok = tail.valid_bytes == tail.total_bytes
    return VerifyReport(
        ok, "journal", tail.total_bytes, tail.valid_bytes,
        None if ok else tail.valid_bytes, len(records),
        "" if ok else (tail.reason or "truncated record"),
    )


def verify_doc_dir(path: str, fs=None) -> List[VerifyReport]:
    """Deep read-back scan of one durable document directory (snapshot +
    journal) — the shared core under the durable-tier scrub and
    ``cli.py journal-info --verify``."""
    from .storage.durable import JOURNAL_NAME, SNAPSHOT_NAME
    from .storage.journal import OS_FS

    fs = fs or OS_FS
    out = []
    snap = os.path.join(path, SNAPSHOT_NAME)
    if fs.exists(snap):
        out.append(verify_snapshot_bytes(fs.read_bytes(snap)))
    jpath = os.path.join(path, JOURNAL_NAME)
    if fs.exists(jpath):
        out.append(verify_journal_bytes(fs.read_bytes(jpath)))
    return out


# -- one admin request on a short-lived connection -----------------------------


def _admin_call(addr: str, method: str, params: dict,
                timeout: float = 10.0) -> dict:
    """One synchronous JSON-line request to a peer node. The scrubber
    must not share the replication links' pipelined sockets — a scrub
    probe riding a ship loop's connection would interleave frames."""
    host, _, port = addr.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.settimeout(timeout)
        line = json.dumps({"id": 1, "method": method, "params": params})
        s.sendall((line + "\n").encode("utf-8"))
        f = s.makefile("r")
        raw = f.readline()
    if not raw:
        raise OSError(f"no response from {addr}")
    resp = json.loads(raw)
    if "error" in resp:
        err = resp["error"]
        raise RuntimeError(f"{err.get('type')}: {err.get('message')}")
    return resp.get("result") or {}


# -- the scrubber --------------------------------------------------------------


class Scrubber:
    """Background anti-entropy loop for one serving node. All passes are
    sampled (``AUTOMERGE_TPU_SCRUB_SAMPLE`` docs per surface per round,
    round-robin so every doc is eventually covered) and run between the
    ack path's locks, never on it."""

    def __init__(self, rpc, *, interval: Optional[float] = None,
                 sample: Optional[int] = None):
        self.rpc = rpc
        self.interval = (
            interval if interval is not None
            else _env_float("AUTOMERGE_TPU_SCRUB_INTERVAL", 15.0)
        )
        self.sample = (
            sample if sample is not None
            else max(1, _env_int("AUTOMERGE_TPU_SCRUB_SAMPLE", 8))
        )
        self._rr = 0  # round-robin cursor over the doc-name space
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._round_lock = threading.Lock()
        # (follower addr, doc name) -> times repaired: the first
        # divergence heals, a re-divergence after repair quarantines
        self._repaired: dict = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None or not scrub_enabled():
            return
        self._thread = threading.Thread(
            target=self._run, name="scrubber", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.run_round()
            except Exception as e:  # noqa: BLE001 — the loop must not die
                obs.count("scrub.round_error", error=str(e)[:200])

    # -- one round -----------------------------------------------------------

    def run_round(self) -> dict:
        """One full scrub round (also the ``scrubNow`` RPC body, so CI
        can force a deterministic pass instead of sleeping out the
        cadence). Returns a summary of what was checked and found."""
        with self._round_lock:
            summary = {"mirrors": 0, "files": 0, "digests": 0,
                       "corrupt": 0, "divergent": 0, "repaired": 0,
                       "quarantined": 0}
            with obs.span("scrub.round"):
                names = self._sample_names()
                for name in names:
                    summary["mirrors"] += self._audit_mirror(name, summary)
                for name in names:
                    summary["files"] += self._scrub_files(name, summary)
                hub = getattr(self.rpc, "hub", None)
                if hub is not None:
                    self._anti_entropy(hub, summary)
            obs.count("scrub.rounds")
            return summary

    def _sample_names(self) -> List[str]:
        rpc = self.rpc
        with rpc._lock:
            names = set(rpc._durable_names)
        store = getattr(rpc, "store", None)
        if store is not None:
            try:
                names.update(store.names())
            except Exception:  # noqa: BLE001 — store may be mid-shutdown
                pass
        ordered = sorted(names)
        if not ordered:
            return []
        k = min(self.sample, len(ordered))
        start = self._rr % len(ordered)
        self._rr += k
        return [ordered[(start + i) % len(ordered)] for i in range(k)]

    def _live_doc(self, name):
        """The OPEN durable doc for ``name``, or None (never hydrates —
        scrubbing must not churn residency)."""
        rpc = self.rpc
        with rpc._lock:
            h = rpc._durable_names.get(name)
            doc = rpc._docs.get(h) if h is not None else None
        if doc is None or not hasattr(doc, "journal"):
            return None
        if getattr(doc, "_closed", False):
            return None
        return doc

    # -- device-mirror audit -------------------------------------------------

    def _audit_mirror(self, name: str, summary: dict) -> int:
        doc = self._live_doc(name)
        dev = getattr(doc, "device_doc", None) if doc is not None else None
        if dev is None:
            return 0
        if not doc.lock.acquire(timeout=0.2):
            return 0  # busy doc: skip this round, never stall the ack path
        try:
            with obs.span("scrub.mirror", doc=name):
                bad = dev.audit_columns()
        except Exception as e:  # noqa: BLE001 — an audit fault is a finding
            bad = [f"audit-error:{e}"[:80]]
        finally:
            doc.lock.release()
        if not bad:
            return 1
        # the clean-degrade contract: never serve from a mirror the
        # oracle disputes — drop it for rebuild and say so loudly
        for col in bad:
            obs.count("device.mirror_divergence", labels={"column": col})
        obs.event("device.mirror_divergence", doc=name, columns=bad)
        self._flight_dump("mirror_divergence")
        summary["divergent"] += 1
        store = getattr(self.rpc, "store", None)
        try:
            if store is not None and store.tier(name) == "hot":
                store.demote(name, "warm", reason="integrity")
            else:
                doc.drop_device_mirror()
        except Exception:  # noqa: BLE001 — direct drop as fallback
            doc.drop_device_mirror()
        return 1

    # -- durable-tier scrub --------------------------------------------------

    def _scrub_files(self, name: str, summary: dict) -> int:
        doc = self._live_doc(name)
        if doc is not None:
            return self._scrub_live(name, doc, summary)
        store = getattr(self.rpc, "store", None)
        if store is not None and store.tier(name) == "cold":
            return self._scrub_cold(name, summary)
        return 0

    def _doc_fs(self, name: str):
        from .storage.journal import OS_FS

        return getattr(self.rpc, "_chaos_fs", {}).get(name) or OS_FS

    def _scrub_live(self, name: str, doc, summary: dict) -> int:
        """Read-back verify a LIVE doc's on-disk files. Holding the doc
        lock excludes appends and compactions, and a forced fsync first
        flushes buffered tail bytes — so any short CRC prefix is real
        damage, not an in-flight write."""
        from .storage.durable import JOURNAL_NAME, SNAPSHOT_NAME

        if not doc.lock.acquire(timeout=0.2):
            return 0
        try:
            j = doc.journal
            if j.closed or j.poisoned:
                return 0  # degraded docs have their own recovery surface
            fs = self._doc_fs(name)
            with obs.span("scrub.durable", doc=name, tier="live"):
                try:
                    j.sync()
                except Exception:  # noqa: BLE001 — fsync fault, not bit rot
                    return 0
                reports = []
                jpath = os.path.join(doc.path, JOURNAL_NAME)
                if fs.exists(jpath):
                    reports.append(verify_journal_bytes(fs.read_bytes(jpath)))
                spath = os.path.join(doc.path, SNAPSHOT_NAME)
                if fs.exists(spath):
                    reports.append(verify_snapshot_bytes(fs.read_bytes(spath)))
            bad = [r for r in reports if not r.ok]
            if not bad:
                obs.count("journal.scrub_clean")
                return 1
            for r in bad:
                obs.count("journal.scrub_corrupt", labels={"kind": r.kind})
                obs.event("journal.scrub_corrupt", doc=name, kind=r.kind,
                          offset=r.first_bad_offset, reason=r.reason[:120])
            self._flight_dump("scrub_corrupt")
            summary["corrupt"] += len(bad)
            # a live doc's in-memory history is complete (every acked
            # change entered it before the ack) — a fresh snapshot +
            # truncated journal rewrites clean bytes with zero loss
            if doc.compact():
                obs.count("journal.scrub_repaired", labels={"kind": "live"})
                summary["repaired"] += 1
            return 1
        finally:
            doc.lock.release()

    def _scrub_cold(self, name: str, summary: dict) -> int:
        rpc = self.rpc
        try:
            path = rpc._durable_path(name)
        except Exception:  # noqa: BLE001 — not durable mode
            return 0
        fs = self._doc_fs(name)
        with obs.span("scrub.durable", doc=name, tier="cold"):
            try:
                reports = verify_doc_dir(path, fs=fs)
            except Exception as e:  # noqa: BLE001 — unreadable IS corrupt
                reports = [VerifyReport(False, "journal", 0, 0, 0, 0,
                                        str(e)[:120])]
        bad = [r for r in reports if not r.ok]
        if not bad:
            obs.count("journal.scrub_clean")
            return 1
        for r in bad:
            obs.count("journal.scrub_corrupt", labels={"kind": r.kind})
            obs.event("journal.scrub_corrupt", doc=name, kind=r.kind,
                      offset=r.first_bad_offset, reason=r.reason[:120])
        self._flight_dump("scrub_corrupt")
        summary["corrupt"] += len(bad)
        self._repair_cold(name, summary)
        return 1

    def _repair_cold(self, name: str, summary: dict) -> None:
        """Re-fetch a corrupt cold doc from a healthy peer and rewrite
        clean files: salvage-open locally (torn tails truncate, damaged
        snapshot chunks drop), union-merge the peer's full state (every
        change the local damage lost comes back — CRDT merge by hash),
        then compact. Without a peer the salvage alone is the last
        resort, loudly counted."""
        rpc = self.rpc
        store = getattr(rpc, "store", None)
        if store is None:
            return
        peer = self._peer_snapshot(name)
        try:
            doc = store.ensure_open(name)
        except Exception as e:  # noqa: BLE001 — hydration may be bounded
            obs.count("journal.scrub_repair_error", error=str(e)[:200])
            return
        try:
            if peer is not None:
                with doc.lock, doc.ack_scope():
                    doc.load_incremental(peer, on_partial="salvage")
            doc.compact()
        except Exception as e:  # noqa: BLE001
            obs.count("journal.scrub_repair_error", error=str(e)[:200])
            return
        kind = "peer" if peer is not None else "salvage"
        obs.count("journal.scrub_repaired", labels={"kind": kind})
        summary["repaired"] += 1

    def _peer_snapshot(self, name: str) -> Optional[bytes]:
        """Full document state from a healthy replica: the leader asks
        its (non-quarantined) followers, a follower asks its leader.
        None on an unreplicated deployment."""
        rpc = self.rpc
        addrs: List[str] = []
        hub = getattr(rpc, "hub", None)
        if hub is not None:
            addrs = hub.follower_addrs()
        elif getattr(rpc, "leader_hint", None):
            addrs = [rpc.leader_hint]
        for addr in addrs:
            try:
                res = _admin_call(addr, "replHarvest", {"name": name})
                return base64.b64decode(res["snapshot"])
            except Exception as e:  # noqa: BLE001 — try the next peer
                obs.count("scrub.peer_error", error=str(e)[:200])
        return None

    @staticmethod
    def _flight_dump(reason: str) -> None:
        try:
            obs.flight.dump(reason=reason)
        except Exception:  # noqa: BLE001 — diagnostics must not fail scrub
            pass

    # -- anti-entropy (leader <-> follower digest exchange) ------------------

    def _anti_entropy(self, hub, summary: dict) -> None:
        names = hub.doc_names()
        if not names:
            return
        names = sorted(names)
        k = min(self.sample, len(names))
        start = self._rr % len(names)
        picked = [names[(start + i) % len(names)] for i in range(k)]
        addrs = hub.follower_addrs()
        for name in picked:
            doc = self._live_doc(name)
            if doc is None:
                continue
            lsn_a = hub.lsn(name)
            try:
                mine = doc.doc_digest()
            except Exception:  # noqa: BLE001 — racing close/demote
                continue
            if hub.lsn(name) != lsn_a:
                obs.count("scrub.digest_skipped", labels={"reason": "busy"})
                continue
            for addr in addrs:
                self._compare_follower(hub, addr, name, lsn_a, mine, summary)

    def _compare_follower(self, hub, addr: str, name: str, lsn: int,
                          mine: dict, summary: dict) -> None:
        try:
            theirs = _admin_call(addr, "docDigest", {"name": name},
                                 timeout=hub.io_timeout)
        except Exception as e:  # noqa: BLE001 — link faults aren't rot
            obs.count("scrub.peer_error", error=str(e)[:200])
            return
        if (theirs.get("stream") != hub.stream_id
                or theirs.get("lsn") != lsn):
            obs.count("scrub.digest_skipped", labels={"reason": "lagging"})
            return
        summary["digests"] += 1
        if theirs.get("digest") == mine["digest"]:
            obs.count("cluster.digest_ok")
            return
        # same stream, same LSN, different state: genuine divergence
        summary["divergent"] += 1
        obs.count("cluster.divergence", labels={"kind": "follower_digest"})
        obs.event("cluster.divergence", follower=addr, doc=name, lsn=lsn,
                  leader=mine["digest"], follower_digest=theirs.get("digest"))
        self._flight_dump("divergence")
        key = (addr, name)
        if key in self._repaired:
            # repaired once already and diverged again: the replica is
            # not trustworthy — out of the ack quorum, loudly
            hub.quarantine(addr)
            summary["quarantined"] += 1
            return
        self._repaired[key] = 1
        if self._repair_follower(hub, addr, name):
            summary["repaired"] += 1

    def _repair_follower(self, hub, addr: str, name: str) -> bool:
        """Reset the diverged replica from a fresh leader snapshot. A
        forced catch-up snapshot is NOT enough: CRDT merge is a union,
        so a replica holding *extra* (corrupt or foreign) changes would
        keep them — ``replReset`` wipes the replica's doc state first."""
        from .cluster.replication import ReplicationError, encode_cursor

        try:
            data, lsn = hub.snapshot(name)
            cursor = encode_cursor(hub.stream_id, lsn)
            _admin_call(addr, "replReset", {
                "name": name,
                "stream": hub.stream_id,
                "lsn": lsn,
                "snapshot": base64.b64encode(data).decode("ascii"),
                "cursor": base64.b64encode(cursor).decode("ascii"),
            }, timeout=max(hub.io_timeout, 30.0))
        except (ReplicationError, OSError, RuntimeError, ValueError) as e:
            # a refused snapshot or a failed call to the follower
            obs.count("scrub.repair_error", error=str(e)[:200])
            return False
        obs.count("cluster.divergence_repaired")
        return True
