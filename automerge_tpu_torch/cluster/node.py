"""A cluster backend node: the concurrent socket server plus a role.

``ClusterNode`` wraps ``SocketRpcServer`` with a replication role:

* **leader** — serves the full client method surface, runs a
  ``ReplicationHub`` that ships every acked journal append to its
  followers, and (with ``ack_replicas``) withholds client acks until
  enough followers hold the write durably;
* **follower** — rejects client mutations with a ``NotLeader`` error
  (carrying the leader address as a hint), applies the replication
  stream serially through one shard key (so its state is always a
  prefix of the leader's log), and can be promoted in place.

The RPC surface grows cluster methods (``clusterStatus``,
``clusterPromote``, ``clusterReplicateTo``, ``replApply``,
``replSnapshot``, ``replPing``, ``migrateOut`` / ``migrateTail`` /
``migrateIn`` / ``migrateRelease``) — same line framing, same error
envelope, dispatched through the same allowlist discipline as every
other method.

Promotion (``clusterPromote``): flip role, mint a fresh
``ReplicationHub`` (new stream id, so surviving followers notice the
incarnation change and snapshot-resync), warm-open every durable
directory, and count ``cluster.promotions``. Client sync sessions resume
through ``syncSessionAttach`` — the replicated ``sync/<peer>`` journal
meta restores each session with a bumped epoch, so the epoch/reset
handshake renegotiates in one round instead of a full resync.

The port of ``automerge_tpu/cluster/node.py``. Its differences, each on
purpose:

* **The device.** ``ClusterNode(..., device=None)`` and
  ``ClusterRpcServer(..., device=None)`` take a torch device (None: the
  card; without a GPU the constructor raises). Every document the node
  opens, replicates, migrates in, warm-opens or promotes lives there,
  every follower mirror too, and the batched follower drain's packed
  launch (``resolve_stages(..., device=)``) runs there.
* **A failed mirror feed is answered, not acked.** The reference's
  ``_feed_repl_mirrors`` counts ``cluster.repl_device_feed_error``,
  drops the mirror and acks the drained ``replApply`` requests (its
  ``except Exception``). The port counts it the same way, drops the
  failed mirrors (through the store: hot to warm, so the next access
  rebuilds each from the journaled history on the device), and answers
  the requests whose changes fed them with the error. A document's own
  staging error fails that document's requests; a failed launch fails
  every request whose changes it carried. The host apply was journaled
  first, so the follower's cursor already covers the batch: the leader's
  link counts the error, reconnects, reads the cursor from
  ``clusterStatus`` and ships on from there (nothing lost, nothing sent
  twice).
* **A snapshot resync rebuilds the mirror.** ``replSnapshot`` and
  ``replReset`` that bring a mirrored replica new changes rebuild its
  mirror from the history (one resolve on the device); the reference
  leaves the mirror as it was, missing the snapshot's changes.
* **Narrowed ``except``s.** ``_warm_open`` skips a directory the durable
  layer refuses (the journal's, the image's and the document's errors,
  ``OSError``) and lets every other failure, the card's among them,
  propagate. A sub-run whose document cannot be opened answers its
  requests with that error (the reference retries it per request). The
  two ``except``s left around ``doc_digest`` guard host state only (the
  digest is a hash of the history, no device work).
* ``AUTOMERGE_TPU_REPL_BATCH`` is read where the node is built.
"""

from __future__ import annotations

import base64
import contextlib
import os
import threading
import time
import zlib
from typing import Optional, Sequence

from .. import obs
from ..errors import AutomergeError
from ..rpc import RpcServer
from ..serve.server import SocketRpcServer
from ..storage.journal import JournalError
from ..storage.runsnap import RunSnapError
from .replication import (
    ReplicationHub,
    decode_batch,
    decode_cursor,
    encode_batch,
)

# the whole replication stream serializes through ONE shard key: each
# follower's durable state stays a strict prefix of the leader's log,
# which keeps follower states totally ordered for promotion
REPL_SHARD_KEY = "__replication__"

_REPL_METHODS = frozenset(
    {"replApply", "replSnapshot", "replReset", "migrateIn"}
)

# what a follower will answer; everything else is NotLeader. The
# durable-recovery and chaos-injection surfaces are follower-ok: a
# degraded FOLLOWER doc (live disk fault on the replica) is repaired in
# place by compact/reopen, and the chaos soak deals its faults to
# followers directly.
_FOLLOWER_OK = frozenset({
    "clusterStatus", "clusterPromote", "clusterReplicateTo",
    "replApply", "replSnapshot", "replPing", "replHarvest",
    "metrics", "configure",
    "durableInfo", "durableCompact", "durableReopen", "openDurable",
    "chaosDisk",
    # residency is node-local: a follower's store demotes and hydrates
    # its replica copies independently of the leader's tiers
    "storeStatus", "storeDemote",
    # integrity surface: the leader's anti-entropy scrub probes follower
    # digests, resets diverged replicas, and CI forces follower rounds
    "docDigest", "replReset", "scrubNow",
    # read-only telemetry: a follower's heat table and history rings
    # are its own (the advisor reads every node's view)
    "heatStatus", "historyStatus",
})


class NotLeader(Exception):
    pass


def _wire_blob(data: bytes):
    """Encode one migration payload for the wire: ``(b64, codec)``.

    With compressed residency on (``AUTOMERGE_TPU_COMPRESSED``), blobs
    past a floor ship zlib-compressed (level 1 — migration is
    latency-sensitive; the snapshot format is already columnar-packed,
    so the cheap level captures most of the win) so cold migration and
    live handoffs move compressed bytes, not raw journal rows. Byte
    counters (``cluster.migrate_raw_bytes`` / ``_wire_bytes``) make the
    saving observable. Returns ``codec=None`` (field omitted by
    callers) when compression is off or doesn't pay."""
    from ..ops import compressed as _C

    obs.count("cluster.migrate_raw_bytes", n=len(data))
    if _C.enabled() and len(data) >= 512:
        z = zlib.compress(data, 1)
        if len(z) < len(data):
            obs.count("cluster.migrate_wire_bytes", n=len(z))
            return base64.b64encode(z).decode("ascii"), "zlib"
    obs.count("cluster.migrate_wire_bytes", n=len(data))
    return base64.b64encode(data).decode("ascii"), None


def _unwire_blob(b64s, codec) -> bytes:
    """Inverse of ``_wire_blob``; raw base64 when ``codec`` is absent
    (every pre-codec sender, e.g. a replHarvest snapshot)."""
    raw = base64.b64decode(b64s or "")
    return zlib.decompress(raw) if codec == "zlib" else raw


class ClusterRpcServer(RpcServer):
    """RpcServer + the cluster method surface and follower gating, every
    document on ``device`` (None: the card)."""

    METHODS = RpcServer.METHODS | frozenset({
        "clusterStatus", "clusterPromote", "clusterReplicateTo",
        "replApply", "replSnapshot", "replPing", "replHarvest",
        "replReset",
        "migrateOut", "migrateTail", "migrateIn", "migrateRelease",
    })

    def __init__(self, *a, node_id: str = "node", **kw):
        super().__init__(*a, **kw)
        self.node_id = node_id
        self.cluster_role = "leader"
        self.leader_hint: Optional[str] = None  # follower's known leader
        self.hub: Optional[ReplicationHub] = None
        self.last_leader_contact = 0.0
        self._role_lock = threading.RLock()
        # set by the node's batched follower drain for the duration of a
        # coalesced replApply run (the repl shard is single-threaded):
        # apply_replicated hands each doc's applied changes here instead
        # of leaving the device mirror untouched
        self._repl_device_feed = None
        # follower staleness self-estimate, kept in the LEADER's
        # monotonic frame: the last leader clock sample (leader now,
        # local now at receipt — every replApply/replPing carries one),
        # the per-doc applied LSN, and per doc the leader-frame instant
        # at which this follower last held everything the leader had
        self._stale_lock = threading.Lock()
        self._leader_clock = None  # (leader_now, local_now)
        self._applied_lsn: dict = {}
        self._fresh_at: dict = {}

    # -- gating --------------------------------------------------------------

    def handle(self, req: dict) -> dict:
        method = req.get("method", "")
        if (
            self.cluster_role == "follower"
            and isinstance(method, str)
            and method in self.METHODS
            and method not in _FOLLOWER_OK
        ):
            obs.count("rpc.errors",
                      labels={"method": method, "type": "NotLeader"})
            return {"id": req.get("id"), "error": {
                "type": "NotLeader",
                "message": f"node {self.node_id} is a follower"
                + (f" of {self.leader_hint}" if self.leader_hint else ""),
                "leader": self.leader_hint,
                # retriable: mid-failover the router can briefly route at
                # a node that has not been promoted yet; retry re-resolves
                "retriable": True,
            }}
        return super().handle(req)

    # -- replicated document access ------------------------------------------

    def _repl_doc(self, name):
        """Open-or-get the named durable doc for the replication /
        migration paths (bypasses the follower gate by construction:
        these handlers are already past it). A cold-demoted replica
        hydrates here — applying a shipped batch needs the live doc."""
        h = self.openDurable({"name": name})["doc"]
        doc = self._ensure_resident(h)
        return doc if doc is not None else self._docs[h]

    # -- follower staleness self-estimate ------------------------------------

    def _note_leader_clock(self, leader_now) -> None:
        if isinstance(leader_now, (int, float)):
            with self._stale_lock:
                self._leader_clock = (float(leader_now), obs.now())

    def _est_leader_now(self):
        """The leader's monotonic clock, extrapolated from the last
        sample it shipped us (one-way, so off by up to one transit —
        within the RTT bound the agreement assertion allows)."""
        with self._stale_lock:
            lc = self._leader_clock
        if lc is None:
            return None
        return lc[0] + (obs.now() - lc[1])

    def _note_applied(self, name, lsn, leader_now, leader_lsn) -> None:
        """Record one applied batch/snapshot: our durable LSN for the
        doc, and — when the batch brought us level with the leader's
        latest — the leader-frame instant we became fresh at."""
        self._note_leader_clock(leader_now)
        with self._stale_lock:
            self._applied_lsn[name] = int(lsn)
            if (
                isinstance(leader_now, (int, float))
                and isinstance(leader_lsn, int)
                and int(lsn) >= leader_lsn
            ):
                self._fresh_at[name] = float(leader_now)

    def follower_staleness(self) -> dict:
        """{doc: seconds} — this follower's own staleness estimate:
        extrapolated leader-now minus the last instant we were level.
        Empty until the first leader clock sample arrives."""
        est_now = self._est_leader_now()
        if est_now is None:
            return {}
        with self._stale_lock:
            return {
                name: max(0.0, est_now - t)
                for name, t in self._fresh_at.items()
            }

    # -- cluster status ------------------------------------------------------

    def clusterStatus(self, p):
        docs = {}
        with self._lock:
            named = dict(self._durable_names)
        for name, h in sorted(named.items()):
            doc = self._docs.get(h)
            if doc is None or not hasattr(doc, "journal"):
                continue
            acked, appended = doc.acked_prefix()
            cur = doc.replication_cursor
            info = {
                "acked": acked,
                "appended": appended,
                "cursor": None,
            }
            if cur is not None:
                stream, lsn = decode_cursor(cur)
                info["cursor"] = {"stream": stream, "lsn": lsn}
            if self.hub is not None:
                info["lsn"] = self.hub.lsn(name)
            try:
                dg = doc.doc_digest()
                info["digest"] = dg["digest"]
                info["digestChanges"] = dg["changes"]
            except Exception:  # noqa: BLE001 — racing close/demote
                pass
            docs[name] = info
        out = {
            "nodeId": self.node_id,
            "role": self.cluster_role,
            "docs": docs,
            # clock-sync sample for the router's heartbeat poll (same
            # contract as replPing's "now")
            "now": obs.now(),
        }
        if self.hub is not None:
            out["stream"] = self.hub.stream_id
            out["followers"] = self.hub.followers()
            # seconds-based lag, both leader-computed and
            # follower-reported, refreshed (gauges included) on every
            # status poll so whoever is looking sees current numbers
            self.hub.publish_staleness()
            out["staleness"] = self.hub.staleness_report()
        else:
            stale = self.follower_staleness()
            if stale:
                out["stalenessSeconds"] = stale
                for name, s in stale.items():
                    if name in docs:
                        docs[name]["stalenessSeconds"] = s
        if self.leader_hint:
            out["leader"] = self.leader_hint
        # overload advertisement: the serving layer's admission
        # controller (installed by SocketRpcServer) rides the heartbeat
        # so the router stops routing sheddable classes at this node
        adm = getattr(self, "admission", None)
        if adm is not None:
            out["admission"] = adm.advertisement()
        return out

    # -- replication receive path (follower) ---------------------------------

    def replApply(self, p):
        """Apply one shipped record batch. Cursor arithmetic guards
        contiguity: our persisted cursor must name the same stream at
        exactly ``prev`` or the leader falls back to a snapshot."""
        name = p["name"]
        doc = self._repl_doc(name)
        cur = doc.replication_cursor
        have_stream, have_lsn = (None, 0) if cur is None else decode_cursor(cur)
        if have_stream != p["stream"] or have_lsn != int(p["prev"]):
            raise ReplCursorMismatch(
                f"{name}: have {have_stream}@{have_lsn}, "
                f"leader sent prev={p['prev']} on {p['stream']}"
            )
        records = decode_batch(base64.b64decode(p["data"]))
        # the shipped batch covers many leader-side requests: link this
        # follower's apply (and the journal fsync it nests) to each of
        # their traces so flight-merge connects client -> leader ->
        # follower on one timeline
        with obs.span("repl.apply",
                      links=obs.decode_wire_traces(p.get("traces")),
                      records=len(records)):
            applied = doc.apply_replicated(
                records, base64.b64decode(p["cursor"]),
                device_feed=self._repl_device_feed)
        obs.count("cluster.records_applied", n=len(records))
        self._note_applied(name, int(p["lsn"]),
                           p.get("now"), p.get("leaderLsn"))
        return {"lsn": int(p["lsn"]), "applied": applied}

    def replSnapshot(self, p):
        """Catch-up: full leader save + pinned cursor, applied through
        the listener path (known changes deduplicate on the history
        index, so converging snapshots never conflict)."""
        name = p["name"]
        doc = self._repl_doc(name)
        n = len(doc._core.history)
        doc.apply_replicated_snapshot(
            base64.b64decode(p["snapshot"]), base64.b64decode(p["cursor"]))
        self._resync_mirror(name, doc, n)
        obs.count("cluster.snapshots_applied")
        self._note_applied(name, int(p["lsn"]),
                           p.get("now"), p.get("leaderLsn"))
        return {"lsn": int(p["lsn"])}

    def _resync_mirror(self, name, doc, n_before: int) -> None:
        """A mirrored replica whose history a snapshot grew gets its
        mirror rebuilt from that history on the device (the snapshot's
        changes never reached the old one)."""
        if doc.device_doc is None or len(doc._core.history) == n_before:
            return
        self._store_drop_device(name)
        self._store_build_device(name)
        obs.count("cluster.mirror_resyncs")

    def replPing(self, p):
        self.last_leader_contact = time.monotonic()
        # the ping's request half carries the leader's clock and per-doc
        # latest LSNs: any doc we already hold in full is fresh as of
        # the leader instant the ping left — that keeps an IDLE doc's
        # staleness pinned near zero instead of growing since its last
        # write. The response half reports our estimate back.
        now_l = p.get("now")
        docs = p.get("docs")
        if isinstance(now_l, (int, float)):
            self._note_leader_clock(now_l)
            if isinstance(docs, dict):
                with self._stale_lock:
                    for name, llsn in docs.items():
                        if (
                            isinstance(llsn, int)
                            and self._applied_lsn.get(name, -1) >= llsn
                        ):
                            self._fresh_at[name] = float(now_l)
        out = {"nodeId": self.node_id, "role": self.cluster_role,
               "now": obs.now()}
        stale = self.follower_staleness()
        if stale:
            out["staleness"] = stale
            obs.gauge_set("cluster.staleness_seconds",
                          max(stale.values()),
                          labels={"node": self.node_id})
        # "now" (this process's monotonic obs clock) turns every ping
        # into a clock-sync sample: the pinger records the RTT midpoint
        # and flight-merge aligns the two processes' span timelines
        return out

    def replHarvest(self, p):
        """Hand out this node's full state for one document — the
        post-promotion reconciliation path: the router unions every
        reachable follower's state into the promoted leader (changes
        deduplicate by hash, so a CRDT merge is always safe), which
        keeps promotion lossless even when per-doc cursors diverge
        across followers and the longest-sum choice alone would not."""
        doc = self._repl_doc(p["name"])
        with doc.lock:
            data = doc._core.save()
        return {"snapshot": base64.b64encode(data).decode("ascii")}

    # -- integrity surface (anti-entropy scrub, integrity.py) ----------------

    def docDigest(self, p):
        """Base digest plus replication coordinates, so the leader's
        anti-entropy exchange can compare digests only when both sides
        sit at the same ``(stream, lsn)`` — never against a lagging or
        mid-apply replica."""
        out = super().docDigest(p)
        name = p.get("name")
        if name is None:
            return out
        if self.hub is not None:
            out["stream"] = self.hub.stream_id
            out["lsn"] = self.hub.lsn(name)
            return out
        # follower: digest and cursor must describe one instant — a
        # shipped batch landing between the two reads would pair a fresh
        # digest with a stale LSN and false-positive the leader's scrub
        with self._lock:
            h = self._durable_names.get(name)
            doc = self._docs.get(h) if h is not None else None
        if (
            doc is not None
            and hasattr(doc, "journal")
            and not getattr(doc, "_closed", False)
        ):
            with doc.lock:
                out.update(doc.doc_digest())
                cur = doc.replication_cursor
            if cur is not None:
                stream, lsn = decode_cursor(cur)
                out["stream"] = stream
                out["lsn"] = lsn
        return out

    def replReset(self, p):
        """Wipe and rebuild one replica document from a leader snapshot
        — the anti-entropy repair for a diverged copy. A catch-up
        snapshot alone cannot heal a replica holding EXTRA changes (CRDT
        merge is a union, it only ever adds), so the on-disk state is
        deleted and the doc re-opened empty before the leader's save is
        applied with its pinned cursor. The handle survives (same
        aliasing as ``durableReopen``); the leader's ship loop recovers
        from the cursor jump via its normal snapshot-resync fallback."""
        name = p["name"]
        res = self.durableReopen({"name": name, "wipe": True})
        h = res["doc"]
        doc = self._ensure_resident(h)
        if doc is None:
            doc = self._docs[h]
        n = len(doc._core.history)
        doc.apply_replicated_snapshot(
            base64.b64decode(p["snapshot"]), base64.b64decode(p["cursor"]))
        self._resync_mirror(name, doc, n)
        obs.count("cluster.repl_resets")
        out = {"reset": True, "lsn": int(p.get("lsn", 0))}
        try:
            out["digest"] = doc.doc_digest()["digest"]
        except Exception:  # noqa: BLE001 — digest echo is best-effort
            pass
        return out

    # -- role transitions ----------------------------------------------------

    def _become_leader(self, ack_replicas: int) -> int:
        """Flip to leader: fresh hub incarnation + warm-open. Returns
        the number of durable directories opened."""
        self.cluster_role = "leader"
        self.leader_hint = None
        with self._stale_lock:
            # follower-frame staleness state is meaningless once leading
            self._leader_clock = None
            self._fresh_at.clear()
            self._applied_lsn.clear()
        self.hub = ReplicationHub(self.node_id, ack_replicas=ack_replicas)
        self.on_durable_open = self._on_durable_open
        n = self._warm_open()
        # docs opened before the hub existed (or by a prior role) must
        # attach too — attach() is idempotent per name. Cold docs have
        # no live journal to hook; they attach lazily when an access
        # hydrates them (on_durable_open fires on the hydration path)
        with self._lock:
            named = list(self._durable_names.items())
        for name, h in named:
            doc = self._docs.get(h)
            if (
                doc is not None
                and hasattr(doc, "journal")
                and not getattr(doc, "_closed", False)
            ):
                self.hub.attach(name, doc)
        return n

    def clusterPromote(self, p):
        """Follower -> leader: mint a fresh hub incarnation, warm-open
        every durable directory, start serving client mutations. The
        caller (the router's failover monitor) picked this node as the
        longest durable acked prefix."""
        with self._role_lock:
            if self.cluster_role == "leader" and self.hub is not None:
                return {"promoted": False, "role": "leader",
                        "stream": self.hub.stream_id}
            n = self._become_leader(
                int(p.get("ackReplicas", self.cluster_ack_replicas)))
        obs.count("cluster.promotions")
        return {"promoted": True, "role": "leader",
                "stream": self.hub.stream_id, "docs": n}

    def clusterReplicateTo(self, p):
        """Leader: add a follower link (the post-promotion rewire the
        failover monitor drives, and the startup ``--replicate-to``)."""
        with self._role_lock:
            if self.hub is None:
                raise NotLeader("cannot replicate from a follower")
            self.hub.add_follower(p["addr"])
        return {"followers": sorted(self.hub.followers())}

    cluster_ack_replicas = 0  # default; ClusterNode sets from config

    def _on_durable_open(self, name, dd):
        if self.hub is not None:
            self.hub.attach(name, dd)

    def _warm_open(self) -> int:
        """Open (and attach) every durable directory under the serving
        dir — promotion and leader start must replicate docs that exist
        on disk but have no live client handle yet. A directory the
        durable layer refuses is counted and skipped; any other failure
        (the card's, the native library's) propagates."""
        n = 0
        if not self.durable_dir or not os.path.isdir(self.durable_dir):
            return n
        for entry in sorted(os.listdir(self.durable_dir)):
            path = os.path.join(self.durable_dir, entry)
            if not os.path.isdir(path):
                continue
            try:
                self.openDurable({"name": entry})
                n += 1
            except (JournalError, RunSnapError, AutomergeError, OSError) as e:
                # one bad directory, not all
                obs.count("cluster.warm_open_error", error=str(e)[:200])
        return n

    # -- live shard migration ------------------------------------------------

    def migrateOut(self, p):
        """Phase 1 of the handoff: a full snapshot pinned to an LSN,
        taken while the document keeps serving. The journal meta rides
        along (minus replication bookkeeping) so attached sync sessions
        resume on the target instead of renegotiating from nothing.

        A COLD document short-circuits all of that: its entire state IS
        the fsynced on-disk snapshot + journal tail, so the response
        ships those bytes verbatim (``cold: true``, tail records in
        ``data``) with no hydration and no residency rebuild — the cheap
        live-migration source rebalancing wants. The router re-runs this
        under the routing pause, making the cold bytes authoritative."""
        if self.hub is None:
            raise NotLeader("migration source must be a leader")
        name = p["name"]
        if self.store is not None and self.store.tier(name) == "cold":
            return self._migrate_out_cold(name)
        doc = self._repl_doc(name)  # ensure open + attached
        data, lsn = self.hub.snapshot(name)
        from ..storage.durable import REPL_META_PREFIX

        meta = {
            k: base64.b64encode(v).decode("ascii")
            for k, v in doc.meta.items()
            if not k.startswith(REPL_META_PREFIX)
        }
        snap_b64, codec = _wire_blob(data)
        return {
            "snapshot": snap_b64,
            **({"snapshotCodec": codec} if codec else {}),
            "lsn": lsn,
            "stream": self.hub.stream_id,
            "meta": meta,
        }

    def _migrate_out_cold(self, name: str):
        """Read a cold document's on-disk bytes for migration: snapshot
        file verbatim, journal change-records as the shipped tail, meta
        records latest-wins (minus replication bookkeeping). Read-only —
        the flock is free (the journal is closed) and the doc stays
        cold on this node throughout."""
        from ..storage.durable import (
            JOURNAL_NAME,
            REPL_META_PREFIX,
            SNAPSHOT_NAME,
        )
        from ..storage.journal import (
            REC_CHANGE,
            REC_META,
            decode_meta,
            scan_records,
        )

        path = self._durable_path(name)
        snap = b""
        sp = os.path.join(path, SNAPSHOT_NAME)
        if os.path.exists(sp):
            with open(sp, "rb") as f:
                snap = f.read()
        records = []
        meta = {}
        jp = os.path.join(path, JOURNAL_NAME)
        if os.path.exists(jp):
            with open(jp, "rb") as f:
                raw = f.read()
            recs, _tail = scan_records(raw)  # read-only torn-tail scan
            for r in recs:
                if r.rec_type == REC_CHANGE:
                    records.append((r.rec_type, r.payload))
                elif r.rec_type == REC_META:
                    mname, blob = decode_meta(r.payload)
                    if not mname.startswith(REPL_META_PREFIX):
                        meta[mname] = base64.b64encode(blob).decode("ascii")
        obs.count("cluster.migrate_cold_source")
        snap_b64, s_codec = _wire_blob(snap)
        data_b64, d_codec = _wire_blob(encode_batch(records))
        return {
            "snapshot": snap_b64,
            **({"snapshotCodec": s_codec} if s_codec else {}),
            "data": data_b64,
            **({"dataCodec": d_codec} if d_codec else {}),
            "lsn": -1,  # no live stream to pin; the router skips the tail
            "cold": True,
            "meta": meta,
        }

    def migrateTail(self, p):
        """Phase 2 (routing paused): the journal tail since the
        snapshot's LSN. Raises when the tail was trimmed — the router
        then repeats migrateOut under the pause."""
        if self.hub is None:
            raise NotLeader("migration source must be a leader")
        records, last, _traces = self.hub.tail_after(p["name"], int(p["since"]))
        data_b64, codec = _wire_blob(encode_batch(records))
        return {
            "data": data_b64,
            **({"dataCodec": codec} if codec else {}),
            "lsn": last,
        }

    def migrateIn(self, p):
        """Target side: snapshot + tail through the replicated-apply
        path (plus carried journal meta), then own the document as a
        normal leader doc (no cursor — it follows nobody). Also the
        post-promotion union sink: a replHarvest snapshot fed here
        merges any state the promoted leader was missing."""
        name = p["name"]
        doc = self._repl_doc(name)
        snap = _unwire_blob(p["snapshot"], p.get("snapshotCodec"))
        if snap:  # a cold source that never compacted ships no snapshot
            doc.apply_replicated_snapshot(snap, None)
        records = decode_batch(_unwire_blob(p.get("data"), p.get("dataCodec")))
        if records:
            doc.apply_replicated(records, None)
        meta = p.get("meta") or {}
        if meta:
            with doc.lock, doc.ack_scope():
                for k, blob in meta.items():
                    doc.set_meta(k, base64.b64decode(blob))
        obs.count("cluster.migrations_in")
        return {"heads": [base64.b64encode(h).decode("ascii")
                          for h in doc.get_heads()]}

    def migrateRelease(self, p):
        """Source side: drop the migrated document (close the journal,
        release the flock) after the router flipped routing."""
        name = p["name"]
        with self._lock:
            h = self._durable_names.get(name)
        if h is None:
            return {"released": False}
        if self.hub is not None:
            self.hub.detach(name)
        self.free({"doc": h})
        obs.count("cluster.migrations_out")
        return {"released": True}


class ReplCursorMismatch(Exception):
    """Follower journal cursor does not extend the shipped batch."""


class ClusterNode(SocketRpcServer):
    """A backend node process: socket server + role + replication."""

    def __init__(
        self,
        *,
        node_id: str,
        host: Optional[str] = None,
        port: int = 0,
        unix_path: Optional[str] = None,
        durable_dir: str,
        role: str = "leader",
        leader_addr: Optional[str] = None,
        replicate_to: Sequence[str] = (),
        ack_replicas: Optional[int] = None,
        workers: Optional[int] = None,
        device=None,
    ):
        if role not in ("leader", "follower"):
            raise ValueError(f"unknown cluster role {role!r}")
        rpc = ClusterRpcServer(durable_dir=durable_dir, node_id=node_id,
                               device=device)
        super().__init__(
            rpc, host=host, port=port, unix_path=unix_path, workers=workers,
            durable_dir=durable_dir, device=rpc.device,
        )
        # the A/B knob of the batched follower drain, read where the node
        # is built (the serving layer reads its batcher's knobs so too)
        self.repl_batch = os.environ.get("AUTOMERGE_TPU_REPL_BATCH", "1") != "0"
        if ack_replicas is None:
            try:
                ack_replicas = int(os.environ.get(
                    "AUTOMERGE_TPU_CLUSTER_ACK_REPLICAS", "0"))
            except ValueError:
                ack_replicas = 0
        rpc.cluster_ack_replicas = ack_replicas
        rpc.cluster_role = role
        rpc.leader_hint = leader_addr
        if role == "leader":
            # starting as leader is not a promotion — no counter
            rpc._become_leader(ack_replicas)
            for addr in replicate_to:
                rpc.clusterReplicateTo({"addr": addr})
        else:
            rpc._warm_open()

    # replication ingest serializes through one shard key (prefix-ordered
    # follower state); migration source methods take the migrated doc's
    # OWN shard key, so they execute after every write this node already
    # read for it — the tail a migrateTail ships really is the tail
    def _affinity(self, req: dict):
        method = req.get("method")
        if method in _REPL_METHODS:
            return REPL_SHARD_KEY
        if method in ("migrateOut", "migrateTail", "migrateRelease"):
            name = (req.get("params") or {}).get("name")
            if isinstance(name, str):
                with self.rpc._lock:
                    h = self.rpc._durable_names.get(name)
                if h is not None:
                    return h
        return super()._affinity(req)

    # -- batched follower apply ----------------------------------------------
    #
    # A drained grab of the replication shard's queue holds replApply
    # requests for MANY documents (the leader ships per doc, the pool
    # batches up to max_batch per grab). The old path replayed them
    # per-request and serially; now adjacent replApply frames coalesce
    # into one run: same-doc sub-runs share one ack scope (one fsync per
    # doc per drain instead of one per shipped batch), and every touched
    # device mirror's feed drains through ONE vectorized cross-doc
    # staging pass + shared launch (ops/host_batch.py) — the follower
    # applies at the same super-batch discipline as the serve drain, so
    # replication lag stops being the ceiling for follower reads.
    # ``AUTOMERGE_TPU_REPL_BATCH=0`` (``repl_batch``) forces the old
    # serial path (the bench / soak A/B knob): mirrors are not fed.

    def _coalesce_key(self, req):
        if req.get("method") == "replApply" and self.repl_batch:
            # every adjacent replApply frame coalesces regardless of its
            # target doc — the batched drain groups per doc itself
            return ("replApply",)
        return super()._coalesce_key(req)

    def _coalesce_single(self, req) -> bool:
        if req.get("method") == "replApply":
            return True
        return super()._coalesce_single(req)

    def _run_coalesced(self, run, out) -> None:
        if run[0][1].get("method") == "replApply":
            self._run_repl_apply(run, out)
            return
        super()._run_coalesced(run, out)

    def _run_repl_apply(self, run, out) -> None:
        rpc = self.rpc
        obs.observe("cluster.repl_apply_batch_size", len(run))
        if len(run) > 1:
            obs.count("rpc.coalesced", n=len(run),
                      labels={"method": "replApply"})
        # (doc, mirror, [changes], name, index of the request's answer)
        feeds: list = []

        def defer_feed(doc, dev, changes):
            # called inside rpc.handle for the sub-run of ``name``: the
            # answer lands at len(out)
            feeds.append((doc, dev, [changes], name, len(out)))

        i = 0
        while i < len(run):
            name = (run[i][1].get("params") or {}).get("name")
            j = i
            while (
                j + 1 < len(run)
                and (run[j + 1][1].get("params") or {}).get("name") == name
            ):
                j += 1
            group = run[i : j + 1]
            first = len(out)
            scope = None
            if len(group) > 1 and isinstance(name, str):
                # same-doc sub-run: one shared ack scope — the nested
                # apply_replicated scopes defer their fsync to this exit
                try:
                    doc = rpc._repl_doc(name)
                except Exception as e:
                    # the document cannot be opened (a refused directory,
                    # or its mirror's rebuild failing on the device): every
                    # request of the sub-run answers with the error
                    out.extend((c, {"id": r.get("id")}) for c, r in group)
                    self._run_error(out, first, "replApply", e)
                    i = j + 1
                    continue
                scope = getattr(doc, "ack_scope", None)
            rpc._repl_device_feed = defer_feed
            try:
                with scope() if scope is not None else (
                    contextlib.nullcontext()
                ):
                    for conn2, req2 in group:
                        out.append((conn2, rpc.handle(req2)))
            except Exception as e:  # the shared group fsync failed
                # an un-fsynced ack is no ack: convert the sub-run
                obs.count("rpc.errors", labels={
                    "method": "replApply", "type": type(e).__name__})
                err = {"type": type(e).__name__,
                       "message": f"replicated group commit failed: {e}"}
                retriable = getattr(e, "retriable", None)
                if retriable is None and isinstance(e, OSError):
                    retriable = True
                if retriable is not None:
                    err["retriable"] = bool(retriable)
                out[first:] = [
                    (c, r if "error" in r else {
                        "id": r.get("id"), "error": dict(err)})
                    for c, r in out[first:]
                ]
            finally:
                rpc._repl_device_feed = None
            i = j + 1
        if feeds:
            failed = self._feed_repl_mirrors(feeds)
            for _doc, dev, _b, _name, k in feeds:
                e = failed.get(id(dev))
                if e is None or "error" in out[k][1]:
                    continue
                # the change is journaled, its mirror's feed failed: the
                # request answers with the error instead of an ack
                c, r = out[k]
                obs.count("rpc.errors", labels={
                    "method": "replApply", "type": type(e).__name__})
                out[k] = (c, {"id": r.get("id"), "error": {
                    "type": type(e).__name__,
                    "message": f"replicated mirror feed failed: {e}",
                    "retriable": bool(getattr(e, "retriable", False))}})

    def _feed_repl_mirrors(self, feeds) -> dict:
        """One vectorized cross-doc staging pass + shared launch on the
        node's device for every device mirror the drained replApply run
        touched — the follower-side analogue of the serve drain's batcher
        feed. Returns the failures by ``id(mirror)``: a document's own
        staging error fails that document, a failed staging or launch
        every document fed. Each failed mirror is counted
        (``cluster.repl_device_feed_error``) and dropped (never serve a
        possibly part-updated resolution); its next use rebuilds it from
        the journaled history."""
        from ..ops import host_batch
        from ..ops.batched import resolve_stages

        docs = {}
        for doc, _dev, _b, _name, _k in feeds:
            docs.setdefault(id(doc), doc)
        try:
            with contextlib.ExitStack() as st:
                # deterministic multi-lock order; single-lock takers
                # (background compaction) cannot form a cycle with it
                for doc in sorted(
                    docs.values(),
                    key=lambda d: str(getattr(d, "path", "")),
                ):
                    st.enter_context(doc.lock)
                stages, results = host_batch.stage_docs(
                    [(dev, b) for _doc, dev, b, _name, _k in feeds]
                )
                failed = {
                    key: r.error for key, r in results.items()
                    if r.error is not None
                }
                live = [s for s in stages if id(s.doc) not in failed]
                if live:
                    resolve_stages(live, device=self.rpc.device)
        except Exception as e:
            # a failed staging or launch leaves every mirror fed here
            # possibly part-updated
            failed = {id(dev): e for _doc, dev, _b, _name, _k in feeds}
        # one error/drop per DOCUMENT: feeds holds one entry per
        # coalesced frame, and a 10-frame doc must not count 10
        # errors or drop its mirror 10 times
        dropped = set()
        for doc, dev, _b, name, _k in feeds:
            if id(dev) in failed and id(dev) not in dropped:
                dropped.add(id(dev))
                obs.count("cluster.repl_device_feed_error")
                obs.event("cluster.repl_device_feed_error",
                          doc=str(getattr(doc, "obs_name", "")),
                          error=str(failed[id(dev)])[:200])
                self._drop_failed_mirror(name, doc)
        return failed

    def _drop_failed_mirror(self, name, doc) -> None:
        """Drop a mirror whose feed failed, keeping no run image of its
        log. A stored document goes hot -> warm, so the store rebuilds
        the mirror from the history on the next access (the next
        replApply for it, or a read)."""
        with doc.lock:
            doc.drop_device_mirror(keep_image=False)
        store = self.rpc.store
        if store is not None and store.tier(name) == "hot":
            store.demote(name, "warm", reason="feed_error")

    def _stop_inner(self) -> None:
        hub = self.rpc.hub
        if hub is not None:
            hub.close()
        super()._stop_inner()
