"""Line-delimited JSON-RPC frontend over stdio: the second embedding
boundary.

The reference ships two FFI frontends: a C API and a wasm-bindgen module
whose role is to let ANOTHER language runtime (JS) drive documents through
a narrow marshalled surface (reference: rust/automerge-wasm/src/lib.rs:102-
1083 — the ~80-method Automerge class). This frontend plays that role for
any language with a subprocess + JSON: one request per line on stdin, one
response per line on stdout.

Protocol:
    -> {"id": 1, "method": "create", "params": {"actor": "<hex>"}}
    <- {"id": 1, "result": {"doc": 1}}
    -> {"id": 2, "method": "spliceText",
        "params": {"doc": 1, "obj": "1@..", "pos": 0, "del": 0, "text": "hi"}}
    <- {"id": 2, "result": null}
Errors come back as {"id": n, "error": {"type": "...", "message": "..."}}
and never kill the server. Bytes (saves, changes, sync messages, hashes)
travel base64. Values are JSON-native with two wrappers for types JSON
cannot express: {"$counter": n}, {"$timestamp": ms}, {"$bytes": "<b64>"};
object creation returns {"$obj": "<exid>", "type": "map|list|text"}.

Run: ``python -m automerge_tpu_torch.rpc`` (see tests/test_torch_rpc.py
for a full two-peer session driven from a separate process).

The device (the port's differences from the JAX package's frontend,
each on purpose):

* ``RpcServer(..., device=None)`` takes a torch device, the port's
  meaning of ``device`` everywhere: None is the card, and without a GPU
  the constructor raises instead of serving on the CPU. Every document
  the server creates, loads, forks or opens lives on it, and so does
  every resident mirror. ``python -m automerge_tpu_torch.rpc --device
  cpu`` serves the plain PyTorch path; without ``--device`` it serves
  the card.
* The wire keeps ``openDurable {"device": true}``: "also keep a
  resident ``DeviceDoc``". It becomes ``mirror=True`` in
  ``AutoDoc.open`` and ``DocStore.admit(name, dd, mirror=...)``, on the
  server's device, so clients do not change.
* A failed feed of a resident mirror (``receiveSyncMessage``) and a
  failed promotion (``_store_build_device``) are counted as the
  reference counts them (``sync.device_feed_error``,
  ``store.promote_error``) and then propagate: the request answers with
  the error instead of a silent success.
* ``profileStart`` / ``profileStop`` drive a ``torch.profiler`` capture
  (``prof.torch_profile_start`` / ``torch_profile_stop``).
* ``main``'s cluster mode (``--node-id``, ``--replicate-to``,
  ``--follow`` with ``--socket`` and ``--durable``) runs a
  ``cluster.ClusterNode`` on ``--device`` (the card by default).

Robustness: every malformed frame (bad JSON, unknown method, oversized
request, undecodable base64) answers with an ``error`` response; EOF —
even mid-request — is a clean shutdown. ``configure`` sets
``maxRequestBytes`` and ``syncTimeoutMs``; the ``syncSession*`` methods
expose the resilient retry/backoff/reset sync sessions (sync/session.py)
for lossy client links, and ``load`` accepts ``onError: "salvage"`` to
recover damaged saves (the response then carries a ``salvage`` report).

Durability: ``python -m automerge_tpu_torch.rpc --durable DIR`` enables
``openDurable {"name": ...}`` — each named document persists under
``DIR/<name>`` through the crash-safe journal + snapshot layer
(storage/durable.py), so every committed or sync-absorbed change is on
disk before the response goes out; ``durableInfo`` / ``durableCompact``
expose the journal state.

Concurrency: ``--socket HOST:PORT`` / ``--unix PATH`` serve the same
protocol concurrently (serve/server.py) — per-document single-writer
shards, bounded queues with a ``Backpressure`` error, group-commit
durable acks, coalesced sync receives. The stdio mode here stays a
strictly serial single-client loop.

Observability: every request is counted and timed into the labeled
metrics registry (``rpc.request{method=...}`` latency histograms,
``rpc.bytes_in``/``rpc.bytes_out``, ``rpc.errors{method=,type=}``,
``rpc.request_bytes``), and the ``metrics`` method returns the whole
registry — Prometheus text by default, ``{"format": "json"}`` for the
structured snapshot — so an operator can scrape a running server over
the same stdio channel.
"""

from __future__ import annotations

import base64
import json
import os
import sys
import threading
import time
from typing import Dict, Optional

from . import obs
from .api import AutoDoc
from .degrade import brownout_active
from .device import resolve_device
from .obs import heat as _heat
from .sync import SessionConfig, SyncSession, SyncState
from .types import ActorId, ObjType, ScalarValue

# default per-request line limit: large enough for multi-megabyte base64
# saves, small enough that a hostile or broken client cannot buffer-bomb
# the process — serve() reads each line with a bounded readline(limit), so
# an endless newline-free stream is discarded in bounded chunks instead of
# being buffered whole (configurable via the ``configure`` method)
DEFAULT_MAX_REQUEST_BYTES = 32 << 20
DEFAULT_SYNC_TIMEOUT_MS = 5000

# durable doc names become directory names under --durable DIR: one safe
# path component, no leading dot
import re as _re

_DURABLE_NAME_RE = _re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

_OBJTYPES = {"map": ObjType.MAP, "list": ObjType.LIST, "text": ObjType.TEXT,
             "table": ObjType.TABLE}


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode("ascii")


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def _to_scalar(v) -> ScalarValue:
    """JSON value -> ScalarValue (wrappers for counter/timestamp/bytes)."""
    if isinstance(v, dict):
        if "$counter" in v:
            return ScalarValue("counter", int(v["$counter"]))
        if "$timestamp" in v:
            return ScalarValue("timestamp", int(v["$timestamp"]))
        if "$bytes" in v:
            return ScalarValue("bytes", _unb64(v["$bytes"]))
        raise ValueError(f"unsupported value wrapper {sorted(v)}")
    if v is None:
        return ScalarValue("null")
    if isinstance(v, bool):
        return ScalarValue("bool", v)
    if isinstance(v, int):
        return ScalarValue("int", v)
    if isinstance(v, float):
        return ScalarValue("f64", v)
    if isinstance(v, str):
        return ScalarValue("str", v)
    raise ValueError(f"unsupported value type {type(v).__name__}")


def _from_rendered(rendered, exid, doc) -> object:
    """(kind, payload) from doc.get/get_all -> JSON value."""
    kind = rendered[0]
    if kind == "obj":
        t = doc.object_type(exid)
        return {"$obj": exid, "type": t.name.lower()}
    if kind == "counter":
        return {"$counter": int(rendered[1])}
    sv = rendered[1]
    if sv.tag == "bytes":
        return {"$bytes": _b64(sv.value)}
    if sv.tag == "timestamp":
        return {"$timestamp": int(sv.value)}
    if sv.tag == "counter":
        return {"$counter": int(sv.value)}
    if sv.tag == "null":
        return None
    if sv.tag == "unknown":
        return {"$bytes": _b64(bytes(sv.value[1]))}
    return sv.value


class _StoreOps:
    """The tier-transition mechanics the DocStore delegates back to the
    serving layer (store/docstore.py owns policy + bookkeeping only)."""

    __slots__ = ("_rpc",)

    def __init__(self, rpc: "RpcServer"):
        self._rpc = rpc

    def open_cold(self, name):
        return self._rpc._store_open_cold(name)

    def close_cold(self, name, compact):
        return self._rpc._store_close_cold(name, compact=compact)

    def drop_device(self, name):
        return self._rpc._store_drop_device(name)

    def build_device(self, name):
        return self._rpc._store_build_device(name)


class DeadlineExceeded(Exception):
    """The client's ``deadlineMs`` budget expired before the server
    reached this stage — the request was answered WITHOUT executing the
    mutation (the client already gave up; doing the work anyway only
    deepens the overload). Always retriable: the client may still want
    the operation under a fresh budget."""

    retriable = True


def request_expired(req: dict) -> bool:
    """True when the request carried ``deadlineMs`` and its stamped
    local expiry (see ``_parse_line``) has passed."""
    dl = req.get("_deadline_ts")
    return dl is not None and obs.now() >= dl


def deadline_response(rid, method: str, stage: str) -> dict:
    """The ``DeadlineExceeded`` answer for one expired request, counted
    per enforcement stage (``serve.deadline_expired{stage}``)."""
    obs.count("serve.deadline_expired", labels={"stage": stage})
    obs.count("rpc.errors", labels={"method": method or "unknown",
                                    "type": "DeadlineExceeded"})
    return {"id": rid, "error": {
        "type": "DeadlineExceeded",
        "message": f"client deadline expired before {stage}",
        "retriable": True,
    }}


class RpcServer:
    """One frontend session: documents + sync states by integer handle,
    every document on ``device`` (None: the card)."""

    def __init__(
        self,
        max_request_bytes: int = DEFAULT_MAX_REQUEST_BYTES,
        sync_timeout_ms: int = DEFAULT_SYNC_TIMEOUT_MS,
        durable_dir: Optional[str] = None,
        device=None,
    ):
        # where every document and mirror of this server lives; raises
        # here, before any state exists, when the card is asked for and
        # no GPU is present
        self.device = resolve_device(device)
        self._docs: Dict[int, AutoDoc] = {}
        self._syncs: Dict[int, SyncState] = {}
        self._sessions: Dict[int, SyncSession] = {}
        self._patched = set()  # docs with an activated patch cursor
        self._next = 1
        self.max_request_bytes = max_request_bytes
        self.sync_timeout_ms = sync_timeout_ms
        # --durable DIR mode: named documents persist under DIR/<name> via
        # the crash-safe journal + snapshot layer (storage/durable.py)
        self.durable_dir = durable_dir
        self._durable_names: Dict[str, int] = {}  # name -> open handle
        # handle-table guard: the socket serving layer (serve/) registers
        # and frees handles from many threads; stdio mode pays one
        # uncontended RLock acquisition per registration
        self._lock = threading.RLock()
        # session handle -> doc handle, so the serving layer can route
        # session-only requests (poll/receive/stats) to the doc's shard
        self._session_docs: Dict[int, int] = {}
        # (doc handle, peer) -> session handle for syncSessionAttach
        # idempotency within one server incarnation
        self._attached_sessions: Dict = {}
        # set by SocketRpcServer: durable docs opened through a concurrent
        # server compact on a background thread instead of the ack path
        self.serve_background_compact = False
        # cluster hook (cluster/node.py): called with (name, durable_doc)
        # after every FRESH openDurable, so a leader's replication hub
        # starts shipping the document's journal the moment it exists
        self.on_durable_open = None
        # serializes the name-cache check against the filesystem open,
        # PER NAME: a cluster node's replication path opens docs OUTSIDE
        # the serving layer's openDurable queue, and two concurrent
        # opens of one name would race each other onto the same journal
        # flock — but a slow open (multi-second journal replay) of one
        # document must not head-of-line-block opens of every other
        self._open_locks: Dict[str, threading.Lock] = {}
        # chaos mode (AUTOMERGE_TPU_CHAOS=1): durable docs open through a
        # per-doc FaultyFS so the chaosDisk method can deal a RUNNING
        # journal ENOSPC on append / EIO on fsync. Off (the default) the
        # injection surface does not exist at all.
        self.chaos_enabled = os.environ.get("AUTOMERGE_TPU_CHAOS") == "1"
        self._chaos_fs: Dict[str, object] = {}  # doc name -> FaultyFS
        # tiered residency (store/): every named durable document this
        # server serves is tracked in the DocStore, which demotes idle
        # documents hot -> warm -> cold under the configured budgets and
        # hydrates cold ones lazily on access. Unconfigured budgets (the
        # default) make it pure bookkeeping — nothing is ever demoted.
        self.store = None
        self._handle_names: Dict[int, str] = {}  # doc handle -> durable name
        # overload resilience: deadline enforcement shares the admission
        # master switch (AUTOMERGE_TPU_ADMISSION=0 is the uncontrolled
        # baseline the overload bench compares against). The serving
        # layer installs its AdmissionController here so cluster status
        # can advertise shed-mode.
        self.deadlines_enabled = (
            os.environ.get("AUTOMERGE_TPU_ADMISSION", "1") != "0")
        self.admission = None
        # integrity scrubber (integrity.py): the serving layer installs
        # and starts one per server; scrubNow lazily builds it so tests
        # and CI can force a round on a bare RpcServer too
        self.scrubber = None
        if durable_dir is not None:
            from .store import DocStore

            self.store = DocStore(_StoreOps(self))

    # -- handle plumbing ----------------------------------------------------

    def _reg(self, table, value) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            table[h] = value
        return h

    def _doc(self, p) -> AutoDoc:
        doc = self._docs.get(p["doc"])
        if doc is None:
            raise ValueError(f"invalid doc handle {p.get('doc')}")
        if getattr(doc, "_closed", False) and self.store is not None:
            # a cold-demoted document: hydrate it (single-flight, inside
            # this doc's ordered queue) before serving the request
            doc = self._ensure_resident(p["doc"])
        touch = getattr(doc, "touch", None)
        if touch is not None and not brownout_active():
            # read-path recency: without this a read-hot document looks
            # idle to the store's LRU policy (writes refresh at ack exit,
            # reads previously refreshed nothing). In brownout the skip
            # is deliberate: reads and generateSyncMessage serve from
            # the resident image without recency churn — LRU precision
            # is what the degraded mode trades for capacity.
            touch()
            if self.store is not None:
                self.store.touch(self._handle_names.get(p["doc"], ""))
        return doc

    def _ensure_resident(self, h):
        """The document behind handle ``h``, hydrated if it was demoted
        to cold (may raise the retriable ``StoreBackpressure`` past the
        store's concurrent-hydration bound). None for unknown handles."""
        doc = self._docs.get(h)
        if (
            doc is not None
            and getattr(doc, "_closed", False)
            and self.store is not None
        ):
            name = self._handle_names.get(h)
            if name is not None:
                doc = self.store.ensure_open(name)
        return doc

    def _heads(self, p, key="heads"):
        hs = p.get(key)
        return None if hs is None else [_unb64(h) for h in hs]

    # -- methods (wasm lib.rs surface, JSON-shaped) -------------------------

    def create(self, p):
        actor = bytes.fromhex(p["actor"]) if p.get("actor") else None
        doc = AutoDoc(
            actor=ActorId(actor) if actor else None,
            text_encoding=p.get("textEncoding"),
            device=self.device,
        )
        return {"doc": self._reg(self._docs, doc)}

    def load(self, p):
        doc = AutoDoc.load(
            _unb64(p["data"]),
            text_encoding=p.get("textEncoding"),
            on_error=p.get("onError"),
            device=self.device,
        )
        out = {"doc": self._reg(self._docs, doc)}
        rep = doc.salvage_report
        if rep is not None:
            out["salvage"] = {
                "appliedChunks": rep.applied_chunks,
                "dropped": [
                    {"offset": d.offset, "reason": d.reason,
                     "checksum": _b64(d.checksum)}
                    for d in rep.dropped
                ],
            }
        return out

    def configure(self, p):
        """Runtime knobs: syncTimeoutMs (resilient sync sessions' base
        retransmit timeout), maxRequestBytes (per-line request limit)."""
        if "syncTimeoutMs" in p:
            v = int(p["syncTimeoutMs"])
            if v <= 0:
                raise ValueError("syncTimeoutMs must be positive")
            self.sync_timeout_ms = v
        if "maxRequestBytes" in p:
            v = int(p["maxRequestBytes"])
            if v <= 0:
                raise ValueError("maxRequestBytes must be positive")
            self.max_request_bytes = v
        return {"syncTimeoutMs": self.sync_timeout_ms,
                "maxRequestBytes": self.max_request_bytes}

    def free(self, p):
        with self._lock:
            doc = self._docs.pop(p["doc"], None)
            self._patched.discard(p["doc"])
            # sessions attached to this doc die with it: they hold the
            # (soon-closed) durable wrapper, and a long-lived server that
            # re-attaches per restart/failover must not leak them
            stale = [h for (d, _peer), h in self._attached_sessions.items()
                     if d == p["doc"]]
            for h in stale:
                self._sessions.pop(h, None)
                self._session_docs.pop(h, None)
            self._attached_sessions = {
                k: h for k, h in self._attached_sessions.items()
                if k[0] != p["doc"]
            }
            name = None
            if doc is not None and hasattr(doc, "journal"):  # durable wrapper
                # drop the name mapping BEFORE closing: if close raises,
                # the name must not stay pointed at a dead handle
                self._durable_names = {
                    n: h for n, h in self._durable_names.items()
                    if h != p["doc"]
                }
                name = self._handle_names.pop(p["doc"], None)
        if doc is not None and hasattr(doc, "journal"):
            if self.store is not None and name is not None:
                self.store.forget(name)
            doc.close()
        # cardinality hygiene: the shard pool keys this doc's queue by
        # its integer handle — drop the rpc.queue_depth{doc=<handle>}
        # series along with the per-doc gauges (handles are unbounded
        # over a server's life; the gauge table must not be)
        obs.remove_doc_gauges(name, queue_key=p.get("doc"))
        return None

    # -- durable documents (--durable DIR mode) -----------------------------

    def _durable_path(self, name: str) -> str:
        import os

        if self.durable_dir is None:
            raise ValueError("server is not running in --durable mode")
        if not isinstance(name, str) or not _DURABLE_NAME_RE.match(name):
            raise ValueError(f"invalid durable doc name {name!r}")
        return os.path.join(self.durable_dir, name)

    def openDurable(self, p):
        """Open (or create) the named durable document under the server's
        --durable directory; reopening an already-open name returns the
        same handle (two live journals on one file would corrupt it).
        ``device: true`` additionally recovers a resident DeviceDoc whose
        incremental path absorbs sync-received changes (``mirror=True``
        on the server's device)."""
        name = p.get("name")
        path = self._durable_path(name)
        with self._lock:
            lk = self._open_locks.setdefault(name, threading.Lock())
        with lk:
            return self._open_durable_locked(name, path, p)

    def _open_durable_locked(self, name, path, p):
        # the name-cache read and the live-handle check must be one
        # atomic snapshot: a concurrent free() pops both under this lock,
        # so we either see the live doc or neither — never a handle whose
        # journal a racing free is mid-close on
        with self._lock:
            h = self._durable_names.get(name)
            live = self._docs.get(h) if h is not None else None
        if live is not None:
            # a cached handle must not silently override the caller's
            # requested durability: error on a policy mismatch
            want = p.get("fsync")  # omitted = don't-care, like textEncoding
            if want is not None and want != live.journal.fsync_policy:
                raise ValueError(
                    f"durable doc {name!r} is already open with "
                    f"fsync={live.journal.fsync_policy!r}, not {want!r}"
                )
            want_enc = p.get("textEncoding")
            # normalize: a doc opened without an explicit encoding stores
            # None, which MEANS the process default — not a conflict with
            # a client naming that same default explicitly
            from .types import get_text_encoding

            have_enc = live.doc.text_encoding or get_text_encoding()
            if want_enc is not None and want_enc != have_enc:
                raise ValueError(
                    f"durable doc {name!r} is already open with "
                    f"textEncoding={have_enc!r}, not {want_enc!r}"
                )
            # a cold doc's handle answers without hydrating — residency
            # is paid on first real access, not on re-open
            if self.store is not None:
                self.store.touch(name)
            return {"doc": h}
        open_kw = {}
        if self.chaos_enabled:
            from .storage.crashsim import FaultyFS

            fs = self._chaos_fs.get(name)
            if fs is None:
                fs = self._chaos_fs[name] = FaultyFS()
            open_kw["fs"] = fs
        dd = AutoDoc.open(
            path,
            fsync=p.get("fsync", "always"),
            text_encoding=p.get("textEncoding"),
            mirror=bool(p.get("device", False)),
            device=self.device,
            background_compact=self.serve_background_compact,
            compact_cost_ratio=float(
                os.environ.get("AUTOMERGE_TPU_COMPACT_COST_RATIO", "0") or 0
            ),
            **open_kw,
        )
        h = self._reg(self._docs, dd)
        with self._lock:
            self._durable_names[name] = h
            self._handle_names[h] = name
        if self.on_durable_open is not None:
            self.on_durable_open(name, dd)
        if self.store is not None:
            self.store.admit(name, dd, mirror=bool(p.get("device", False)))
        return {"doc": h}

    def _durable_doc(self, p):
        doc = self._doc(p)
        if not hasattr(doc, "journal"):
            raise ValueError(f"doc handle {p.get('doc')} is not durable")
        return doc

    def durableCompact(self, p):
        doc = self._durable_doc(p)
        compacted = doc.compact()
        return {"compacted": compacted,
                "journalRecords": doc.journal.record_count}

    def durableInfo(self, p):
        doc = self._durable_doc(p)
        img = getattr(doc, "_run_image", None)
        return {
            "path": doc.path,
            "journalRecords": doc.journal.record_count,
            "journalBytes": doc.journal.size_bytes,
            "fsync": doc.journal.fsync_policy,
            "degraded": doc.degraded,
            "poisoned": doc.journal.poisoned_reason,
            # run-coded persistence surface: which codec the doc's
            # snapshot/image currently speaks, and the retained image's
            # host footprint (0 = legacy/chunk, no image retained)
            "snapshotCodec": "runsnap" if img is not None else "chunk",
            "runImageBytes": 0 if img is None else img.nbytes,
        }

    def durableReopen(self, p):
        """Close and re-open a named durable document in place — the
        operator recovery path for a doc degraded by a live disk fault
        (a poisoned journal re-acquires its file and flock; recovery
        replays snapshot + intact journal prefix). The handle is
        preserved, so clients holding it keep working; sessions attached
        to the old incarnation are dropped exactly as ``free`` drops
        them (re-attach resumes via the epoch handshake)."""
        name = p.get("name")
        path = self._durable_path(name)
        with self._lock:
            lk = self._open_locks.setdefault(name, threading.Lock())
        with lk:
            with self._lock:
                h = self._durable_names.get(name)
                old = self._docs.get(h) if h is not None else None
                # unmap the NAME (so the open below builds a fresh doc)
                # but keep the handle pointing at the old instance for
                # the whole reopen window: a concurrent request on it
                # answers with the doc's own (retriable) degraded error
                # rather than a bogus invalid-handle
                self._durable_names.pop(name, None)
            if old is not None:
                try:
                    old.close()
                except Exception as e:  # noqa: BLE001 — a degraded doc's
                    # close may trip on its own poisoned journal; the
                    # reopen below re-establishes a clean state anyway
                    obs.count("rpc.reopen_close_error", error=str(e)[:200])
            if p.get("wipe"):
                # the replica-reset path (anti-entropy repair of a
                # diverged copy): the fresh open must rebuild from
                # nothing — salvaging the old bytes would keep the very
                # corruption the reset is meant to remove
                from .storage.durable import JOURNAL_NAME, SNAPSHOT_NAME

                for fname in (SNAPSHOT_NAME, JOURNAL_NAME):
                    try:
                        os.remove(os.path.join(path, fname))
                    except OSError:
                        pass
            try:
                res = self._open_durable_locked(name, path, p)
            except Exception:
                # reopen failed (e.g. the disk fault is still live):
                # restore the name mapping so the doc stays addressable
                # (still degraded) and a later reopen can retry
                if h is not None:
                    with self._lock:
                        self._durable_names[name] = h
                raise
            new_h = res["doc"]
            with self._lock:
                if h is not None and new_h != h:
                    # preserve the caller's existing handle: alias it to
                    # the fresh doc and retire the transient handle the
                    # open minted (nobody ever saw it)
                    self._docs[h] = self._docs.pop(new_h)
                    self._durable_names[name] = h
                    self._handle_names.pop(new_h, None)
                    self._handle_names[h] = name
                    new_h = h
                # sessions attached to the old incarnation die with it
                # (re-attach resumes via the epoch handshake)
                if h is not None:
                    stale = [
                        sh for (d, _peer), sh in self._attached_sessions.items()
                        if d == h
                    ]
                    for sh in stale:
                        self._sessions.pop(sh, None)
                        self._session_docs.pop(sh, None)
                    self._attached_sessions = {
                        k: v for k, v in self._attached_sessions.items()
                        if k[0] != h
                    }
            obs.count("rpc.durable_reopens")
            return {"doc": new_h, "reopened": True}

    def chaosDisk(self, p):
        """Chaos-only fault injection (requires AUTOMERGE_TPU_CHAOS=1 in
        the server's environment): arm or clear a live disk fault on the
        named durable document's filesystem. ``op`` is one of write /
        truncate / fsync / replace / sync_dir / read; ``err`` an errno
        name (EIO, ENOSPC) or — for ``read`` only — ``BITFLIP``, which
        silently corrupts one bit of the bytes read instead of raising
        (the bit-rot model the integrity scrub exists to catch);
        ``count`` how many calls fail (-1 = until cleared);
        ``clear: true`` disarms (``op`` optional)."""
        if not self.chaos_enabled:
            raise ValueError(
                "chaosDisk requires AUTOMERGE_TPU_CHAOS=1 in the server "
                "environment"
            )
        name = p.get("name")
        fs = self._chaos_fs.get(name)
        if fs is None:
            raise ValueError(f"no chaos-wrapped durable doc {name!r} open")
        if p.get("clear"):
            fs.clear(p.get("op"))
        else:
            fs.arm(p["op"], p.get("err", "EIO"), int(p.get("count", -1)))
        return {"armed": {op: list(v) for op, v in fs.armed().items()}}

    def docDigest(self, p):
        """The verifiable state digest of one document: SHA-256 over
        (change-hash XOR accumulator, change count, sorted heads) —
        identical across residency modes and merge orders, so two nodes
        agree iff they hold the same state (integrity.py). Address by
        durable ``name`` (hydrates a cold doc; errors on names with no
        on-disk directory) or by ``doc`` handle."""
        name = p.get("name")
        if name is not None:
            path = self._durable_path(name)
            with self._lock:
                known = self._durable_names.get(name) is not None
            if not known and not os.path.isdir(path):
                raise ValueError(f"unknown durable doc {name!r}")
            h = self.openDurable({"name": name})["doc"]
            doc = self._ensure_resident(h)
            if doc is None:
                doc = self._docs[h]
        else:
            doc = self._doc(p)
        if hasattr(doc, "doc_digest"):
            return dict(doc.doc_digest())
        from . import integrity

        core = doc.doc if hasattr(doc, "doc") else doc
        return dict(integrity.doc_digest(core))

    def scrubNow(self, p):
        """Force one synchronous scrub round (integrity.Scrubber) and
        return its summary — the deterministic hook CI smokes use
        instead of sleeping out the background cadence."""
        s = self.scrubber
        if s is None:
            from .integrity import Scrubber

            s = self.scrubber = Scrubber(self)
        return s.run_round()

    # -- tiered residency mechanics (store/docstore.py drives these) ---------

    def _store_doc(self, name: str):
        """(handle, live durable doc) for a store transition; raises for
        unknown or already-cold names."""
        with self._lock:
            h = self._durable_names.get(name)
            dd = self._docs.get(h) if h is not None else None
        if h is None or dd is None or not hasattr(dd, "journal"):
            raise ValueError(f"durable doc {name!r} is not open")
        return h, dd

    def _store_open_cold(self, name: str):
        """Hydrate a cold document: reopen its directory through the
        standard warm-recovery path (salvage snapshot load + journal
        replay) and alias the existing client handle to the fresh
        instance. Runs under the store's per-doc single-flight lock."""
        h, ref = self._store_doc(name)
        path = self._durable_path(name)
        open_kw = {}
        if self.chaos_enabled:
            from .storage.crashsim import FaultyFS

            fs = self._chaos_fs.get(name)
            if fs is None:
                fs = self._chaos_fs[name] = FaultyFS()
            open_kw["fs"] = fs
        dd = AutoDoc.open(
            path,
            fsync=getattr(ref, "fsync_policy", "always"),
            text_encoding=getattr(ref, "text_encoding", None),
            mirror=False,  # cold hydrates to WARM; hot is a promotion
            device=self.device,
            background_compact=self.serve_background_compact,
            compact_cost_ratio=float(
                os.environ.get("AUTOMERGE_TPU_COMPACT_COST_RATIO", "0") or 0
            ),
            **open_kw,
        )
        with self._lock:
            self._docs[h] = dd
        if self.on_durable_open is not None:
            # replication: the hub reattaches the fresh journal in place
            # (followers whose cursors name the old stream resync via the
            # cursor-mismatch snapshot path)
            self.on_durable_open(name, dd)
        return dd

    def _store_close_cold(self, name: str, *, compact: bool = True):
        """Demote to cold: optionally compact (bounding the hydration
        replay), close the journal (flock released), drop the sessions
        attached to the document (clients re-attach; the epoch handshake
        resumes them, exactly as after ``durableReopen``), and leave a
        ``ColdDocRef`` placeholder on the handle so the materialized
        document — host op-store, device mirror, journal buffers — is
        garbage the moment the last request drains."""
        from .store import ColdDocRef

        h, dd = self._store_doc(name)
        if getattr(dd, "_closed", False):
            return dd  # already cold
        hub = getattr(self, "hub", None)
        if hub is not None:
            # a live stream must not keep shipping (or referencing) a
            # journal that is about to close; hydration re-attaches
            try:
                hub.detach(name)
            except Exception as e:  # noqa: BLE001 — demotion must win
                obs.count("store.demote_error", error=str(e)[:200])
        with dd.lock:
            if compact and not dd.degraded:
                dd.compact()
            dd.close()
            acked, appended = dd.acked_prefix()
            ref = ColdDocRef(
                name,
                fsync_policy=dd.journal.fsync_policy,
                text_encoding=dd._core.text_encoding,
                acked=acked,
                appended=appended,
                replication_cursor=dd.replication_cursor,
            )
        with self._lock:
            # every session holding the closed instance dies with it —
            # feeding a closed journal would poison-error the client
            stale = [sh for sh, d in self._session_docs.items() if d == h]
            for sh in stale:
                self._sessions.pop(sh, None)
                self._session_docs.pop(sh, None)
            self._attached_sessions = {
                k: v for k, v in self._attached_sessions.items()
                if k[0] != h
            }
            self._docs[h] = ref
        # dd.close() above already removed the per-doc gauges; the shard
        # queue's depth series is keyed by handle and needs its own drop
        obs.remove_doc_gauges(None, queue_key=h)
        return ref

    def _store_drop_device(self, name: str) -> None:
        """Demote hot -> warm: release the device mirror and detach it
        from live sessions (which would otherwise keep feeding — and
        keeping alive — the dropped arrays)."""
        h, dd = self._store_doc(name)
        with dd.lock:
            dev = dd.drop_device_mirror()
        if dev is not None:
            with self._lock:
                for sh, d in self._session_docs.items():
                    if d == h:
                        sess = self._sessions.get(sh)
                        if sess is not None:
                            sess.device_doc = None

    def _store_build_device(self, name: str) -> bool:
        """Promote warm -> hot: rebuild the device mirror and hand it to
        the document's live sessions. A failed build is counted
        (``store.promote_error``) and propagates: the request that
        touched the document answers with the error."""
        h, dd = self._store_doc(name)
        try:
            dev = dd.build_device_mirror()
        except Exception as e:
            obs.count("store.promote_error", error=str(e)[:200])
            raise
        with self._lock:
            for sh, d in self._session_docs.items():
                if d == h:
                    sess = self._sessions.get(sh)
                    if sess is not None:
                        sess.device_doc = dev
        return True

    def storeStatus(self, p):
        """Tier population, budgets and process RSS; ``{"docs": true}``
        adds per-document tier/idle/footprint detail."""
        if self.store is None:
            raise ValueError("server is not running in --durable mode")
        return self.store.status(docs=bool(p.get("docs")))

    def storeDemote(self, p):
        """Explicitly demote a named document (``to``: "warm" or
        "cold") — the operator/CI surface over the same transition the
        LRU policy drives."""
        if self.store is None:
            raise ValueError("server is not running in --durable mode")
        name = p.get("name")
        if not isinstance(name, str):
            raise ValueError("storeDemote requires a doc name")
        tier = self.store.demote(name, p.get("to", "cold"))
        return {"name": name, "tier": tier}

    def close_durables(self) -> None:
        """Flush and close every open durable document (their close()
        commits pending autocommit edits and releases the journal locks);
        serve() calls this on every exit path. Cold documents are
        already closed — their placeholder's close() is a no-op."""
        if self.store is not None:
            self.store.close()  # stop the eviction sweeper first
        with self._lock:
            self._durable_names.clear()
            self._handle_names.clear()
            durable = [
                (h, doc) for h, doc in self._docs.items()
                if hasattr(doc, "journal")
            ]
            for h, _ in durable:
                self._docs.pop(h, None)
        for _, doc in durable:
            try:
                doc.close()
            except Exception:
                pass  # shutdown must not die half-way through the list

    def fork(self, p):
        doc = self._doc(p)
        actor = bytes.fromhex(p["actor"]) if p.get("actor") else None
        heads = self._heads(p)
        forked = (
            doc.fork_at(heads, actor=ActorId(actor) if actor else None)
            if heads is not None
            else doc.fork(actor=ActorId(actor) if actor else None)
        )
        return {"doc": self._reg(self._docs, forked)}

    def actor(self, p):
        return self._doc(p).get_actor().bytes.hex()

    def heads(self, p):
        return [_b64(h) for h in self._doc(p).get_heads()]

    def docFence(self, p):
        """Affinity-matched no-op: routed through the document's shard
        queue like any other ``doc`` request, so its response proves
        every frame pipelined ahead of it has fully executed (the
        router's migration fence). Deliberately does NOT touch the
        document — fencing a cold doc must not hydrate it."""
        if p.get("doc") not in self._docs:
            raise ValueError(f"invalid doc handle {p.get('doc')}")
        return None

    def commit(self, p):
        h = self._doc(p).commit(message=p.get("message"))
        return _b64(h) if h is not None else None

    def save(self, p):
        return _b64(self._doc(p).save())

    def saveIncremental(self, p):
        return _b64(self._doc(p).save_incremental_after(self._heads(p) or []))

    def applyChanges(self, p):
        self._doc(p).load_incremental(_unb64(p["data"]), on_partial="error")
        return None

    def merge(self, p):
        # the merge source may be cold too: hydrate it like the target
        other = self._ensure_resident(p["other"])
        if other is None:
            raise ValueError(f"invalid doc handle {p.get('other')}")
        return [_b64(h) for h in self._doc(p).merge(other)]

    # mutation
    def put(self, p):
        self._doc(p).put(p["obj"], p["prop"], _to_scalar(p["value"]))
        return None

    def putObject(self, p):
        exid = self._doc(p).put_object(p["obj"], p["prop"], _OBJTYPES[p["type"]])
        return {"$obj": exid, "type": p["type"]}

    def insert(self, p):
        self._doc(p).insert(p["obj"], p["index"], _to_scalar(p["value"]))
        return None

    def insertObject(self, p):
        exid = self._doc(p).insert_object(p["obj"], p["index"], _OBJTYPES[p["type"]])
        return {"$obj": exid, "type": p["type"]}

    def delete(self, p):
        self._doc(p).delete(p["obj"], p.get("prop", p.get("index")))
        return None

    def increment(self, p):
        self._doc(p).increment(p["obj"], p.get("prop", p.get("index")), p["by"])
        return None

    def spliceText(self, p):
        self._doc(p).splice_text(p["obj"], p["pos"], p.get("del", 0), p.get("text", ""))
        return None

    def mark(self, p):
        self._doc(p).mark(
            p["obj"], p["start"], p["end"], p["name"], p["value"],
            expand=p.get("expand", "after"),
        )
        return None

    def unmark(self, p):
        self._doc(p).unmark(p["obj"], p["start"], p["end"], p["name"])
        return None

    # reads (all honor optional historical heads)
    def get(self, p):
        doc = self._doc(p)
        got = doc.get(p["obj"], p.get("prop", p.get("index")), heads=self._heads(p))
        return None if got is None else _from_rendered(got[0], got[1], doc)

    def getAll(self, p):
        doc = self._doc(p)
        return [
            _from_rendered(r, e, doc)
            for r, e in doc.get_all(p["obj"], p.get("prop", p.get("index")),
                                    heads=self._heads(p))
        ]

    def keys(self, p):
        return self._doc(p).keys(p["obj"], heads=self._heads(p))

    def length(self, p):
        return self._doc(p).length(p["obj"], heads=self._heads(p))

    def text(self, p):
        return self._doc(p).text(p["obj"], heads=self._heads(p))

    def marks(self, p):
        return [
            {"start": m.start, "end": m.end, "name": m.name, "value": m.value}
            for m in self._doc(p).marks(p["obj"], heads=self._heads(p))
        ]

    def getCursor(self, p):
        return self._doc(p).get_cursor(p["obj"], p["pos"], heads=self._heads(p))

    def getCursorPosition(self, p):
        return self._doc(p).get_cursor_position(
            p["obj"], p["cursor"], heads=self._heads(p)
        )

    def materialize(self, p):
        """Plain-JSON projection of the (sub)tree, like the wasm module's
        materialize: counters and timestamps flatten to numbers (JSON has
        no such types; ``get``/``getAll`` are the typed surface), bytes
        serialize as the {"$bytes"} wrapper."""
        return self._doc(p).hydrate(p.get("obj", "_root"), heads=self._heads(p))

    # patches
    def popPatches(self, p):
        """Patches since the previous pop — local AND remote changes, via
        the autocommit diff cursor (reference: autocommit.rs
        diff_incremental; the wasm popPatches surfaces local edits too).
        The first call pins the cursor at the current heads and returns
        an empty list."""
        doc = self._doc(p)
        if p["doc"] not in self._patched:
            self._patched.add(p["doc"])
            doc.update_diff_cursor(commit=False)
            return []
        # commit=False: popping must never close an open transaction (a
        # later explicit commit keeps its message); pending ops' patches
        # arrive on the pop after that commit
        return [self._patch_json(x) for x in doc.diff_incremental(commit=False)]

    @staticmethod
    def _patch_json(patch) -> dict:
        a = patch.action
        d = {"obj": patch.obj, "path": [list(pe) for pe in patch.path],
             "action": type(a).__name__}
        for f in getattr(a, "__dataclass_fields__", {}):
            v = getattr(a, f)
            if f == "marks":
                v = [
                    {"start": m.start, "end": m.end, "name": m.name,
                     "value": m.value}
                    for m in v
                ]
            d[f] = v
        return d

    # sync
    def syncStateNew(self, p):
        return {"sync": self._reg(self._syncs, SyncState())}

    def syncStateFree(self, p):
        self._syncs.pop(p["sync"], None)
        return None

    def syncStateEncode(self, p):
        return _b64(self._syncs[p["sync"]].encode())

    def syncStateDecode(self, p):
        return {"sync": self._reg(self._syncs, SyncState.decode(_unb64(p["data"])))}

    def generateSyncMessage(self, p):
        msg = self._doc(p).generate_sync_message(self._syncs[p["sync"]])
        return None if msg is None else _b64(msg.encode())

    def receiveSyncMessage(self, p):
        from .sync.protocol import Message

        doc = self._doc(p)
        msg = Message.decode(_unb64(p["data"]))
        doc.receive_sync_message(self._syncs[p["sync"]], msg)
        # a durable doc opened with device=true carries a resident
        # DeviceDoc: feed it incrementally so device reads stay current
        # (the serving layer coalesces runs of these into apply_batches).
        # A failed feed is counted and answers the request with its error
        dev = getattr(doc, "device_doc", None)
        if dev is not None and msg.changes:
            try:
                dev.apply_changes(msg.changes)
            except Exception as e:
                obs.count("sync.device_feed_error", error=str(e)[:200])
                raise
        return None

    # resilient sync sessions (retry/backoff/reset over lossy transports;
    # see sync/session.py). The base retransmit timeout is the server's
    # syncTimeoutMs (``configure``), overridable per session.
    def _session_config(self, p) -> SessionConfig:
        timeout_ms = int(p.get("timeoutMs", self.sync_timeout_ms))
        if timeout_ms <= 0:
            raise ValueError("timeoutMs must be positive")
        timeout_s = timeout_ms / 1000.0
        return SessionConfig(
            timeout=timeout_s,
            max_timeout=timeout_s * 16,
            seed=int(p.get("seed", 0)),
        )

    def syncSessionNew(self, p):
        doc = self._doc(p)
        sess = SyncSession(
            doc,
            config=self._session_config(p),
            epoch=int(p.get("epoch", 1)),
            device_doc=getattr(doc, "device_doc", None),
        )
        h = self._reg(self._sessions, sess)
        self._session_docs[h] = p["doc"]
        return {"session": h}

    def syncSessionRestore(self, p):
        """Rebuild a session from persisted bytes after a restart; pass an
        epoch different from the pre-restart one."""
        doc = self._doc(p)
        sess = SyncSession.restore(
            doc,
            _unb64(p["data"]),
            epoch=int(p["epoch"]),
            config=self._session_config(p),
        )
        sess.device_doc = getattr(doc, "device_doc", None)
        h = self._reg(self._sessions, sess)
        self._session_docs[h] = p["doc"]
        return {"session": h}

    def syncSessionAttach(self, p):
        """Durable named session: restore (or create) the sync session
        for ``peer`` from the document's journal meta, with the epoch
        bumped — after a server restart or a failover promotion the
        surviving client session sees the new epoch and renegotiates
        through the epoch/reset handshake instead of a full resync.
        Re-attaching a peer that is already live returns the existing
        handle (the epoch only bumps across process incarnations)."""
        doc = self._durable_doc(p)
        peer = p.get("peer")
        if not isinstance(peer, str) or not peer:
            raise ValueError("syncSessionAttach requires a peer name")
        with self._lock:
            h = self._attached_sessions.get((p["doc"], peer))
            if h is not None and h in self._sessions:
                sess = self._sessions[h]
                return {"session": h, "epoch": sess.epoch}
        sess = doc.restore_sync_session(
            peer, config=self._session_config(p))
        h = self._reg(self._sessions, sess)
        with self._lock:
            self._session_docs[h] = p["doc"]
            self._attached_sessions[(p["doc"], peer)] = h
        return {"session": h, "epoch": sess.epoch}

    def _session(self, p) -> SyncSession:
        sess = self._sessions.get(p.get("session"))
        if sess is None:
            raise ValueError(f"invalid session handle {p.get('session')}")
        return sess

    def syncSessionPoll(self, p):
        frame = self._session(p).poll(time.monotonic())
        return None if frame is None else _b64(frame)

    def syncSessionReceive(self, p):
        """Feed wire bytes; corrupt or duplicate frames are absorbed (and
        counted), never raised."""
        accepted = self._session(p).receive(_unb64(p["data"]), time.monotonic())
        return {"accepted": accepted}

    # the counters the wire reports: the port's session keeps more
    # (persist errors, coalesced batches, feeds by kind), read in process
    _SESSION_WIRE_STATS = ("sent", "received", "retries", "resets",
                           "resyncs", "dups", "malformed", "rejected")

    def syncSessionStats(self, p):
        sess = self._session(p)
        return dict({k: sess.stats[k] for k in self._SESSION_WIRE_STATS},
                    converged=sess.converged(), epoch=sess.epoch)

    def syncSessionEncode(self, p):
        return _b64(self._session(p).encode())

    def syncSessionFree(self, p):
        with self._lock:
            self._sessions.pop(p.get("session"), None)
            self._session_docs.pop(p.get("session"), None)
            self._attached_sessions = {
                k: h for k, h in self._attached_sessions.items()
                if h != p.get("session")
            }
        return None

    # -- observability ------------------------------------------------------

    def metrics(self, p):
        """Metrics exposition for a live server. Default is Prometheus
        text (``{"method": "metrics"}`` -> ``result.body``); ``{"format":
        "json"}`` returns the structured snapshot plus the legacy
        counter/timing views."""
        fmt = p.get("format", "prometheus")
        if fmt == "prometheus":
            return {"format": "prometheus", "body": obs.render_prometheus()}
        if fmt == "json":
            with obs.registry.lock:
                counters = dict(obs.legacy_counters)
            return {
                "format": "json",
                "metrics": obs.snapshot(),
                "counters": counters,
                "timings": obs.timing_summary(),
            }
        raise ValueError(f"unknown metrics format {fmt!r}")

    def perfStatus(self, p):
        """The drain-cycle performance observatory's merged report
        (obs/prof.py): cumulative per-stage attribution with a
        host-vs-device split, batch occupancy, docs-per-launch,
        drain-cycle and queue-wait percentiles, and the bounded top-K
        expensive-docs table. ``{"top": n}`` sizes the doc table."""
        from .obs import prof

        top = p.get("top")
        return prof.profiler.status(top=int(top) if top is not None else None)

    def profileStart(self, p):
        """Start a ``torch.profiler`` capture (the card's kernels too,
        where there is one) with a named range on every kernel-launch
        site; ``{"dir": path}`` overrides the capture directory (default:
        a fresh temp dir, named in the response). Degrades cleanly where
        the profiler cannot start: the answer is ``{"ok": false,
        "reason": ...}``, never an error."""
        from .obs import prof

        return prof.torch_profile_start(p.get("dir"))

    def profileStop(self, p):
        """Stop the active ``torch.profiler`` capture; the response names
        the trace directory and its Chrome trace file."""
        from .obs import prof

        return prof.torch_profile_stop()

    def heatStatus(self, p):
        """The doc-heat table (obs/heat.py): ranked per-document
        read/write/sync/bytes/drain rates. ``{"top": n}`` bounds the
        entry list. Scraping also refreshes the ``doc.heat`` gauges."""
        top = p.get("top")
        _heat.table.publish_gauges()
        return _heat.snapshot(top=int(top) if top is not None else None)

    def historyStatus(self, p):
        """The history rings (obs/history.py): downsampled trend slots
        per allowlisted metric family. ``{"name": fam}`` filters to one
        family, ``{"tier": 0|1|2}`` to one resolution tier."""
        from .obs import history

        tier = p.get("tier")
        return history.status(
            name=p.get("name"),
            tier=int(tier) if tier is not None else None)

    # -- dispatch -----------------------------------------------------------

    # explicit allowlist: getattr dispatch must never reach serve/handle or
    # any other non-API callable
    METHODS = frozenset({
        "create", "load", "free", "fork", "actor", "heads", "commit",
        "save", "saveIncremental", "applyChanges", "merge",
        "put", "putObject", "insert", "insertObject", "delete", "increment",
        "spliceText", "mark", "unmark",
        "get", "getAll", "keys", "length", "text", "marks",
        "getCursor", "getCursorPosition", "materialize", "popPatches",
        "syncStateNew", "syncStateFree", "syncStateEncode",
        "syncStateDecode", "generateSyncMessage", "receiveSyncMessage",
        "configure",
        "syncSessionNew", "syncSessionRestore", "syncSessionPoll",
        "syncSessionReceive", "syncSessionStats", "syncSessionEncode",
        "syncSessionFree", "syncSessionAttach",
        "openDurable", "durableCompact", "durableInfo", "durableReopen",
        "chaosDisk", "docDigest", "scrubNow",
        "storeStatus", "storeDemote", "docFence",
        "metrics", "perfStatus", "profileStart", "profileStop",
        "heatStatus", "historyStatus",
    })

    # heat-kind classification for the dispatch hook: which methods
    # count as read / write / sync load against their target document.
    # Fixed at class scope so the per-request cost is one dict lookup.
    _HEAT_KINDS = {
        **dict.fromkeys(
            ("put", "putObject", "insert", "insertObject", "delete",
             "increment", "spliceText", "mark", "unmark", "commit",
             "applyChanges", "merge"), "write"),
        **dict.fromkeys(
            ("get", "getAll", "keys", "length", "text", "marks",
             "getCursor", "getCursorPosition", "materialize",
             "popPatches", "heads", "save", "saveIncremental"), "read"),
        **dict.fromkeys(
            ("generateSyncMessage", "receiveSyncMessage",
             "syncSessionPoll", "syncSessionReceive",
             "syncSessionAttach"), "sync"),
    }

    def _note_heat(self, kind: str, p: dict) -> None:
        """Attribute one request (and its payload bytes) to its target
        document's heat entry. Only NAMED durable documents are
        tracked — the advisor reasons about placeable docs; anonymous
        handles have nothing to place. Never raises: load accounting
        must not be able to fail a request."""
        try:
            name = None
            h = p.get("doc")
            if h is None:
                s = p.get("session")
                if s is not None:
                    h = self._session_docs.get(s)
            if h is not None:
                name = self._handle_names.get(h)
            elif isinstance(p.get("name"), str):
                name = p["name"]
            if not name:
                return
            _heat.note(name, kind)
            nb = 0
            m = p.get("message")
            if isinstance(m, str):
                nb += len(m)
            d = p.get("data")
            if isinstance(d, str):
                nb += len(d)
            if nb:
                _heat.note(name, "bytes", nb)
        except Exception:  # noqa: BLE001
            pass

    def handle(self, req: dict) -> dict:
        rid = req.get("id")
        method = req.get("method", "")
        # the isinstance guard keeps unhashable method values (lists,
        # dicts) from raising out of the membership test
        if not isinstance(method, str) or method not in self.METHODS:
            # "unknown" keeps the method label bounded by the allowlist
            # (+1) no matter what a hostile client sends
            obs.count("rpc.errors",
                      labels={"method": "unknown", "type": "UnknownMethod"})
            return {"id": rid, "error": {"type": "UnknownMethod",
                                         "message": str(method),
                                         "retriable": False}}
        # last deadline gate: in the concurrent server this runs inside
        # the ack scope, just before the mutation would join the fsync
        # batch — the final point where an expired request can still be
        # refused without having executed anything
        if self.deadlines_enabled and request_expired(req):
            return deadline_response(rid, method, "pre_fsync")
        # optional cross-process trace context: {"trace": {"t": <trace
        # id>, "s": <parent span id>}} on the request parents this
        # process's spans into the caller's chain (router -> node, client
        # -> anything). Absent (the common case) this is one dict lookup;
        # malformed values deactivate the scope instead of erroring.
        tr = req.get("trace")
        if isinstance(tr, dict):
            with obs.trace_scope(tr.get("t"), tr.get("s")):
                return self._dispatch(rid, method, req)
        return self._dispatch(rid, method, req)

    def _dispatch(self, rid, method: str, req: dict) -> dict:
        if _heat.table.enabled:
            kind = self._HEAT_KINDS.get(method)
            if kind is not None:
                self._note_heat(kind, req.get("params") or {})
        # the span doubles as the per-method request counter (histogram
        # count) and latency distribution (rpc.request{method=...})
        with obs.span("rpc.request", labels={"method": method}):
            try:
                return {"id": rid,
                        "result": getattr(self, method)(req.get("params") or {})}
            except Exception as e:  # errors answer the request, never kill us
                obs.count("rpc.errors", labels={"method": method,
                                                "type": type(e).__name__})
                err = {"type": type(e).__name__, "message": str(e)}
                # every error answer carries an EXPLICIT retriable flag:
                # exceptions that know their retry semantics (a poisoned
                # journal, a replication-gate timeout) surface it; every
                # other exception is explicitly non-retriable, so clients
                # never have to guess from the type name
                retriable = getattr(e, "retriable", None)
                err["retriable"] = (
                    bool(retriable) if retriable is not None else False)
                # a shedding node's backoff hint (Overloaded) rides along
                ra = getattr(e, "retry_after_ms", None)
                if ra is not None:
                    err["retryAfterMs"] = int(ra)
                return {"id": rid, "error": err}

    @staticmethod
    def _json_default(v):
        # stray raw bytes (mark values, hydrated bytes scalars, patch
        # payloads) serialize as the documented wrapper instead of killing
        # the server
        if isinstance(v, (bytes, bytearray)):
            return {"$bytes": _b64(bytes(v))}
        raise TypeError(f"unserializable value of type {type(v).__name__}")

    def _encode_response(self, resp: dict) -> str:
        try:
            return json.dumps(resp, default=self._json_default)
        except Exception as e:
            return json.dumps({
                "id": resp.get("id"),
                "error": {"type": "EncodeError", "message": str(e),
                          "retriable": False},
            })

    def _parse_line(self, line: str) -> tuple[Optional[dict], Optional[dict]]:
        """One request line -> (request dict, early error response); at
        most one is non-None (both None for a blank line). The byte-limit
        and JSON-shape checks shared by the stdio loop and the socket
        transport (serve/server.py)."""
        line = line.strip()
        if not line:
            return None, None
        # measure encoded BYTES, not characters: a non-ASCII payload can be
        # 4x its character count (the ascii fast path avoids re-encoding)
        nbytes = (
            len(line) if line.isascii()
            else len(line.encode("utf-8", errors="surrogatepass"))
        )
        obs.count("rpc.bytes_in", n=nbytes)
        obs.observe("rpc.request_bytes", nbytes)
        if nbytes > self.max_request_bytes:
            obs.count("rpc.errors", labels={"method": "unknown",
                                            "type": "RequestTooLarge"})
            return None, {"id": None, "error": {
                "type": "RequestTooLarge",
                "message": f"request of {nbytes} bytes exceeds limit "
                           f"of {self.max_request_bytes}",
                "retriable": False}}
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            obs.count("rpc.errors", labels={"method": "unknown",
                                            "type": "ParseError"})
            return None, {"id": None,
                          "error": {"type": "ParseError", "message": str(e),
                                    "retriable": False}}
        if not isinstance(req, dict):
            obs.count("rpc.errors", labels={"method": "unknown",
                                            "type": "ParseError"})
            return None, {"id": None, "error": {
                "type": "ParseError",
                "message": "request must be a JSON object",
                "retriable": False}}
        # deadline propagation: an optional top-level ``deadlineMs``
        # (remaining budget at send time, like ``trace``) is stamped to
        # an absolute LOCAL expiry here — every later enforcement stage
        # (admission, dequeue, pre-fsync) compares against the same
        # monotonic clock, immune to cross-host clock skew
        dl = req.get("deadlineMs")
        if (isinstance(dl, (int, float)) and not isinstance(dl, bool)
                and dl > 0):
            req["_deadline_ts"] = obs.now() + float(dl) / 1000.0
        return req, None

    def _handle_line(self, line: str) -> tuple[Optional[dict], bool]:
        """One request line -> (response dict or None, stop flag).
        Total error isolation: any malformed frame becomes an ``error``
        response; nothing a client sends can raise out of here."""
        req, early = self._parse_line(line)
        if early is not None:
            return early, False
        if req is None:
            return None, False
        if req.get("method") == "shutdown":
            return {"id": req.get("id"), "result": None}, True
        try:
            return self.handle(req), False
        except Exception as e:  # belt and braces: handle() already catches
            retriable = getattr(e, "retriable", None)
            return {"id": None,
                    "error": {"type": type(e).__name__,
                              "message": str(e),
                              "retriable": bool(retriable)
                              if retriable is not None else False}}, False

    def serve(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        raw_readline = getattr(stdin, "readline", None)
        if raw_readline is None:  # plain iterables of lines work too
            it = iter(stdin)
            readline = lambda: next(it, "")  # noqa: E731
        else:
            def readline():
                # bounded read: a request longer than the limit is never
                # buffered whole — the tail is drained (and discarded) in
                # limit-sized chunks until its newline, then rejected.
                # readline(limit) counts characters, so the true buffer
                # bound is limit..4*limit bytes; _handle_line then enforces
                # the byte-exact limit on what survives
                limit = self.max_request_bytes + 1
                line = raw_readline(limit)
                if len(line) >= limit and not line.endswith("\n"):
                    while True:
                        tail = raw_readline(limit)
                        if not tail or tail.endswith("\n"):
                            break
                return line
        try:
            while True:
                try:
                    line = readline()
                except Exception as e:
                    # broken pipe / undecodable stream: clean shutdown —
                    # but a VISIBLE one; a silently dropped client is
                    # indistinguishable from a healthy idle one in metrics
                    obs.count("rpc.errors", labels={"method": "transport",
                                                    "type": "transport"})
                    obs.event("rpc.transport_death", stage="read",
                              error=str(e))
                    return
                if not line:  # EOF (including mid-request cut-offs)
                    return
                resp, stop = self._handle_line(line)
                if resp is not None:
                    payload = self._encode_response(resp) + "\n"
                    obs.count("rpc.bytes_out", n=len(payload))
                    try:
                        stdout.write(payload)
                        stdout.flush()
                    except Exception as e:
                        # client went away mid-response: shutdown, counted
                        obs.count("rpc.errors",
                                  labels={"method": "transport",
                                          "type": "transport"})
                        obs.event("rpc.transport_death", stage="write",
                                  error=str(e))
                        return
                if stop:
                    return
        finally:
            # every exit path flushes durable docs: a client that vanishes
            # without free() must not strand a pending autocommit tx (or
            # the journal flocks) any more than a clean shutdown would
            self.close_durables()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="automerge_tpu_torch.rpc",
        description="line-delimited JSON-RPC frontend over stdio or sockets",
    )
    ap.add_argument(
        "--durable", metavar="DIR", default=None,
        help="persist named documents (openDurable) as crash-safe "
             "journal+snapshot directories under DIR",
    )
    ap.add_argument(
        "--socket", metavar="HOST:PORT", default=None,
        help="serve concurrently over TCP instead of stdio (port 0 picks "
             "a free port; the bound address prints to stderr)",
    )
    ap.add_argument(
        "--unix", metavar="PATH", default=None,
        help="serve concurrently over a unix-domain socket at PATH",
    )
    ap.add_argument(
        "--workers", type=int, default=None,
        help="worker pool size for socket mode "
             "(default AUTOMERGE_TPU_SERVE_WORKERS or 8)",
    )
    ap.add_argument(
        "--device", default=None, metavar="DEVICE",
        help="torch device every document and resident mirror lives on "
             "(default: the card; 'cpu' serves the plain PyTorch path)",
    )
    ap.add_argument(
        "--node-id", default=None, metavar="ID",
        help="run as a cluster node (cluster/node.py) with this id; "
             "requires --socket and --durable",
    )
    ap.add_argument(
        "--replicate-to", action="append", default=[], metavar="HOST:PORT",
        help="cluster leader: ship acked journal records to this "
             "follower node (repeatable)",
    )
    ap.add_argument(
        "--follow", default=None, metavar="HOST:PORT",
        help="cluster follower: reject client mutations (NotLeader, "
             "naming this leader) and accept the replication stream",
    )
    ap.add_argument(
        "--ack-replicas", type=int, default=None,
        help="cluster leader: client acks wait until this many "
             "followers hold the write durably (default "
             "AUTOMERGE_TPU_CLUSTER_ACK_REPLICAS or 0)",
    )
    ap.add_argument(
        "--flight-dir", metavar="DIR", default=None,
        help="dump the flight recorder (recent spans/events/metric "
             "deltas) to DIR on exit/crash (default "
             "AUTOMERGE_TPU_FLIGHT_DIR; merge dumps with "
             "obs.merge_flights)",
    )
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"automerge_tpu_torch.rpc: {e}", file=sys.stderr)
        return 1
    flight_dir = args.flight_dir or os.environ.get("AUTOMERGE_TPU_FLIGHT_DIR")
    if flight_dir:
        obs.flight.install(
            flight_dir, node_id=args.node_id or f"rpc-{os.getpid()}")
    if args.durable:
        os.makedirs(args.durable, exist_ok=True)
    if args.socket or args.unix:
        import signal

        from .serve import SocketRpcServer

        # a DEDICATED server process trades single-thread switch latency
        # for cross-thread fairness: the default 5ms GIL switch interval
        # lets one busy conn thread starve the worker pool for whole
        # request lifetimes (observed: >2x tail-latency inflation)
        sys.setswitchinterval(float(
            os.environ.get("AUTOMERGE_TPU_SERVE_SWITCH_INTERVAL", "0.001")
        ))

        cluster = bool(args.node_id or args.replicate_to or args.follow)
        if cluster:
            from .cluster import ClusterNode

            if not (args.socket and args.durable):
                print("cluster node mode requires --socket and --durable",
                      file=sys.stderr)
                return 2
            host, _, port = args.socket.rpartition(":")
            srv = ClusterNode(
                node_id=args.node_id or f"node-{os.getpid()}",
                host=host or "127.0.0.1", port=int(port),
                durable_dir=args.durable,
                role="follower" if args.follow else "leader",
                leader_addr=args.follow,
                replicate_to=args.replicate_to,
                ack_replicas=args.ack_replicas,
                workers=args.workers,
                device=device,
            )
        elif args.socket:
            host, _, port = args.socket.rpartition(":")
            srv = SocketRpcServer(
                host=host or "127.0.0.1", port=int(port),
                workers=args.workers, durable_dir=args.durable,
                device=device,
            )
        else:
            srv = SocketRpcServer(
                unix_path=args.unix, workers=args.workers,
                durable_dir=args.durable, device=device,
            )
        srv.start()
        print(f"serving on {srv.address}", file=sys.stderr, flush=True)
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: srv._shutdown.set())
        srv.serve_forever()
        return 0
    RpcServer(durable_dir=args.durable, device=device).serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
