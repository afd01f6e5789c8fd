"""The tiered document store: bounded-memory residency for every
document a node serves.

One process used to hold every document it had ever opened fully
materialized — host op-store, optional device mirror, journal — so RSS
scaled linearly with the number of documents opened. ``DocStore``
replaces that assumption with an explicit residency state machine:

* **hot**  — device-resident ``DeviceDoc`` mirror + host op-store
  (write-hot docs; the device incremental-merge path stays warm).
* **warm** — host op-store only; the device mirror is dropped
  (read-mostly docs: every read serves, writes journal as always).
* **cold** — closed in memory entirely; on disk as the fsynced
  snapshot + journal tail the durability layer always maintains.
  The serving handle stays valid — the first access hydrates the
  document back to warm through the standard warm-recovery open
  (snapshot load in salvage mode + journal replay), under a per-doc
  single-flight lock so a stampede of requests for one cold document
  opens it exactly once.

Demotion is policy-driven (store/policy.py): LRU order under the
``AUTOMERGE_TPU_STORE_HOT_DOCS`` / ``_WARM_BYTES`` budgets, a hard
``_MAX_RSS`` process watermark, and an optional idle age-out — fed by
the same per-document accounting the obs layer already exports
(``doc.journal_bytes`` / ``doc.last_access_seconds`` /
``doc.resident_ops`` / ``doc.device_bytes``).

The port of ``automerge_tpu/store/docstore.py``. One name differs:
``admit(name, dd, mirror=...)`` says whether the document carries a
resident ``DeviceDoc`` (the reference's ``device``), since ``device``
means a torch device throughout the port.

The store owns *bookkeeping and policy*; the *mechanics* of each
transition (reopening a journal, aliasing an RPC handle, dropping a
device mirror, detaching a replication stream) belong to the serving
layer, which supplies them as an ``ops`` object:

    ops.open_cold(name)         -> live document (hydration)
    ops.close_cold(name, compact) -> ColdDocRef (demotion to cold)
    ops.drop_device(name)       -> None (hot -> warm)
    ops.build_device(name)      -> bool (warm -> hot promotion)

Observability: ``store.tier{tier=...}`` gauges track the population,
``store.promotions`` / ``store.demotions`` counters carry
``{from,to,reason}`` labels, ``store.hydrate`` is the cold-open
latency histogram, and every transition lands a flight-recorder event
(``store.transition``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import obs
from ..degrade import brownout_active
from .policy import (
    TIER_COLD,
    TIER_HOT,
    TIER_WARM,
    DocStats,
    StoreBudgets,
    compact_on_demote,
    current_rss_bytes,
    device_resident_bytes,
    pick_demotions,
)


class StoreBackpressure(Exception):
    """Too many cold documents hydrating at once — retry. Carries the
    ``retriable`` flag the RPC error envelope and the reference client
    understand (the same contract as the shard pool's Backpressure)."""

    retriable = True


class ColdDocRef:
    """What a cold document leaves behind in the serving handle table:
    a few dozen bytes instead of a materialized document. Duck-types
    just enough of the durable wrapper for the handle-table code paths
    that may touch it without hydrating — ``journal.fsync_policy`` and
    ``doc.text_encoding`` for ``openDurable``'s mismatch checks,
    ``close()`` for ``free``/shutdown sweeps, and the frozen
    replication coordinates (nothing changes on disk while cold, so the
    values captured at demotion stay exact) for ``clusterStatus``."""

    _closed = True  # the residency check every access path keys on

    __slots__ = ("name", "fsync_policy", "text_encoding",
                 "_acked", "_appended", "replication_cursor")

    def __init__(self, name: str, *, fsync_policy: str,
                 text_encoding, acked: int, appended: int,
                 replication_cursor: Optional[bytes]):
        self.name = name
        self.fsync_policy = fsync_policy
        self.text_encoding = text_encoding
        self._acked = acked
        self._appended = appended
        self.replication_cursor = replication_cursor

    # openDurable reads live.journal.fsync_policy / live.doc.text_encoding
    @property
    def journal(self):
        return self

    @property
    def doc(self):
        return self

    def acked_prefix(self):
        return (self._acked, self._appended)

    def close(self) -> None:  # already closed; sweeps may call anyway
        return None


class _Entry:
    """Store-side bookkeeping for one named document."""

    __slots__ = ("name", "tier", "last_access", "want_device",
                 "resident_bytes", "lock", "doc")

    def __init__(self, name: str, tier: str, *, want_device: bool):
        self.name = name
        self.tier = tier
        self.last_access = obs.now()
        self.want_device = want_device
        self.resident_bytes = 0
        # single-flight guard for this document's tier transitions: a
        # stampede of readers for one cold doc serializes here and every
        # waiter past the first finds the document already live
        self.lock = threading.Lock()
        self.doc = None  # the live durable doc (None while cold)


class DocStore:
    """Tiered residency over every named durable document. See module
    docstring for the state machine; see ``StoreBudgets`` for knobs."""

    def __init__(self, ops, budgets: Optional[StoreBudgets] = None):
        self.ops = ops
        self.budgets = budgets or StoreBudgets.from_env()
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        # running tier populations (kept exact under _lock at every
        # transition): the gauges, the hot-budget check on the promote
        # path and status() must not scan 10^5 entries per access
        self._counts: Dict[str, int] = {
            TIER_HOT: 0, TIER_WARM: 0, TIER_COLD: 0}
        self._hydrations = threading.Semaphore(
            max(1, self.budgets.max_hydrations))
        self._evict_thread: Optional[threading.Thread] = None
        self._evict_wake = threading.Event()
        self._last_inline_sweep = 0.0
        self._closed = False
        self._export_tier_gauges()

    # -- admission / bookkeeping ---------------------------------------------

    def admit(self, name: str, dd, *, mirror: bool) -> None:
        """Register a freshly opened durable document (tier hot when it
        carries a device mirror, warm otherwise) and run the budgets."""
        tier = TIER_HOT if mirror else TIER_WARM
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                e = self._entries[name] = _Entry(
                    name, tier, want_device=mirror)
                self._counts[tier] += 1
            else:
                self._counts[e.tier] -= 1
                self._counts[tier] += 1
                e.tier = tier
                e.want_device = e.want_device or mirror
            e.doc = dd
            e.last_access = obs.now()
            e.resident_bytes = _resident_bytes(dd)
        self._export_tier_gauges()
        self._maybe_start_evictor()
        self.request_evict()

    def forget(self, name: str) -> None:
        """Drop the entry entirely (the document was freed/closed by the
        serving layer; its on-disk state is not the store's concern)."""
        with self._lock:
            e = self._entries.pop(name, None)
            if e is not None:
                self._counts[e.tier] -= 1
        self._export_tier_gauges()

    def touch(self, name: str) -> None:
        """Per-request recency stamp. Deliberately lock-free on the
        common path: dict lookup and float store are GIL-atomic, the
        stamp is advisory (the policy also reads the live doc's own
        ``last_access``), and a store-wide lock here would serialize
        every shard worker on one mutex per request."""
        e = self._entries.get(name)
        if e is None:
            return
        e.last_access = obs.now()
        # a warm doc that wants its device mirror back promotes on
        # access (reads included — a read-hot doc earns residency too)
        if e.tier == TIER_WARM and e.want_device:
            self._maybe_promote(e)

    def tier(self, name: str) -> Optional[str]:
        with self._lock:
            e = self._entries.get(name)
            return e.tier if e is not None else None

    def names(self, tier: Optional[str] = None) -> List[str]:
        with self._lock:
            return sorted(
                n for n, e in self._entries.items()
                if tier is None or e.tier == tier
            )

    # -- access (the hydration path) -----------------------------------------

    def ensure_open(self, name: str):
        """Return the live document for ``name``, hydrating a cold one
        through the single-flight lock. Raises ``StoreBackpressure``
        (retriable) when more than ``max_hydrations`` *different* cold
        documents are mid-open — the stampede-on-one-doc case instead
        blocks on the entry lock and finds the document live."""
        with self._lock:
            e = self._entries.get(name)
        if e is None:
            raise KeyError(f"unknown stored document {name!r}")
        if (
            e.tier != TIER_COLD
            and e.doc is not None
            and not getattr(e.doc, "_closed", False)
        ):
            e.last_access = obs.now()
            self._maybe_promote(e)
            return e.doc
        with e.lock:
            if e.tier != TIER_COLD and e.doc is not None:
                if getattr(e.doc, "_closed", False):
                    # a reopen is mid-flight elsewhere (durableReopen's
                    # window): hydrating here would race it onto the
                    # journal flock — hand the client a retriable error
                    raise StoreBackpressure(
                        f"document {e.name!r} is reopening; retry"
                    )
                e.last_access = obs.now()
                return e.doc  # another thread hydrated while we waited
            if not self._hydrations.acquire(blocking=False):
                obs.count("store.hydrate_backpressure")
                raise StoreBackpressure(
                    f"too many cold documents hydrating; retry {name!r}"
                )
            try:
                with obs.span("store.hydrate", doc=name):
                    dd = self.ops.open_cold(name)
            finally:
                self._hydrations.release()
            with self._lock:
                e.doc = dd
                self._counts[e.tier] -= 1
                self._counts[TIER_WARM] += 1
                e.tier = TIER_WARM
                e.last_access = obs.now()
                e.resident_bytes = _resident_bytes(dd)
        self._transition(name, TIER_COLD, TIER_WARM, "access")
        obs.count("store.promotions", labels={
            "from": TIER_COLD, "to": TIER_WARM, "reason": "access"})
        self._export_tier_gauges()
        self.request_evict()
        return dd

    def _maybe_promote(self, e: _Entry) -> None:
        """Warm doc that wants a device mirror, with hot-budget room (or
        no hot budget at all): promote on access. Runs outside the store
        lock; the entry lock serializes against a racing demotion."""
        if not (e.want_device and e.tier == TIER_WARM):
            return
        if not e.lock.acquire(blocking=False):
            return  # a transition is in flight; this access keeps the doc
        try:
            if e.tier != TIER_WARM or e.doc is None:
                return
            if (
                self.budgets.hot_docs
                and self._counts[TIER_HOT] >= self.budgets.hot_docs
            ):
                return
            if self.ops.build_device(e.name):
                with self._lock:
                    self._counts[e.tier] -= 1
                    self._counts[TIER_HOT] += 1
                    e.tier = TIER_HOT
                    e.resident_bytes = _resident_bytes(e.doc)
                self._transition(e.name, TIER_WARM, TIER_HOT, "access")
                obs.count("store.promotions", labels={
                    "from": TIER_WARM, "to": TIER_HOT, "reason": "access"})
                self._export_tier_gauges()
        finally:
            e.lock.release()

    # -- demotion ------------------------------------------------------------

    def demote(self, name: str, to: str, reason: str = "manual") -> str:
        """Explicit demotion (the ``storeDemote`` RPC / CI drive). Also
        the single implementation the eviction sweep calls. Returns the
        resulting tier."""
        if to not in (TIER_WARM, TIER_COLD):
            raise ValueError(f"cannot demote to {to!r}")
        with self._lock:
            e = self._entries.get(name)
        if e is None:
            raise KeyError(f"unknown stored document {name!r}")
        with e.lock:
            frm = e.tier
            if frm == TIER_COLD or (frm == TIER_WARM and to == TIER_WARM):
                return e.tier
            if frm == TIER_HOT:
                self.ops.drop_device(name)
                with self._lock:
                    self._counts[TIER_HOT] -= 1
                    self._counts[TIER_WARM] += 1
                    e.tier = TIER_WARM
                    if e.doc is not None:
                        e.resident_bytes = _resident_bytes(e.doc)
                self._transition(name, TIER_HOT, TIER_WARM, reason)
                obs.count("store.demotions", labels={
                    "from": TIER_HOT, "to": TIER_WARM, "reason": reason})
            if to == TIER_COLD:
                compact = False
                if e.doc is not None:
                    compact = compact_on_demote(
                        e.doc.journal.size_bytes,
                        getattr(e.doc, "_run_image", None) is not None,
                        len(e.doc._core.history),
                        self.budgets,
                    )
                self.ops.close_cold(name, compact=compact)
                with self._lock:
                    self._counts[e.tier] -= 1
                    self._counts[TIER_COLD] += 1
                    e.doc = None
                    e.tier = TIER_COLD
                    e.resident_bytes = 0
                self._transition(name, TIER_WARM, TIER_COLD, reason)
                obs.count("store.demotions", labels={
                    "from": TIER_WARM, "to": TIER_COLD, "reason": reason})
        self._export_tier_gauges()
        return self.tier(name) or TIER_COLD

    def request_evict(self) -> None:
        """Admission-path eviction signal. A sweep is O(live entries),
        so the hot paths (admit, hydrate) must not each pay one — with
        a background sweeper running this just wakes it; without one it
        runs an inline sweep at most every 50ms. Budget overshoot is
        bounded by (admission rate x that latency), which the watermark
        headroom absorbs."""
        if self._closed or not self.budgets.active:
            return
        if self._evict_thread is not None:
            self._evict_wake.set()
            return
        now = obs.now()
        if now - self._last_inline_sweep >= 0.05:
            self._last_inline_sweep = now
            self.maybe_evict()

    def maybe_evict(self) -> int:
        """One policy sweep: snapshot accounting, ask the policy for
        victims, apply them. Returns the number of demotions applied.
        Cheap no-op when no budget is configured."""
        if self._closed or not self.budgets.active:
            return 0
        if brownout_active() and not (
            self.budgets.max_rss_bytes
            and current_rss_bytes() > self.budgets.max_rss_bytes
        ):
            # brownout: cold-demotion churn (close/compact/re-hydrate
            # cycles) defers — EXCEPT when RSS is actually over budget;
            # the memory watermark is a hard promise, degraded or not
            obs.count("store.evict_deferred_brownout")
            return 0
        now = obs.now()
        with self._lock:
            stats = []
            for e in self._entries.values():
                la = e.last_access
                if e.doc is not None:
                    # the durable layer stamps the doc on every ack and
                    # every read-path touch; take the freshest of the two
                    la = max(la, getattr(e.doc, "last_access", 0.0))
                    e.resident_bytes = _resident_bytes(e.doc)
                stats.append(DocStats(
                    e.name, e.tier, la, e.resident_bytes))
        rss = (
            current_rss_bytes() if self.budgets.max_rss_bytes else None
        )
        n = 0
        for d in pick_demotions(stats, self.budgets, now=now, rss_bytes=rss):
            try:
                self.demote(d.name, d.to, d.reason)
                n += 1
            except KeyError:
                continue  # freed while the sweep ran
            except Exception as e:  # noqa: BLE001 — one doc, not the sweep
                obs.count("store.demote_error", error=str(e)[:200])
        return n

    # -- the background sweeper ----------------------------------------------

    def _maybe_start_evictor(self) -> None:
        if (
            self._evict_thread is not None
            or not self.budgets.active
            or self.budgets.evict_interval_s <= 0
            or self._closed
        ):
            return
        with self._lock:
            if self._evict_thread is not None or self._closed:
                return
            self._evict_thread = threading.Thread(
                target=self._evict_loop, name="store-evict", daemon=True)
            self._evict_thread.start()

    def _evict_loop(self) -> None:
        while not self._closed:
            self._evict_wake.wait(self.budgets.evict_interval_s)
            self._evict_wake.clear()
            if self._closed:
                return
            try:
                self.maybe_evict()
            except Exception as e:  # noqa: BLE001 — sweeper must not die
                obs.count("store.evict_error", error=str(e)[:200])

    def close(self) -> None:
        """Stop the sweeper and drop bookkeeping. Does NOT close the
        documents — the serving layer's shutdown flush owns that."""
        self._closed = True
        self._evict_wake.set()
        t = self._evict_thread
        if t is not None:
            t.join(timeout=10)
            self._evict_thread = None
        with self._lock:
            self._entries.clear()

    # -- introspection -------------------------------------------------------

    def status(self, *, docs: bool = False) -> dict:
        with self._lock:
            counts = dict(self._counts)
            entries = list(self._entries.values()) if docs else []
        now = obs.now()
        per_doc = {}
        for e in entries:
            per_doc[e.name] = {
                "tier": e.tier,
                "idleSeconds": round(max(0.0, now - e.last_access), 3),
                "residentBytes": e.resident_bytes,
            }
        out = {
            "enabled": self.budgets.active,
            "tiers": counts,
            "budgets": {
                "hotDocs": self.budgets.hot_docs,
                "warmBytes": self.budgets.warm_bytes,
                "maxRssBytes": self.budgets.max_rss_bytes,
                "idleColdSeconds": self.budgets.idle_cold_s,
                "maxHydrations": self.budgets.max_hydrations,
            },
            "rssBytes": current_rss_bytes(),
        }
        if docs:
            out["docs"] = per_doc
        return out

    # -- internals -----------------------------------------------------------

    def _transition(self, name: str, frm: str, to: str, reason: str) -> None:
        # obs.event always lands in the flight recorder's bounded event
        # ring — every tier transition is reconstructable post-mortem
        obs.event("store.transition", doc=name, tier_from=frm, tier_to=to,
                  reason=reason)

    def _export_tier_gauges(self) -> None:
        with self._lock:
            counts = dict(self._counts)
        for t, n in counts.items():
            obs.gauge_set("store.tier", n, labels={"tier": t})


# measured floor for one live durable doc (AutoDoc + core document +
# op-store indexes + journal buffers) before any history payload: ~32KiB
# on CPython 3.10. The payload proxy below scales with history; without
# this floor a million EMPTY docs would look free to the warm-bytes
# budget while actually costing tens of GiB.
DOC_OVERHEAD_BYTES = 48 << 10


def _resident_bytes(dd) -> int:
    """Estimated host+device footprint of a live durable document. A
    proxy, not an accounting: a fixed per-doc overhead floor, plus
    snapshot-size + journal-size tracking the op-store's history
    payload, plus the device mirror's resolution arrays (exact). The
    policy only needs a consistent ordering and a roughly linear
    scale."""
    try:
        n = (DOC_OVERHEAD_BYTES + getattr(dd, "_last_snapshot_bytes", 0)
             + dd.journal.size_bytes)
        # the retained run-coded image (storage/runsnap.py) is real host
        # memory a warm doc holds to make promotion/compaction decode-only
        img = getattr(dd, "_run_image", None)
        if img is not None:
            n += img.nbytes
    except Exception:  # closed mid-estimate
        return 0
    dev = getattr(dd, "device_doc", None)
    if dev is not None:
        # TRUE device-path bytes (compressed resident columns +
        # readbacks), so a hot doc whose history compresses 10x is 10x
        # cheaper to the hot budget than one that doesn't
        n += device_resident_bytes(dev)
    return n
