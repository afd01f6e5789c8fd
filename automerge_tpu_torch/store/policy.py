"""Residency policy: budgets, cost signals and victim selection.

The port of ``automerge_tpu/store/policy.py``, with the same knobs.

The tiered store's demotion decisions are pure functions over a
snapshot of per-document accounting (last access stamp, resident-byte
estimate, tier) plus the configured budgets — kept separate from the
``DocStore`` mechanics so the policy is unit-testable without opening a
single journal.

The shape follows SynchroStore's cost-based incremental compaction
(arXiv:2503.18688) and the Real-Time LSM-Tree HTAP tiering argument
(arXiv:2101.06801): write-hot documents stay fully (device-)resident,
read-mostly documents keep only the host op-store, and idle documents
collapse to their on-disk snapshot + journal tail. Victims are picked
least-recently-used first; the cost side shows up as (a) the
compact-on-demote gate (a journal smaller than
``cold_compact_min_bytes`` is cheaper to replay than to re-snapshot)
and (b) the resident-byte estimate that orders the warm set's pressure.

Budgets (all ``0`` = unbounded, the default — an unconfigured store is
pure bookkeeping and never demotes):

* ``hot_docs``   — max documents holding a device mirror
  (``AUTOMERGE_TPU_STORE_HOT_DOCS``).
* ``warm_bytes`` — max estimated host-resident bytes across live
  (hot + warm) documents (``AUTOMERGE_TPU_STORE_WARM_BYTES``).
* ``max_rss_bytes`` — hard process-RSS watermark: past it the store
  demotes LRU live documents to cold until the process is back under
  (or nothing demotable remains) (``AUTOMERGE_TPU_STORE_MAX_RSS``).
* ``idle_cold_s`` — optional age-based demotion: any live document
  idle longer than this goes cold regardless of budgets
  (``AUTOMERGE_TPU_STORE_IDLE_COLD_S``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

TIER_HOT = "hot"
TIER_WARM = "warm"
TIER_COLD = "cold"
TIERS = (TIER_HOT, TIER_WARM, TIER_COLD)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass(frozen=True)
class StoreBudgets:
    """Residency budgets; 0 disables the corresponding bound."""

    hot_docs: int = 0
    warm_bytes: int = 0
    max_rss_bytes: int = 0
    idle_cold_s: float = 0.0
    # concurrent cold-open bound: past it, access answers a retriable
    # Backpressure instead of queueing unbounded hydration work
    max_hydrations: int = 4
    # background sweep cadence (idle/RSS pressure is time-driven, not
    # only admission-driven); 0 disables the thread
    evict_interval_s: float = 1.0
    # demote-to-cold compacts first ONLY when the journal is at least
    # this big — replaying a small tail on hydrate is cheaper than
    # re-snapshotting the document on every demotion
    cold_compact_min_bytes: int = 64 << 10
    # demotion floor: a document accessed within this window is never a
    # victim, whatever the budgets say. Keeps a doc that is mid-flight
    # between handle resolution and its mutation from being closed out
    # from under the request (the closed-instance guard makes that a
    # retriable error, not a loss — this floor makes it rare), and damps
    # hydrate/demote thrash under budgets tighter than the working set.
    min_idle_s: float = 0.1

    @classmethod
    def from_env(cls) -> "StoreBudgets":
        return cls(
            hot_docs=_env_int("AUTOMERGE_TPU_STORE_HOT_DOCS", 0),
            warm_bytes=_env_int("AUTOMERGE_TPU_STORE_WARM_BYTES", 0),
            max_rss_bytes=_env_int("AUTOMERGE_TPU_STORE_MAX_RSS", 0),
            idle_cold_s=_env_float("AUTOMERGE_TPU_STORE_IDLE_COLD_S", 0.0),
            max_hydrations=_env_int("AUTOMERGE_TPU_STORE_HYDRATIONS", 4),
            evict_interval_s=_env_float(
                "AUTOMERGE_TPU_STORE_EVICT_INTERVAL", 1.0),
            cold_compact_min_bytes=_env_int(
                "AUTOMERGE_TPU_STORE_COLD_COMPACT_MIN", 64 << 10),
            min_idle_s=_env_float("AUTOMERGE_TPU_STORE_MIN_IDLE", 0.1),
        )

    @property
    def active(self) -> bool:
        """True when any bound can actually force a demotion."""
        return bool(
            self.hot_docs or self.warm_bytes
            or self.max_rss_bytes or self.idle_cold_s
        )


@dataclass
class DocStats:
    """One document's policy-relevant accounting snapshot."""

    name: str
    tier: str
    last_access: float  # obs.now() stamp
    resident_bytes: int = 0

    def idle_s(self, now: float) -> float:
        return max(0.0, now - self.last_access)


@dataclass
class Demotion:
    name: str
    to: str  # TIER_WARM or TIER_COLD
    reason: str


def compact_on_demote(journal_bytes: int, has_run_image: bool,
                      history_len: int, budgets: StoreBudgets) -> bool:
    """Should a warm→cold demotion compact before closing?

    The cost side of the tiering model: a journal smaller than
    ``cold_compact_min_bytes`` is cheaper to replay on the next hydrate
    than to re-snapshot now — UNLESS the document has no run-coded image
    yet (legacy-format or absent snapshot), in which case one compaction
    here converts the cold copy to the run-coded format and every later
    hydration becomes decode-only. Write-hot docs therefore keep short
    tails; read-mostly docs converge to a pure image."""
    if journal_bytes >= budgets.cold_compact_min_bytes:
        return True
    from ..storage import runsnap

    return runsnap.enabled() and not has_run_image and history_len > 0


def device_resident_bytes(dev) -> int:
    """Device-path footprint of one resident ``DeviceDoc`` mirror, as
    the admission/demotion policy should see it: TRUE resident bytes —
    the compressed column image a drain actually ships plus the
    resolution readbacks — not the dense-equivalent array bytes the
    estimate used to report. Reads the owner-stamped cache
    (``DeviceDoc.resident_nbytes_estimate``): the evict sweeper runs
    off-thread, and computing the figure fresh would sync the log's
    compressed image under a concurrent append. With
    ``AUTOMERGE_TPU_COMPRESSED=0`` the two modes coincide."""
    try:
        return int(dev.resident_nbytes_estimate())
    except AttributeError:
        # a foreign duck-type without the estimate: fall back to
        # whatever readback arrays are reachable
        try:
            return sum(a.nbytes for a in dev.res.values())
        except AttributeError:
            return 0


def current_rss_bytes() -> int:
    """This process's current resident set size. Linux reads
    ``/proc/self/statm`` (current, not peak); elsewhere falls back to
    ``getrusage`` peak RSS — a watermark against the peak is still a
    watermark, just a sticky one."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        import resource
        import sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is KiB on Linux but BYTES on macOS — a 1024x
        # misread here would make the watermark pass see permanent
        # excess and demote the whole working set every sweep
        return peak if sys.platform == "darwin" else peak * 1024


def pick_demotions(
    stats: List[DocStats],
    budgets: StoreBudgets,
    *,
    now: float,
    rss_bytes: Optional[int] = None,
) -> List[Demotion]:
    """The policy: which documents leave their tier, and why.

    Pure over its inputs. Order of enforcement (each pass works on the
    state the previous pass left behind):

    1. ``idle_cold_s`` — age out idle live docs to cold.
    2. ``hot_docs``    — LRU hot docs drop their device mirror (→ warm).
    3. ``warm_bytes``  — LRU live docs go cold until the estimated
       host-resident total fits.
    4. ``max_rss_bytes`` — hard watermark: LRU live docs go cold until
       the measured RSS is projected back under (resident-byte
       estimates are optimistic about allocator behaviour, so this pass
       just demotes oldest-first until the ledger says enough).
    """
    out: List[Demotion] = []
    tier = {s.name: s.tier for s in stats}
    # the demotion floor: a just-touched doc is never a victim (see
    # StoreBudgets.min_idle_s); every pass below works over this set
    by_age = sorted(
        (s for s in stats if s.idle_s(now) >= budgets.min_idle_s),
        key=lambda s: s.last_access,
    )

    if budgets.idle_cold_s > 0:
        for s in by_age:
            if tier[s.name] != TIER_COLD and s.idle_s(now) >= budgets.idle_cold_s:
                out.append(Demotion(s.name, TIER_COLD, "idle"))
                tier[s.name] = TIER_COLD

    if budgets.hot_docs > 0:
        hot = [s for s in by_age if tier[s.name] == TIER_HOT]
        for s in hot[: max(0, len(hot) - budgets.hot_docs)]:
            out.append(Demotion(s.name, TIER_WARM, "hot_budget"))
            tier[s.name] = TIER_WARM

    if budgets.warm_bytes > 0:
        live_bytes = sum(
            s.resident_bytes for s in stats if tier[s.name] != TIER_COLD
        )
        for s in by_age:
            if live_bytes <= budgets.warm_bytes:
                break
            if tier[s.name] == TIER_COLD:
                continue
            out.append(Demotion(s.name, TIER_COLD, "warm_budget"))
            tier[s.name] = TIER_COLD
            live_bytes -= s.resident_bytes

    if budgets.max_rss_bytes > 0 and rss_bytes is not None:
        excess = rss_bytes - budgets.max_rss_bytes
        for s in by_age:
            if excess <= 0:
                break
            if tier[s.name] == TIER_COLD:
                continue
            out.append(Demotion(s.name, TIER_COLD, "rss"))
            tier[s.name] = TIER_COLD
            # the estimate may undershoot what the allocator returns to
            # the OS; clamping at 1 byte guarantees forward progress so
            # sustained pressure eventually demotes everything demotable
            excess -= max(1, s.resident_bytes)

    # collapse duplicate names (a hot-budget victim may also be a
    # warm-bytes victim in the same sweep): the coldest decision wins,
    # keeping the first reason that named that tier
    best: dict = {}
    order: List[str] = []
    for d in out:
        prev = best.get(d.name)
        if prev is None:
            best[d.name] = d
            order.append(d.name)
        elif prev.to == TIER_WARM and d.to == TIER_COLD:
            best[d.name] = d
    return [best[n] for n in order]


def tier_counts(stats: List[DocStats]) -> Tuple[int, int, int]:
    hot = sum(1 for s in stats if s.tier == TIER_HOT)
    warm = sum(1 for s in stats if s.tier == TIER_WARM)
    cold = sum(1 for s in stats if s.tier == TIER_COLD)
    return hot, warm, cold
