"""Bounded per-document heat accounting: who is hot, and how.

The registry's per-doc gauges say how *big* a document is
(``doc.journal_bytes``) and when it was last touched
(``doc.last_access_seconds``); nothing says how *often* it is touched,
or what it costs to serve. This module keeps that signal: a bounded
top-K table of per-document decayed rates — read / write / sync
request counts, request bytes, and attributed drain seconds (fed from
the cycle profiler's per-doc cost attribution) — that the placement
advisor (cluster/advisor.py) and ``perf-report`` rank against.

Mechanics: one table entry per document, each kind's score a
half-life-decayed accumulator (``score *= 2**(-dt/half_life)`` on
touch, default half-life 60 s). At steady state a constant event rate
``r`` holds the score at ``r * half_life / ln 2``, so the exported
per-second rate is ``score * ln2 / half_life``. The table is
**space-saving** bounded: at capacity a new document evicts the
minimum-ranked entry and *inherits its rank score* (plus an ``err``
field recording the inherited overestimate) — the classic top-K
guarantee that a genuinely hot document can never be kept out by a
stream of cold ones, at the price of a bounded overestimate.

Rank is the decayed read+write+sync request score only: bytes and
drain seconds ride along for the advisor but do not decide eviction
(their units would drown the request counts).

Surfaces: ``doc.heat{doc,kind}`` gauges for the top-N
(``publish_gauges``; previously-published series for documents that
fell out of the top set are removed — same hygiene contract as
``obs.remove_doc_gauges``), the ``heatStatus`` RPC (rpc.py), a ranked
section in ``perf-report`` (obs/prof.py), and the advisor snapshot.

Env knobs: ``AUTOMERGE_TPU_HEAT=0`` disables accounting entirely (the
disabled ``note`` is one attribute check — run_obs holds it to the
standard overhead budget); ``AUTOMERGE_TPU_HEAT_DOCS`` caps the table
(default 256); ``AUTOMERGE_TPU_HEAT_HALFLIFE`` sets the decay
half-life in seconds (default 60).

Every public method takes an optional explicit ``now`` (monotonic
seconds) so tests drive decay deterministically; production callers
omit it and get ``obs.now()``.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional

import automerge_tpu_torch.obs as _obs

KINDS = ("read", "write", "sync", "bytes", "drain_s")

# kinds whose decayed score contributes to the eviction/ranking order
_RANK_KINDS = ("read", "write", "sync")

_LN2 = math.log(2.0)


def _env_pos(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, ""))
    except ValueError:
        return default
    return v if v > 0 else default


class _Entry:
    __slots__ = ("scores", "totals", "stamp", "err")

    def __init__(self, now: float, err: float = 0.0):
        self.scores: Dict[str, float] = {}
        self.totals: Dict[str, float] = {}
        self.stamp = now
        self.err = err  # rank score inherited from an evicted entry

    def decay_to(self, now: float, half_life: float) -> None:
        dt = now - self.stamp
        if dt <= 0.0:
            return
        f = 2.0 ** (-dt / half_life)
        for k in self.scores:
            self.scores[k] *= f
        self.err *= f
        self.stamp = now

    def rank(self) -> float:
        s = self.err
        for k in _RANK_KINDS:
            s += self.scores.get(k, 0.0)
        return s


class HeatTable:
    """Bounded space-saving table of per-document decayed heat."""

    def __init__(
        self,
        cap: Optional[int] = None,
        half_life: Optional[float] = None,
        enabled: Optional[bool] = None,
    ):
        if enabled is None:
            enabled = os.environ.get("AUTOMERGE_TPU_HEAT", "1") != "0"
        self.enabled = bool(enabled)
        self.cap = int(cap if cap is not None
                       else _env_pos("AUTOMERGE_TPU_HEAT_DOCS", 256))
        self.cap = max(1, self.cap)
        self.half_life = float(
            half_life if half_life is not None
            else _env_pos("AUTOMERGE_TPU_HEAT_HALFLIFE", 60.0))
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self._evictions = 0
        # (doc, kind) series currently published as doc.heat gauges
        self._published: set = set()

    # -- recording -----------------------------------------------------------

    def note(self, doc: str, kind: str, n: float = 1.0,
             now: Optional[float] = None) -> None:
        """Record ``n`` units of ``kind`` heat against ``doc``. The
        disabled path returns after one attribute check."""
        if not self.enabled:
            return
        if not doc or kind not in KINDS:
            return
        if now is None:
            now = _obs.now()
        with self._lock:
            e = self._entries.get(doc)
            if e is None:
                e = self._admit_locked(doc, now)
            else:
                e.decay_to(now, self.half_life)
            e.scores[kind] = e.scores.get(kind, 0.0) + n
            e.totals[kind] = e.totals.get(kind, 0.0) + n

    def _admit_locked(self, doc: str, now: float) -> _Entry:
        if len(self._entries) < self.cap:
            e = _Entry(now)
            self._entries[doc] = e
            return e
        # space-saving eviction: drop the minimum-ranked entry; the
        # newcomer inherits its rank so a hot doc arriving late still
        # climbs (err records the overestimate)
        victim, vmin = None, math.inf
        for name, cand in self._entries.items():
            cand.decay_to(now, self.half_life)
            r = cand.rank()
            if r < vmin:
                victim, vmin = name, r
        assert victim is not None
        del self._entries[victim]
        self._evictions += 1
        e = _Entry(now, err=vmin)
        self._entries[doc] = e
        return e

    def forget(self, doc: str) -> bool:
        """Drop one document's entry (close/migrate-out hygiene)."""
        with self._lock:
            return self._entries.pop(doc, None) is not None

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._evictions = 0
            self._published.clear()

    # -- reading -------------------------------------------------------------

    def rate_of(self, score: float) -> float:
        """Steady-state per-second rate implied by a decayed score."""
        return score * _LN2 / self.half_life

    def snapshot(self, now: Optional[float] = None,
                 top: Optional[int] = None) -> dict:
        """Ranked heat snapshot: ``{"entries": [{doc, rank, rates,
        totals, err}, ...], ...}`` sorted hottest-first (ties broken by
        doc name for determinism)."""
        if now is None:
            now = _obs.now()
        out: List[dict] = []
        with self._lock:
            for doc, e in self._entries.items():
                e.decay_to(now, self.half_life)
                out.append({
                    "doc": doc,
                    "rank": e.rank(),
                    "rates": {k: self.rate_of(v)
                              for k, v in e.scores.items() if v > 0.0},
                    "totals": dict(e.totals),
                    "err": e.err,
                })
            evictions = self._evictions
        out.sort(key=lambda r: (-r["rank"], r["doc"]))
        if top is not None:
            out = out[:top]
        return {
            "enabled": self.enabled,
            "cap": self.cap,
            "halfLifeSeconds": self.half_life,
            "docs": len(self._entries),
            "evictions": evictions,
            "entries": out,
        }

    # -- gauge export --------------------------------------------------------

    def publish_gauges(self, top: int = 16,
                       now: Optional[float] = None) -> int:
        """Export the top-N entries as ``doc.heat{doc,kind}`` gauges
        (per-second rates; ``drain_s`` is seconds-of-work per second,
        i.e. utilization). Series published on a previous call for docs
        that fell out of the top set are removed so the registry's
        cardinality slots keep circulating. Returns the series count."""
        snap = self.snapshot(now=now, top=top)
        fresh = set()
        for e in snap["entries"]:
            for kind, rate in e["rates"].items():
                key = (e["doc"], kind)
                fresh.add(key)
                _obs.gauge_set("doc.heat", rate,
                               labels={"doc": e["doc"], "kind": kind})
        for doc, kind in self._published - fresh:
            _obs.gauge_remove("doc.heat", {"doc": doc, "kind": kind})
        self._published = fresh
        return len(fresh)


# -- process-global table (what the rpc/serve/prof hooks feed) ---------------

table = HeatTable()


def note(doc: str, kind: str, n: float = 1.0,
         now: Optional[float] = None) -> None:
    table.note(doc, kind, n, now=now)


def snapshot(now: Optional[float] = None, top: Optional[int] = None) -> dict:
    return table.snapshot(now=now, top=top)


def reset() -> None:
    """Tests: clear the global table (keeps enabled/cap config)."""
    table.reset()
