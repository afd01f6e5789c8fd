"""History rings: fixed-memory downsampled metric trends.

Every instrument in the registry is a *now* view; flight dumps keep
raw recent deltas but no aligned time base. Soaks and chaos scenes
need to assert on **trends** — "staleness spiked under the delay dial
and recovered" — which requires bounded, time-aligned history. This
module keeps it: per allowlisted metric family, three fixed-size ring
tiers at 1 s / 10 s / 60 s resolution (120 slots each by default, so
two minutes of fine grain, twenty minutes of medium, two hours of
coarse — all in a few KB per series, forever).

Sampling reads one registry snapshot per tick and aggregates **across
label sets** per family: counters record the per-slot *delta* of the
label-summed total (a rate, once divided by the tier interval);
gauges record the per-slot *max* and *last* of the label-max (max is
what spike assertions want; last is what a dashboard line wants).
Downsampling is pure aggregation: a 10 s slot is the sum of deltas /
max of maxes / last of lasts over its ten 1 s slots, so counter
totals stay additive and gauge envelopes stay true across tiers.

Bounded by construction: the allowlist is explicit, the series count
is capped (``cap``; families past it are counted in
``dropped_series``), and every tier is a fixed-``maxlen`` deque — no
input can grow the ring.

Surfaces: the ``historyStatus`` RPC (rpc.py), the ``cluster-history``
CLI (cli.py), and every flight dump (the recorder's history provider
hook), so a post-mortem sees the trend that led to the dump.

Env knobs: ``AUTOMERGE_TPU_HISTORY=0`` keeps the serving layer from
starting the background sampler; ``AUTOMERGE_TPU_HISTORY_METRICS``
replaces the default allowlist (comma-separated family names);
``AUTOMERGE_TPU_HISTORY_SLOTS`` resizes the per-tier ring (default
120). Tests drive ``sample(now=...)`` manually for determinism.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import automerge_tpu_torch.obs as _obs

# (interval seconds, slots-of-previous-tier per slot); tier 0 is the
# base sampling interval, each later tier downsamples the one before
TIERS = (1.0, 10.0, 60.0)

DEFAULT_ALLOWLIST = (
    "cluster.staleness_seconds",
    "cluster.replication_lag",
    "serve.load_score",
    "rpc.bytes_in",
    "cluster.records_shipped",
)


def _allowlist_from_env() -> Tuple[str, ...]:
    raw = os.environ.get("AUTOMERGE_TPU_HISTORY_METRICS")
    if raw is None:
        return DEFAULT_ALLOWLIST
    return tuple(s.strip() for s in raw.split(",") if s.strip())


class _Series:
    """One family's three ring tiers plus the counter baseline."""

    __slots__ = ("name", "type", "tiers", "prev_total", "pending")

    def __init__(self, name: str, type_: str, slots: int):
        self.name = name
        self.type = type_  # "counter" | "gauge"
        self.tiers: List[deque] = [deque(maxlen=slots) for _ in TIERS]
        self.prev_total: Optional[float] = None
        # per-tier accumulator for the slot being built from the tier
        # below: [n_slots, delta_sum, max, last, t_start]
        self.pending: List[Optional[list]] = [None for _ in TIERS[1:]]


class HistoryRing:
    """Fixed-memory downsampling recorder over a metric allowlist."""

    def __init__(
        self,
        allowlist: Optional[Tuple[str, ...]] = None,
        slots: Optional[int] = None,
        cap: int = 64,
        registry=None,
    ):
        self.allowlist = tuple(
            allowlist if allowlist is not None else _allowlist_from_env())
        if slots is None:
            try:
                slots = int(os.environ.get(
                    "AUTOMERGE_TPU_HISTORY_SLOTS", "120"))
            except ValueError:
                slots = 120
        self.slots = max(2, int(slots))
        self.cap = max(1, int(cap))
        self.registry = registry if registry is not None else _obs.registry
        self._series: Dict[Tuple[str, str], _Series] = {}
        self._lock = threading.Lock()
        self.samples = 0
        self.dropped_series = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sampling ------------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> int:
        """Take one tier-0 sample from the registry; returns the number
        of series updated. Callers own the cadence (the background
        sampler ticks every ``TIERS[0]`` seconds; tests call directly
        with an explicit ``now``)."""
        if now is None:
            now = _obs.now()
        want = set(self.allowlist)
        # label-aggregated totals per (name, type): counters sum,
        # gauges take (max, last) across label sets
        agg: Dict[Tuple[str, str], list] = {}
        for e in self.registry.snapshot():
            if e["name"] not in want or e["type"] not in ("counter", "gauge"):
                continue
            key = (e["name"], e["type"])
            v = float(e["value"])
            slot = agg.get(key)
            if slot is None:
                agg[key] = [v, v, v]  # [sum, max, last]
            else:
                slot[0] += v
                slot[1] = max(slot[1], v)
                slot[2] = v
        n = 0
        with self._lock:
            self.samples += 1
            for key, (vsum, vmax, vlast) in sorted(agg.items()):
                s = self._series.get(key)
                if s is None:
                    if len(self._series) >= self.cap:
                        self.dropped_series += 1
                        continue
                    s = _Series(key[0], key[1], self.slots)
                    self._series[key] = s
                self._push_locked(s, now, vsum, vmax, vlast)
                n += 1
        return n

    def _push_locked(self, s: _Series, now: float, vsum: float,
                     vmax: float, vlast: float) -> None:
        if s.type == "counter":
            prev = s.prev_total if s.prev_total is not None else vsum
            delta = max(0.0, vsum - prev)  # reset-protected
            s.prev_total = vsum
            slot = {"t": now, "delta": delta}
        else:
            slot = {"t": now, "max": vmax, "last": vlast}
        s.tiers[0].append(slot)
        self._downsample_locked(s, 1, slot)

    def _downsample_locked(self, s: _Series, tier: int, slot: dict) -> None:
        """Fold one completed slot of ``tier-1`` into ``tier``'s pending
        accumulator; emit (and recurse) when the accumulator covers a
        full coarse interval."""
        if tier >= len(TIERS):
            return
        per = int(round(TIERS[tier] / TIERS[tier - 1]))
        acc = s.pending[tier - 1]
        if acc is None:
            acc = s.pending[tier - 1] = [
                0, 0.0, float("-inf"), 0.0, slot["t"]]
        acc[0] += 1
        if s.type == "counter":
            acc[1] += slot["delta"]
        else:
            acc[2] = max(acc[2], slot["max"])
            acc[3] = slot["last"]
        if acc[0] < per:
            return
        if s.type == "counter":
            coarse = {"t": acc[4], "delta": acc[1]}
        else:
            coarse = {"t": acc[4], "max": acc[2], "last": acc[3]}
        s.tiers[tier].append(coarse)
        s.pending[tier - 1] = None
        self._downsample_locked(s, tier + 1, coarse)

    # -- background sampler --------------------------------------------------

    def start(self) -> bool:
        """Start the 1 Hz daemon sampler (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="obs-history", daemon=True)
            self._thread.start()
            return True

    def _run(self) -> None:
        while not self._stop.wait(TIERS[0]):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — telemetry never kills serving
                pass

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    # -- reading -------------------------------------------------------------

    def series(self, name: str, tier: int = 0,
               type_: Optional[str] = None) -> List[dict]:
        """One family's slots at one tier, oldest first."""
        with self._lock:
            for (n, t), s in self._series.items():
                if n == name and (type_ is None or t == type_):
                    return list(s.tiers[tier])
        return []

    def status(self, name: Optional[str] = None,
               tier: Optional[int] = None) -> dict:
        """Queryable dump: every series' rings (optionally filtered to
        one family / one tier)."""
        tiers = [
            {"intervalSeconds": iv, "slots": self.slots}
            for iv in TIERS
        ]
        out_series = []
        with self._lock:
            for (n, t), s in sorted(self._series.items()):
                if name is not None and n != name:
                    continue
                rings = {}
                for i in range(len(TIERS)):
                    if tier is not None and i != tier:
                        continue
                    rings[str(i)] = list(s.tiers[i])
                out_series.append({
                    "name": n, "type": t, "tiers": rings,
                })
            return {
                "allowlist": list(self.allowlist),
                "tiers": tiers,
                "cap": self.cap,
                "samples": self.samples,
                "droppedSeries": self.dropped_series,
                "series": out_series,
            }

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self.samples = 0
            self.dropped_series = 0


# -- process-global ring (what the serving layer starts) ----------------------

ring = HistoryRing()


def enabled() -> bool:
    return os.environ.get("AUTOMERGE_TPU_HISTORY", "1") != "0"


def start() -> bool:
    """Start the global sampler when enabled; installs the flight-dump
    provider so every dump carries the trend that led to it."""
    if not enabled():
        return False
    _obs.flight.history_provider = ring.status
    return ring.start()


def status(name: Optional[str] = None, tier: Optional[int] = None) -> dict:
    return ring.status(name=name, tier=tier)


def reset() -> None:
    ring.reset()
