"""Admission control and brownout for the serving tier.

The chaos fabric proves the cluster survives *faults*; this module is
what protects it from *load*. One per-node ``AdmissionController``
combines the serving layer's pressure signals into a scalar load score
and acts on it three ways:

* **Shedding.** Past a soft limit the node starts refusing the least
  important work first with ``Overloaded {retriable: true,
  retryAfterMs}`` — the HTAP insight (Real-Time LSM-Trees,
  arXiv:2101.06801) applied to the write path: protect the
  latency-critical class by explicitly degrading the rest. Priority
  classes, most- to least-protected::

      replication/ack > interactive mutation > sync generate > read
                      > background compact/rebalance

  Replication and control-plane traffic is NEVER shed (shedding acks
  under load turns an overload into an availability incident). Within a
  class, shedding is *proportional*: the refused fraction ramps 0 -> 1
  across one threshold width, so the admitted rate tracks capacity at a
  stable queue depth instead of bang-banging between flood and silence.

* **Advertisement.** ``advertisement()`` rides the ``clusterStatus``
  heartbeat so the router stops routing sheddable work at a node that
  would only refuse it.

* **Brownout.** Sustained pressure past an enter threshold (with
  enter/exit hysteresis so the state cannot flap) flips the process-wide
  ``degrade.BROWNOUT`` flag: reads and ``generateSyncMessage`` skip
  journal/recency touches, background compaction and cold-demotion churn
  defer, and the CrossDocBatcher window widens so drains amortize
  better. Entry dumps the flight recorder — the moment of degradation is
  exactly the moment to capture.

The load score is the MAX of normalized signals (each ~1.0 at its own
saturation point), sampled with a small cache interval so per-request
``admit()`` stays cheap:

* expected dequeue wait right now (deepest shard queue times the pool's
  recent per-item service time) and the recent observed dequeue wait
  (EWMA with time decay — the all-time ``serve.queue_wait`` histogram
  cannot decay after a burst), whichever is larger, over the target
  wait; an empty backlog overrides the EWMA entirely;
* shard-pool worker utilization (0..1);
* DocStore hydration-semaphore pressure (0..1);
* RSS over the configured store budget.

Utilization/hydration/RSS alone saturate at ~1.0, below the mutation
shed threshold: only sustained queue waits — the signal that latency
SLOs are actually burning — can escalate shedding to interactive
mutations.

Everything is wall-clock injectable (``now=``) so hysteresis is unit
testable without sleeps. ``AUTOMERGE_TPU_ADMISSION=0`` disables
shedding, deadline enforcement and brownout in one knob — the
uncontrolled baseline the overload bench compares against.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Any, Dict, Optional

from .. import obs
from ..degrade import BROWNOUT, brownout_active

__all__ = [
    "Overloaded",
    "AdmissionController",
    "priority_class",
    "admission_enabled",
]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def admission_enabled() -> bool:
    """The one overload-resilience master switch (default on)."""
    return os.environ.get("AUTOMERGE_TPU_ADMISSION", "1") != "0"


class Overloaded(Exception):
    """The node refused this request to protect higher-priority work.

    Always retriable; carries the server's backoff hint so the client
    retry loop can pace itself instead of hammering a shedding node."""

    retriable = True

    def __init__(self, message: str, *, retry_after_ms: Optional[int] = None,
                 shed_class: Optional[str] = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms
        self.shed_class = shed_class


# -- priority classes ---------------------------------------------------------

# rank 0 is never shed; higher ranks shed earlier. Methods absent from
# every set below default to rank 1 (interactive mutation): a new method
# is protected until explicitly classified, never silently sheddable.
CLASS_NAMES = {0: "replication", 1: "mutation", 2: "sync", 3: "read",
               4: "background"}
NO_SHED_RANK = 5  # advertisement value for "nothing is being shed"

_REPLICATION = frozenset({
    # replication / ack path and the cluster control plane: shedding
    # these converts load into unavailability or split-brain
    "replApply", "replSnapshot", "replPing", "replHarvest",
    "clusterStatus", "clusterPromote", "clusterReplicateTo",
    "migrateOut", "migrateTail", "migrateIn", "migrateRelease",
    "metrics", "configure", "perfStatus", "profileStart", "profileStop",
    "chaosDisk", "shutdown",
})
_SYNC = frozenset({
    "generateSyncMessage", "syncSessionPoll", "syncSessionEncode",
    "syncSessionStats", "syncStateEncode",
})
_READ = frozenset({
    "get", "getAll", "keys", "length", "text", "marks",
    "getCursor", "getCursorPosition", "materialize", "heads",
    "save", "saveIncremental", "storeStatus", "durableInfo",
})
_BACKGROUND = frozenset({"durableCompact", "storeDemote", "docFence"})


def priority_class(method: str) -> tuple:
    """``(rank, class name)`` for one method (see module docstring)."""
    if method in _REPLICATION:
        return 0, CLASS_NAMES[0]
    if method in _SYNC:
        return 2, CLASS_NAMES[2]
    if method in _READ:
        return 3, CLASS_NAMES[3]
    if method in _BACKGROUND:
        return 4, CLASS_NAMES[4]
    return 1, CLASS_NAMES[1]


# -- the controller -----------------------------------------------------------


class AdmissionController:
    """Per-node load scoring, priority shedding and brownout hysteresis.

    ``pool`` / ``store`` / ``batcher`` are duck-typed and all optional
    (tests drive the controller with ``note_wait`` alone): the pool
    supplies ``utilization()``, the store its hydration semaphore and
    RSS budget, the batcher a mutable ``window`` the brownout widens.
    """

    def __init__(self, *, pool=None, store=None, batcher=None,
                 enabled: Optional[bool] = None):
        self.pool = pool
        self.store = store
        self.batcher = batcher
        self.enabled = admission_enabled() if enabled is None else bool(enabled)
        # score thresholds: background sheds at soft, interactive
        # mutations only at hard, read/sync on the line between
        self.soft = _env_float("AUTOMERGE_TPU_ADMISSION_SOFT", 0.75)
        self.hard = _env_float("AUTOMERGE_TPU_ADMISSION_HARD", 2.0)
        self.target_wait_s = _env_float(
            "AUTOMERGE_TPU_ADMISSION_TARGET_WAIT_S", 0.2)
        # brownout hysteresis: enter above, exit below, each sustained
        self.brownout_enter = _env_float(
            "AUTOMERGE_TPU_BROWNOUT_ENTER", 1.25)
        self.brownout_exit = _env_float("AUTOMERGE_TPU_BROWNOUT_EXIT", 0.6)
        self.enter_hold_s = _env_float(
            "AUTOMERGE_TPU_BROWNOUT_ENTER_HOLD_S", 1.0)
        self.exit_hold_s = _env_float(
            "AUTOMERGE_TPU_BROWNOUT_EXIT_HOLD_S", 2.0)
        self.window_widen = _env_float(
            "AUTOMERGE_TPU_BROWNOUT_BATCH_WIDEN", 4.0)
        # recent-wait estimate: EWMA over drain waits, halved every
        # decay_half_s of silence so the score can actually come down
        self.decay_half_s = _env_float(
            "AUTOMERGE_TPU_ADMISSION_DECAY_HALF_S", 2.0)
        self.sample_s = _env_float("AUTOMERGE_TPU_ADMISSION_SAMPLE_S", 0.05)
        self._lock = threading.Lock()
        self._wait_ewma = 0.0
        self._wait_ts = 0.0
        self._score = 0.0
        self._score_ts = -1.0
        self._enter_since: Optional[float] = None
        self._exit_since: Optional[float] = None
        self._batcher_base_window: Optional[float] = None
        # seeded: shed decisions inside the proportional band are
        # reproducible across runs like everything else in the harness
        self._rng = random.Random(0xAD417)
        self.transitions = {"on": 0, "off": 0}
        # export the resting state so the gauges exist before first load
        obs.gauge_set("cluster.brownout", 0.0, labels={"state": "on"})
        obs.gauge_set("cluster.brownout", 1.0, labels={"state": "off"})

    # -- signals -------------------------------------------------------------

    def note_wait(self, waited: float, now: Optional[float] = None) -> None:
        """Feed one drain's dequeue wait (installed as the ShardPool's
        ``wait_observer``)."""
        now = obs.now() if now is None else now
        with self._lock:
            self._wait_ewma = self._decayed_wait_locked(now)
            self._wait_ewma += 0.2 * (waited - self._wait_ewma)
            self._wait_ts = now

    def _decayed_wait_locked(self, now: float) -> float:
        if self._wait_ewma <= 0.0:
            return 0.0
        dt = max(now - self._wait_ts, 0.0)
        return self._wait_ewma * 0.5 ** (dt / max(self.decay_half_s, 1e-6))

    def _hydration_pressure(self) -> float:
        store = self.store
        sem = getattr(store, "_hydrations", None)
        budgets = getattr(store, "budgets", None)
        max_h = getattr(budgets, "max_hydrations", 0) or 0
        if sem is None or max_h <= 0:
            return 0.0
        free = getattr(sem, "_value", max_h)
        return max(0.0, min(1.0, (max_h - free) / max_h))

    def _rss_pressure(self) -> float:
        budgets = getattr(self.store, "budgets", None)
        max_rss = getattr(budgets, "max_rss_bytes", 0) or 0
        if max_rss <= 0:
            return 0.0
        try:
            from ..store.docstore import current_rss_bytes

            return current_rss_bytes() / max_rss
        except Exception:
            return 0.0

    def load_score(self, now: Optional[float] = None) -> float:
        """The scalar load score (cached for ``sample_s``); recomputing
        also steps the brownout state machine."""
        now = obs.now() if now is None else now
        with self._lock:
            if 0 <= now - self._score_ts < self.sample_s:
                return self._score
            ewma_wait = self._decayed_wait_locked(now)
        util_term = 0.0
        expected_wait = 0.0
        backlog = None
        if self.pool is not None:
            try:
                util_term = float(self.pool.utilization())
                backlog = int(self.pool.backlog())
                expected_wait = float(self.pool.expected_wait())
            except Exception:
                util_term = 0.0
        # present beats history, both ways: the pool's expected wait
        # (deepest queue x recent service time) sees a flood the moment
        # it lands, and an EMPTY backlog refutes the decayed EWMA — a
        # score pinned on history after the flood drained would idle
        # the node through the decay half-life
        if backlog == 0:
            ewma_wait = 0.0
        wait_term = (
            max(ewma_wait, expected_wait) / max(self.target_wait_s, 1e-6)
        )
        score = max(wait_term, util_term, self._hydration_pressure(),
                    self._rss_pressure())
        with self._lock:
            self._score = score
            self._score_ts = now
        obs.gauge_set("serve.load_score", score)
        if self.enabled:
            self._update_brownout(score, now)
        return score

    # -- shedding ------------------------------------------------------------

    def _shed_threshold(self, rank: int) -> float:
        if rank <= 0:
            return float("inf")
        if rank == 1:
            return self.hard
        step = (self.hard - self.soft) / 3.0
        # rank 4 (background) sheds first, at soft; rank 2 (sync) last
        return self.soft + (4 - rank) * step

    def retry_after_ms(self, score: Optional[float] = None,
                       now: Optional[float] = None) -> int:
        """The backoff hint: roughly two current queue-wait estimates,
        scaled up with the score, clamped to a sane band."""
        now = obs.now() if now is None else now
        if score is None:
            score = self.load_score(now)
        with self._lock:
            wait = self._decayed_wait_locked(now)
        hint = max(wait * 2.0, self.target_wait_s) * max(score, 1.0) * 1000.0
        return int(max(50, min(hint, 5000)))

    def shed_rank(self, score: Optional[float] = None,
                  now: Optional[float] = None) -> int:
        """Lowest rank currently being FULLY shed (score past the top of
        its proportional band — every request of rank >= this is being
        refused, so the router should stop shipping them here);
        ``NO_SHED_RANK`` (5) when no class is fully shed."""
        if score is None:
            score = self.load_score(now)
        for rank in (1, 2, 3, 4):
            if score >= 2.0 * self._shed_threshold(rank):
                return rank
        return NO_SHED_RANK

    def shed_fraction(self, rank: int, score: float) -> float:
        """Fraction of ``rank`` work being refused at ``score``: 0 below
        the class threshold, ramping linearly to 1 across one threshold
        width ([thresh, 2*thresh]). Proportional shedding gives the
        control loop a stable operating point — a hard cutoff bang-bangs
        between "admit everything" (waits spike) and "shed everything"
        (the queue drains, the wait signal goes silent, and the node
        idles until the EWMA decays), which burns most of the node's
        capacity on the idle half of the oscillation."""
        thresh = self._shed_threshold(rank)
        if thresh == float("inf") or score < thresh:
            return 0.0
        return min(1.0, (score - thresh) / max(thresh, 1e-9))

    def admit(self, method: str, now: Optional[float] = None) -> None:
        """Gate one request at admission: raises ``Overloaded`` when the
        method's priority class is being shed (probabilistically inside
        the proportional band). No-op when disabled."""
        if not self.enabled:
            return
        rank, cls = priority_class(method)
        if rank == 0:
            return
        score = self.load_score(now)
        frac = self.shed_fraction(rank, score)
        if frac <= 0.0:
            return
        if frac < 1.0 and self._rng.random() >= frac:
            return
        ra = self.retry_after_ms(score, now)
        obs.count("serve.shed", labels={"class": cls})
        raise Overloaded(
            f"shedding {cls} work at load {score:.2f} "
            f"(retry after {ra}ms)",
            retry_after_ms=ra, shed_class=cls,
        )

    # -- advertisement (rides clusterStatus) ---------------------------------

    def advertisement(self, now: Optional[float] = None) -> Dict[str, Any]:
        score = self.load_score(now)
        shed = self.shed_rank(score) if self.enabled else NO_SHED_RANK
        out: Dict[str, Any] = {
            "score": round(score, 3),
            "shedClass": shed,
            "brownout": brownout_active(),
        }
        if shed < NO_SHED_RANK:
            out["retryAfterMs"] = self.retry_after_ms(score, now)
        return out

    # -- brownout state machine ----------------------------------------------

    def _update_brownout(self, score: float, now: float) -> None:
        with self._lock:
            if not BROWNOUT.is_set():
                self._exit_since = None
                if score >= self.brownout_enter:
                    if self._enter_since is None:
                        self._enter_since = now
                    elif now - self._enter_since >= self.enter_hold_s:
                        self._enter_brownout_locked(score)
                else:
                    self._enter_since = None
            else:
                self._enter_since = None
                if score <= self.brownout_exit:
                    if self._exit_since is None:
                        self._exit_since = now
                    elif now - self._exit_since >= self.exit_hold_s:
                        self._exit_brownout_locked(score)
                else:
                    self._exit_since = None

    def _enter_brownout_locked(self, score: float) -> None:
        BROWNOUT.set()
        self._enter_since = None
        self.transitions["on"] += 1
        if self.batcher is not None and self._batcher_base_window is None:
            try:
                self._batcher_base_window = float(self.batcher.window)
                self.batcher.window = (
                    self._batcher_base_window * self.window_widen)
            except Exception:
                self._batcher_base_window = None
        obs.gauge_set("cluster.brownout", 1.0, labels={"state": "on"})
        obs.gauge_set("cluster.brownout", 0.0, labels={"state": "off"})
        obs.count("cluster.brownout_transitions", labels={"to": "on"})
        obs.event("brownout.enter", score=round(score, 3),
                  transitions=self.transitions["on"])
        # capture the moment of degradation while the evidence is hot
        try:
            obs.flight.dump(reason="brownout")
        except Exception:
            pass

    def _exit_brownout_locked(self, score: float) -> None:
        BROWNOUT.clear()
        self._exit_since = None
        self.transitions["off"] += 1
        if self.batcher is not None and self._batcher_base_window is not None:
            try:
                self.batcher.window = self._batcher_base_window
            except Exception:
                pass
            self._batcher_base_window = None
        obs.gauge_set("cluster.brownout", 0.0, labels={"state": "on"})
        obs.gauge_set("cluster.brownout", 1.0, labels={"state": "off"})
        obs.count("cluster.brownout_transitions", labels={"to": "off"})
        obs.event("brownout.exit", score=round(score, 3),
                  transitions=self.transitions["off"])

    def reset(self) -> None:
        """Test hook: clear brownout and every accumulated signal."""
        with self._lock:
            if BROWNOUT.is_set():
                self._exit_brownout_locked(0.0)
            self._wait_ewma = 0.0
            self._wait_ts = 0.0
            self._score = 0.0
            self._score_ts = -1.0
            self._enter_since = None
            self._exit_since = None
