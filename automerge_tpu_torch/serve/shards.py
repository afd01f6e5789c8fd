"""Per-document single-writer shards: the concurrency discipline of the
serving layer.

Every request with document affinity hashes to a per-document ordered
queue. A fixed pool of workers drains those queues one document at a
time — a worker that grabs a document's queue drains up to
``max_batch`` requests in one go (the group-commit / sync-coalescing
window) and no other worker touches that document until the drain
finishes. The result: requests against the SAME document execute in
exact arrival order on one thread at a time (the single-writer
guarantee the core document needs), while requests against different
documents run fully in parallel across the pool.

Queues are bounded: a submit against a full queue fails immediately
(the server answers a ``Backpressure`` error instead of buffering
without limit — the client is the retry loop). Gauges:

* ``rpc.queue_depth{doc=...}`` — per-document queue depth at enqueue /
  drain (the registry's cardinality cap collapses a hostile handle
  churn into ``{overflow=true}``).
* ``rpc.pool_busy`` / ``rpc.pool_utilization`` — workers currently
  executing, absolute and as a fraction of the pool.

The pool is generic over the work items: the server submits
``(connection, request)`` pairs and supplies ``execute(key, items)``;
the pool owns only ordering, bounding and thread placement.
"""

from __future__ import annotations

import threading
from collections import deque
from time import monotonic as _monotonic
from typing import Callable, Dict, Hashable, List, Optional

from .. import obs


class QueueFull(Exception):
    """Raised by ``submit`` when the target document's queue is at its
    bound — the backpressure signal."""


class _DocQueue:
    __slots__ = ("items", "scheduled", "first_ts")

    def __init__(self):
        self.items: deque = deque()
        self.scheduled = False  # a worker owns (or is queued to own) this doc
        self.first_ts = 0.0  # enqueue time of the oldest queued item


class ShardPool:
    """N workers over per-key ordered bounded queues. See module docstring."""

    def __init__(
        self,
        execute: Callable[[Hashable, List], None],
        *,
        workers: int = 4,
        max_queue: int = 128,
        max_batch: int = 32,
        name: str = "shard",
    ):
        if workers <= 0:
            raise ValueError("workers must be positive")
        self._execute = execute
        self.max_queue = max(1, int(max_queue))
        self.max_batch = max(1, int(max_batch))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[Hashable, _DocQueue] = {}
        self._ready: deque = deque()  # keys with work and no owning worker
        self._stopping = False
        self._busy = 0
        self._svc_ewma = 0.0  # per-item execution seconds, EWMA
        # optional hook fed each drain's dequeue wait (seconds); the
        # admission controller installs itself here to keep a *recent*
        # wait estimate (the all-time histogram percentile cannot decay,
        # so it would pin the load score high forever after one burst)
        self.wait_observer: Optional[Callable[[float], None]] = None
        self.workers = [
            threading.Thread(
                target=self._worker, name=f"{name}-{i}", daemon=True
            )
            for i in range(workers)
        ]
        for t in self.workers:
            t.start()

    # -- submission ----------------------------------------------------------

    def submit(self, key: Hashable, item) -> None:
        """Enqueue ``item`` for ``key``; raises ``QueueFull`` at the bound."""
        with self._lock:
            if self._stopping:
                raise QueueFull("pool is shutting down")
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _DocQueue()
            if len(q.items) >= self.max_queue:
                obs.count("rpc.errors",
                          labels={"method": "submit", "type": "Backpressure"})
                raise QueueFull(
                    f"queue for doc {key!r} is full "
                    f"({self.max_queue} pending requests)"
                )
            if not q.items:
                q.first_ts = _monotonic()
            q.items.append(item)
            if not q.scheduled:
                q.scheduled = True
                self._ready.append(key)
                self._cond.notify()

    def depth(self, key: Hashable) -> int:
        with self._lock:
            q = self._queues.get(key)
            return len(q.items) if q is not None else 0

    def utilization(self) -> float:
        """Fraction of workers currently executing (0.0..1.0) — one of
        the admission controller's load signals."""
        with self._lock:
            return self._busy / (len(self.workers) or 1)

    def backlog(self) -> int:
        """Total queued items across every per-document queue."""
        with self._lock:
            return sum(len(q.items) for q in self._queues.values())

    def expected_wait(self) -> float:
        """Expected dequeue wait of the deepest queue RIGHT NOW: its
        depth times the recent per-item service time. Per-doc ordering
        means a doc's queue drains serially, so depth x service time is
        what a request arriving behind it will actually wait. This is
        the admission controller's *present-tense* congestion signal —
        the EWMA of past dequeue waits lags a flood on the way up and
        keeps shedding after the drain on the way down."""
        with self._lock:
            if not self._queues or self._svc_ewma <= 0.0:
                return 0.0
            deepest = max(
                (len(q.items) for q in self._queues.values()), default=0)
            return deepest * self._svc_ewma

    # -- the workers ---------------------------------------------------------

    def _worker(self) -> None:
        n_workers = len(self.workers) or 1
        while True:
            with self._lock:
                while not self._ready and not self._stopping:
                    self._cond.wait()
                if self._stopping and not self._ready:
                    return
                key = self._ready.popleft()
                q = self._queues[key]
                batch = []
                while q.items and len(batch) < self.max_batch:
                    batch.append(q.items.popleft())
                waited = _monotonic() - q.first_ts if batch else 0.0
                q.first_ts = _monotonic()  # the remainder starts waiting now
                self._busy += 1
                busy = self._busy
                depth = len(q.items)
            # gauges are sampled at drain boundaries, not per enqueue: a
            # gauge is a level, and per-request registry-lock traffic from
            # every submitter measurably throttles the pool
            if batch:
                # dequeue latency: how long the oldest request of this
                # drain sat queued before a worker picked the doc up
                obs.observe("serve.queue_wait", waited)
                if self.wait_observer is not None:
                    self.wait_observer(waited)
            obs.gauge_set("rpc.queue_depth", depth, labels={"doc": str(key)})
            obs.gauge_set("rpc.pool_busy", busy)
            obs.gauge_set("rpc.pool_utilization", busy / n_workers)
            t0 = _monotonic()
            try:
                if batch:
                    self._execute(key, batch)
            finally:
                dt = _monotonic() - t0
                popped = False
                with self._lock:
                    if batch:
                        per = dt / len(batch)
                        self._svc_ewma = (
                            per if self._svc_ewma <= 0.0
                            else self._svc_ewma + 0.3 * (per - self._svc_ewma)
                        )
                    self._busy -= 1
                    if q.items:
                        # still work: stay scheduled, go back in line so
                        # other documents get a worker in between
                        self._ready.append(key)
                        self._cond.notify()
                    else:
                        q.scheduled = False
                        # drop the empty queue: handles are unbounded over
                        # a server's life, the queue table must not be
                        self._queues.pop(key, None)
                        popped = True
                if popped:
                    # same hygiene for the gauge: the registry's label
                    # table is as unbounded as the queue table was. A
                    # racing submit may have re-created the queue already;
                    # its next drain simply re-creates the series.
                    obs.gauge_remove("rpc.queue_depth", {"doc": str(key)})

    # -- shutdown ------------------------------------------------------------

    def stop(self, drain: bool = True, timeout: Optional[float] = 30.0) -> None:
        """Stop the pool. ``drain=True`` lets queued work finish; False
        discards whatever has not started executing."""
        with self._lock:
            self._stopping = True
            if not drain:
                for q in self._queues.values():
                    q.items.clear()
            self._cond.notify_all()
        for t in self.workers:
            t.join(timeout=timeout)
