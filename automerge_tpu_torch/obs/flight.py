"""Flight recorder: bounded in-memory history, dumped on exit/failover.

Every process keeps cheap bounded rings of what just happened — the span
ring (obs/spans.py ``SpanRecorder``), a ring of structured events
(``obs.event``), and a ring of metric deltas (every ``obs.count`` /
``gauge_set`` / ``observe`` call) — plus RTT clock-sync samples against
its peers. ``dump()`` writes all of it, with a full metrics snapshot, as
one JSON file; the intended triggers are process exit (``install()``
registers an atexit hook, which also covers a handled SIGTERM and an
unhandled crash), and explicit postmortem moments like a router
failover.

``merge_flights()`` stitches several processes' dumps into one
Perfetto/Chrome-trace timeline. Clocks align in two layers:

* every dump carries ``origin_wall`` — the wall-clock time of that
  process's monotonic span origin — which lines up processes on one
  host;
* RTT samples (``note_clock_sync``: request send/receive times around a
  peer's reported monotonic "now", e.g. the leader's ``replPing`` round
  trips and the router's ``clusterStatus`` polls) refine the offset
  NTP-style from the RTT midpoint, and propagate transitively
  (router -> leader -> follower) from the first dump as reference.

Cross-process span identity needs no rewriting: span ids are minted from
a process-random base (obs/spans.py), so a child's ``parent_id`` (or a
group-commit span's ``links``) in one dump resolves against a span in
another dump directly.

Env knobs: ``AUTOMERGE_TPU_FLIGHT_BUFFER`` sizes the event/delta rings
(default 2048; 0 disables their recording — the span ring has its own
``AUTOMERGE_TPU_SPAN_BUFFER``), ``AUTOMERGE_TPU_FLIGHT_DIR`` makes the
server entry points (``rpc.main``, the cluster router) install the
recorder at startup.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import signal
import statistics
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .spans import now as _mono_now

_SAFE_NAME = re.compile(r"[^A-Za-z0-9._-]")


class FlightRecorder:
    """Bounded recent-history rings + dump/install. One per process,
    constructed by ``obs/__init__`` around the global span recorder and
    metrics registry."""

    def __init__(self, span_recorder, registry, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(
                    os.environ.get("AUTOMERGE_TPU_FLIGHT_BUFFER", "2048"))
            except ValueError:
                capacity = 2048
        self.capacity = max(capacity, 0)
        self._spans = span_recorder
        self._registry = registry
        self.events: deque = deque(maxlen=max(self.capacity, 1))
        self.deltas: deque = deque(maxlen=max(self.capacity, 1))
        self.clock_sync: deque = deque(maxlen=256)
        self.node_id: Optional[str] = None
        self.dir: Optional[str] = None
        self._lock = threading.Lock()
        self._seq = 0
        self._installed = False
        self._signal_installed = False
        # optional callable returning the history-ring status dict
        # (obs/history.py sets it when the sampler starts) so every
        # dump carries the metric trend that led up to it
        self.history_provider = None

    # -- recording (hot-ish paths: one deque append, no locks) ---------------

    def note_event(self, name: str, fields: dict) -> None:
        if self.capacity:
            self.events.append((_mono_now(), name, dict(fields)))

    def note_delta(self, kind: str, name: str,
                   labels: Optional[dict], value) -> None:
        if self.capacity:
            self.deltas.append(
                (_mono_now(), kind, name,
                 dict(labels) if labels else None, value))

    def note_clock_sync(self, peer: str, t_send: float, t_recv: float,
                        peer_now: float) -> None:
        """One RTT sample against ``peer``: our monotonic clock read
        before/after a round trip whose response carried the peer's own
        monotonic ``now``. The midpoint estimates simultaneity."""
        self.clock_sync.append(
            {"peer": str(peer), "t_send": t_send, "t_recv": t_recv,
             "peer_now": peer_now})

    # -- lifecycle -----------------------------------------------------------

    def install(self, directory: str, node_id: str) -> None:
        """Dump into ``directory`` as ``flight-<node_id>-<pid>-<n>.json``
        on process exit (atexit covers clean exits, handled SIGTERM and
        crash-unwinds) and on SIGUSR2 (a wedged-but-alive node can be
        snapshotted without killing it); explicit ``dump()`` calls
        (failover) also land there. Idempotent."""
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.node_id = _SAFE_NAME.sub("_", str(node_id))[:64] or "proc"
        if not self._installed:
            self._installed = True
            atexit.register(self._atexit_dump)
        if not self._signal_installed:
            # only the main thread may set handlers; an embedding that
            # installs from a worker thread just skips the signal hook
            try:
                signal.signal(signal.SIGUSR2, self._on_sigusr2)
                self._signal_installed = True
            except (ValueError, AttributeError, OSError):
                pass

    def _on_sigusr2(self, signum, frame) -> None:
        try:
            self.dump(reason="signal")
        except Exception:  # noqa: BLE001 — a probe must not kill the node
            pass

    def _atexit_dump(self) -> None:
        try:
            self.dump(reason="exit")
        except Exception:  # noqa: BLE001 — dying must not die harder
            pass

    # -- dumping -------------------------------------------------------------

    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> Optional[str]:
        """Write the flight data as one JSON file; returns the path, or
        None when no explicit path was given and ``install()`` never
        configured a directory."""
        if path is None:
            if self.dir is None:
                return None
            with self._lock:
                self._seq += 1
                seq = self._seq
            path = os.path.join(
                self.dir,
                f"flight-{self.node_id}-{os.getpid()}-{seq}.json")
        mono = _mono_now()
        doc = {
            "format": "automerge_tpu-flight-v1",
            "node_id": self.node_id or f"pid{os.getpid()}",
            "pid": os.getpid(),
            "reason": reason,
            # wall-clock instant of this process's monotonic origin: the
            # coarse cross-process alignment (RTT samples refine it)
            "origin_wall": time.time() - mono,
            "dumped_at_mono": mono,
            "spans": [r.to_dict() for r in self._spans.snapshot()],
            "events": [
                {"t": t, "name": n, "fields": f}
                for t, n, f in list(self.events)
            ],
            "metric_deltas": [
                {"t": t, "kind": k, "name": n, "labels": lb, "value": v}
                for t, k, n, lb, v in list(self.deltas)
            ],
            "metrics": self._registry.snapshot(),
            "clock_sync": list(self.clock_sync),
        }
        if self.history_provider is not None:
            try:
                doc["history"] = self.history_provider()
            except Exception:  # noqa: BLE001 — trend data is best-effort
                pass
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# -- multi-process merge ------------------------------------------------------


def _rtt_offsets(dumps: List[dict]) -> Dict[str, float]:
    """``origin_wall`` per node, refined transitively from RTT samples.

    A sample in dump A about peer B says: B's monotonic clock read
    ``peer_now`` at A-monotonic midpoint ``m`` — so B's origin happened
    at wall time ``wall_A(m) - peer_now = A.origin_wall + m - peer_now``
    (median over samples). The BFS roots at the dump holding the most
    samples (the router in a full cluster — it probes every leader; a
    leader otherwise — it pings its followers), so router -> leader ->
    follower chains align even when only adjacent pairs exchanged
    pings. Samplers are only ever on the probing side, so rooting at an
    unsampled follower would reach nobody. Nodes no sample chain
    reaches keep their self-reported ``origin_wall``."""
    by_node = {d["node_id"]: d for d in dumps}
    origin = {n: d.get("origin_wall", 0.0) for n, d in by_node.items()}
    root = max(
        by_node, key=lambda n: len(by_node[n].get("clock_sync", ())),
        default=None,
    )
    frontier = [root] if root is not None else []
    visited = set(frontier)
    while frontier:
        nxt: List[str] = []
        for node in frontier:
            samples: Dict[str, List[float]] = {}
            for s in by_node[node].get("clock_sync", ()):
                peer = s.get("peer")
                if peer not in by_node or peer in visited:
                    continue
                m = (s["t_send"] + s["t_recv"]) / 2.0
                samples.setdefault(peer, []).append(
                    origin[node] + m - s["peer_now"])
            for peer, ests in samples.items():
                origin[peer] = statistics.median(ests)
                visited.add(peer)
                nxt.append(peer)
        frontier = nxt
    return origin


def merge_flights(paths: List[str]) -> Tuple[dict, dict]:
    """Stitch flight dumps into one Chrome-trace/Perfetto document.

    Returns ``(trace_doc, info)``: the trace has one pid per process
    (named by node id), every span as a complete ("X") event on the
    clock-aligned shared timeline, and every recorded flight event as an
    instant ("i") event. Span/parent/link ids pass through untouched —
    they are globally unique — so one propagated trace renders as a
    connected request across processes."""
    raw = []
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        if d.get("format") != "automerge_tpu-flight-v1":
            raise ValueError(f"{p}: not a flight dump")
        raw.append(d)
    if not raw:
        raise ValueError("no flight dumps to merge")
    # one process may dump several times (a router dumps at failover AND
    # exit) under one node id, with overlapping span rings: collapse to
    # one dump per node — union spans by span_id and events by identity,
    # latest dump's metadata wins — so a span renders once, under one pid
    by_node_order: List[str] = []
    merged_dumps: Dict[str, dict] = {}
    for d in sorted(raw, key=lambda d: d.get("dumped_at_mono", 0.0)):
        node = d["node_id"]
        prev = merged_dumps.get(node)
        if prev is None:
            by_node_order.append(node)
            merged_dumps[node] = d
            continue
        spans = {s["span_id"]: s for s in prev["spans"]}
        spans.update((s["span_id"], s) for s in d["spans"])
        events = {(e["t"], e["name"]): e
                  for e in prev.get("events", ())}
        events.update(((e["t"], e["name"]), e)
                      for e in d.get("events", ()))
        d = dict(d)
        d["spans"] = sorted(spans.values(), key=lambda s: s["start"])
        d["events"] = sorted(events.values(), key=lambda e: e["t"])
        d["clock_sync"] = list(prev.get("clock_sync", ())) + list(
            d.get("clock_sync", ()))
        merged_dumps[node] = d
    dumps = [merged_dumps[n] for n in by_node_order]
    origin = _rtt_offsets(dumps)
    t0 = min(
        origin[d["node_id"]] + s["start"]
        for d in dumps for s in d["spans"]
    ) if any(d["spans"] for d in dumps) else min(origin.values())

    events: List[dict] = []
    for pid, d in enumerate(dumps, start=1):
        ow = origin[d["node_id"]]
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": d["node_id"]},
        })
        for s in d["spans"]:
            args = dict(s.get("fields") or {})
            args["span_id"] = s["span_id"]
            if s.get("parent_id") is not None:
                args["parent_id"] = s["parent_id"]
            if s.get("trace_id") is not None:
                args["trace_id"] = s["trace_id"]
            if s.get("links"):
                args["links"] = s["links"]
            if s.get("status", "ok") != "ok":
                args["status"] = s["status"]
            events.append({
                "name": s["name"], "cat": "automerge_tpu", "ph": "X",
                "ts": round((ow + s["start"] - t0) * 1e6, 3),
                "dur": round(s["duration"] * 1e6, 3),
                "pid": pid, "tid": s.get("thread_id", 0),
                "args": args,
            })
        for e in d.get("events", ()):
            events.append({
                "name": e["name"], "cat": "automerge_tpu.event", "ph": "i",
                "ts": round((ow + e["t"] - t0) * 1e6, 3),
                "pid": pid, "tid": 0, "s": "p",
                "args": dict(e.get("fields") or {}),
            })
    events.sort(key=lambda e: e.get("ts", -1))
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "automerge_tpu_torch.obs.flight"},
    }
    info = {
        "processes": {
            d["node_id"]: {
                "pid": i + 1,
                "spans": len(d["spans"]),
                "events": len(d.get("events", ())),
                "aligned": (
                    "rtt" if abs(origin[d["node_id"]]
                                 - d.get("origin_wall", 0.0)) > 1e-12
                    else "wall"
                ),
            }
            for i, d in enumerate(dumps)
        },
        "spans": sum(len(d["spans"]) for d in dumps),
    }
    return doc, info
