"""Drain-cycle performance observatory: per-cycle stage attribution.

The spans in obs/__init__ are per-*call*: one ``device.kernel`` span per
launch, one ``journal.fsync`` per sync. What no layer provided until now
is the per-*cycle* view — for one drain of the serve pool (or one
``apply_cross_doc`` pass in the bench), where did the wall clock go?
Host staging (dedup, causal ordering, column splice, delta resolution),
the device pipeline (pack, h2d, kernel, linearize, readback, scatter),
or durability (the covering group-commit fsync)? That attribution is
what decides which ROADMAP perf item to spend next (the host append
phase is the claimed ceiling — this module is the instrument that can
prove or retire that claim, and watch it regress).

Mechanics: ``with prof.cycle(kind=..., docs=..., doc=...)`` activates a
contextvar collector for the calling context. Two hooks installed into
``obs.span`` (``cycle_enter``/``cycle_exit``; a no-op global check when
this module was never imported, a contextvar read when idle) feed every
span completed inside the cycle into a fixed stage taxonomy:

* **host** — ``device.stage.dedup`` / ``device.stage.causal_order``
  (the ``_take_ready`` halves), ``device.apply`` (the staging umbrella,
  whose interior breaks down into ``device.stage.splice``,
  ``device.materialize``, ``device.delta_resolve``, ``device.extract``);
* **device** — ``device.pack``, ``device.h2d``, ``device.kernel``,
  ``device.linearize``, ``device.readback``, ``device.scatter``,
  ``device.mesh_resolve``;
* **fsync** — ``journal.fsync`` (the group-commit share of a serve
  drain's ack path).

Nesting is handled: a parent span (``device.apply``) counts toward the
attributed total exactly once; stages completing inside it land in the
breakdown table without double-counting the total, and device stages
nested under a host umbrella (the per-doc fallback path launches a
kernel *inside* ``device.apply``) are re-assigned to the device side of
the split without inflating the sum. ``attributed_frac`` is therefore a
real fraction of the measured cycle wall clock.

Each finished cycle:

* merges into the process-wide ``profiler`` aggregate (totals, a
  bounded top-K expensive-docs table, occupancy/launch counts);
* feeds fixed-cardinality histograms — ``drain.stage_seconds{stage=}``
  (one label per taxonomy stage), ``drain.attributed_fraction``,
  ``drain.occupancy``, ``drain.docs_per_launch`` — scrapeable like any
  other instrument;
* lands in the flight recorder as a ``drain.cycle_report`` event, so an
  offline ``perf-report`` can rebuild the whole aggregate from a merged
  flight dump of a dead (or remote) process.

Surfaces: ``profiler.status()`` and ``render_text`` — a host-vs-device
percentage breakdown with occupancy, docs-per-launch, queue-wait and
fsync share (the reference serves them as its ``perfStatus`` RPC and
``perf-report`` CLI, which the port does not have yet).
``torch_profile_start`` / ``torch_profile_stop`` additionally capture a
``torch.profiler`` trace (CPU and CUDA activity, written as a Chrome
trace) with a named range (``prof.annotate``: a ``record_function`` and
an NVTX range) wrapped around every kernel-launch site. A profiler that
cannot start or stop answers ``{"ok": false}``; a range that fails while
a capture is active raises.

Env knobs: ``AUTOMERGE_TPU_PROF=0`` disarms cycle collection entirely
(cycles become no-ops); ``AUTOMERGE_TPU_PROF_TOPK`` sizes the
expensive-docs table (default 8; the working set is bounded at 4x that
before pruning).
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
from contextlib import nullcontext
from time import perf_counter
from typing import Dict, List, Optional

import automerge_tpu_torch.obs as _obs
from . import heat as _heat

# -- stage taxonomy -----------------------------------------------------------

# span name -> (stage key, side). Fixed cardinality by construction: the
# histogram label set below can never exceed this table.
STAGES: Dict[str, tuple] = {
    "device.stage.dedup": ("dedup", "host"),
    "device.stage.causal_order": ("causal_order", "host"),
    "device.stage.splice": ("splice", "host"),
    # the vectorized cross-doc staging passes (ops/host_batch.py): one
    # span each per drain, covering every packed document at once
    "host.pack": ("host_pack", "host"),
    "host.sort": ("host_sort", "host"),
    "device.materialize": ("materialize", "host"),
    "device.delta_resolve": ("delta_resolve", "host"),
    "device.extract": ("extract", "host"),
    "device.pack": ("pack", "device"),
    "device.h2d": ("h2d", "device"),
    # the eager run-table expansion dispatch (merge.stage_cols_device's
    # _expander) — its own row so the run-native kernels' win (expansion
    # fused INTO the kernel, this stage -> 0) is visible, not folded
    # into h2d
    "device.expand": ("expand", "device"),
    "device.kernel": ("kernel", "device"),
    "device.linearize": ("linearize", "device"),
    "device.readback": ("readback", "device"),
    "device.scatter": ("scatter", "device"),
    "device.mesh_resolve": ("mesh", "device"),
    "serve.write": ("write", "host"),
    "journal.fsync": ("fsync", "fsync"),
}

# umbrella spans: their own duration attributes to a side exactly once
# (when they close at cycle top level); everything that completed inside
# them stays breakdown-only. device.stage.splice is both a stage row and
# a parent (device.extract runs inside it); device.batched wraps the
# whole packed pack/launch/scatter region so its glue attributes too;
# rpc.request makes a serve drain's request-handling wall attributable
# (a put/commit drain is mostly dispatch, not device work — without
# this umbrella a live perfStatus would claim the drain went nowhere).
PARENTS: Dict[str, tuple] = {
    "device.apply": (None, "host"),
    "device.stage.splice": ("splice", "host"),
    "device.batched": (None, "device"),
    "rpc.request": (None, "host"),
    # the cross-doc splice is a stage row AND a parent umbrella, so any
    # span a future splice internals nests stays breakdown-only
    "host.splice": ("host_splice", "host"),
}

# host breakdown rows that partition the host side without overlapping
# each other (extract lives inside splice, so it is excluded): host_other
# in a report is host - sum(these) - nested device time
_HOST_EXCLUSIVE = ("dedup", "causal_order", "splice", "materialize",
                   "delta_resolve", "write", "host_pack", "host_sort",
                   "host_splice")

_NOTE_KEYS = ("useful_rows", "padded_rows", "launches", "docs", "changes",
              "h2d_bytes", "h2d_dense_bytes", "overlap_s")


class _Cycle:
    """The per-cycle collector the span hooks feed."""

    __slots__ = ("kind", "t0", "parents", "stages", "host_s", "device_s",
                 "fsync_s", "nested_device_s", "notes", "doc_costs", "doc")

    def __init__(self, kind: str, docs: int = 0, doc: Optional[str] = None):
        self.kind = kind
        self.t0 = perf_counter()
        self.parents: List[str] = []  # sides of the open umbrella spans
        self.stages: Dict[str, float] = {}
        self.host_s = 0.0
        self.device_s = 0.0
        self.fsync_s = 0.0
        self.nested_device_s = 0.0
        self.notes = dict.fromkeys(_NOTE_KEYS, 0)
        if docs:
            self.notes["docs"] = docs
        self.doc_costs: Dict[str, float] = {}
        self.doc = doc  # attribute the whole cycle wall to this doc

    def _side(self, side: str, dur: float) -> None:
        if side == "host":
            self.host_s += dur
        elif side == "device":
            self.device_s += dur
        else:
            self.fsync_s += dur

    def span_enter(self, name: str) -> None:
        parent = PARENTS.get(name)
        if parent is not None:
            self.parents.append(parent[1])

    def span_exit(self, name: str, dur: float) -> None:
        parent = PARENTS.get(name)
        ks = STAGES.get(name) if parent is None else None
        if parent is None and ks is None:
            return
        # a span ENTERED before this cycle started may exit inside it
        # (an rpc.request umbrella already open when a nested cycle
        # begins): only the portion that overlaps the cycle attributes,
        # or attributed_s could exceed the cycle wall
        elapsed = perf_counter() - self.t0
        if dur > elapsed:
            dur = elapsed
        if parent is not None:
            key, side = parent
            if self.parents:
                self.parents.pop()
            if key is not None:
                self.stages[key] = self.stages.get(key, 0.0) + dur
            if not self.parents:
                self._side(side, dur)
            elif side == "device" and self.parents[-1] == "host":
                # a device umbrella (device.batched) nested under a host
                # one (rpc.request on a live accelerator serve drain):
                # its whole region is device work the split must move
                # out of the host share — its own children skipped the
                # reassignment because THEIR innermost parent is device
                self.nested_device_s += dur
            return
        key, side = ks
        self.stages[key] = self.stages.get(key, 0.0) + dur
        if not self.parents:
            self._side(side, dur)
        elif side == "device" and self.parents[-1] == "host":
            # a kernel launched inside the host umbrella (the per-doc
            # fallback path): keep the sum honest, reassign in the split
            self.nested_device_s += dur

    def note(self, key: str, v) -> None:
        self.notes[key] = self.notes.get(key, 0) + v

    def note_doc(self, name: str, seconds: float) -> None:
        self.doc_costs[name] = self.doc_costs.get(name, 0.0) + seconds

    def finish(self) -> dict:
        wall = perf_counter() - self.t0
        attributed = self.host_s + self.device_s + self.fsync_s
        if self.doc is not None:
            # the cycle's own doc gets the WHOLE wall — but staging
            # seconds note_doc'd for the same doc inside this cycle are
            # part of that wall, so take the max instead of summing
            # (a serve drain must not rank its doc twice as expensive)
            self.doc_costs[self.doc] = max(
                self.doc_costs.get(self.doc, 0.0), wall
            )
        n = self.notes
        useful, padded = n["useful_rows"], n["padded_rows"]
        return {
            "kind": self.kind,
            "wall_s": wall,
            "attributed_s": attributed,
            "attributed_frac": min(attributed / wall, 1.0) if wall > 0 else 0.0,
            # the split reassigns device work that ran nested under the
            # host umbrella, so host_s is PURE host time
            "host_s": max(self.host_s - self.nested_device_s, 0.0),
            "device_s": self.device_s + self.nested_device_s,
            "fsync_s": self.fsync_s,
            "stages": dict(self.stages),
            "docs": n["docs"],
            "changes": n["changes"],
            "launches": n["launches"],
            "useful_rows": useful,
            "padded_rows": padded,
            "occupancy": (
                useful / (useful + padded) if (useful + padded) else None
            ),
            # h2d byte accounting (merge._note_h2d): actual bytes staged
            # vs their dense equivalent — the compressed-residency win
            "h2d_bytes": n["h2d_bytes"],
            "h2d_dense_bytes": n["h2d_dense_bytes"],
            # host seconds spent while a dispatched device launch was
            # still in flight (the double-buffered drain pipeline notes
            # them at its dispatch/collect seam) — wall hidden behind
            # the kernel rather than serialized after it
            "overlap_s": n["overlap_s"],
            "overlap_frac": (
                min(n["overlap_s"] / wall, 1.0) if wall > 0 else 0.0
            ),
            "doc_costs": dict(self.doc_costs),
        }


_CUR: contextvars.ContextVar[Optional[_Cycle]] = contextvars.ContextVar(
    "automerge_tpu_torch_prof_cycle", default=None
)


# -- the span hooks (installed into obs at import) ---------------------------


def _hook_enter(name: str) -> None:
    c = _CUR.get()
    if c is not None:
        c.span_enter(name)


def _hook_exit(name: str, dur: float) -> None:
    c = _CUR.get()
    if c is not None:
        c.span_exit(name, dur)


_obs.cycle_enter = _hook_enter
_obs.cycle_exit = _hook_exit


def note(key: str, v=1) -> None:
    """Deposit a numeric fact (rows, launches, docs) into the active
    cycle; a no-op outside any cycle. Instrumented sites call this next
    to their obs counters so per-cycle occupancy/launch figures exist
    without a racy global-counter diff."""
    c = _CUR.get()
    if c is not None:
        c.note(key, v)


def note_doc(name: Optional[str], seconds: float) -> None:
    """Attribute ``seconds`` of the active cycle to a document (by its
    durable name or a synthetic label) — feeds the top-K table."""
    c = _CUR.get()
    if c is not None and name:
        c.note_doc(str(name), seconds)


# -- the process-wide aggregate ----------------------------------------------


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class CycleProfiler:
    """Process-wide aggregate of finished cycle reports, plus the
    bounded top-K expensive-docs table. Thread-safe; one exists
    (``prof.profiler``)."""

    def __init__(self, top_k: Optional[int] = None):
        self.enabled = os.environ.get("AUTOMERGE_TPU_PROF", "1") != "0"
        self.top_k = top_k or _env_int("AUTOMERGE_TPU_PROF_TOPK", 8)
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.cycles = 0
            self.wall_s = 0.0
            self.attributed_s = 0.0
            self.host_s = 0.0
            self.device_s = 0.0
            self.fsync_s = 0.0
            self.stage_s: Dict[str, float] = {}
            self.useful_rows = 0
            self.padded_rows = 0
            self.launches = 0
            self.docs = 0
            self.changes = 0
            self.h2d_bytes = 0
            self.h2d_dense_bytes = 0
            self.overlap_s = 0.0
            self._doc_costs: Dict[str, float] = {}

    def record(self, report: dict) -> None:
        """Merge one finished cycle; export the fixed-cardinality
        histograms and the flight-recorder event."""
        with self._lock:
            self.cycles += 1
            self.wall_s += report["wall_s"]
            self.attributed_s += report["attributed_s"]
            self.host_s += report["host_s"]
            self.device_s += report["device_s"]
            self.fsync_s += report["fsync_s"]
            for k, v in report["stages"].items():
                self.stage_s[k] = self.stage_s.get(k, 0.0) + v
            self.useful_rows += report["useful_rows"]
            self.padded_rows += report["padded_rows"]
            self.launches += report["launches"]
            self.docs += report["docs"]
            self.changes += report["changes"]
            self.h2d_bytes += report.get("h2d_bytes", 0)
            self.h2d_dense_bytes += report.get("h2d_dense_bytes", 0)
            self.overlap_s += report.get("overlap_s", 0.0)
            for d, s in report["doc_costs"].items():
                self._doc_costs[d] = self._doc_costs.get(d, 0.0) + s
            # bounded: past 4x the table prunes to the K most expensive
            # (space-saving flavor — a consistently cheap doc may rotate
            # out, a whale never does)
            if len(self._doc_costs) > 4 * self.top_k:
                keep = sorted(
                    self._doc_costs.items(), key=lambda kv: -kv[1]
                )[: self.top_k]
                self._doc_costs = dict(keep)
        # attributed drain seconds are the cost half of the heat signal:
        # a doc can be request-cold but drain-expensive (huge merges),
        # and the advisor needs to see that
        for d, s in report["doc_costs"].items():
            _heat.note(d, "drain_s", s)
        _obs.observe("drain.attributed_fraction", report["attributed_frac"])
        _obs.observe("drain.overlap_fraction", report.get("overlap_frac", 0.0))
        for k, v in report["stages"].items():
            _obs.observe("drain.stage_seconds", v, labels={"stage": k})
        if report["occupancy"] is not None:
            _obs.observe("drain.occupancy", report["occupancy"])
        if report["launches"]:
            _obs.observe(
                "drain.docs_per_launch", report["docs"] / report["launches"]
            )
        ev = {
            "kind": report["kind"],
            "wall_s": round(report["wall_s"], 6),
            "attributed_s": round(report["attributed_s"], 6),
            "host_s": round(report["host_s"], 6),
            "device_s": round(report["device_s"], 6),
            "fsync_s": round(report["fsync_s"], 6),
            "docs": report["docs"],
            "changes": report["changes"],
            "launches": report["launches"],
            "useful_rows": report["useful_rows"],
            "padded_rows": report["padded_rows"],
            "h2d_bytes": report.get("h2d_bytes", 0),
            "h2d_dense_bytes": report.get("h2d_dense_bytes", 0),
            "overlap_s": round(report.get("overlap_s", 0.0), 6),
        }
        for k, v in report["stages"].items():
            ev[f"stage_{k}_s"] = round(v, 6)
        _obs.event("drain.cycle_report", **ev)

    def top_docs(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            items = sorted(self._doc_costs.items(), key=lambda kv: -kv[1])
        return [
            {"doc": d, "seconds": round(s, 6)}
            for d, s in items[: n or self.top_k]
        ]

    def status(self, top: Optional[int] = None) -> dict:
        """The merged report the ``perfStatus`` RPC / ``perf-report``
        CLI render: cumulative stage attribution with a host/device
        split, occupancy, docs-per-launch, queue-wait and drain-cycle
        percentiles, and the top-K expensive-docs table."""
        with self._lock:
            agg = {
                "cycles": self.cycles,
                "wall_s": self.wall_s,
                "attributed_s": self.attributed_s,
                "host_s": self.host_s,
                "device_s": self.device_s,
                "fsync_s": self.fsync_s,
                "stages": dict(self.stage_s),
                "useful_rows": self.useful_rows,
                "padded_rows": self.padded_rows,
                "launches": self.launches,
                "docs": self.docs,
                "changes": self.changes,
                "h2d_bytes": self.h2d_bytes,
                "h2d_dense_bytes": self.h2d_dense_bytes,
                "overlap_s": self.overlap_s,
            }
        out = summarize(agg)
        out["enabled"] = self.enabled
        out["torch_profiler"] = dict(_torch_trace)
        out["top_docs"] = self.top_docs(top)
        # extraction-cache efficacy: extract is a named dominant host
        # stage, and hit ratio is what separates "re-decoding the same
        # changes" from real staging work (None = never consulted)
        hits = _obs.counter_values("extract.change_cache_hit", "").get("", 0)
        misses = _obs.counter_values(
            "extract.change_cache_miss", "").get("", 0)
        out["extract_cache"] = {
            "hits": hits,
            "misses": misses,
            "cache_hit_ratio": (
                round(hits / (hits + misses), 4) if (hits + misses) else None
            ),
        }
        # the heat observatory rides along so one perfStatus answer (and
        # one offline perf-report) shows cost AND demand per document
        out["heat"] = _heat.snapshot(top=top or self.top_k)
        out["drain_cycle_seconds"] = {
            f"p{int(q * 100)}": round(v, 6)
            for q, v in _obs.percentiles("drain.cycle_seconds").items()
        }
        out["queue_wait_seconds"] = {
            f"p{int(q * 100)}": round(v, 6)
            for q, v in _obs.percentiles("serve.queue_wait").items()
        }
        return out


def summarize(agg: dict) -> dict:
    """Percentage view over cumulative cycle totals — shared by the live
    ``profiler.status()`` and the offline flight-dump reducer, so both
    surfaces render the identical shape."""
    wall = agg["wall_s"]
    attributed = agg["attributed_s"]
    split_total = agg["host_s"] + agg["device_s"] + agg["fsync_s"]
    useful, padded = agg["useful_rows"], agg["padded_rows"]
    stages = agg["stages"]
    host_other = max(
        agg["host_s"]
        - sum(stages.get(k, 0.0) for k in _HOST_EXCLUSIVE),
        0.0,
    )
    pct = lambda x, of: round(100.0 * x / of, 1) if of > 0 else 0.0  # noqa: E731
    return {
        "cycles": agg["cycles"],
        "wall_s": round(wall, 6),
        "attributed_s": round(attributed, 6),
        "attributed_frac": (
            round(min(attributed / wall, 1.0), 4) if wall > 0 else 0.0
        ),
        "host_pct": pct(agg["host_s"], split_total),
        "device_pct": pct(agg["device_s"], split_total),
        "fsync_pct": pct(agg["fsync_s"], split_total),
        "host_s": round(agg["host_s"], 6),
        "device_s": round(agg["device_s"], 6),
        "fsync_s": round(agg["fsync_s"], 6),
        "host_other_s": round(host_other, 6),
        "stages": {
            k: {"seconds": round(v, 6), "pct_of_wall": pct(v, wall)}
            for k, v in sorted(stages.items(), key=lambda kv: -kv[1])
        },
        "occupancy": (
            round(useful / (useful + padded), 4) if (useful + padded) else None
        ),
        "useful_rows": useful,
        "padded_rows": padded,
        # h2d byte accounting across the cycles: actual staged bytes vs
        # dense equivalent — the compressed-residency h2d win as a ratio
        "h2d_bytes": agg.get("h2d_bytes", 0),
        "h2d_dense_bytes": agg.get("h2d_dense_bytes", 0),
        "h2d_compress_ratio": (
            round(agg.get("h2d_dense_bytes", 0) / agg["h2d_bytes"], 2)
            if agg.get("h2d_bytes") else None
        ),
        # pipelined-drain overlap: host seconds that ran while a device
        # launch was in flight, as a fraction of the drain wall (0 = the
        # two halves serialized, -> 1 = wall collapsed to max(host, device))
        "overlap_s": round(agg.get("overlap_s", 0.0), 6),
        "overlap_fraction": (
            round(min(agg.get("overlap_s", 0.0) / wall, 1.0), 4)
            if wall > 0 else 0.0
        ),
        "launches": agg["launches"],
        "docs": agg["docs"],
        "changes": agg["changes"],
        "docs_per_launch": (
            round(agg["docs"] / agg["launches"], 2) if agg["launches"] else None
        ),
    }


profiler = CycleProfiler()


class cycle:
    """``with prof.cycle(kind="serve", doc=name):`` — collect every span
    the calling context completes until exit, then fold the report into
    the process aggregate. ``self.report`` holds the finished report
    after exit (None when profiling is disarmed). Re-entrant: an inner
    cycle shadows the outer for its duration."""

    __slots__ = ("kind", "docs", "doc", "_c", "_tok", "report")

    def __init__(self, kind: str = "drain", docs: int = 0,
                 doc: Optional[str] = None):
        self.kind = kind
        self.docs = docs
        self.doc = doc
        self.report = None

    def __enter__(self):
        if not profiler.enabled:
            self._tok = None
            return self
        self._c = _Cycle(self.kind, docs=self.docs, doc=self.doc)
        self._tok = _CUR.set(self._c)
        return self

    def __exit__(self, *exc):
        if self._tok is None:
            return False
        _CUR.reset(self._tok)
        self.report = self._c.finish()
        profiler.record(self.report)
        return False


def summarize_reports(reports: List[dict]) -> dict:
    """Reduce raw cycle reports (e.g. one bench config's drains) into
    the same summary shape ``profiler.status()`` serves."""
    agg = {
        "cycles": 0, "wall_s": 0.0, "attributed_s": 0.0, "host_s": 0.0,
        "device_s": 0.0, "fsync_s": 0.0, "stages": {}, "useful_rows": 0,
        "padded_rows": 0, "launches": 0, "docs": 0, "changes": 0,
        "h2d_bytes": 0, "h2d_dense_bytes": 0, "overlap_s": 0.0,
    }
    for r in reports:
        agg["cycles"] += 1
        for k in ("wall_s", "attributed_s", "host_s", "device_s", "fsync_s"):
            agg[k] += r[k]
        for k in ("useful_rows", "padded_rows", "launches", "docs", "changes",
                  "h2d_bytes", "h2d_dense_bytes", "overlap_s"):
            agg[k] += r.get(k, 0)
        for k, v in r["stages"].items():
            agg["stages"][k] = agg["stages"].get(k, 0.0) + v
    return summarize(agg)


def summarize_flight_events(events: List[dict]) -> dict:
    """Rebuild the aggregate from flight-recorder ``drain.cycle_report``
    events (the offline ``perf-report`` path over a merged or raw flight
    dump). Event fields are the flat numeric form ``record`` emitted."""
    reports = []
    for e in events:
        if e.get("name") != "drain.cycle_report":
            continue
        f = e.get("fields") or {}

        def num(k, default=0.0):
            try:
                return float(f.get(k, default))
            except (TypeError, ValueError):
                return default

        stages = {
            k[len("stage_"):-2]: num(k)
            for k in f
            if k.startswith("stage_") and k.endswith("_s")
        }
        reports.append({
            "wall_s": num("wall_s"),
            "attributed_s": num("attributed_s"),
            "host_s": num("host_s"),
            "device_s": num("device_s"),
            "fsync_s": num("fsync_s"),
            "stages": stages,
            "useful_rows": int(num("useful_rows")),
            "padded_rows": int(num("padded_rows")),
            "launches": int(num("launches")),
            "docs": int(num("docs")),
            "changes": int(num("changes")),
            "h2d_bytes": int(num("h2d_bytes")),
            "h2d_dense_bytes": int(num("h2d_dense_bytes")),
            "overlap_s": num("overlap_s"),
        })
    out = summarize_reports(reports)
    out["source"] = "flight"
    return out


def render_text(summary: dict, top: Optional[int] = None) -> str:
    """The human perf-report: host-vs-device percentage breakdown, stage
    table, occupancy, and the expensive-docs tail."""
    lines = []
    frac = summary.get("attributed_frac", 0.0)
    lines.append(
        f"drain cycles: {summary.get('cycles', 0)}   "
        f"wall {summary.get('wall_s', 0.0):.4f}s   "
        f"attributed {100.0 * frac:.1f}%"
    )
    lines.append(
        f"split: host {summary.get('host_pct', 0.0):.1f}%  |  "
        f"device {summary.get('device_pct', 0.0):.1f}%  |  "
        f"fsync {summary.get('fsync_pct', 0.0):.1f}%"
    )
    stages = summary.get("stages") or {}
    # the host/device share of the measured drain wall itself, plus how
    # the host half split between the vectorized cross-doc staging
    # passes (host_pack/host_sort/host_splice) and the scalar per-doc
    # fallback (splice) — the ROADMAP item 4 acceptance line
    wall = summary.get("wall_s", 0.0)
    if wall > 0:
        hs = summary.get("host_s", 0.0)
        ds = summary.get("device_s", 0.0)
        vec = sum(
            stages.get(k, {}).get("seconds", 0.0)
            for k in ("host_pack", "host_sort", "host_splice")
        )
        sca = stages.get("splice", {}).get("seconds", 0.0)
        lines.append(
            f"share of wall: host {100.0 * hs / wall:.1f}%  |  "
            f"device {100.0 * ds / wall:.1f}%   "
            f"(host staging: vectorized {100.0 * vec / wall:.1f}%, "
            f"scalar {100.0 * sca / wall:.1f}%)"
        )
    ov = summary.get("overlap_s", 0.0)
    if ov:
        lines.append(
            f"pipeline overlap: {100.0 * summary.get('overlap_fraction', 0.0):.1f}% "
            f"of wall ({ov:.4f}s host work under in-flight launches)"
        )
    ec = summary.get("extract_cache") or {}
    if ec.get("cache_hit_ratio") is not None:
        lines.append(
            f"extract cache: {100.0 * ec['cache_hit_ratio']:.1f}% hits "
            f"({ec.get('hits', 0)}/{ec.get('hits', 0) + ec.get('misses', 0)})"
        )
    # h2d byte accounting: what the compressed staging actually moved vs
    # its dense equivalent (ops/compressed.py / merge.stage_cols_device)
    hb = summary.get("h2d_bytes", 0)
    if hb:
        ratio = summary.get("h2d_compress_ratio")
        lines.append(
            f"h2d: {hb} bytes staged "
            f"(dense equivalent {summary.get('h2d_dense_bytes', 0)}, "
            f"compress ratio {ratio if ratio is not None else 1.0}x)"
        )
    if stages:
        lines.append(f"  {'stage':<14} {'seconds':>10} {'% wall':>8}")
        for k, v in stages.items():
            lines.append(
                f"  {k:<14} {v['seconds']:>10.4f} {v['pct_of_wall']:>7.1f}%"
            )
        other = summary.get("host_other_s", 0.0)
        if other:
            wall = summary.get("wall_s", 0.0) or 1.0
            lines.append(
                f"  {'host_other':<14} {other:>10.4f} "
                f"{100.0 * other / wall:>7.1f}%"
            )
    occ = summary.get("occupancy")
    if occ is not None:
        lines.append(
            f"occupancy: {100.0 * occ:.1f}% "
            f"(useful {summary.get('useful_rows', 0)} rows, "
            f"padded {summary.get('padded_rows', 0)} rows)"
        )
    if summary.get("docs_per_launch") is not None:
        lines.append(
            f"launches: {summary.get('launches', 0)} "
            f"({summary['docs_per_launch']} docs/launch)"
        )
    for key, label in (("drain_cycle_seconds", "drain cycle"),
                       ("queue_wait_seconds", "queue wait")):
        q = summary.get(key)
        if q and any(q.values()):
            lines.append(
                f"{label}: p50 {q.get('p50', 0.0):.6f}s  "
                f"p95 {q.get('p95', 0.0):.6f}s  p99 {q.get('p99', 0.0):.6f}s"
            )
    td = summary.get("top_docs") or []
    if td:
        lines.append("top docs by attributed seconds:")
        for e in td[: top or len(td)]:
            lines.append(f"  {e['doc']:<32} {e['seconds']:.4f}s")
    he = (summary.get("heat") or {}).get("entries") or []
    if he:
        lines.append("doc heat (decayed per-second rates):")
        for e in he[: top or len(he)]:
            rates = "  ".join(
                f"{k} {v:.2f}/s"
                for k, v in sorted((e.get("rates") or {}).items())
            )
            lines.append(
                f"  {e['doc']:<32} rank {e.get('rank', 0.0):.2f}  {rates}"
            )
    jp = summary.get("torch_profiler")
    if jp and jp.get("active"):
        lines.append(f"torch profiler capture ACTIVE -> {jp.get('dir')}")
    return "\n".join(lines) + "\n"


# -- torch.profiler capture (profileStart / profileStop) ----------------------

# JSON-able capture state (``status()`` reports it); the live profiler
# object and whether ranges also go to NVTX stay beside it
_torch_trace = {"active": False, "dir": None}
_torch_prof = {"profile": None, "nvtx": False}
_torch_lock = threading.Lock()

# the Chrome trace a capture writes into its directory
TRACE_FILE = "torch_trace.json"


def torch_profile_start(directory: Optional[str] = None) -> dict:
    """Start a ``torch.profiler`` capture (CPU activity on every thread,
    and CUDA activity when a card is present) whose Chrome trace
    ``torch_profile_stop`` writes into ``directory`` (a fresh temp dir
    when omitted). A profiler
    that cannot start answers ``{"ok": false, "reason": ...}`` and counts
    ``device.profiler_unavailable{reason=}``: this is capture tooling,
    and no kernel changes its route because of it."""
    with _torch_lock:
        if _torch_trace["active"]:
            return {"ok": False, "reason": "capture already active",
                    "dir": _torch_trace["dir"]}
        if directory is None:
            import tempfile

            directory = tempfile.mkdtemp(prefix="amtpu_torchprof_")
        try:
            import torch
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(directory, exist_ok=True)
            cuda = torch.cuda.is_available()
            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            # every thread's ranges: a server starts the capture on a
            # connection thread while its workers and the batcher's
            # leader launch the kernels
            p = profile(activities=acts, experimental_config=_ExperimentalConfig(
                profile_all_threads=True))
            p.start()
        except Exception as e:  # noqa: BLE001 — answered, never raised
            _obs.count("device.profiler_unavailable",
                       labels={"reason": type(e).__name__})
            _obs.event("device.profiler_error", op="start",
                       error=str(e)[:200])
            return {"ok": False, "reason": str(e)[:200]}
        _torch_prof.update(profile=p, nvtx=cuda)
        _torch_trace.update(active=True, dir=directory)
        _obs.count("device.profiler_captures")
        return {"ok": True, "dir": directory}


def torch_profile_stop() -> dict:
    """Stop the active capture and write its Chrome trace (open it at
    https://ui.perfetto.dev); the response names the directory and the
    trace file."""
    with _torch_lock:
        if not _torch_trace["active"]:
            return {"ok": False, "reason": "no active capture"}
        d = _torch_trace["dir"]
        p = _torch_prof["profile"]
        _torch_trace.update(active=False, dir=None)
        _torch_prof.update(profile=None, nvtx=False)
        try:
            p.stop()
            path = os.path.join(d, TRACE_FILE)
            p.export_chrome_trace(path)
            if not os.path.exists(path):  # the exporter logs, not raises
                raise OSError(f"no trace written to {path}")
        except Exception as e:  # noqa: BLE001
            _obs.count("device.profiler_unavailable",
                       labels={"reason": type(e).__name__})
            _obs.event("device.profiler_error", op="stop",
                       error=str(e)[:200])
            return {"ok": False, "reason": str(e)[:200], "dir": d}
        return {"ok": True, "dir": d, "trace": path}


class _Range:
    """A named range around a kernel-launch site: a
    ``torch.profiler.record_function`` (a CPU range in the capture, and
    the GPU range over the kernels it launches) and, on the card, an NVTX
    range. Neither synchronizes; a failing NVTX call raises."""

    __slots__ = ("name", "nvtx", "_rf")

    def __init__(self, name: str, nvtx: bool):
        self.name = name
        self.nvtx = nvtx
        self._rf = None

    def __enter__(self):
        import torch

        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self.nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False


def annotate(name: str):
    """A named range (``_Range``) around a kernel-launch site while a
    capture is active; a free ``nullcontext`` otherwise (the common case
    costs one dict read)."""
    if not _torch_trace["active"]:
        return nullcontext()
    return _Range(name, _torch_prof["nvtx"])


def _union_us(spans, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] that the (start, end) intervals cover."""
    total, end = 0.0, lo
    for s, e in sorted(spans):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def read_capture(path: str, window: Optional[str] = None) -> dict:
    """What a capture's Chrome trace (``torch_profile_stop()["trace"]``)
    says of the card: each named range (``amtpu.*``) with its count and
    the CUDA kernels launched inside it (a launch on the range's thread
    between its ends, joined to its kernel by correlation id), and the
    device busy share of a window: the union of the kernel intervals over
    the window's wall. ``window`` names a range (e.g. a
    ``record_function`` around the work measured); None takes the span
    of every event in the trace."""
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_corr: Dict[object, int] = {}
    for k in kernels:
        c = (k.get("args") or {}).get("correlation")
        by_corr[c] = by_corr.get(c, 0) + 1
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and (e.get("args") or {}).get("correlation") in by_corr]
    user = [e for e in events if e.get("cat") == "user_annotation"]
    ranges: Dict[str, dict] = {}
    for r in user:
        if not r["name"].startswith("amtpu."):
            continue
        t0, t1 = r["ts"], r["ts"] + r["dur"]
        n = sum(by_corr[l["args"]["correlation"]] for l in launches
                if l.get("tid") == r.get("tid") and t0 <= l["ts"] <= t1)
        slot = ranges.setdefault(r["name"], {"count": 0, "kernels": 0})
        slot["count"] += 1
        slot["kernels"] += n
    if window is not None:
        w = [r for r in user if r["name"] == window]
        if not w:
            raise ValueError(f"no range {window!r} in {path}")
        lo, hi = min(r["ts"] for r in w), max(r["ts"] + r["dur"] for r in w)
    else:
        lo = min(e["ts"] for e in events)
        hi = max(e["ts"] + e["dur"] for e in events)
    inside = [(k["ts"], k["ts"] + k["dur"]) for k in kernels
              if k["ts"] < hi and k["ts"] + k["dur"] > lo]
    busy = _union_us(inside, lo, hi)
    wall = hi - lo
    return {"ranges": ranges, "kernels": len(inside), "window_s": wall / 1e6,
            "busy_s": busy / 1e6, "busy_share": busy / wall if wall > 0 else 0.0}
