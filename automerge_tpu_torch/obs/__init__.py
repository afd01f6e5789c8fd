"""Unified observability: labeled metrics + hierarchical spans.

The single entry point the rest of the codebase instruments against
(``trace.py`` keeps its ``count``/``time``/``span``/``event`` names as
thin shims over this module):

* ``obs.count(name, n, labels={...}, **fields)`` — labeled counter; the
  aggregate (label-summed) value also lands in the legacy
  ``trace.counters`` dict so existing consumers keep working.
* ``obs.gauge_set(name, v, labels=...)`` — last-write-wins gauge.
* ``obs.observe(name, v, labels=...)`` — histogram observation.
* ``with obs.span(name, labels=..., **fields):`` — hierarchical timed
  span: nests via a contextvar, accumulates wall time into the legacy
  ``trace.timings`` dict AND a log-bucketed histogram (p50/p95/p99), and
  lands in the bounded ring buffer that ``obs.export_trace(path)`` dumps
  as Chrome-trace/Perfetto JSON.
* ``obs.render_prometheus()`` — text exposition of every instrument
  (scraped via the RPC ``metrics`` method or the CLI ``metrics``
  subcommand).

Env knobs: ``AUTOMERGE_TPU_TRACE=1`` turns on per-event debug log lines
(same as before); ``AUTOMERGE_TPU_SPAN_BUFFER=N`` sizes the span ring
buffer (default 4096, 0 disables span recording while keeping the
timing/histogram accumulation).

Everything here is thread-safe: one registry RLock guards instruments and
the legacy dicts (the RPC server and the device staging path touch them
concurrently).
"""

from __future__ import annotations

import logging
import os
import re
import threading
from time import perf_counter as _perf_counter
from typing import Optional

from .metrics import (  # noqa: F401 — re-exported API
    FACTOR,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    merge_prometheus,
    parse_prometheus,
    sanitize_metric_name,
)
from .spans import (  # noqa: F401 — re-exported API
    _ORIGIN,
    SpanRecord,
    SpanRecorder,
    current_span,
    current_trace,
    new_trace_id,
    next_span_id,
    now,
)
from .flight import FlightRecorder, merge_flights  # noqa: F401

logger = logging.getLogger("automerge_tpu_torch")

if os.environ.get("AUTOMERGE_TPU_TRACE"):
    logger.setLevel(logging.DEBUG)
    if not logger.handlers:
        logging.basicConfig()

_DEBUG = logging.DEBUG


def enabled() -> bool:
    return logger.isEnabledFor(_DEBUG)


# -- globals -----------------------------------------------------------------

registry = MetricsRegistry()

_SPAN_BUFFER = int(os.environ.get("AUTOMERGE_TPU_SPAN_BUFFER", "4096"))
recorder = SpanRecorder(_SPAN_BUFFER)

# the per-process flight recorder (obs/flight.py): bounded rings of
# recent events + metric deltas around the span ring, dumped to disk on
# exit/failover once a server entry point calls ``flight.install``
flight = FlightRecorder(recorder, registry)

# drain-cycle profiler hooks (obs/prof.py installs these when imported;
# None — the default until a server/bench imports prof — costs one
# global read per span). When installed, each hook is a contextvar read
# unless a prof.cycle is actually active in the calling context.
cycle_enter = None
cycle_exit = None

# the legacy back-compat views (trace.counters / trace.timings alias these
# exact dict objects): counters hold the label-aggregated totals; timings
# hold [total_seconds, count] per span name. Mutated only under
# ``registry.lock`` by this module; external consumers (bench stash/
# restore) read and swap contents single-threaded.
legacy_counters: dict = {}
legacy_timings: dict = {}


# -- structured event lines --------------------------------------------------

_NEEDS_QUOTE = re.compile(r'[\s"=\\]')


def _fmt_field(v) -> str:
    """One ``k=v`` value: quoted + escaped when it contains whitespace,
    ``=``, quotes or backslashes, so trace lines stay machine-parseable
    even for error messages."""
    s = str(v)
    if _NEEDS_QUOTE.search(s) or not s:
        s = (
            '"'
            + s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
            + '"'
        )
    return s


def event(name: str, **fields) -> None:
    """One structured trace line: ``name k=v k=v`` (values quoted as
    needed). Always lands in the flight recorder's bounded event ring;
    the debug log line still requires ``AUTOMERGE_TPU_TRACE``."""
    flight.note_event(name, fields)
    if logger.isEnabledFor(_DEBUG):
        body = " ".join(f"{k}={_fmt_field(v)}" for k, v in fields.items())
        logger.debug("%s %s", name, body)


_EVENT_TOKEN = re.compile(r'(\w+)=("(?:[^"\\]|\\.)*"|\S*)')


def parse_event_fields(body: str) -> dict:
    """Inverse of the ``event`` field encoding (for log consumers/tests)."""
    from .metrics import _unescape_label_value

    out = {}
    for m in _EVENT_TOKEN.finditer(body):
        k, v = m.group(1), m.group(2)
        if v.startswith('"') and v.endswith('"') and len(v) >= 2:
            # single-pass unescape: sequential str.replace would decode
            # an escaped backslash-then-n ('\\\\n') as backslash+newline
            v = _unescape_label_value(v[1:-1])
        out[k] = v
    return out


# -- counters / gauges / histograms ------------------------------------------


def count(name: str, n: int = 1, labels: Optional[dict] = None, **fields) -> None:
    """Increment the named (optionally labeled) counter. The aggregate
    across labels also lands in the legacy ``trace.counters`` dict; a
    debug event line is emitted when tracing is on."""
    with registry.lock:
        registry._get_locked(name, "counter", labels or {})._inc_locked(n)
        total = legacy_counters.get(name, 0) + n
        legacy_counters[name] = total
    flight.note_delta("count", name, labels, n)
    if logger.isEnabledFor(_DEBUG):
        event(name, n=n, total=total, **(labels or {}), **fields)


def gauge_set(name: str, value: float, labels: Optional[dict] = None) -> None:
    registry.gauge(name, **(labels or {})).set(value)
    flight.note_delta("gauge", name, labels, value)


def observe(name: str, value: float, labels: Optional[dict] = None) -> None:
    registry.histogram(name, **(labels or {})).observe(value)
    flight.note_delta("observe", name, labels, value)


def remove_labels(name: str, labels: dict, type_: Optional[str] = None) -> int:
    """Remove one label set from the named families (see
    ``MetricsRegistry.remove_labels``) — the hygiene call for
    per-subject series whose subject is gone."""
    return registry.remove_labels(name, labels, type_=type_)


def gauge_remove(name: str, labels: Optional[dict] = None) -> bool:
    return registry.gauge_remove(name, **(labels or {}))


# the per-document gauge families the durable and device layers export;
# one hygiene call drops every series for a document that closed or
# went cold, so the cardinality cap's slots keep circulating among LIVE
# documents instead of filling with dead ones (past the cap, new docs
# would collapse into {overflow=true} — exactly the admission signal
# the tiered store cannot afford to lose)
DOC_GAUGES = ("doc.journal_bytes", "doc.last_access_seconds",
              "doc.digest_changes")
DEVICE_DOC_GAUGES = ("doc.resident_ops", "doc.device_bytes",
                     "doc.compress_ratio")
# per-queue gauges keyed by the serving layer's shard key (the integer
# doc HANDLE, not the durable name) — removed via ``queue_key``
QUEUE_GAUGES = ("rpc.queue_depth",)


def remove_doc_gauges(doc_name: Optional[str], *, device_only: bool = False,
                      queue_key=None) -> int:
    n = 0
    if queue_key is not None:
        for fam in QUEUE_GAUGES:
            n += registry.remove_labels(
                fam, {"doc": str(queue_key)}, type_="gauge")
    if not doc_name:
        return n
    names = DEVICE_DOC_GAUGES if device_only else DOC_GAUGES + DEVICE_DOC_GAUGES
    for fam in names:
        n += registry.remove_labels(fam, {"doc": doc_name}, type_="gauge")
    return n


def reset_counters() -> None:
    """Clear the legacy counter view (the registry's Prometheus counters
    stay monotone over process life, as scrapers expect)."""
    with registry.lock:
        legacy_counters.clear()


def reset_timers() -> None:
    """Clear the legacy timings view (histograms/spans are unaffected)."""
    with registry.lock:
        legacy_timings.clear()


def timing_summary() -> dict:
    """{name: {"s": total seconds, "n": span count}} snapshot of the
    legacy timing accumulators."""
    with registry.lock:
        return {
            k: {"s": round(v[0], 6), "n": v[1]}
            for k, v in legacy_timings.items()
        }


def percentiles(name: str, qs=(0.5, 0.95, 0.99), labels: Optional[dict] = None) -> dict:
    """{q: estimate} from the named histogram (0.0s when empty)."""
    h = registry.histogram(name, **(labels or {}))
    return {q: h.percentile(q) for q in qs}


def counter_values(name: str, label: str) -> dict:
    """{label value: count} across the named counter's label sets (e.g.
    ``counter_values("device.kernel_launches", "path")`` — the per-path
    dispatch totals the bench JSON and the multichip harness export)."""
    return {
        e["labels"].get(label, ""): e["value"]
        for e in snapshot()
        if e["type"] == "counter" and e["name"] == name
    }


# -- hierarchical spans ------------------------------------------------------


class span:
    """``with obs.span("device.kernel", rows=n):`` — a timed span that
    nests under the contextually-active span, accumulates into
    ``trace.timings`` and the ``name`` histogram, and records into the
    ring buffer for Perfetto export. Always on; cost is two clock reads,
    one lock round-trip and a deque append.

    ``links`` is an optional list of ``(trace_id, span_id)`` pairs for
    work this span covers without parenting it — a group-commit fsync
    names every request whose records it made durable, a batched kernel
    launch names every document's originating request. The active
    cross-process trace id (``trace_scope``) is recorded automatically.
    """

    __slots__ = ("name", "labels", "fields", "links", "t0",
                 "_id", "_parent", "_token")

    def __init__(self, name: str, labels: Optional[dict] = None,
                 links=None, **fields):
        self.name = name
        self.labels = labels
        self.fields = fields
        self.links = links
        self.t0 = 0.0

    @property
    def span_id(self) -> int:
        """This span's id (valid once entered) — what a forwarded trace
        context names as the remote parent."""
        return self._id

    def __enter__(self):
        self._parent = current_span.get()
        self._id = next_span_id()
        self._token = current_span.set(self._id)
        if cycle_enter is not None:
            cycle_enter(self.name)
        self.t0 = _perf_counter()
        return self

    def __exit__(self, etype, evalue, tb):
        t1 = _perf_counter()
        dur = t1 - self.t0
        current_span.reset(self._token)
        name = self.name
        if cycle_exit is not None:
            cycle_exit(name, dur)
        with registry.lock:
            slot = legacy_timings.get(name)
            if slot is None:
                legacy_timings[name] = [dur, 1]
            else:
                slot[0] += dur
                slot[1] += 1
            registry._get_locked(
                name, "histogram", self.labels or {}
            )._observe_locked(dur)
        if recorder.capacity > 0:
            dropped = recorder.record(SpanRecord(
                name, self._id, self._parent, self.t0 - _ORIGIN, dur,
                threading.get_ident(), self.fields,
                "error" if etype is not None else "ok",
                current_trace.get(),
                tuple(self.links) if self.links else None,
            ))
            if dropped:
                # the ring wrapping silently was invisible before: count
                # it so a truncated flight dump advertises itself
                with registry.lock:
                    registry._get_locked(
                        "obs.spans_dropped", "counter", {})._inc_locked(1)
        if logger.isEnabledFor(_DEBUG):
            event(name, ms=round(dur * 1e3, 3),
                  **(self.labels or {}), **self.fields)
        return False


class trace_scope:
    """Activate a cross-process trace context: ``with
    obs.trace_scope(trace_id, parent_span_id):`` makes every span opened
    inside record that trace id, with the (remote) parent span id as the
    root of the local parent chain. Invalid or absent ids deactivate the
    scope entirely — hostile wire input degrades to "no trace", never an
    error — and with no scope active the cost a span pays is a single
    contextvar read."""

    __slots__ = ("trace_id", "parent", "_t_token", "_s_token")

    def __init__(self, trace_id, parent_span_id=None):
        self.trace_id = (
            trace_id
            if isinstance(trace_id, str) and 0 < len(trace_id) <= 128
            else None
        )
        self.parent = (
            parent_span_id
            if isinstance(parent_span_id, int)
            and not isinstance(parent_span_id, bool)
            else None
        )
        self._t_token = None
        self._s_token = None

    def __enter__(self):
        if self.trace_id is not None:
            self._t_token = current_trace.set(self.trace_id)
            if self.parent is not None:
                self._s_token = current_span.set(self.parent)
        return self

    def __exit__(self, *exc):
        if self._t_token is not None:
            current_trace.reset(self._t_token)
            self._t_token = None
            if self._s_token is not None:
                current_span.reset(self._s_token)
                self._s_token = None
        return False


def current_trace_context() -> Optional[tuple]:
    """``(trace_id, active_span_id)`` when a propagated trace is active,
    else None — what gets captured into journal appends and batcher
    stages so later group-commit/batched spans can link back."""
    tid = current_trace.get()
    if tid is None:
        return None
    return (tid, current_span.get())


def decode_wire_traces(v, limit: int = 16) -> list:
    """Sanitize a wire-supplied ``traces`` list (``[[trace_id,
    span_id], ...]``) into span-link tuples; anything malformed is
    silently dropped (hostile input must degrade, not raise)."""
    out = []
    if isinstance(v, (list, tuple)):
        for e in v[:limit]:
            if (
                isinstance(e, (list, tuple)) and len(e) == 2
                and isinstance(e[0], str) and 0 < len(e[0]) <= 128
                and (e[1] is None
                     or (isinstance(e[1], int) and not isinstance(e[1], bool)))
            ):
                out.append((e[0], e[1]))
    return out


def export_trace(path: str) -> int:
    """Dump the span ring buffer as Chrome-trace/Perfetto JSON; returns
    the number of span events written. Open the file at
    https://ui.perfetto.dev (or chrome://tracing)."""
    return recorder.export_chrome_trace(path)


def render_prometheus() -> str:
    return registry.render_prometheus()


def snapshot() -> list:
    return registry.snapshot()


def reset_all() -> None:
    """Full reset (tests): registry, legacy views and the span buffer."""
    with registry.lock:
        registry.reset()
        legacy_counters.clear()
        legacy_timings.clear()
    recorder.clear()
