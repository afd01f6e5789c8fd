"""Back-compat tracing facade over ``automerge_tpu_torch.obs``.

Historically this module held two bare dicts (``counters``/``timings``)
and standalone ``count``/``time``/``span``/``event`` helpers. The real
implementation now lives in ``obs/`` — a thread-safe labeled metrics
registry, hierarchical spans with Perfetto export, and Prometheus
exposition — and these names are thin shims kept so every existing call
site, test and bench consumer keeps working:

* ``trace.count(name, n, **fields)``  -> ``obs.count`` (lock-protected;
  the old plain-dict increments raced between the RPC server and the
  device staging path).
* ``trace.time(name, **fields)`` / ``trace.span(...)`` -> ``obs.span``:
  both now accumulate into ``trace.timings`` AND feed the span ring
  buffer + per-name latency histograms (p50/p95/p99 via
  ``obs.percentiles``).
* ``trace.counters`` / ``trace.timings`` alias the same dict objects obs
  maintains, so direct reads (bench JSON export, tests) see live data.

Enable per-event log lines with ``AUTOMERGE_TPU_TRACE=1`` (or raise the
``automerge_tpu_torch`` logger to DEBUG); the metric/span accumulation is
always on and cheap.
"""

from __future__ import annotations

from . import obs

logger = obs.logger

enabled = obs.enabled
event = obs.event

# the legacy dict views: same OBJECTS as obs.legacy_* (callers that stash,
# clear and restore their contents — bench.py — keep working)
counters = obs.legacy_counters
timings = obs.legacy_timings


def count(name: str, n: int = 1, **fields) -> None:
    """Increment the named counter and trace it (``name n=… k=v``)."""
    obs.count(name, n, **fields)


# ``with trace.span("load", bytes=n):`` and ``with trace.time("device.kernel",
# rows=n):`` are the same instrument now: a hierarchical obs span. (span
# formerly only logged; it gains the always-on timing accumulation.)
span = obs.span
time = obs.span  # noqa: A001 — the public name IS trace.time

reset_counters = obs.reset_counters
reset_timers = obs.reset_timers
timing_summary = obs.timing_summary
