"""Hierarchical spans: a contextvar parent chain and a bounded ring buffer
of completed spans, exportable as Chrome-trace/Perfetto JSON.

A span nests under whatever span is active in the same context when it
starts (``contextvars`` — so async tasks and threads each get their own
chain), records wall time on exit, and lands in the ``SpanRecorder`` ring
buffer. The buffer is bounded (``AUTOMERGE_TPU_SPAN_BUFFER`` entries,
default 4096; 0 disables recording) so always-on span collection costs a
deque append, never unbounded memory.

``export_chrome_trace`` writes the buffer in the Chrome trace-event JSON
format (``{"traceEvents": [{"ph": "X", ...}]}``) that
https://ui.perfetto.dev and chrome://tracing open directly: one complete
("X") event per span, nested by time containment per thread, with the
span's fields (and its span/parent ids) under ``args``.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import random
import threading
import uuid
from collections import deque
from time import perf_counter
from typing import List, Optional

# all span timestamps are seconds since this process-wide origin, so the
# exported trace starts near ts=0 regardless of perf_counter's epoch
_ORIGIN = perf_counter()

# span ids start from a process-random base (high bits random, low bits a
# plain counter): parent/link references must stay unambiguous when flight
# dumps from SEVERAL processes are stitched into one timeline, and a
# counter starting at 1 would collide in every process
_ids = itertools.count((random.getrandbits(62) & ~0xFFFFFFFF) | 1)
current_span: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "automerge_tpu_torch_span", default=None
)
# the active cross-process trace id (None outside any propagated trace —
# the pay-for-what-you-use default: one contextvar read per span exit)
current_trace: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "automerge_tpu_torch_trace", default=None
)


def next_span_id() -> int:
    return next(_ids)


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id for a request entering the system."""
    return uuid.uuid4().hex[:16]


class SpanRecord:
    __slots__ = ("name", "span_id", "parent_id", "start", "duration",
                 "thread_id", "fields", "status", "trace_id", "links")

    def __init__(self, name, span_id, parent_id, start, duration,
                 thread_id, fields, status, trace_id=None, links=None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start          # seconds since _ORIGIN
        self.duration = duration    # seconds
        self.thread_id = thread_id
        self.fields = fields
        self.status = status        # "ok" | "error"
        self.trace_id = trace_id    # cross-process trace id, or None
        # links: ((trace_id, span_id), ...) — spans this one covers
        # without parenting them (group commit, batched launches)
        self.links = links

    def to_chrome_event(self, pid: int) -> dict:
        args = {str(k): _arg(v) for k, v in self.fields.items()}
        args["span_id"] = self.span_id
        if self.parent_id is not None:
            args["parent_id"] = self.parent_id
        if self.trace_id is not None:
            args["trace_id"] = self.trace_id
        if self.links:
            args["links"] = [list(l) for l in self.links]
        if self.status != "ok":
            args["status"] = self.status
        return {
            "name": self.name,
            "cat": "automerge_tpu",
            "ph": "X",
            "ts": round(self.start * 1e6, 3),
            "dur": round(self.duration * 1e6, 3),
            "pid": pid,
            "tid": self.thread_id,
            "args": args,
        }

    def to_dict(self) -> dict:
        """JSON form for flight-recorder dumps (obs/flight.py)."""
        d = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "duration": self.duration,
            "thread_id": self.thread_id,
            "fields": {str(k): _arg(v) for k, v in self.fields.items()},
            "status": self.status,
        }
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.links:
            d["links"] = [list(l) for l in self.links]
        return d


def _arg(v):
    if isinstance(v, (int, float, bool, str)) or v is None:
        return v
    return str(v)


class SpanRecorder:
    """Bounded ring of completed SpanRecords, newest-wins."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=max(capacity, 0))

    def record(self, rec: SpanRecord) -> bool:
        """Append; returns True when the ring was full and an old span
        was silently evicted (the caller counts ``obs.spans_dropped``)."""
        if self.capacity <= 0:
            return False
        with self._lock:
            evicted = len(self._buf) == self._buf.maxlen
            self._buf.append(rec)
        return evicted

    def snapshot(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def export_chrome_trace(self, path: str) -> int:
        """Write the buffered spans as Chrome-trace JSON; returns the
        number of events written."""
        records = self.snapshot()
        pid = os.getpid()
        events = [r.to_chrome_event(pid) for r in records]
        events.sort(key=lambda e: e["ts"])
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "automerge_tpu_torch.obs"},
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)


def now() -> float:
    """Seconds since the recorder origin (what SpanRecord.start uses)."""
    return perf_counter() - _ORIGIN
