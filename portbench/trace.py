"""The traced run's reduction: from ``torch.profiler``'s events over the
measured window to device busy time, the device time inside the
harness's spans, the device operations that took most time, and the idle
gaps named by what the host was doing.

The host's side of the trace carries the harness's spans
(``portbench.*``, ``record_function`` around each call into the program
and the read). The device's side carries every kernel, memset and
memcpy. Times are the profiler's, on one clock for both sides.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np

WINDOW = "portbench.window"
# the device's activities: busy time counts all three, a kernel's roofline
# the first two
COMPUTE = ("kernel", "gpu_memset")
DEVICE = COMPUTE + ("gpu_memcpy",)
# the spans the harness reads: its own
SPANS = ("portbench.",)


def span(name: str, on: bool):
    """A harness span (``record_function``), or nothing in an untraced run."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def _kind(e) -> str:
    """The kind of profiler event ``e``, from its device and name: on the
    device, the spans' projections, memcpys, memsets and kernels; on the
    host, spans and other operations."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith(SPANS):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if name.startswith(SPANS) else "cpu_op"


def _union(iv: np.ndarray) -> np.ndarray:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > ends[:-1]]
    starts = iv[new, 0]
    last = np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]
    return np.stack([starts, ends[last]], axis=1)


def _covered(union: np.ndarray, lo: float, hi: float) -> float:
    """Length of the part of [lo, hi) that ``union`` covers."""
    if not len(union):
        return 0.0
    s = np.clip(union[:, 0], lo, hi)
    e = np.clip(union[:, 1], lo, hi)
    return float(np.sum(e - s))


class Trace:
    """The reduction of one profiler session (times in seconds)."""

    def __init__(self, prof):
        host, device = [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            kind = _kind(e)
            if kind in DEVICE:
                device.append((e.name(), start, end, kind in COMPUTE))
            elif kind == "user_annotation" and e.name().startswith(SPANS):
                host.append((e.name(), start, end))
        windows = [(s, t) for n, s, t in host if n == WINDOW]
        if not windows:
            raise RuntimeError("the trace holds no window span")
        self.lo, self.hi = windows[0]
        self.window_s = self.hi - self.lo
        self.host = [h for h in host if h[0] != WINDOW]
        self.device = [d for d in device if d[2] > self.lo and d[1] < self.hi]
        iv = np.array([(s, t) for _, s, t, _ in self.device], float).reshape(-1, 2)
        self.busy = _union(iv)
        self.busy_s = _covered(self.busy, self.lo, self.hi)
        compute = np.array([(s, t) for _, s, t, c in self.device if c],
                           float).reshape(-1, 2)
        self.compute = _union(compute)

    def compute_s_in(self, name: str) -> list:
        """Device seconds of kernels and memsets inside each span ``name``."""
        return [_covered(self.compute, s, t) for n, s, t in self.host if n == name]

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for n, s, t, _ in self.device:
            by[n] += min(t, self.hi) - max(s, self.lo)
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The idle time of the window, each stretch of it named by the
        innermost host span ("host" where none) open then, summed by name;
        the ``k`` largest."""
        edges = np.r_[self.lo, np.clip(self.busy, self.lo, self.hi).ravel(), self.hi]
        gaps = edges.reshape(-1, 2)
        gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        spans = sorted(self.host, key=lambda h: h[1])
        starts = np.array([s for _, s, _ in spans], float)
        cuts = np.unique(np.array([x for _, s, t in spans for x in (s, t)], float))

        def innermost(at: float) -> str:
            # spans nest, so the latest-starting span still open holds ``at``
            first = int(np.searchsorted(starts, at, side="right")) - 1
            for i in range(first, max(first - 256, -1), -1):
                if at < spans[i][2]:
                    return spans[i][0]
            return "host"

        by = defaultdict(float)
        for g0, g1 in gaps:
            inner = cuts[np.searchsorted(cuts, g0, "right"):np.searchsorted(cuts, g1, "left")]
            pts = np.r_[g0, inner, g1]
            for a, b in zip(pts[:-1], pts[1:]):
                by[innermost(0.5 * (a + b))] += float(b - a)
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]
