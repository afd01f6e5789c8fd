#!/usr/bin/env python3
"""The document catch-up of ``chip_smoke.py`` (phase k) with every stage
traced by ``torch.profiler``: how long the card is busy in each stage and
how long it idles.

    python3 scripts/profile_document_torch.py

The text and record fan-ins are built and merged on the card as the smoke
builds them (phases a and b, without their checks of the stagings), then
``chip_smoke.document_paths`` runs the catch-up itself, with its checks:
the bulk apply, the stale read, the rebuild, save and load of the text
document, then the records document's apply, materialize and reads. Each
stage runs inside a profiler that records the card's activity only (no
host operators), so the host seconds it adds are small.

One JSON line a stage: its host seconds under the profiler (``host_s``,
from before the stage's first call to after a synchronize), the card's
busy seconds (``busy_s``: the union of the intervals of every kernel,
copy and memset the profiler saw), the idle share (1 - busy / host), the
port's kernel launches, the device events counted and the busiest five
by name. Then one line for the whole phase. A stage in which the profiler
saw no device activity has ``busy_s`` 0 when it launched none of the
port's kernels, else null: not measured, and then so is the phase's. Needs
a CUDA card; prints the card's name and power limit first and last.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402

STAGES = {}


def union_seconds(spans) -> float:
    """Seconds covered by the union of (start, end) microsecond spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


@contextlib.contextmanager
def traced(name: str):
    """The stage ``name`` under the profiler; its figures go to STAGES."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from automerge_tpu_torch import kernels

    before = sum(kernels.launch_counts().values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    launches = sum(kernels.launch_counts().values()) - before
    spans, by_name = [], defaultdict(float)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name[:60]] += (e.time_range.end - e.time_range.start) / 1e6
    # no device event: idle when the stage launched no kernel of the port,
    # else the profiler missed its activity (not measured)
    busy = union_seconds(spans) if spans else (0.0 if launches == 0 else None)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    STAGES[name] = {"stage": name, "host_s": host, "busy_s": busy,
                    "idle_share": None if busy is None else 1 - busy / host,
                    "launches": launches, "device_events": len(spans),
                    "top": {k: v for k, v in top}}
    print(json.dumps(STAGES[name]), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_document_torch: no CUDA device")
    card = S.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    from automerge_tpu_torch import native
    from automerge_tpu_torch.kernels import _build
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    _build.build()
    native.build()
    native.load()
    S.text_fanin("text", card, device)
    base, reps, expect = S.record_workload()[:3]
    S.FANINS["records"] = {"doc": DeviceDoc.merge([base] + reps, device=device),
                           "blobs": [base] + reps, "expect": expect}
    S.DOC_STAGE_PROBE = traced
    S.document_paths(card, device)
    rows = list(STAGES.values())
    host = sum(r["host_s"] for r in rows)
    missed = [r["stage"] for r in rows if r["busy_s"] is None]
    busy = None if missed else sum(r["busy_s"] for r in rows)
    print(json.dumps({"stage": "document catch-up", "host_s": host, "busy_s": busy,
                      "idle_share": None if missed else 1 - busy / host,
                      "stages_not_measured": missed}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
