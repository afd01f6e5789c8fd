#!/usr/bin/env python3
"""The run decode (``expand_runs``), document order (``linearize``) and
the sharded merge's ``mesh_reduce`` of one tree of the port, timed on the
card at the main path's shapes, so that two trees can be compared in one
run on one card.

    python3 scripts/profile_decode_torch.py [--tree DIR] [--label NAME]

``--tree`` names the root of the checkout whose ``chip_smoke.py`` and
``automerge_tpu_torch`` are imported (default: this one); its kernels
build into that checkout. At the text, record and typing fan-ins (full
width, as ``chip_smoke.py`` builds them): ``expand_runs`` at every stack
of run tables of the run-native, eager and packed stagings beside
``torch.searchsorted`` plus a gather, ``linearize`` with its launches a
call, and (text only) ``mesh_reduce`` at the psum of the counts and the
pmax of the win tables beside ``.sum(0)`` / ``.amax(0)``. Each row: the
median CUDA-event ms of 20 calls (host work included) and the
``torch.profiler`` device ms per call, in all and by kernel. Needs a CUDA card; prints the
card's name and power limit first and one JSON line per row.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPS = 20
TIMED = ("expand_runs", "linearize", "mesh_reduce")


def device_ms(fn) -> tuple:
    """(device ms per call of ``fn()``, {kernel: ms per call}), from
    torch.profiler over REPS calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if t > 0:
            per[e.key[:40]] = t / REPS / 1e3
    return sum(per.values()), per


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    import chip_smoke as S
    from automerge_tpu_torch import kernels
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.oplog import OpLog
    from automerge_tpu_torch.storage.change import parse_change

    if not torch.cuda.is_available():
        raise SystemExit("profile_decode_torch: no CUDA device")
    print(S.card_line(), flush=True)
    device = torch.device("cuda", 0)
    label = a.label or os.path.abspath(a.tree)

    def log_of(blobs):
        return OpLog.from_changes([parse_change(b)[0] for b in blobs])

    text = log_of(S.workload(S.BASE_EDITS, S.REPLICAS, S.PER_REPLICA)[0])
    typing = log_of(S.workload(S.BASE_EDITS, S.REPLICAS, S.PER_REPLICA,
                               W.typing_trace)[0])
    base, reps = S.record_workload()[:2]
    records = log_of([base] + reps)
    for path, log in (("text", text), ("records", records), ("typing", typing)):
        spec = (log.padded_columns(), log.n_objs, len(log.props), device)
        makers = [("", S.path_kernels)]
        if path != "typing":
            makers += [(" expand", S.eager_kernels), (" packed", S.packed_kernels)]
        if path == "text":
            makers.append((" sharded", lambda *x: S.sharded_kernels(*x, "condensed")))
        for suffix, make in makers:
            for name, kern, _plain, args, _out, library, tag in make(*spec):
                if name not in TIMED:
                    continue
                fn = (lambda: kern(*args))
                kernels.reset_launches()
                kern(*args)
                row = {"tree": label, "path": path + suffix, "tag": tag, "fn": name,
                       "launches": kernels.launch_counts()[name],
                       "event_ms": S.cuda_ms(fn, REPS)}
                row["device_ms"], row["device_kernels"] = device_ms(fn)
                if library is not None:
                    row["library_event_ms"] = S.cuda_ms(library, REPS)
                    row["library_device_ms"] = device_ms(library)[0]
                print(json.dumps(row), flush=True)
    print(S.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
