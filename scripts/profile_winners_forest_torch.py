#!/usr/bin/env python3
"""The scatter winners (``scatter_winners``, K4) and the sibling forest
(``forest`` with its ``radix_sort``, K6) of one tree of the port, timed
on the card at the main path's shapes, so that two trees can be compared
in one run on one card.

    python3 scripts/profile_winners_forest_torch.py [--tree DIR] [--label NAME]
        [--cols FILE.npz]

``--tree`` names the root of the checkout whose ``chip_smoke.py`` and
``automerge_tpu_torch`` are imported (default: this one); its kernels
build into that checkout. ``--cols`` keeps the padded columns of the four
paths in one file: built and written when it is missing, read when it is
there, so that the turns of one run share their inputs and skip the
parse. The paths: the text, typing and record fan-ins at full width (as
``chip_smoke.py`` builds them), and the record store's served subset (the
last batch of 16 replica changes applied to the rest, its dirty objects'
rows). At each: ``scatter_winners`` where the group table passes the
scatter gate (not the record paths), and ``forest``, each with its
launches a call, the median CUDA-event ms of 20 calls (host work
included) and the ``torch.profiler`` device ms per call, in all and by
kernel (a forest call's include its sort's), and the forest's keys
sorted (every row's before the element-only design, the element rows'
after). Needs a CUDA card; prints the card's name and power limit first
and last, and one JSON line per row.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPS = 20
SERVED_BATCH = 16


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


def build_paths(S, device) -> dict:
    """{path: (padded columns, n_objs, n_props)} of the four paths."""
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.oplog import OpLog, pad_columns
    from automerge_tpu_torch.storage.change import parse_change

    def spec(log):
        return log.padded_columns(), log.n_objs, len(log.props)

    def log_of(blobs):
        return OpLog.from_changes([parse_change(b)[0] for b in blobs])

    paths = {"text": spec(log_of(S.workload(S.BASE_EDITS, S.REPLICAS,
                                            S.PER_REPLICA)[0])),
             "typing": spec(log_of(S.workload(S.BASE_EDITS, S.REPLICAS,
                                              S.PER_REPLICA, W.typing_trace)[0]))}
    base, reps = S.record_workload()[:2]
    paths["records"] = spec(log_of([base] + reps))
    # the served subset: the last batch applied to a document of the rest
    doc = DeviceDoc.merge([base] + reps[:-SERVED_BATCH], device=device)
    dirty_sets = []
    dispatch = DeviceDoc._dispatch_async

    def noting_dispatch(self, dirty, phases=None):
        handle = dispatch(self, dirty, phases)
        if handle is not None and not handle.get("fallback"):
            dirty_sets.append(np.array(dirty, np.int64))
        return handle

    DeviceDoc._dispatch_async = noting_dispatch
    try:
        doc.apply_batches([reps[-SERVED_BATCH:]])
    finally:
        DeviceDoc._dispatch_async = dispatch
    if not dirty_sets:
        raise AssertionError("the served batch did not take the subset re-resolve")
    dirty = dirty_sets[-1]
    paths["served"] = (pad_columns(doc._subset_cols(doc._subset_rows(dirty), dirty),
                                   len(dirty)), len(dirty), len(doc.log.props))
    return paths


def save_paths(path: str, paths: dict) -> None:
    flat = {}
    for name, (cols, n_objs, n_props) in paths.items():
        flat[f"{name}/meta"] = np.array([n_objs, n_props], np.int64)
        flat.update({f"{name}/{k}": np.asarray(v) for k, v in cols.items()})
    np.savez(path, **flat)


def load_paths(path: str) -> dict:
    paths = {}
    with np.load(path) as z:
        for key in z.files:
            name, k = key.split("/", 1)
            paths.setdefault(name, {})[k] = z[key]
    out = {}
    for name, cols in paths.items():
        n_objs, n_props = (int(x) for x in cols.pop("meta"))
        out[name] = (cols, n_objs, n_props)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--cols", default="")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    import chip_smoke as S
    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.kernels import forest as F
    from automerge_tpu_torch.kernels import scatter_winners as SW
    from automerge_tpu_torch.kernels import succ_vis as SV
    from automerge_tpu_torch.ops.merge import scatter_geom_key, scatter_geometry_ok

    if not torch.cuda.is_available():
        raise SystemExit("profile_winners_forest_torch: no CUDA device")
    print(S.card_line(), flush=True)
    device = torch.device("cuda", 0)
    label = a.label or os.path.abspath(a.tree)
    if a.cols and os.path.exists(a.cols):
        paths = load_paths(a.cols)
    else:
        paths = build_paths(S, device)
        if a.cols:
            save_paths(a.cols, paths)

    for path, (cols, n_objs, n_props) in paths.items():
        c = columns_from_numpy(cols, device)
        P = c["action"].numel()
        visible = SV.succ_vis(c["action"], c["value_tag"], c["value_i32"],
                              c["covered"], c["pred_src"], c["pred_tgt"])[3]
        fo_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
        calls = []
        if scatter_geometry_ok(P, n_objs, n_props):
            sw_in = (*fo_in[:4], c["prop"], c["width"], visible,
                     *scatter_geom_key(n_objs, n_props))
            calls.append(("scatter_winners", lambda: SW.scatter_winners(*sw_in),
                           ("scatter_winners",), {}))
        is_elem = F.forest(*fo_in)[0]
        # the element-only design sorts the element rows' keys, the one
        # before it every row's
        elem_only = hasattr(F, "element_keys")
        calls.append(("forest", lambda: F.forest(*fo_in), ("forest", "radix_sort"),
                      {"elements": int(is_elem.sum()),
                       "keys_sorted": int(is_elem.sum()) if elem_only else P}))
        for name, fn, counted, extra in calls:
            kernels.reset_launches()
            fn()
            launched = kernels.launch_counts()
            row = {"tree": label, "path": path, "P": P, "fn": name,
                   "launches": {k: launched[k] for k in counted}, **extra,
                   "event_ms": S.cuda_ms(fn, REPS)}
            row["device_ms"], row["device_kernels"] = device_ms(fn)
            print(json.dumps(row), flush=True)
    print(S.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
