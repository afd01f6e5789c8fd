#!/usr/bin/env python3
"""The port's kernels timed on the card at the main path's shapes, and,
with ``--ab``, against another checkout's in the same process.

    python3 scripts/profile_kernels_torch.py --kernels NAME[,NAME...]
        [--paths PATH[,PATH...]] [--cols FILE.npz] [--ab DIR] [--label NAME]
        [--mesh card|cards]

The kernels and their arguments are those of ``chip_smoke.kernel_rows``:
each path's kernels run on its padded columns as its merge runs them,
named as there (``succ_vis``, ``forest``, ``radix_sort``,
``expand_runs``, ``mesh_reduce``, ...). The paths (default all four):
``text``, ``typing`` and ``records``, the fan-ins at full width as
``chip_smoke.py`` builds them, and ``served``, the record store's served
subset (the last batch of 16 replica changes applied to the rest, its
dirty objects' rows). A fan-in's name followed by `` expand``,
`` packed``, `` sharded``, `` sharded rows`` or `` condensed`` takes
that staging, transport, sharded arm or the condensed merge (its
columns with the actor order, rcap = ``condensed_caps(log)``: ``--kernels
linearize_condensed,linearize --paths "typing condensed"`` times K8
beside K7). ``--cols`` keeps the paths' padded columns
in one file: built and written when it is missing, read when it is
there, so that several runs share their inputs and skip the parse; only
the fan-ins the paths name are built.

On a sharded path the kernel name ``sharded_merge`` is a row of the
whole sharded merge, ``parallel.sharding.sharded_merge_columns`` over
four shards on the card (``Mesh(["cuda:0"] * 4)``; with ``--mesh
cards``, over four distinct cards) with that path's arm: its launches
by kernel, its times, no bound.

On a sharded path a ``mesh_reduce`` row is the whole collective it
serves (``parallel.collectives.psum`` / ``pmax`` of the four shards'
tables on the card, from the tables to the result), its bound the
fold's; with ``--ab`` the other tree's whole collective (its
allocations and copies included) is timed beside it.

On a condensed path with both ``linearize_condensed`` and ``linearize``
named, ``linearize`` (K7) runs on the forest K8 ranks, and its row adds
400 pairs of this tree's K8 against it (``linearize_condensed_vs_this``:
K8's median and quartiles first, the share of pairs K8 wins).

One JSON line a row: the launches of one call, the median CUDA-event ms
of 20 single calls (host work included), the ``torch.profiler`` device
ms a call in all and by kernel, the bound (``chip_smoke.bound``), the
library call's CUDA-event and device ms where there is one, and the
wrapper's host µs by step where ``chip_smoke.HOST_STEPS`` has it.

``--ab DIR`` loads the ``automerge_tpu_torch`` of the checkout at DIR
beside this one (its kernels build into DIR). For each row whose kernel
is a function of the package it checks that DIR's gives the same
outputs, then times both in this process: device ms in turns (DIR's,
this tree's, this tree's, DIR's) and DIR's by kernel, DIR's launches and
whole-call host µs, and 400 pairs of single calls, alternating which goes first, with
each side's median and quartiles and the share of pairs this tree wins.
Single calls timed in separate processes drift with the host; pairs in
one process do not, so two trees are compared by these. Needs a CUDA
card; prints the card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402

REPS = 20
SERVED_BATCH = 16
AB_PAIRS = 400
PACKAGE = "automerge_tpu_torch"
AB_ALIAS = "ab_tree"
FANINS = ("text", "typing", "records")
PATHS = FANINS + ("served",)


def build_paths(device, wanted=PATHS) -> dict:
    """{path: (padded columns, n_objs, n_props, rcap)} of the paths in
    ``wanted`` (of ``PATHS``): a fan-in's columns with the actor order and
    its ``condensed_caps``; the served subset's without (rcap 0)."""
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.merge import condensed_caps
    from automerge_tpu_torch.ops.oplog import OpLog, pad_columns
    from automerge_tpu_torch.storage.change import parse_change

    def spec(blobs):
        log = OpLog.from_changes([parse_change(b)[0] for b in blobs])
        return (log.padded_columns(include_aorder=True), log.n_objs,
                len(log.props), condensed_caps(log))

    paths = {}
    if "text" in wanted:
        paths["text"] = spec(S.workload(S.BASE_EDITS, S.REPLICAS, S.PER_REPLICA)[0])
    if "typing" in wanted:
        paths["typing"] = spec(S.workload(S.BASE_EDITS, S.REPLICAS, S.PER_REPLICA,
                                          W.typing_trace)[0])
    if "records" not in wanted and "served" not in wanted:
        return paths
    base, reps = S.record_workload()[:2]
    if "records" in wanted:
        paths["records"] = spec([base] + reps)
    if "served" not in wanted:
        return paths
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
                                   len(dirty)), len(dirty), len(doc.log.props), 0)
    return paths


def save_paths(path: str, paths: dict) -> None:
    flat = {}
    for name, (cols, n_objs, n_props, rcap) in paths.items():
        flat[f"{name}/meta"] = np.array([n_objs, n_props, rcap], np.int64)
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
        n_objs, n_props, rcap = (int(x) for x in cols.pop("meta"))
        out[name] = (cols, n_objs, n_props, rcap)
    return out


def path_spec(paths: dict, path: str) -> tuple:
    """``chip_smoke.kernel_rows``' spec of ``path``: its fan-in's
    (columns, n_objs, n_props), then a sharded arm's linearize, or for a
    condensed path the columns with the actor order and rcap."""
    base, *arm = path.split()
    if base not in paths or (arm and base not in FANINS):
        raise ValueError(f"unknown path {path!r}")
    if arm and arm not in (["expand"], ["packed"], ["sharded"], ["sharded", "rows"],
                           ["condensed"]):
        raise ValueError(f"unknown path {path!r}")
    cols, n_objs, n_props, rcap = paths[base]
    if arm == ["condensed"]:
        return cols, n_objs, n_props, rcap
    cols = {k: v for k, v in cols.items() if k != "aorder"}
    if "sharded" in arm:
        return cols, n_objs, n_props, "rows" if arm[-1] == "rows" else "condensed"
    return cols, n_objs, n_props


def load_tree_as(alias: str, tree: str):
    """The ``automerge_tpu_torch`` package of the checkout at ``tree``,
    imported under the name ``alias`` beside this process's own (its
    imports are relative, and its kernels build into that checkout)."""
    root = os.path.join(os.path.abspath(tree), PACKAGE)
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(root, "__init__.py"), submodule_search_locations=[root])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def counterpart(alias: str, kern):
    """The function of the package loaded as ``alias`` in the place of
    ``kern``, or None when ``kern`` is not a function of the package."""
    mod = getattr(kern, "__module__", "")
    if not mod.startswith(PACKAGE + "."):
        return None
    other = importlib.import_module(alias + mod[len(PACKAGE):])
    return getattr(other, kern.__name__, None)


def same(a, b) -> bool:
    """Outputs equal exactly: tensors, arrays, sequences and dicts of them."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and torch.equal(a, b))
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)) or isinstance(b, (tuple, list)):
        return (isinstance(a, (tuple, list)) and isinstance(b, (tuple, list))
                and len(a) == len(b) and all(map(same, a, b)))
    return a == b


def one_call_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def ab_pairs(fn_a, fn_b, pairs: int) -> dict:
    """Single-call CUDA-event ms of ``fn_a`` (this tree) and ``fn_b``
    (the other) in ``pairs`` pairs, alternating which runs first."""
    fn_a(), fn_b()
    a, b = [], []
    for i in range(pairs):
        if i % 2:
            b.append(one_call_ms(fn_b))
            a.append(one_call_ms(fn_a))
        else:
            a.append(one_call_ms(fn_a))
            b.append(one_call_ms(fn_b))
    quart = lambda v: statistics.quantiles(v, n=4)  # noqa: E731
    return {"pairs": pairs, "median": statistics.median(a),
            "other_median": statistics.median(b), "quartiles": quart(a),
            "other_quartiles": quart(b),
            "wins": sum(x < y for x, y in zip(a, b)) / pairs}


def launches(kernels_mod, name: str, fn):
    """The launches of one call of ``fn``: of the kernel ``name``, or, for
    a row that is no kernel (``sharded_merge``), of every kernel that
    launched, by name."""
    kernels_mod.reset_launches()
    fn()
    counts = kernels_mod.launch_counts()
    if name in counts:
        return counts[name]
    return {k: v for k, v in counts.items() if v}


def merge_rows(path: str, spec, device, mesh=None):
    """The whole sharded merge on a sharded path's columns over ``mesh``
    (default: ``MESH_SHARDS`` shards on ``device``), as a row of
    ``chip_smoke.kernel_rows``' form (no plain version, no library)."""
    from automerge_tpu_torch.parallel import default_mesh
    from automerge_tpu_torch.parallel import sharding as PS

    cols, n_objs, n_props, linearize = spec
    mesh = mesh or default_mesh(devices=[device] * S.MESH_SHARDS)
    args = (cols, mesh, n_objs, n_props, "dict", linearize)
    out = PS.sharded_merge_columns(*args)
    where = ("one card" if len(mesh.distinct) == 1
             else f"{len(mesh.distinct)} devices")
    return [("sharded_merge", PS.sharded_merge_columns, None, args, out, None,
             f"{mesh.size} shards on {where}, {linearize} arm")]


def whole_collective(args, device, tag: str):
    """A ``mesh_reduce`` row's (tables, op) as the collective they serve:
    (``psum`` or ``pmax``, its arguments over ``MESH_SHARDS`` shards on
    the card, its output, tag)."""
    from automerge_tpu_torch.parallel import collectives as C
    from automerge_tpu_torch.parallel import default_mesh

    parts, op = args
    fn = C.psum if op == "sum" else C.pmax
    cargs = (default_mesh(devices=[device] * len(parts)), parts)
    return fn, cargs, fn(*cargs), f"{tag}, the whole {fn.__name__}"


def beside_row(rows):
    """On a condensed path: ``linearize`` (K7) on the forest that
    ``linearize_condensed`` (K8, the last row) ranks, as a row of the
    same form, so that the two can be timed against each other."""
    from automerge_tpu_torch.kernels import linearize as L

    args = rows[-1][3][:5]
    return ("linearize", L.linearize, L.linearize_plain, args, (L.linearize(*args),),
            None, "beside linearize_condensed, on its forest")


def ab_row(other_pkg, other, name: str, args, out, fn) -> dict:
    """This tree's kernel against ``other``, the other tree's, in this
    process (see the module's note)."""
    got = other(*args)
    if not same(out, got if isinstance(got, (tuple, dict)) else (got,)):
        raise AssertionError(f"{name}: the other tree's outputs differ")
    ofn = lambda: other(*args)  # noqa: E731
    turns = [S.device_ms(f, REPS) for f in (ofn, fn, fn, ofn)]
    host_reps = 200 if name in S.REPLACES else REPS
    return {"launches": launches(other_pkg.kernels, name, ofn),
            "device_ms_turns": [t[0] for t in turns],
            "device_kernels": turns[0][1],
            "host_us_whole_call": S.host_us({"whole call": ofn},
                                            host_reps)["whole call"],
            **ab_pairs(fn, ofn, AB_PAIRS)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", required=True, help="comma-separated names")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--cols", default="")
    ap.add_argument("--ab", default="", help="another checkout, timed against "
                    "this one in the same process")
    ap.add_argument("--label", default="")
    ap.add_argument("--mesh", choices=("card", "cards"), default="card",
                    help="the sharded_merge row's mesh: four shards on the "
                    "card, or four distinct cards")
    a = ap.parse_args()
    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.parallel import default_mesh

    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels_torch: no CUDA device")
    print(S.card_line(), flush=True)
    device = torch.device("cuda", 0)
    wanted = set(a.kernels.split(","))
    if a.cols and os.path.exists(a.cols):
        paths = load_paths(a.cols)
    else:
        paths = build_paths(device, {p.split()[0] for p in a.paths.split(",")})
        if a.cols:
            save_paths(a.cols, paths)
    other_pkg = load_tree_as(AB_ALIAS, a.ab) if a.ab else None
    mesh = default_mesh(S.MESH_SHARDS) if a.mesh == "cards" else None
    for path in a.paths.split(","):
        spec = path_spec(paths, path)
        rows = S.kernel_rows(path, spec, device)
        if "sharded_merge" in wanted and "sharded" in path:
            rows += merge_rows(path, spec, device, mesh)
        k8 = None
        if path.endswith("condensed") and "linearize" in wanted:
            k8 = rows[-1]
            rows.append(beside_row(rows))
        for name, kern, _plain, args, out, library, tag in rows:
            if name not in wanted:
                continue
            out = out if isinstance(out, (tuple, dict)) else (out,)
            ms, by = S.bound(name, args, out) if name in S.REPLACES else (None, None)
            if name == "mesh_reduce":
                kern, args, out, tag = whole_collective(args, device, tag)
            fn = lambda: kern(*args)  # noqa: E731
            row = {"label": a.label, "path": path, "tag": tag, "fn": name,
                   "P": len(spec[0]["action"]),
                   "launches": launches(kernels, name, fn),
                   "bound_ms": ms, "bound_by": by, "event_ms": S.cuda_ms(fn, REPS)}
            row["device_ms"], row["device_kernels"] = S.device_ms(fn, REPS)
            if library is not None:
                row["library_event_ms"] = S.cuda_ms(library, REPS)
                row["library_device_ms"] = S.device_ms(library, REPS)[0]
            if name in S.HOST_STEPS:
                row["host_us"] = S.HOST_STEPS[name](args, library)
            other = counterpart(AB_ALIAS, kern) if other_pkg else None
            if other is not None:
                row["ab"] = {"tree": a.ab,
                             **ab_row(other_pkg, other, name, args, out, fn)}
            elif other_pkg:
                row["ab"] = None  # not a function of the package
            if k8 is not None and name == "linearize":
                # this tree's K8 against K7 on the same inputs: K8 is "this"
                row["linearize_condensed_vs_this"] = ab_pairs(
                    lambda: k8[1](*k8[3]), fn, AB_PAIRS)
            print(json.dumps(row), flush=True)
    print(S.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
