"""Chip smoke test of automerge_tpu_torch on one NVIDIA GPU: the fan-in
merge of a text document, the fan-in of a record store and the record
store served batch by batch, end to end through hand-written CUDA kernels,
with the columns staged as run tables (run-native, the default), the
packed transport, the chain-condensed document order, and the sharded
merge over a mesh of four shards on the card.

    python3 chip_smoke.py            # full width, as below
    python3 chip_smoke.py --cards    # on four cards: phases 1, 2 and (g) only

Phases, each raising on failure (nothing is caught):

 1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
    no CUDA device is an error;
 2. build the kernels from automerge_tpu_torch/csrc with nvcc (sm_90a);
 3. the main paths, each with every kernel's launch count set to 0 just
    before it and read just after:
    a. text fan-in (BASELINE width: a 260,000-edit base, 1024 x 250):
       parse, OpLog, DeviceDoc.merge on the card (run-native staging:
       expand_runs decodes the run tables) and text(); the text length must
       equal the generator's count; scatter_winners must run (the group
       table passes the scatter gate), sort_winners must not; then, on the
       same OpLog, merge_columns with staging="expand" and "dense": all 13
       outputs equal across the three stagings (h2d bytes, host encode and
       decode seconds, launches printed for each; the "expand" staging,
       K9's path, is reported as a path); then DeviceDoc.resolve of the same
       log with transport="packed" (its own launch counts: expand_runs,
       unpack_flags, emit_packed), equal to the dict resolve on READ_FETCH
       (conflicts as > 1), the same text, and its flat vector's bytes
       printed against the dict readback's;
    b. record-store fan-in (65,536 records x 8 fields, 1024 x 250): the
       same phases, then keys of the records map and map_entries of every
       visible record; the generator's counts (visible records, the votes
       sum, keys with concurrent values) must hold; sort_winners must run,
       scatter_winners must not; the three stagings and the packed
       transport as in (a), the packed document's reads the generator's
       counts;
    c. the record store served: the base merged on the card (its launches
       read on their own), then DeviceDoc.apply_batches of the replicas in
       64 batches of 16, with the counts set to 0 just before; every batch
       must launch expand_runs (run-native staging, K1); every READ_FETCH
       array must equal (b)'s exactly; then the same 64 batches from the
       same base with staging="dense" (no expand_runs; its base merge's
       launches again read on their own, the counts set to 0 just before
       the batches), equal to (b) too, p50 and max per batch printed
       beside the run-native drain's;
    d. the input on which the JAX package's packed key merges two groups
       (two map puts, props 64 and 0, P = 16): packed equals dict, and so
       does merge_kernel_condensed(32) (the JAX package's
       merge_kernel_condensed(32, 16) merges them);
    e. condensed document order: merge_kernel_condensed at condensed_caps
       on the padded columns with the actor order, for (a)'s text log, a typing fan-in of the
       same shape (workload.typing_trace; its dict merge by DeviceDoc.merge
       first, the path "typing") and (b)'s record log (no sequence: one
       run); run count and rcap printed; all 13 outputs equal the dict
       merge's; the DeviceDoc built from them reads the same text (the
       generator's counts); linearize_condensed launches, linearize does
       not;
    f. the sharded merge (parallel.sharded_merge_columns) over a mesh of
       4 shards on the card (Mesh(["cuda:0"] * 4)), each path against
       the single-device merge_kernel on the same padded columns (all 13
       outputs, exact), wall seconds of both printed, the collectives'
       calls and bytes, and the launches (the sharded kernels must run,
       no single-device merge kernel): "text sharded" (the row-range
       winners, the condensed arm: R and R2 printed), "text sharded
       rows" (the row arm), "typing sharded" and "typing sharded rows"
       (the all_gather bytes per doubling round of both arms and their
       ratio), "records sharded" (the sort-based winners, R = 0) and
       "records sharded packed"; then "text mesh doc": (a)'s log less its
       last replica change as two DeviceDocs, one with enable_mesh on the
       card, both applying that change (its full re-resolve: over the
       mesh in one), equal on READ_FETCH and the text; "text sharded 4
       cards" where the machine has four cards, else a line saying why
       not;
    g. with --cards, in place of (a)-(f) and 4-6 but the last line: the
       text fan-in's merge (a), then its sharded merge over four distinct
       cards and over four shards on one card, both linearize arms, each
       twice, each against the single-device merge as in (f);
 4. every kernel against its plain PyTorch version on the same CUDA
    tensors (exact equality: all integer arithmetic) at the shapes of
    each path that runs it: the text fan-in, the record fan-in and the
    last served batch's subset columns (whose prop ids are the whole
    log's); expand_runs at every stack of run tables the run-native
    staging makes on those three (row stacks, and the record fan-in's
    pred-edge stack: the text's pred columns stay dense), at the stacks
    of the eager-expansion staging on both fan-ins (the delta form, with
    the bool columns) and at the packed transport's; unpack_flags and
    emit_packed at the packed transport of both fan-ins; the condensed
    merge's kernels at the three condensed paths' shapes and the dict
    merge's at the typing fan-in's (linearize
    beside linearize_condensed on one log); the sharded merge's at one
    shard's shapes of "text sharded", "text sharded rows" and "records
    sharded" (mesh_reduce at the psum of the counts and the pmax of the
    winners, its library time torch.stack(...).sum(0) / .amax(0); the
    doubling kernels at one round of one shard's slice); sort_winners also on synthetic
    columns with P > 2^20; the whole merge on the card
    against the plain CPU path on all 13 outputs for that served subset
    and for a small fan-in; expand_runs at every stack and linearize at
    every path also timed on the device by torch.profiler (``device_ms``,
    beside the CUDA-event ``ms``), linearize held to its LAUNCHES launches
    a call, and one expand_runs call at the text fan-in's first stack
    timed on the host step by step;
 5. one {"kernels": [...]} line: kernel launches on the main paths (their
    sum, and by path), median CUDA-event times of the kernel, its plain
    version and (where one exists) a single PyTorch call computing the
    same function (expand_runs: torch.searchsorted and a gather), and the
    bound: the larger of the bytes the function must move over 3.35 TB/s
    and its integer operations over the int32 rate (``work``); the
    top-level numbers are those of the first path that runs the kernel,
    ``by_path`` has each path's (and each stack's, for expand_runs);
 6. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The data sheet's 67 TFLOP/s float32 counts an FMA as two operations on
# 128 float32 lanes per SM; an SM has 64 int32 lanes, one operation each.
INT32_OPS_PER_S = 67e12 / 4

# The BASELINE fan-in: a 260,000-edit base and 1024 replicas x 250 edits.
BASE_EDITS, REPLICAS, PER_REPLICA = 260_000, 1024, 250
# The record store: 65,536 records of 8 fields, 1024 replicas x 250 ops,
# served in batches of 16.
RECORDS, RECORD_REPLICAS, RECORD_PER_REPLICA, RECORD_BATCH = 65_536, 1024, 250, 16
WIDE_P = (1 << 20) + 12_345  # sort_winners past 2^20 rows
REPS = 20  # timed calls per kernel


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event milliseconds of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int) -> tuple:
    """(device ms per call summed over its kernels and memsets, {kernel:
    ms per call}) of ``fn()`` from torch.profiler over ``reps`` calls
    after a warm-up: the card's own time, without the host's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            per[e.key[:60]] = t / reps / 1e3
    return sum(per.values()), per


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def work(name: str, args, out):
    """(bytes, int32 operations) the function ``name`` must do on these
    inputs: each per-row column read once in full, a gathered input only
    at the distinct indices this run's data reaches, each output written
    once; the operations a minimal count per row, edge or comparison."""
    from automerge_tpu_torch.ops.oplog import PAD_ACTION
    from automerge_tpu_torch.types import Action

    def distinct(idx) -> int:
        return int(torch.unique(idx).numel())

    if name == "succ_vis":
        action, value_tag, _value_i32, covered, pred_src, pred_tgt = args
        P, Q = action.numel(), pred_src.numel()
        src = pred_src.long().clamp(0, P - 1)
        inc = ((pred_tgt >= 0) & (pred_tgt < P) & covered[src]
               & (action[src] == Action.INCREMENT))
        read = nbytes(pred_src, pred_tgt, action, value_tag, covered)
        # value_i32 only at the sources of counted increment edges
        return read + 4 * distinct(src[inc]) + nbytes(*out), 3 * Q + 6 * P
    if name in ("scatter_winners", "sort_winners"):
        action, insert, elem_ref, obj_dense, prop, _width, visible = args[:7]
        winner = out[0]
        elem_vis = insert & (action != PAD_ACTION) & (winner >= 0)
        read = nbytes(action, insert, elem_ref, obj_dense, prop, visible)
        # width only at the winners of visible elements
        return (read + 4 * distinct(winner[elem_vis]) + nbytes(*out),
                10 * action.numel())
    if name == "radix_sort":
        keys = args[0]
        n = keys.numel()
        return nbytes(keys, *out), n * max(n - 1, 1).bit_length()
    if name == "forest":
        n = args[0].numel()
        return nbytes(*args, *out), 10 * n + n * max(n - 1, 1).bit_length()
    if name == "linearize":
        first_child, next_sib, is_elem, elem_ref, obj_dense = args
        P = is_elem.numel()
        # first_child and next_sib over the element rows [0, P), and
        # first_child at the object roots P + obj_dense the elements reach
        read = (nbytes(first_child[:P], next_sib[:P], is_elem, elem_ref, obj_dense)
                + 4 * distinct(obj_dense[is_elem]))
        return read + nbytes(*out), 10 * P
    if name == "linearize_condensed":
        _first_child, _next_sib, is_elem, elem_ref, obj_dense, aorder = args[:6]
        P = is_elem.numel()
        n_elem = int(is_elem.sum())
        parents = elem_ref[is_elem]
        # is_elem and the actor-order slots in full; elem_ref, next_sib and
        # obj_dense at the element rows; first_child at the element parents
        # (the chain test) and at the object roots the elements reach
        read = (nbytes(is_elem, aorder) + 3 * 4 * n_elem
                + 4 * distinct(parents[(parents >= 0) & (parents < P)])
                + 4 * distinct(obj_dense[is_elem]))
        return read + nbytes(*out), 2 * P + 12 * n_elem
    if name == "expand_runs":
        W, C, S, n, _bools = args
        K, rcap = W.shape
        read = nbytes(W, C) + (nbytes(S) if S is not None else 0)
        # a binary search over rcap run ends per value, then the slope term
        per_value = rcap.bit_length() + (2 if S is not None else 0)
        return read + nbytes(*out), K * n * per_value
    if name == "unpack_flags":
        (flags,) = args
        return nbytes(flags, *out), 6 * flags.numel()
    if name == "emit_packed":
        core, fetch, obj_cap = args
        ins = [core[k][:obj_cap] if k.startswith("obj_") else core[k] for k in fetch]
        return nbytes(*ins, *out), 2 * sum(t.numel() for t in ins)
    return sharded_work(name, args, out, distinct)


def sharded_work(name: str, args, out, distinct):
    """``work`` of the sharded merge's kernels: a slice's rows or nodes
    read in full, the state they gather only at the distinct slots this
    data reaches."""
    from automerge_tpu_torch.kernels.scatter_winners import group_ids
    from automerge_tpu_torch.ops.oplog import PAD_ACTION
    from automerge_tpu_torch.types import Action

    if name == "mesh_reduce":
        stack, _op = args
        return nbytes(stack, *out), stack.numel()
    if name == "succ_partial":
        action, _value_i32, _covered, pred_src, pred_tgt = args
        P = action.numel()
        src = pred_src.long().clamp(0, P - 1)
        hit = (pred_tgt >= 0) & (pred_tgt < P)
        inc = hit & (action[src] == Action.INCREMENT)
        # action and covered at the edges' sources, value_i32 at the
        # increments'
        read = (nbytes(pred_src, pred_tgt) + 5 * distinct(src[hit])
                + 4 * distinct(src[inc]))
        return read + nbytes(*out), 3 * pred_src.numel()
    if name == "visibility":
        return nbytes(*args, *out), 6 * args[0].numel()
    if name == "winners_partial":
        action, insert, elem_ref, obj_dense, prop, visible, r0, count = args[:8]
        sl = slice(r0, r0 + count)
        read = nbytes(action[sl], insert[sl], elem_ref[sl], obj_dense[sl], prop[sl],
                      visible[sl])
        return read + nbytes(*out), 10 * count
    if name == "winners_gather":
        (action, insert, elem_ref, obj_dense, prop, _width, _win, _cnt, r0, count,
         n_objs2, n_props) = args
        sl = slice(r0, r0 + count)
        gid = group_ids(action, insert, elem_ref, obj_dense, prop, n_objs2, n_props)[sl]
        winner = out[0]
        elem_vis = insert[sl] & (action[sl] != PAD_ACTION) & (winner >= 0)
        # win and cnt at the slice's groups, width at its visible winners
        read = (nbytes(action[sl], insert[sl], elem_ref[sl], obj_dense[sl], prop[sl])
                + 8 * distinct(gid) + 4 * distinct(winner[elem_vis]))
        return read + nbytes(*out), 10 * count
    if name == "linearize_init":
        first_child, next_sib, is_elem, elem_ref, Epad = args
        P = is_elem.numel()
        read = nbytes(first_child[:P], next_sib[:P], is_elem, elem_ref)
        return read + nbytes(*out), 5 * Epad
    if name in ("linearize_thread", "linearize_rank"):
        *state, i0, count = args
        link = state[-1]
        j = link[i0:i0 + count].long().clamp(0, link.numel() - 1)
        per_node = sum(t.element_size() for t in state)
        # the slice's state, and the state at the distinct nodes it jumps to
        read = per_node * (count + distinct(j))
        return read + nbytes(*out), (4 if len(state) == 3 else 3) * count
    if name == "linearize_rank_init":
        fc_e, ans, _P = args
        return nbytes(fc_e, ans, *out), 3 * ans.numel()
    if name == "linearize_final":
        _first_child, is_elem, obj_dense, dist, r0, count = args
        sl = slice(r0, r0 + count)
        # first_child at the objects' roots and dist at their starts
        roots = distinct(obj_dense[sl][is_elem[sl]])
        return (nbytes(is_elem[sl], obj_dense[sl], dist[sl]) + 8 * roots
                + nbytes(*out), 6 * count)
    if name == "cond_init":
        return nbytes(*args, *out), 4 * args[0].numel()
    if name == "cond_succ":
        tail_ans, ans, _chain_id, clen = args
        a = torch.where(tail_ans != -1, tail_ans, ans)
        # chain_id at the distinct rows the chains' successors start at
        return (nbytes(tail_ans, ans, clen) + 4 * distinct(a[a >= 0]) + nbytes(*out),
                4 * ans.numel())
    if name == "cond_expand":
        chain_id, offset, obj_dense, insert, action, _start_chain, cdist, r0, count = args
        sl = slice(r0, r0 + count)
        cid = chain_id[sl]
        # start_chain at the slice's objects, cdist at its chains
        read = (nbytes(chain_id[sl], offset[sl], obj_dense[sl], insert[sl], action[sl])
                + 4 * distinct(obj_dense[sl]) + 4 * distinct(cid[cid >= 0]))
        return read + nbytes(*out), 8 * count
    raise KeyError(name)


def winner_columns(P: int, seed: int, device, max_prop: int = 70_000):
    """Synthetic inputs of the winner kernels at any P: (action, insert,
    elem_ref, obj_dense, prop, width, visible). Map ops (about half) carry
    prop ids up to ``max_prop``, sequence ops run keys over the rows and
    the elem_ref sentinels; a tail of padding rows, as pad_columns makes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = P - P // 64
    is_map = rng.random(P) < 0.5
    action = np.where(rng.random(P) < 0.8, 1, 3).astype(np.int32)
    action[n:] = 15
    insert = ~is_map & (action == 1) & (rng.random(P) < 0.6)
    elem_ref = np.where(is_map, -2, rng.integers(-3, P, P)).astype(np.int32)
    prop = np.where(is_map, rng.integers(0, max_prop, P), -1).astype(np.int32)
    prop[n:], elem_ref[n:] = -1, -2
    obj_dense = rng.integers(0, max(P // 16, 1), P).astype(np.int32)
    width = rng.integers(1, 4, P).astype(np.int32)
    visible = (action == 1) & (rng.random(P) < 0.7)
    cols = (action, insert, elem_ref, obj_dense, prop, width, visible)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in cols)


def group_keys(action, insert, elem_ref, obj_dense, prop):
    """sort_winners' int64 group key per row (csrc/sort_winners.cu
    ``sk_key``), ``((g_obj * 2 + g_kind) << 32) | uint32(g_key + 4)``: the
    keys whose torch.sort is sort_winners' library time."""
    from automerge_tpu_torch.ops.oplog import PAD_ACTION

    P = action.shape[0]
    rows = torch.arange(P, dtype=torch.int64, device=action.device)
    is_map = prop >= 0
    g_obj = torch.where(action != PAD_ACTION, obj_dense.long(), P)
    g_key = torch.where(is_map, prop.long(),
                        torch.where(insert, rows, elem_ref.long()))
    return ((g_obj * 2 + is_map.long()) << 32) | ((g_key + 4) & 0xFFFFFFFF)


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired outputs; raises unless 0."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    if err:
        raise AssertionError(f"kernel disagrees with its plain version by {err}")
    return err


def workload(base_edits: int, replicas: int, per_replica: int, make_trace=None):
    """(change chunks, expected text length, text object id, seconds of
    generation and of encoding). ``make_trace(n)`` makes the edit trace
    (default: ``workload.load_trace``)."""
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.storage.change import build_change

    t0 = time.perf_counter()
    trace = (make_trace or W.load_trace)(base_edits)
    base_ch, elems = W.base_change(trace, base_edits)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = W.BaseInfo(build_change(base_ch), elems)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    reps = W.fanin_changes(base, trace, replicas, per_replica, base_edits)
    t_gen += time.perf_counter() - t0
    t0 = time.perf_counter()
    reps = [build_change(c) for c in reps]
    t_enc += time.perf_counter() - t0
    changes = base.changes + reps
    blobs = [c.raw_bytes for c in changes]
    return blobs, W.expected_text_length(changes), base.text_exid, t_gen, t_enc


def check_small_against_cpu(device) -> None:
    """A small fan-in merged on the card equals the plain CPU path on
    every output."""
    import numpy as np

    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.merge import ALL_OUTPUTS, merge_columns
    from automerge_tpu_torch.ops.oplog import OpLog

    trace = W.load_trace(3000)
    base = W.build_base(trace, 2000)
    log = OpLog.from_changes(base.changes + W.synth_fanin(base, trace, 16, 100, 2000))
    kw = dict(n_objs=log.n_objs, n_props=len(log.props))
    gpu = merge_columns(log.columns(), device=device, **kw)
    cpu = merge_columns(log.columns(), device="cpu", **kw)
    for k in ALL_OUTPUTS:
        if not np.array_equal(gpu[k], cpu[k]):
            raise AssertionError(f"small fan-in: {k} differs between cuda and cpu")


def record_workload():
    """(base chunk, replica chunks, expected counts, seconds of generation
    and of encoding) of the record store."""
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.storage.change import build_change

    t0 = time.perf_counter()
    base_ch = W.record_base_change(RECORDS)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = build_change(base_ch)
    t_enc = time.perf_counter() - t0
    expect = W.RecordExpect(RECORDS)
    reps = []
    for i in range(RECORD_REPLICAS):
        t0 = time.perf_counter()
        ch = W.record_replica_change(base, RECORDS, i, RECORD_PER_REPLICA, expect)
        t1 = time.perf_counter()
        reps.append(build_change(ch).raw_bytes)
        t_gen += t1 - t0
        t_enc += time.perf_counter() - t1
    return base.raw_bytes, reps, expect.counts(), t_gen, t_enc


def check_launches(path: str, counts: dict, must: tuple, must_not: tuple) -> None:
    from automerge_tpu_torch.kernels.linearize import LAUNCHES

    idle = [k for k in must if counts[k] < 1]
    if idle:
        raise AssertionError(f"{path}: kernels not launched: {idle}")
    if counts["linearize"] % LAUNCHES:
        raise AssertionError(f"{path}: linearize launched {counts['linearize']} "
                             f"kernels, not {LAUNCHES} a call")
    stray = [k for k in must_not if counts[k]]
    if stray:
        raise AssertionError(f"{path}: kernels launched that must not be: {stray}")


def check_call_launches(name: str, launched: int, want: int) -> None:
    if launched != want:
        raise AssertionError(f"{name}: {launched} launches a call, not {want}")


SHARED = ("succ_vis", "forest", "radix_sort", "linearize")
RUN_NATIVE = SHARED + ("expand_runs",)
PACKED = SHARED + ("expand_runs", "unpack_flags", "emit_packed")
TRANSPORT_ONLY = ("unpack_flags", "emit_packed")
# merge_kernel_condensed's kernels, and those it must not launch
CONDENSED = ("succ_vis", "sort_winners", "forest", "radix_sort",
             "linearize_condensed")
NOT_CONDENSED = ("linearize", "scatter_winners", "expand_runs") + TRANSPORT_ONLY
# the sharded merge's (K11): every path, each linearize arm, each winner
# arm, and the single-device kernels it must not launch
MESH_SHARDS = 4
SHARDED_ALL = ("succ_partial", "visibility", "mesh_reduce", "forest", "radix_sort")
SHARDED_CONDENSED = ("cond_init", "linearize_thread", "cond_succ", "linearize_rank",
                     "cond_expand")
SHARDED_ROWS = ("linearize_init", "linearize_thread", "linearize_rank_init",
                "linearize_rank", "linearize_final")
SHARDED_SCATTER = ("winners_partial", "winners_gather")
NOT_SHARDED = ("succ_vis", "scatter_winners", "linearize", "linearize_condensed",
               "emit_packed")


def check_stagings(name: str, log, device) -> dict:
    """The log merged under each staging: all 13 outputs equal; the bytes
    each copies, its host encode, its decode on the card and its launches
    printed. Returns the launch counts of the eager-expansion staging
    (K9's path) and the run-native staging's 13 outputs."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops.merge import ALL_OUTPUTS, STAGINGS, merge_columns

    kw = dict(n_objs=log.n_objs, n_props=len(log.props), device=device)
    outs, counts = {}, {}
    for staging in STAGINGS:
        phases = {}
        kernels.reset_launches()
        outs[staging] = merge_columns(log.columns(), staging=staging,
                                      phases=phases, **kw)
        counts[staging] = kernels.launch_counts()
        print(f"{name} staging {staging}: h2d_bytes {phases['h2d_bytes']} of "
              f"dense {phases['h2d_dense_bytes']}; encode (_slope_rle) "
              f"{phases.get('encode', 0.0):.6f} s, h2d {phases['h2d']:.6f} s, "
              f"expand (expand_runs) {phases.get('expand', 0.0) * 1e3:.3f} ms; "
              f"launches {json.dumps(counts[staging])}", flush=True)
        decodes = ("expand_runs",) if staging != "dense" else ()
        check_launches(f"{name} staging {staging}", counts[staging],
                       SHARED + decodes,
                       TRANSPORT_ONLY + (("expand_runs",) if not decodes else ()))
    for staging in STAGINGS[1:]:
        for k in ALL_OUTPUTS:
            if not np.array_equal(outs[staging][k], outs[STAGINGS[0]][k]):
                raise AssertionError(f"{name}: {k} differs between staging "
                                     f"{staging} and {STAGINGS[0]}")
    print(f"{name}: the three stagings agree on all 13 outputs", flush=True)
    return counts["expand"], outs[STAGINGS[0]]


def check_packed(name: str, doc, dict_phases, device):
    """DeviceDoc.resolve of ``doc``'s log with the packed transport: its
    READ_FETCH arrays equal ``doc``'s (conflicts as > 1). Returns (packed
    document, its launch counts)."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    kernels.reset_launches()
    phases = {}
    packed = DeviceDoc.resolve(doc.log, device=device, phases=phases,
                               transport="packed")
    counts = kernels.launch_counts()
    n = doc.log.n
    for k in DeviceDoc.READ_FETCH:
        cut = doc.log.n_objs + 2 if k.startswith("obj_") else n
        got, want = np.asarray(packed.res[k])[:cut], np.asarray(doc.res[k])[:cut]
        if k == "conflicts":
            got, want = got > 1, want > 1
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: packed {k} differs from the dict path's")
    print(f"{name} packed: READ_FETCH equal to the dict path's (conflicts as "
          f"> 1); read back {phases['d2h_bytes']} bytes in one flat vector "
          f"against the dict path's {dict_phases['d2h_bytes']}; h2d_bytes "
          f"{phases['h2d_bytes']} of dense {phases['h2d_dense_bytes']}", flush=True)
    print(f"{name} packed phases_s " + json.dumps(
        {k: round(v, 6) for k, v in phases.items()}), flush=True)
    print(f"{name} packed launches {json.dumps(counts)}", flush=True)
    check_launches(f"{name} packed", counts, PACKED, ())
    return packed, counts


def text_fanin(name: str, card: str, device, make_trace=None):
    """A text fan-in of BASELINE width (a 260,000-edit base, 1024 x 250)
    from the trace ``make_trace`` makes: parse..read through
    DeviceDoc.merge on the card, its launches read around it (the scatter
    winners must run, the sort-based must not), its text length the
    generator's count. Returns (document, phases, text, text object,
    launch counts)."""
    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    blobs, expect_len, text_obj, t_gen, t_enc = workload(
        BASE_EDITS, REPLICAS, PER_REPLICA, make_trace)
    print(f"{name} workload: {len(blobs)} changes, {sum(map(len, blobs))} bytes; "
          f"generate {t_gen:.3f} s, encode {t_enc:.3f} s", flush=True)
    kernels.reset_launches()
    phases = {}
    t0 = time.perf_counter()
    doc = DeviceDoc.merge(blobs, device=device, phases=phases)
    t1 = time.perf_counter()
    text = doc.text(text_obj)
    t_end = time.perf_counter()
    phases["read"] = t_end - t1
    counts = kernels.launch_counts()
    report_path(f"{name} fan-in", doc.log, phases, t_end - t0, counts, card)
    if len(text) != expect_len:
        raise AssertionError(f"{name} length {len(text)} != expected {expect_len}")
    check_launches(f"{name} fan-in", counts, RUN_NATIVE + ("scatter_winners",),
                   ("sort_winners",) + TRANSPORT_ONLY)
    print(f"{name}: {len(text)} characters, as the generator counted", flush=True)
    return doc, phases, text, text_obj, counts


def text_path(card: str, device):
    """(a) the text fan-in: (log, launch counts by path: the fan-in, its
    eager-expansion staging and its packed resolve; the dict merge's 13
    outputs, the text, the text object)."""
    doc, phases, text, text_obj, counts = text_fanin("text", card, device)
    log = doc.log
    expand_counts, out = check_stagings("text fan-in", log, device)
    packed, packed_counts = check_packed("text fan-in", doc, phases, device)
    if packed.text(text_obj) != text:
        raise AssertionError("text fan-in: the packed document's text differs")
    print("text fan-in packed: the same text", flush=True)
    return log, {"text": counts, "text expand": expand_counts,
                 "text packed": packed_counts}, out, text, text_obj


def report_path(name, log, phases, e2e, counts, card) -> None:
    padded = log.padded_columns()
    print(f"{name}: ops {log.n}, P {len(padded['action'])}, "
          f"Q {len(padded['pred_src'])}, pred edges {len(log.pred_src)}, "
          f"objects {log.n_objs}, keys {len(log.props)}", flush=True)
    print(f"{name} phases_s " + json.dumps(
        {k: round(v, 6) for k, v in phases.items()}), flush=True)
    print(f"{name} end to end (parse..read): {e2e:.3f} s, "
          f"{log.n / e2e:.1f} ops/s on {card}", flush=True)
    print(f"{name} launches {json.dumps(counts)}", flush=True)


def record_paths(card: str, device):
    """(b) the record-store fan-in and (c) the record store served:
    (fan-in log, the last served batch's subset, launch counts of each,
    the fan-in's dict merge outputs, the generator's counts)."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.oplog import pad_columns

    base, reps, expect, t_gen, t_enc = record_workload()
    print(f"record workload: {1 + len(reps)} changes, "
          f"{len(base) + sum(map(len, reps))} bytes; generate {t_gen:.3f} s, "
          f"encode {t_enc:.3f} s; expected {json.dumps(expect)}", flush=True)

    # (b) fan-in
    kernels.reset_launches()
    phases = {}
    t0 = time.perf_counter()
    doc = DeviceDoc.merge([base] + reps, device=device, phases=phases)
    t1 = time.perf_counter()
    got = W.record_counts(doc)
    t_end = time.perf_counter()
    phases["read"] = t_end - t1
    fanin_counts = kernels.launch_counts()
    report_path("record fan-in", doc.log, phases, t_end - t0, fanin_counts, card)
    if got != expect:
        raise AssertionError(f"record fan-in read {got}, generator counted {expect}")
    check_launches("record fan-in", fanin_counts, RUN_NATIVE + ("sort_winners",),
                   ("scatter_winners",) + TRANSPORT_ONLY)
    print(f"record fan-in: {json.dumps(got)}, as the generator counted", flush=True)
    expand_counts, fanin_out = check_stagings("record fan-in", doc.log, device)
    packed, packed_counts = check_packed("record fan-in", doc, phases, device)
    if W.record_counts(packed) != expect:
        raise AssertionError("record fan-in: the packed document's reads differ "
                             "from the generator's counts")
    print("record fan-in packed: reads as the generator counted", flush=True)

    # (c) served: the base resident on the card, then 64 batches of 16
    batches = W.record_batches(reps, RECORD_BATCH)
    kernels.reset_launches()
    t0 = time.perf_counter()
    served = DeviceDoc.merge([base], device=device)
    t_base = time.perf_counter() - t0
    base_counts = kernels.launch_counts()
    print(f"record served base launches {json.dumps(base_counts)}", flush=True)
    check_launches("record served base", base_counts, RUN_NATIVE + ("sort_winners",),
                   ("scatter_winners",) + TRANSPORT_ONLY)
    # note each batch's subset (its dirty objects) to check the kernels at
    # a served batch's shapes afterwards, and each batch's expand_runs
    # launches
    dirty_sets = []
    batch_decodes = []
    dispatch = DeviceDoc._dispatch_async
    step = DeviceDoc._pipeline_step

    def noting_dispatch(self, dirty, phases=None):
        handle = dispatch(self, dirty, phases)
        subset = handle is not None and not handle.get("fallback")
        dirty_sets.append(np.array(dirty, np.int64) if subset else None)
        return handle

    def counting_step(self, chs, inflight, phases=None):
        before = kernels.launch_counts()["expand_runs"]
        out = step(self, chs, inflight, phases)
        batch_decodes.append(kernels.launch_counts()["expand_runs"] - before)
        return out

    phases = {}
    DeviceDoc._dispatch_async = noting_dispatch
    DeviceDoc._pipeline_step = counting_step
    try:
        kernels.reset_launches()
        t1 = time.perf_counter()
        applied = served.apply_batches(batches, phases)
        t_end = time.perf_counter()
        served_counts = kernels.launch_counts()
    finally:
        DeviceDoc._dispatch_async = dispatch
        DeviceDoc._pipeline_step = step
    seconds = phases.pop("batches")
    print(f"record served: base merge {t_base:.3f} s, {len(batches)} batches of "
          f"{RECORD_BATCH}: {t_end - t1:.3f} s, per batch p50 "
          f"{statistics.median(seconds):.6f} s max {max(seconds):.6f} s on {card}",
          flush=True)
    print("record served stages_s " + json.dumps(
        {k: round(v, 6) for k, v in phases.items()}), flush=True)
    print(f"record served launches {json.dumps(served_counts)}", flush=True)
    print(f"record served expand_runs launches per batch {batch_decodes}", flush=True)
    if applied != len(reps):
        raise AssertionError(f"served {applied} of {len(reps)} changes")
    check_launches("record served", served_counts, RUN_NATIVE + ("sort_winners",),
                   ("scatter_winners",) + TRANSPORT_ONLY)
    if len(batch_decodes) != len(batches) or min(batch_decodes) < 1:
        raise AssertionError(f"a served batch launched no expand_runs: {batch_decodes}")
    check_served_equal("record served", served, doc, expect)

    # the same batches from the same base, staged dense
    kernels.reset_launches()
    dense = DeviceDoc.merge([base], device=device, staging="dense")
    dense_base_counts = kernels.launch_counts()
    print(f"record served dense base launches {json.dumps(dense_base_counts)}",
          flush=True)
    check_launches("record served dense base", dense_base_counts,
                   SHARED + ("sort_winners",),
                   ("scatter_winners", "expand_runs") + TRANSPORT_ONLY)
    dense_phases = {}
    kernels.reset_launches()
    t2 = time.perf_counter()
    dense.apply_batches(batches, dense_phases)
    t_dense = time.perf_counter() - t2
    dense_counts = kernels.launch_counts()
    dense_seconds = dense_phases.pop("batches")
    print(f"record served, staging dense: {len(batches)} batches {t_dense:.3f} s, "
          f"per batch p50 {statistics.median(dense_seconds):.6f} s max "
          f"{max(dense_seconds):.6f} s; run-native p50 "
          f"{statistics.median(seconds):.6f} s max {max(seconds):.6f} s "
          f"(same run, {card})", flush=True)
    print("record served dense stages_s " + json.dumps(
        {k: round(v, 6) for k, v in dense_phases.items()}), flush=True)
    print(f"record served dense launches {json.dumps(dense_counts)}", flush=True)
    check_launches("record served dense", dense_counts, SHARED + ("sort_winners",),
                   ("scatter_winners", "expand_runs") + TRANSPORT_ONLY)
    check_served_equal("record served dense", dense, doc, expect)
    # the last batch's subset columns: they are those of the final log
    if len(dirty_sets) != len(batches) or dirty_sets[-1] is None:
        raise AssertionError("the last served batch did not take the subset "
                             "re-resolve")
    dirty = dirty_sets[-1]
    last = (pad_columns(served._subset_cols(served._subset_rows(dirty), dirty),
                        len(dirty)), len(dirty), len(served.log.props))
    counts = {"records": fanin_counts, "records expand": expand_counts,
              "records packed": packed_counts,
              "served base": base_counts, "served": served_counts,
              "served dense base": dense_base_counts, "served dense": dense_counts}
    return doc.log, last, counts, fanin_out, expect


def check_served_equal(name: str, served, doc, expect) -> None:
    """A served document equals the one-shot fan-in ``doc`` on every
    READ_FETCH array and the counters, and reads the generator's counts."""
    import numpy as np

    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    n = doc.log.n
    if served.log.n != n or served.log.n_objs != doc.log.n_objs:
        raise AssertionError(f"{name}: log differs in size from the fan-in's")
    for k in DeviceDoc.READ_FETCH:
        cut = doc.log.n_objs + 2 if k.startswith("obj_") else n
        if not np.array_equal(np.asarray(served.res[k])[:cut],
                              np.asarray(doc.res[k])[:cut]):
            raise AssertionError(f"{name}: {k} differs from the fan-in's")
    if not np.array_equal(served.counter_val[:n], doc.counter_val[:n]):
        raise AssertionError(f"{name}: counter values differ from the fan-in's")
    if W.record_counts(served) != expect:
        raise AssertionError(f"{name}: reads differ from the generator's counts")
    print(f"{name} == record fan-in on every READ_FETCH array", flush=True)


def condensed_merge(name: str, log, want: dict, device):
    """(e) One condensed all-device merge of ``log``:
    ``merge_kernel_condensed(condensed_caps(log))`` on its padded columns
    with the actor order, the launch counts set to 0 just before and read
    just after; the run count and rcap printed; all 13 outputs equal to
    ``want``, the dict merge's (its per-object stats cut to n_objs + 2).
    Returns (the DeviceDoc built from the outputs, the launch counts)."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.merge import (
        ALL_OUTPUTS, condensed_caps, merge_kernel_condensed,
    )

    runs = log.condensed_run_count()
    rcap = condensed_caps(log)
    t0 = time.perf_counter()
    cols = log.padded_columns(include_aorder=True)
    P = len(cols["action"])
    print(f"{name}: {runs} chain runs of {int(np.count_nonzero(log.insert))} "
          f"elements ({log.n} ops, P {P}); rcap {rcap}; "
          f"actor order and padding {time.perf_counter() - t0:.6f} s", flush=True)
    c = columns_from_numpy(cols, device)
    phases = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = merge_kernel_condensed(rcap)(c, phases)
    res = {k: v.cpu().numpy() for k, v in out.items()}
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"{name}: merge and readback {seconds:.6f} s; phases_s " + json.dumps(
        {k: round(v, 6) for k, v in phases.items()}), flush=True)
    print(f"{name} launches {json.dumps(counts)}", flush=True)
    check_launches(name, counts, CONDENSED, NOT_CONDENSED)
    for k in ALL_OUTPUTS:
        got = res[k][: len(want[k])] if k.startswith("obj_") else res[k]
        if not np.array_equal(got, want[k]):
            raise AssertionError(f"{name}: {k} differs from the dict merge's")
    print(f"{name}: all 13 outputs equal to the dict merge's", flush=True)
    return DeviceDoc(log, res, device=device), counts


def condensed_paths(card, device, text, records):
    """(e) condensed document order: ``text`` = (log, dict outputs, text,
    text object) of (a), ``records`` = (log, dict outputs, the generator's
    counts) of (b); the typing fan-in is made here. Each path's condensed
    merge equals its dict merge on all 13 outputs, and the DeviceDoc built
    from it reads the same text (the generator's counts for the records).
    Returns (the typing log, launch counts by path)."""
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.ops.merge import merge_columns

    counts = {}
    log, out, txt, text_obj = text
    doc, counts["text condensed"] = condensed_merge("text condensed", log, out, device)
    if doc.text(text_obj) != txt:
        raise AssertionError("text condensed: the text differs from (a)'s")
    print("text condensed: the same text as (a)", flush=True)

    # the typing fan-in, a stand-in for a real editing trace: the dict
    # merge by DeviceDoc.merge (the path "typing"), then all 13 of its
    # outputs from merge_columns for the condensed merge to meet
    doc, _, txt, text_obj, counts["typing"] = text_fanin(
        "typing", card, device, W.typing_trace)
    typing_log = doc.log
    out = merge_columns(typing_log.columns(), n_objs=typing_log.n_objs,
                        n_props=len(typing_log.props), device=device)
    doc, counts["typing condensed"] = condensed_merge(
        "typing condensed", typing_log, out, device)
    if doc.text(text_obj) != txt:
        raise AssertionError("typing condensed: the text differs from the dict merge's")
    print("typing condensed: the same text as the dict merge", flush=True)

    log, out, expect = records
    doc, counts["records condensed"] = condensed_merge(
        "records condensed", log, out, device)
    if W.record_counts(doc) != expect:
        raise AssertionError("records condensed: reads differ from the generator's counts")
    print("records condensed: reads as the generator counted", flush=True)
    return typing_log, counts


def single_merge(cols, n_objs: int, n_props: int, device):
    """The single-device merge_kernel of padded columns, dense: (its 13
    outputs, wall seconds from the copy to the card to the readback)."""
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.ops.merge import merge_kernel

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = merge_kernel(columns_from_numpy(cols, device), n_objs, n_props)
    res = {k: v.cpu().numpy() for k, v in out.items()}
    return res, time.perf_counter() - t0


def sharded_path(name, card, cols, n_objs: int, n_props: int, mesh, single,
                 linearize: str = "condensed", transport: str = "dict"):
    """(f) One sharded merge of padded columns over ``mesh``, the launch
    counts and the collectives' counts set to 0 just before and read just
    after: its kernels must run (the row-range winners where the sharded
    gate passes, the sort-based ones where it fails; the ``linearize``
    arm's loops) and no single-device merge kernel; all 13 outputs equal
    ``single`` = (outputs, seconds) of ``single_merge``. Returns (launch
    counts, the all_gathers as (per-shard length, bytes), R2)."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops.merge import ALL_OUTPUTS
    from automerge_tpu_torch.parallel import collectives as C
    from automerge_tpu_torch.parallel import sharding as PS

    n = mesh.size
    P, Q = len(cols["action"]), len(cols["pred_src"])
    scatter = PS.sharded_gate(P, n_objs + 2, n_props)
    detail = ""
    R2 = 0
    if linearize == "condensed":
        t0 = time.perf_counter()
        R2, cond = PS.condense_host(cols, n_objs + 2, n)
        detail = (f", R {int(np.count_nonzero(cond['clen']))} chains, R2 {R2} "
                  f"(condense_host on the host {time.perf_counter() - t0:.6f} s)")
    print(f"{name}: {n} shards on {[str(d) for d in mesh.devices]}; P {P}, "
          f"Pl {P // n}, Q {Q}; winners "
          f"{'row-range scatter' if scatter else 'sort-based, replicated'}; "
          f"linearize {linearize}{detail}; transport {transport}", flush=True)
    for d in mesh.distinct:
        torch.cuda.synchronize(d)
    C.reset_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = PS.sharded_merge_columns(cols, mesh, n_objs=n_objs, n_props=n_props,
                                   transport=transport, linearize=linearize)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    stats, gathers = json.loads(json.dumps(C.stats)), list(C.gathers)
    want, single_s = single
    print(f"{name}: {seconds:.6f} s wall (synchronised: condense, h2d, merge, "
          f"readback) against the single-device merge's {single_s:.6f} s "
          f"(h2d, merge, readback) on {card}", flush=True)
    print(f"{name} collectives {json.dumps(stats)}", flush=True)
    print(f"{name} launches {json.dumps(counts)}", flush=True)
    arm = SHARDED_CONDENSED if linearize == "condensed" else SHARDED_ROWS
    other = tuple(k for k in SHARDED_CONDENSED + SHARDED_ROWS if k not in arm)
    winners = SHARDED_SCATTER if scatter else ("sort_winners",)
    not_winners = ("sort_winners",) if scatter else SHARDED_SCATTER
    decode = ("expand_runs", "unpack_flags")
    check_launches(name, counts,
                   SHARDED_ALL + arm + winners + (decode if transport == "packed" else ()),
                   NOT_SHARDED + other + not_winners
                   + (decode if transport == "dict" else ()))
    for k in ALL_OUTPUTS:
        if out[k].shape != want[k].shape or not np.array_equal(out[k], want[k]):
            raise AssertionError(f"{name}: {k} differs from the single-device merge's")
    print(f"{name}: all 13 outputs equal to the single-device merge's", flush=True)
    return counts, gathers, R2


def doubling_bytes(gathers, length: int, rounds: int) -> float:
    """all_gather bytes per doubling round (the climb's and the rank's
    averaged): the gathers of ``length`` values per shard."""
    return sum(b for n, b in gathers if n == length) / (2 * rounds)


def mesh_doc_path(card, device, log, text_obj):
    """(f) The text fan-in's log less its last replica change, as two
    documents on the card, one with a mesh of ``MESH_SHARDS`` shards on
    the card (``enable_mesh``, min_rows 0); both apply that change, whose
    ops interleave with the others' (not a tail append), so its
    re-resolve is the full one: over the mesh in the first (its kernels
    must run, no single-device merge's), on the card alone in the other.
    The two equal on every READ_FETCH array and the text. Returns the
    launch counts of both applies."""
    import numpy as np

    from automerge_tpu_torch import kernels
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    changes = list(log.changes)
    docs, counts = {}, {}
    for mode in ("mesh", "single"):
        t0 = time.perf_counter()
        doc = DeviceDoc.from_changes(changes[:-1], device=device)
        t_build = time.perf_counter() - t0
        if mode == "mesh":
            doc.enable_mesh(devices=[device] * MESH_SHARDS, min_rows=0)
        torch.cuda.synchronize(device)
        kernels.reset_launches()
        t0 = time.perf_counter()
        doc.apply_changes(changes[-1:])
        t_apply = time.perf_counter() - t0
        counts[mode] = kernels.launch_counts()
        print(f"text mesh doc {mode}: OpLog and resolve of {len(changes) - 1} "
              f"changes {t_build:.3f} s; apply of the last change (its full "
              f"re-resolve) {t_apply:.6f} s on {card}; launches "
              f"{json.dumps(counts[mode])}", flush=True)
        docs[mode] = doc
    check_launches("text mesh doc", counts["mesh"],
                   SHARDED_ALL + SHARDED_CONDENSED + SHARDED_SCATTER,
                   NOT_SHARDED + ("sort_winners",))
    check_launches("text mesh doc single", counts["single"],
                   RUN_NATIVE + ("scatter_winners",),
                   SHARDED_ALL[:3] + SHARDED_CONDENSED + SHARDED_SCATTER)
    mesh, single = docs["mesh"], docs["single"]
    n = mesh.log.n
    for k in DeviceDoc.READ_FETCH:
        cut = mesh.log.n_objs + 2 if k.startswith("obj_") else n
        if not np.array_equal(np.asarray(mesh.res[k])[:cut],
                              np.asarray(single.res[k])[:cut]):
            raise AssertionError(f"text mesh doc: {k} differs from the "
                                 "single-device document's")
    if mesh.text(text_obj) != single.text(text_obj):
        raise AssertionError("text mesh doc: the text differs")
    print("text mesh doc: READ_FETCH and the text equal to the single-device "
          "document's", flush=True)
    return {"text mesh doc": counts["mesh"], "text mesh doc single": counts["single"]}


def sharded_paths(card, device, text, typing_log, record_log):
    """(f) The sharded merge (K11) over a mesh of ``MESH_SHARDS`` shards on
    the one card: the text fan-in (both linearize arms), the typing
    fan-in (both arms: the collectives' bytes per doubling round), the
    record fan-in (dict and packed), the mesh document, and the text
    fan-in over four cards where the machine has them. Returns the
    launch counts by path."""
    from automerge_tpu_torch.kernels import linearize as L
    from automerge_tpu_torch.parallel import default_mesh

    mesh = default_mesh(devices=[device] * MESH_SHARDS)
    text_log, text_obj = text
    counts = {}
    for name, log, arms in (
            ("text", text_log, (("condensed", "dict"), ("rows", "dict"))),
            ("typing", typing_log, (("condensed", "dict"), ("rows", "dict"))),
            ("records", record_log, (("condensed", "dict"), ("condensed", "packed")))):
        cols = log.padded_columns()
        geom = (log.n_objs, len(log.props))
        single = single_merge(cols, *geom, device)
        per_round = {}
        for linearize, transport in arms:
            path = f"{name} sharded" + ("" if linearize == "condensed" else " rows") + (
                " packed" if transport == "packed" else "")
            counts[path], gathers, R2 = sharded_path(
                path, card, cols, *geom, mesh, single, linearize, transport)
            P = len(cols["action"])
            per_round[linearize] = (
                doubling_bytes(gathers, R2 // MESH_SHARDS, L.ceil_log2(R2) + 1)
                if linearize == "condensed" else
                doubling_bytes(gathers, P // MESH_SHARDS + 1, L.rounds(P)))
        if name == "typing":
            print(f"typing sharded: all_gather bytes per doubling round, condensed "
                  f"arm {per_round['condensed']:.1f}, row arm {per_round['rows']:.1f}, "
                  f"ratio {per_round['rows'] / per_round['condensed']:.2f}", flush=True)
    counts.update(mesh_doc_path(card, device, text_log, text_obj))
    n_cards = torch.cuda.device_count()
    if n_cards >= MESH_SHARDS:
        cols = text_log.padded_columns()
        geom = (text_log.n_objs, len(text_log.props))
        counts["text sharded 4 cards"] = sharded_path(
            "text sharded 4 cards", card, cols, *geom, default_mesh(MESH_SHARDS),
            single_merge(cols, *geom, device))[0]
    else:
        print(f"text sharded 4 cards: not run, this machine has {n_cards} CUDA "
              f"device(s); the mesh of {MESH_SHARDS} shards ran on one card",
              flush=True)
    return counts


def cards_paths(card, device) -> None:
    """``--cards``: the text fan-in's sharded merge over four distinct
    cards (the default mesh), both linearize arms, beside the same four
    shards on one card and the single-device merge, each run twice (the
    first call on a card pays its context and allocations). Every run is
    held to the single-device merge's 13 outputs as in (f)."""
    from automerge_tpu_torch.parallel import default_mesh

    n_cards = torch.cuda.device_count()
    if n_cards < MESH_SHARDS:
        raise SystemExit(f"chip_smoke --cards: needs {MESH_SHARDS} CUDA devices, "
                         f"found {n_cards}")
    doc, _, _, _, _ = text_fanin("text", card, device)
    cols = doc.log.padded_columns()
    geom = (doc.log.n_objs, len(doc.log.props))
    single = single_merge(cols, *geom, device)
    for where, mesh in (("4 cards", default_mesh(MESH_SHARDS)),
                        ("1 card", default_mesh(devices=[device] * MESH_SHARDS))):
        for linearize in ("condensed", "rows"):
            for rep in (1, 2):
                arm = "" if linearize == "condensed" else " rows"
                sharded_path(f"text sharded {where}{arm}, run {rep}", card, cols,
                             *geom, mesh, single, linearize)


def check_reference_fault(device) -> None:
    """(d) Two map puts whose prop ids the JAX package's packed key merges
    (prop 64 + 4 needs more than ceil_log2(16 + 5) bits): the packed
    transport and the condensed merge give the dict path's winners and
    conflicts (the JAX package's merge_kernel_condensed(32, 16) does not)."""
    import numpy as np

    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.merge import merge_columns, merge_kernel_condensed
    from automerge_tpu_torch.ops.oplog import pad_columns

    cols = {
        "action": np.array([1, 1], np.int32), "insert": np.zeros(2, bool),
        "prop": np.array([64, 0], np.int32), "elem_ref": np.array([-2, -2], np.int32),
        "obj_dense": np.array([0, 1], np.int32), "value_tag": np.array([4, 4], np.int32),
        "value_i32": np.zeros(2, np.int32), "width": np.ones(2, np.int32),
        "covered": np.ones(2, bool), "pred_src": np.zeros(0, np.int32),
        "pred_tgt": np.zeros(0, np.int32),
    }
    kw = dict(fetch=DeviceDoc.READ_FETCH, n_objs=2, n_props=None, device=device)
    d = merge_columns(dict(cols), **kw)
    p = merge_columns(dict(cols), transport="packed", **kw)
    c = columns_from_numpy(pad_columns(dict(cols, aorder=np.zeros(0, np.int32)), 2),
                           device)
    k = {name: v.cpu().numpy() for name, v in merge_kernel_condensed(32)(c).items()}
    got = {name: (list(r["winner"][:2]), list(r["conflicts"][:2]))
           for name, r in (("dict", d), ("packed", p), ("condensed", k))}
    if any(v != ([0, 1], [1, 1]) for v in got.values()):
        raise AssertionError(f"reference-fault input: winners, conflicts {got}")
    print("reference-fault input (props 64 and 0, P = 16): packed == condensed "
          "(rcap 32) == dict, winners [0, 1], conflicts [1, 1]",
          flush=True)


def check_served_subset(last, device) -> None:
    """One served batch's subset columns: the whole merge on the card
    equals the plain CPU path on every output, exactly."""
    import numpy as np

    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.ops.merge import ALL_OUTPUTS, merge_kernel

    cols, n_objs, n_props = last
    gpu = merge_kernel(columns_from_numpy(cols, device), n_objs, n_props)
    cpu = merge_kernel(columns_from_numpy(cols, "cpu"), n_objs, n_props)
    for k in ALL_OUTPUTS:
        if not np.array_equal(gpu[k].cpu().numpy(), cpu[k].numpy()):
            raise AssertionError(f"served subset: {k} differs between cuda and cpu")
    print(f"served subset (P {len(cols['action'])}, {n_objs} objects, prop ids "
          f"to {int(cols['prop'].max())}): cuda == cpu on all outputs", flush=True)


def expand_library(W, C, n: int):
    """torch.searchsorted and a gather: the decode of one stack in
    PyTorch calls (the yardstick of expand_runs)."""
    K, rcap = W.shape
    i = torch.arange(n, dtype=torch.int32, device=W.device).expand(K, n).contiguous()
    return lambda: torch.gather(W, 1, torch.searchsorted(C, i, right=True)
                                .clamp_(max=rcap - 1))


def expand_rows(stacks):
    """expand_runs rows for stacks of run tables: [(W, C, S or None, n,
    bools, tag)]."""
    from automerge_tpu_torch.kernels import expand_runs as E

    rows = []
    for W, C, S, n, bools, tag in stacks:
        args = (W, C, S, n, bools)
        rows.append(("expand_runs", E.expand_runs, E.expand_runs_plain, args,
                     E.expand_runs(*args), expand_library(W, C, n), tag))
    return rows


def resolve_rows(c, scatter_geom):
    """succ_vis, the winners (scatter_winners over ``scatter_geom`` =
    (n_objs2, n_props), sort_winners for None), forest and its
    radix_sort on column tensors ``c``, as a merge runs them: (rows,
    forest outputs). sort_winners and radix_sort are timed beside
    torch.sort of the same keys."""
    from automerge_tpu_torch.kernels import forest as F
    from automerge_tpu_torch.kernels import radix_sort as RS
    from automerge_tpu_torch.kernels import scatter_winners as SW
    from automerge_tpu_torch.kernels import sort_winners as SO
    from automerge_tpu_torch.kernels import succ_vis as SV

    sv_in = (c["action"], c["value_tag"], c["value_i32"], c["covered"],
             c["pred_src"], c["pred_tgt"])
    sv = SV.succ_vis(*sv_in)
    rows = [("succ_vis", SV.succ_vis, SV.succ_vis_plain, sv_in, sv, None, "")]
    win_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"], c["prop"],
              c["width"], sv[3])
    if scatter_geom is not None:
        sw_in = win_in + scatter_geom
        rows.append(("scatter_winners", SW.scatter_winners,
                     SW.scatter_winners_plain, sw_in, SW.scatter_winners(*sw_in),
                     None, ""))
    else:
        keys = group_keys(*win_in[:5])
        rows.append(("sort_winners", SO.sort_winners, SO.sort_winners_plain,
                     win_in, SO.sort_winners(*win_in), lambda: torch.sort(keys), ""))
    fo_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
    fo = F.forest(*fo_in)
    sib = F.sibling_keys(fo[0], fo[1])
    rows.append(("forest", F.forest, F.forest_plain, fo_in, fo, None, ""))
    rs_in = (sib, F.sibling_digits(sib.numel()))
    rows.append(("radix_sort", RS.radix_sort, RS.radix_sort_plain, rs_in,
                 (RS.radix_sort(*rs_in),), lambda: torch.sort(sib), ""))
    return rows, fo


def path_kernels(cols, n_objs: int, n_props: int, device):
    """The kernels of one path's run-native merge run on its padded
    columns as the merge runs them: [(name, kernel, plain, args, out,
    library, tag)], expand_runs once for each stack of run tables (its
    tag: the stack's length and form)."""
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.kernels import linearize as L
    from automerge_tpu_torch.ops.merge import (
        scatter_geom_key, scatter_geometry_ok, stage_cols_run_native,
    )

    _, stacks, plan = stage_cols_run_native(cols, device)
    rows = expand_rows([
        (arrs[0], arrs[1], arrs[2] if cls == "delta" else None, n, bools,
         f"n={n} {cls} K={len(names)} rcap={rcap}")
        for (n, rcap, cls, names, bools), arrs in zip(plan, stacks)])
    c = columns_from_numpy(cols, device)
    geom = (scatter_geom_key(n_objs, n_props)
            if scatter_geometry_ok(c["action"].numel(), n_objs, n_props) else None)
    core, fo = resolve_rows(c, geom)
    rows += core
    li_in = (fo[2], fo[3], fo[0], c["elem_ref"], c["obj_dense"])
    before = L.linearize.launches
    li = L.linearize(*li_in)
    check_call_launches("linearize", L.linearize.launches - before, L.LAUNCHES)
    rows.append(("linearize", L.linearize, L.linearize_plain, li_in, (li,), None,
                 f"{L.LAUNCHES} launches a call"))
    return rows


def eager_kernels(cols, n_objs: int, n_props: int, device):
    """expand_runs at each stack of run tables the eager-expansion staging
    (``staging="expand"``, K9) makes of one path's padded columns, as
    ``stage_cols_device`` runs it: one stack per column length, always
    the delta form, bool columns among the int32 ones."""
    import numpy as np

    from automerge_tpu_torch.ops.merge import _encode_columns, _stack

    _, groups = _encode_columns({k: np.asarray(v) for k, v in cols.items()},
                                run_native=False)
    stacks = []
    for n, group in groups.items():
        rcap, *arrs = _stack(n, group)
        W, C, S = (torch.from_numpy(a).to(device) for a in arrs)
        bools = tuple(b for _, _, b in group)
        stacks.append((W, C, S, n, bools, f"n={n} delta K={len(group)} "
                       f"rcap={rcap} bool columns {sum(bools)}"))
    return expand_rows(stacks)


def packed_kernels(cols, n_objs: int, n_props: int, device):
    """The packed transport's own kernels on one path's padded columns, as
    ``DeviceDoc.resolve(..., transport="packed")`` runs them: expand_runs
    at its row and edge stacks, unpack_flags, emit_packed of READ_FETCH."""
    from automerge_tpu_torch.kernels import emit_packed as EP
    from automerge_tpu_torch.kernels import expand_runs as E
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.ops.merge import (
        _capacity, _unpack_transport, encode_transport, merge_kernel,
    )

    key, arrays = encode_transport(cols)
    a = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    P, Q = len(cols["action"]), len(cols["pred_src"])
    stacks = [(a[f"w{g}"], a[f"c{g}"], a[f"s{g}"], n, (False,) * len(names),
               f"packed {g} n={n} K={len(names)} rcap={a[f'w{g}'].shape[1]}")
              for g, names, n in (("P", key[0], P), ("Q", key[2], Q)) if names]
    rows = expand_rows(stacks)
    if "flags" in key[0]:
        flags = rows[0][4][key[0].index("flags")]
    else:
        flags = a["plainP"][key[1].index("flags")]
    rows.append(("unpack_flags", E.unpack_flags, E.unpack_flags_plain, (flags,),
                 E.unpack_flags(flags), None, ""))
    core = merge_kernel(_unpack_transport(key, a, P, Q), n_objs, n_props)
    em_in = (core, DeviceDoc.READ_FETCH, min(_capacity(n_objs + 2, 16), P + 2))
    rows.append(("emit_packed", EP.emit_packed, EP.emit_packed_plain, em_in,
                 (EP.emit_packed(*em_in),), None, ""))
    return rows


def condensed_kernels(cols, n_objs: int, n_props: int, device, rcap: int):
    """merge_kernel_condensed's kernels on one path's padded columns (with
    the actor order), as it runs them: succ_vis, sort_winners, forest,
    radix_sort, then linearize_condensed at ``rcap``."""
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.kernels import linearize_condensed as LC

    c = columns_from_numpy(cols, device)
    rows, fo = resolve_rows(c, None)
    lc_in = (fo[2], fo[3], fo[0], c["elem_ref"], c["obj_dense"], c["aorder"],
             rcap)
    rows.append(("linearize_condensed", LC.linearize_condensed,
                 LC.linearize_condensed_plain, lc_in,
                 (LC.linearize_condensed(*lc_in),), None, f"rcap={rcap}"))
    return rows


def sharded_kernels(cols, n_objs: int, n_props: int, device, linearize: str):
    """The sharded merge's kernels on one path's padded columns at one
    shard's shapes (the mesh of ``MESH_SHARDS``), as it runs them:
    succ_partial on shard 0's pred slice, mesh_reduce on the four shards'
    stacked accumulators (and, past the scatter gate, on their win
    tables), visibility, the row-range winners at shard 0, then the
    ``linearize`` arm's kernels: a doubling round at one shard's slice of
    the state (the loops run to their end in between)."""
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.kernels import collectives as CK
    from automerge_tpu_torch.kernels import forest as F
    from automerge_tpu_torch.kernels import linearize as L
    from automerge_tpu_torch.kernels import scatter_winners as SW
    from automerge_tpu_torch.kernels import sharded as SH
    from automerge_tpu_torch.kernels import succ_vis as SV
    from automerge_tpu_torch.parallel import sharding as PS

    n = MESH_SHARDS
    c = columns_from_numpy({k: cols[k] for k in PS.COLUMN_SPECS}, device)
    P, Q = c["action"].numel(), c["pred_src"].numel()
    Pl, Ql = P // n, Q // n
    assert P % n == 0 and Q % n == 0, (P, Q)

    def succ_in(i):
        return (c["action"], c["value_i32"], c["covered"],
                c["pred_src"][i * Ql:(i + 1) * Ql].contiguous(),
                c["pred_tgt"][i * Ql:(i + 1) * Ql].contiguous())

    accs = [SV.succ_partial(*succ_in(i)) for i in range(n)]
    rows = [("succ_partial", SV.succ_partial, SV.succ_partial_plain, succ_in(0),
             (accs[0],), None, "shard 0")]
    stack = torch.stack([a.reshape(-1) for a in accs])
    acc = CK.mesh_reduce(stack, "sum")
    rows.append(("mesh_reduce", CK.mesh_reduce, CK.mesh_reduce_plain, (stack, "sum"),
                 (acc,), lambda: torch.stack(accs).sum(0), f"psum [{n}, 3P]"))
    acc = acc.reshape(3, P)
    vis_in = (c["action"], c["value_tag"], c["covered"], acc[0], acc[1])
    visible = SV.visibility(*vis_in)
    rows.append(("visibility", SV.visibility, SV.visibility_plain, vis_in,
                 (visible,), None, ""))
    if PS.sharded_gate(P, n_objs + 2, n_props):
        geom = (n_objs + 2, max(n_props, 1))

        def part_in(i):
            return (c["action"], c["insert"], c["elem_ref"], c["obj_dense"],
                    c["prop"], visible, i * Pl, Pl, *geom)

        tables = [SW.winners_partial(*part_in(i)) for i in range(n)]
        rows.append(("winners_partial", SW.winners_partial,
                     SW.winners_partial_plain, part_in(0), (tables[0],), None,
                     "shard 0"))
        wins = [t[0] for t in tables]
        win_stack = torch.stack(wins)
        win = CK.mesh_reduce(win_stack, "max")
        rows.append(("mesh_reduce", CK.mesh_reduce, CK.mesh_reduce_plain,
                     (win_stack, "max"), (win,), lambda: torch.stack(wins).amax(0),
                     f"pmax [{n}, G]"))
        cnt = CK.mesh_reduce(torch.stack([t[1] for t in tables]), "sum")
        wg_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"], c["prop"],
                 c["width"], win, cnt, 0, Pl, *geom)
        rows.append(("winners_gather", SW.winners_gather, SW.winners_gather_plain,
                     wg_in, SW.winners_gather(*wg_in), None, "shard 0"))
    fo = F.forest(c["action"], c["insert"], c["elem_ref"], c["obj_dense"])

    def doubling(step, plain, state, length, rounds, tag):
        """A round at shard 1's slice measured, then the loop over all
        nodes to its end."""
        args = (*state, length, length)
        rows.append((step.__name__, step, plain, args, step(*args), None, tag))
        for _ in range(rounds):
            state = step(*state, 0, state[0].numel())
        return state

    if linearize == "rows":
        El = Pl + 1
        li_in = (fo[2], fo[3], fo[0], c["elem_ref"], n * El)
        st = L.linearize_init(*li_in)
        rows.append(("linearize_init", L.linearize_init, L.linearize_init_plain,
                     li_in, st, None, f"Epad={n * El}"))
        ans = doubling(L.linearize_thread, L.linearize_thread_plain, st[:3], El,
                       L.rounds(P), f"El={El} shard 1")[0]
        rk_in = (st[3], ans, P)
        rk = L.linearize_rank_init(*rk_in)
        rows.append(("linearize_rank_init", L.linearize_rank_init,
                     L.linearize_rank_init_plain, rk_in, rk, None, ""))
        dist = doubling(L.linearize_rank, L.linearize_rank_plain, rk, El,
                        L.rounds(P), f"El={El} shard 1")[0]
        fi_in = (fo[2], fo[0], c["obj_dense"], dist, 0, P)
        rows.append(("linearize_final", L.linearize_final, L.linearize_final_plain,
                     fi_in, (L.linearize_final(*fi_in),), None, ""))
        return rows
    R2, cond_np = PS.condense_host(cols, n_objs + 2, n)
    Rl = R2 // n
    cond = {k: torch.from_numpy(v).to(device) for k, v in cond_np.items()}
    ci_in = (cond["centry"], cond["cpar"])
    ci = SH.cond_init(*ci_in)
    rows.append(("cond_init", SH.cond_init, SH.cond_init_plain, ci_in, ci, None,
                 f"R2={R2}"))
    rounds = L.ceil_log2(R2) + 1
    ans = doubling(L.linearize_thread, L.linearize_thread_plain, ci, Rl, rounds,
                   f"R2={R2} shard 1")[0]
    cs_in = (cond["tail_ans"], ans, cond["chain_id"], cond["clen"])
    cs = SH.cond_succ(*cs_in)
    rows.append(("cond_succ", SH.cond_succ, SH.cond_succ_plain, cs_in, cs, None,
                 f"R2={R2}"))
    cdist = doubling(L.linearize_rank, L.linearize_rank_plain, cs, Rl, rounds,
                     f"R2={R2} shard 1")[0]
    ce_in = (cond["chain_id"], cond["offset"], c["obj_dense"], c["insert"],
             c["action"], cond["start_chain"], cdist, 0, Pl)
    rows.append(("cond_expand", SH.cond_expand, SH.cond_expand_plain, ce_in,
                 (SH.cond_expand(*ce_in),), None, "shard 0"))
    return rows


REPLACES = {
    "succ_vis": ("automerge_tpu/ops/merge.py:59", "succ_vis.cu"),
    "scatter_winners": ("automerge_tpu/ops/merge.py:595", "scatter_winners.cu"),
    "sort_winners": ("automerge_tpu/ops/merge.py:110", "sort_winners.cu"),
    "forest": ("automerge_tpu/ops/merge.py:551", "forest.cu"),
    "radix_sort": ("automerge_tpu/ops/merge.py:582", "radix_sort.cu"),
    "linearize": ("automerge_tpu/ops/merge.py:216", "linearize.cu"),
    "linearize_condensed": ("automerge_tpu/ops/merge.py:303",
                            "linearize_condensed.cu"),
    "expand_runs": ("automerge_tpu/ops/merge.py:993", "expand_runs.cu"),
    "unpack_flags": ("automerge_tpu/ops/merge.py:1143", "expand_runs.cu"),
    "emit_packed": ("automerge_tpu/ops/merge.py:1181", "emit_packed.cu"),
    "succ_partial": ("automerge_tpu/parallel/sharding.py:340", "succ_vis.cu"),
    "visibility": ("automerge_tpu/parallel/sharding.py:345", "succ_vis.cu"),
    "winners_partial": ("automerge_tpu/parallel/sharding.py:132",
                        "scatter_winners.cu"),
    "winners_gather": ("automerge_tpu/parallel/sharding.py:141",
                       "scatter_winners.cu"),
    "linearize_init": ("automerge_tpu/parallel/sharding.py:216", "linearize.cu"),
    "linearize_thread": ("automerge_tpu/parallel/sharding.py:218", "linearize.cu"),
    "linearize_rank_init": ("automerge_tpu/parallel/sharding.py:232",
                            "linearize.cu"),
    "linearize_rank": ("automerge_tpu/parallel/sharding.py:238", "linearize.cu"),
    "linearize_final": ("automerge_tpu/parallel/sharding.py:247", "linearize.cu"),
    "cond_init": ("automerge_tpu/parallel/sharding.py:283", "sharded.cu"),
    "cond_succ": ("automerge_tpu/parallel/sharding.py:300", "sharded.cu"),
    "cond_expand": ("automerge_tpu/parallel/sharding.py:320", "sharded.cu"),
    "mesh_reduce": ("automerge_tpu/parallel/sharding.py:139", "collectives.cu"),
}


# the kernels timed on the device as well (torch.profiler)
DEVICE_TIMED = ("expand_runs", "linearize")


def measure(name, kern, plain, args, out, library, reps: int) -> dict:
    """One kernel at one path's shapes: its output against its plain
    version (raising unless equal), its bound and its times."""
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    err = max_abs_err(out, want)
    moved, ops = work(name, args, out)
    bounds = {"bytes": moved / HBM_BYTES_PER_S * 1e3,
              "operations": ops / INT32_OPS_PER_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    m = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: kern(*args), reps),
        "plain_ms": cuda_ms(lambda: plain(*args), reps),
        "bound_ms": bounds[bound_by],
        "bound_by": bound_by,
        "library_ms": cuda_ms(library, reps) if library else None,
    }
    if name in DEVICE_TIMED:
        m["device_ms"], m["device_kernels"] = device_ms(lambda: kern(*args), reps)
        if library:
            m["library_device_ms"] = device_ms(library, reps)[0]
    return m


def expand_host_steps(W, C, S, n: int, bools, library, reps: int = 200) -> dict:
    """Host microseconds of one expand_runs call on the card, by the
    wrapper's steps (argument checks, the layout of the bool columns, the
    allocations, the stream handle, the C call that launches the kernel,
    the column views), the whole call, and the yardstick's two PyTorch
    calls: medians of ``reps`` calls, each timed alone, the card
    synchronised between calls so that no queue fills."""
    from automerge_tpu_torch.kernels import expand_runs as E
    from automerge_tpu_torch.kernels._args import on_cuda, stream

    K, _, bools = E._check(W, C, S, n, bools)
    bits, nb, order = E._layout(bools)
    ints, flags = E._outputs(K, nb, n, W.device)
    st = stream(W)
    steps = {
        "checks": lambda: (E._check(W, C, S, n, bools),
                           on_cuda(W=W, C=C) if S is None else on_cuda(W=W, C=C, S=S)),
        "layout": lambda: E._layout(bools),
        "allocate": lambda: E._outputs(K, nb, n, W.device),
        "stream": lambda: stream(W),
        "launch": lambda: E._launch(W, C, S, n, bits, ints, flags, st),
        "views": lambda: E._columns(ints, flags, order),
        "whole call": lambda: E.expand_runs(W, C, S, n, bools),
        "yardstick (searchsorted + gather)": library,
    }
    us = {}
    for name, fn in steps.items():
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        us[name] = statistics.median(times) * 1e6
    torch.cuda.synchronize()
    return us


def kernel_report(paths, by_path, device, reps: int):
    """Each kernel against its plain version at the shapes of every path
    that runs it (``paths``: name -> (padded columns, n_objs, n_props), and
    for a name ending in "condensed", the condensed merge's, its columns
    with the actor order and rcap after; a name ending in
    "packed" is the packed transport's, one ending in "expand" the
    eager-expansion staging's), and sort_winners past 2^20 rows. A kernel's top-level numbers are those of the first
    path that runs it; ``by_path`` has them all (expand_runs: by stack)."""
    from automerge_tpu_torch.kernels import sort_winners as SO

    report = {}
    host_steps_done = False
    for path, (cols, n_objs, n_props, *caps) in paths.items():
        rows_of = (sharded_kernels if "sharded" in path else
                   packed_kernels if path.endswith("packed") else
                   eager_kernels if path.endswith("expand") else
                   condensed_kernels if path.endswith("condensed") else path_kernels)
        for name, kern, plain, args, out, library, tag in rows_of(
                cols, n_objs, n_props, device, *caps):
            m = {"P": len(cols["action"]),
                 **measure(name, kern, plain, args, out, library, reps)}
            m["launches"] = by_path[path][name]
            where = f"{path} {tag}".strip()
            if name == "expand_runs" and not host_steps_done:
                host_steps_done = True
                us = expand_host_steps(*args, library)
                print(f"{where}: expand_runs host us by step {json.dumps(us)}",
                      flush=True)
            print(f"{where}: {name} equal to its plain version, "
                  f"{json.dumps(m)}", flush=True)
            if name not in report:
                replaces, source = REPLACES[name]
                report[name] = {"name": name, "route": "cuda",
                                "source": f"automerge_tpu_torch/csrc/{source}",
                                "replaces": replaces, **m, "by_path": {}}
            entry = report[name]
            entry["max_abs_err"] = max(entry["max_abs_err"], m["max_abs_err"])
            entry["by_path"][where] = m
    for name, entry in report.items():
        launches = {path: counts[name] for path, counts in by_path.items()}
        entry["launches"] = sum(launches.values())
        entry["launches_by_path"] = launches

    # sort_winners past 2^20 rows, where a key packing the row would overflow
    wide = winner_columns(WIDE_P, 11, device)
    SO.sort_winners.launches = 0
    got = SO.sort_winners(*wide)
    wide_launches = SO.sort_winners.launches
    wide_keys = group_keys(*wide[:5])
    m = {"P": WIDE_P, **measure("sort_winners", SO.sort_winners,
                                SO.sort_winners_plain, wide, got,
                                lambda: torch.sort(wide_keys), reps)}
    m["launches"] = wide_launches
    report["sort_winners"]["wide"] = m
    report["sort_winners"]["max_abs_err"] = max(
        report["sort_winners"]["max_abs_err"], m["max_abs_err"])
    print(f"sort_winners at P = {WIDE_P}: equal to its plain version in "
          f"{wide_launches} launches", flush=True)
    return [report[name] for name in REPLACES]


def main() -> int:
    # 1. the card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    device = torch.device("cuda", 0)

    from automerge_tpu_torch.kernels import _build

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {built:.2f} s compiling ({time.perf_counter() - t0:.2f} s "
          f"with cache check), {_build.library_path().name}", flush=True)

    if sys.argv[1:] == ["--cards"]:
        cards_paths(card, device)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
            flush=True)
        return 0

    # 3. the main paths
    text_log, text_counts, text_out, text, text_obj = text_path(card, device)
    record_log, last, record_counts, record_out, expect = record_paths(card, device)
    check_reference_fault(device)
    typing_log, condensed_counts = condensed_paths(
        card, device, (text_log, text_out, text, text_obj),
        (record_log, record_out, expect))
    del text_out, record_out
    sharded_counts = sharded_paths(card, device, (text_log, text_obj), typing_log,
                                   record_log)

    # 4./5. every kernel against its plain version at each path's shapes;
    # the whole merge against the CPU on a small fan-in and a served subset
    from automerge_tpu_torch.ops.merge import condensed_caps

    by_path = {**text_counts, **record_counts, **condensed_counts,
               **sharded_counts}

    def spec(log, condensed=False):
        return (log.padded_columns(include_aorder=condensed), log.n_objs,
                len(log.props), *((condensed_caps(log),) if condensed else ()))

    text_cols, record_cols = spec(text_log), spec(record_log)
    paths = {"text": text_cols, "text expand": text_cols,
             "text packed": text_cols, "records": record_cols,
             "records expand": record_cols, "records packed": record_cols,
             "served": last, "text condensed": spec(text_log, True),
             "typing": spec(typing_log),
             "typing condensed": spec(typing_log, True),
             "records condensed": spec(record_log, True),
             "text sharded": (*text_cols, "condensed"),
             "text sharded rows": (*text_cols, "rows"),
             "records sharded": (*record_cols, "condensed")}
    report = kernel_report(paths, by_path, device, REPS)
    check_served_subset(last, device)
    check_small_against_cpu(device)
    print("small fan-in: cuda == cpu on all outputs", flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(card, flush=True)

    # 6. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
