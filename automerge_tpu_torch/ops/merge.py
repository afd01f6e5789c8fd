"""The batched causal-resolution merge (the north star), on the card.

Replaces the reference's sequential per-op seek/insert loop
(reference: rust/automerge/src/automerge.rs:1258-1280, op_tree.rs:212-239)
with one pass of four kernels over the whole op log, each the port of a
part of ``automerge_tpu/ops/merge.py``'s all-device ``merge_kernel`` (:288):

  1. ``succ_vis``        — pred references (pre-resolved to row indices by
                           the host columnizer) counted into per-op succ /
                           increment counters, then the visibility rule.
  2. ``scatter_winners`` — per-key winners and conflict counts over dense
     or ``sort_winners``   group ids (the sort-free ``resolve_state_scatter``
                           form) while the group table passes
                           ``scatter_geometry_ok``, else over sorted group
                           keys (``resolve_state``, grouped by a hash
                           table on the card), plus per-object
                           visible length and width.
  3. ``forest``          — the RGA sibling forest (parent / first child /
                           next sibling, by a radix sort of sibling keys).
  4. ``linearize``       — document order by pointer-doubling successor
                           threading + Wyllie list ranking.

``merge_kernel_condensed`` (K8, :508) is the same merge with the sort-based
winners and document order by ``linearize_condensed``: typing chains found
as contiguous stretches of the actor order (``OpLog.actor_order``, the
``aorder`` column) and both doubling loops over at most ``rcap`` runs
(``condensed_caps``). As in the JAX package it is called directly on
padded column tensors; ``merge_columns`` does not route to it.

The columns reach the card as the JAX package stages them (``staging``):
by default run-native (:908-1038), each run-coded column a slope-RLE run
table that the ``expand_runs`` kernel decodes on the card just before the
four kernels; ``"expand"`` decodes the same tables eagerly (:765-892);
``"dense"`` copies the plain columns. ``transport="packed"`` is the JAX
package's packed transport (:1082-1306): run tables and flag-packed
columns in, one flat int32 vector with bit-packed ``visible``/
``conflicts`` out (``expand_runs``, ``unpack_flags``, the four kernels,
``emit_packed``).

Everything is int32 (counters wrap as in the reference). There is no host
engine: on CUDA the kernels always run. The CPU (``device="cpu"``) runs
each kernel's plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import obs
from ..convert import columns_from_numpy
from ..device import resolve_device
from ..kernels.emit_packed import BIT_OUTPUTS, OBJ_STATS, emit_packed
from ..kernels.expand_runs import F_TAG_SHIFT, expand_runs, unpack_flags
from ..kernels.forest import forest
from ..kernels.linearize import linearize
from ..kernels.linearize_condensed import linearize_condensed
from ..kernels.scatter_winners import scatter_winners
from ..kernels.sort_winners import sort_winners
from ..kernels.succ_vis import succ_vis
from ..obs import prof as _prof
from .compressed import run_gate
from .oplog import _capacity, _next_pow2, pad_columns

ALL_OUTPUTS = (
    "visible", "counter_inc", "winner", "conflicts", "succ_count",
    "inc_count", "first_child", "next_sib", "parent_row", "is_elem",
    "obj_vis_len", "obj_text_width", "elem_index",
)

# node-space outputs: [0,P) elements + [P,2P+2) object roots + sentinel
_NODE_OUTPUTS = ("first_child", "next_sib")
# the packed transport's row columns (flags: action, insert, value_tag and
# covered in one int32) and pred-edge columns
_P_ORDER = ("flags", "prop", "elem_ref", "obj_dense", "value_i32", "width")
_Q_ORDER = ("pred_src", "pred_tgt")

STAGINGS = ("run_native", "expand", "dense")
TRANSPORTS = ("dict", "packed")


def scatter_geom_key(n_objs: int, n_props: int):
    """Pow2-bucketed (n_objs2, n_props) geometry of the group table: a
    larger table changes nothing — the gid mapping stays injective and
    every output is per-row or fixed-size."""
    return (_next_pow2(max(n_objs + 2, 16)), _next_pow2(max(n_props, 1)))


def scatter_geometry_ok(P: int, n_objs: int, n_props: int) -> bool:
    # evaluated on the BUCKETED geometry (scatter_geom_key) so the gate
    # bounds the actual table, not the pre-bucket request
    n_objs2, np_eff = scatter_geom_key(n_objs, n_props)
    return n_objs2 * np_eff <= 8 * P + 65536


@contextlib.contextmanager
def _phase(phases, name: str, device: torch.device):
    """Adds the seconds of the block to ``phases[name]``; with ``phases``
    given, the device is synchronised at both ends so the time is the
    block's own."""
    if phases is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0


def _count(phases, name: str, n: int) -> None:
    if phases is not None:
        phases[name] = phases.get(name, 0) + n


def _resolve(c, geom, phases):
    """succ_vis, the winners (the scatter kernel over the group table
    ``geom`` = (n_objs2, n_props), the sort-based kernel for ``None``) and
    the forest: ALL_OUTPUTS but ``elem_index``, in their order."""
    action = c["action"]
    dev = action.device
    with _phase(phases, "succ_vis", dev):
        succ, inc, counter_inc, visible = succ_vis(
            action, c["value_tag"], c["value_i32"], c["covered"],
            c["pred_src"], c["pred_tgt"],
        )
    winner_args = (action, c["insert"], c["elem_ref"], c["obj_dense"],
                   c["prop"], c["width"], visible)
    with _phase(phases, "sort_winners" if geom is None else "scatter_winners", dev):
        if geom is None:
            winner, conflicts, obj_vis_len, obj_text_width = sort_winners(
                *winner_args)
        else:
            winner, conflicts, obj_vis_len, obj_text_width = scatter_winners(
                *winner_args, *geom)
    with _phase(phases, "forest", dev):
        is_elem, parent_row, first_child, next_sib = forest(
            action, c["insert"], c["elem_ref"], c["obj_dense"]
        )
    return {
        "visible": visible,
        "counter_inc": counter_inc,
        "winner": winner,
        "conflicts": conflicts,
        "succ_count": succ,
        "inc_count": inc,
        "first_child": first_child,
        "next_sib": next_sib,
        "parent_row": parent_row,
        "is_elem": is_elem,
        "obj_vis_len": obj_vis_len,
        "obj_text_width": obj_text_width,
    }


def merge_kernel(c, n_objs, n_props, phases=None):
    """All-device merge of padded column tensors ``c`` (one device, int32/
    bool as ``convert.columns_from_numpy`` makes them): the dict of the 13
    ``ALL_OUTPUTS`` tensors. ``n_objs``/``n_props`` bound the object and
    map-key ids of the columns and size the winner group table; the
    scatter winners run when both are given and the table passes
    ``scatter_geometry_ok``, the sort-based winners otherwise."""
    P = c["action"].shape[0]
    scatter = (n_objs is not None and n_props is not None
               and scatter_geometry_ok(P, n_objs, n_props))
    out = _resolve(c, scatter_geom_key(n_objs, n_props) if scatter else None,
                   phases)
    with _phase(phases, "linearize", c["action"].device):
        out["elem_index"] = linearize(
            out["first_child"], out["next_sib"], out["is_elem"], c["elem_ref"],
            c["obj_dense"])
    return out


def condensed_caps(log) -> int:
    """The run bucket ``rcap`` of ``merge_kernel_condensed`` for ``log``
    (``automerge_tpu/ops/merge.py`` ``condensed_caps``, :497): its exact
    run count through ``_capacity``. The reference's second bucket,
    ``obj_cap``, sizes a packed winner key the port does not use."""
    return _capacity(max(log.condensed_run_count(), 1), 32)


def merge_kernel_condensed(rcap: int):
    """The all-device merge whose document order condenses typing chains
    into at most ``rcap`` runs (``merge_kernel_condensed``, :508): a
    callable of ``(c, phases=None)``, ``c`` padded column tensors with
    ``aorder`` (``padded_columns(include_aorder=True)``), returning the 13
    ``ALL_OUTPUTS``. The winners are the sort-based kernel's, as the
    reference's ``resolve_state``. The reference's ``obj_cap`` argument
    packs that kernel's group key into one int32 and can merge groups
    (ROADMAP §3); here the key is injective and there is no such argument.
    Raises ``ValueError`` when the log has more runs than ``rcap``
    (``condensed_caps`` gives one that fits)."""

    def fn(c, phases=None):
        out = _resolve(c, None, phases)
        with _phase(phases, "linearize_condensed", c["action"].device):
            out["elem_index"] = linearize_condensed(
                out["first_child"], out["next_sib"], out["is_elem"],
                c["elem_ref"], c["obj_dense"], c["aorder"], rcap)
        return out

    return fn


# -- host encoders ------------------------------------------------------------


def _flags_column(cols) -> np.ndarray:
    return (
        cols["action"].astype(np.int32)
        | (cols["insert"].astype(np.int32) << 4)
        | (cols["value_tag"].astype(np.int32) << F_TAG_SHIFT)
        | (cols["covered"].astype(np.int32) << 9)
    )


def _slope_rle(x: np.ndarray):
    """Slope-RLE one column: x[i] == w[run(i)] + slope*i, or None.

    Slope candidates: 0, 1 and the modal first-difference — the latter
    catches the stride-N patterns Lamport row order produces when N
    replicas' same-counter ops interleave (elem_ref then steps by N).
    Returns (w, cum, slope) int32 arrays, or None when the column doesn't
    compress below n/8 runs (caller ships it as a plain column).
    """
    n = len(x)
    if n == 0:
        return None
    # x[i] - s*i steps by d[i] - s: a run ends where that is nonzero, so
    # one difference pass scores every slope
    d = np.subtract(x[1:], x[:-1], dtype=np.int64)
    cands = [0, 1]
    if n > 2:
        # the modal difference of the first 2^16 rows, the smallest of a
        # tie (np.unique's order); a counting pass when the range is small
        head = d[: min(n, 1 << 16) - 1]
        lo, hi = int(head.min()), int(head.max())
        if hi - lo < (1 << 22):
            mode = int(np.argmax(np.bincount(head - lo))) + lo
        else:
            vals, counts = np.unique(head, return_counts=True)
            mode = int(vals[np.argmax(counts)])
        if mode not in cands and abs(mode) < (1 << 20):
            cands.append(mode)
    # the first slope with the fewest run ends
    s, n_ends = min(((s, int(np.count_nonzero(d != s))) for s in cands),
                    key=lambda c: c[1])
    if n_ends + 1 > max(n // 8, 15):
        return None
    starts = np.concatenate([[0], np.flatnonzero(d != s) + 1])
    w = x[starts].astype(np.int64) - s * starts
    if w.min() < -(1 << 31) or w.max() >= (1 << 31):
        return None
    cum = np.concatenate([starts[1:], [n]])
    return w.astype(np.int32), cum.astype(np.int32), s


def _run_table(encs, n: int, rcap: int):
    """One stack of run tables: W (run values) and C (run ends, padded
    with n), int32 [K, rcap], and S, int32 [K], the slopes."""
    K = len(encs)
    W = np.zeros((K, rcap), np.int32)
    C = np.full((K, rcap), np.int32(n), np.int32)
    S = np.empty(K, np.int32)
    for idx, (w, cum, s) in enumerate(encs):
        W[idx, : len(w)] = w
        C[idx, : len(cum)] = cum
        S[idx] = s
    return W, C, S


def _note_h2d(phases, actual: int, dense: int) -> None:
    """Byte accounting of every staging: the bytes copied to the card and
    the bytes the dense columns would have taken (the ``obs`` counter
    pair, the cycle profiler's notes and ``phases``)."""
    obs.count("device.h2d_bytes", n=actual)
    obs.count("device.h2d_dense_bytes", n=dense)
    _prof.note("h2d_bytes", actual)
    _prof.note("h2d_dense_bytes", dense)
    _count(phases, "h2d_bytes", actual)
    _count(phases, "h2d_dense_bytes", dense)


def _to_device(arrays, dev):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


# -- staging (the dict transport) ---------------------------------------------


def _encode_columns(cols_np, run_native: bool):
    """Each column slope-RLE coded or kept dense, as the JAX package's
    stagings split them: dense when shorter than 32 rows, not int32/bool,
    past ``_slope_rle``'s n/8 gate or, for the run-native staging, past
    ``compressed.run_gate``. Returns the dense {name: array} and the coded
    columns grouped into stacks, {key: [(name, (w, cum, slope), is_bool)]}
    keyed by length, or for the run-native staging by (length, "rle" |
    "delta"). A coded column's demotion counts as
    ``oplog.compress_fallback{column,reason=h2d}``; on the run-native
    staging every dense column counts as
    ``device.run_native_fallback{column,reason}`` (short, dtype, ratio)."""
    dense, groups = {}, {}
    for k, v in cols_np.items():
        n = len(v)
        enc = None
        reason = None
        if n < 32:
            reason = "short"
        elif v.dtype not in (np.int32, np.bool_):
            reason = "dtype"
        else:
            enc = _slope_rle(v if v.dtype == np.int32 else v.astype(np.int32))
            if run_native and enc is not None and run_gate(len(enc[0]), n):
                enc = None
            if enc is None:
                reason = "ratio"
                obs.count("oplog.compress_fallback",
                          labels={"column": k, "reason": "h2d"})
        if enc is None:
            if run_native:
                obs.count("device.run_native_fallback",
                          labels={"column": k, "reason": reason})
            dense[k] = v
            continue
        key = (n, "rle" if enc[2] == 0 else "delta") if run_native else n
        groups.setdefault(key, []).append((k, enc, v.dtype == np.bool_))
    return dense, groups


def _stack(n: int, cols):
    """(rcap, W, C, S) of one stack: rcap is the bucketed largest run count."""
    rcap = _capacity(max(len(e[0]) for _, e, _ in cols), 16)
    return (rcap, *_run_table([e for _, e, _ in cols], n, rcap))


def stage_cols_device(cols_np, device, phases=None):
    """Eager-expansion staging (``automerge_tpu/ops/merge.py``
    ``stage_cols_device``, :765): per column, slope-RLE run tables are
    copied to the card, one stacked (K, rcap) table per column length,
    and expanded there at once by the ``expand_runs`` kernel (K9). A
    column past ``_slope_rle``'s n/8 gate, or shorter than 32 rows, ships
    dense. Returns {name: tensor} on ``device``."""
    dev = torch.device(device)
    cols_np = {k: np.asarray(v) for k, v in cols_np.items()}
    P = len(cols_np["action"])
    with _phase(phases, "encode", dev):
        dense, groups = _encode_columns(cols_np, run_native=False)
        stacks = [(n, cols, _stack(n, cols)[1:]) for n, cols in groups.items()]
    h2d_bytes = (sum(v.nbytes for v in dense.values())
                 + sum(a.nbytes for _, _, arrs in stacks for a in arrs))
    with _phase(phases, "h2d", dev), obs.span("device.h2d", rows=P,
                                              bytes=h2d_bytes):
        out = columns_from_numpy(dense, dev)
        dev_stacks = [(n, cols, _to_device(arrs, dev)) for n, cols, arrs in stacks]
    if dev_stacks:
        with _phase(phases, "expand", dev), obs.span(
                "device.expand", rows=P, stacks=len(dev_stacks)):
            for n, cols, (W, C, S) in dev_stacks:
                expanded = expand_runs(W, C, S, n, tuple(b for _, _, b in cols))
                for (k, _, _), col in zip(cols, expanded):
                    out[k] = col
    _note_h2d(phases, h2d_bytes, sum(v.nbytes for v in cols_np.values()))
    return out


def stage_cols_run_native(cols_np, device, phases=None):
    """Run-native staging (``automerge_tpu/ops/merge.py``
    ``stage_cols_run_native``, :908): per column, slope-RLE run tables
    are copied to the card and stay the resolution's input. Columns group
    into stacks by (length, "rle" | "delta"), in sorted order; a column
    shorter than 32 rows, or whose run table fails ``_slope_rle``'s gate
    or ``compressed.run_gate``, ships dense. Returns ``(dense, stacks,
    plan)``: {name: tensor} of the dense columns, one ``(W, C)`` (rle) or
    ``(W, C, S)`` (delta) tuple of tensors per stack, and one ``(n, rcap,
    enc, names, bools)`` entry per stack."""
    dev = torch.device(device)
    cols_np = {k: np.asarray(v) for k, v in cols_np.items()}
    P = len(cols_np["action"])
    with _phase(phases, "encode", dev):
        dense, groups = _encode_columns(cols_np, run_native=True)
        plan, host_stacks = [], []
        for (n, cls), cols in sorted(groups.items(), key=lambda kv: kv[0]):
            rcap, W, C, S = _stack(n, cols)
            plan.append((n, rcap, cls, tuple(k for k, _, _ in cols),
                         tuple(b for _, _, b in cols)))
            host_stacks.append((W, C) if cls == "rle" else (W, C, S))
    h2d_bytes = (sum(v.nbytes for v in dense.values())
                 + sum(a.nbytes for arrs in host_stacks for a in arrs))
    dense_bytes = sum(v.nbytes for v in cols_np.values())
    with _phase(phases, "h2d", dev), obs.span("device.h2d", rows=P,
                                              bytes=h2d_bytes):
        dense_dev = columns_from_numpy(dense, dev)
        stacks = tuple(_to_device(arrs, dev) for arrs in host_stacks)
    _note_h2d(phases, h2d_bytes, dense_bytes)
    obs.count("device.kernel_input_bytes", n=h2d_bytes)
    obs.count("device.kernel_input_dense_bytes", n=dense_bytes)
    return dense_dev, stacks, tuple(plan)


def _core_args(geom):
    """(n_objs, n_props) for ``merge_kernel``: the scatter winners for
    ``("scatter", n_objs, n_props)``, the sort-based ones for
    ``("core",)``."""
    return (geom[1], geom[2]) if geom[0] == "scatter" else (None, None)


def run_native_kernel(plan, geom):
    """The run-native resolution for one staging plan (K1,
    ``run_native_kernel``, :993): a callable of ``(dense, stacks,
    phases=None)`` that decodes each stack with the ``expand_runs`` kernel
    (its rle or delta form) into the columns, then runs ``merge_kernel``,
    all on the current stream with no host sync in between. ``geom``
    picks the winners: ``("scatter", n_objs, n_props)`` or ``("core",)``
    (sort-based). Document order always comes from ``linearize``."""

    def fn(dense, stacks, phases=None):
        c = dict(dense)
        dev = stacks[0][0].device
        with _phase(phases, "expand", dev):
            for (n, rcap, cls, names, bools), arrs in zip(plan, stacks):
                S = arrs[2] if cls == "delta" else None
                c.update(zip(names, expand_runs(arrs[0], arrs[1], S, n, bools)))
        return merge_kernel(c, *_core_args(geom), phases)

    return fn


def prepare_resolution(cols_np, n_objs=None, n_props=None, device=None,
                       staging: str = "run_native", phases=None):
    """Stage padded numpy columns on ``device`` for one resolution and
    return a zero-argument callable that launches it (``prepare_resolution``,
    :1040). The winners are the scatter ones when ``n_objs`` and
    ``n_props`` are given and the geometry passes, the sort-based ones
    otherwise. ``staging``: ``"run_native"`` (run tables decoded just
    before the kernels; dense when no column run-encodes), ``"expand"``
    (run tables decoded eagerly here), ``"dense"`` (plain columns)."""
    dev = resolve_device(device)
    P = len(cols_np["action"])
    if n_objs is not None and n_props is not None and scatter_geometry_ok(
            P, n_objs, n_props):
        geom = ("scatter", n_objs, n_props)
    else:
        geom = ("core",)
    if staging == "run_native":
        dense, stacks, plan = stage_cols_run_native(cols_np, dev, phases)
        if plan:
            obs.count("device.kernel_launches", labels={"path": "run_native"})
            fn = run_native_kernel(plan, geom)
            return lambda: fn(dense, stacks, phases)
        cols = dense  # nothing run-eligible: plain dense launch
    elif staging == "expand":
        cols = stage_cols_device(cols_np, dev, phases)
    elif staging == "dense":
        nbytes = sum(np.asarray(v).nbytes for v in cols_np.values())
        with _phase(phases, "h2d", dev), obs.span("device.h2d", rows=P,
                                                  bytes=nbytes):
            cols = columns_from_numpy(cols_np, dev)
        _note_h2d(phases, nbytes, nbytes)
    else:
        raise ValueError(f"staging must be one of {STAGINGS}, not {staging!r}")
    return lambda: merge_kernel(cols, *_core_args(geom), phases)


# -- the packed transport -----------------------------------------------------


def encode_transport(cols) -> tuple:
    """Choose per column between slope-RLE runs and plain transfer
    (``encode_transport``, :1082). Returns ``(static_key, arrays)``:
    ``static_key`` = (run-coded row columns, plain row columns, run-coded
    edge columns, plain edge columns) by name, ``arrays`` the numpy
    inputs ``wP``/``cP``/``sP`` (one stacked run table per group),
    ``plainP`` (the plain columns stacked), and the same for ``Q``."""
    p_sources = dict(cols, flags=_flags_column(cols))
    groups = {
        "P": {k: p_sources[k].astype(np.int32) for k in _P_ORDER},
        "Q": {k: cols[k].astype(np.int32) for k in _Q_ORDER},
    }
    arrays = {}
    plain_names = []
    for gname, group in groups.items():
        length = len(next(iter(group.values())))
        encs = {}
        for k, x in group.items():
            e = _slope_rle(x)
            if e is None:
                plain_names.append(k)
            else:
                encs[k] = e
        if encs:
            r_cap = _next_pow2(max(max(len(w) for w, _, _ in encs.values()), 16))
            W, C, S = _run_table(list(encs.values()), length, r_cap)
            arrays[f"w{gname}"] = W
            arrays[f"c{gname}"] = C
            arrays[f"s{gname}"] = S
        plain = [k for k in group if k not in encs]
        if plain:
            arrays[f"plain{gname}"] = np.stack([group[k] for k in plain])
    run_namesP = tuple(k for k in groups["P"] if k not in plain_names)
    run_namesQ = tuple(k for k in groups["Q"] if k not in plain_names)
    plainP = tuple(k for k in groups["P"] if k in plain_names)
    plainQ = tuple(k for k in groups["Q"] if k in plain_names)
    return (run_namesP, plainP, run_namesQ, plainQ), arrays


def _unpack_transport(static_key, arrays, P: int, Q: int):
    """The merge's column tensors from the transport's (``_unpack_transport``,
    :1143): each group's run table decoded by ``expand_runs``, the flags
    split by ``unpack_flags``."""
    run_namesP, plainP, run_namesQ, plainQ = static_key
    cols = {}
    for gname, run_names, plain_names, n in (
        ("P", run_namesP, plainP, P),
        ("Q", run_namesQ, plainQ, Q),
    ):
        if run_names:
            cols.update(zip(run_names, expand_runs(
                arrays[f"w{gname}"], arrays[f"c{gname}"], arrays[f"s{gname}"],
                n, (False,) * len(run_names))))
        for i, k in enumerate(plain_names):
            cols[k] = arrays[f"plain{gname}"][i]
    cols["action"], cols["insert"], cols["value_tag"], cols["covered"] = (
        unpack_flags(cols.pop("flags")))
    return cols


def _bitunpack(words, P):
    bits = np.unpackbits(
        np.asarray(words, np.int32).view(np.uint8), bitorder="little"
    )
    return bits[:P].astype(bool)


def _split_flat(flat, fetch, P, obj_cap):
    """The flat vector back into named host arrays (``_split_flat``,
    :1222): ``conflicts`` comes back as a conflicted flag, 2 or 1."""
    out = {}
    pos = 0
    words = (P + 31) // 32
    for k in fetch:
        if k in BIT_OUTPUTS:
            v = _bitunpack(flat[pos : pos + words], P)
            pos += words
            if k == "conflicts":
                # travels as a "conflicted" flag; consumers compare > 1
                v = np.where(v, np.int32(2), np.int32(1))
        else:
            if k in OBJ_STATS:
                size = obj_cap
            elif k in _NODE_OUTPUTS:
                size = 2 * P + 3
            else:
                size = P
            v = flat[pos : pos + size]
            pos += size
            if k == "is_elem":
                v = v.astype(bool)
        out[k] = v
    return out


def _packed_merge(cols_np, fetch, n_objs, n_props, dev, phases=None):
    """The packed transport (``_packed_merge``, :1248, with ``_runs_fn``,
    :1198, K10): the transport's arrays copied to the card, decoded there,
    merged, and the outputs read back as one flat int32 vector. Unlike the
    JAX package it keeps ``elem_index`` on the card (the ``linearize``
    kernel) and its winner keys are the dict path's, injective for any
    prop id."""
    P = len(cols_np["action"])
    Q = len(cols_np["pred_src"])
    obj_cap = min(_capacity((n_objs or P) + 2, 16), P + 2)
    fetch = tuple(fetch)
    with _phase(phases, "encode", dev):
        static_key, arrays = encode_transport(cols_np)
    pk_bytes = sum(a.nbytes for a in arrays.values())
    with _phase(phases, "h2d", dev), obs.span("device.h2d", rows=P,
                                              bytes=pk_bytes):
        names = tuple(arrays)
        arrays_dev = dict(zip(names, _to_device([arrays[k] for k in names], dev)))
    _note_h2d(phases, pk_bytes,
              sum(np.asarray(v).nbytes for v in cols_np.values()))
    # the launches are queued without a sync; the readback holds the wait
    with obs.span("device.kernel", rows=P):
        with _phase(phases, "expand", dev):
            c = _unpack_transport(static_key, arrays_dev, P, Q)
        core = merge_kernel(c, n_objs, n_props, phases)
        with _phase(phases, "emit", dev):
            flat_dev = emit_packed(core, fetch, obj_cap)
    with _phase(phases, "readback", dev), obs.span("device.readback", rows=P):
        flat = flat_dev.cpu().numpy()
    _count(phases, "d2h_bytes", flat.nbytes)
    with obs.span("device.materialize", rows=P):
        return _split_flat(flat, fetch, P, obj_cap)


def merge_columns(cols_np, fetch=None, n_objs=None, n_props=None, device=None,
                  phases=None, staging: str = "run_native",
                  transport: str = "dict"):
    """Host entry: numpy columns in (``OpLog.columns()``, padded or not),
    numpy resolution out.

    ``fetch`` selects the outputs brought back (default: all of
    ``ALL_OUTPUTS``); per-row outputs come back at the padded length.
    ``device`` defaults to the card.

    ``transport="dict"`` (default) reads back each output as its own
    array, the per-object stats cut to ``n_objs + 2`` when ``n_objs`` is
    given; ``n_objs``/``n_props`` default to what the columns hold, and
    ``staging`` (``"run_native"``, ``"expand"``, ``"dense"``: see
    ``prepare_resolution``) says how the columns reach the card.
    ``transport="packed"`` is the JAX package's packed transport, whatever
    ``staging`` says: ``conflicts`` comes back as a 1/2 conflicted flag,
    the stats cut to the bucketed object capacity; the scatter winners run
    only when ``n_objs`` and ``n_props`` are both given.

    ``phases``, a dict when given, collects the seconds of pad, encode
    (the host run-length encoding), h2d, expand (the decode on the card),
    each kernel, emit (packed) and readback (the device is then
    synchronised between phases), and the byte counts ``h2d_bytes``,
    ``h2d_dense_bytes`` and ``d2h_bytes``."""
    dev = resolve_device(device)
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, not {transport!r}")
    n = len(cols_np["action"])
    with _phase(phases, "pad", dev):
        obj_dense = np.asarray(cols_np["obj_dense"])[:n]
        prop = np.asarray(cols_np["prop"])[:n]
        n_objs_eff = n_objs if n_objs is not None else (
            int(obj_dense.max()) + 1 if n else 1
        )
        n_props_eff = n_props if n_props is not None else (
            int(prop.max()) + 1 if n else 0
        )
        cols_np = pad_columns(cols_np, n_objs_eff)
    need = fetch if fetch is not None else ALL_OUTPUTS
    if transport == "packed":
        return _packed_merge(cols_np, need, n_objs, n_props, dev, phases)
    dispatch = prepare_resolution(cols_np, n_objs_eff, max(n_props_eff, 0), dev,
                                  staging, phases)
    P = len(cols_np["action"])
    # the launches are queued without a sync; the readback holds the wait
    with obs.span("device.kernel", rows=P):
        out = dispatch()
    with _phase(phases, "readback", dev), obs.span("device.readback", rows=P):
        host = {}
        for k in need:
            v = out[k]
            if k in OBJ_STATS and n_objs is not None:
                v = v[: n_objs + 2]
            host[k] = v.cpu().numpy()
    _count(phases, "d2h_bytes", sum(v.nbytes for v in host.values()))
    return host
