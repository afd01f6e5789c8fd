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
                           keys (``resolve_state``), plus per-object
                           visible length and width.
  3. ``forest``          — the RGA sibling forest (parent / first child /
                           next sibling, by a bitonic sort of sibling keys).
  4. ``linearize``       — document order by pointer-doubling successor
                           threading + Wyllie list ranking.

Everything is int32 (counters wrap as in the reference). There is no host
engine and no packed transport: on CUDA the kernels always run. The CPU
(``device="cpu"``) runs each kernel's plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..convert import columns_from_numpy
from ..device import resolve_device
from ..kernels.forest import forest
from ..kernels.linearize import linearize
from ..kernels.scatter_winners import scatter_winners
from ..kernels.sort_winners import sort_winners
from ..kernels.succ_vis import succ_vis
from .oplog import _next_pow2, pad_columns

ALL_OUTPUTS = (
    "visible", "counter_inc", "winner", "conflicts", "succ_count",
    "inc_count", "first_child", "next_sib", "parent_row", "is_elem",
    "obj_vis_len", "obj_text_width", "elem_index",
)

_OBJ_STATS = ("obj_vis_len", "obj_text_width")


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


def merge_kernel(c, n_objs: int, n_props: int, phases=None):
    """All-device merge of padded column tensors ``c`` (one device, int32/
    bool as ``convert.columns_from_numpy`` makes them): the dict of the 13
    ``ALL_OUTPUTS`` tensors. ``n_objs``/``n_props`` bound the object and
    map-key ids of the columns and size the winner group table."""
    action = c["action"]
    dev = action.device
    P = action.shape[0]
    scatter = scatter_geometry_ok(P, n_objs, n_props)
    with _phase(phases, "succ_vis", dev):
        succ, inc, counter_inc, visible = succ_vis(
            action, c["value_tag"], c["value_i32"], c["covered"],
            c["pred_src"], c["pred_tgt"],
        )
    winner_args = (action, c["insert"], c["elem_ref"], c["obj_dense"],
                   c["prop"], c["width"], visible)
    with _phase(phases, "scatter_winners" if scatter else "sort_winners", dev):
        if scatter:
            winner, conflicts, obj_vis_len, obj_text_width = scatter_winners(
                *winner_args, *scatter_geom_key(n_objs, n_props))
        else:
            winner, conflicts, obj_vis_len, obj_text_width = sort_winners(
                *winner_args)
    with _phase(phases, "forest", dev):
        is_elem, parent_row, first_child, next_sib = forest(
            action, c["insert"], c["elem_ref"], c["obj_dense"]
        )
    with _phase(phases, "linearize", dev):
        elem_index = linearize(
            first_child, next_sib, is_elem, c["elem_ref"], c["obj_dense"]
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
        "elem_index": elem_index,
    }


def merge_columns(cols_np, fetch=None, n_objs=None, n_props=None, device=None,
                  phases=None):
    """Host entry: numpy columns in (``OpLog.columns()``, padded or not),
    numpy resolution out.

    ``fetch`` selects the outputs brought back (default: all of
    ``ALL_OUTPUTS``); per-row outputs come back at the padded length, and
    with ``n_objs`` given the per-object stats are cut to ``n_objs + 2``.
    ``n_objs``/``n_props`` default to what the columns hold. ``device``
    defaults to the card. ``phases``, a dict when given, collects the
    seconds of pad, h2d, each kernel and readback (the device is then
    synchronised between phases)."""
    dev = resolve_device(device)
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
    with _phase(phases, "h2d", dev):
        c = columns_from_numpy(cols_np, dev)
    out = merge_kernel(c, n_objs_eff, max(n_props_eff, 0), phases)
    need = fetch if fetch is not None else ALL_OUTPUTS
    with _phase(phases, "readback", dev):
        host = {}
        for k in need:
            v = out[k]
            if k in _OBJ_STATS and n_objs is not None:
                v = v[: n_objs + 2]
            host[k] = v.cpu().numpy()
    return host
