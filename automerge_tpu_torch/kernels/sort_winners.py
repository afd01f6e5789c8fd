"""sort_winners: per-key winners, conflict counts and per-object stats for
any group geometry.

Replaces ``automerge_tpu/ops/merge.py`` ``resolve_state`` (:110-213)
without its forest call: the winner step of every merge whose group table
fails ``scatter_geometry_ok`` (a map of records, and every subset
re-resolve of one). The CUDA kernel is ``csrc/sort_winners.cu``: one int64
group key per row, each row's group slot found in an open-addressing hash
table of ``table_capacity(P)`` slots (at most half full, so a linear
probe ends), atomicMax/atomicAdd of visible rows into the slots, then a
gather pass that also accumulates the per-object stats: three launches,
no sort. Bound by bytes: 18P read, width only at the winners of visible
elements, 16P + 16 written.
"""

from __future__ import annotations

import torch

from ..ops.oplog import PAD_ACTION, _next_pow2
from . import _build
from ._args import expect, on_cuda, ptr, stream

_P, _I = _build.P_, _build.I_
_SIG = [_P] * 7 + [_I, _I] + [_P] * 7 + [_P]


def table_capacity(P: int) -> int:
    """Slots of the kernel's hash table: the power of two >= 2 max(P, 1),
    so its at most P groups fill at most half of it."""
    return _next_pow2(2 * max(P, 1))


def sort_winners_plain(action, insert, elem_ref, obj_dense, prop, width, visible):
    """Plain PyTorch version, the reference's algorithm: rows stably
    sorted by (obj, kind, key), segment max / sum of the visible sorted
    positions, scattered back. Returns (winner, conflicts, obj_vis_len,
    obj_text_width)."""
    P = action.shape[0]
    dev = action.device
    rows = torch.arange(P, dtype=torch.int32, device=dev)
    valid = action != PAD_ACTION
    is_map = prop >= 0
    run_key = torch.where(insert, rows, elem_ref)
    g_obj = torch.where(valid, obj_dense, P)
    g_kind = is_map.to(torch.int32)
    g_key = torch.where(is_map, prop, run_key)
    # stable lexsort, least significant key first
    sort_idx = torch.arange(P, dtype=torch.int64, device=dev)
    for k in (g_key, g_kind, g_obj):
        sort_idx = sort_idx[torch.sort(k[sort_idx], stable=True).indices]
    keys = torch.stack([g_obj, g_kind, g_key])[:, sort_idx]
    newseg = torch.ones(P, dtype=torch.bool, device=dev)
    newseg[1:] = (keys[:, 1:] != keys[:, :-1]).any(dim=0)
    seg = (torch.cumsum(newseg.to(torch.int32), 0) - 1).long()
    vis_s = visible[sort_idx]
    cand = torch.where(vis_s, rows, -1)
    win_pos = torch.full((P,), -1, dtype=torch.int32, device=dev)
    win_pos.scatter_reduce_(0, seg, cand, "amax", include_self=True)
    seg_vis = torch.zeros(P, dtype=torch.int32, device=dev)
    seg_vis.index_add_(0, seg, vis_s.to(torch.int32))
    win_row = torch.where(
        win_pos >= 0,
        sort_idx[win_pos.long().clamp(0, max(P - 1, 0))].to(torch.int32),
        -1,
    )
    seg_of_row = torch.empty(P, dtype=torch.int64, device=dev)
    seg_of_row[sort_idx] = seg
    winner = win_row[seg_of_row]
    conflicts = seg_vis[seg_of_row]
    elem_vis = insert & valid & (winner >= 0)
    obj_idx = torch.where(valid, obj_dense, P + 1).long()
    keep = (obj_idx >= 0) & (obj_idx < P + 2)
    w_width = torch.where(elem_vis, width[winner.long().clamp(0, max(P - 1, 0))], 0)
    obj_vis_len = torch.zeros(P + 2, dtype=torch.int32, device=dev)
    obj_vis_len.index_add_(0, obj_idx[keep], elem_vis[keep].to(torch.int32))
    obj_text_width = torch.zeros(P + 2, dtype=torch.int32, device=dev)
    obj_text_width.index_add_(0, obj_idx[keep], w_width[keep])
    return winner, conflicts, obj_vis_len, obj_text_width


def sort_winners(action, insert, elem_ref, obj_dense, prop, width, visible):
    """(winner, conflicts, obj_vis_len, obj_text_width) for int32/bool [P]
    columns. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    P = action.shape[0] if isinstance(action, torch.Tensor) else -1
    for name, t, dt in (
        ("action", action, torch.int32), ("insert", insert, torch.bool),
        ("elem_ref", elem_ref, torch.int32), ("obj_dense", obj_dense, torch.int32),
        ("prop", prop, torch.int32), ("width", width, torch.int32),
        ("visible", visible, torch.bool),
    ):
        expect(t, name, dt, (P,))
    if not on_cuda(action=action, insert=insert, elem_ref=elem_ref,
                   obj_dense=obj_dense, prop=prop, width=width, visible=visible):
        return sort_winners_plain(action, insert, elem_ref, obj_dense, prop,
                                  width, visible)
    if P >= 1 << 29:
        raise ValueError(f"sort_winners: {P} rows exceed the int32 key range")
    dev = action.device
    C = table_capacity(P)
    keys = torch.empty(C, dtype=torch.int64, device=dev)
    slots = torch.empty(2, C, dtype=torch.int32, device=dev)
    slot = torch.empty(P, dtype=torch.int32, device=dev)
    out = torch.empty(2, P, dtype=torch.int32, device=dev)
    stats = torch.empty(2, P + 2, dtype=torch.int32, device=dev)
    sort_winners.launches += _build.launch(
        "amt_sort_winners", _SIG, ptr(action), ptr(insert), ptr(elem_ref),
        ptr(obj_dense), ptr(prop), ptr(width), ptr(visible), P, C, ptr(keys),
        ptr(slots[0]), ptr(slots[1]), ptr(slot), ptr(out[0]), ptr(out[1]),
        ptr(stats), stream(action))
    return out[0], out[1], stats[0], stats[1]


sort_winners.launches = 0
