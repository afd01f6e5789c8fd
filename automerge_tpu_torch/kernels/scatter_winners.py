"""scatter_winners: per-key winners, conflict counts and per-object stats.

Replaces ``automerge_tpu/ops/merge.py`` ``resolve_state_scatter``
(:595-648) without its forest call; the CUDA kernel is
``csrc/scatter_winners.cu`` (atomicMax/atomicAdd of visible rows into a
dense group table, then a gather pass that also atomically accumulates
the per-object stats). Bound by bytes: 18P read, width only at the
winners of visible elements, 16P + 16 written.

The sharded merge (``parallel/sharding.py``) runs the two passes apart
over a shard's rows [r0, r0 + count): ``winners_partial`` fills the
shard's win/cnt tables, the collectives max and sum them across shards,
and ``winners_gather`` reads them back for the shard's rows.
"""

from __future__ import annotations

import torch

from ..ops.oplog import ELEM_HEAD, PAD_ACTION
from . import _build
from ._args import expect, on_cuda, ptr, stream

_P, _I = _build.P_, _build.I_
_SIG = [_P] * 7 + [_I, _I, _I, _I] + [_P] * 5 + [_P]
_PARTIAL_SIG = [_P] * 6 + [_I] * 6 + [_P] * 3
_GATHER_SIG = [_P] * 6 + [_I] * 6 + [_P] * 6


def group_count(P: int, n_objs2: int, n_props: int) -> int:
    """G: P run heads, 2 sentinels per object, the obj x prop table and
    one slot for padding rows."""
    return P + 2 * n_objs2 + n_objs2 * n_props + 1


def group_ids(action, insert, elem_ref, obj_dense, prop, n_objs2: int, n_props: int):
    """Dense group id per row (int32 arithmetic, as in the reference)."""
    P = action.shape[0]
    G = group_count(P, n_objs2, n_props)
    rows = torch.arange(P, dtype=torch.int32, device=action.device)
    run = torch.where(insert, rows, elem_ref)
    seq_gid = torch.where(
        run >= 0,
        run,
        P + obj_dense * 2 + (elem_ref != ELEM_HEAD).to(torch.int32),
    )
    map_gid = P + 2 * n_objs2 + obj_dense * n_props + prop
    gid = torch.where(prop >= 0, map_gid, seq_gid)
    return torch.where(action != PAD_ACTION, gid, torch.full_like(gid, G - 1))


def _scatter_add(n: int, idx, vals):
    """int32 [n] zeros with ``vals`` added at ``idx``; out-of-range
    indices are dropped, as XLA drops them."""
    out = torch.zeros(n, dtype=torch.int32, device=idx.device)
    keep = (idx >= 0) & (idx < n)
    return out.index_add_(0, idx[keep].long(), vals[keep].to(torch.int32))


def scatter_winners_plain(action, insert, elem_ref, obj_dense, prop, width,
                          visible, n_objs2: int, n_props: int):
    """Plain PyTorch version: (winner, conflicts, obj_vis_len,
    obj_text_width), the two passes over all P rows."""
    P = action.shape[0]
    win, cnt = winners_partial_plain(action, insert, elem_ref, obj_dense, prop,
                                     visible, 0, P, n_objs2, n_props)
    winner, conflicts, stats = winners_gather_plain(
        action, insert, elem_ref, obj_dense, prop, width, win, cnt, 0, P, n_objs2,
        n_props)
    return winner, conflicts, stats[0], stats[1]


def scatter_winners(action, insert, elem_ref, obj_dense, prop, width, visible,
                    n_objs2: int, n_props: int):
    """(winner, conflicts, obj_vis_len, obj_text_width) for int32/bool [P]
    columns and the group-table geometry (n_objs2, n_props). CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    P = action.shape[0] if isinstance(action, torch.Tensor) else -1
    for name, t, dt in (
        ("action", action, torch.int32), ("insert", insert, torch.bool),
        ("elem_ref", elem_ref, torch.int32), ("obj_dense", obj_dense, torch.int32),
        ("prop", prop, torch.int32), ("width", width, torch.int32),
        ("visible", visible, torch.bool),
    ):
        expect(t, name, dt, (P,))
    G = group_count(P, n_objs2, n_props)
    if G >= 1 << 31:
        raise ValueError(f"group table of {G} slots exceeds int32")
    if not on_cuda(action=action, insert=insert, elem_ref=elem_ref,
                   obj_dense=obj_dense, prop=prop, width=width, visible=visible):
        return scatter_winners_plain(action, insert, elem_ref, obj_dense, prop,
                                     width, visible, n_objs2, n_props)
    dev = action.device
    table = torch.empty(2, G, dtype=torch.int32, device=dev)
    out = torch.empty(2, P, dtype=torch.int32, device=dev)
    stats = torch.empty(2, P + 2, dtype=torch.int32, device=dev)
    scatter_winners.launches += _build.launch(
        "amt_scatter_winners", _SIG, ptr(action), ptr(insert), ptr(elem_ref),
        ptr(obj_dense), ptr(prop), ptr(width), ptr(visible), P, n_objs2,
        n_props, G, ptr(table[0]), ptr(table[1]), ptr(out[0]), ptr(out[1]),
        ptr(stats), stream(action))
    return out[0], out[1], stats[0], stats[1]


scatter_winners.launches = 0


def _rows(P: int, r0: int, count: int) -> None:
    if not (0 <= r0 and 0 <= count and r0 + count <= P):
        raise ValueError(f"rows [{r0}, {r0 + count}) outside [0, {P})")


def winners_partial_plain(action, insert, elem_ref, obj_dense, prop, visible,
                          r0: int, count: int, n_objs2: int, n_props: int):
    """Plain PyTorch version: int32 [2, G], the win (max visible row,
    else -1) and cnt (visible rows) tables of the rows [r0, r0+count)."""
    P = action.shape[0]
    G = group_count(P, n_objs2, n_props)
    rows = torch.arange(P, dtype=torch.int32, device=action.device)[r0:r0 + count]
    gid = group_ids(action, insert, elem_ref, obj_dense, prop, n_objs2,
                    n_props)[r0:r0 + count]
    vis = visible[r0:r0 + count]
    keep = (gid >= 0) & (gid < G)
    table = torch.empty(2, G, dtype=torch.int32, device=action.device)
    table[0] = -1
    table[0].scatter_reduce_(
        0, gid[keep].long(),
        torch.where(vis, rows, torch.full_like(rows, -1))[keep],
        "amax", include_self=True,
    )
    table[1] = _scatter_add(G, gid, vis)
    return table


def winners_gather_plain(action, insert, elem_ref, obj_dense, prop, width,
                         win, cnt, r0: int, count: int, n_objs2: int,
                         n_props: int):
    """Plain PyTorch version: (winner, conflicts) int32 [count] of the
    rows [r0, r0+count) from the merged ``win``/``cnt`` tables, and those
    rows' per-object stats, int32 [2, P+2] (obj_vis_len, obj_text_width)."""
    P = action.shape[0]
    G = win.shape[0]
    sl = slice(r0, r0 + count)
    gid = group_ids(action, insert, elem_ref, obj_dense, prop, n_objs2,
                    n_props)[sl]
    valid = action[sl] != PAD_ACTION
    g = gid.long().clamp(0, G - 1)  # gathers clamp, as in XLA
    zero = torch.zeros_like(gid)
    winner = torch.where(valid, win[g], zero - 1)
    conflicts = torch.where(valid, cnt[g], zero)
    elem_vis = insert[sl] & valid & (winner >= 0)
    obj_idx = torch.where(valid, obj_dense[sl], torch.full_like(gid, P + 1))
    w_width = torch.where(elem_vis, width[winner.long().clamp(0, max(P - 1, 0))],
                          zero)
    stats = torch.stack([_scatter_add(P + 2, obj_idx, elem_vis),
                         _scatter_add(P + 2, obj_idx, w_width)])
    return winner, conflicts, stats


def winners_partial(action, insert, elem_ref, obj_dense, prop, visible,
                    r0: int, count: int, n_objs2: int, n_props: int):
    """int32 [2, G]: the win and cnt tables of the rows [r0, r0+count) of
    the int32/bool [P] columns, over the group table (n_objs2, n_props).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    P = action.shape[0] if isinstance(action, torch.Tensor) else -1
    for name, t, dt in (
        ("action", action, torch.int32), ("insert", insert, torch.bool),
        ("elem_ref", elem_ref, torch.int32), ("obj_dense", obj_dense, torch.int32),
        ("prop", prop, torch.int32), ("visible", visible, torch.bool),
    ):
        expect(t, name, dt, (P,))
    _rows(P, r0, count)
    G = group_count(P, n_objs2, n_props)
    if G >= 1 << 31:
        raise ValueError(f"group table of {G} slots exceeds int32")
    if not on_cuda(action=action, insert=insert, elem_ref=elem_ref,
                   obj_dense=obj_dense, prop=prop, visible=visible):
        return winners_partial_plain(action, insert, elem_ref, obj_dense, prop,
                                     visible, r0, count, n_objs2, n_props)
    table = torch.empty(2, G, dtype=torch.int32, device=action.device)
    winners_partial.launches += _build.launch(
        "amt_winners_partial", _PARTIAL_SIG, ptr(action), ptr(insert),
        ptr(elem_ref), ptr(obj_dense), ptr(prop), ptr(visible), P, r0, count,
        n_objs2, n_props, G, ptr(table[0]), ptr(table[1]), stream(action))
    return table


winners_partial.launches = 0


def winners_gather(action, insert, elem_ref, obj_dense, prop, width, win, cnt,
                   r0: int, count: int, n_objs2: int, n_props: int):
    """(winner, conflicts) int32 [count] of the rows [r0, r0+count) from
    the merged int32 [G] ``win``/``cnt`` tables, and their per-object
    stats int32 [2, P+2]. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    P = action.shape[0] if isinstance(action, torch.Tensor) else -1
    G = group_count(P, n_objs2, n_props)
    for name, t, dt, shape in (
        ("action", action, torch.int32, P), ("insert", insert, torch.bool, P),
        ("elem_ref", elem_ref, torch.int32, P),
        ("obj_dense", obj_dense, torch.int32, P), ("prop", prop, torch.int32, P),
        ("width", width, torch.int32, P), ("win", win, torch.int32, G),
        ("cnt", cnt, torch.int32, G),
    ):
        expect(t, name, dt, (shape,))
    _rows(P, r0, count)
    if not on_cuda(action=action, insert=insert, elem_ref=elem_ref,
                   obj_dense=obj_dense, prop=prop, width=width, win=win, cnt=cnt):
        return winners_gather_plain(action, insert, elem_ref, obj_dense, prop,
                                    width, win, cnt, r0, count, n_objs2, n_props)
    dev = action.device
    out = torch.empty(2, count, dtype=torch.int32, device=dev)
    stats = torch.empty(2, P + 2, dtype=torch.int32, device=dev)
    winners_gather.launches += _build.launch(
        "amt_winners_gather", _GATHER_SIG, ptr(action), ptr(insert),
        ptr(elem_ref), ptr(obj_dense), ptr(prop), ptr(width), P, r0, count,
        n_objs2, n_props, G, ptr(win), ptr(cnt), ptr(out[0]), ptr(out[1]),
        ptr(stats), stream(action))
    return out[0], out[1], stats


winners_gather.launches = 0
