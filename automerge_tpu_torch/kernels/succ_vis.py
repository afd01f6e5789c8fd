"""succ_vis: pred-edge successor counting and the visibility mask.

Replaces ``automerge_tpu/ops/merge.py`` ``succ_resolution`` (:59) and
``visibility`` (:91); the CUDA kernel is ``csrc/succ_vis.cu`` (one thread
per pred edge, int32 atomics into a [3, P] accumulator, then one pass per
row for the mask). Bound by bytes: 8Q + 9P read, value_i32 only at the
sources of increment edges, 13P written.

The sharded merge (``parallel/sharding.py``) runs the two halves apart:
``succ_partial`` counts one shard's slice of the edges, the collectives
sum the shards' accumulators, and ``visibility`` applies the rule.
"""

from __future__ import annotations

import torch

from ..ops.oplog import PAD_ACTION, TAG_COUNTER
from ..types import Action
from . import _build
from ._args import expect, on_cuda, ptr, stream

_P, _I = _build.P_, _build.I_
_SIG = [_P] * 6 + [_I, _I] + [_P, _P, _P]
_PARTIAL_SIG = [_P] * 5 + [_I, _I] + [_P, _P]
_VIS_SIG = [_P] * 5 + [_I] + [_P, _P]


def visibility_plain(action, value_tag, covered, succ_count, inc_count):
    """The visibility rule (types.rs:712-744): valid, covered, not a
    delete/increment/mark, and no successor — counter puts survive
    increment successors."""
    valid = action != PAD_ACTION
    never = (
        (action == Action.DELETE) | (action == Action.INCREMENT) | (action == Action.MARK)
    )
    is_counter = (action == Action.PUT) & (value_tag == TAG_COUNTER)
    return (
        valid
        & covered
        & ~never
        & torch.where(is_counter, succ_count == 0, (succ_count + inc_count) == 0)
    )


def succ_partial_plain(action, value_i32, covered, pred_src, pred_tgt):
    """Plain PyTorch version of the counting half: int32 [3, P] (succ,
    inc, counter_inc).

    A pred edge src->tgt counts when tgt >= 0 and ``covered[src]``: as a
    successor of tgt, or, when src is an increment, as an increment
    carrying ``value_i32[src]`` (int32 wraparound)."""
    P = action.shape[0]
    acc = torch.zeros(3, P, dtype=torch.int32, device=action.device)
    if P and pred_src.shape[0]:
        src = pred_src.long().clamp(0, P - 1)  # gathers clamp, as in XLA
        tgt = pred_tgt.long()
        hit = (tgt >= 0) & (tgt < P) & covered[src]  # OOB scatters drop
        is_inc = action[src] == Action.INCREMENT
        s = hit & ~is_inc
        i = hit & is_inc
        acc[0].index_add_(0, tgt[s], torch.ones_like(tgt[s], dtype=torch.int32))
        acc[1].index_add_(0, tgt[i], torch.ones_like(tgt[i], dtype=torch.int32))
        acc[2].index_add_(0, tgt[i], value_i32[src[i]])
    return acc


def succ_vis_plain(action, value_tag, value_i32, covered, pred_src, pred_tgt):
    """Plain PyTorch version: (succ_count, inc_count, counter_inc, visible)."""
    acc = succ_partial_plain(action, value_i32, covered, pred_src, pred_tgt)
    visible = visibility_plain(action, value_tag, covered, acc[0], acc[1])
    return acc[0], acc[1], acc[2], visible


def succ_vis(action, value_tag, value_i32, covered, pred_src, pred_tgt):
    """(succ_count, inc_count, counter_inc, visible) for int32 [P]
    action/value_tag/value_i32, bool [P] covered and int32 [Q] pred
    edges. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    P = action.shape[0] if isinstance(action, torch.Tensor) else -1
    Q = pred_src.shape[0] if isinstance(pred_src, torch.Tensor) else -1
    expect(action, "action", torch.int32, (P,))
    expect(value_tag, "value_tag", torch.int32, (P,))
    expect(value_i32, "value_i32", torch.int32, (P,))
    expect(covered, "covered", torch.bool, (P,))
    expect(pred_src, "pred_src", torch.int32, (Q,))
    expect(pred_tgt, "pred_tgt", torch.int32, (Q,))
    if not on_cuda(action=action, value_tag=value_tag, value_i32=value_i32,
                   covered=covered, pred_src=pred_src, pred_tgt=pred_tgt):
        return succ_vis_plain(action, value_tag, value_i32, covered,
                              pred_src, pred_tgt)
    acc = torch.empty(3, P, dtype=torch.int32, device=action.device)
    visible = torch.empty(P, dtype=torch.bool, device=action.device)
    succ_vis.launches += _build.launch(
        "amt_succ_vis", _SIG, ptr(action), ptr(value_tag), ptr(value_i32),
        ptr(covered), ptr(pred_src), ptr(pred_tgt), P, Q, ptr(acc),
        ptr(visible), stream(action))
    return acc[0], acc[1], acc[2], visible


succ_vis.launches = 0


def succ_partial(action, value_i32, covered, pred_src, pred_tgt):
    """int32 [3, P] (succ, inc, counter_inc) counted from the pred edges
    ``pred_src``/``pred_tgt`` (int32 [Q]: one shard's slice) over the
    rows' int32 [P] action/value_i32 and bool [P] covered. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    P = action.shape[0] if isinstance(action, torch.Tensor) else -1
    Q = pred_src.shape[0] if isinstance(pred_src, torch.Tensor) else -1
    expect(action, "action", torch.int32, (P,))
    expect(value_i32, "value_i32", torch.int32, (P,))
    expect(covered, "covered", torch.bool, (P,))
    expect(pred_src, "pred_src", torch.int32, (Q,))
    expect(pred_tgt, "pred_tgt", torch.int32, (Q,))
    if not on_cuda(action=action, value_i32=value_i32, covered=covered,
                   pred_src=pred_src, pred_tgt=pred_tgt):
        return succ_partial_plain(action, value_i32, covered, pred_src, pred_tgt)
    acc = torch.empty(3, P, dtype=torch.int32, device=action.device)
    succ_partial.launches += _build.launch(
        "amt_succ_partial", _PARTIAL_SIG, ptr(action), ptr(value_i32),
        ptr(covered), ptr(pred_src), ptr(pred_tgt), P, Q, ptr(acc),
        stream(action))
    return acc


succ_partial.launches = 0


def visibility(action, value_tag, covered, succ_count, inc_count):
    """bool [P]: the visibility rule over int32 [P] action/value_tag/
    succ_count/inc_count and bool [P] covered. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    P = action.shape[0] if isinstance(action, torch.Tensor) else -1
    expect(action, "action", torch.int32, (P,))
    expect(value_tag, "value_tag", torch.int32, (P,))
    expect(covered, "covered", torch.bool, (P,))
    expect(succ_count, "succ_count", torch.int32, (P,))
    expect(inc_count, "inc_count", torch.int32, (P,))
    if not on_cuda(action=action, value_tag=value_tag, covered=covered,
                   succ_count=succ_count, inc_count=inc_count):
        return visibility_plain(action, value_tag, covered, succ_count, inc_count)
    visible = torch.empty(P, dtype=torch.bool, device=action.device)
    visibility.launches += _build.launch(
        "amt_visibility", _VIS_SIG, ptr(action), ptr(value_tag), ptr(covered),
        ptr(succ_count), ptr(inc_count), P, ptr(visible), stream(action))
    return visible


visibility.launches = 0
