"""succ_vis: pred-edge successor counting and the visibility mask.

Replaces ``automerge_tpu/ops/merge.py`` ``succ_resolution`` (:59) and
``visibility`` (:91); the CUDA kernel is ``csrc/succ_vis.cu``: two
launches, a row pass (four rows a thread: the counts zeroed and the mask
as if no edge counted) then an edge pass (one thread per pred edge: int32
atomics into the counts and a store of false into the mask where the
edge hides its target). Bound by bytes: 8Q + 9P read, value_i32 only at
the sources of increment edges, 13P written. ``succ_vis_model`` is that
design pass by pass in plain PyTorch, for the tests.

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
_SIG = [_P] * 6 + [_I, _I] + [_P, _P]
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


def succ_vis_model(action, value_tag, value_i32, covered, pred_src, pred_tgt,
                   order: str = "ascending", seed: int = 0):
    """The CUDA design pass by pass in plain PyTorch, for the tests:
    (succ_count, inc_count, counter_inc, visible) as ``succ_vis_plain``.

    The row pass zeroes the counts and sets visible = valid & covered &
    not a delete/increment/mark. Then the edges one at a time in
    ``order`` ("ascending", "reversed", or "shuffled" by ``seed``), each
    as its thread does it: dropped unless 0 <= tgt < P and covered[src]
    (src clamped); a non-increment source adds 1 to succ[tgt] and stores
    False into visible[tgt]; an increment source adds 1 to inc[tgt] and
    value_i32[src] to counter_inc[tgt] (int32 wraparound), and stores
    False unless tgt is a counter put."""
    P, Q = action.shape[0], pred_src.shape[0]
    never = (
        (action == Action.DELETE) | (action == Action.INCREMENT) | (action == Action.MARK)
    )
    vis = ((action != PAD_ACTION) & covered & ~never).tolist()
    succ, inc, cinc = [0] * P, [0] * P, [0] * P
    act, tag, val, cov = (action.tolist(), value_tag.tolist(), value_i32.tolist(),
                          covered.tolist())
    srcs, tgts = pred_src.tolist(), pred_tgt.tolist()
    if order == "ascending":
        edges = range(Q)
    elif order == "reversed":
        edges = range(Q - 1, -1, -1)
    elif order == "shuffled":
        edges = torch.randperm(Q, generator=torch.Generator().manual_seed(seed)).tolist()
    else:
        raise ValueError(f"unknown edge order {order!r}")
    for e in edges:
        tgt, src = tgts[e], min(max(srcs[e], 0), P - 1)
        if not (0 <= tgt < P and cov[src]):
            continue
        if act[src] == Action.INCREMENT:
            inc[tgt] += 1
            cinc[tgt] = (cinc[tgt] + val[src] + (1 << 31)) % (1 << 32) - (1 << 31)
            if not (act[tgt] == Action.PUT and tag[tgt] == TAG_COUNTER):
                vis[tgt] = False
        else:
            succ[tgt] += 1
            vis[tgt] = False

    def ints(v):
        return torch.tensor(v, dtype=torch.int32).reshape(P)

    return ints(succ), ints(inc), ints(cinc), torch.tensor(vis, dtype=torch.bool).reshape(P)


def _stride(P: int) -> int:
    """The kernel's row stride: P rounded up to a multiple of 4, so that
    each row of its output starts 16-byte aligned."""
    return (P + 3) & ~3


def _check(action, value_tag, value_i32, covered, pred_src, pred_tgt) -> bool:
    """True for valid CUDA arguments on one card, False for valid CPU
    ones; raises for any other."""
    P = action.shape[0] if isinstance(action, torch.Tensor) else -1
    Q = pred_src.shape[0] if isinstance(pred_src, torch.Tensor) else -1
    expect(action, "action", torch.int32, (P,))
    expect(value_tag, "value_tag", torch.int32, (P,))
    expect(value_i32, "value_i32", torch.int32, (P,))
    expect(covered, "covered", torch.bool, (P,))
    expect(pred_src, "pred_src", torch.int32, (Q,))
    expect(pred_tgt, "pred_tgt", torch.int32, (Q,))
    return on_cuda(action=action, value_tag=value_tag, value_i32=value_i32,
                   covered=covered, pred_src=pred_src, pred_tgt=pred_tgt)


def _output(P: int, dev):
    """The one allocation: int32 [3 * stride + stride / 4], the rows succ,
    inc and counter_inc, then visible's bytes."""
    s = _stride(P)
    return torch.empty(3 * s + s // 4, dtype=torch.int32, device=dev)


def _launch(action, value_tag, value_i32, covered, pred_src, pred_tgt, out,
            st) -> int:
    """The row and edge passes on the stream ``st``: their launch count."""
    return _build.launch(
        "amt_succ_vis", _SIG, ptr(action), ptr(value_tag), ptr(value_i32),
        ptr(covered), ptr(pred_src), ptr(pred_tgt), action.shape[0],
        pred_src.shape[0], ptr(out), st)


def _views(out, P: int):
    """(succ_count, inc_count, counter_inc, visible) [P]: views of ``out``."""
    s = _stride(P)
    succ, inc, counter_inc, tail = out.split_with_sizes((s, s, s, s // 4))
    visible = tail.view(torch.bool)
    if s == P:
        return succ, inc, counter_inc, visible
    return succ[:P], inc[:P], counter_inc[:P], visible[:P]


def succ_vis(action, value_tag, value_i32, covered, pred_src, pred_tgt):
    """(succ_count, inc_count, counter_inc, visible) for int32 [P]
    action/value_tag/value_i32, bool [P] covered and int32 [Q] pred
    edges. CPU tensors take the plain version; CUDA tensors launch the
    kernel, and the four results are views of one allocation."""
    if not _check(action, value_tag, value_i32, covered, pred_src, pred_tgt):
        return succ_vis_plain(action, value_tag, value_i32, covered,
                              pred_src, pred_tgt)
    P = action.shape[0]
    out = _output(P, action.device)
    succ_vis.launches += _launch(action, value_tag, value_i32, covered, pred_src,
                                 pred_tgt, out, stream(action))
    return _views(out, P)


succ_vis.launches = 0


def succ_partial(action, value_i32, covered, pred_src, pred_tgt):
    """int32 [3, P] (succ, inc, counter_inc) counted from the pred edges
    ``pred_src``/``pred_tgt`` (int32 [Q]: one shard's slice) over the
    rows' int32 [P] action/value_i32 and bool [P] covered. CPU tensors
    take the plain version; CUDA tensors launch the kernel (the edge pass
    without the mask, after one memset)."""
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
