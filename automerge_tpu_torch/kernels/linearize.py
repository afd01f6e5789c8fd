"""linearize: document-order element indices, all on the device.

Replaces ``automerge_tpu/ops/merge.py`` ``device_linearize`` (:216-285).
``linearize_plain`` keeps the reference's algorithm (sibling-climb pointer
doubling, then Wyllie list ranking, ceil_log2(E)+1 rounds each over
E = P+1 nodes) and stays the oracle. The CUDA kernel (``csrc/linearize.cu``
``amt_linearize``) ranks an Euler tour of the element forest instead, in
``LAUNCHES`` launches whatever P: each row's enter and exit slots get
local successors, rulers sampled one in ``ruler_stride(P)`` walk their
sublists, the rulers' own list is walked the same way two levels up, one
block ranks the few thousand rulers left in shared memory, and a last
pass sums the levels. ``linearize_tour_model`` is that design step
by step in numpy, for the tests. Bound by bytes: first_child and
next_sib over the rows [0, P) (8P), is_elem, elem_ref, obj_dense (9P)
and first_child at the object roots read, 4P written.

The sharded merge (``parallel/sharding.py``) drives the reference's loops
round by round: ``linearize_init`` (the threading state over Epad nodes,
padded past the sentinel with fixed points), ``linearize_thread`` and
``linearize_rank`` (one round over a slice of the nodes, reading the
full gathered state) and ``linearize_final``. Its rank loop starts from
the thread loop's answers: ``linearize_rank_first`` is its first round,
reading ``fc_e`` and ``ans`` where the reference builds the ranking state
between the loops (``linearize_rank_init_plain``, kept as the plain
version's first step). Its condensed arm runs the same loops over the
chain tables (the rank loop from ``cond_succ``'s state). Where every
shard of the mesh sits on one device, a loop is one call of
``linearize_thread_rounds`` / ``linearize_rank_from_thread`` (condensed:
``linearize_rank_rounds``): all its rounds over all E nodes in one C
call, ``rounds`` launches, the state carried in records ({ans, jump,
done, 0}, {dist, nxt}) between them. Bound by bytes: a round's load of
the state at the node each jumps to.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _build
from ._args import expect, on_cuda, ptr, stream

_P, _I = _build.P_, _build.I_
_SIG = [_P] * 5 + [_I, _build.U_, _I, _P, _build.LL_, _P, _P]
_INIT_SIG = [_P] * 4 + [_I, _I] + [_P] * 4 + [_P]
_ROUND_SIG = [_P] * 3 + [_I] * 3 + [_P] * 3 + [_P]
_RANK_SIG = [_P] * 2 + [_I] * 3 + [_P] * 2 + [_P]
_RANK_FIRST_SIG = [_P] * 2 + [_I] * 4 + [_P] * 2 + [_P]
_FINAL_SIG = [_P] * 4 + [_I] * 3 + [_P] + [_P]
_THREAD_ROUNDS_SIG = [_P] * 3 + [_I] * 2 + [_P, _build.LL_] + [_P] * 3 + [_P]
_RANK_ROUNDS_SIG = [_P] * 2 + [_I] * 2 + [_P, _build.LL_] + [_P] * 2 + [_P]
_RANK_FROM_THREAD_SIG = [_P] * 2 + [_I] * 3 + [_P, _build.LL_] + [_P] * 2 + [_P]
# the node range of the rounds entries (their C entries refuse more)
MAX_ROUNDS_NODES = 1 << 30


def ceil_log2(n: int) -> int:
    return max(1, int(n - 1).bit_length())


def rounds(P: int) -> int:
    """Doubling rounds of each loop for P rows (E = P+1 nodes)."""
    return ceil_log2(P + 1) + 1


# the Euler-tour kernel's constants (csrc/linearize.cu)
LAUNCHES = 8  # clear, successors, three walks, the block's ranking, two sums
R3_TARGET = 6144  # level-3 rulers aimed at: what one block ranks
R3_CAP = 10240
R4_TARGET = 1024  # the block's own rulers among them
R4_CAP = 2048
SEEDS = (0, 0x5BD1E995, 0x27D4EB2F)  # the hashes of levels 2, 3 and 4
_WEYL = 0x9E3779B9
_U32 = 0xFFFFFFFF


def ruler_stride(P: int) -> int:
    """One level-1 ruler in this many element slots: the three levels'
    strides are equal when the 2P slots shrink to R3_TARGET rulers, so
    cbrt(2P / R3_TARGET); at least 4."""
    return max(4, round((2 * P / R3_TARGET) ** (1 / 3)))


def ruler_threshold(stride: int) -> int:
    """A slot is a level-1 ruler when its Weyl hash is below this."""
    return (1 << 32) // stride


def ruler_capacity(P: int, stride: int) -> int:
    """Level-1 (and level-2) rulers kept: the 2P slots' expected share and
    a margin (the Weyl hash's count deviates by a few); a slot past it is
    no ruler."""
    return min(2 * P, 2 * P // stride + 1024) if P else 1


def _marks(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 4


def scratch_words(P: int, r1cap: int) -> int:
    """int32 words of the kernel's scratch (``lt_scratch_words``)."""
    return (12 * P + 16 * r1cap + -(-r1cap // 4) * 4 + 5 * R3_CAP + 4
            + 2 * _marks(r1cap))


def _mix(h):
    """murmur3's 32-bit finalizer on int64 arrays of 32-bit values."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    return h ^ (h >> 16)


def _pick(slots, seed: int, count: int, num: int, cap: int):
    """Ids (in order, -1 for none, none past ``cap``) of the rulers of the
    next level among ``slots``: hash * count < num."""
    chosen = _mix(slots.astype(np.int64) ^ seed) * count < num
    ids = np.full(len(slots), -1, np.int64)
    ids[chosen] = np.arange(int(chosen.sum()))
    ids[ids >= cap] = -1
    return ids


def _walk(succ, stops, weight, walkers, cap):
    """Every walker steps along ``succ`` (-1 ends) until the next node is
    a stop (its id >= 0 in ``stops``), all in lockstep as the kernel's
    threads do: each node's walker and prefix, the walkers' totals, the
    stop each reached or -1, the longest walk."""
    n = len(succ)
    owner = np.full(n, -1, np.int64)
    pre = np.zeros(n, np.int64)
    cur = walkers.copy()
    acc = np.zeros(len(walkers), np.int64)
    end = np.full(len(walkers), -1, np.int64)
    live = np.ones(len(walkers), bool)
    steps = 0
    while live.any() and steps < cap:
        steps += 1
        c = cur[live]
        owner[c] = walkers[live]
        pre[c] = acc[live]
        acc[live] += weight[c]
        nx = succ[c]
        idx = np.flatnonzero(live)
        ends = nx < 0
        stop = ~ends & (stops[np.maximum(nx, 0)] >= 0)
        end[idx[stop]] = stops[nx[stop]]
        live[idx[ends | stop]] = False
        go = ~ends & ~stop
        cur[idx[go]] = nx[go]
    return owner, pre, acc, end, steps


class _Level:
    """One level's walk over its nodes (successor, weight, ruler id, slot):
    the nodes' walker and prefix, the walkers' total and the ruler each
    reached, indexed by node; and the rulers' own list for the level
    above. The walkers are the rulers and the list heads: ``heads``, or
    the nodes no successor names."""

    def __init__(self, succ, weight, rid, slot, heads=None):
        n = len(succ)
        if heads is None:
            heads = np.ones(n, bool)
            heads[succ[succ >= 0]] = False
        walkers = np.flatnonzero((rid >= 0) | heads)
        self.own, self.pre, tot, end, self.steps = _walk(succ, rid, weight,
                                                         walkers, n)
        self.tot = np.zeros(n, np.int64)
        self.end = np.full(n, -1, np.int64)
        self.tot[walkers], self.end[walkers] = tot, end
        rulers = np.flatnonzero(rid >= 0)[np.argsort(rid[rid >= 0])]
        self.up = (self.end[rulers], self.tot[rulers], slot[rulers])

    def dist(self, nodes, above):
        """The weight from each node to its list's end, given that of the
        rulers (``above``, a function of ruler ids)."""
        o = self.own[nodes]
        out = self.tot[o] - self.pre[nodes]
        e = self.end[o]
        has = e >= 0
        out[has] += above(e[has])
        return out


def linearize_tour_model(first_child, next_sib, is_elem, elem_ref, obj_dense,
                         stride=None, r3_target=R3_TARGET, r4_target=R4_TARGET):
    """The CUDA kernel's design step by step in numpy, for the tests:
    (elem_index int32 [P], info). Rulers are numbered in slot order where
    the kernel's atomics number them in any order (the result does not
    depend on it). ``stride`` and the targets default to the kernel's;
    smaller ones make small inputs walk at every level. ``info`` has the
    ruler counts and the longest walk of each level."""
    P = int(is_elem.shape[0])
    N = 2 * P + 3
    fc = np.asarray(first_child[:P], np.int64)
    ns = np.asarray(next_sib[:P], np.int64)
    ie = np.asarray(is_elem, bool)
    er = np.asarray(elem_ref, np.int64)
    od = np.asarray(obj_dense, np.int64)
    stride = ruler_stride(P) if stride is None else stride
    r1cap = ruler_capacity(P, stride)
    v = np.arange(P)
    fc_all = np.asarray(first_child, np.int64)
    # the tour's successors over the element rows: enter 2v, exit 2v+1, -1
    # ends the list; the rows that are no elements have no part
    se = np.where((fc >= 0) & (fc < P), 2 * fc,
                  np.where((fc == -1) | (fc > P), 2 * v + 1, -1))
    elem_parent = (er >= 0) & (er < P) & ie[np.clip(er, 0, max(P - 1, 0))]
    sx = np.where(ns != -1, np.where((ns >= 0) & (ns < P), 2 * ns, -1),
                  np.where(elem_parent, 2 * er + 1, -1))
    succ = np.where(ie[:, None], np.stack([se, sx], 1), -1).reshape(-1)
    # the heads, off the forest's layout: an element whose parent is no
    # element row and that is its parent's first child (or has no slot
    # there)
    parent = np.where(er == -1, P + od, np.where(er >= 0, er, N - 1))
    first = fc_all[np.clip(parent, 0, N - 1)] == v
    head_e = ie & ~elem_parent & ((parent < 0) | (parent >= N) | first)
    heads = np.stack([head_e, np.zeros(P, bool)], 1).reshape(-1)
    slots = np.arange(2 * P)
    # level 1: element slots under the Weyl threshold
    r1 = ie[slots // 2] & (((slots * _WEYL) & _U32) < ruler_threshold(stride))
    rid = np.full(2 * P, -1, np.int64)
    rid[r1] = np.arange(int(r1.sum()))
    rid[rid >= r1cap] = -1
    lv1 = _Level(succ, (slots % 2 == 0).astype(np.int64), rid, slots, heads)
    # levels 2 and 3: one in sqrt(R1 / r3_target) of the rulers below each
    nxt, w, slot = lv1.up
    R1 = len(nxt)
    num = int(math.sqrt(r3_target * R1) * 4294967296.0)
    lv2 = _Level(nxt, w, _pick(slot, SEEDS[0], R1, num, r1cap), slot)
    nxt, w, slot = lv2.up
    lv3 = _Level(nxt, w, _pick(slot, SEEDS[1], R1, num, R3_CAP), slot)
    # the block: a walk over the level-3 rulers, then doubling over its own
    nxt, w, slot = lv3.up
    rid = _pick(slot, SEEDS[2], len(nxt), r4_target << 32, R4_CAP)
    lv4 = _Level(nxt, w, rid, slot)
    n4, d4 = lv4.up[0], lv4.up[1]
    for _ in range(int(R4_CAP).bit_length()):
        on = n4 >= 0
        if not on.any():
            break
        j = np.maximum(n4, 0)
        d4, n4 = np.where(on, d4 + d4[j], d4), np.where(on, n4[j], -1)

    def dist(s):
        return lv1.dist(s, lambda e1: lv2.dist(e1, lambda e2: lv3.dist(
            e2, lambda e3: lv4.dist(e3, lambda e4: d4[e4]))))

    start = fc_all[np.clip(P + od, 0, N - 1)]
    out = np.full(P, -1, np.int64)
    rows = np.flatnonzero(ie & (start >= 0))
    out[rows] = dist(2 * np.clip(start[rows], 0, P - 1)) - dist(2 * rows)
    info = {"stride": stride,
            "rulers": [len(lv.up[0]) for lv in (lv1, lv2, lv3, lv4)],
            "walks": [lv.steps for lv in (lv1, lv2, lv3, lv4)]}
    return torch.from_numpy(out.astype(np.int32)), info


def linearize_init_plain(first_child, next_sib, is_elem, elem_ref, Epad: int):
    """Plain PyTorch version of the threading state over Epad >= P + 1
    nodes: (ans, done, jump, fc_e). A(i) starts as i's next sibling;
    object roots (parent = the sentinel P) and nodes with a sibling are
    done; the nodes past the sentinel are fixed points (done, jump P)."""
    P = is_elem.shape[0]
    SE = P
    dev = is_elem.device
    pad = torch.full((Epad - P,), -1, dtype=torch.int32, device=dev)
    next_sib_e = torch.cat([next_sib[:P], pad])
    fc_e = torch.cat([first_child[:P].clamp(max=SE + 1), pad])
    fc_e = torch.where(fc_e > SE, -1, fc_e)  # child refs are always < P
    parent_e = torch.cat([
        torch.where(is_elem & (elem_ref >= 0), elem_ref, SE),
        torch.full((Epad - P,), SE, dtype=torch.int32, device=dev),
    ])
    is_elem_e = torch.cat([is_elem, torch.zeros(Epad - P, dtype=torch.bool, device=dev)])
    has_sib = next_sib_e != -1
    done = has_sib | ~is_elem_e | (parent_e == SE)
    ans = torch.where(has_sib & is_elem_e, next_sib_e, -1)
    return ans, done, parent_e, fc_e


def linearize_thread_plain(ans, done, jump, i0: int, count: int):
    """Plain PyTorch version of one threading round over the nodes
    [i0, i0+count): (ans, done, jump) of those nodes."""
    E = ans.shape[0]
    sl = slice(i0, i0 + count)
    j = jump[sl].long().clamp(0, E - 1)
    take = ~done[sl] & done[j]
    return torch.where(take, ans[j], ans[sl]), done[sl] | take, jump[j]


def linearize_rank_init_plain(fc_e, ans, P: int):
    """Plain PyTorch version of the ranking state over Epad nodes: (dist,
    nxt). The preorder successor is the first child, else A(i); the
    sentinel P and the padding past it end the list with distance 0."""
    Epad = ans.shape[0]
    node = torch.arange(Epad, dtype=torch.int32, device=ans.device)
    succ = torch.where(fc_e != -1, fc_e, ans)
    nxt = torch.where((succ < 0) | (node >= P), P, succ).to(torch.int32)
    return (node < P).to(torch.int32), nxt


def linearize_rank_plain(dist, nxt, i0: int, count: int):
    """Plain PyTorch version of one Wyllie round over the nodes
    [i0, i0+count): (dist, nxt) of those nodes."""
    E = dist.shape[0]
    sl = slice(i0, i0 + count)
    j = nxt[sl].long().clamp(0, E - 1)
    return dist[sl] + dist[j], nxt[j]


def linearize_rank_first_plain(fc_e, ans, P: int, i0: int, count: int):
    """Plain PyTorch version of the rank loop's first round over the nodes
    [i0, i0+count), from the thread loop's answers: the ranking state
    built, then one Wyllie round."""
    return linearize_rank_plain(*linearize_rank_init_plain(fc_e, ans, P), i0, count)


def linearize_final_plain(first_child, is_elem, obj_dense, dist, r0: int,
                          count: int):
    """Plain PyTorch version of elem_index for the rows [r0, r0+count):
    the distance from the row's object start minus the row's own."""
    P = is_elem.shape[0]
    N = first_child.shape[0]
    sl = slice(r0, r0 + count)
    # chain start per row: its object root's first child
    start = first_child[(P + obj_dense[sl]).long().clamp(0, N - 1)]
    d_start = dist[start.long().clamp(0, max(P - 1, 0))]
    return torch.where(is_elem[sl] & (start >= 0), d_start - dist[sl], -1)


def linearize_plain(first_child, next_sib, is_elem, elem_ref, obj_dense):
    """Plain PyTorch version: elem_index int32 [P] (-1 for non-elements).

    A(i): next sibling of i, else of its nearest ancestor, by pointer
    doubling over the parent chain (object roots end the climb); then
    Wyllie ranking of the preorder successor chain (first child, else
    A(i)) gives each node's distance to the chain end."""
    P = is_elem.shape[0]
    E = P + 1
    ans, done, jump, fc_e = linearize_init_plain(first_child, next_sib, is_elem,
                                                 elem_ref, E)
    for _ in range(rounds(P)):
        ans, done, jump = linearize_thread_plain(ans, done, jump, 0, E)
    dist, nxt = linearize_rank_init_plain(fc_e, ans, P)
    for _ in range(rounds(P)):
        dist, nxt = linearize_rank_plain(dist, nxt, 0, E)
    return linearize_final_plain(first_child, is_elem, obj_dense, dist, 0, P)


def linearize(first_child, next_sib, is_elem, elem_ref, obj_dense):
    """elem_index int32 [P] from the forest (first_child/next_sib int32
    [2P+3], is_elem bool [P]) and the elem_ref/obj_dense columns. CPU
    tensors take the plain version; CUDA tensors launch the kernels."""
    P = is_elem.shape[0] if isinstance(is_elem, torch.Tensor) else -1
    N = 2 * P + 3
    expect(first_child, "first_child", torch.int32, (N,))
    expect(next_sib, "next_sib", torch.int32, (N,))
    expect(is_elem, "is_elem", torch.bool, (P,))
    expect(elem_ref, "elem_ref", torch.int32, (P,))
    expect(obj_dense, "obj_dense", torch.int32, (P,))
    if not on_cuda(first_child=first_child, next_sib=next_sib, is_elem=is_elem,
                   elem_ref=elem_ref, obj_dense=obj_dense):
        return linearize_plain(first_child, next_sib, is_elem, elem_ref, obj_dense)
    if P >= 1 << 29:
        raise ValueError(f"linearize: {P} rows exceed the int32 node range")
    dev = is_elem.device
    stride = ruler_stride(P)
    r1cap = ruler_capacity(P, stride)
    words = scratch_words(P, r1cap)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    elem_index = torch.empty(P, dtype=torch.int32, device=dev)
    linearize.launches += _build.launch(
        "amt_linearize", _SIG, ptr(first_child), ptr(next_sib), ptr(is_elem),
        ptr(elem_ref), ptr(obj_dense), P, ruler_threshold(stride), r1cap,
        ptr(scratch), words, ptr(elem_index), stream(is_elem))
    return elem_index


linearize.launches = 0


def _check_range(E: int, i0: int, count: int) -> None:
    if not (0 <= i0 and 0 <= count and i0 + count <= E):
        raise ValueError(f"nodes [{i0}, {i0 + count}) outside [0, {E})")


def linearize_init(first_child, next_sib, is_elem, elem_ref, Epad: int):
    """(ans int32, done bool, jump int32, fc_e int32), each [Epad]: the
    threading state of the P rows, the sentinel P and padding nodes up
    to Epad. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    P = is_elem.shape[0] if isinstance(is_elem, torch.Tensor) else -1
    N = 2 * P + 3
    expect(first_child, "first_child", torch.int32, (N,))
    expect(next_sib, "next_sib", torch.int32, (N,))
    expect(is_elem, "is_elem", torch.bool, (P,))
    expect(elem_ref, "elem_ref", torch.int32, (P,))
    if Epad < P + 1:
        raise ValueError(f"Epad {Epad} < P + 1 = {P + 1}")
    if not on_cuda(first_child=first_child, next_sib=next_sib, is_elem=is_elem,
                   elem_ref=elem_ref):
        return linearize_init_plain(first_child, next_sib, is_elem, elem_ref, Epad)
    dev = is_elem.device
    state = torch.empty(3, Epad, dtype=torch.int32, device=dev)
    done = torch.empty(Epad, dtype=torch.bool, device=dev)
    linearize_init.launches += _build.launch(
        "amt_linearize_init", _INIT_SIG, ptr(first_child), ptr(next_sib),
        ptr(is_elem), ptr(elem_ref), P, Epad, ptr(state[0]), ptr(done),
        ptr(state[1]), ptr(state[2]), stream(is_elem))
    return state[0], done, state[1], state[2]


linearize_init.launches = 0


def _check_out(out, like, count: int, names) -> None:
    """``out``: one contiguous tensor of [count] per state array, of its
    type and on its device."""
    if len(out) != len(like):
        raise ValueError(f"out: expected {len(like)} tensors, got {len(out)}")
    for o, t, name in zip(out, like, names):
        expect(o, f"out {name}", t.dtype, (count,))
        if o.device != t.device:
            raise ValueError(f"out {name}: on {o.device}, the state on {t.device}")


def _plain_into(out, got):
    for o, g in zip(out, got):
        o.copy_(g)
    return tuple(out)


def linearize_thread(ans, done, jump, i0: int, count: int, out=None):
    """One threading round over the nodes [i0, i0+count) of the E-node
    state (ans/jump int32 [E], done bool [E]): (ans, done, jump) of those
    nodes, [count] each, written into ``out`` when it is given (three
    tensors of [count], e.g. views of a next-round buffer at i0). CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    E = ans.shape[0] if isinstance(ans, torch.Tensor) else -1
    expect(ans, "ans", torch.int32, (E,))
    expect(done, "done", torch.bool, (E,))
    expect(jump, "jump", torch.int32, (E,))
    _check_range(E, i0, count)
    if out is not None:
        _check_out(out, (ans, done, jump), count, ("ans", "done", "jump"))
    if not on_cuda(ans=ans, done=done, jump=jump):
        got = linearize_thread_plain(ans, done, jump, i0, count)
        return got if out is None else _plain_into(out, got)
    if out is None:
        ints = torch.empty(2, count, dtype=torch.int32, device=ans.device)
        out = (ints[0], torch.empty(count, dtype=torch.bool, device=ans.device),
               ints[1])
    linearize_thread.launches += _build.launch(
        "amt_linearize_thread", _ROUND_SIG, ptr(ans), ptr(done), ptr(jump), E,
        i0, count, ptr(out[0]), ptr(out[1]), ptr(out[2]), stream(ans))
    return tuple(out)


linearize_thread.launches = 0


def linearize_rank(dist, nxt, i0: int, count: int, out=None):
    """One Wyllie round over the nodes [i0, i0+count) of the E-node state
    (dist/nxt int32 [E]): (dist, nxt) of those nodes, [count] each,
    written into ``out`` when it is given (two tensors of [count]). CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    E = dist.shape[0] if isinstance(dist, torch.Tensor) else -1
    expect(dist, "dist", torch.int32, (E,))
    expect(nxt, "nxt", torch.int32, (E,))
    _check_range(E, i0, count)
    if out is not None:
        _check_out(out, (dist, nxt), count, ("dist", "nxt"))
    if not on_cuda(dist=dist, nxt=nxt):
        got = linearize_rank_plain(dist, nxt, i0, count)
        return got if out is None else _plain_into(out, got)
    if out is None:
        out = tuple(torch.empty(2, count, dtype=torch.int32, device=dist.device))
    linearize_rank.launches += _build.launch(
        "amt_linearize_rank", _RANK_SIG, ptr(dist), ptr(nxt), E, i0, count,
        ptr(out[0]), ptr(out[1]), stream(dist))
    return tuple(out)


linearize_rank.launches = 0


def _check_start(fc_e, ans, P: int) -> int:
    """E, the node count of the thread loop's answers ``fc_e``/``ans``
    (int32 [E], E >= P + 1) that a rank loop starts from."""
    E = ans.shape[0] if isinstance(ans, torch.Tensor) else -1
    expect(fc_e, "fc_e", torch.int32, (E,))
    expect(ans, "ans", torch.int32, (E,))
    if not 0 <= P < E:
        raise ValueError(f"{E} nodes, fewer than P + 1 = {P + 1}")
    return E


def linearize_rank_first(fc_e, ans, P: int, i0: int, count: int, out=None):
    """The rank loop's first round over the nodes [i0, i0+count), read
    straight from the thread loop's answers (``fc_e``, ``ans``: int32 [E]
    of P rows) without building the ranking state: (dist, nxt) of those
    nodes, as ``linearize_rank`` gives them from
    ``linearize_rank_init_plain(fc_e, ans, P)``, [count] each, written
    into ``out`` when it is given. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    E = _check_start(fc_e, ans, P)
    _check_range(E, i0, count)
    if out is not None:
        _check_out(out, (fc_e, ans), count, ("dist", "nxt"))
    if not on_cuda(fc_e=fc_e, ans=ans):
        got = linearize_rank_first_plain(fc_e, ans, P, i0, count)
        return got if out is None else _plain_into(out, got)
    if out is None:
        out = tuple(torch.empty(2, count, dtype=torch.int32, device=ans.device))
    linearize_rank_first.launches += _build.launch(
        "amt_linearize_rank_first", _RANK_FIRST_SIG, ptr(fc_e), ptr(ans), P, E,
        i0, count, ptr(out[0]), ptr(out[1]), stream(ans))
    return tuple(out)


linearize_rank_first.launches = 0


def _check_rounds(E: int, rounds: int) -> None:
    if rounds < 1:
        raise ValueError(f"rounds must be at least 1, not {rounds}")
    if E >= MAX_ROUNDS_NODES:
        raise ValueError(f"{E} nodes exceed the rounds entries' node range "
                         f"(< {MAX_ROUNDS_NODES})")


def record_words(words: int, E: int, rounds: int) -> int:
    """int32 words of a rounds entry's scratch (``li_record_words``): E
    records of ``words`` each, none for one round, one buffer for two,
    the ping-pong pair past that."""
    return 0 if rounds < 2 else words * E * (1 if rounds == 2 else 2)


def linearize_thread_rounds_plain(ans, done, jump, rounds: int):
    """Plain PyTorch version: ``rounds`` threading rounds over all E
    nodes, (ans, done, jump) after the last."""
    E = ans.shape[0]
    for _ in range(rounds):
        ans, done, jump = linearize_thread_plain(ans, done, jump, 0, E)
    return ans, done, jump


def linearize_thread_rounds(ans, done, jump, rounds: int):
    """``rounds`` threading rounds over all E nodes of the state
    (ans/jump int32 [E], done bool [E], never written): (ans, done, jump)
    after the last, [E] each, as ``rounds`` calls of ``linearize_thread``
    over [0, E) give them. CPU tensors take the plain version; CUDA
    tensors launch ``rounds`` kernels from one C call."""
    E = ans.shape[0] if isinstance(ans, torch.Tensor) else -1
    expect(ans, "ans", torch.int32, (E,))
    expect(done, "done", torch.bool, (E,))
    expect(jump, "jump", torch.int32, (E,))
    _check_rounds(E, rounds)
    if not on_cuda(ans=ans, done=done, jump=jump):
        return linearize_thread_rounds_plain(ans, done, jump, rounds)
    dev = ans.device
    records = torch.empty(record_words(4, E, rounds), dtype=torch.int32, device=dev)
    out = torch.empty(2, E, dtype=torch.int32, device=dev)
    done1 = torch.empty(E, dtype=torch.bool, device=dev)
    linearize_thread_rounds.launches += _build.launch(
        "amt_linearize_thread_rounds", _THREAD_ROUNDS_SIG, ptr(ans), ptr(done),
        ptr(jump), E, rounds, ptr(records), records.numel(), ptr(out[0]),
        ptr(done1), ptr(out[1]), stream(ans))
    return out[0], done1, out[1]


linearize_thread_rounds.launches = 0


def linearize_rank_rounds_plain(dist, nxt, rounds: int):
    """Plain PyTorch version: ``rounds`` Wyllie rounds over all E nodes,
    (dist, nxt) after the last."""
    E = dist.shape[0]
    for _ in range(rounds):
        dist, nxt = linearize_rank_plain(dist, nxt, 0, E)
    return dist, nxt


def linearize_rank_rounds(dist, nxt, rounds: int):
    """``rounds`` Wyllie rounds over all E nodes of the state (dist/nxt
    int32 [E], never written): (dist, nxt) after the last, [E] each, as
    ``rounds`` calls of ``linearize_rank`` over [0, E) give them. CPU
    tensors take the plain version; CUDA tensors launch ``rounds``
    kernels from one C call."""
    E = dist.shape[0] if isinstance(dist, torch.Tensor) else -1
    expect(dist, "dist", torch.int32, (E,))
    expect(nxt, "nxt", torch.int32, (E,))
    _check_rounds(E, rounds)
    if not on_cuda(dist=dist, nxt=nxt):
        return linearize_rank_rounds_plain(dist, nxt, rounds)
    dev = dist.device
    records = torch.empty(record_words(2, E, rounds), dtype=torch.int32, device=dev)
    out = torch.empty(2, E, dtype=torch.int32, device=dev)
    linearize_rank_rounds.launches += _build.launch(
        "amt_linearize_rank_rounds", _RANK_ROUNDS_SIG, ptr(dist), ptr(nxt), E,
        rounds, ptr(records), records.numel(), ptr(out[0]), ptr(out[1]),
        stream(dist))
    return out[0], out[1]


linearize_rank_rounds.launches = 0


def linearize_rank_from_thread_plain(fc_e, ans, P: int, rounds: int):
    """Plain PyTorch version: the ranking state built from the thread
    loop's answers, then ``rounds`` Wyllie rounds over all E nodes."""
    return linearize_rank_rounds_plain(*linearize_rank_init_plain(fc_e, ans, P),
                                       rounds)


def linearize_rank_from_thread(fc_e, ans, P: int, rounds: int):
    """The row arm's whole rank loop, started from the thread loop's
    answers (``fc_e``, ``ans``: int32 [E] of P rows, never written):
    (dist, nxt) after ``rounds`` Wyllie rounds over all E nodes, as
    ``linearize_rank_rounds`` gives them from
    ``linearize_rank_init_plain(fc_e, ans, P)``. Its first round reads
    ``fc_e`` and ``ans`` in place of the state, so nothing is built
    between the loops. CPU tensors take the plain version; CUDA tensors
    launch ``rounds`` kernels from one C call."""
    E = _check_start(fc_e, ans, P)
    _check_rounds(E, rounds)
    if not on_cuda(fc_e=fc_e, ans=ans):
        return linearize_rank_from_thread_plain(fc_e, ans, P, rounds)
    dev = ans.device
    records = torch.empty(record_words(2, E, rounds), dtype=torch.int32, device=dev)
    out = torch.empty(2, E, dtype=torch.int32, device=dev)
    linearize_rank_from_thread.launches += _build.launch(
        "amt_linearize_rank_from_thread", _RANK_FROM_THREAD_SIG, ptr(fc_e),
        ptr(ans), P, E, rounds, ptr(records), records.numel(), ptr(out[0]),
        ptr(out[1]), stream(ans))
    return out[0], out[1]


linearize_rank_from_thread.launches = 0


def linearize_final(first_child, is_elem, obj_dense, dist, r0: int, count: int):
    """elem_index int32 [count] of the rows [r0, r0+count) from the ranked
    distances ``dist`` (int32, at least P + 1 nodes). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    P = is_elem.shape[0] if isinstance(is_elem, torch.Tensor) else -1
    expect(first_child, "first_child", torch.int32, (2 * P + 3,))
    expect(is_elem, "is_elem", torch.bool, (P,))
    expect(obj_dense, "obj_dense", torch.int32, (P,))
    E = dist.shape[0] if isinstance(dist, torch.Tensor) else -1
    expect(dist, "dist", torch.int32, (E,))
    if E < P + 1:
        raise ValueError(f"dist has {E} nodes, fewer than P + 1 = {P + 1}")
    _check_range(P, r0, count)
    if not on_cuda(first_child=first_child, is_elem=is_elem, obj_dense=obj_dense,
                   dist=dist):
        return linearize_final_plain(first_child, is_elem, obj_dense, dist, r0,
                                     count)
    out = torch.empty(count, dtype=torch.int32, device=dist.device)
    linearize_final.launches += _build.launch(
        "amt_linearize_final", _FINAL_SIG, ptr(first_child), ptr(is_elem),
        ptr(obj_dense), ptr(dist), P, r0, count, ptr(out), stream(dist))
    return out


linearize_final.launches = 0
