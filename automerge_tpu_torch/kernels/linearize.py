"""linearize: document-order element indices, all on the device.

Replaces ``automerge_tpu/ops/merge.py`` ``device_linearize`` (:216-285);
the CUDA kernels are in ``csrc/linearize.cu``: sibling-climb pointer
doubling, then Wyllie list ranking, ceil_log2(E)+1 rounds each over
E = P+1 nodes, one launch per round on ping-pong buffers. Bound by
bytes: first_child and next_sib over the rows [0, P) (8P), is_elem,
elem_ref, obj_dense (9P) and first_child at the object roots read, 4P
written.

The sharded merge (``parallel/sharding.py``) drives the same loops
round by round: ``linearize_init`` (the threading state over Epad nodes,
padded past the sentinel with fixed points), ``linearize_thread`` and
``linearize_rank`` (one round over a slice of the nodes, reading the
full gathered state), ``linearize_rank_init`` and ``linearize_final``.
Its condensed arm runs ``linearize_thread`` and ``linearize_rank`` over
the chain tables.
"""

from __future__ import annotations

import torch

from . import _build
from ._args import expect, on_cuda, ptr, stream

_P, _I = _build.P_, _build.I_
_SIG = [_P] * 5 + [_I, _I] + [_P] * 3 + [_P]
_INIT_SIG = [_P] * 4 + [_I, _I] + [_P] * 4 + [_P]
_ROUND_SIG = [_P] * 3 + [_I] * 3 + [_P] * 3 + [_P]
_RANK_INIT_SIG = [_P] * 2 + [_I, _I] + [_P] * 2 + [_P]
_RANK_SIG = [_P] * 2 + [_I] * 3 + [_P] * 2 + [_P]
_FINAL_SIG = [_P] * 4 + [_I] * 3 + [_P] + [_P]


def ceil_log2(n: int) -> int:
    return max(1, int(n - 1).bit_length())


def rounds(P: int) -> int:
    """Doubling rounds of each loop for P rows (E = P+1 nodes)."""
    return ceil_log2(P + 1) + 1


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
    E = P + 1
    scratch = torch.empty(7, E, dtype=torch.int32, device=dev)
    done = torch.empty(2, E, dtype=torch.bool, device=dev)
    elem_index = torch.empty(P, dtype=torch.int32, device=dev)
    linearize.launches += _build.launch(
        "amt_linearize", _SIG, ptr(first_child), ptr(next_sib), ptr(is_elem),
        ptr(elem_ref), ptr(obj_dense), P, rounds(P), ptr(scratch), ptr(done),
        ptr(elem_index), stream(is_elem))
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


def linearize_thread(ans, done, jump, i0: int, count: int):
    """One threading round over the nodes [i0, i0+count) of the E-node
    state (ans/jump int32 [E], done bool [E]): (ans, done, jump) of those
    nodes, [count] each. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    E = ans.shape[0] if isinstance(ans, torch.Tensor) else -1
    expect(ans, "ans", torch.int32, (E,))
    expect(done, "done", torch.bool, (E,))
    expect(jump, "jump", torch.int32, (E,))
    _check_range(E, i0, count)
    if not on_cuda(ans=ans, done=done, jump=jump):
        return linearize_thread_plain(ans, done, jump, i0, count)
    dev = ans.device
    out = torch.empty(2, count, dtype=torch.int32, device=dev)
    done1 = torch.empty(count, dtype=torch.bool, device=dev)
    linearize_thread.launches += _build.launch(
        "amt_linearize_thread", _ROUND_SIG, ptr(ans), ptr(done), ptr(jump), E,
        i0, count, ptr(out[0]), ptr(done1), ptr(out[1]), stream(ans))
    return out[0], done1, out[1]


linearize_thread.launches = 0


def linearize_rank_init(fc_e, ans, P: int):
    """(dist, nxt) int32 [Epad]: the ranking state from the threaded
    answers ``ans`` and first children ``fc_e`` (int32 [Epad]) of P rows.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    Epad = ans.shape[0] if isinstance(ans, torch.Tensor) else -1
    expect(fc_e, "fc_e", torch.int32, (Epad,))
    expect(ans, "ans", torch.int32, (Epad,))
    if Epad < P + 1:
        raise ValueError(f"Epad {Epad} < P + 1 = {P + 1}")
    if not on_cuda(fc_e=fc_e, ans=ans):
        return linearize_rank_init_plain(fc_e, ans, P)
    state = torch.empty(2, Epad, dtype=torch.int32, device=ans.device)
    linearize_rank_init.launches += _build.launch(
        "amt_linearize_rank_init", _RANK_INIT_SIG, ptr(fc_e), ptr(ans), P, Epad,
        ptr(state[0]), ptr(state[1]), stream(ans))
    return state[0], state[1]


linearize_rank_init.launches = 0


def linearize_rank(dist, nxt, i0: int, count: int):
    """One Wyllie round over the nodes [i0, i0+count) of the E-node state
    (dist/nxt int32 [E]): (dist, nxt) of those nodes, [count] each. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    E = dist.shape[0] if isinstance(dist, torch.Tensor) else -1
    expect(dist, "dist", torch.int32, (E,))
    expect(nxt, "nxt", torch.int32, (E,))
    _check_range(E, i0, count)
    if not on_cuda(dist=dist, nxt=nxt):
        return linearize_rank_plain(dist, nxt, i0, count)
    out = torch.empty(2, count, dtype=torch.int32, device=dist.device)
    linearize_rank.launches += _build.launch(
        "amt_linearize_rank", _RANK_SIG, ptr(dist), ptr(nxt), E, i0, count,
        ptr(out[0]), ptr(out[1]), stream(dist))
    return out[0], out[1]


linearize_rank.launches = 0


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
