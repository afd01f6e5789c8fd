"""linearize_condensed: document-order element indices by chain
condensation, all on the device.

Replaces ``automerge_tpu/ops/merge.py`` ``device_linearize_condensed``
(:303-494). It gives ``linearize``'s ``elem_index`` without pointer
chasing over all P rows: the insert rows are laid out in actor order
(``aorder``, from ``OpLog.actor_order``), where a typing chain is a
contiguous stretch of slots (a run). ``linearize_condensed_plain`` keeps
the reference's algorithm (two scans find the runs; a sibling climb and
a Wyllie ranking over tables of at most ``rcap`` runs, ceil_log2(rcap)+1
rounds each) and stays the oracle. Each object's chain start is read from
its root (:490-494). The reference's ``obj_cap`` arm (:481-488) reads the
same roots through a table; it exists there to pack the winner key into
one int32, which the sort-based winners here do not need, so it is not
ported.

The CUDA kernel (``csrc/linearize_condensed.cu``) has no doubling loop:
one slot pass scans the runs (decoupled look-back across tiles), the runs
become a condensed Euler tour whose successors are all local (an enter
node a run, weighing its length; an exit node a head or sibling-bearing
slot), and ``linearize``'s ruling set ranks it (``csrc/tour.cuh``);
``LAUNCHES`` launches after one memset, whatever ``rcap``. Bound by
bytes: is_elem and aorder read in full (5P), elem_ref, next_sib and
obj_dense at the element rows, first_child at the element parents and
the object roots, elem_index (4P) written.

``aorder`` must hold every element row once (its pad slots P), as
``OpLog.actor_order`` padded by ``pad_columns`` does. The run count must
fit ``rcap``: both versions raise ``ValueError`` when it does not (the
JAX kernel assumes it).
"""

from __future__ import annotations

import torch

from . import _build
from ._args import expect, on_cuda, ptr, stream
from .linearize import ceil_log2
from .linearize import scratch_words as tour_levels_words

_P, _I, _LL = _build.P_, _build.I_, _build.LL_
_SIG = [_P] * 6 + [_I, _I, _I, _P, _LL, _P, _LL, _P, _P]
LAUNCHES = 8  # the slot scan, the tour, the ruling set's five, the final pass
TILE = 4096  # slots per scan tile


def rounds(rcap: int) -> int:
    """Doubling rounds of each of the reference's loops over ``rcap`` runs."""
    return ceil_log2(rcap) + 1


def tour_capacity(P: int, rcap: int) -> int:
    """Tour nodes the kernel has room for: rcap enter nodes and an exit
    node for each of at most P slots."""
    return rcap + P


def ruler_capacity(P: int, rcap: int) -> int:
    """Level-1 rulers kept: one in four (the stride on the device is at
    least 4) of the nodes a forest's tour can have (3 rcap: a sibling
    names a run head), and a margin for the hash's deviation; past it a
    node is simply no ruler."""
    cap = tour_capacity(P, rcap)
    return min(cap, min(cap, 3 * rcap) // 4 + 1024)


def _round4(words: int) -> int:
    return -(-words // 4) * 4


def scratch_words(P: int, rcap: int, r1cap: int) -> int:
    """int32 words of the kernel's scratch (``lc_scratch_words``); the
    ruling set's levels take what ``linearize``'s scratch has past its
    12P words of rows."""
    nb = -(-P // TILE)
    cap = tour_capacity(P, rcap)
    return (4 + 4 * nb + 4 + _round4(P) + 4 * P + _round4(rcap)
            + _round4(6 * cap) + tour_levels_words(0, r1cap))


def tour_size(first_child, next_sib, is_elem, elem_ref, aorder) -> tuple:
    """(runs, exit nodes) of the kernel's condensed tour on these inputs,
    in plain PyTorch: a run breaks at a slot whose row is not its parent
    element's first child with the parent in the slot before; an exit
    node is a run head or a slot whose row has a next sibling."""
    P = is_elem.shape[0]
    valid = aorder < P
    rows = aorder.clamp(0, P - 1).long()
    er = elem_ref[rows].long()
    erc = er.clamp(0, P - 1)
    prev = torch.cat([torch.full((1,), P, device=aorder.device), aorder[:-1]])
    elem = valid & is_elem[rows]
    cont = (elem & (er >= 0) & (er < P) & is_elem[erc]
            & (first_child[erc].long() == rows) & (er == prev.long()))
    brk = valid & ~cont
    flag = elem & (next_sib[rows] != -1)
    return int(brk.sum()), int((brk | flag).sum())


def _check_runs(n_runs: int, rcap: int) -> None:
    if n_runs > rcap:
        raise ValueError(
            f"linearize_condensed: {n_runs} chain runs exceed rcap = {rcap}")


def linearize_condensed_plain(first_child, next_sib, is_elem, elem_ref,
                              obj_dense, aorder, rcap: int):
    """Plain PyTorch version: elem_index int32 [P] (-1 for non-elements).
    Every gather index is clamped and every dropped scatter lands in a
    spare slot, as XLA does for the reference."""
    P = is_elem.shape[0]
    N = first_child.shape[0]
    dev = is_elem.device
    i32 = torch.int32
    ks = torch.arange(P, dtype=i32, device=dev)
    rix = torch.arange(rcap, dtype=i32, device=dev)

    def at(t, idx, n):  # gather, indices clamped into [0, n)
        return t[idx.long().clamp(0, max(n - 1, 0))]

    def scatter(size, idx, vals, fill=0):  # the spare slot `size` is dropped
        out = torch.full((size + 1, *vals.shape[1:]), fill, dtype=vals.dtype,
                         device=dev)
        out[idx.long()] = vals
        return out[:size]

    # each element row marks ITS first child as a continuation
    fc_elem = first_child[:P]
    mark = is_elem & (fc_elem >= 0)
    is_cont = scatter(P, torch.where(mark, fc_elem.clamp(0, P - 1), P),
                      torch.ones(P, dtype=torch.bool, device=dev), False)
    valid = aorder < P
    seqc = aorder.clamp(0, P - 1)
    kpos = scatter(P, torch.where(valid, seqc, P), ks)  # row -> slot (0 if none)
    sib = next_sib[:P]
    row_pack = torch.stack(
        [elem_ref, sib, is_cont.to(i32) * 2 + (sib != -1).to(i32)], 1)
    g = scatter(P, torch.where(is_elem, kpos, P), row_pack)
    er_k, sib_k, cont_bit = g[:, 0], g[:, 1], g[:, 2]

    # a slot continues its run iff it is a first-child continuation AND
    # its parent is the previous slot's row
    prev_row = torch.cat([torch.full((1,), P, dtype=i32, device=dev), aorder[:-1]])
    cont_k = valid & (cont_bit >= 2) & (er_k == prev_row)
    brk = valid & ~cont_k
    run_of_k = torch.cumsum(brk.to(i32), 0, dtype=i32) - 1
    # the reference's segmented scan: the start of k's run (the last
    # break at or before k, else 0) and the last sibling-bearing slot of
    # [start, k] with its next sibling
    start_k = torch.cummax(torch.where(brk, ks, 0), 0).values
    flag_k = valid & ((cont_bit & 1) == 1)
    last = torch.cummax(torch.where(flag_k, ks, -1), 0).values
    ansf_k = last >= start_k
    ans_k = torch.where(ansf_k, at(sib_k, last, P), -1)
    off_k = ks - start_k

    n_runs = int(brk.sum())
    _check_runs(n_runs, rcap)
    live_r = rix < n_runs
    n_elems = int(valid.sum())
    run_start = scatter(rcap, torch.where(brk, run_of_k.clamp(0, rcap - 1), rcap), ks)
    run_end = torch.where(
        rix + 1 < n_runs,
        torch.cat([run_start[1:], torch.zeros(1, dtype=i32, device=dev)]),
        n_elems)
    run_len = torch.where(live_r, run_end - run_start, 0)

    # sibling climb over runs: a run asks for A at its head's parent,
    # answered within the parent's run prefix when a flagged slot is
    # there, else inherited from the parent's run's own climb
    head_row = at(aorder, run_start, P)
    par_head = torch.where(live_r, at(elem_ref, head_row, P), -1)
    par_is_elem = par_head >= 0
    pk = at(kpos, par_head, P)
    done = ~par_is_elem | ansf_k[pk.long()]
    ans = torch.where(par_is_elem & ansf_k[pk.long()], ans_k[pk.long()], -1)
    jump = torch.where(par_is_elem, run_of_k[pk.long()].clamp(0, rcap - 1), rix)
    for _ in range(rounds(rcap)):
        j = jump.long()
        take = ~done & done[j]
        ans = torch.where(take, ans[j], ans)
        done = done | take
        jump = jump[j]

    # run successor: the tail's first child (a later run's head), else the
    # tail's climb answer (its run prefix, else the run's climb)
    tail_k = (run_start + run_len - 1).clamp(0, P - 1).long()
    tail_row = aorder[tail_k]
    fc_tail = at(first_child, tail_row, P)
    a_tail = torch.where(ansf_k[tail_k], ans_k[tail_k], ans)
    nxt_row = torch.where(live_r, torch.where(fc_tail >= 0, fc_tail, a_tail), -1)
    succ_run = torch.where(
        nxt_row >= 0, at(run_of_k, at(kpos, nxt_row, P), P).clamp(0, rcap - 1),
        rcap)

    # Wyllie ranking over runs, weights the run lengths; slot rcap ends
    dist = torch.cat([torch.where(live_r, run_len, 0),
                      torch.zeros(1, dtype=i32, device=dev)])
    nxt = torch.cat([succ_run, torch.full((1,), rcap, dtype=i32, device=dev)])
    for _ in range(rounds(rcap)):
        j = nxt.long()
        dist = dist + dist[j]
        nxt = nxt[j]

    # each slot takes its run's head value; nodes from it to the end are
    # the run's minus its offset; back to rows, rank = T(start) - T(row)
    dist_at_head = scatter(P, torch.where(live_r, run_start.clamp(0, P), P),
                           dist[:rcap])
    t_slot = dist_at_head[start_k.long()] - off_k
    t_row = scatter(P, torch.where(valid, seqc, P), t_slot)
    start = at(first_child, P + obj_dense, N)
    return torch.where(is_elem & (start >= 0), at(t_row, start, P) - t_row, -1)


def _check(first_child, next_sib, is_elem, elem_ref, obj_dense, aorder,
           rcap: int) -> bool:
    """True for valid CUDA arguments on one card, False for valid CPU
    ones; raises for any other."""
    P = is_elem.shape[0] if isinstance(is_elem, torch.Tensor) else -1
    N = 2 * P + 3
    expect(first_child, "first_child", torch.int32, (N,))
    expect(next_sib, "next_sib", torch.int32, (N,))
    expect(is_elem, "is_elem", torch.bool, (P,))
    expect(elem_ref, "elem_ref", torch.int32, (P,))
    expect(obj_dense, "obj_dense", torch.int32, (P,))
    expect(aorder, "aorder", torch.int32, (P,))
    if P < 1 or rcap < 1:
        raise ValueError(f"linearize_condensed: P {P}, rcap {rcap}")
    cuda = on_cuda(first_child=first_child, next_sib=next_sib, is_elem=is_elem,
                   elem_ref=elem_ref, obj_dense=obj_dense, aorder=aorder)
    if cuda and (P >= 1 << 29 or rcap >= 1 << 29):
        raise ValueError(f"linearize_condensed: {P} rows / rcap {rcap} exceed "
                         "the int32 node range")
    return cuda


def _buffers(P: int, rcap: int, dev):
    """(scratch int32, flags uint8, elem_index int32 [P]): the scratch
    with the run count at [0], the slot flags then the tour's node marks."""
    words = scratch_words(P, rcap, ruler_capacity(P, rcap))
    return (torch.empty(words, dtype=torch.int32, device=dev),
            torch.empty(P + tour_capacity(P, rcap), dtype=torch.uint8, device=dev),
            torch.empty(P, dtype=torch.int32, device=dev))


def _launch(args, rcap: int, scratch, flags, elem_index, st) -> int:
    """The kernel's launches on the stream ``st``: their count."""
    P = elem_index.shape[0]
    return _build.launch(
        "amt_linearize_condensed", _SIG, *map(ptr, args), P, rcap,
        ruler_capacity(P, rcap), ptr(scratch), scratch.shape[0], ptr(flags),
        flags.shape[0], ptr(elem_index), st)


def linearize_condensed(first_child, next_sib, is_elem, elem_ref, obj_dense,
                        aorder, rcap: int):
    """elem_index int32 [P] from the forest (first_child/next_sib int32
    [2P+3], is_elem bool [P]), the elem_ref/obj_dense columns and the
    actor-order slots ``aorder`` int32 [P], with at most ``rcap`` runs.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    and read the run count back to check it against ``rcap``."""
    args = (first_child, next_sib, is_elem, elem_ref, obj_dense, aorder)
    if not _check(*args, rcap):
        return linearize_condensed_plain(*args, rcap)
    scratch, flags, elem_index = _buffers(is_elem.shape[0], rcap, is_elem.device)
    linearize_condensed.launches += _launch(args, rcap, scratch, flags, elem_index,
                                            stream(is_elem))
    _check_runs(int(scratch[0]), rcap)  # the run count: the one host sync
    return elem_index


linearize_condensed.launches = 0
