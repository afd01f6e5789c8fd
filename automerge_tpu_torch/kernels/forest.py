"""forest: the RGA sibling forest.

Replaces ``automerge_tpu/ops/merge.py`` ``forest`` (:551-592); the CUDA
kernels are in ``csrc/forest.cu``: a links pass (is_elem and parent_row
of every row, one packed int64 sibling key per element row, compacted to
the front of a buffer with the element count kept on the card), the radix
sort of those keys over the digits their layout lets vary
(``radix_sort.radix_sort`` with ``sibling_digits(P)`` and that count),
and a finish pass over adjacent sorted keys (next_sib, and first_child at
the start of each parent's run). first_child and next_sib start at -1 by
one memset. Node space is N = 2P+3: element rows, object roots
P + obj_dense, and the sentinel N-1. Bound by bytes: 13P read, 5P + 8N
written (the sort: 8 bytes an element read, 8 written).
"""

from __future__ import annotations

import torch

from ..ops.oplog import ELEM_HEAD, PAD_ACTION
from . import _build
from ._args import expect, on_cuda, ptr, stream
from .radix_sort import radix_sort, radix_sort_plain

_P, _I = _build.P_, _build.I_
_LINKS_SIG = [_P, _P, _P, _P, _I] + [_P] * 5 + [_P]
_FINISH_SIG = [_P, _I, _P, _P, _P]


def parent_rows(action, insert, elem_ref, obj_dense):
    """(is_elem, parent_row): an insert's parent is its reference
    element, its object's root P + obj_dense for HEAD, else the sentinel
    N-1 (as for every non-element)."""
    P = action.shape[0]
    S = 2 * P + 2
    is_elem = insert & (action != PAD_ACTION)
    sentinel = torch.full_like(elem_ref, S)
    parent = torch.where(
        elem_ref == ELEM_HEAD,
        P + obj_dense,
        torch.where(elem_ref >= 0, elem_ref, sentinel),
    )
    return is_elem, torch.where(is_elem, parent, sentinel)


def sibling_keys(is_elem, parent_row):
    """(sib_parent << 32) | (P-1-row), int64: ascending order is parent
    ascending, row descending; non-elements take sib_parent = N."""
    P = is_elem.shape[0]
    rows = torch.arange(P, dtype=torch.int64, device=is_elem.device)
    sp = torch.where(is_elem, parent_row.long(), torch.full_like(rows, 2 * P + 3))
    return (sp << 32) | (P - 1 - rows)


def sibling_digits(P: int) -> tuple:
    """The 8-bit digits of the sibling keys that can vary, from their
    layout alone: the low word P-1-row < P, the high word sib_parent <= N
    = 2P+3; bit 63 is always clear."""
    low = ((P - 1).bit_length() + 7) // 8 if P > 0 else 0
    high = ((2 * P + 3).bit_length() + 7) // 8
    return tuple(range(low)) + tuple(range(4, 4 + high))


def next_sib_from_sorted(sorted_keys, P: int):
    N = 2 * P + 3
    sp = sorted_keys >> 32
    row = P - 1 - (sorted_keys & 0xFFFFFFFF)
    none = torch.full((1,), -1, dtype=torch.int64, device=sorted_keys.device)
    same = torch.cat([sp[1:] == sp[:-1], torch.zeros_like(none, dtype=torch.bool)])
    nxt = torch.where(same, torch.cat([row[1:], none]), -1)
    in_range = sp < N
    next_sib = torch.full((N,), -1, dtype=torch.int32, device=sorted_keys.device)
    next_sib[row[in_range]] = nxt[in_range].to(torch.int32)
    return next_sib


def forest_plain(action, insert, elem_ref, obj_dense):
    """Plain PyTorch version: (is_elem, parent_row, first_child,
    next_sib)."""
    P = action.shape[0]
    N = 2 * P + 3
    is_elem, parent_row = parent_rows(action, insert, elem_ref, obj_dense)
    rows = torch.arange(P, dtype=torch.int32, device=action.device)
    keep = is_elem & (parent_row >= 0) & (parent_row < N)
    first_child = torch.full((N,), -1, dtype=torch.int32, device=action.device)
    first_child.scatter_reduce_(
        0, parent_row[keep].long(), rows[keep], "amax", include_self=True
    )
    sorted_keys = radix_sort_plain(sibling_keys(is_elem, parent_row))
    return is_elem, parent_row, first_child, next_sib_from_sorted(sorted_keys, P)


def element_keys(is_elem, parent_row):
    """The sibling keys of the element rows whose parent lies in the node
    space [0, 2P+3), in row order: what the links pass compacts (in some
    order of its blocks)."""
    keep = is_elem & (parent_row >= 0) & (parent_row < 2 * is_elem.shape[0] + 3)
    return sibling_keys(is_elem, parent_row)[keep]


def forest_model(action, insert, elem_ref, obj_dense, block: int = 256,
                 block_order=None):
    """The CUDA design in plain PyTorch, pass by pass: (is_elem,
    parent_row, first_child, next_sib, the number of keys sorted). The
    links pass compacts the element keys block by block, the blocks of
    ``block`` rows taking their offsets in ``block_order`` (a permutation
    of the block indices; default ascending), as the blocks' atomics may;
    the keys are sorted; each sorted key links its row to the next key's
    row under the same parent, and the first key of a parent's run is
    that parent's first child; every other node reads -1."""
    P = action.shape[0]
    N = 2 * P + 3
    dev = action.device
    is_elem, parent_row = parent_rows(action, insert, elem_ref, obj_dense)
    keyed = is_elem & (parent_row >= 0) & (parent_row < N)
    key = sibling_keys(is_elem, parent_row)
    n_blocks = -(-P // block)
    order = range(n_blocks) if block_order is None else block_order
    keys = torch.cat([key[b * block:(b + 1) * block][keyed[b * block:(b + 1) * block]]
                      for b in order] + [key[:0]])
    n = keys.shape[0]
    ks = radix_sort_plain(keys, sibling_digits(P))
    sp, row = ks >> 32, P - 1 - (ks & 0xFFFFFFFF)
    nodes = torch.full((2, N), -1, dtype=torch.int32, device=dev)
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = sp[1:] != sp[:-1]
    nodes[0][sp[start]] = row[start].to(torch.int32)
    linked = sp[1:] == sp[:-1]
    nodes[1][row[:-1][linked]] = row[1:][linked].to(torch.int32)
    return is_elem, parent_row, nodes[0], nodes[1], n


def forest(action, insert, elem_ref, obj_dense):
    """(is_elem, parent_row, first_child, next_sib) for int32/bool [P]
    columns. CPU tensors take the plain version; CUDA tensors launch the
    kernels (the sort through ``radix_sort``)."""
    P = action.shape[0] if isinstance(action, torch.Tensor) else -1
    expect(action, "action", torch.int32, (P,))
    expect(insert, "insert", torch.bool, (P,))
    expect(elem_ref, "elem_ref", torch.int32, (P,))
    expect(obj_dense, "obj_dense", torch.int32, (P,))
    if not on_cuda(action=action, insert=insert, elem_ref=elem_ref,
                   obj_dense=obj_dense):
        return forest_plain(action, insert, elem_ref, obj_dense)
    if P >= 1 << 29:
        raise ValueError(f"forest: {P} rows exceed the int32 node range")
    dev = action.device
    N = 2 * P + 3
    is_elem = torch.empty(P, dtype=torch.bool, device=dev)
    parent_row = torch.empty(P, dtype=torch.int32, device=dev)
    nodes = torch.empty(2, N, dtype=torch.int32, device=dev)
    keys = torch.empty(P, dtype=torch.int64, device=dev)
    n_elem = torch.empty(1, dtype=torch.int32, device=dev)  # set on the card
    st = stream(action)
    forest.launches += _build.launch(
        "amt_forest_links", _LINKS_SIG, ptr(action), ptr(insert), ptr(elem_ref),
        ptr(obj_dense), P, ptr(is_elem), ptr(parent_row), ptr(nodes), ptr(keys),
        ptr(n_elem), st)
    sorted_keys = radix_sort(keys, sibling_digits(P), n_elem)
    forest.launches += _build.launch(
        "amt_forest_finish", _FINISH_SIG, ptr(sorted_keys), P, ptr(n_elem),
        ptr(nodes), st)
    return is_elem, parent_row, nodes[0], nodes[1]


forest.launches = 0
