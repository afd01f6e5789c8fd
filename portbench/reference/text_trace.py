"""The plain reference of a merged text object: automerge's sequence CRDT
(RGA) written out in NumPy and Python, from the generator's ops alone.

Every element is an insert op; it sits after its anchor, and the elements
anchored on one element come in descending op-id order, each followed by
its own subtree: a depth-first walk. An op id orders by its counter, then
by its actor's bytes. An element is visible when no delete targets it.
The merge semantics hold whatever order the changes arrive in; the
``"arrival"`` sibling order breaks that guarantee (the elements anchored on
one element come in the order their changes arrived), and serves as the
control.

Imports neither the program nor JAX.
"""

from __future__ import annotations

import numpy as np


def _actor_rank(actors: np.ndarray) -> np.ndarray:
    """Each actor's rank in byte order."""
    order = sorted(range(len(actors)), key=lambda i: bytes(actors[i]))
    rank = np.empty(len(actors), np.int64)
    rank[order] = np.arange(len(actors))
    return rank


def text(ref: dict, n_changes: int, sibling_order: str = "opid") -> str:
    """The visible text once the first ``n_changes`` changes (the base is
    change 0) are merged."""
    rank = _actor_rank(ref["actors"])
    n_act = len(rank)
    keep = ref["ins_change"] < n_changes
    ctr = ref["ins_ctr"][keep].astype(np.int64)
    actor = ref["ins_actor"][keep]
    change = ref["ins_change"][keep]
    chars = ref["ins_char"][keep]
    anc_ctr = ref["anc_ctr"][keep].astype(np.int64)
    anc_actor = ref["anc_actor"][keep]
    n = len(ctr)
    # node 0 is HEAD; node i + 1 is insert i
    key = ctr * n_act + rank[actor]
    by_key = np.argsort(key, kind="stable")
    head = anc_ctr == 0
    anc_key = np.where(head, -1, anc_ctr * n_act + rank[np.maximum(anc_actor, 0)])
    pos = np.searchsorted(key[by_key], anc_key)
    pos = np.minimum(pos, max(n - 1, 0))
    parent = np.where(head, 0, by_key[pos] + 1)
    if not np.all(head | (key[by_key][pos] == anc_key)):
        raise ValueError("an insert is anchored on an element no change made")
    # siblings: descending op id, or (the control) ascending arrival
    if sibling_order == "opid":
        order = np.lexsort((-rank[actor], -ctr, parent))
    elif sibling_order == "arrival":
        order = np.lexsort((-ctr, change, parent))
    else:
        raise ValueError(f"unknown sibling order {sibling_order!r}")
    first_child = np.full(n + 1, -1, np.int64)
    next_sib = np.full(n + 1, -1, np.int64)
    sorted_parent = parent[order]
    starts = np.flatnonzero(np.r_[True, sorted_parent[1:] != sorted_parent[:-1]])
    first_child[sorted_parent[starts]] = order[starts] + 1
    same = sorted_parent[1:] == sorted_parent[:-1]
    next_sib[order[:-1][same] + 1] = order[1:][same] + 1
    # depth-first walk, iterative
    walk = np.empty(n, np.int64)
    fc, ns = first_child.tolist(), next_sib.tolist()
    stack = [0]
    k = 0
    while stack:
        node = stack.pop()
        if node:
            walk[k] = node - 1
            k += 1
        sib = ns[node]
        if sib >= 0 and node:
            stack.append(sib)
        child = fc[node]
        if child >= 0:
            stack.append(child)
    if k != n:
        raise ValueError(f"the walk reached {k} of {n} elements")
    dkeep = ref["del_change"] < n_changes
    dkey = ref["del_ctr"][dkeep].astype(np.int64) * n_act + rank[ref["del_actor"][dkeep]]
    visible = ~np.isin(key, dkey)
    doc_order = walk[visible[walk]]
    return chars[doc_order].tobytes().decode("ascii")
