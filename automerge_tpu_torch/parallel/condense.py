"""Chain condensation of the sibling forest, on the host.

The port's own copy of ``automerge_tpu/native/condense.cpp``
(``am_chain_condense``, wrapped by ``automerge_tpu.native.chain_condense``),
which feeds the sharded merge's condensed document order
(``parallel/sharding.py``). Preorder over the sibling forest is a linked
list: the successor of an element is its first child, else the next
sibling of its nearest ancestor that has one. Maximal first-child chains
are contiguous stretches of that list, and a non-first child always heads
a chain, so the condensed successor graph is chain-to-chain: ranking R
chains instead of P elements.

The C++ walks each chain from its head, one row at a time. Here the same
tables come from vectorised passes, each a pointer-doubling loop of
ceil_log2(P) + 1 rounds at most: the rows the walks reach (forward along
first-child links from the heads), then each reached row's head and
offset (backward, by doubling over the unique first-child predecessor),
then the within-chain answers by one max-scan over the rows laid out in
chain order.
"""

from __future__ import annotations

import numpy as np

from ..kernels.linearize import rounds


def _reached(succ: np.ndarray, heads: np.ndarray, P: int) -> np.ndarray:
    """Rows reachable from ``heads`` along ``succ`` (-1: none). After
    round j ``mark`` holds the rows fewer than 2^(j+1) steps from a head:
    a row 2^j + t steps away is the 2^j-th successor of a row t steps
    away."""
    jump = np.where(succ >= 0, succ, P).astype(np.int64)
    jump = np.concatenate([jump, [P]])  # slot P: absorbing "no successor"
    mark = np.zeros(P + 1, bool)
    mark[heads] = True
    for _ in range(rounds(P)):
        grown = mark.copy()
        grown[jump[np.flatnonzero(mark)]] = True
        grown[P] = False
        jump = jump[jump]
        if np.array_equal(grown, mark):
            break
        mark = grown
    return mark[:P]


def chain_condense(first_child, next_sib, parent, is_elem, P: int, n_objs: int):
    """Collapse the first-child chains of the sibling forest.

    Inputs as ``automerge_tpu.native.chain_condense`` takes them (node
    space of ``forest``: rows [0, P), object roots from P; ``parent`` is
    the rows' parent node). Returns (R, {chain_id, offset: per row,
    -1 / 0 off the chains; head, len, tail_ans, cpar, centry: per chain,
    trimmed to R; start_chain: per object}), with chain ids in ascending
    head-row order, exactly as the C++ walk numbers them. Raises
    ``ValueError`` where the C++ returns -1: a row reached twice (a
    first-child cycle, or two walks meeting) or an element no walk
    reaches."""
    fc = np.asarray(first_child, np.int64)
    ns = np.asarray(next_sib, np.int64)
    pa = np.asarray(parent, np.int64)[:P]
    ie = np.asarray(is_elem, bool)[:P]
    rows = np.arange(P, dtype=np.int64)
    inner = (pa >= 0) & (pa < P)
    pc = np.clip(pa, 0, max(P - 1, 0))
    # a head's parent is an object root, or the head is not its parent's
    # first child (non-first children always start a chain)
    head = ie & (~inner | (fc[pc] != rows))
    heads = np.flatnonzero(head)
    succ = np.where((fc[:P] >= 0) & (fc[:P] < P), fc[:P], -1)

    on = _reached(succ, heads, P)
    # the walks are disjoint simple paths iff no reached row is entered
    # twice: by two reached rows, or by one while it is itself a head
    into = np.bincount(succ[on & (succ >= 0)], minlength=P)[:P]
    if np.any(on & (into + head > 1)):
        raise ValueError("cyclic element structure in chain condensation")
    if np.any(ie & ~on):
        raise ValueError("cyclic element structure in chain condensation")

    # each reached row's head and offset: doubling over the unique
    # first-child predecessor, heads (and rows off the chains) fixed
    anc = rows.copy()
    src = np.flatnonzero(on & (succ >= 0))
    anc[succ[src]] = src
    dist = (anc != rows).astype(np.int64)
    for _ in range(rounds(P)):
        if np.array_equal(anc[anc], anc):
            break
        dist = dist + dist[anc]
        anc = anc[anc]

    R = len(heads)
    cid_of_head = np.full(P, -1, np.int64)
    cid_of_head[heads] = np.arange(R)
    chain_id = np.where(on, cid_of_head[anc], -1)
    offset = np.where(on, dist, 0)
    length = np.bincount(chain_id[on], minlength=R)[:R]

    # rows in walk order; prefix_ans = the last next_sib >= 0 so far along
    # the chain (a max-scan of positions, cut at the chain's start)
    start = np.concatenate([[0], np.cumsum(length)[:-1]]).astype(np.int64)
    members = np.flatnonzero(on)
    order = np.empty(len(members), np.int64)
    order[start[chain_id[members]] + offset[members]] = members
    val = ns[order]
    pos = np.arange(len(order))
    last = np.maximum.accumulate(np.where(val >= 0, pos, -1))
    carry = np.where(last >= start[chain_id[order]], val[np.maximum(last, 0)], -1)
    prefix_ans = np.full(P, -1, np.int64)
    prefix_ans[order] = carry
    tail_ans = carry[start + length - 1]

    p_head = pa[heads]
    root = (p_head >= P) | (p_head < 0)
    ph = np.clip(p_head, 0, max(P - 1, 0))
    cpar = np.where(root, -1, chain_id[ph])
    centry = np.where(root, -1, prefix_ans[ph])

    f = fc[P: P + n_objs]
    start_chain = np.full(len(f), -1, np.int64)
    hit = (f >= 0) & (f < P)
    start_chain[hit] = chain_id[f[hit]]

    out = {"chain_id": chain_id, "offset": offset, "head": heads, "len": length,
           "tail_ans": tail_ans, "cpar": cpar, "centry": centry,
           "start_chain": start_chain}
    return R, {k: np.ascontiguousarray(v, np.int32) for k, v in out.items()}
