"""The sharded merge: every phase of the merge split over a mesh of shards.

The port of ``automerge_tpu/parallel/sharding.py`` (K11), which runs the
merge under ``jax.shard_map`` over a ``jax.sharding.Mesh``. As there, one
process drives the whole mesh (``parallel/collectives.py``): the pred
stream is split over the shards and the op columns are replicated on
each distinct device, and the phases run as follows.

1. succ resolution: each shard counts its slice of the pred edges into
   full-size counters (``succ_partial``), one ``psum`` combines them.
2. visibility: elementwise on the summed counts, replicated.
3. per-key winners, while the dense group table passes the sharded gate
   ``n_objs2 * n_props <= 8 P + 65536``: each shard scatters its ROW
   slice into the group table (``winners_partial``), a ``pmax`` of the
   winners and a ``psum`` of the counts merge the shards' tables, each
   shard gathers its rows' winner and conflicts (``winners_gather``),
   one ``all_gather`` each re-replicates them and a ``psum`` the
   per-object stats. Past the gate: the sort-based winners, replicated.
4. the sibling forest, replicated.
5. document order. By default the condensed arm: the host collapses the
   forest's first-child chains into R chains (``condense_host``), the
   ancestor climb and the Wyllie ranking run over R2 chain slots, each
   round a shard advancing its slice and an ``all_gather`` of O(R)
   values, then the shards' rows are expanded to element ranks and one
   ``all_gather`` of O(P) values ends it (one launch per device, into
   the replicated result: nothing is copied on one device).
   ``linearize="rows"`` runs the reference's other arm instead (its arm
   without the native library): the same loops over the E = P + 1
   element nodes, padded to n (P/n + 1), so each round gathers O(P);
   its rank loop's first round reads the thread loop's answers, where
   the reference builds the ranking state between the loops. Where
   every shard sits on one device (``Mesh(["cuda:0"] * 4)``, a
   CPU mesh), the shards' slices tile the state and a loop is one call
   of its rounds entry (``rounds`` launches, no copy); over distinct
   devices each device advances its shards' slices in its own buffers
   and only the others' are copied in.

Replicated phases run once per distinct device of the mesh (their values
are the same on every shard); row-sliced phases launch once per shard,
on its device, but for the condensed expansion, once per run of shards
on a device; psum and pmax fold once per distinct device. On a CUDA
mesh every step launches its kernel or raises: there is no fallback to
one device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import obs
from ..convert import columns_from_numpy
from ..kernels import linearize as L
from ..kernels.forest import forest
from ..kernels.scatter_winners import winners_gather, winners_partial
from ..kernels.sharded import cond_expand, cond_init, cond_succ
from ..kernels.sort_winners import sort_winners
from ..kernels.succ_vis import succ_partial, visibility
from ..obs import prof as _prof
from ..ops.merge import ALL_OUTPUTS, _unpack_transport, encode_transport
from ..ops.oplog import host_forest
from . import collectives as C
from .collectives import Mesh, default_mesh
from .condense import chain_condense

SHARDED, REPLICATED = "sharded", "replicated"
# column -> placement: the pred stream splits over the shards, the op
# columns are replicated (row WORK is split by slicing, not the columns)
COLUMN_SPECS = {
    "action": REPLICATED,
    "insert": REPLICATED,
    "prop": REPLICATED,
    "elem_ref": REPLICATED,
    "obj_dense": REPLICATED,
    "value_tag": REPLICATED,
    "value_i32": REPLICATED,
    "width": REPLICATED,
    "covered": REPLICATED,
    "pred_src": SHARDED,
    "pred_tgt": SHARDED,
}
TRANSPORTS = ("dict", "packed")
LINEARIZE = ("condensed", "rows")
_COND_KEYS = ("chain_id", "offset", "tail_ans", "cpar", "centry", "clen",
              "start_chain")


def sharded_gate(P: int, n_objs2: int, n_props: int) -> bool:
    """The sharded merge's scatter gate (``sharding.py:389-391``), on the
    unbucketed geometry: the single-device merge buckets it first."""
    return n_objs2 * max(n_props, 1) <= 8 * P + 65536


def _sharded_winners(mesh, cols, out, Pl, n_objs2, n_props):
    """Scatter winners over the shards' row slices (``_sharded_winners``,
    :99): winner/conflicts gathered, per-object stats summed."""
    tables = C.per_shard(mesh, lambda i, d: winners_partial(
        cols[d]["action"], cols[d]["insert"], cols[d]["elem_ref"],
        cols[d]["obj_dense"], cols[d]["prop"], out[d]["visible"], i * Pl, Pl,
        n_objs2, n_props))
    win = C.pmax(mesh, [t[0] for t in tables])
    cnt = C.psum(mesh, [t[1] for t in tables])
    got = C.per_shard(mesh, lambda i, d: winners_gather(
        cols[d]["action"], cols[d]["insert"], cols[d]["elem_ref"],
        cols[d]["obj_dense"], cols[d]["prop"], cols[d]["width"], win[d], cnt[d],
        i * Pl, Pl, n_objs2, n_props))
    winner = C.all_gather(mesh, [g[0] for g in got])
    conflicts = C.all_gather(mesh, [g[1] for g in got])
    stats = C.psum(mesh, [g[2] for g in got])
    for d in mesh.distinct:
        out[d].update(winner=winner[d], conflicts=conflicts[d],
                      obj_vis_len=stats[d][0], obj_text_width=stats[d][1])


# the doubling loops: (range kernel, rounds entry) of ``linearize``
THREAD = (L.linearize_thread, L.linearize_thread_rounds)
RANK = (L.linearize_rank, L.linearize_rank_rounds)


def rank_from_thread(P: int):
    """The row arm's rank loop, started from the thread loop's answers
    (state ``(fc_e, ans)`` of P rows) where the reference builds the
    ranking state between the loops: (range kernel, rounds entry, first
    round's range kernel). Its first round reads ``fc_e`` and ``ans`` in
    place of the state; the later rounds are ``RANK``'s."""
    return (L.linearize_rank,
            lambda fc_e, ans, rounds: L.linearize_rank_from_thread(
                fc_e, ans, P, rounds),
            lambda fc_e, ans, i0, count, out: L.linearize_rank_first(
                fc_e, ans, P, i0, count, out=out))


def _doubling(mesh, loop, state, length: int, rounds: int):
    """``rounds`` rounds of ``loop`` (``THREAD``, ``RANK`` or
    ``rank_from_thread(P)``): each round every shard advances its slice
    of ``length`` nodes of the replicated state, and an all_gather per
    array re-replicates it. Where every shard sits on one device the
    slices tile the state: the loop's rounds entry runs it whole in one
    call, and the gathers move nothing; over distinct devices,
    ``_exchange`` (with the loop's first round's range kernel, where it
    has one)."""
    if len(mesh.distinct) > 1:
        return _exchange(mesh, loop[0], state, length, rounds, *loop[2:])
    (d,) = mesh.distinct
    arrays = tuple(s[d] for s in state)
    out = loop[1](*arrays, rounds)
    for _ in range(rounds):
        for a in arrays:
            C.note_gather(mesh, length, a.element_size())
    return tuple({d: o} for o in out)


def _exchange(mesh, step, state, length: int, rounds: int, first=None):
    """``rounds`` rounds of the range kernel ``step`` over the mesh's
    devices (the first round ``first``'s, when given): two full-size
    buffers per array on each device, allocated once; each round every
    run of consecutive shards on one device is one launch writing into
    that device's next buffer at its offset, and ``all_gather_into``
    copies in the other devices' slices."""
    bufs = [{d: tuple(torch.empty_like(s[d]) for s in state) for d in mesh.distinct}
            for _ in range(min(rounds, 2))]
    cur = {d: tuple(s[d] for s in state) for d in mesh.distinct}
    for r in range(rounds):
        nxt = bufs[r % 2]
        kernel = first if r == 0 and first is not None else step
        for d, first_shard, count in mesh.runs:
            i0, n = first_shard * length, count * length
            kernel(*cur[d], i0, n, out=tuple(b[i0:i0 + n] for b in nxt[d]))
        for k in range(len(state)):
            C.all_gather_into(mesh, {d: nxt[d][k] for d in mesh.distinct}, length)
        cur = nxt
    return tuple({d: cur[d][k] for d in mesh.distinct} for k in range(len(state)))


def _sharded_linearize(mesh, cols, out, Pl):
    """Document order over the element nodes (``_sharded_linearize``,
    :166): E = P + 1 does not divide over n, so the node space is padded
    to Epad = n (Pl + 1) with fixed points of both loops. The rank loop
    starts from the thread loop's answers (``rank_from_thread``): nothing
    is built between the loops."""
    P = Pl * mesh.size
    El = Pl + 1
    rounds = L.rounds(P)
    init = {d: L.linearize_init(out[d]["first_child"], out[d]["next_sib"],
                                out[d]["is_elem"], cols[d]["elem_ref"],
                                mesh.size * El) for d in mesh.distinct}
    state = tuple({d: init[d][k] for d in mesh.distinct} for k in range(3))
    ans, _, _ = _doubling(mesh, THREAD, state, El, rounds)
    fc_e = {d: init[d][3] for d in mesh.distinct}
    dist, _ = _doubling(mesh, rank_from_thread(P), (fc_e, ans), El, rounds)
    return {d: L.linearize_final(out[d]["first_child"], out[d]["is_elem"],
                                 cols[d]["obj_dense"], dist[d], 0, P)
            for d in mesh.distinct}


def _sharded_linearize_condensed(mesh, cols, cond, Pl, Rl):
    """Document order over the chain-condensed forest
    (``_sharded_linearize_condensed``, :255): the climb and the ranking
    over R2 chain slots (O(R) per all_gather), then the rows' expansion
    and one all_gather of O(P) values (``_expand``)."""
    R2 = Rl * mesh.size
    rounds = L.ceil_log2(R2) + 1
    init = {d: cond_init(cond[d]["centry"], cond[d]["cpar"]) for d in mesh.distinct}
    state = tuple({d: init[d][k] for d in mesh.distinct} for k in range(3))
    ans, _, _ = _doubling(mesh, THREAD, state, Rl, rounds)
    succ = {d: cond_succ(cond[d]["tail_ans"], ans[d], cond[d]["chain_id"],
                         cond[d]["clen"]) for d in mesh.distinct}
    state = tuple({d: succ[d][k] for d in mesh.distinct} for k in range(2))
    cdist, _ = _doubling(mesh, RANK, state, Rl, rounds)
    return _expand(mesh, cols, cond, cdist, Pl)


def _expand(mesh, cols, cond, cdist, Pl):
    """The element ranks of every row, replicated: the shards' expansions
    and the reference's one all_gather of them (:320-334). Where every
    shard sits on one device, one ``cond_expand`` over all P rows writes
    the replicated result and the gather moves nothing; over distinct
    devices each run of shards on one device is one launch into that
    device's full buffer at its offset, and ``all_gather_into`` copies
    in the other devices' slices."""

    def expand(d, r0, count, out=None):
        return cond_expand(cond[d]["chain_id"], cond[d]["offset"],
                           cols[d]["obj_dense"], cols[d]["insert"],
                           cols[d]["action"], cond[d]["start_chain"], cdist[d],
                           r0, count, out=out)

    if len(mesh.distinct) == 1:
        (d,) = mesh.distinct
        elem = expand(d, 0, mesh.size * Pl)
        C.note_gather(mesh, Pl, elem.element_size())
        return {d: elem}
    full = {d: torch.empty(mesh.size * Pl, dtype=torch.int32, device=d)
            for d in mesh.distinct}
    for d, first, count in mesh.runs:
        r0, n = first * Pl, count * Pl
        expand(d, r0, n, out=full[d][r0:r0 + n])
    C.all_gather_into(mesh, full, Pl)
    return full


def _sharded_merge(mesh, cols, preds, Pl, n_objs2, n_props, cond=None, Rl=0):
    """Every phase over the mesh (``_sharded_merge``, :338): the 13
    ``ALL_OUTPUTS`` replicated, {device: {name: tensor}}."""
    acc = C.psum(mesh, C.per_shard(mesh, lambda i, d: succ_partial(
        cols[d]["action"], cols[d]["value_i32"], cols[d]["covered"], *preds[i])))
    out = {}
    for d in mesh.distinct:
        c = cols[d]
        out[d] = {
            "succ_count": acc[d][0], "inc_count": acc[d][1],
            "counter_inc": acc[d][2],
            "visible": visibility(c["action"], c["value_tag"], c["covered"],
                                  acc[d][0], acc[d][1]),
        }
    if sharded_gate(Pl * mesh.size, n_objs2, n_props):
        _sharded_winners(mesh, cols, out, Pl, n_objs2, max(n_props, 1))
    else:
        # the group table is too large for the dense gid space: the
        # sort-based winners, replicated
        for d in mesh.distinct:
            c = cols[d]
            w = sort_winners(c["action"], c["insert"], c["elem_ref"],
                             c["obj_dense"], c["prop"], c["width"],
                             out[d]["visible"])
            out[d].update(zip(("winner", "conflicts", "obj_vis_len",
                               "obj_text_width"), w))
    for d in mesh.distinct:
        c = cols[d]
        out[d].update(zip(("is_elem", "parent_row", "first_child", "next_sib"),
                          forest(c["action"], c["insert"], c["elem_ref"],
                                 c["obj_dense"])))
    if cond is not None:
        elem = _sharded_linearize_condensed(mesh, cols, cond, Pl, Rl)
    else:
        elem = _sharded_linearize(mesh, cols, out, Pl)
    for d in mesh.distinct:
        out[d]["elem_index"] = elem[d]
    return out


def _pad_to_multiple(a: np.ndarray, m: int, fill) -> np.ndarray:
    r = (-len(a)) % m
    if r == 0:
        return a
    return np.concatenate([a, np.full(r, fill, dtype=a.dtype)])


def _pad_exact(a: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full(size, fill, np.int32)
    out[: len(a)] = a
    return out


def _next_pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def condense_host(cols_np, n_objs2: int, n_shards: int):
    """Host chain condensation feeding the condensed arm
    (``condense_host``, :484): the sibling forest (``host_forest``)
    collapsed by ``chain_condense``. Returns (R2, tables): the chain
    tables padded to R2 slots, a power of two above R rounded up to a
    multiple of ``n_shards``, the last slot the list-end sentinel."""
    insert, parent_row, first_child, next_sib = host_forest(cols_np)
    P = len(insert)
    R, cond = chain_condense(first_child, next_sib, parent_row, insert, P, n_objs2)
    # strictly > R so the last slot is free for the sentinel, and a
    # multiple of n_shards so the shards' slices tile exactly
    R2 = max(_next_pow2(R + 1), 2)
    R2 = -(-R2 // n_shards) * n_shards
    return R2, {
        "chain_id": cond["chain_id"],
        "offset": cond["offset"],
        "tail_ans": _pad_exact(cond["tail_ans"], R2, -1),
        "cpar": _pad_exact(cond["cpar"], R2, -1),
        "centry": _pad_exact(cond["centry"], R2, -1),
        "clen": _pad_exact(cond["len"], R2, 0),
        "start_chain": cond["start_chain"],
    }


def _run(mesh: Mesh, cols_np, n_objs2: int, n_props: int, transport: str,
         linearize: str):
    """The sharded merge of padded numpy columns: the 13 outputs on the
    mesh's first device."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, not {transport!r}")
    if linearize not in LINEARIZE:
        raise ValueError(f"linearize must be one of {LINEARIZE}, not {linearize!r}")
    n = mesh.size
    cols_np = {k: np.asarray(cols_np[k]) for k in COLUMN_SPECS}
    cols_np["pred_src"] = _pad_to_multiple(cols_np["pred_src"], n, 0)
    cols_np["pred_tgt"] = _pad_to_multiple(cols_np["pred_tgt"], n, -1)
    P = len(cols_np["action"])
    if P % n:
        raise ValueError(
            f"row capacity {P} must divide evenly over {n} shards "
            "(padded_columns capacities are powers of two / 8k multiples)")
    Pl = P // n
    Q = len(cols_np["pred_src"])
    Ql = Q // n
    R2, cond_np = 0, None
    if linearize == "condensed":
        with obs.span("parallel.condense", rows=P):
            R2, cond_np = condense_host(cols_np, n_objs2, n)
    with obs.span("parallel.h2d", rows=P):
        if transport == "packed":
            # the run tables decoded on each device, the pred stream sliced
            # per shard from the decoded columns
            static_key, arrays = encode_transport(cols_np)
            cols = C.replicate(mesh, lambda d: _unpack_transport(
                static_key, {k: torch.from_numpy(v).to(d)
                             for k, v in arrays.items()},
                P, Q))
            preds = C.per_shard(mesh, lambda i, d: tuple(
                cols[d][k][i * Ql:(i + 1) * Ql] for k in ("pred_src", "pred_tgt")))
        else:
            rep = {k: v for k, v in cols_np.items() if COLUMN_SPECS[k] == REPLICATED}
            cols = C.replicate(mesh, lambda d: columns_from_numpy(rep, d))
            preds = C.per_shard(mesh, lambda i, d: tuple(
                torch.from_numpy(np.ascontiguousarray(
                    cols_np[k][i * Ql:(i + 1) * Ql], np.int32)).to(d)
                for k in ("pred_src", "pred_tgt")))
        cond = (C.replicate(mesh, lambda d: {k: torch.from_numpy(cond_np[k]).to(d)
                                             for k in _COND_KEYS})
                if cond_np is not None else None)
    with obs.span("parallel.kernel", rows=P, devices=n), \
            _prof.annotate("amtpu.sharded_launch"):
        out = _sharded_merge(mesh, cols, preds, Pl, n_objs2, n_props, cond, R2 // n)
    return out[mesh.distinct[0]]


def make_sharded_merge(mesh: Mesh, n_objs2: Optional[int] = None,
                       n_props: Optional[int] = None, linearize: str = "condensed"):
    """A sharded merge over ``mesh`` (``make_sharded_merge``, :450): a
    callable of padded numpy columns returning the 13 ``ALL_OUTPUTS``
    as tensors on the mesh's first device. Without ``n_objs2``/``n_props``
    the defaults (P + 2, P) send map groups through the sort-based
    winners, as the reference's do."""
    def run(cols):
        P = len(cols["action"])
        no2 = n_objs2 if n_objs2 is not None else P + 2
        np_ = n_props if n_props is not None else P
        return _run(mesh, cols, no2, np_, "dict", linearize)

    return run


def sharded_merge_columns(cols_np, mesh: Optional[Mesh] = None,
                          n_objs: Optional[int] = None,
                          n_props: Optional[int] = None, transport: str = "dict",
                          linearize: str = "condensed"):
    """Host entry (``sharded_merge_columns``, :524): padded numpy columns
    in, the 13 ``ALL_OUTPUTS`` as numpy arrays out, merged over ``mesh``
    (default: every CUDA card).

    ``n_objs``/``n_props`` (the log's object and map-key counts) size the
    dense group table; absent, conservative defaults send map groups
    through the sort-based winners. ``transport="packed"`` ships the
    columns as run tables, decoded on each device. ``linearize``:
    ``"condensed"`` (default; chain tables condensed on the host) or
    ``"rows"`` (the doubling over every element node)."""
    mesh = mesh or default_mesh()
    P = len(cols_np["action"])
    n_objs2 = n_objs + 2 if n_objs is not None else P + 2
    np_eff = n_props if n_props is not None else P
    obs.count("device.kernel_launches", labels={"path": "sharded"})
    _prof.note("launches")
    out = _run(mesh, cols_np, n_objs2, np_eff, transport, linearize)
    with obs.span("parallel.readback", rows=P):
        return {k: out[k].cpu().numpy() for k in ALL_OUTPUTS}
