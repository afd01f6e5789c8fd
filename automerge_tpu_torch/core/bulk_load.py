"""Bulk op-store rebuild and stale reads, with document order from the
merge kernels.

Incremental per-op apply (op_store.insert_op) is ideal for small remote
batches, but a large catch-up (sync with a long-divergent peer, an N-way
merge) degenerates in Python: the RGA sibling skip scan
(op_store.py, mirroring reference op_tree.rs:212-239) touches every
concurrent chain at an anchor per insert. The bulk path instead:

  1. flattens the ENTIRE history (old + new changes) into packed-id arrays
     with the native batch column decoder,
  2. runs one merge of the whole history on the document's device
     (ops/merge.merge_columns: the succ/visibility, winner, forest and
     linearize kernels) for every sequence object's element order,
  3. recomputes succ lists / visibility / map runs vectorized in numpy,
  4. assembles fresh OpStore structures in one linear pass.

Same output as replaying insert_op per op, asserted by the differential
tests. A read-only consumer of a bulk apply never builds the store:
``stale_read_state`` / ``stale_text`` answer text reads straight from one
merge's outputs. Linearization is on the device at every size; a failure
of the kernels or of the native library propagates to the caller.
(The reference, ``automerge_tpu/core/bulk_load.py``, also has a host
sequential integrate it picks below a size gate, and falls back to it and
to a per-op flatten on any exception; the port has neither.)
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..types import Action, ActorId, ObjType, ScalarValue, objtype_for_action
from .op_store import Element, MapObject, ObjInfo, Op, OpStore, SeqObject

from ..errors import AutomergeError
from ..types import ACTOR_BITS  # shared packed-id layout


class MalformedHistory(AutomergeError):
    """The rebuild's structural validation refused the history (an op on a
    missing object, a key of the wrong kind for its object, an update of a
    missing element). The document replays it per op instead
    (``Document._rebuild_slow``), which raises the precise error."""


def flatten_changes(changes: Sequence) -> Dict[str, object]:
    """Flatten StoredChanges (in order) into packed-id arrays.

    Ids pack as (counter << 20 | byte-sorted actor rank) so int64 order is
    lamport_cmp (types.rs:517-521). Built from the native batch column
    decoder's per-change caches (``_flatten_fast``); ``_flatten_slow``, the
    per-op walk, is the oracle the tests hold it to."""
    return _flatten_fast(changes)


def _flatten_fast(changes: Sequence) -> Dict[str, object]:
    """Vectorized flatten via the commit-time ChangeCols caches
    (ops/assemble.ranked_from_caches): changes decoded once per object
    lifetime, flattened with numpy concats + rank gathers."""
    from ..ops.assemble import ranked_from_caches

    actor_bytes = sorted({bytes(a) for ch in changes for a in ch.actors})
    rank_of = {a: i for i, a in enumerate(actor_bytes)}
    if len(actor_bytes) >= (1 << ACTOR_BITS):
        raise ValueError("too many actors for packed id encoding")

    r = ranked_from_caches(list(changes), rank_of)
    a = r["a"]
    return {
        "op_id": r["id_key"].astype(np.int64),
        "obj": r["obj"].astype(np.int64),
        "elem": r["elem"].astype(np.int64),
        "prop": np.where(r["prop_ids"] >= 0, 0, -1).astype(np.int32),
        "action": a["action"].astype(np.int32),
        "insert": a["insert"].astype(np.uint8),
        "is_counter": (a["vcode"] == 8).astype(np.uint8),
        "pred_off": np.concatenate([[0], np.cumsum(a["pred_num"])]).astype(np.int64),
        "pred_flat": r["pred_key"].astype(np.int64),
        "rank_of": rank_of,
        # full ranked batch: lets the rebuild construct store Ops straight
        # from arrays instead of materializing ChangeOp objects
        "rb": r,
    }


def _flatten_slow(changes: Sequence) -> Dict[str, object]:
    """The per-op walk of ``flatten_changes`` (its oracle)."""
    actor_bytes = sorted({bytes(a) for ch in changes for a in ch.actors})
    rank_of = {a: i for i, a in enumerate(actor_bytes)}
    if len(actor_bytes) >= (1 << ACTOR_BITS):
        raise ValueError("too many actors for packed id encoding")

    op_id, obj, elem, prop_l, action, insert, is_counter = [], [], [], [], [], [], []
    pred_off, pred_flat = [0], []
    for ch in changes:
        ranks = [rank_of[bytes(a)] for a in ch.actors]
        author = ranks[0]
        for i, cop in enumerate(ch.ops):
            op_id.append(((ch.start_op + i) << ACTOR_BITS) | author)
            obj.append(
                0 if cop.obj[0] == 0 else (cop.obj[0] << ACTOR_BITS) | ranks[cop.obj[1]]
            )
            if cop.key.prop is not None:
                prop_l.append(0)
                elem.append(-1)
            else:
                prop_l.append(-1)
                e = cop.key.elem
                elem.append(0 if e[0] == 0 else (e[0] << ACTOR_BITS) | ranks[e[1]])
            action.append(int(cop.action))
            insert.append(1 if cop.insert else 0)
            is_counter.append(1 if cop.value.tag == "counter" else 0)
            for pc, pa in cop.pred:
                pred_flat.append((pc << ACTOR_BITS) | ranks[pa])
            pred_off.append(len(pred_flat))
    return {
        "op_id": np.asarray(op_id, np.int64),
        "obj": np.asarray(obj, np.int64),
        "elem": np.asarray(elem, np.int64),
        "prop": np.asarray(prop_l, np.int32),
        "action": np.asarray(action, np.int32),
        "insert": np.asarray(insert, np.uint8),
        "is_counter": np.asarray(is_counter, np.uint8),
        "pred_off": np.asarray(pred_off, np.int64),
        "pred_flat": np.asarray(pred_flat, np.int64),
        "rank_of": rank_of,
    }


def _export_via_device(log, elem_index, flat):
    """Per-object element order from a merge of the history: ``log`` is
    the history's OpLog, ``elem_index`` the merge's.

    The merge's ``elem_index`` IS the document order, for every insert op
    including tombstones, so it feeds the (obj_keys, obj_off, elem_rows)
    contract. flatten_changes and ops/oplog.py share the byte-rank id
    packing, so rows translate with one searchsorted; the two are separate
    extractions of the history (the log Lamport-ordered, ``flat`` in
    change order), so their op counts and ids are checked to agree.
    """
    if log.n != len(flat["op_id"]):
        raise ValueError("device export: op count mismatch with flat history")
    elem_index = np.asarray(elem_index[: log.n])

    flat_pos = np.argsort(flat["op_id"], kind="stable")
    sorted_flat = flat["op_id"][flat_pos]
    pos = np.searchsorted(sorted_flat, log.id_key)
    pos = np.clip(pos, 0, max(len(sorted_flat) - 1, 0))
    if len(sorted_flat) == 0 or not np.array_equal(sorted_flat[pos], log.id_key):
        raise ValueError("device export: id mismatch with flat history")
    flat_rows = flat_pos[pos]

    rows = np.flatnonzero(log.insert & (elem_index >= 0))
    order = np.lexsort((elem_index[rows], log.obj_key[rows]))
    rows = rows[order]
    obj_of = log.obj_key[rows]
    bnd = (
        np.flatnonzero(np.concatenate([[True], obj_of[1:] != obj_of[:-1]]))
        if len(rows)
        else np.empty(0, np.int64)
    )
    obj_keys = obj_of[bnd].astype(np.int64)
    obj_off = np.concatenate([bnd, [len(rows)]]).astype(np.int64)
    elem_rows = flat_rows[rows].astype(np.int32)
    return obj_keys, obj_off, elem_rows


_INT_TAG = {3: "uint", 4: "int", 8: "counter", 9: "timestamp"}


def _build_ops_from_arrays(doc, flat, ops, objs_of, sort_key) -> None:
    """Array-driven store-Op construction: straight from the ranked batch
    columns (no ChangeOp materialization). Value semantics match
    storage/values decoding exactly — common codes inline, everything
    else through _decode_one."""
    from ..storage.values import _decode_one

    rb = flat["rb"]
    a = rb["a"]
    n = len(flat["op_id"])
    mask = (1 << ACTOR_BITS) - 1
    rank_of = flat["rank_of"]
    rank_bytes = sorted(rank_of, key=rank_of.get)
    r2g = [doc.actors.cache(ActorId(b)) for b in rank_bytes]
    key_g = [doc.props.cache(s) for s in a["key_table"]]
    mark_tab = a["mark_table"]

    op_id = flat["op_id"]
    id_ctr = (op_id >> ACTOR_BITS).tolist()
    id_a = [r2g[x] for x in (op_id & mask).tolist()]
    obj_l = flat["obj"].tolist()
    elem_l = flat["elem"].tolist()
    prop_l = rb["prop_ids"].tolist()
    action_l = flat["action"].tolist()
    insert_l = a["insert"].tolist()
    expand_l = a["expand"].tolist()
    mark_l = (
        a["mark_ids"].tolist() if a["mark_ids"] is not None else [-1] * n
    )
    vcode_l = a["vcode"].tolist()
    voff_l = a["voff"].tolist()
    vlen_l = a["vlen"].tolist()
    vint_l = a["value_int"].tolist()
    raw = a["vraw"]
    pred_num = a["pred_num"].tolist()
    pf = flat["pred_flat"]
    pf_ctr = (pf >> ACTOR_BITS).tolist()
    pf_a = [r2g[x] for x in (pf & mask).tolist()]

    NULL_V = ScalarValue("null")
    TRUE_V = ScalarValue("bool", True)
    FALSE_V = ScalarValue("bool", False)
    HEAD_T = (0, 0)
    ROOT_T = (0, 0)
    _new = Op.__new__
    pv = 0
    for i in range(n):
        code = vcode_l[i]
        if code == 6:
            o = voff_l[i]
            v = ScalarValue("str", raw[o : o + vlen_l[i]].decode("utf-8"))
        elif code == 0:
            v = NULL_V
        elif code == 3 or code == 4 or code == 8 or code == 9:
            # the native decoder wraps values outside i64 (uint >= 2^63,
            # overlong LEBs): re-decode those few through the exact path
            if (code == 3 and vint_l[i] < 0) or vlen_l[i] >= 10:
                o = voff_l[i]
                v = _decode_one(code, raw[o : o + vlen_l[i]])
            else:
                v = ScalarValue(_INT_TAG[code], vint_l[i])
        elif code == 2:
            v = TRUE_V
        elif code == 1:
            v = FALSE_V
        else:
            o = voff_l[i]
            v = _decode_one(code, raw[o : o + vlen_l[i]])
        op = _new(Op)
        op.id = (id_ctr[i], id_a[i])
        op.action = action_l[i]
        p = prop_l[i]
        if p >= 0:
            op.key = key_g[p]
            op.elem = None
        else:
            op.key = None
            e = elem_l[i]
            op.elem = HEAD_T if e == 0 else (e >> ACTOR_BITS, r2g[e & mask])
        op.insert = insert_l[i]
        op.value = v
        k = pred_num[i]
        if k == 0:
            op.pred = []
        elif k == 1:
            op.pred = [(pf_ctr[pv], pf_a[pv])]
        else:
            pr = [(pf_ctr[pv + j], pf_a[pv + j]) for j in range(k)]
            pr.sort(key=sort_key)
            op.pred = pr
        pv += k
        op.succ = []
        op.incs = []
        m = mark_l[i]
        op.mark_name = mark_tab[m] if m >= 0 else None
        op.expand = expand_l[i]
        ops[i] = op
        ob = obj_l[i]
        objs_of[i] = ROOT_T if ob == 0 else (ob >> ACTOR_BITS, r2g[ob & mask])


def rebuild_op_store(doc) -> None:
    """Rebuild ``doc.ops`` from the full applied history. Element order
    comes from one merge of the history on ``doc.device``.
    Replaces the store wholesale; the document's history / change graph /
    actor caches are untouched.

    Cyclic GC is paused for the build: it allocates millions of small
    objects and a generational collection mid-build walks every live one
    (measured ~2.4x on a 260k-op rebuild). Nothing in here creates
    garbage cycles — the element list's cycles stay live in the store.
    """
    import gc

    gc_was = gc.isenabled()
    if gc_was:
        gc.disable()
    try:
        _rebuild_op_store(doc)
    finally:
        if gc_was:
            gc.enable()


def _seq_export(doc, flat):
    """(obj_keys, obj_off, elem_rows): every sequence object's element
    order, from the document's merge of its history
    (``Document._history_merge``, on ``doc.device``; shared with the stale
    reads and the save at this history length). ``flat`` is
    ``flatten_changes`` of the history."""
    memo = doc._history_merge()
    return _export_via_device(memo["log"], memo["res"]["elem_index"], flat)


def _row_visibility(flat):
    """Vectorized per-row current-state visibility (Op.visible batched).

    Returns (vis, src_rows, tgt_rows): vis[i] = row i is a visible winner
    candidate; src/tgt are the resolved pred-edge endpoints (source op row,
    predecessor-target op row) for succ-list construction."""
    ids = flat["op_id"]
    n = len(ids)
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]

    pred_counts = np.diff(flat["pred_off"])
    src_rows = np.repeat(np.arange(n, dtype=np.int64), pred_counts)
    if len(flat["pred_flat"]):
        pos = np.searchsorted(sorted_ids, flat["pred_flat"])
        posc = np.clip(pos, 0, max(n - 1, 0))
        hit = sorted_ids[posc] == flat["pred_flat"] if n else np.zeros(0, bool)
        tgt_rows = np.where(hit, order[posc], -1)
    else:
        tgt_rows = np.empty(0, np.int64)
    okm = tgt_rows >= 0
    src_rows, tgt_rows = src_rows[okm], tgt_rows[okm]

    act = flat["action"]
    succ_n = np.zeros(n, np.int64)
    inc_n = np.zeros(n, np.int64)
    if len(tgt_rows):
        np.add.at(succ_n, tgt_rows, 1)
        inc_edge = (act[src_rows] == int(Action.INCREMENT)) & (
            (act[tgt_rows] == int(Action.PUT)) & (flat["is_counter"][tgt_rows] != 0)
        )
        if inc_edge.any():
            np.add.at(inc_n, tgt_rows[inc_edge], 1)
    counter_row = (act == int(Action.PUT)) & (flat["is_counter"] != 0)
    never = np.isin(act, (int(Action.DELETE), int(Action.INCREMENT), int(Action.MARK)))
    vis = ~never & np.where(counter_row, succ_n <= inc_n, succ_n == 0)
    return vis, src_rows, tgt_rows


def stale_read_state(doc):
    """Shared intermediates for every stale read at one history length:
    the Document's memoised merge of its history
    (``Document._history_merge``: one OpLog extraction + one merge on
    ``doc.device``, shared with the rebuild and the save at that length),
    so N object reads pay one history pass, not N. None when the array
    path cannot serve (an empty history, or a log whose values are an
    eager list).

    The merge supplies element order, winners and visibility together:
    the same kernels the fan-in merge runs."""
    if not doc.history:
        return None
    memo = doc._history_merge()
    if not hasattr(memo["log"].values, "code"):
        # eager-list values (per-op extraction fallback): no value heap to
        # gather from; let the materialized store answer
        return None
    return memo


def stale_text(doc, obj_exid: str, state):
    """Current-state text of one object straight from the merge outputs,
    with no op-store materialization. None when this path cannot serve
    (the root, a map, an unknown object): the caller reads the
    materialized store, which raises the store's own error.

    This is the sync-consumer read path: a replica that catches up over
    the wire and is only *read* never pays the Python object build; the
    store materializes lazily on the first local edit (the same
    history-is-source-of-truth stance as Document._materialize_ops)."""
    log, res = state["log"], state["res"]
    try:
        qkey = log.import_id(obj_exid)
    except (KeyError, ValueError):
        return None
    if qkey == 0:
        return None  # root is a map

    # only sequence objects read as text; maps/tables fall back so the
    # store raises the same typed error it would when materialized
    n = log.n
    mk = int(np.searchsorted(log.id_key, qkey))
    if mk >= n or int(log.id_key[mk]) != qkey or int(log.action[mk]) not in (2, 4):
        return None  # unknown object, or not MAKE_LIST/MAKE_TEXT

    # element rows of this object in document order; each element's
    # current value is its merge-group winner (insert overridden by the
    # last visible update — res["winner"] already encodes TopOps)
    from ..ops.device_doc import order_elem_rows

    obj_rows = np.flatnonzero(log.obj_key == qkey)
    erows = order_elem_rows(log, res["elem_index"][:n], obj_rows)
    win = res["winner"][:n][erows]
    sel = win[win >= 0].astype(np.int64)
    vals = log.values
    vc = np.asarray(vals.code)[sel]
    off = np.asarray(vals.off)[sel].astype(np.int64)
    ln = np.asarray(vals.ln)[sel].astype(np.int64)
    raw = vals.raw
    if len(sel) == 0:
        return ""
    if bool((vc == 6).all()):
        # pure-string text (the overwhelmingly common case): gather every
        # value slice with one flat index build + one utf-8 decode instead
        # of a per-element python loop
        tot = int(ln.sum())
        if tot == 0:
            return ""
        base = np.concatenate([[0], np.cumsum(ln)[:-1]])
        idx = np.arange(tot, dtype=np.int64) + np.repeat(off - base, ln)
        return np.frombuffer(raw, np.uint8)[idx].tobytes().decode("utf-8")
    vcl, offl, lnl = vc.tolist(), off.tolist(), ln.tolist()
    parts = []
    for i in range(len(vcl)):
        if vcl[i] == 6:
            o = offl[i]
            parts.append(raw[o : o + lnl[i]].decode("utf-8"))
        else:
            parts.append("￼")
    return "".join(parts)


def _rebuild_op_store(doc) -> None:
    stored = [a.stored for a in doc.history]
    flat = flatten_changes(stored)
    obj_keys, obj_off, elem_rows = _seq_export(doc, flat)

    # ---- build Op objects (linear pass over change ops) -------------------
    n = len(flat["op_id"])
    ops: List[Op] = [None] * n
    objs_of: List[Tuple[int, int]] = [None] * n  # (obj ctr, obj doc-idx)
    sort_key = doc._ops.lamport_key  # direct: doc.ops may be mid-rebuild
    _build_ops_from_arrays(doc, flat, ops, objs_of, sort_key)

    ids = flat["op_id"]

    # ---- succ lists / counter incs + visibility (vectorized) --------------
    vis, src_rows, tgt_rows = _row_visibility(flat)
    edge_order = np.lexsort((ids[src_rows], tgt_rows))
    for k in edge_order:
        s, t = ops[int(src_rows[k])], ops[int(tgt_rows[k])]
        t.succ.append(s.id)
        if s.is_inc and t.is_counter:
            t.incs.append((s.id, s.value.value))

    # ---- object registry --------------------------------------------------
    store = OpStore(doc.actors)
    make_rows = np.flatnonzero(np.isin(flat["action"], (0, 2, 4, 6)))
    for r in make_rows:
        op = ops[int(r)]
        t = objtype_for_action(op.action)
        data = (
            MapObject(t)
            if t in (ObjType.MAP, ObjType.TABLE)
            else SeqObject(t, store.actors)
        )
        parent_elem = op.id if op.insert else op.elem
        store.objects[op.id] = ObjInfo(data, objs_of[int(r)], op.key, parent_elem)

    # ---- structural validation (vectorized) -------------------------------
    # A map-keyed op must target a map object and a seq-keyed op a sequence
    # — the per-op path raises OpStoreError for these; the bulk rebuild must
    # fail loudly too, never silently drop the op (kind mismatch would
    # otherwise diverge from replicas applying the same change per-op).
    obj_arr = flat["obj"]
    kind_is_map = {0: True}  # packed obj key -> is-map (root is a map)
    for r in make_rows:
        t = objtype_for_action(int(flat["action"][r]))
        kind_is_map[int(flat["op_id"][r])] = t in (ObjType.MAP, ObjType.TABLE)
    is_map_key = flat["prop"] == 0
    kkeys = np.fromiter(kind_is_map.keys(), np.int64, len(kind_is_map))
    kvals = np.fromiter(
        (1 if v else 0 for v in kind_is_map.values()), np.int8, len(kind_is_map)
    )
    korder = np.argsort(kkeys)
    kkeys, kvals = kkeys[korder], kvals[korder]
    pos = np.clip(np.searchsorted(kkeys, obj_arr), 0, len(kkeys) - 1)
    if not np.array_equal(kkeys[pos], obj_arr):
        raise MalformedHistory("op targets unknown object")
    obj_map = kvals[pos].astype(bool)
    if np.any(obj_map & ~is_map_key):
        raise MalformedHistory("sequence-keyed op on a map object")
    if np.any(~obj_map & is_map_key):
        raise MalformedHistory("map-keyed op on a sequence object")

    # ---- map runs (ascending lamport per (obj, prop)) ---------------------
    is_map_op = flat["prop"] == 0
    map_rows = np.flatnonzero(is_map_op & (flat["action"] != int(Action.DELETE)))
    if len(map_rows):
        mr_sorted = map_rows[np.argsort(ids[map_rows], kind="stable")]
        for r in mr_sorted:
            r = int(r)
            op = ops[r]
            info = store.objects.get(objs_of[r])
            if info is None or not isinstance(info.data, MapObject):
                raise MalformedHistory("map op on missing/non-map object")
            info.data.props.setdefault(op.key, []).append(op)

    # ---- sequence elements (kernel order) + update runs -------------------
    elems_by_id: Dict[Tuple[int, int], Element] = {}
    for k in range(len(obj_keys)):
        okey = int(obj_keys[k])
        oid = (0, 0) if okey == 0 else _unpack(okey, flat["rank_of"], doc)
        info = store.objects.get(oid)
        if info is None or not isinstance(info.data, SeqObject):
            raise MalformedHistory("sequence export for missing/non-seq object")
        obj_data = info.data
        prev = obj_data.head
        for r in elem_rows[int(obj_off[k]) : int(obj_off[k + 1])]:
            r = int(r)
            op = ops[r]
            el = Element(op)
            # pre-seed the winner cache from the vectorized visibility —
            # rebuild_blocks then aggregates without recomputing runs
            el._wcache = (op,) if vis[r] else (None,)
            el.prev = prev
            prev.next = el
            prev = el
            obj_data.by_id[op.id] = el
            elems_by_id[op.id] = el
        obj_data.tail = prev
        # visible_len / text_width are filled by the visibility pass below

    seq_upd_rows = np.flatnonzero(
        (flat["prop"] != 0)
        & (flat["insert"] == 0)
        & (flat["action"] != int(Action.DELETE))
    )
    if len(seq_upd_rows):
        su_sorted = seq_upd_rows[np.argsort(ids[seq_upd_rows], kind="stable")]
        for r in su_sorted:
            r = int(r)
            op = ops[r]
            el = elems_by_id.get(op.elem)
            if el is None:
                raise MalformedHistory("seq update targets missing element")
            el.updates.append(op)
            if vis[r]:  # ascending Lamport: the last visible wins
                el._wcache = (op,)

    # ---- visibility counters + block index (one sweep) ---------------------
    for info in store.objects.values():
        data = info.data
        if isinstance(data, SeqObject):
            data.rebuild_blocks()

    doc.ops = store


def _unpack(key: int, rank_of: Dict[bytes, int], doc) -> Tuple[int, int]:
    ctr = key >> ACTOR_BITS
    rank = key & ((1 << ACTOR_BITS) - 1)
    for b, rk in rank_of.items():
        if rk == rank:
            return (ctr, doc.actors.cache(ActorId(b)))
    raise MalformedHistory("unknown actor rank in export")
