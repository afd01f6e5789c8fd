"""Vectorized cross-document host staging: columnar passes over many
documents' drained changes, each document in its own offset range.

The port of ``automerge_tpu/ops/host_batch.py``. Staging a drained delta
document by document (``OpLog.append_changes`` then
``DeviceDoc._apply_append``) is a few dozen small numpy calls a document,
whose overhead dwarfs the work at serving sizes. Here every document's
ready changes go through one set of shared passes:

* **pack**: one column extraction over every document's changes
  (``assemble.ranked_from_caches`` under a union actor table), then the
  packed (counter, actor rank) keys translated from the union's ranks to
  each document's with one flat lookup a key column;
* **sort**: ONE ``lexsort`` over (document, op id) puts every delta in
  Lamport order at once, and the duplicate and tail checks run as shared
  vector passes;
* **splice**: per document, a tail append specialised by column kind
  (payload, packed-key, row-reference and string-table columns), with row
  references resolved through the id join, and the resolution-array
  bookkeeping of ``DeviceDoc._apply_append`` in the same form.

A document takes the fast path only when its assumptions hold: a resident
log with column bytes kept (``LazyValues``), no unresolved reference
(``OpLog.n_miss_elem`` / ``n_miss_pred``), a strict tail in Lamport
order, an object table that only grows at its end. Any other document is
staged by ``DeviceDoc.stage_ready``, the scalar path and the oracle of
this one; ``stage_docs(work, vectorized=False)`` stages every document
that way.

The id join is offset-value-coded where it can be: with compressed
residency on (``compressed.ENABLED``) and no new actor, the delta's ids
extend the log's compressed id runs and the row references are joined
over the R run heads (``StrideRuns.join``); otherwise, or once the id
runs are demoted, through the native ``join_rows``. A tail write never
moves the resident prefix, so the rest of the compressed image stays
valid and extends its last runs at the next sync; an actor-rank remap
drops it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..obs import prof as _prof
from ..types import ACTOR_BITS, Action, ActorId, objtype_for_action
from . import compressed as _C
from .device_doc import DIRTY_FRACTION_LIMIT, _parsed, _stage
from .extract import LazyValues
from .oplog import (
    ACTOR_MASK, ELEM_HEAD, ELEM_MAP, ELEM_MISSING, TAG_UNKNOWN, _capacity,
    _merge_table, join_rows,
)

# stage_docs' default: the vectorized staging (False: every document
# through the scalar DeviceDoc.stage_ready)
VECTORIZED = True


def enabled() -> bool:
    """Whether the cross-document callers stage through ``stage_docs``."""
    return VECTORIZED


def _tail_write(bufs: dict, name: str, old: np.ndarray, new, mm: int):
    """One tail write into a capacity-bucketed buffer: the tail fast path
    of ``OpLog._splice_col`` / ``DeviceDoc._res_splice`` with their
    generic machinery stripped, so the scalar path can keep splicing the
    same buffers afterwards. ``new`` is the appended values or a fill."""
    n = len(old)
    buf = bufs.get(name)
    if buf is not None and old.base is buf and len(buf) >= mm:
        buf[n:mm] = new
        return buf[:mm]
    nbuf = np.empty(_capacity(mm), old.dtype)
    nbuf[:n] = old
    nbuf[n:mm] = new
    bufs[name] = nbuf
    return nbuf[:mm]


class _DocPlan:
    """One document's slot in the shared staging pass."""

    __slots__ = (
        "dev", "ready", "label", "c0", "c1", "r0", "r1", "p0", "p1", "k",
        "rank_of", "all_bytes", "actors_changed",
    )

    def __init__(self, dev, ready, label=None):
        self.dev = dev
        self.ready = ready
        self.label = label
        self.c0 = self.c1 = self.r0 = self.r1 = self.p0 = self.p1 = 0
        self.k = 0
        # the document's actor universe after this delta: new actors
        # insert by byte rank, a monotone remap of the resident keys
        self.rank_of: Dict[bytes, int] = {}
        self.all_bytes: List[bytes] = []
        self.actors_changed = False


class DocResult:
    """One document's outcome of ``stage_docs``."""

    __slots__ = ("applied", "error", "vectorized")

    def __init__(self):
        self.applied = 0
        self.error: Optional[BaseException] = None
        self.vectorized = False


def _admit(dev, ready, label=None) -> Optional[_DocPlan]:
    """The fast path's admission: every assumption its splice relies on,
    checked before anything is touched. Returns the document's plan (with
    its actor universe) or None for the scalar path."""
    log = dev.log
    if log.n == 0 or log.n_miss_elem or log.n_miss_pred:
        return None
    if not isinstance(log.values, LazyValues):
        return None
    for ch in ready:
        if ch.op_col_data is None and ch.cached_cols is None:
            return None
    if not log._ensure_ref_keys():
        return None
    p = _DocPlan(dev, ready, label)
    old_rank = dev._rank_of
    delta_bytes = {bytes(a) for ch in ready for a in ch.actors}
    if delta_bytes <= old_rank.keys():
        p.rank_of = old_rank
        p.all_bytes = [a.bytes for a in log.actors]
    else:
        all_bytes = sorted(old_rank.keys() | delta_bytes)
        if len(all_bytes) >= (1 << ACTOR_BITS):
            return None
        p.all_bytes = all_bytes
        p.rank_of = {b: i for i, b in enumerate(all_bytes)}
        p.actors_changed = True
    return p


def _extract_all(plans: List[_DocPlan]):
    """One column extraction over every planned document's changes under a
    union actor table: ``(ranked columns, union actor bytes)``, or None
    when a change's columns are refused (counted as ``extract_error``; the
    documents then stage on the scalar path, nothing having been
    touched). Anything else raises, a missing native library included."""
    from . import batched
    from .assemble import AssembleError, ranked_from_caches

    changes = [ch for p in plans for ch in p.ready]
    g_bytes = sorted({bytes(a) for ch in changes for a in ch.actors})
    if len(g_bytes) >= (1 << ACTOR_BITS):
        return None
    g_rank = {b: i for i, b in enumerate(g_bytes)}
    try:
        r = ranked_from_caches(changes, g_rank)
    except (AssembleError, ValueError):
        batched.count("extract_error")
        return None
    return r, g_bytes


def _doc_string_table(ready, attr: str) -> List[str]:
    """First-occurrence union of one document's per-change string tables
    (the table ``ranked_from_caches`` builds for these changes alone)."""
    seen_tables = set()
    have = set()
    out: List[str] = []
    for ch in ready:
        t = getattr(ch.cached_cols, attr, None)
        if not t or id(t) in seen_tables:
            continue
        seen_tables.add(id(t))
        for s in t:
            if s not in have:
                have.add(s)
                out.append(s)
    return out


def _local_ids(g_ids, g_pos: Dict[str, int], doc_table: List[str],
               g_table_len: int) -> np.ndarray:
    """Union-table string ids as document-table ids (-1 stays -1)."""
    g2d = np.full(max(g_table_len, 1), -1, np.int32)
    for i, s in enumerate(doc_table):
        g2d[g_pos[s]] = i
    ids = np.asarray(g_ids)
    return np.where(ids >= 0, g2d[np.clip(ids, 0, None)], np.int32(-1)).astype(np.int32)


def stage_docs(work, vectorized: Optional[bool] = None, phases=None
               ) -> Tuple[List, Dict[int, DocResult]]:
    """Stage many documents' drained batches through shared passes.

    ``work``: ``(DeviceDoc, batches)`` pairs (a document listed twice
    merges into one staging). ``vectorized`` (default ``VECTORIZED``):
    False stages every document by the scalar ``DeviceDoc.stage_ready``.
    Returns ``(stages, results)``: the ``BatchStage``s to pack, and each
    document's ``DocResult`` by ``id(document)``. A document failing a
    fast-path assumption stages on the scalar path, bit for bit the same.

    Each call stands alone (its dedup, union actor table and offsets), so
    ``apply_cross_doc`` can stage chunk N+1 here while chunk N's launch is
    in flight. ``phases``, a dict when given, sums the seconds of
    ``dedup``, ``causal_order``, ``host_pack``, ``host_sort``,
    ``host_splice``, ``reresolve`` and ``scalar``."""
    from . import batched
    from .batched import BatchStage

    if vectorized is None:
        vectorized = VECTORIZED
    # dedup, causal order and admission: one span each for the whole drain
    with _stage(phases, "dedup"), obs.span(
            "device.stage.dedup", docs=len(work) if isinstance(work, list) else 0):
        merged: Dict[int, tuple] = {}
        order: List[int] = []
        for dev, batches in work:
            if dev._base is not dev:
                raise ValueError("stage_docs on a historical view; use the base doc")
            key = id(dev)
            if key in merged:
                merged[key][1].extend(batches)
            else:
                merged[key] = (dev, list(batches))
                order.append(key)
        results: Dict[int, DocResult] = {k: DocResult() for k in order}
        for key in order:
            dev, batches = merged[key]
            dev._dedup_into_pending(_parsed([ch for b in batches for ch in b]))
    vec: List[_DocPlan] = []
    scalar: List[tuple] = []  # (key, dev, ready, label)
    with _stage(phases, "causal_order"), obs.span(
            "device.stage.causal_order", docs=len(order)):
        for i, key in enumerate(order):
            dev = merged[key][0]
            ready = dev._drain_ready_pending()
            if not ready:
                continue
            label = getattr(dev, "obs_name", None) or f"doc{i}"
            plan = _admit(dev, ready, label) if vectorized else None
            if plan is not None:
                vec.append(plan)
                results[key].vectorized = True
            else:
                scalar.append((key, dev, ready, label))

    def demote(plans):
        for p in plans:
            results[id(p.dev)].vectorized = False
            scalar.append((id(p.dev), p.dev, p.ready, p.label))
        batched.count("demoted_docs", len(plans))

    stages: List = []
    pending_reresolve: List[tuple] = []  # (plan, dirty)
    g = None
    if vec:
        with _stage(phases, "host_pack"), obs.span("host.pack", docs=len(vec)):
            g = _pack_global(vec)
        if g is None:
            demote(vec)
            obs.count("host_batch.fallback_docs",
                      n=len(vec), labels={"reason": "extract"})
            vec = []
    if vec:
        with _stage(phases, "host_sort"), obs.span(
                "host.sort", rows=g["N"], docs=len(vec)):
            demoted = _sort_global(vec, g)
        demote(demoted)
        if demoted:
            obs.count("host_batch.fallback_docs",
                      n=len(demoted), labels={"reason": "order"})
        dem_ids = {id(p) for p in demoted}
        vec = [p for p in vec if id(p) not in dem_ids]
    if vec:
        rows_total = spliced = 0
        with _stage(phases, "host_splice"), obs.span("host.splice", docs=len(vec)):
            for p in vec:
                res = results[id(p.dev)]
                t0 = time.perf_counter()
                try:
                    outcome = _splice_doc(p, g)
                except Exception as e:  # noqa: BLE001 - isolate the document
                    res.error = e
                    obs.count("host_batch.fallback_docs",
                              labels={"reason": "error"})
                    continue
                finally:
                    _prof.note_doc(p.label, time.perf_counter() - t0)
                kind = outcome[0]
                if kind == "scalar":
                    # a check before any mutation failed: the scalar path takes it
                    demote([p])
                    continue
                res.applied = len(p.ready)
                rows_total += p.k
                spliced += 1
                if kind == "stage":
                    stages.append(BatchStage(p.dev, outcome[1], outcome[2]))
                elif kind == "reresolve":
                    pending_reresolve.append((p, outcome[1]))
        obs.count("oplog.append_rows", n=rows_total)
        obs.count("host_batch.docs", n=spliced)
        obs.event("host_batch.splice", docs=spliced, rows=rows_total)
    # the per-document device work runs outside the host spans, so its
    # kernel spans attribute to the device side of a cycle's split
    with _stage(phases, "reresolve"):
        for p, dirty in pending_reresolve:
            t0 = time.perf_counter()
            try:
                p.dev._reresolve(dirty)
                p.dev._export_doc_gauges()
            except Exception as e:  # noqa: BLE001 - isolate the document
                results[id(p.dev)].error = e
            _prof.note_doc(p.label, time.perf_counter() - t0)
    with _stage(phases, "scalar"):
        for key, dev, ready, label in scalar:
            res = results[key]
            t0 = time.perf_counter()
            try:
                res.applied, st = dev.stage_ready(ready)
                if st is not None:
                    stages.append(st)
            except Exception as e:  # noqa: BLE001 - isolate the document
                res.error = e
            _prof.note_doc(label, time.perf_counter() - t0)
    batched.count("vectorized_docs", sum(r.vectorized for r in results.values()))
    batched.count("scalar_docs", len(scalar))
    return stages, results


# -- the shared passes ----------------------------------------------------------


def _pack_global(plans: List[_DocPlan]):
    """Extraction and packed-key translation for every planned document:
    the shared arrays, or None when the extraction failed."""
    ext = _extract_all(plans)
    if ext is None:
        return None
    r, g_bytes = ext
    a = r["a"]
    N = int(a["n"])
    row_off = np.asarray(a["row_off"], np.int64)
    pred_off = np.asarray(a["pred_row_off"], np.int64)
    raw_off = np.asarray(a["raw_off"], np.int64)
    raw_ln = np.asarray(a["raw_ln"], np.int64)

    c = 0
    k_of = np.empty(len(plans), np.int64)
    q_of = np.empty(len(plans), np.int64)
    for di, p in enumerate(plans):
        p.c0, p.c1 = c, c + len(p.ready)
        c = p.c1
        p.r0, p.r1 = int(row_off[p.c0]), int(row_off[p.c1])
        p.p0, p.p1 = int(pred_off[p.c0]), int(pred_off[p.c1])
        p.k = p.r1 - p.r0
        k_of[di] = p.k
        q_of[di] = p.p1 - p.p0

    # union -> document actor ranks: one flat lookup, one gather a packed
    # key column. Rank order is byte order on both sides, so the union's
    # ranking restricted to a document's actors is the document's.
    G = max(len(g_bytes), 1)
    lut = np.zeros(len(plans) * G, np.int64)
    for di, p in enumerate(plans):
        base = di * G
        ro = p.rank_of
        for gi, b in enumerate(g_bytes):
            rk = ro.get(b)
            if rk is not None:
                lut[base + gi] = rk
    doc_of_row = np.repeat(np.arange(len(plans), dtype=np.int64), k_of)
    base_row = doc_of_row * G

    def translate(key):
        key = np.asarray(key, np.int64)
        idx = np.where(key > 0, key & ACTOR_MASK, 0)
        return np.where(key > 0,
                        ((key >> ACTOR_BITS) << ACTOR_BITS) | lut[base_row + idx],
                        key)

    pk = np.asarray(r["pred_key"], np.int64)
    if len(pk):
        doc_of_pred = np.repeat(np.arange(len(plans), dtype=np.int64), q_of)
        pk_t = ((pk >> ACTOR_BITS) << ACTOR_BITS) | lut[
            doc_of_pred * G + (pk & ACTOR_MASK)]
    else:
        pk_t = pk
    return {
        "N": N, "a": a, "r": r, "doc_of_row": doc_of_row,
        "id_t": translate(r["id_key"]), "obj_t": translate(r["obj"]),
        "elem_t": translate(r["elem"]), "pk_t": pk_t,
        "raw_off": raw_off, "raw_ln": raw_ln, "n_changes": c,
        "key_pos": {s: i for i, s in enumerate(a["key_table"] or [])},
        "mark_pos": {s: i for i, s in enumerate(a["mark_table"] or [])},
    }


def _sort_global(plans: List[_DocPlan], g) -> List[_DocPlan]:
    """One Lamport sort of every document's delta, the shared duplicate and
    tail checks, and every row column gathered into sorted order. Returns
    the plans demoted to the scalar path."""
    a = g["a"]
    N = g["N"]
    doc_of_row = g["doc_of_row"]
    order_g = np.lexsort((g["id_t"], doc_of_row))
    inv_g = np.empty(N, np.int64)
    inv_g[order_g] = np.arange(N, dtype=np.int64)
    id_s = g["id_t"][order_g]

    # an op id twice in one document's delta: the scalar path reports it
    bad = set()
    if N > 1:
        same = (doc_of_row[1:] == doc_of_row[:-1]) & (id_s[1:] == id_s[:-1])
        if np.any(same):
            bad.update(doc_of_row[1:][same].tolist())

    g["inv_g"] = inv_g
    g["id_s"] = id_s
    g["obj_s"] = g["obj_t"][order_g]
    g["elem_s"] = g["elem_t"][order_g]
    g["action_s"] = np.asarray(a["action"], np.int32)[order_g]
    g["insert_s"] = np.asarray(a["insert"], np.bool_)[order_g]
    g["vtag_s"] = np.minimum(np.asarray(a["vcode"]), TAG_UNKNOWN).astype(np.int32)[order_g]
    g["vint_s"] = np.asarray(a["value_int"], np.int64)[order_g]
    g["width_s"] = np.asarray(a["width"], np.int32)[order_g]
    g["expand_s"] = np.asarray(a["expand"], np.bool_)[order_g]
    g["vcode_s"] = np.asarray(a["vcode"], np.int32)[order_g]
    g["voff_s"] = np.asarray(a["voff"], np.int64)[order_g]
    g["vlen_s"] = np.asarray(a["vlen"], np.int64)[order_g]
    g["prop_s"] = np.asarray(g["r"]["prop_ids"], np.int32)[order_g]
    mark_ids = a["mark_ids"]
    g["mark_s"] = (np.asarray(mark_ids, np.int32)[order_g]
                   if mark_ids is not None else None)

    demoted = []
    for di, p in enumerate(plans):
        if di in bad:
            demoted.append(p)
            continue
        if p.k:
            log = p.dev.log
            om = int(log.id_key[-1])
            if p.actors_changed:
                # the resident maximum after the monotone remap
                om = ((om >> ACTOR_BITS) << ACTOR_BITS) | p.rank_of[
                    log.actors[om & ACTOR_MASK].bytes]
            if int(id_s[p.r0]) <= om:
                demoted.append(p)  # not a strict tail append
    return demoted


def _splice_doc(p: _DocPlan, g):
    """The specialised tail splice of one document: what
    ``OpLog.append_changes`` + ``DeviceDoc._apply_append`` +
    ``stage_ready`` do for a tail delta over a ``LazyValues`` log, as
    passes over the pre-sorted shared arrays. Returns ("stage", rows,
    dirty) | ("reresolve", dirty) | ("done",) | ("scalar",).

    Nothing is committed before every check has passed: until then the
    only writes go to capacity buffers past the resident length."""
    dev = p.dev
    log = dev.log
    ready = p.ready
    k = p.k
    n = log.n

    if k == 0:
        if p.actors_changed:
            # a rowless change introducing an actor: the scalar path owns it
            return ("scalar",)
        log.changes.extend(ready)
        log.hashes().update(ch.hash for ch in ready)
        for ch in ready:
            dev._hash_index[ch.hash] = ch
        dev._views.clear()
        return ("done",)

    sl = slice(p.r0, p.r1)
    d_id = g["id_s"][sl]
    d_obj = g["obj_s"][sl]
    d_action = g["action_s"][sl]

    # -- the actor universe grows: monotone rank remap of the resident keys
    # (copies; nothing committed yet)
    if p.actors_changed:
        rank_map = np.fromiter((p.rank_of[a.bytes] for a in log.actors),
                               np.int64, count=len(log.actors))

        def remap_packed(key):
            key = np.asarray(key, np.int64)
            idx = np.where(key > 0, key, 0) & ACTOR_MASK
            return np.where(key > 0,
                            ((key >> ACTOR_BITS) << ACTOR_BITS) | rank_map[idx], key)

        old_id = remap_packed(log.id_key)
        old_obj = remap_packed(log.obj_key)
        old_ek = remap_packed(log.elem_key)
        old_pk = remap_packed(log.pred_key)
        old_table = remap_packed(log.obj_table)
    else:
        old_id, old_obj = log.id_key, log.obj_key
        old_ek, old_pk = log.elem_key, log.pred_key
        old_table = log.obj_table

    # -- the object table may only grow at its end
    # make actions are exactly the even codes below 8 (0, 2, 4, 6)
    make_mask = (d_action < 8) & ((d_action & 1) == 0)
    make_new = d_id[make_mask]
    pos = np.searchsorted(old_table, d_obj)
    posc = np.clip(pos, 0, len(old_table) - 1)
    found = old_table[posc] == d_obj
    all_found = bool(np.all(found))
    if len(make_new) == 0 and all_found:
        add = make_new
    else:
        add_parts = [make_new]
        if not all_found:
            add_parts.append(d_obj[~found])
        add = np.unique(np.concatenate(add_parts))
    if len(add) and int(add[0]) <= int(old_table[-1]):
        # a new object id inside the table would renumber resident rows
        obs.count("host_batch.fallback_docs", labels={"reason": "obj_order"})
        return ("scalar",)
    m = n + k

    # -- the offset-value-coded id join: the delta's ids extend the id_key
    # runs, so that the joins below search R run heads instead of m keys;
    # the rest of the image extends at its next sync (a tail write never
    # moves the resident prefix)
    idruns = None
    if _C.enabled() and not p.actors_changed:
        comp = log._comp
        if comp is None:
            comp = log._comp = _C.CompressedOpColumns()
        comp._sync_col("id_key", "delta", log.id_key, n)
        idruns = comp.extend_id(d_id)

    # -- packed-key and payload columns (tail writes only)
    if log._bufs is None:
        log._bufs = {}
    bufs = log._bufs
    tw = _tail_write
    id_new = tw(bufs, "id_key", old_id, d_id, m)
    obj_new = tw(bufs, "obj_key", old_obj, d_obj, m)
    ek_new = tw(bufs, "elem_key", old_ek, g["elem_s"][sl], m)
    action_new = tw(bufs, "action", log.action, d_action, m)
    insert_new = tw(bufs, "insert", log.insert, g["insert_s"][sl], m)
    vtag_new = tw(bufs, "value_tag", log.value_tag, g["vtag_s"][sl], m)
    vint_new = tw(bufs, "value_int", log.value_int, g["vint_s"][sl], m)
    width_new = tw(bufs, "width", log.width, g["width_s"][sl], m)
    expand_new = tw(bufs, "expand", log.expand, g["expand_s"][sl], m)

    # -- string-table columns
    doc_keys = _doc_string_table(ready, "key_table")
    if doc_keys:
        props, d_prop = _merge_table(
            log.props, doc_keys,
            _local_ids(g["prop_s"][sl], g["key_pos"], doc_keys, len(g["key_pos"])),
            np.arange(k))
    else:
        props = log.props
        d_prop = np.full(k, -1, np.int32)
    doc_marks = _doc_string_table(ready, "mark_table") if g["mark_s"] is not None else []
    if doc_marks:
        mark_names, d_mark = _merge_table(
            log.mark_names, doc_marks,
            _local_ids(g["mark_s"][sl], g["mark_pos"], doc_marks, len(g["mark_pos"])),
            np.arange(k))
    else:
        mark_names = log.mark_names
        d_mark = np.full(k, -1, np.int32)
    prop_new = tw(bufs, "prop", log.prop, d_prop, m)
    mark_new = tw(bufs, "mark_name_idx", log.mark_name_idx, d_mark, m)

    # -- row-reference columns, through the id join
    def _id_join(keys):
        if idruns is not None:
            obs.count("oplog.ovc_join", n=len(keys))
            return idruns.join(keys, ELEM_MISSING)
        return join_rows(id_new, keys, ELEM_MISSING)

    d_ek = g["elem_s"][sl]
    d_er = np.where(
        d_ek == -1, np.int32(ELEM_MAP),
        np.where(d_ek == 0, np.int32(ELEM_HEAD), _id_join(d_ek)),
    ).astype(np.int32)
    er_new = tw(bufs, "elem_ref", log.elem_ref, d_er, m)
    n_miss_elem = int(np.count_nonzero(d_er == ELEM_MISSING))

    q = len(log.pred_src)
    src_g = g["r"]["pred_src"][p.p0:p.p1]
    if len(src_g):
        d_ps = (n + (g["inv_g"][src_g] - p.r0)).astype(np.int32)
        d_pk = g["pk_t"][p.p0:p.p1]
        d_pt = _id_join(d_pk)
        d_pt = np.where(d_pt == ELEM_MISSING, np.int32(-1), d_pt).astype(np.int32)
    else:
        d_ps = np.empty(0, np.int32)
        d_pk = np.empty(0, np.int64)
        d_pt = np.empty(0, np.int32)
    qm = q + len(d_ps)
    ps_new = tw(bufs, "pred_src", log.pred_src, d_ps, qm)
    pt_new = tw(bufs, "pred_tgt", log.pred_tgt, d_pt, qm)
    pk_new = tw(bufs, "pred_key", old_pk, d_pk, qm)
    n_miss_pred = int(np.count_nonzero(d_pt == -1))

    # -- object table and dense ids
    if len(add):
        new_table = np.concatenate([old_table, add])
        od_new = np.searchsorted(new_table, d_obj).astype(np.int32)
    else:
        new_table = old_table
        od_new = posc.astype(np.int32)
    od_all = tw(bufs, "obj_dense", log.obj_dense, od_new, m)

    # -- the values heap (append-only raw bytes)
    vals = log.values
    c1 = p.c1
    raw0 = int(g["raw_off"][p.c0])
    raw1 = (int(g["raw_off"][c1]) if c1 < g["n_changes"]
            else int(g["raw_off"][-1] + g["raw_ln"][-1]))
    base = len(vals.raw)
    code = tw(bufs, "vcode", vals.code, g["vcode_s"][sl], m)
    off = tw(bufs, "voff", vals.off, g["voff_s"][sl] - raw0 + base, m)
    ln = tw(bufs, "vlen", vals.ln, g["vlen_s"][sl], m)
    raw = vals.raw
    if not isinstance(raw, bytearray):
        raw = bytearray(raw)
    raw += g["a"]["vraw"][raw0:raw1]
    nv = LazyValues(code, off, ln, raw, cap=vals.cap)

    # -- dirty objects (new dense numbering)
    one_obj = bool(np.all(od_new == od_new[0]))
    if one_obj and len(make_new) == 0 and len(d_pt) == 0:
        dirty = od_new[:1].astype(np.int64)  # a typing burst: its one object
    else:
        parts = [od_new.astype(np.int64), np.searchsorted(new_table, make_new)]
        if len(d_pt):
            hit = d_pt >= 0
            if np.any(hit):
                parts.append(od_all[d_pt[hit]].astype(np.int64))
        dirty = np.unique(np.concatenate(parts)).astype(np.int64)

    # -- commit the log
    log.id_key = id_new
    log.obj_key = obj_new
    log.elem_key = ek_new
    log.action = action_new
    log.prop = prop_new
    log.insert = insert_new
    log.value_tag = vtag_new
    log.value_int = vint_new
    log.width = width_new
    log.expand = expand_new
    log.mark_name_idx = mark_new
    log.elem_ref = er_new
    log.obj_dense = od_all
    log.pred_src = ps_new
    log.pred_tgt = pt_new
    log.pred_key = pk_new
    log.props = props
    log.mark_names = mark_names
    log.values = nv
    log.n = m
    log.n_objs = len(new_table)
    log.obj_table = new_table
    log.n_miss_elem = n_miss_elem
    log.n_miss_pred = n_miss_pred
    if p.actors_changed:
        log.actors = [ActorId(b) for b in p.all_bytes]
        log._comp = None  # every resident packed key was rank-remapped
    log._actor_order = None
    log.changes.extend(ready)
    log.hashes().update(ch.hash for ch in ready)

    # -- the document's bookkeeping (_apply_append for a tail delta)
    for ch in ready:
        dev._hash_index[ch.hash] = ch
    if p.actors_changed:
        # host caches keyed by packed ids follow the same monotone map
        remap = {old: p.rank_of[b] for b, old in dev._rank_of.items()}
        dev._obj_type = {
            (key if key == 0
             else ((key >> ACTOR_BITS) << ACTOR_BITS) | remap[key & ACTOR_MASK]): v
            for key, v in dev._obj_type.items()
        }
        dev._rank_of = dict(p.rank_of)
    # a view's clock and resolution describe the old log
    dev._views.clear()
    nr = np.arange(n, m, dtype=np.int64)
    for r_ in nr[make_mask]:
        dev._obj_type[int(log.id_key[r_])] = objtype_for_action(int(log.action[r_]))

    rbufs = dev._res_bufs
    vis = tw(rbufs, "visible", dev.visible, False, m)
    win = tw(rbufs, "winner", dev.winner, -1, m)
    con = tw(rbufs, "conflicts", dev.conflicts, 0, m)
    ei = tw(rbufs, "elem_index", dev.elem_index, -1, m)
    ovl = np.zeros(log.n_objs + 2, np.int32)
    otw = np.zeros(log.n_objs + 2, np.int32)
    oo = np.asarray(dev.res["obj_vis_len"])
    ot = np.asarray(dev.res["obj_text_width"])
    take = min(len(old_table), len(oo))
    ovl[:take] = oo[:take]
    otw[:take] = ot[:take]
    dev.res = {
        "visible": vis, "winner": win, "conflicts": con,
        "elem_index": ei, "obj_vis_len": ovl, "obj_text_width": otw,
    }
    dev.visible = vis
    dev.winner = win
    dev.conflicts = con
    dev.elem_index = ei
    dev.covered = tw(rbufs, "covered", dev.covered, True, m)
    dev.succ_count = tw(rbufs, "succ_count", dev.succ_count, 0, m)
    dev.inc_count = tw(rbufs, "inc_count", dev.inc_count, 0, m)
    value_int = np.asarray(log.value_int)
    cv = tw(rbufs, "counter_val", dev.counter_val, 0, m)
    cv[n:m] = value_int[n:m]
    dev.counter_val = cv
    if qm > q:
        src = ps_new[q:qm]
        tgt = pt_new[q:qm]
        ok = tgt >= 0
        src, tgt = src[ok], tgt[ok]
        is_inc = np.asarray(log.action)[src] == Action.INCREMENT
        np.add.at(dev.succ_count, tgt[~is_inc], 1)
        np.add.at(dev.inc_count, tgt[is_inc], 1)
        np.add.at(dev.counter_val, tgt[is_inc], value_int[src[is_inc]])

    # object-sorted row index: the delta merged into the resident order
    old_rbo = dev._rows_by_obj
    if p.actors_changed:
        # the sorted keys are packed values: gather them from the remapped
        # column (the monotone remap kept their order)
        old_keys = np.asarray(log.obj_key)[:n][old_rbo]
    else:
        old_keys = dev._obj_sorted
    rbo = np.empty(m, np.int64)
    keys = np.empty(m, np.int64)
    if one_obj:
        # one object: one contiguous insertion block
        okey = int(d_obj[0])
        at = int(np.searchsorted(old_keys, okey, side="right"))
        rbo[:at] = old_rbo[:at]
        keys[:at] = old_keys[:at]
        rbo[at:at + k] = nr
        keys[at:at + k] = okey
        rbo[at + k:] = old_rbo[at:]
        keys[at + k:] = old_keys[at:]
    else:
        d_keys = np.asarray(log.obj_key)[nr]
        ordx = np.lexsort((nr, d_keys))
        d_rows = nr[ordx]
        d_keys = d_keys[ordx]
        pos2 = np.searchsorted(old_keys, d_keys, side="right")
        cnt = np.bincount(pos2, minlength=n + 1)
        old_pos = np.arange(n, dtype=np.int64) + np.cumsum(cnt[:n])
        rbo[old_pos] = old_rbo
        keys[old_pos] = old_keys
        new_pos = pos2 + np.arange(k, dtype=np.int64)
        rbo[new_pos] = d_rows
        keys[new_pos] = d_keys
    dev._rows_by_obj = rbo
    dev._obj_sorted = keys

    if p.actors_changed:
        dev._all_elems_cache.clear()
    else:
        for d in dirty:
            dev._all_elems_cache.pop(int(log.obj_table[d]), None)

    # -- stage, or resolve the whole document (the stage_ready decision)
    rows = dev._subset_rows(dirty)
    if len(rows) / m > DIRTY_FRACTION_LIMIT or len(dirty) >= log.n_objs:
        return ("reresolve", dirty)
    return ("stage", rows, dirty)
