"""Per-change decoded-column caches + single-pass native log assembly.

The change chunk is already columnar (change_op_columns.rs); decoding it
for every log is waste. Each StoredChange therefore keeps its decoded,
chunk-local column arrays (``cached_cols``), attached on first decode (one
batched native pass over all changes not yet decoded), and a log is
assembled into its final Lamport-ordered, reference-resolved columns by
one native call (native/assemble.cpp):

  counting sort over consecutive-counter runs  ->  O(N) Lamport order
  column gathers through the emit permutation  ->  no concat middleman
  change-span reference resolution             ->  O(log C) per ref, not
                                                   a join against N rows

A change's map keys and mark names are ids into ITS OWN string tables (the
strings its rows use, in first-use order), so its cache reads the same
whichever changes were decoded with it; a log's ``props`` and
``mark_names`` are the union of its changes' tables in change order, the
order of first use across the log, whatever logs were built before.

``assemble_log`` takes what a parsed change can carry: ``route`` says
beforehand which changes hold a counter the assembler does not place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..errors import AutomergeError
from ..types import ACTOR_BITS, get_text_encoding


class AssembleError(AutomergeError):
    pass


# The gather-heavy columns interleaved as one 24-byte record per op
# (AoS): the assembler's permuted reads touch ONE cache line per row
# (2.6 rows per line) instead of seven per-change column streams. The
# i64 field leads so it stays 8-aligned (24 % 8 == 0).
HOT_DTYPE = np.dtype(
    [
        ("elem_ctr", "<i8"),    # 0
        ("voff", "<u4"),        # 8  chunk-local value-heap offset
        ("vlen", "<u4"),        # 12 value payload length
        ("elem_actor", "<i4"),  # 16 chunk-local actor index (-1 = HEAD)
        ("action", "u1"),       # 20 storage action (0..15)
        ("vcode", "u1"),        # 21 value meta type code (meta & 0xF)
        ("insert", "u1"),       # 22
        ("_pad", "V1"),         # 23
    ]
)
assert HOT_DTYPE.itemsize == 24
# voff/vlen are u32: _split_batch refuses a change whose value heap
# reaches 4 GiB.

# Counters the packed ids hold: ``ctr << ACTOR_BITS | rank`` in an int64.
PACKED_CTR = 1 << 43

# ChangeCols.route: what a change's counters let a log do with it
ROUTE_ASSEMBLE = 0  # every counter in [0, 2^43): the assembler places it
ROUTE_BATCH = 1     # a negative key or pred counter: the batch extraction
ROUTE_OVERFLOW = 2  # a counter outside the packed ids' range: refused

# shared all-minus-one buffer for changes without a key_str / mark_name
# column (grown on demand, never shrunk; cache rows only READ [0, n))
_NEG1_I32 = np.full(1024, -1, np.int32)


def _neg1(n: int) -> np.ndarray:
    global _NEG1_I32
    if len(_NEG1_I32) < n:
        _NEG1_I32 = np.full(max(n, 2 * len(_NEG1_I32)), -1, np.int32)
    return _NEG1_I32


class ChangeCols:
    """One change's decoded, chunk-local op columns (actor columns hold
    chunk-local indices; string columns hold ids into the change's own
    ``key_table`` / ``mark_table``). Arrays are C-contiguous with the
    exact dtypes the native assembler reads; ``ptr_row`` caches their
    addresses in the fixed 19-slot layout of am_assemble_log. ``route``
    is one of the ROUTE_* codes."""

    __slots__ = (
        "n", "q", "obj_ctr", "obj_actor", "obj_has", "key_sid",
        "expand", "value_int", "width", "width_enc", "mark_sid",
        "pred_num", "pred_ctr", "pred_actor", "key_table", "mark_table",
        "vraw", "hot", "route", "_ptrs", "_const", "rank_tab",
    )

    # the gather-heavy columns live ONLY in the hot record (strided views
    # for host-side consumers); the assembler reads them from the record
    @property
    def action(self) -> np.ndarray:
        return self.hot["action"]

    @property
    def elem_ctr(self) -> np.ndarray:
        return self.hot["elem_ctr"]

    @property
    def elem_actor(self) -> np.ndarray:
        return self.hot["elem_actor"]

    @property
    def insert(self) -> np.ndarray:
        return self.hot["insert"]

    @property
    def vcode(self) -> np.ndarray:
        return self.hot["vcode"]

    @property
    def vlen(self) -> np.ndarray:
        return self.hot["vlen"]

    @property
    def voff(self) -> np.ndarray:
        return self.hot["voff"]

    def const_scan(self) -> Tuple[np.ndarray, np.ndarray]:
        """(mask, value) per column slot: mask[k] when every row of
        column k carries the same value. Computed once per cache."""
        c = self._const
        if c is None:
            mask = np.zeros(18, bool)
            val = np.zeros(18, np.int64)
            n = self.n
            cols = {
                1: self.obj_ctr, 2: self.obj_actor, 3: self.obj_has,
                4: self.key_sid[:n], 7: self.insert, 8: self.expand,
                9: self.vcode, 10: self.vlen, 11: self.voff,
                12: self.value_int, 13: self.width,
                14: self.mark_sid[:n],
            }
            for k, a in cols.items():
                if n == 0:
                    continue  # empty changes don't constrain anything
                v = a[0]
                if n == 1 or (a == v).all():
                    mask[k] = True
                    val[k] = int(v)
            c = (mask, val)
            self._const = c
        return c

    def ptr_row(self) -> np.ndarray:
        p = self._ptrs
        if p is None:
            # slots 0/5/6/7/9/10/11 are served by the hot record; the
            # assembler never dereferences their cold pointers
            cols = (
                None, self.obj_ctr, self.obj_actor, self.obj_has,
                self.key_sid, None, None, None,
                self.expand, None, None, None,
                self.value_int, self.width, self.mark_sid, self.pred_num,
                self.pred_ctr, self.pred_actor, self.hot,
            )
            p = np.fromiter(
                (0 if a is None else a.ctypes.data for a in cols),
                dtype=np.int64,
                count=19,
            )
            self._ptrs = p
        return p

    def ensure_width_encoding(self) -> None:
        """Recompute text widths if the active encoding differs from the
        one the cache was built under (reference: text_value.rs — the
        index unit is a per-document property)."""
        enc = get_text_encoding()
        if enc == self.width_enc:
            return
        from .extract import _str_widths

        w = _str_widths(self.vraw, self.voff.astype(np.int64),
                        self.vlen.astype(np.int64), self.vcode, self.n)
        self.width = np.ascontiguousarray(w, np.int32)
        self.width_enc = enc
        self._ptrs = None
        self._const = None


def _c32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _c64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def _c8(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint8)


def ensure_change_cols(changes: Sequence) -> List[ChangeCols]:
    """Fetch-or-build every change's column cache.

    Changes without one are decoded in ONE batched native pass
    (extract.batch_arrays) and the per-change views attached, so the
    decode cost is paid once per change object, not per log."""
    caches: List[Optional[ChangeCols]] = [ch.cached_cols for ch in changes]
    missing = [i for i, c in enumerate(caches) if c is None]
    if missing:
        from .. import obs
        from .extract import batch_arrays

        # the reference looks each one up in a hash-keyed cache first; the
        # port keeps a change's columns on the change object alone, so
        # every change without them is a miss
        obs.count("extract.change_cache_miss", n=len(missing))

        subset = [changes[i] for i in missing]
        for ch in subset:
            if ch.op_col_data is None:
                raise AssembleError("change has no retained column data")
        built = _split_batch(batch_arrays(subset), subset)
        for i, cc in zip(missing, built):
            changes[i].cached_cols = cc
            caches[i] = cc
    enc = get_text_encoding()
    for cc in caches:
        if cc.width_enc != enc:
            cc.ensure_width_encoding()
    return caches  # type: ignore[return-value]


def _local_tables(ids, table, row_off, C: int):
    """Batch-interned string ids -> (per-change local ids, per-change
    tables): change c's table is the strings its rows use, first use
    first (native am_localize_ids)."""
    N = int(row_off[-1])
    local = np.empty(max(N, 1), np.int32)
    tab_ids = np.empty(max(N, 1), np.int32)
    tab_start = np.empty(C + 1, np.int64)
    stamp = np.empty(max(len(table), 1), np.int64)
    ids = _c32(ids)
    w = native.load().am_localize_ids(
        native._i32(ids), native._i64(row_off), C, len(table),
        native._i32(local), native._i32(tab_ids), native._i64(tab_start),
        native._i64(stamp),
    )
    if w < 0:
        raise AssembleError("string id outside its batch table")
    names = [table[g] for g in tab_ids[:w].tolist()]
    starts = tab_start.tolist()
    tables = [names[starts[c]:starts[c + 1]] for c in range(C)]
    return local[:N], tables


def _routes(a: Dict, C: int) -> np.ndarray:
    """ROUTE_* per change of one batch_arrays output (vectorized): where
    each change's object, element and pred counters fall against the
    packed ids' range."""
    route = np.zeros(C, np.int64)
    N = a["n"]
    if N:
        key_ids = a["key_ids"]
        seq = a["key_has_actor"] & (a["key_ctr"] != 0)
        if key_ids is not None:
            seq &= key_ids < 0
        ectr = np.where(seq, a["key_ctr"], 1)
        octr = np.where(a["obj_has"], a["obj_ctr"], 1)
        # an object counter is a ULEB: negative in int64 means >= 2^63
        over = ((octr < 0) | (octr >= PACKED_CTR) | (ectr >= PACKED_CTR)
                | (ectr < -PACKED_CTR))
        neg = ectr < 0
        cor = a["change_of_row"]
        if over.any():
            route[np.unique(cor[over])] = ROUTE_OVERFLOW
        if neg.any():
            hit = np.unique(cor[neg])
            route[hit] = np.maximum(route[hit], ROUTE_BATCH)
    pctr = a["pred_ctr"]
    if len(pctr):
        cop = np.repeat(np.arange(C), np.diff(a["pred_row_off"]))
        over = (pctr >= PACKED_CTR) | (pctr < -PACKED_CTR)
        neg = pctr < 0
        if over.any():
            route[np.unique(cop[over])] = ROUTE_OVERFLOW
        if neg.any():
            hit = np.unique(cop[neg])
            route[hit] = np.maximum(route[hit], ROUTE_BATCH)
    return route


def _split_batch(a: Dict, changes: Sequence) -> List[ChangeCols]:
    """Slice one batch_arrays output into per-change ChangeCols views."""
    n_changes = len(changes)
    row_off = a["row_off"]
    pred_row_off = a["pred_row_off"]
    raw_off = a["raw_off"]
    raw_ln = a["raw_ln"]
    raw = a["vraw"]
    enc = get_text_encoding()

    # whole-batch conversions once; per-change slices are COPIED so a
    # retained change never pins the whole batch's arrays through views
    N = int(row_off[-1])
    hot_all = np.empty(N, HOT_DTYPE)
    # HEAD (no actor) is counter 0; a map op's slot is ignored by C
    hot_all["elem_ctr"] = np.where(a["key_has_actor"], a["key_ctr"], 0)
    voff_local = a["voff"] - raw_off[a["change_of_row"]]  # chunk-local
    if N and (
        int(a["vlen"].max(initial=0)) >= (1 << 32)
        or int(voff_local.max(initial=0)) >= (1 << 32)
        or int(voff_local.min(initial=0)) < 0
        or int(a["vlen"].min(initial=0)) < 0
    ):
        raise AssembleError("value heap exceeds the 24-byte record range")
    hot_all["vlen"] = a["vlen"]
    hot_all["voff"] = voff_local
    hot_all["action"] = a["action"]
    hot_all["elem_actor"] = a["key_actor"]
    hot_all["vcode"] = a["vcode"]
    hot_all["insert"] = a["insert"]
    obj_ctr = _c64(a["obj_ctr"])
    obj_actor = _c32(a["obj_actor"])
    obj_has = _c8(a["obj_has"])
    key_sid = key_tables = mark_sid = mark_tables = None
    if a["key_ids"] is not None:
        key_sid, key_tables = _local_tables(a["key_ids"], a["key_table"],
                                            row_off, n_changes)
    if a["mark_ids"] is not None:
        mark_sid, mark_tables = _local_tables(a["mark_ids"], a["mark_table"],
                                              row_off, n_changes)
    expand = _c8(a["expand"])
    value_int = _c64(a["value_int"])
    width = _c32(a["width"])
    pred_num = _c32(a["pred_num"])
    pred_ctr = _c64(a["pred_ctr"])
    pred_actor = _c32(a["pred_actor"])
    route = _routes(a, n_changes)

    # structured-dtype slice copies go through numpy's per-field slow path
    # (~17x a plain copy); copying through a flat byte view is a memcpy
    hot_bytes = hot_all.view(np.uint8).reshape(N, HOT_DTYPE.itemsize)

    out = []
    for c in range(n_changes):
        lo, hi = int(row_off[c]), int(row_off[c + 1])
        plo, phi = int(pred_row_off[c]), int(pred_row_off[c + 1])
        rlo = int(raw_off[c])
        cc = ChangeCols()
        cc.n = hi - lo
        cc.q = phi - plo
        cc.hot = hot_bytes[lo:hi].copy().view(HOT_DTYPE).reshape(cc.n)
        cc.obj_ctr = obj_ctr[lo:hi].copy()
        cc.obj_actor = obj_actor[lo:hi].copy()
        cc.obj_has = obj_has[lo:hi].copy()
        # a change's string columns are null when its table is empty
        cc.key_table = key_tables[c] if key_sid is not None and key_tables[c] else None
        cc.key_sid = key_sid[lo:hi].copy() if cc.key_table else _neg1(cc.n)
        cc.expand = expand[lo:hi].copy()
        cc.value_int = value_int[lo:hi].copy()
        cc.width = width[lo:hi].copy()
        cc.width_enc = enc
        cc.mark_table = (mark_tables[c] if mark_sid is not None and mark_tables[c]
                         else None)
        cc.mark_sid = mark_sid[lo:hi].copy() if cc.mark_table else _neg1(cc.n)
        cc.pred_num = pred_num[lo:hi].copy()
        cc.pred_ctr = pred_ctr[plo:phi].copy()
        cc.pred_actor = pred_actor[plo:phi].copy()
        cc.vraw = raw[rlo : rlo + int(raw_ln[c])]
        cc.route = int(route[c])
        cc._ptrs = None
        cc._const = None
        cc.rank_tab = None
        out.append(cc)
    return out


def route(changes: Sequence) -> int:
    """The route of a log of ``changes`` (decoding those not yet decoded):
    ROUTE_OVERFLOW when a change holds a counter outside the packed ids'
    range (op ids included: start_op + ops - 1), else ROUTE_BATCH when one
    holds a negative key or pred counter, else ROUTE_ASSEMBLE."""
    caches = ensure_change_cols(changes)
    C = len(caches)
    if not C:
        return ROUTE_ASSEMBLE
    worst = max(cc.route for cc in caches)
    n_ops = np.fromiter((cc.n for cc in caches), np.int64, count=C)
    start_op = np.fromiter((ch.start_op for ch in changes), np.int64, count=C)
    if int((np.where(n_ops > 0, start_op + n_ops, 0)).max()) - 1 >= PACKED_CTR:
        worst = ROUTE_OVERFLOW
    return worst


_UNIVERSE_IDS: Dict[bytes, int] = {}
_UNIVERSE_NEXT = [1]  # monotone: tokens never recycle, even across clears


def _universe_token(rank_of: Dict[bytes, int]) -> int:
    """Intern the actor universe (rank_of's keys are in rank order) to a
    small id; equal universes across merges share one token. The key is a
    LENGTH-PREFIXED join — actor ids are arbitrary bytes, so a separator
    join would be ambiguous — making token equality exact."""
    key = b"".join(
        len(a).to_bytes(4, "little") + a for a in rank_of
    )
    tok = _UNIVERSE_IDS.get(key)
    if tok is None:
        if len(_UNIVERSE_IDS) >= 4096:  # bound stale universes
            _UNIVERSE_IDS.clear()
        tok = _UNIVERSE_NEXT[0]
        _UNIVERSE_NEXT[0] += 1
        _UNIVERSE_IDS[key] = tok
    return tok


def _const_stacks(caches):
    """(li, mask_stack, value_stack) over non-empty changes — the shared
    input of _global_const and _per_change_const (assemble_log computes it
    once and threads it into both)."""
    li = np.asarray([i for i, cc in enumerate(caches) if cc.n > 0], np.int64)
    if not len(li):
        return li, np.zeros((0, 18), bool), np.zeros((0, 18), np.int64)
    scans = [caches[int(i)].const_scan() for i in li]
    ms = np.stack([m for m, _ in scans])
    vs = np.stack([v for _, v in scans])
    return li, ms, vs


def _global_const(
    caches, tab_all, tab_off, tab_size, prop_off, prop_size, prop_remap,
    mark_off, mark_size, mark_remap, total_raw, stacks=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Aggregate per-change constant columns into the assembler's global
    fill directives (see assemble.cpp g_flags docs): a column is fillable
    iff every non-empty change is constant AND agrees on the (translated)
    value."""
    g_flags = np.zeros(18, np.int64)
    g_vals = np.zeros(18, np.int64)
    li, ms, vs = stacks if stacks is not None else _const_stacks(caches)
    if not len(li):
        return g_flags, g_vals
    allc = ms.all(axis=0)
    same = (vs == vs[0]).all(axis=0)
    for k in (7, 8, 9, 10, 12, 13):
        if allc[k] and same[k]:
            g_flags[k] = 1
            g_vals[k] = vs[0, k]
    # voff is rebased by per-change raw offsets; fillable only when the
    # whole value heap is empty (then every local offset is 0)
    if allc[11] and same[11] and total_raw == 0:
        g_flags[11] = 1
        g_vals[11] = vs[0, 11]
    # object id: translate each change's constant (ctr, local actor, has)
    # through its actor table and require one global packed value
    if allc[1] and allc[2] and allc[3]:
        has = vs[:, 3] != 0
        oa = vs[:, 2]
        ts = tab_size[li]
        if ((~has) | ((oa >= 0) & (oa < ts))).all() and (
            (~has) | ((vs[:, 1] >= 0) & (vs[:, 1] < PACKED_CTR))
        ).all():
            packed = np.where(
                has,
                (vs[:, 1] << ACTOR_BITS)
                | tab_all[(tab_off[li] + np.minimum(oa, ts - 1))],
                0,
            )
            if (packed == packed[0]).all():
                g_flags[1] = 1
                g_vals[1] = packed[0]
    # key_sid: all-seq (1) or one shared global map prop (2)
    if allc[4]:
        s = vs[:, 4]
        if (s == -1).all():
            g_flags[4] = 1
        elif (s >= 0).all():
            po = prop_off[li]
            if (po >= 0).all() and (s < prop_size[li]).all():
                gp = prop_remap[po + s]
                if (gp == gp[0]).all():
                    g_flags[4] = 2
                    g_vals[4] = gp[0]
    # mark name: none anywhere, or one shared global mark id
    if allc[14]:
        m = vs[:, 14]
        if (m == -1).all():
            g_flags[14] = 1
            g_vals[14] = -1
        elif (m >= 0).all():
            mo = mark_off[li]
            if (mo >= 0).all() and (m < mark_size[li]).all():
                gm = mark_remap[mo + m]
                if (gm == gm[0]).all():
                    g_flags[14] = 1
                    g_vals[14] = gm[0]
    return g_flags, g_vals


def _per_change_const(
    caches, tab_all, tab_off, tab_size, prop_off, prop_size, prop_remap,
    stacks=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-change constant shortcuts for the assembler's gather loop.

    Real changes overwhelmingly target ONE object and one key shape, so
    the per-row has/actor/ctr loads + actor-table translation collapse to
    a single C-array read even when the GLOBAL const scan fails (e.g. the
    make op itself rides in an early change). Returns:
      c_obj_key[c]: packed global object key every row of c targets
                    (0 = root), or -1 when the change's obj column varies;
      c_sid[c]:     -1 = every row seq-keyed, >= 0 = one global map prop,
                    -2 = varies.
    Vectorized over the (cached) per-change const scans.
    """
    C = len(caches)
    c_obj_key = np.full(C, -1, np.int64)
    c_sid = np.full(C, -2, np.int64)
    li, ms, vs = stacks if stacks is not None else _const_stacks(caches)
    empty = np.ones(C, bool)
    empty[li] = False
    c_obj_key[empty] = 0
    c_sid[empty] = -1
    if not len(li):
        return c_obj_key, c_sid

    # object: const has/actor/ctr columns -> one packed key per change
    oc = ms[:, 1] & ms[:, 2] & ms[:, 3]
    has = vs[:, 3] != 0
    oa = vs[:, 2]
    octr = vs[:, 1]
    ts = tab_size[li]
    valid = oc & ((~has) | ((oa >= 0) & (oa < ts) & (octr >= 0) & (octr < PACKED_CTR)))
    packed = np.where(
        has,
        (octr << ACTOR_BITS) | tab_all[tab_off[li] + np.clip(oa, 0, np.maximum(ts - 1, 0))],
        0,
    )
    c_obj_key[li[valid]] = packed[valid]

    # key sid: all-seq, or one prop remapped to its global id
    sc = ms[:, 4]
    s = vs[:, 4]
    seq = sc & (s == -1)
    c_sid[li[seq]] = -1
    po = prop_off[li]
    mp = sc & (s >= 0) & (po >= 0) & (s < prop_size[li])
    c_sid[li[mp]] = prop_remap[(po + np.clip(s, 0, None))[mp]]
    return c_obj_key, c_sid


def _remap_tables(
    caches: Sequence[ChangeCols], table_attr: str
) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]:
    """Union per-change string tables into one global table, in change
    order (so in order of first use across the log).

    Returns (global table, remap_all, off[c], size[c]) where
    remap_all[off[c] + local_id] = global id. Tables are memoized by
    object identity: changes that share one table object are unioned
    once."""
    global_of: Dict[str, int] = {}
    remap_of_table: Dict[int, Tuple[int, int]] = {}  # id(table) -> (off, size)
    parts: List[np.ndarray] = []
    off = np.full(len(caches), -1, np.int64)
    size = np.zeros(len(caches), np.int64)
    pos = 0
    for c, cc in enumerate(caches):
        table = getattr(cc, table_attr)
        if table is None:
            continue
        key = id(table)
        hit = remap_of_table.get(key)
        if hit is None:
            remap = np.fromiter(
                (
                    global_of.setdefault(s, len(global_of))
                    for s in table
                ),
                dtype=np.int32,
                count=len(table),
            )
            parts.append(remap)
            hit = (pos, len(table))
            remap_of_table[key] = hit
            pos += len(table)
        off[c], size[c] = hit
    remap_all = (
        np.concatenate(parts) if parts else np.zeros(1, np.int32)
    )
    table_list = list(global_of)
    return table_list, _c32(remap_all), off, size


def ranked_from_caches(changes: Sequence, rank_of: Dict[bytes, int]):
    """The changes' ChangeCols caches concatenated in change order, packed
    ids rank-translated, string tables unioned: ``{"a": the batch columns,
    "id_key", "obj", "prop_ids", "elem", "pred_src", "pred_key"}``, no
    chunk decoded twice. The batch extraction (``OpLog._collect_fast``)
    and the served splice (``OpLog._extract_delta``) build from it.

    HEAD is elem_ctr == 0 here (as in the assembler and the per-op path:
    a key counter 0 with an actor is HEAD too). The caller supplies
    rank_of (it also owns the actor-capacity check).
    """
    caches = ensure_change_cols(changes)
    C = len(caches)

    n_ops = np.fromiter((c.n for c in caches), np.int64, count=C)
    row_off = np.concatenate([[0], np.cumsum(n_ops)]).astype(np.int64)
    N = int(row_off[-1])
    cor = np.repeat(np.arange(C, dtype=np.int64), n_ops)
    start_op = np.fromiter((ch.start_op for ch in changes), np.int64, count=C)

    tab_parts = [[rank_of[bytes(x)] for x in ch.actors] for ch in changes]
    tab_size = np.fromiter((len(t) for t in tab_parts), np.int64, count=C)
    tab_off = np.concatenate([[0], np.cumsum(tab_size)])[:-1].astype(np.int64)
    tab_all = np.fromiter(
        (r for t in tab_parts for r in t), np.int64,
        count=int(tab_size.sum()),
    )
    author = tab_all[tab_off] if C else np.empty(0, np.int64)
    clip = max(len(tab_all) - 1, 0)

    def cat(field, dtype, sliced=False):
        """Concatenate one cached column across changes. ``sliced`` is for
        the sid columns whose backing buffer (the shared -1 filler) can
        exceed the change's row count."""
        if not C:
            return np.empty(0, dtype)
        if sliced:
            arrs = [getattr(c, field)[: c.n] for c in caches]
        else:
            arrs = [getattr(c, field) for c in caches]
        out = np.concatenate(arrs)
        return out if out.dtype == dtype else out.astype(dtype)

    within = np.arange(N, dtype=np.int64) - row_off[:-1][cor]
    id_key = ((start_op[cor] + within) << ACTOR_BITS) | author[cor]

    obj_has = cat("obj_has", np.bool_)
    obj_actor = cat("obj_actor", np.int64)
    obj_ctr = cat("obj_ctr", np.int64)
    if N and np.any(obj_actor[obj_has] >= tab_size[cor][obj_has]):
        raise AssembleError("actor index out of chunk-local table range")
    obj = np.where(
        obj_has,
        (obj_ctr << ACTOR_BITS)
        | tab_all[(tab_off[cor] + obj_actor).clip(max=clip)],
        np.int64(0),
    )

    key_tables, prop_remap, prop_off, _ = _remap_tables(caches, "key_table")
    sid = cat("key_sid", np.int64, sliced=True)
    any_keys = any(c.key_table is not None for c in caches)
    prop_ids = (
        np.where(
            sid >= 0,
            prop_remap[(prop_off[cor] + sid).clip(min=0, max=max(len(prop_remap) - 1, 0))],
            np.int32(-1),
        ).astype(np.int32)
        if any_keys
        else None
    )
    mark_tables, mark_remap, mark_off, _ = _remap_tables(caches, "mark_table")
    msid = cat("mark_sid", np.int64, sliced=True)
    any_marks = any(c.mark_table is not None for c in caches)
    mark_ids = (
        np.where(
            msid >= 0,
            mark_remap[(mark_off[cor] + msid).clip(min=0, max=max(len(mark_remap) - 1, 0))],
            np.int32(-1),
        ).astype(np.int32)
        if any_marks
        else None
    )

    elem_ctr = cat("elem_ctr", np.int64)
    elem_actor = cat("elem_actor", np.int64)
    if N:
        seq_rows = sid < 0
        if np.any(
            (elem_ctr[seq_rows] != 0)
            & (elem_actor[seq_rows] >= tab_size[cor][seq_rows])
        ):
            raise AssembleError("actor index out of chunk-local table range")
    elem = np.where(
        sid >= 0,
        np.int64(-1),
        np.where(
            elem_ctr == 0,
            np.int64(0),
            (elem_ctr << ACTOR_BITS)
            | tab_all[(tab_off[cor] + elem_actor).clip(max=clip)],
        ),
    )

    q_ops = np.fromiter((c.q for c in caches), np.int64, count=C)
    pred_row_off = np.concatenate([[0], np.cumsum(q_ops)]).astype(np.int64)
    Q = int(pred_row_off[-1])
    pred_num = cat("pred_num", np.int64)
    pred_src = np.repeat(np.arange(N, dtype=np.int64), pred_num)
    corq = np.repeat(np.arange(C, dtype=np.int64), q_ops)
    pred_ctr = (
        np.concatenate([np.asarray(c.pred_ctr, np.int64) for c in caches])
        if C
        else np.empty(0, np.int64)
    )
    pred_actor = (
        np.concatenate([np.asarray(c.pred_actor, np.int64) for c in caches])
        if C
        else np.empty(0, np.int64)
    )
    if Q and np.any(pred_actor >= tab_size[corq]):
        raise AssembleError("pred actor index out of chunk-local table range")
    pred_key = (pred_ctr << ACTOR_BITS) | tab_all[
        (tab_off[corq] + pred_actor).clip(max=clip)
    ]

    raw_ln = np.fromiter((len(c.vraw) for c in caches), np.int64, count=C)
    raw_off = np.concatenate([[0], np.cumsum(raw_ln)])[:-1].astype(np.int64)
    vraw = b"".join(c.vraw for c in caches)
    voff = cat("voff", np.int64) + raw_off[cor]

    a = {
        "n": N,
        "n_ops": n_ops,
        "row_off": row_off,
        "raw_off": raw_off,
        "raw_ln": raw_ln,
        "change_of_row": cor,
        "action": cat("action", np.int32),
        "insert": cat("insert", np.bool_),
        "expand": cat("expand", np.bool_),
        "vcode": cat("vcode", np.int32),
        "voff": voff,
        "vlen": cat("vlen", np.int64),
        "vraw": vraw,
        "value_int": cat("value_int", np.int64),
        "width": cat("width", np.int32),
        "key_ids": prop_ids,
        "key_table": key_tables,
        "mark_ids": mark_ids,
        "mark_table": mark_tables,
        "pred_num": pred_num,
        "pred_ctr": pred_ctr,
        "pred_actor": pred_actor,
        "pred_row_off": pred_row_off,
        "obj_ctr": obj_ctr,
        "obj_actor": obj_actor,
        "obj_has": obj_has,
    }
    return {
        "a": a,
        "id_key": id_key,
        "obj": obj,
        "prop_ids": prop_ids if prop_ids is not None else np.full(N, -1, np.int32),
        "elem": elem,
        "pred_src": pred_src,
        "pred_key": pred_key,
        "rank_of": rank_of,
    }


def assemble_log(log, changes: Sequence, rank_of: Dict[bytes, int]):
    """Fill ``log`` (an empty OpLog with actors/changes set) from cached
    per-change columns via the native assembler. The caller has checked
    ``route(changes) == ROUTE_ASSEMBLE``; anything the assembler still
    refuses raises AssembleError."""
    lib = native.load()
    caches = ensure_change_cols(changes)
    C = len(caches)
    n_ops = np.fromiter((c.n for c in caches), np.int64, count=C)
    q_ops = np.fromiter((c.q for c in caches), np.int64, count=C)
    N = int(n_ops.sum())
    Q = int(q_ops.sum())
    start_op = np.fromiter((ch.start_op for ch in changes), np.int64, count=C)

    # per-log actor translation: chunk-local index -> global rank. The
    # translated table is memoized on the cache keyed by the actor
    # UNIVERSE (interned to a token, so the key comparison is one int):
    # repeated logs over the same replica set skip the per-actor lookups.
    rank_token = _universe_token(rank_of)
    tab_parts = []
    for ch, cc in zip(changes, caches):
        rt = cc.rank_tab
        if rt is not None and rt[0] == rank_token:
            tab_parts.append(rt[1])
        else:
            t = [rank_of[bytes(a)] for a in ch.actors]
            cc.rank_tab = (rank_token, t)
            tab_parts.append(t)
    tab_size = np.fromiter((len(t) for t in tab_parts), np.int64, count=C)
    tab_off = np.concatenate([[0], np.cumsum(tab_size)])[:-1].astype(np.int64)
    tab_all = np.fromiter(
        (r for t in tab_parts for r in t), np.int64, count=int(tab_size.sum())
    )
    author = tab_all[tab_off] if C else np.empty(0, np.int64)

    props, prop_remap, prop_off, prop_size = _remap_tables(caches, "key_table")
    marks, mark_remap, mark_off, mark_size = _remap_tables(caches, "mark_table")

    # value raw heap: concatenate per-change buffers; C rebases offsets
    raw_base = np.zeros(C, np.int64)
    pos = 0
    for c, cc in enumerate(caches):
        raw_base[c] = pos
        pos += len(cc.vraw)
    raw_all = b"".join(cc.vraw for cc in caches)

    col_ptrs = np.empty((C, 19), np.int64)
    for c, cc in enumerate(caches):
        col_ptrs[c] = cc.ptr_row()

    stacks = _const_stacks(caches)
    g_flags, g_vals = _global_const(
        caches, tab_all, tab_off, tab_size, prop_off, prop_size, prop_remap,
        mark_off, mark_size, mark_remap, len(raw_all), stacks=stacks,
    )
    c_obj_key, c_sid = _per_change_const(
        caches, tab_all, tab_off, tab_size, prop_off, prop_size, prop_remap,
        stacks=stacks,
    )

    # outputs
    id_key = np.empty(N, np.int64)
    obj_key = np.empty(N, np.int64)
    prop = np.empty(N, np.int32)
    action = np.empty(N, np.int32)
    insert = np.empty(N, np.uint8)
    expand = np.empty(N, np.uint8)
    value_tag = np.empty(N, np.int32)
    value_int = np.empty(N, np.int64)
    width = np.empty(N, np.int32)
    mark_idx = np.empty(N, np.int32)
    vcode = np.empty(N, np.int32)
    voff = np.empty(N, np.int64)
    vlen = np.empty(N, np.int64)
    elem_ref = np.empty(N, np.int32)
    obj_dense = np.empty(N, np.int32)
    pred_src = np.empty(max(Q, 1), np.int32)
    pred_tgt = np.empty(max(Q, 1), np.int32)
    obj_table_buf = np.empty(N + 1, np.int64)
    out_meta = np.zeros(4, np.int64)

    if N:
        rc = lib.am_assemble_log(
            native._i64(n_ops), native._i64(q_ops), native._i64(start_op),
            native._i64(author), native._i64(tab_off), native._i64(tab_size),
            native._i64(prop_off), native._i64(prop_size),
            native._i64(mark_off), native._i64(mark_size),
            native._i64(raw_base), native._i64(col_ptrs.reshape(-1)), C,
            native._i64(tab_all), native._i32(prop_remap),
            native._i32(mark_remap), ACTOR_BITS,
            native._i64(g_flags), native._i64(g_vals),
            native._i64(c_obj_key), native._i64(c_sid),
            native._i64(id_key), native._i64(obj_key), native._i32(prop),
            native._i32(action), native._u8(insert), native._u8(expand),
            native._i32(value_tag), native._i64(value_int),
            native._i32(width), native._i32(mark_idx), native._i32(vcode),
            native._i64(voff), native._i64(vlen), native._i32(elem_ref),
            native._i32(obj_dense), N,
            native._i32(pred_src), native._i32(pred_tgt), Q,
            native._i64(obj_table_buf), native._i64(out_meta),
        )
        if rc < 0:
            raise AssembleError(f"native assembler rejected input ({rc})")
    else:
        rc = 0
        obj_table_buf[0] = 0
        out_meta[0] = 1

    from .extract import LazyValues

    log.n = N
    log.props = props
    log.mark_names = marks
    log.id_key = id_key
    log.obj_key = obj_key
    log.prop = prop
    log.action = action
    log.insert = insert.view(np.bool_)
    log.expand = expand.view(np.bool_)
    log.value_tag = value_tag
    log.value_int = value_int
    log.width = width
    log.mark_name_idx = mark_idx
    log.values = LazyValues(vcode, voff, vlen, raw_all)
    log.elem_ref = elem_ref
    log.pred_src = pred_src[:Q]
    log.pred_tgt = pred_tgt[:Q]
    if rc == 1:
        # partial history: some object id has no make op in this log —
        # the exact unique, still unioned with the make ids so childless
        # objects resolve as in oplog._finalize
        from .oplog import MAKE_ACTIONS

        make_ids = id_key[np.isin(action, MAKE_ACTIONS)]
        obj_table = np.unique(np.concatenate([[0], make_ids, obj_key]))
        log.obj_table = obj_table
        log.obj_dense = np.searchsorted(obj_table, obj_key).astype(np.int32)
        log.n_objs = len(obj_table)
    else:
        log.n_objs = int(out_meta[0])
        log.obj_table = obj_table_buf[: log.n_objs].copy()
        log.obj_dense = obj_dense
    log.count_missing()
    return log
