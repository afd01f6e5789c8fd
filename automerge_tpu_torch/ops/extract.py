"""Vectorized change-column extraction: chunk bytes -> numpy op columns.

The change chunk's own columnar encoding (reference:
change/change_op_columns.rs) is decoded straight into numpy arrays by the
native decoders (native/extract_batch.cpp) instead of one Python
``ChangeOp`` per op. Map keys and mark names become ids into a string
table; scalar payloads stay (type code, offset, length) views into the raw
value buffer, materialized when a row is read (``LazyValues``).

A change's rows are those the parser defines (storage/change.py): the
first rows of each column, as many as the change has ops; the decoders
stop there and pad a short column with nulls.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

import numpy as np

from .. import native
from ..errors import AutomergeError
from ..storage.change import (
    COL_ACTION,
    COL_EXPAND,
    COL_INSERT,
    COL_KEY_ACTOR,
    COL_KEY_CTR,
    COL_KEY_STR,
    COL_MARK_NAME,
    COL_OBJ_ACTOR,
    COL_OBJ_CTR,
    COL_PRED_ACTOR,
    COL_PRED_CTR,
    COL_PRED_GROUP,
    COL_VAL_META,
    COL_VAL_RAW,
)
from ..types import ScalarValue, get_text_encoding
from ..utils.leb128 import decode_sleb, decode_uleb


def _str_widths(raw: bytes, voff, vlen, vcode, n) -> "np.ndarray":
    """Per-row text widths in the active index unit, vectorized over the
    raw value buffer (reference: text_value.rs width-per-encoding)."""
    width = np.ones(n, np.int32)
    if not len(raw):
        return width
    srows = vcode == 6
    enc = get_text_encoding()
    if enc == "utf8":
        width[srows] = vlen[srows].astype(np.int32)
        return width
    rb = np.frombuffer(raw, np.uint8)
    cont = np.concatenate([[0], np.cumsum((rb & 0xC0) == 0x80)])
    cps = (vlen[srows] - (cont[(voff + vlen)[srows]] - cont[voff[srows]])).astype(
        np.int32
    )
    if enc == "utf16":
        # supplementary-plane code points (4-byte UTF-8) take two units
        supp = np.concatenate([[0], np.cumsum((rb & 0xF8) == 0xF0)])
        cps = cps + (supp[(voff + vlen)[srows]] - supp[voff[srows]]).astype(np.int32)
    width[srows] = cps
    return width


class ExtractError(AutomergeError):
    pass


def _int_payloads(raw: bytes, voff, vlen, vcode, n: int) -> np.ndarray:
    """The integer payloads (uint/int/counter/timestamp; booleans 0/1)."""
    out = np.empty(max(n, 1), np.int64)
    rc = native.load().am_leb_decode_rows(
        native._u8(_np_u8(raw)), len(raw), native._i64(np.ascontiguousarray(voff, np.int64)),
        native._i64(np.ascontiguousarray(vlen, np.int64)),
        native._i32(np.ascontiguousarray(vcode, np.int32)), n, native._i64(out),
    )
    if rc != 0:
        raise ExtractError(f"bad integer value payload at row {-rc - 1}")
    return out[:n]


def _col_batch(changes, spec):
    """(concatenated bytes, per-change offsets, per-change lengths)."""
    parts = []
    off = np.empty(len(changes), np.int64)
    ln = np.empty(len(changes), np.int64)
    pos = 0
    for i, ch in enumerate(changes):
        b = ch.op_col_data.get(spec, b"")
        off[i] = pos
        ln[i] = len(b)
        pos += len(b)
        parts.append(b)
    return b"".join(parts), off, ln


def _np_u8(buf: bytes) -> np.ndarray:
    return np.frombuffer(buf, np.uint8) if len(buf) else np.zeros(1, np.uint8)


_POOL = None
_POOL_INIT = False
_POOL_LOCK = threading.Lock()


def _decode_pool():
    """Shared column-decode thread pool, or None on effectively-single-CPU
    hosts (scheduler affinity, not raw core count: cgroup-limited
    containers report cores they cannot use)."""
    global _POOL, _POOL_INIT
    if not _POOL_INIT:
        with _POOL_LOCK:
            if _POOL_INIT:  # lost the race; another thread built it
                return _POOL
            try:
                n = len(os.sched_getaffinity(0))
            except AttributeError:  # non-Linux
                n = os.cpu_count() or 1
            if n > 1:
                from concurrent.futures import ThreadPoolExecutor

                _POOL = ThreadPoolExecutor(
                    max_workers=min(8, n), thread_name_prefix="amt-decode"
                )
            _POOL_INIT = True
    return _POOL


def _strtab_decode(buf: bytes, off, ln, row_off, nc: int, n_rows: int,
                   strict: bool = False):
    """Drive am_rle_decode_batch_strtab: (ids per row, string table).
    ``strict`` refuses rows past a change's row count instead of cutting
    them (a document chunk's key-string column, as the reference does)."""
    lib = native.load()
    ids = np.empty(max(n_rows, 1), np.int32)
    max_tab = max(n_rows, 1)  # each distinct string takes at least one row
    tab_off = np.empty(max_tab, np.int64)
    tab_len = np.empty(max_tab, np.int64)
    bufa = _np_u8(buf)
    tn = lib.am_rle_decode_batch_strtab(
        native._u8(bufa), native._i64(off), native._i64(ln),
        native._i64(row_off), nc, native._i32(ids), native._i64(tab_off),
        native._i64(tab_len), max_tab, int(strict),
    )
    if tn < 0:
        raise ExtractError(f"malformed string column ({tn})")
    table = [
        buf[int(tab_off[i]) : int(tab_off[i]) + int(tab_len[i])].decode("utf-8")
        for i in range(tn)
    ]
    return ids[:n_rows], table


def batch_arrays(changes) -> Dict[str, object]:
    """Decode ALL changes' op columns in one native pass per column kind.

    Output rows are change-concatenated; actor columns still carry
    chunk-local indices (the caller translates them with one table
    gather)."""
    lib = native.load()
    nc = len(changes)
    for ch in changes:
        if ch.op_col_data is None:
            raise ExtractError("change has no retained column data")
    n_ops = np.fromiter((len(ch.ops) for ch in changes), np.int64, count=nc)
    row_off = np.concatenate([[0], np.cumsum(n_ops)]).astype(np.int64)
    N = int(row_off[-1])

    def rle(spec, signed=False):
        buf, off, ln = _col_batch(changes, spec)
        out = np.empty(max(N, 1), np.int64)
        mask = np.empty(max(N, 1), np.uint8)
        rc = lib.am_rle_decode_batch(
            native._u8(_np_u8(buf)), native._i64(off), native._i64(ln),
            native._i64(row_off), nc, int(signed), native._i64(out),
            native._u8(mask),
        )
        if rc != 0:
            raise ExtractError(f"malformed column {spec} in change {-rc - 1}")
        return out[:N], mask[:N].astype(bool)

    def delta(spec):
        buf, off, ln = _col_batch(changes, spec)
        out = np.empty(max(N, 1), np.int64)
        mask = np.empty(max(N, 1), np.uint8)
        rc = lib.am_delta_decode_batch(
            native._u8(_np_u8(buf)), native._i64(off), native._i64(ln),
            native._i64(row_off), nc, native._i64(out), native._u8(mask),
        )
        if rc != 0:
            raise ExtractError(f"malformed column {spec} in change {-rc - 1}")
        return out[:N], mask[:N].astype(bool)

    def boolean(spec):
        buf, off, ln = _col_batch(changes, spec)
        out = np.empty(max(N, 1), np.uint8)
        rc = lib.am_bool_decode_batch(
            native._u8(_np_u8(buf)), native._i64(off), native._i64(ln),
            native._i64(row_off), nc, native._u8(out),
        )
        if rc != 0:
            raise ExtractError(f"malformed column {spec} in change {-rc - 1}")
        return out[:N].astype(bool)

    def strtab(spec):
        buf, off, ln = _col_batch(changes, spec)
        if not len(buf):
            return None, []
        return _strtab_decode(buf, off, ln, row_off, nc, N)

    # The independent column decodes overlap in the shared thread pool on
    # multi-core hosts (every native decode releases the GIL through
    # ctypes); small batches (served deltas) and single-core hosts run
    # them in turn, where a pool's round trip costs more than the decodes.
    tasks = [
        (rle, COL_ACTION), (rle, COL_OBJ_CTR), (rle, COL_OBJ_ACTOR),
        (delta, COL_KEY_CTR), (rle, COL_KEY_ACTOR), (boolean, COL_INSERT),
        (boolean, COL_EXPAND), (rle, COL_VAL_META), (strtab, COL_KEY_STR),
        (strtab, COL_MARK_NAME), (rle, COL_PRED_GROUP),
    ]
    pool = _decode_pool() if N >= (1 << 14) else None
    if pool is not None:
        futs = [pool.submit(fn, spec) for fn, spec in tasks]
        results = [f.result() for f in futs]
    else:
        results = [fn(spec) for fn, spec in tasks]
    (
        (action, amask), (obj_ctr, obj_mask), (obj_actor, obj_amask),
        (key_ctr, key_ctr_mask), (key_actor, key_actor_mask), insert,
        expand, (meta, meta_mask), (key_ids, key_table),
        (mark_ids, mark_table), (pred_num, pn_mask),
    ) = results
    if not amask.all():
        raise ExtractError("action column mismatch")
    meta = np.where(meta_mask, meta, 0)
    pred_num = np.where(pn_mask, pred_num, 0)
    pn_cum = np.concatenate([[0], np.cumsum(pred_num)]).astype(np.int64)
    per_change_preds = pn_cum[row_off[1:]] - pn_cum[row_off[:-1]]
    pred_row_off = np.concatenate([[0], np.cumsum(per_change_preds)]).astype(np.int64)
    Q = int(pred_row_off[-1])

    def pred_col(spec, is_delta):
        buf, off, ln = _col_batch(changes, spec)
        out = np.empty(max(Q, 1), np.int64)
        mask = np.empty(max(Q, 1), np.uint8)
        if is_delta:
            rc = lib.am_delta_decode_batch(
                native._u8(_np_u8(buf)), native._i64(off), native._i64(ln),
                native._i64(pred_row_off), nc, native._i64(out), native._u8(mask),
            )
        else:
            rc = lib.am_rle_decode_batch(
                native._u8(_np_u8(buf)), native._i64(off), native._i64(ln),
                native._i64(pred_row_off), nc, 0, native._i64(out),
                native._u8(mask),
            )
        if rc != 0:
            raise ExtractError(f"malformed pred column {spec} in change {-rc - 1}")
        if Q and not mask[:Q].all():
            raise ExtractError("null pred entries")
        return out[:Q]

    pred_ctr = pred_col(COL_PRED_CTR, True)
    pred_actor = pred_col(COL_PRED_ACTOR, False)

    # value payloads: per-change raw buffers concatenated; offsets rebased
    raw, raw_off, raw_ln = _col_batch(changes, COL_VAL_RAW)
    vcode = (meta & 0xF).astype(np.int32)
    vlen = (meta >> 4).astype(np.int64)
    change_of_row = np.repeat(np.arange(nc), n_ops)
    vend = np.cumsum(vlen)
    voff = vend - vlen
    # rebase per change: local offset + that change's slice start in `raw`
    base = np.zeros(nc, np.int64)
    if N:
        base_local = voff[row_off[:-1].clip(max=max(N - 1, 0))]
        base_local[n_ops == 0] = 0
        base = base_local
    voff = voff - base[change_of_row] + raw_off[change_of_row]
    limit = (raw_off + raw_ln)[change_of_row]
    if N and np.any(voff + vlen > limit):
        raise ExtractError("value raw column overrun")

    # integer payloads (the kernels need them eagerly)
    value_int = _int_payloads(raw, voff, vlen, vcode, N)
    width = _str_widths(raw, voff, vlen, vcode, N)

    return {
        "n": N,
        "n_ops": n_ops,
        "row_off": row_off,
        "raw_off": raw_off,
        "raw_ln": raw_ln,
        "change_of_row": change_of_row,
        "action": action.astype(np.int32),
        "obj_ctr": np.where(obj_mask, obj_ctr, 0),
        "obj_has": obj_mask & obj_amask,
        "obj_actor": np.where(obj_amask, obj_actor, 0),
        "key_ctr": np.where(key_ctr_mask, key_ctr, -1),
        "key_actor": np.where(key_actor_mask, key_actor, 0),
        "key_has_actor": key_actor_mask,
        "key_ids": key_ids,
        "key_table": key_table,
        "mark_ids": mark_ids,
        "mark_table": mark_table,
        "insert": insert,
        "expand": expand,
        "vcode": vcode,
        "voff": voff,
        "vlen": vlen,
        "vraw": raw,
        "value_int": value_int,
        "width": width,
        "pred_num": pred_num.astype(np.int64),
        "pred_ctr": pred_ctr,
        "pred_actor": pred_actor,
        "pred_row_off": pred_row_off,
    }


# a ScalarValue built without NamedTuple's Python-level __new__ (half the
# cost, on the read path's hottest line)
_new_value = tuple.__new__


class LazyValues:
    """Row -> ScalarValue, materialized on demand from the raw value buffer.

    Stands in for the eager list of the per-op path. The per-row cache is
    BOUNDED (``cap``, default 65,536 entries): a long-lived document over
    a log of millions of rows would otherwise keep one ScalarValue per row
    ever read. Eviction is insertion-order FIFO, O(1) a row through a ring
    of the cached rows (popping a plain dict's oldest key rescans the slots
    freed before it, which made a text read of 380k rows quadratic).
    """

    __slots__ = ("code", "off", "ln", "raw", "cache", "cap", "_ring", "_next")

    def __init__(self, code: np.ndarray, off: np.ndarray, ln: np.ndarray,
                 raw: bytes, cap: int = 1 << 16):
        self.code = code
        self.off = off
        self.ln = ln
        self.raw = raw
        self.cache: Dict[int, ScalarValue] = {}
        self.cap = cap
        self._ring: list = []  # cached rows, oldest at _next once full
        self._next = 0

    def __len__(self) -> int:
        return len(self.code)

    def __getitem__(self, row: int) -> ScalarValue:
        v = self.cache.get(row)
        if v is None:
            if self.code.item(row) == 6:  # a string (a character): inline
                o = self.off.item(row)
                v = _new_value(ScalarValue, (
                    "str", self.raw[o : o + self.ln.item(row)].decode("utf-8")))
            else:
                v = self._decode(row)
            if self.cap > 0:
                ring = self._ring
                if len(ring) < self.cap:
                    ring.append(row)
                else:
                    i = self._next
                    del self.cache[ring[i]]
                    ring[i] = row
                    self._next = (i + 1) % self.cap
                self.cache[row] = v
        return v

    def text(self, rows: np.ndarray, other: str) -> str:
        """The strings of ``rows`` joined, ``other`` for each row that
        holds no string: one gather over the raw heap and one UTF-8 decode
        (each row's bytes are valid UTF-8 alone, so the join decodes to
        the join of the strings), no value built and no row cached."""
        rows = np.asarray(rows, np.int64)
        is_str = self.code[rows] == 6
        ln = self.ln[rows].astype(np.int64)
        fill = np.frombuffer(other.encode("utf-8"), np.uint8)
        size = np.where(is_str, ln, len(fill))
        start = np.cumsum(size) - size
        out = np.empty(int(size.sum()), np.uint8)
        s_ln = ln[is_str]
        k = int(s_ln.sum())
        if k:
            within = np.arange(k) - np.repeat(np.cumsum(s_ln) - s_ln, s_ln)
            src = np.repeat(self.off[rows][is_str].astype(np.int64), s_ln) + within
            out[np.repeat(start[is_str], s_ln) + within] = (
                np.frombuffer(self.raw, np.uint8)[src])
        others = start[~is_str]
        for j, b in enumerate(fill):
            out[others + j] = b
        return out.tobytes().decode("utf-8")

    def _decode(self, row: int) -> ScalarValue:
        import struct

        code = self.code.item(row)
        o = self.off.item(row)
        ln = self.ln.item(row)
        if code == 6:
            return ScalarValue("str", self.raw[o : o + ln].decode("utf-8"))
        # the raw heap may be a (shared, append-only) bytearray; values
        # must come out as immutable bytes
        chunk = bytes(self.raw[o : o + ln])
        if code == 0:
            return ScalarValue("null")
        if code == 1:
            return ScalarValue("bool", False)
        if code == 2:
            return ScalarValue("bool", True)
        if code == 3:
            return ScalarValue("uint", decode_uleb(chunk, 0)[0])
        if code == 4:
            return ScalarValue("int", decode_sleb(chunk, 0)[0])
        if code == 5:
            return ScalarValue("f64", struct.unpack("<d", chunk)[0])
        if code == 7:
            return ScalarValue("bytes", chunk)
        if code == 8:
            return ScalarValue("counter", decode_sleb(chunk, 0)[0])
        if code == 9:
            return ScalarValue("timestamp", decode_sleb(chunk, 0)[0])
        return ScalarValue("unknown", (code, chunk))


def doc_op_arrays(col_data) -> Dict[str, object]:
    """Decode document-chunk op columns (storage/document.py OP_*) into
    numpy arrays with the native codecs (native/codecs.cpp): the fast load
    path's input.

    Strict about shape regularities the encoder always produces (action
    column defines the row count and every other column covers or
    null-pads it); anything irregular raises ExtractError and the caller
    hands the chunk to the per-op python decoder, which reports precise
    errors for genuinely malformed files.
    """
    from ..storage import document as D

    def col(s) -> bytes:
        return col_data.get(s, b"")

    def rle_full(buf, signed=False):
        cap = max(1024, len(buf))
        while True:
            v, m = native.rle_decode_array(buf, signed, cap)
            if len(v) < cap:
                return v, m
            cap *= 4

    def delta_full(buf):
        cap = max(1024, len(buf))
        while True:
            v, m = native.delta_decode_array(buf, cap)
            if len(v) < cap:
                return v, m
            cap *= 4

    action, amask = rle_full(col(D.OP_ACTION))
    n = len(action)
    if n == 0 or not amask.all():
        raise ExtractError("doc ops: empty or null action column")

    def pad_to_n(v, m):
        if len(v) > n:
            raise ExtractError("doc ops: column longer than action column")
        if len(v) < n:
            v2 = np.zeros(n, v.dtype)
            v2[: len(v)] = v
            m2 = np.zeros(n, bool)
            m2[: len(m)] = m
            return v2, m2
        return v, m

    id_ctr, id_cm = pad_to_n(*delta_full(col(D.OP_ID_CTR)))
    id_actor, id_am = pad_to_n(*rle_full(col(D.OP_ID_ACTOR)))
    if not (id_cm.all() and id_am.all()):
        raise ExtractError("doc ops: missing id column values")
    obj_ctr, obj_cm = pad_to_n(*rle_full(col(D.OP_OBJ_CTR)))
    obj_actor, obj_am = pad_to_n(*rle_full(col(D.OP_OBJ_ACTOR)))
    if not np.array_equal(obj_cm, obj_am):
        raise ExtractError("doc ops: half-null object id")
    key_ctr, key_cm = pad_to_n(*delta_full(col(D.OP_KEY_CTR)))
    key_actor, key_am = pad_to_n(*rle_full(col(D.OP_KEY_ACTOR)))

    def bools(buf):
        out = native.bool_decode_array(buf, n)
        if len(out) < n:
            out = np.concatenate([out, np.zeros(n - len(out), bool)])
        return out.astype(np.uint8)

    insert = bools(col(D.OP_INSERT))
    expand = bools(col(D.OP_EXPAND))

    def strtab(buf, strict):
        if not len(buf):
            return np.full(n, -1, np.int32), []
        return _strtab_decode(
            buf, np.zeros(1, np.int64), np.asarray([len(buf)], np.int64),
            np.asarray([0, n], np.int64), 1, n, strict,
        )

    # a key-string column past the action column's rows is refused (the
    # per-op decoder then raises as the reference's does); the mark-name
    # column's tail is ignored by both decoders, so it keeps its cut
    key_ids, key_table = strtab(col(D.OP_KEY_STR), True)
    mark_ids, mark_table = strtab(col(D.OP_MARK_NAME), False)

    vm, vmm = pad_to_n(*rle_full(col(D.OP_VAL_META)))
    if not vmm.all():
        raise ExtractError("doc ops: null value metadata")
    vcode = (vm & 15).astype(np.int32)
    vlen = (vm >> 4).astype(np.int64)
    voff = np.concatenate([[0], np.cumsum(vlen)[:-1]]).astype(np.int64)
    raw = col(D.OP_VAL_RAW)
    if n and int(voff[-1] + vlen[-1]) > len(raw):
        raise ExtractError("doc ops: value raw column overrun")

    succ_num, snm = pad_to_n(*rle_full(col(D.OP_SUCC_GROUP)))
    succ_num = np.where(snm, succ_num, 0).astype(np.int64)
    total = int(succ_num.sum())
    sa, sam = rle_full(col(D.OP_SUCC_ACTOR))
    sc, scm = delta_full(col(D.OP_SUCC_CTR))
    if len(sa) < total or len(sc) < total:
        raise ExtractError("doc ops: truncated succ columns")
    if not (sam[:total].all() and scm[:total].all()):
        raise ExtractError("doc ops: null succ id")

    return {
        "n": n,
        "action": action.astype(np.int64),
        "id_ctr": id_ctr.astype(np.int64),
        "id_actor": id_actor.astype(np.int64),
        "obj_ctr": np.where(obj_cm, obj_ctr, 0).astype(np.int64),
        "obj_actor": np.where(obj_am, obj_actor, 0).astype(np.int64),
        "obj_mask": obj_cm,
        "key_ctr": key_ctr.astype(np.int64),
        "key_ctr_mask": key_cm,
        "key_actor": np.where(key_am, key_actor, 0).astype(np.int64),
        "key_actor_mask": key_am,
        "key_ids": key_ids,
        "key_table": key_table,
        "mark_ids": mark_ids,
        "mark_table": mark_table,
        "insert": insert,
        "expand": expand,
        "vcode": vcode,
        "vlen": vlen,
        "voff": voff,
        "vraw": raw,
        "succ_num": succ_num,
        "succ_ctr": sc[:total].astype(np.int64),
        "succ_actor": sa[:total].astype(np.int64),
    }


def validate_doc_arrays(a, n_actors: int) -> None:
    """Bounds/magnitude guards over doc_op_arrays output: actor indices in
    [0, n_actors), counters within the 43-bit packed-id range. Raises
    ExtractError: callers hand the chunk to the per-op python decoder,
    which reports the canonical error for genuinely malformed files."""
    lim = 1 << 43

    def ctr_ok(v, mask=None):
        if mask is not None:
            v = v[mask]
        if len(v) and (int(v.min()) < 0 or int(v.max()) >= lim):
            raise ExtractError("counter outside packed range")

    def actor_ok(v, mask=None):
        if mask is not None:
            v = v[mask]
        if len(v) and (int(v.min()) < 0 or int(v.max()) >= n_actors):
            raise ExtractError("actor index out of range")

    ctr_ok(a["id_ctr"])
    ctr_ok(a["succ_ctr"])
    ctr_ok(a["obj_ctr"], a["obj_mask"].astype(bool))
    ctr_ok(a["key_ctr"], a["key_ctr_mask"].astype(bool))
    actor_ok(a["id_actor"])
    actor_ok(a["succ_actor"])
    actor_ok(a["obj_actor"], a["obj_mask"].astype(bool))
    actor_ok(a["key_actor"], a["key_actor_mask"].astype(bool))
