"""The run-coded snapshot ("ARSN"): the compressed column image as the
format on disk.

The port of ``automerge_tpu/storage/runsnap.py``, byte for byte: each
package reads the other's images. A snapshot in change chunks makes a
cold open parse every change and build the columns and their run tables
from scratch. An ARSN image stores the resident form instead:

* each change's raw chunk bytes verbatim (the hash is the chunk's, so
  digests and sync bytes are those of the chunks), with its op count, so
  that ops decode lazily;
* the ``CompressedOpColumns`` run tables of every ROW_SPEC / EDGE_SPEC
  column (a demoted column is stored dense, verbatim);
* the scalar value heap, the actor, prop and mark tables, the object
  table and the heads.

Opening one is a read, a CRC walk over the sections and an ``np.repeat``
expansion of the runs (``RunImage.to_oplog``): no op column is parsed and
nothing is encoded again. The layout:

    magic "ARSN" | version u8 | flags u8
    repeated sections: tag u8 | ULEB payload_len | payload | CRC32 LE
                       (CRC over tag + length + payload)

Flag bit 0 records that compressed residency was on when the image was
written: opening it then installs the run tables (and each column's
demotion) as the log's compressed image instead of deriving them again.

Corruption raises :class:`RunSnapError`. Whether new snapshots are
written in this format is the durable layer's choice (its writer
switch), not this module's.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..utils.leb128 import decode_sleb, decode_uleb, sleb_bytes, uleb_bytes
from . import columns as colio
from .change import LazyOps, StoredChange
from .chunk import parse_chunk

MAGIC = b"ARSN"
VERSION = 1
FLAG_COMPRESSED = 0x01

SEC_META = 1
SEC_ACTORS = 2
SEC_HEADS = 3
SEC_CHANGES = 4
SEC_RUNS = 5
SEC_VALUES = 6
SEC_OBJTAB = 7

SECTION_NAMES = {
    SEC_META: "meta",
    SEC_ACTORS: "actors",
    SEC_HEADS: "heads",
    SEC_CHANGES: "changes",
    SEC_RUNS: "runs",
    SEC_VALUES: "values",
    SEC_OBJTAB: "objtab",
}

# column entry kinds inside SEC_RUNS
_K_ABSENT = 0
_K_RUNS = 1
_K_DENSE = 2

# target dtypes for each OpLog slot on decode (mirrors OpLog._finalize)
_COL_DTYPES = {
    "action": np.int32,
    "insert": np.bool_,
    "prop": np.int32,
    "value_tag": np.int32,
    "width": np.int32,
    "expand": np.bool_,
    "mark_name_idx": np.int32,
    "obj_dense": np.int32,
    "id_key": np.int64,
    "obj_key": np.int64,
    "elem_key": np.int64,
    "elem_ref": np.int32,
    "value_int": np.int64,
    "pred_src": np.int32,
    "pred_tgt": np.int32,
    "pred_key": np.int64,
}


class RunSnapError(Exception):
    """ARSN container is malformed or corrupt."""


def enabled() -> bool:
    """Write new snapshots in the run-coded format? (reader is always on;
    ``AUTOMERGE_TPU_RUNSNAP=0`` writes change-chunk snapshots)"""
    return os.environ.get("AUTOMERGE_TPU_RUNSNAP", "1") != "0"


def is_runsnap(data: bytes) -> bool:
    return len(data) >= 6 and data[:4] == MAGIC


# -- low-level framing -------------------------------------------------------


def _put_array(out: bytearray, arr: Optional[np.ndarray]) -> None:
    if arr is None:
        out += b"\x00"
        return
    arr = np.ascontiguousarray(arr)
    ds = arr.dtype.str.encode("ascii")
    out += bytes([len(ds)])
    out += ds
    raw = arr.tobytes()
    out += uleb_bytes(len(raw))
    out += raw


def _get_array(data: bytes, pos: int) -> Tuple[Optional[np.ndarray], int]:
    dlen = data[pos]
    pos += 1
    if dlen == 0:
        return None, pos
    ds = data[pos : pos + dlen].decode("ascii")
    pos += dlen
    nbytes, pos = decode_uleb(data, pos)
    if pos + nbytes > len(data):
        raise RunSnapError("array extends past section end")
    # .copy(): frombuffer views are read-only and several consumers
    # (StrideRuns.extend_tail, in-place re-resolution) mutate columns
    arr = np.frombuffer(data, dtype=np.dtype(ds), count=nbytes // np.dtype(ds).itemsize, offset=pos).copy()
    return arr, pos + nbytes


def _put_bytes(out: bytearray, b: bytes) -> None:
    out += uleb_bytes(len(b))
    out += b


def _get_bytes(data: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = decode_uleb(data, pos)
    if pos + n > len(data):
        raise RunSnapError("byte string extends past section end")
    return bytes(data[pos : pos + n]), pos + n


def _emit_section(out: bytearray, tag: int, payload: bytes) -> None:
    frame = bytes([tag]) + uleb_bytes(len(payload)) + payload
    out += frame
    out += zlib.crc32(frame).to_bytes(4, "little")


def _specs():
    from ..ops.compressed import EDGE_SPEC, ROW_SPEC

    return list(ROW_SPEC) + list(EDGE_SPEC)


# -- encoder -----------------------------------------------------------------


def encode_snapshot(log, heads: List[bytes]) -> bytes:
    """Serialize an OpLog (with raw change bytes) as an ARSN container.

    Raises :class:`RunSnapError` when the log cannot be represented (a
    change without ``raw_bytes``); the caller then writes change chunks.
    """
    from ..ops import compressed as C

    changes = log.changes
    for ch in changes:
        if ch.raw_bytes is None:
            raise RunSnapError("change without raw chunk bytes")

    comp = None
    flags = 0
    if C.enabled():
        flags |= FLAG_COMPRESSED
        existing = getattr(log, "_comp", None)
        live = [nm for nm, _, _ in _specs() if getattr(log, nm, None) is not None]
        if existing is not None and existing.entries and existing.all_dense(live):
            # every live column already demoted: skip the compressed
            # sync/encode walk entirely and write dense directly
            obs.count("compact.dense_shortcut")
            comp = None
        else:
            comp = log.compressed(sync=True)

    out = bytearray()
    out += MAGIC
    out += bytes([VERSION, flags])

    n = int(log.n)
    q = 0 if getattr(log, "pred_src", None) is None else len(log.pred_src)

    meta = bytearray()
    meta += uleb_bytes(n)
    meta += uleb_bytes(q)
    meta += uleb_bytes(len(changes))
    meta += uleb_bytes(int(getattr(log, "n_objs", 0) or 0))
    _emit_section(out, SEC_META, bytes(meta))

    actors = bytearray()
    actors += uleb_bytes(len(log.actors))
    for a in log.actors:
        _put_bytes(actors, a.bytes if hasattr(a, "bytes") else bytes(a))
    actors += uleb_bytes(len(log.props))
    for p in log.props:
        _put_bytes(actors, p.encode("utf-8"))
    actors += uleb_bytes(len(log.mark_names))
    for m in log.mark_names:
        _put_bytes(actors, m.encode("utf-8"))
    _emit_section(out, SEC_ACTORS, bytes(actors))

    hd = bytearray()
    hd += uleb_bytes(len(heads))
    for h in sorted(heads):
        if len(h) != 32:
            raise RunSnapError("head hash is not 32 bytes")
        hd += h
    _emit_section(out, SEC_HEADS, bytes(hd))

    chs = bytearray()
    chs += uleb_bytes(len(changes))
    for ch in changes:
        chs += uleb_bytes(len(ch.ops))
        _put_bytes(chs, ch.raw_bytes)
    _emit_section(out, SEC_CHANGES, bytes(chs))

    runs = bytearray()
    for name, _mode, _item in _specs():
        arr = getattr(log, name, None)
        if arr is None:
            runs += bytes([_K_ABSENT])
            continue
        rows = len(arr)
        sr = comp.runs_for(name, rows) if comp is not None else None
        if sr is not None:
            runs += bytes([_K_RUNS])
            rflags = (1 if sr.is_sorted else 0) | (2 if sr.stride_mode else 0)
            runs += bytes([rflags])
            ds = np.dtype(sr.dtype).str.encode("ascii")
            runs += bytes([len(ds)])
            runs += ds
            runs += uleb_bytes(len(sr.starts))
            runs += uleb_bytes(rows)
            runs += np.ascontiguousarray(sr.starts, np.int64).tobytes()
            runs += np.ascontiguousarray(sr.vals, np.int64).tobytes()
            runs += np.ascontiguousarray(sr.strides, np.int64).tobytes()
        else:
            runs += bytes([_K_DENSE])
            if arr.dtype == np.bool_:
                dense = np.ascontiguousarray(arr, np.bool_).view(np.int8)
            else:
                dense = arr
            _put_array(runs, dense)
    _emit_section(out, SEC_RUNS, bytes(runs))

    vals = bytearray()
    code, off, ln, raw = _value_heap(log)
    _put_array(vals, code)
    _put_array(vals, off)
    _put_array(vals, ln)
    _put_bytes(vals, raw)
    _emit_section(out, SEC_VALUES, bytes(vals))

    ot = bytearray()
    _put_array(ot, getattr(log, "obj_table", None))
    _emit_section(out, SEC_OBJTAB, bytes(ot))

    return bytes(out)


def _value_heap(log) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bytes]:
    """The (code, off, len, raw) scalar heap for a log, converting an eager
    value list to the lazy layout when needed."""
    vals = log.values
    if vals is None:
        z = np.zeros(0, np.int32)
        return z, np.zeros(0, np.int64), z.copy(), b""
    if hasattr(vals, "code"):  # LazyValues
        return (
            np.asarray(vals.code),
            np.asarray(vals.off),
            np.asarray(vals.ln),
            bytes(vals.raw),
        )
    from .values import encode_raw_value, value_meta

    n = len(vals)
    code = np.zeros(n, np.int32)
    off = np.zeros(n, np.int64)
    ln = np.zeros(n, np.int32)
    raw = bytearray()
    for i, v in enumerate(vals):
        m = value_meta(v)
        code[i] = m & 0x0F
        ln[i] = m >> 4
        off[i] = len(raw)
        encode_raw_value(v, raw)
    return code, off, ln, bytes(raw)


# -- decoder -----------------------------------------------------------------


class _RunCol:
    __slots__ = ("flags", "dtype", "starts", "vals", "strides", "rows")

    def __init__(self, flags, dtype, starts, vals, strides, rows):
        self.flags = flags
        self.dtype = dtype
        self.starts = starts
        self.vals = vals
        self.strides = strides
        self.rows = rows

    def decode(self) -> np.ndarray:
        return self._runs().decode()

    def _runs(self):
        from ..ops.compressed import StrideRuns

        return StrideRuns(
            self.starts, self.vals, self.strides, self.rows, self.dtype,
            bool(self.flags & 1), bool(self.flags & 2),
        )

    @property
    def nbytes(self) -> int:
        return self.starts.nbytes + self.vals.nbytes + self.strides.nbytes


class RunImage:
    """A parsed ARSN container: the column image and the raw change
    blob. ``to_oplog`` builds a log from it without extracting a column
    from the changes; ``changes`` decodes the change envelopes lazily."""

    __slots__ = (
        "version",
        "flags",
        "n",
        "q",
        "n_changes",
        "n_objs",
        "actors",
        "props",
        "mark_names",
        "heads",
        "cols",
        "values",
        "obj_table",
        "_change_blob",
        "_changes",
        "_hashes",
    )

    def __init__(self):
        self.version = VERSION
        self.flags = 0
        self.n = 0
        self.q = 0
        self.n_changes = 0
        self.n_objs = 0
        self.actors: List[bytes] = []
        self.props: List[str] = []
        self.mark_names: List[str] = []
        self.heads: List[bytes] = []
        self.cols: Dict[str, object] = {}
        self.values = (None, None, None, b"")
        self.obj_table: Optional[np.ndarray] = None
        self._change_blob: Optional[bytes] = None
        self._changes: Optional[List[StoredChange]] = None
        self._hashes: Optional[List[bytes]] = None

    # -- changes -------------------------------------------------------------

    @property
    def changes(self) -> List[StoredChange]:
        if self._changes is None:
            self._changes = _load_changes(self._change_blob)
            self._hashes = [c.hash for c in self._changes]
        return self._changes

    def change_hashes(self) -> List[bytes]:
        if self._hashes is None:
            self.changes
        return list(self._hashes)

    @property
    def nbytes(self) -> int:
        total = len(self._change_blob or b"")
        for ent in self.cols.values():
            if ent is None:
                continue
            total += ent.nbytes
        code, off, ln, raw = self.values
        for a in (code, off, ln):
            if a is not None:
                total += a.nbytes
        total += len(raw)
        if self.obj_table is not None:
            total += self.obj_table.nbytes
        return total

    # -- hydration -----------------------------------------------------------

    def to_oplog(self, changes: Optional[List[StoredChange]] = None):
        """Rebuild a fully-populated OpLog from the image without touching
        change op columns: run tables expand via ``np.repeat``, dense columns
        copy straight in — zero re-encode."""
        from ..ops import compressed as C
        from ..ops.compressed import CompressedOpColumns
        from ..ops.extract import LazyValues
        from ..ops.oplog import ELEM_MISSING, OpLog
        from ..types import ActorId

        log = OpLog()
        log.changes = list(changes) if changes is not None else list(self.changes)
        log.actors = [ActorId(a) for a in self.actors]
        log.props = list(self.props)
        log.mark_names = list(self.mark_names)
        log.n = self.n

        install_comp = bool(self.flags & FLAG_COMPRESSED) and C.enabled()
        comp = CompressedOpColumns() if install_comp else None

        for name, _mode, _item in _specs():
            ent = self.cols.get(name)
            want = _COL_DTYPES[name]
            rows = self.q if name in ("pred_src", "pred_tgt", "pred_key") else self.n
            if ent is None:
                setattr(log, name, None)
                continue
            if isinstance(ent, _RunCol):
                arr = ent.decode()
                if arr.dtype != want:
                    arr = arr.astype(want)
                setattr(log, name, arr)
                if comp is not None:
                    # a fresh StrideRuns copy: extend_tail mutates run arrays
                    # in place, so the image's arrays must never be shared
                    sr = ent._runs()
                    sr.starts = sr.starts.copy()
                    sr.vals = sr.vals.copy()
                    sr.strides = sr.strides.copy()
                    comp.entries[name] = sr
                    comp.covered[name] = rows
            else:
                arr = ent
                if want == np.bool_:
                    arr = arr.astype(np.bool_)
                elif arr.dtype != want:
                    arr = arr.astype(want)
                setattr(log, name, arr)
                if comp is not None:
                    comp.entries[name] = C._DENSE
                    comp.covered[name] = rows
                    comp.demoted[name] = "ratio"

        code, off, ln, raw = self.values
        if code is not None:
            log.values = LazyValues(code.copy(), off.copy(), ln.copy(), raw)
        else:
            log.values = []
        if self.obj_table is not None:
            log.obj_table = self.obj_table.copy()
            log.n_objs = len(log.obj_table)
        if log.elem_ref is not None:
            log.n_miss_elem = int(np.count_nonzero(log.elem_ref == ELEM_MISSING))
        if log.pred_tgt is not None:
            log.n_miss_pred = int(np.count_nonzero(log.pred_tgt < 0))
        log._comp = comp
        return log

    @classmethod
    def from_log(cls, log) -> "RunImage":
        """An in-memory image of a log's columns (copies), equal to
        ``parse(encode_snapshot(log, ...))``'s: a log about to be released
        keeps its run tables in it, so that the next ``to_oplog`` encodes
        nothing."""
        from ..ops import compressed as C

        img = cls()
        img.flags = FLAG_COMPRESSED if C.enabled() else 0
        img.n = int(log.n)
        img.q = 0 if getattr(log, "pred_src", None) is None else len(log.pred_src)
        img.n_changes = len(log.changes)
        img.actors = [a.bytes if hasattr(a, "bytes") else bytes(a) for a in log.actors]
        img.props = list(log.props)
        img.mark_names = list(log.mark_names)
        comp = getattr(log, "_comp", None) if C.enabled() else None
        for name, _mode, _item in _specs():
            arr = getattr(log, name, None)
            if arr is None:
                img.cols[name] = None
                continue
            ent = comp.runs_for(name, len(arr)) if comp is not None else None
            if ent is not None:
                img.cols[name] = _RunCol(
                    (1 if ent.is_sorted else 0) | (2 if ent.stride_mode else 0),
                    np.dtype(ent.dtype),
                    ent.starts.copy(),
                    ent.vals.copy(),
                    ent.strides.copy(),
                    len(arr),
                )
            else:
                dense = arr.view(np.int8) if arr.dtype == np.bool_ else arr
                img.cols[name] = np.ascontiguousarray(dense).copy()
        img.values = _value_heap(log)
        ot = getattr(log, "obj_table", None)
        img.obj_table = None if ot is None else ot.copy()
        img.n_objs = 0 if img.obj_table is None else len(img.obj_table)
        img._changes = list(log.changes)
        img._hashes = [c.hash for c in img._changes]
        return img


def _load_changes(blob: Optional[bytes]) -> List[StoredChange]:
    """The cheap change loader: raw chunk bytes to ``StoredChange``s with
    lazy ops. Parses only the chunk envelope (checking its checksum, which
    also gives the change hash) and the header; the op columns stay sliced
    bytes inside a ``LazyOps``, as ``parse_change`` leaves them, but are
    not checked (no ``native.change_check``): the image's writer held
    them already."""
    if not blob:
        return []
    out: List[StoredChange] = []
    pos = 0
    n_changes, pos = decode_uleb(blob, pos)
    for _ in range(n_changes):
        n_ops, pos = decode_uleb(blob, pos)
        raw_len, pos = decode_uleb(blob, pos)
        raw = bytes(blob[pos : pos + raw_len])
        if len(raw) != raw_len:
            raise RunSnapError("truncated change record")
        pos += raw_len
        chunk, _end = parse_chunk(raw, 0)
        if not chunk.checksum_valid:
            raise RunSnapError("change chunk checksum mismatch")
        data = chunk.data
        p = 0
        ndeps, p = decode_uleb(data, p)
        deps = [bytes(data[p + 32 * i : p + 32 * i + 32]) for i in range(ndeps)]
        p += 32 * ndeps
        alen, p = decode_uleb(data, p)
        actor = bytes(data[p : p + alen])
        p += alen
        seq, p = decode_uleb(data, p)
        start_op, p = decode_uleb(data, p)
        tsv, p = decode_sleb(data, p)
        mlen, p = decode_uleb(data, p)
        msg = bytes(data[p : p + mlen]).decode("utf-8") if mlen else None
        p += mlen
        nother, p = decode_uleb(data, p)
        others = []
        for _i in range(nother):
            olen, p = decode_uleb(data, p)
            others.append(bytes(data[p : p + olen]))
            p += olen
        metas, p = colio.parse_columns(data, p)
        col_data = colio.slice_column_data(data, metas, p)
        p += colio.total_column_len(metas)
        extra = bytes(data[p:])
        sc = StoredChange(
            dependencies=deps,
            actor=actor,
            other_actors=others,
            seq=seq,
            start_op=start_op,
            timestamp=tsv,
            message=msg,
            ops=LazyOps(dict(col_data), n_ops),
            extra_bytes=extra,
            hash=chunk.hash,
            raw_bytes=raw,
            op_col_data=dict(col_data),
        )
        out.append(sc)
    return out


def _walk_sections(data: bytes):
    """Yield (tag, payload, frame_start) for each CRC-valid section; raise
    RunSnapError at the first malformed/corrupt frame."""
    if not is_runsnap(data):
        raise RunSnapError("not an ARSN container")
    if data[4] != VERSION:
        raise RunSnapError(f"unsupported ARSN version {data[4]}")
    pos = 6
    end = len(data)
    while pos < end:
        start = pos
        if pos + 1 > end:
            raise RunSnapError("truncated section tag")
        tag = data[pos]
        try:
            plen, body = decode_uleb(data, pos + 1)
        except Exception as e:
            raise RunSnapError(f"bad section length: {e}") from None
        if body + plen + 4 > end:
            raise RunSnapError(
                f"section {SECTION_NAMES.get(tag, tag)} extends past EOF"
            )
        frame = data[start : body + plen]
        crc = int.from_bytes(data[body + plen : body + plen + 4], "little")
        if zlib.crc32(frame) != crc:
            raise RunSnapError(
                f"section {SECTION_NAMES.get(tag, tag)} CRC mismatch at offset {start}"
            )
        yield tag, bytes(data[body : body + plen]), start
        pos = body + plen + 4


def parse(data: bytes) -> RunImage:
    """Decode an ARSN container into a RunImage; RunSnapError on corruption."""
    img = RunImage()
    img.flags = data[5] if len(data) > 5 else 0
    seen = set()
    for tag, payload, _start in _walk_sections(data):
        seen.add(tag)
        try:
            _parse_section(img, tag, payload)
        except RunSnapError:
            raise
        except Exception as e:
            raise RunSnapError(
                f"section {SECTION_NAMES.get(tag, tag)} malformed: {e}"
            ) from None
    required = {SEC_META, SEC_ACTORS, SEC_HEADS, SEC_CHANGES, SEC_RUNS, SEC_VALUES, SEC_OBJTAB}
    missing = required - seen
    if missing:
        raise RunSnapError(
            "missing sections: " + ", ".join(sorted(SECTION_NAMES[t] for t in missing))
        )
    return img


def _parse_section(img: RunImage, tag: int, payload: bytes) -> None:
    p = 0
    if tag == SEC_META:
        img.n, p = decode_uleb(payload, p)
        img.q, p = decode_uleb(payload, p)
        img.n_changes, p = decode_uleb(payload, p)
        img.n_objs, p = decode_uleb(payload, p)
    elif tag == SEC_ACTORS:
        na, p = decode_uleb(payload, p)
        for _ in range(na):
            b, p = _get_bytes(payload, p)
            img.actors.append(b)
        np_, p = decode_uleb(payload, p)
        for _ in range(np_):
            b, p = _get_bytes(payload, p)
            img.props.append(b.decode("utf-8"))
        nm, p = decode_uleb(payload, p)
        for _ in range(nm):
            b, p = _get_bytes(payload, p)
            img.mark_names.append(b.decode("utf-8"))
    elif tag == SEC_HEADS:
        nh, p = decode_uleb(payload, p)
        for _ in range(nh):
            if p + 32 > len(payload):
                raise RunSnapError("truncated head hash")
            img.heads.append(bytes(payload[p : p + 32]))
            p += 32
    elif tag == SEC_CHANGES:
        img._change_blob = payload
    elif tag == SEC_RUNS:
        for name, _mode, _item in _specs():
            kind = payload[p]
            p += 1
            rows = img.q if name in ("pred_src", "pred_tgt", "pred_key") else img.n
            if kind == _K_ABSENT:
                img.cols[name] = None
            elif kind == _K_RUNS:
                rflags = payload[p]
                p += 1
                dlen = payload[p]
                p += 1
                ds = payload[p : p + dlen].decode("ascii")
                p += dlen
                nr, p = decode_uleb(payload, p)
                n_rows, p = decode_uleb(payload, p)
                if n_rows != rows:
                    raise RunSnapError(f"column {name}: row count mismatch")
                need = 3 * nr * 8
                if p + need > len(payload):
                    raise RunSnapError(f"column {name}: truncated run arrays")

                def _take(off):
                    return np.frombuffer(payload, np.int64, count=nr, offset=off).copy()

                starts = _take(p)
                vals = _take(p + nr * 8)
                strides = _take(p + 2 * nr * 8)
                p += need
                img.cols[name] = _RunCol(rflags, np.dtype(ds), starts, vals, strides, rows)
            elif kind == _K_DENSE:
                arr, p = _get_array(payload, p)
                if arr is None or len(arr) != rows:
                    raise RunSnapError(f"column {name}: dense row count mismatch")
                img.cols[name] = arr
            else:
                raise RunSnapError(f"column {name}: unknown kind {kind}")
    elif tag == SEC_VALUES:
        code, p = _get_array(payload, p)
        off, p = _get_array(payload, p)
        ln, p = _get_array(payload, p)
        raw, p = _get_bytes(payload, p)
        img.values = (code, off, ln, raw)
    elif tag == SEC_OBJTAB:
        img.obj_table, p = _get_array(payload, p)
    # unknown tags: CRC already validated, skip for forward compatibility


# -- verification ------------------------------------------------------------


def verify_container(data: bytes) -> dict:
    """A CRC walk over the sections (and a chunk-checksum walk inside
    SEC_CHANGES), then a structural decode. Returns a plain dict: ``ok``,
    ``total_bytes``, ``valid_bytes``, ``first_bad_offset``, ``units`` (the
    sections that passed) and ``reason``."""
    total = len(data)
    if not is_runsnap(data):
        return {
            "ok": False, "total_bytes": total, "valid_bytes": 0,
            "first_bad_offset": 0, "units": 0, "reason": "not an ARSN container",
        }
    units = 0
    valid = 6
    try:
        for tag, payload, start in _walk_sections(data):
            if tag == SEC_CHANGES:
                _verify_changes(payload)
            units += 1
            valid = start + 1 + len(uleb_bytes(len(payload))) + len(payload) + 4
    except RunSnapError as e:
        return {
            "ok": False, "total_bytes": total, "valid_bytes": valid,
            "first_bad_offset": valid, "units": units, "reason": str(e),
        }
    # a structural decode catches in-payload corruption CRCs can't (CRC
    # guards bit-rot; this guards writer bugs / truncated inner arrays)
    try:
        parse(data)
    except RunSnapError as e:
        return {
            "ok": False, "total_bytes": total, "valid_bytes": valid,
            "first_bad_offset": 6, "units": units, "reason": str(e),
        }
    return {
        "ok": True, "total_bytes": total, "valid_bytes": total,
        "first_bad_offset": None, "units": units, "reason": None,
    }


def _verify_changes(payload: bytes) -> None:
    pos = 0
    n_changes, pos = decode_uleb(payload, pos)
    for i in range(n_changes):
        _n_ops, pos = decode_uleb(payload, pos)
        raw_len, pos = decode_uleb(payload, pos)
        raw = payload[pos : pos + raw_len]
        if len(raw) != raw_len:
            raise RunSnapError(f"change {i}: truncated record")
        chunk, _ = parse_chunk(raw, 0)
        if not chunk.checksum_valid:
            raise RunSnapError(f"change {i}: chunk checksum mismatch")
        pos += raw_len
