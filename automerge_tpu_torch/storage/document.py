"""Document chunk encode/decode.

Byte-compatible with the reference (reference:
rust/automerge/src/storage/document.rs, document/doc_op_columns.rs,
document/doc_change_columns.rs). Chunk body layout:

    ULEB num_actors, each ULEB length-prefixed actor id (sorted lexicographic)
    ULEB num_heads, 32-byte head hashes (sorted)
    change column metadata
    ops column metadata
    change column data
    ops column data
    per-head ULEB index of the head change in the change list

Actor indices are document-global indices into the sorted actor table — which
makes (counter, actor_index) order identical to Lamport order, the property
the device merge kernel relies on. Ops are sorted by object id, then key,
then Lamport; delete ops are not stored as rows, they exist only as entries
in their predecessors' ``succ`` lists.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..types import Key, OpId, ScalarValue
from ..utils.codecs import (  # noqa: F401
    _bool_runs_col,
    _str_runs_col,
    BooleanEncoder,
    DeltaEncoder,
    MaybeBooleanEncoder,
    RleEncoder,
    boolean_decode,
    delta_decode,
    rle_decode,
)
from ..utils.leb128 import decode_uleb, encode_uleb
from . import columns as C
from .chunk import (
    CHUNK_DOCUMENT,
    DEFLATE_MIN_SIZE,
    DroppedRegion,
    RawChunk,
    parse_chunk,
    scan_chunks,
    write_chunk,
)
from .change import HEAD_STORED, ROOT_STORED
from .values import ValueEncoder, decode_values

# Normalized doc-op column specs
OP_OBJ_ACTOR = C.spec(0, C.TYPE_ACTOR)  # 1
OP_OBJ_CTR = C.spec(0, C.TYPE_INTEGER)  # 2
OP_KEY_ACTOR = C.spec(1, C.TYPE_ACTOR)  # 17
OP_KEY_CTR = C.spec(1, C.TYPE_DELTA)  # 19
OP_KEY_STR = C.spec(1, C.TYPE_STRING)  # 21
OP_ID_ACTOR = C.spec(2, C.TYPE_ACTOR)  # 33
OP_ID_CTR = C.spec(2, C.TYPE_DELTA)  # 35
OP_INSERT = C.spec(3, C.TYPE_BOOLEAN)  # 52
OP_ACTION = C.spec(4, C.TYPE_INTEGER)  # 66
OP_VAL_META = C.spec(5, C.TYPE_VALUE_META)  # 86
OP_VAL_RAW = C.spec(5, C.TYPE_VALUE)  # 87
OP_SUCC_GROUP = C.spec(8, C.TYPE_GROUP)  # 128
OP_SUCC_ACTOR = C.spec(8, C.TYPE_ACTOR)  # 129
OP_SUCC_CTR = C.spec(8, C.TYPE_DELTA)  # 131
OP_EXPAND = C.spec(9, C.TYPE_BOOLEAN)  # 148
OP_MARK_NAME = C.spec(10, C.TYPE_STRING)  # 165

# Normalized doc-change column specs
CH_ACTOR = C.spec(0, C.TYPE_ACTOR)  # 1
CH_SEQ = C.spec(0, C.TYPE_DELTA)  # 3
CH_MAX_OP = C.spec(1, C.TYPE_DELTA)  # 19
CH_TIME = C.spec(2, C.TYPE_DELTA)  # 35
CH_MESSAGE = C.spec(3, C.TYPE_STRING)  # 53
CH_DEPS_GROUP = C.spec(4, C.TYPE_GROUP)  # 64
CH_DEPS_IDX = C.spec(4, C.TYPE_DELTA)  # 67
CH_EXTRA_META = C.spec(5, C.TYPE_VALUE_META)  # 86
CH_EXTRA_RAW = C.spec(5, C.TYPE_VALUE)  # 87


@dataclass
class DocOp:
    """One op row in the document format (actor indices are doc-global)."""

    id: OpId
    obj: OpId  # ROOT_STORED for the root object
    key: Key
    insert: bool
    action: int
    value: ScalarValue
    succ: List[OpId] = field(default_factory=list)
    expand: bool = False
    mark_name: Optional[str] = None


@dataclass
class DocChangeMeta:
    """Change metadata row in the document format."""

    actor: int  # index into the document actor table
    seq: int
    max_op: int
    timestamp: int
    message: Optional[str]
    deps: List[int]  # indices into the change list
    extra: bytes = b""


class ParsedDocument:
    """A parsed document chunk. ``ops`` decodes lazily from the retained
    column bytes — the fast load path (doc_op_arrays) reads
    ``op_col_data`` directly and never materializes DocOp objects."""

    __slots__ = (
        "actors", "heads", "changes", "head_indices", "checksum_valid",
        "op_col_data", "op_arrays", "_ops",
    )

    def __init__(
        self, actors, heads, changes, head_indices, checksum_valid,
        op_col_data=None, ops=None,
    ):
        self.actors = actors
        self.heads = heads
        self.changes = changes
        self.head_indices = head_indices
        self.checksum_valid = checksum_valid
        self.op_col_data = op_col_data
        self.op_arrays = None  # retained native column arrays (fast load)
        self._ops = ops

    @property
    def ops(self) -> List[DocOp]:
        if self._ops is None:
            ops = decode_doc_ops(self.op_col_data or {})
            for i, op in enumerate(ops):
                _check_doc_actor_bounds(op, i, len(self.actors))
            self._ops = ops
        return self._ops


def encode_doc_ops(ops: List[DocOp]) -> List[Tuple[int, bytes]]:
    obj_actor = RleEncoder("uint")
    obj_ctr = RleEncoder("uint")
    key_actor = RleEncoder("uint")
    key_ctr = DeltaEncoder()
    key_str = RleEncoder("str")
    id_actor = RleEncoder("uint")
    id_ctr = DeltaEncoder()
    insert = BooleanEncoder()
    action = RleEncoder("uint")
    val = ValueEncoder()
    succ_num = RleEncoder("uint")
    succ_actor = RleEncoder("uint")
    succ_ctr = DeltaEncoder()
    expand = MaybeBooleanEncoder()
    mark_name = RleEncoder("str")

    for op in ops:
        # Counter 0 identifies root/HEAD regardless of sentinel actor value
        # (accepts both types.ROOT/HEAD (0,0) and storage (0,-1)).
        if op.obj[0] == 0:
            obj_actor.append_null()
            obj_ctr.append_null()
        else:
            obj_actor.append_value(op.obj[1])
            obj_ctr.append_value(op.obj[0])
        if op.key.prop is not None:
            key_actor.append_null()
            key_ctr.append(None)
            key_str.append_value(op.key.prop)
        elif op.key.elem[0] == 0:
            key_actor.append_null()
            key_ctr.append(0)
            key_str.append_null()
        else:
            key_actor.append_value(op.key.elem[1])
            key_ctr.append(op.key.elem[0])
            key_str.append_null()
        id_actor.append_value(op.id[1])
        id_ctr.append(op.id[0])
        insert.append(op.insert)
        action.append_value(op.action)
        val.append(op.value)
        succ_num.append_value(len(op.succ))
        for s in op.succ:
            succ_actor.append_value(s[1])
            succ_ctr.append(s[0])
        expand.append(op.expand)
        if op.mark_name is None:
            mark_name.append_null()
        else:
            mark_name.append_value(op.mark_name)

    val_meta, val_raw = val.finish()
    return [
        (OP_OBJ_ACTOR, obj_actor.finish()),
        (OP_OBJ_CTR, obj_ctr.finish()),
        (OP_KEY_ACTOR, key_actor.finish()),
        (OP_KEY_CTR, key_ctr.finish()),
        (OP_KEY_STR, key_str.finish()),
        (OP_ID_ACTOR, id_actor.finish()),
        (OP_ID_CTR, id_ctr.finish()),
        (OP_INSERT, insert.finish()),
        (OP_ACTION, action.finish()),
        (OP_VAL_META, val_meta),
        (OP_VAL_RAW, val_raw),
        (OP_SUCC_GROUP, succ_num.finish()),
        (OP_SUCC_ACTOR, succ_actor.finish()),
        (OP_SUCC_CTR, succ_ctr.finish()),
        (OP_EXPAND, expand.finish()),
        (OP_MARK_NAME, mark_name.finish()),
    ]


def encode_doc_ops_arrays(a) -> List[Tuple[int, bytes]]:
    """Array-native doc-op column encode: byte-identical to
    ``encode_doc_ops`` over the materialized DocOp list, built from numpy
    columns (the fast save path, core/document._doc_op_cols_fast).

    ``a`` fields, all length n in document order with save-time actor
    indices: obj_ctr/obj_actor/obj_mask, key_str_ids (+key_str_table),
    key_ctr/key_ctr_mask/key_actor/key_actor_mask, id_ctr/id_actor,
    insert (u8), action, val_meta, val_raw (bytes), succ_num,
    succ_ctr/succ_actor (flat), expand (u8), mark_ids (+mark_table).
    """
    import numpy as np

    from .. import native

    n = len(a["action"])
    ones = np.ones(n, np.uint8)
    ones_s = np.ones(len(a["succ_ctr"]), np.uint8)
    return [
        (OP_OBJ_ACTOR, native.rle_encode_array(a["obj_actor"], a["obj_mask"], False)),
        (OP_OBJ_CTR, native.rle_encode_array(a["obj_ctr"], a["obj_mask"], False)),
        (OP_KEY_ACTOR, native.rle_encode_array(a["key_actor"], a["key_actor_mask"], False)),
        (OP_KEY_CTR, native.delta_encode_array(a["key_ctr"], a["key_ctr_mask"])),
        (OP_KEY_STR, _str_runs_col(a["key_str_ids"], a["key_str_table"], RleEncoder("str"))),
        (OP_ID_ACTOR, native.rle_encode_array(a["id_actor"], ones, False)),
        (OP_ID_CTR, native.delta_encode_array(a["id_ctr"], ones)),
        (OP_INSERT, native.bool_encode_array(a["insert"])),
        (OP_ACTION, native.rle_encode_array(a["action"], ones, False)),
        (OP_VAL_META, native.rle_encode_array(a["val_meta"], ones, False)),
        (OP_VAL_RAW, a["val_raw"]),
        (OP_SUCC_GROUP, native.rle_encode_array(a["succ_num"], ones, False)),
        (OP_SUCC_ACTOR, native.rle_encode_array(a["succ_actor"], ones_s, False)),
        (OP_SUCC_CTR, native.delta_encode_array(a["succ_ctr"], ones_s)),
        (OP_EXPAND, _bool_runs_col(a["expand"], MaybeBooleanEncoder())),
        (OP_MARK_NAME, _str_runs_col(a["mark_ids"], a["mark_table"], RleEncoder("str"))),
    ]


def decode_doc_ops(col_data: dict[int, bytes]) -> List[DocOp]:
    def col(s):
        return col_data.get(s, b"")

    actions = rle_decode(col(OP_ACTION), "uint")
    id_ctr = delta_decode(col(OP_ID_CTR))
    key_str = rle_decode(col(OP_KEY_STR), "str")
    key_ctr = delta_decode(col(OP_KEY_CTR))
    n = max(len(actions), len(id_ctr), len(key_str), len(key_ctr))
    actions = _pad(actions, n)
    insert = boolean_decode(col(OP_INSERT), n)
    obj_actor = _pad(rle_decode(col(OP_OBJ_ACTOR), "uint"), n)
    obj_ctr = _pad(rle_decode(col(OP_OBJ_CTR), "uint"), n)
    key_actor = _pad(rle_decode(col(OP_KEY_ACTOR), "uint"), n)
    key_ctr = _pad(key_ctr, n)
    key_str = _pad(key_str, n)
    id_actor = _pad(rle_decode(col(OP_ID_ACTOR), "uint"), n)
    id_ctr = _pad(id_ctr, n)
    values = decode_values(col(OP_VAL_META), col(OP_VAL_RAW), n)
    succ_num = _pad(rle_decode(col(OP_SUCC_GROUP), "uint"), n)
    total_succ = sum(s or 0 for s in succ_num)
    succ_actor = rle_decode(col(OP_SUCC_ACTOR), "uint", total_succ)
    succ_ctr = delta_decode(col(OP_SUCC_CTR), total_succ)
    expand = boolean_decode(col(OP_EXPAND), n)
    mark_name = _pad(rle_decode(col(OP_MARK_NAME), "str"), n)

    ops: List[DocOp] = []
    si = 0
    for i in range(n):
        if actions[i] is None:
            raise ValueError(f"doc op {i}: missing action")
        if id_ctr[i] is None or id_actor[i] is None:
            raise ValueError(f"doc op {i}: missing op id")
        if obj_ctr[i] is None and obj_actor[i] is None:
            obj = ROOT_STORED
        elif obj_ctr[i] is None or obj_actor[i] is None:
            raise ValueError(f"doc op {i}: half-null object id")
        else:
            obj = (obj_ctr[i], obj_actor[i])
        if key_str[i] is not None:
            key = Key.map(key_str[i])
        elif key_ctr[i] == 0 and key_actor[i] is None:
            key = Key.seq(HEAD_STORED)
        elif key_ctr[i] is not None and key_actor[i] is not None:
            key = Key.seq((key_ctr[i], key_actor[i]))
        else:
            raise ValueError(f"doc op {i}: neither map key nor elem id present")
        ns = succ_num[i] or 0
        succ = []
        for _ in range(ns):
            if si >= len(succ_ctr) or succ_ctr[si] is None or succ_actor[si] is None:
                raise ValueError(f"doc op {i}: truncated succ column")
            succ.append((succ_ctr[si], succ_actor[si]))
            si += 1
        ops.append(
            DocOp(
                id=(id_ctr[i], id_actor[i]),
                obj=obj,
                key=key,
                insert=insert[i],
                action=actions[i],
                value=values[i],
                succ=succ,
                expand=expand[i],
                mark_name=mark_name[i],
            )
        )
    return ops


def encode_doc_changes(changes: List[DocChangeMeta]) -> List[Tuple[int, bytes]]:
    actor = RleEncoder("uint")
    seq = DeltaEncoder()
    max_op = DeltaEncoder()
    time = DeltaEncoder()
    message = RleEncoder("str")
    deps_num = RleEncoder("uint")
    deps_idx = DeltaEncoder()
    extra = ValueEncoder()
    for ch in changes:
        actor.append_value(ch.actor)
        seq.append(ch.seq)
        max_op.append(ch.max_op)
        time.append(ch.timestamp)
        message.append(ch.message)
        deps_num.append_value(len(ch.deps))
        for d in ch.deps:
            deps_idx.append(d)
        extra.append(ScalarValue("bytes", ch.extra))
    extra_meta, extra_raw = extra.finish()
    return [
        (CH_ACTOR, actor.finish()),
        (CH_SEQ, seq.finish()),
        (CH_MAX_OP, max_op.finish()),
        (CH_TIME, time.finish()),
        (CH_MESSAGE, message.finish()),
        (CH_DEPS_GROUP, deps_num.finish()),
        (CH_DEPS_IDX, deps_idx.finish()),
        (CH_EXTRA_META, extra_meta),
        (CH_EXTRA_RAW, extra_raw),
    ]


def decode_doc_changes(col_data: dict[int, bytes]) -> List[DocChangeMeta]:
    def col(s):
        return col_data.get(s, b"")

    actors = rle_decode(col(CH_ACTOR), "uint")
    n = len(actors)
    seq = _pad(delta_decode(col(CH_SEQ)), n)
    max_op = _pad(delta_decode(col(CH_MAX_OP)), n)
    time = _pad(delta_decode(col(CH_TIME)), n)
    message = _pad(rle_decode(col(CH_MESSAGE), "str"), n)
    deps_num = _pad(rle_decode(col(CH_DEPS_GROUP), "uint"), n)
    total_deps = sum(d or 0 for d in deps_num)
    deps_idx = delta_decode(col(CH_DEPS_IDX), total_deps)
    extras = (
        decode_values(col(CH_EXTRA_META), col(CH_EXTRA_RAW), n)
        if col(CH_EXTRA_META)
        else [ScalarValue("bytes", b"")] * n
    )

    out: List[DocChangeMeta] = []
    di = 0
    for i in range(n):
        if actors[i] is None:
            raise ValueError(f"doc change {i}: null actor")
        nd = deps_num[i] or 0
        deps = []
        for _ in range(nd):
            if di >= len(deps_idx) or deps_idx[di] is None:
                raise ValueError(f"doc change {i}: truncated deps")
            if deps_idx[di] < 0:
                raise ValueError(f"doc change {i}: negative dep index")
            deps.append(deps_idx[di])
            di += 1
        extra = extras[i].value if extras[i].tag == "bytes" else b""
        out.append(
            DocChangeMeta(
                actor=actors[i],
                seq=seq[i] if seq[i] is not None else 0,
                max_op=max_op[i] if max_op[i] is not None else 0,
                timestamp=time[i] if time[i] is not None else 0,
                message=message[i],
                deps=deps,
                extra=extra,
            )
        )
    return out


def _pad(lst: list, n: int) -> list:
    if len(lst) < n:
        lst.extend([None] * (n - len(lst)))
    return lst


def build_document(
    actors: List[bytes],
    heads_with_indices: List[Tuple[bytes, int]],
    ops: List[DocOp],
    changes: List[DocChangeMeta],
    deflate: bool = True,
    op_cols: Optional[List[Tuple[int, bytes]]] = None,
) -> bytes:
    """Encode a document chunk. ``actors`` must already be sorted."""
    if sorted(actors) != list(actors):
        raise ValueError("document actor table must be sorted")
    data = bytearray()
    encode_uleb(len(actors), data)
    for a in actors:
        encode_uleb(len(a), data)
        data += a
    encode_uleb(len(heads_with_indices), data)
    for h, _ in heads_with_indices:
        if len(h) != 32:
            raise ValueError("head hash must be 32 bytes")
        data += h

    change_cols = encode_doc_changes(changes)
    if op_cols is None:
        op_cols = encode_doc_ops(ops)
    threshold = DEFLATE_MIN_SIZE if deflate else None
    # Metadata for both column groups precedes both data blocks, so encode
    # them to scratch buffers first.
    change_block = bytearray()
    C.write_columns(change_cols, change_block, threshold)
    op_block = bytearray()
    C.write_columns(op_cols, op_block, threshold)
    data += change_block_meta_and_data(change_block, op_block)
    for _, idx in heads_with_indices:
        encode_uleb(idx, data)
    return write_chunk(CHUNK_DOCUMENT, bytes(data))


def change_block_meta_and_data(change_block: bytearray, op_block: bytearray) -> bytes:
    """Interleave [change meta][op meta][change data][op data].

    ``write_columns`` produces meta+data contiguously, so split each block.
    """
    cm, cd = _split_meta(change_block)
    om, od = _split_meta(op_block)
    return bytes(cm + om + cd + od)


def _split_meta(block: bytearray) -> tuple[bytes, bytes]:
    metas, pos = C.parse_columns(block, 0)
    return bytes(block[:pos]), bytes(block[pos:])


def parse_document(buf: bytes, pos: int = 0) -> tuple[ParsedDocument, int]:
    chunk, end = parse_chunk(buf, pos)
    if chunk.chunk_type != CHUNK_DOCUMENT:
        raise ValueError(f"expected document chunk, got type {chunk.chunk_type}")
    if not chunk.checksum_valid:
        raise ValueError("document chunk checksum mismatch")
    return (_parse_document_body(chunk), end)


def _parse_document_body(chunk: "RawChunk") -> ParsedDocument:
    data = chunk.data
    p = 0
    nactors, p = decode_uleb(data, p)
    actors = []
    for _ in range(nactors):
        alen, p = decode_uleb(data, p)
        if p + alen > len(data):
            raise ValueError("truncated actor table")
        actors.append(bytes(data[p : p + alen]))
        p += alen
    nheads, p = decode_uleb(data, p)
    heads = []
    for _ in range(nheads):
        if p + 32 > len(data):
            raise ValueError("truncated heads")
        heads.append(bytes(data[p : p + 32]))
        p += 32
    change_metas, p = C.parse_columns(data, p)
    op_metas, p = C.parse_columns(data, p)
    change_data = C.slice_column_data(data, change_metas, p)
    p += C.total_column_len(change_metas)
    op_data = C.slice_column_data(data, op_metas, p)
    p += C.total_column_len(op_metas)
    head_indices = []
    if p < len(data):
        for _ in range(nheads):
            idx, p = decode_uleb(data, p)
            head_indices.append(idx)

    changes = decode_doc_changes(change_data)
    for i, ch in enumerate(changes):
        if ch.actor >= nactors:
            raise ValueError(f"doc change {i} references missing actor {ch.actor}")
    parsed = ParsedDocument(
        actors=actors,
        heads=heads,
        changes=changes,
        head_indices=head_indices,
        checksum_valid=chunk.checksum_valid,
        op_col_data=dict(op_data),
    )
    # op-column validation: the native array decode (its arrays are kept
    # for the fast reconstruction). An irregular shape (ExtractError) goes
    # to the per-op python decoder, the authority on such columns; either
    # way malformed op columns are rejected HERE. A native library that
    # cannot be built raises NativeUnavailable.
    from ..ops.extract import ExtractError, doc_op_arrays, validate_doc_arrays

    try:
        arrs = doc_op_arrays(parsed.op_col_data)
        validate_doc_arrays(arrs, nactors)
        parsed.op_arrays = arrs
    except ExtractError:
        parsed.ops  # noqa: B018 — decode + per-op bounds checks, may raise
    return parsed


# ---------------------------------------------------------------------------
# salvage loading: recover the valid chunks from a damaged save


@dataclass
class DroppedChunk:
    """One unrecoverable byte span in a damaged save."""

    offset: int
    end: int
    reason: str
    checksum: bytes  # stored 4-byte checksum (the original hash prefix), or b""
    computed_hash: bytes  # hash of the bytes as found (b"" if unparseable)


@dataclass
class SalvageReport:
    """What a salvage load kept and what it had to drop."""

    scanned_bytes: int = 0
    applied_chunks: int = 0
    dropped: List[DroppedChunk] = field(default_factory=list)

    @property
    def dropped_checksums(self) -> List[bytes]:
        """The stored checksums of dropped chunks — each is the first 4
        bytes of the original (pre-corruption) chunk hash, so callers can
        name exactly which changes were lost."""
        return [d.checksum for d in self.dropped if d.checksum]

    def summary(self) -> str:
        return (
            f"salvaged {self.applied_chunks} chunk(s), "
            f"dropped {len(self.dropped)} span(s) over {self.scanned_bytes} bytes"
        )


def salvage_scan(buf: bytes) -> tuple[List[RawChunk], SalvageReport]:
    """Split a (possibly damaged) save into verifiable chunks + a report.

    Checksum-invalid and unparseable spans become ``DroppedChunk`` records;
    the scan resynchronises on the next ``MAGIC_BYTES`` occurrence (see
    ``scan_chunks``). ``applied_chunks`` is left 0 — the loader fills it in
    after it knows how many chunks actually applied.
    """
    report = SalvageReport(scanned_bytes=len(buf))
    chunks: List[RawChunk] = []
    for item in scan_chunks(buf):
        if isinstance(item, DroppedRegion):
            report.dropped.append(
                DroppedChunk(
                    offset=item.offset,
                    end=item.end,
                    reason=item.reason,
                    checksum=item.checksum,
                    computed_hash=item.hash,
                )
            )
        else:
            chunks.append(item)
    return chunks, report


def parse_document_chunk(chunk: RawChunk) -> ParsedDocument:
    """Parse an already-framed-and-verified document chunk (the body of
    ``parse_document``, reusable from the salvage path)."""
    return _parse_document_body(chunk)


def _check_doc_actor_bounds(op: DocOp, i: int, n_actors: int) -> None:
    refs = [op.id[1]]
    if op.obj != ROOT_STORED:
        refs.append(op.obj[1])
    if op.key.elem is not None and op.key.elem != HEAD_STORED:
        refs.append(op.key.elem[1])
    refs.extend(s[1] for s in op.succ)
    for a in refs:
        if a < 0 or a >= n_actors:
            raise ValueError(f"doc op {i} references missing actor index {a}")
