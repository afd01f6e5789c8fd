"""Change chunk encode/decode.

Byte-compatible with the reference (reference:
rust/automerge/src/storage/change.rs, change/change_op_columns.rs,
change/change_actors.rs). Chunk body layout:

    ULEB num_deps, then 32-byte change hashes (sorted)
    ULEB actor byte length + actor bytes
    ULEB seq
    ULEB start_op
    SLEB timestamp
    ULEB message byte length + message utf8
    ULEB num_other_actors, each ULEB length-prefixed
    column metadata (see columns.py)
    op column data
    extra bytes

Actor indices inside op columns are chunk-local: index 0 is the change author,
indices 1.. are the other actors in lexicographic byte order. Op columns (by
spec): obj actor/counter (1, 2), key actor/counter/string (17, 19, 21),
insert (52), action (66), value meta/raw (86, 87), pred group/actor/counter
(112, 113, 115), expand (148), mark name (165).

Parsing keeps the op column bytes and decodes no op: one native pass
(``native.change_check``) counts the ops and raises where the per-op
decoder (``decode_change_ops``) and the actor bounds check would, and
``ops`` is a ``LazyOps`` that decodes on first access. The log extractor
(ops/extract.py, ops/assemble.py) reads the column bytes directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .. import native
from ..types import Key, OpId, ScalarValue, is_head, is_root
from ..utils.codecs import (
    BooleanEncoder,
    DeltaEncoder,
    MaybeBooleanEncoder,
    RleEncoder,
    boolean_decode,
    delta_decode,
    rle_decode,
)
from ..utils.leb128 import decode_sleb, decode_uleb, encode_sleb, encode_uleb
from . import columns as C
from .chunk import CHUNK_CHANGE, chunk_hash, parse_chunk, write_chunk
from .values import ValueEncoder, decode_values

# Normalized column specs for change op columns
COL_OBJ_ACTOR = C.spec(0, C.TYPE_ACTOR)  # 1
COL_OBJ_CTR = C.spec(0, C.TYPE_INTEGER)  # 2
COL_KEY_ACTOR = C.spec(1, C.TYPE_ACTOR)  # 17
COL_KEY_CTR = C.spec(1, C.TYPE_DELTA)  # 19
COL_KEY_STR = C.spec(1, C.TYPE_STRING)  # 21
COL_INSERT = C.spec(3, C.TYPE_BOOLEAN)  # 52
COL_ACTION = C.spec(4, C.TYPE_INTEGER)  # 66
COL_VAL_META = C.spec(5, C.TYPE_VALUE_META)  # 86
COL_VAL_RAW = C.spec(5, C.TYPE_VALUE)  # 87
COL_PRED_GROUP = C.spec(7, C.TYPE_GROUP)  # 112
COL_PRED_ACTOR = C.spec(7, C.TYPE_ACTOR)  # 113
COL_PRED_CTR = C.spec(7, C.TYPE_DELTA)  # 115
COL_EXPAND = C.spec(9, C.TYPE_BOOLEAN)  # 148
COL_MARK_NAME = C.spec(10, C.TYPE_STRING)  # 165


@dataclass
class ChangeOp:
    """One op as stored in a change chunk.

    ``obj``/``key.elem``/``pred`` op ids carry chunk-local actor indices.
    obj == ROOT is represented as (0, -1) here to distinguish "root" from
    "op of actor 0"; elem HEAD is (0, -1) likewise.
    """

    obj: OpId
    key: Key
    insert: bool
    action: int
    value: ScalarValue
    pred: List[OpId] = field(default_factory=list)
    expand: bool = False
    mark_name: Optional[str] = None


ROOT_STORED: OpId = (0, -1)
HEAD_STORED: OpId = (0, -1)


@dataclass
class StoredChange:
    """A parsed or built change chunk."""

    dependencies: List[bytes]
    actor: bytes  # author actor id bytes
    other_actors: List[bytes]
    seq: int
    start_op: int
    timestamp: int
    message: Optional[str]
    ops: List[ChangeOp]
    extra_bytes: bytes = b""
    # Set when built/parsed:
    hash: Optional[bytes] = None
    raw_bytes: Optional[bytes] = None  # whole chunk incl. header
    # Raw op-column bytes (spec -> bytes) as built or parsed.
    op_col_data: Optional[dict] = None
    # Decoded chunk-local column arrays (ops/assemble.ChangeCols), kept on
    # the change after its first extraction so that later logs built from
    # it do not decode it again.
    cached_cols: Optional[object] = field(default=None, repr=False, compare=False)

    @property
    def actors(self) -> List[bytes]:
        """Chunk-local actor table: author first, then others sorted."""
        return [self.actor, *self.other_actors]

    @property
    def max_op(self) -> int:
        return self.start_op + len(self.ops) - 1 if self.ops else self.start_op - 1


def encode_change_ops(ops: Sequence[ChangeOp]) -> List[Tuple[int, bytes]]:
    """Encode op columns; returns [(normalized spec, bytes)] in order."""
    obj_actor = RleEncoder("uint")
    obj_ctr = RleEncoder("uint")
    key_actor = RleEncoder("uint")
    key_ctr = DeltaEncoder()
    key_str = RleEncoder("str")
    insert = BooleanEncoder()
    action = RleEncoder("uint")
    val = ValueEncoder()
    pred_num = RleEncoder("uint")
    pred_actor = RleEncoder("uint")
    pred_ctr = DeltaEncoder()
    expand = MaybeBooleanEncoder()
    mark_name = RleEncoder("str")

    for op in ops:
        # Root and HEAD are identified by counter 0 alone — both the public
        # (0, 0) sentinels (types.ROOT/HEAD) and the storage-layer (0, -1)
        # forms encode identically (no real op has counter 0).
        if is_root(op.obj):
            obj_actor.append_null()
            obj_ctr.append_null()
        else:
            obj_actor.append_value(op.obj[1])
            obj_ctr.append_value(op.obj[0])
        if op.key.prop is not None:
            key_actor.append_null()
            key_ctr.append(None)
            key_str.append_value(op.key.prop)
        elif is_head(op.key.elem):
            key_actor.append_null()
            key_ctr.append(0)
            key_str.append_null()
        else:
            key_actor.append_value(op.key.elem[1])
            key_ctr.append(op.key.elem[0])
            key_str.append_null()
        insert.append(op.insert)
        action.append_value(op.action)
        val.append(op.value)
        pred_num.append_value(len(op.pred))
        for p in op.pred:
            pred_actor.append_value(p[1])
            pred_ctr.append(p[0])
        expand.append(op.expand)
        if op.mark_name is None:
            mark_name.append_null()
        else:
            mark_name.append_value(op.mark_name)

    val_meta, val_raw = val.finish()
    return [
        (COL_OBJ_ACTOR, obj_actor.finish()),
        (COL_OBJ_CTR, obj_ctr.finish()),
        (COL_KEY_ACTOR, key_actor.finish()),
        (COL_KEY_CTR, key_ctr.finish()),
        (COL_KEY_STR, key_str.finish()),
        (COL_INSERT, insert.finish()),
        (COL_ACTION, action.finish()),
        (COL_VAL_META, val_meta),
        (COL_VAL_RAW, val_raw),
        (COL_PRED_GROUP, pred_num.finish()),
        (COL_PRED_ACTOR, pred_actor.finish()),
        (COL_PRED_CTR, pred_ctr.finish()),
        (COL_EXPAND, expand.finish()),
        (COL_MARK_NAME, mark_name.finish()),
    ]


def encode_ops_with_tail(prefix_ops: Sequence[ChangeOp], tail) -> List[Tuple[int, bytes]]:
    """Encode op columns for ``prefix_ops`` (chunk-local ChangeOps) followed
    by a numpy tail of ops (the native edit session's export) — identical bytes to
    ``encode_change_ops`` over the materialized op list, at array speed.

    ``tail`` fields (chunk-local actor indices, one row per op):
      obj_ctr/obj_actor   ints (the session's single object id)
      elem_ctr (i64), elem_actor (i64, -1 = HEAD/null)
      insert (u8), action (i64)
      val_meta (i64: (byte_len << 4) | type_code), val_raw (bytes)
      pred_ctr/pred_actor (i64, -1 = no pred)
    """
    import numpy as np

    from .values import encode_raw_value, value_meta

    np_ = len(prefix_ops)
    nt = len(tail["action"])
    n = np_ + nt

    obj_ctr = np.empty(n, np.int64)
    obj_mask = np.empty(n, np.uint8)
    obj_actor = np.empty(n, np.int64)
    key_ctr = np.empty(n, np.int64)
    key_ctr_mask = np.empty(n, np.uint8)
    key_actor = np.empty(n, np.int64)
    key_actor_mask = np.empty(n, np.uint8)
    insert = np.empty(n, np.uint8)
    action = np.empty(n, np.int64)
    vmeta = np.empty(n, np.int64)
    pred_num = np.empty(n, np.int64)

    key_str = RleEncoder("str")
    mark_name = RleEncoder("str")
    expand = MaybeBooleanEncoder()
    raw = bytearray()
    pred_ctr_list: List[int] = []
    pred_actor_list: List[int] = []

    for i, op in enumerate(prefix_ops):
        if is_root(op.obj):
            obj_mask[i] = 0
            obj_ctr[i] = 0
            obj_actor[i] = 0
        else:
            obj_mask[i] = 1
            obj_ctr[i] = op.obj[0]
            obj_actor[i] = op.obj[1]
        if op.key.prop is not None:
            key_str.append_value(op.key.prop)
            key_ctr_mask[i] = 0
            key_ctr[i] = 0
            key_actor_mask[i] = 0
            key_actor[i] = 0
        elif is_head(op.key.elem):
            key_str.append_null()
            key_ctr_mask[i] = 1
            key_ctr[i] = 0
            key_actor_mask[i] = 0
            key_actor[i] = 0
        else:
            key_str.append_null()
            key_ctr_mask[i] = 1
            key_ctr[i] = op.key.elem[0]
            key_actor_mask[i] = 1
            key_actor[i] = op.key.elem[1]
        insert[i] = 1 if op.insert else 0
        action[i] = op.action
        vmeta[i] = value_meta(op.value)
        encode_raw_value(op.value, raw)
        pred_num[i] = len(op.pred)
        for p in op.pred:
            pred_ctr_list.append(p[0])
            pred_actor_list.append(p[1])
        expand.append(op.expand)
        if op.mark_name is None:
            mark_name.append_null()
        else:
            mark_name.append_value(op.mark_name)

    # tail (vectorized)
    s = slice(np_, n)
    obj_mask[s] = 1
    obj_ctr[s] = int(tail["obj_ctr"])
    obj_actor[s] = int(tail["obj_actor"])
    t_elem_actor = tail["elem_actor"]
    key_ctr[s] = tail["elem_ctr"]
    key_ctr_mask[s] = 1
    key_actor[s] = np.where(t_elem_actor >= 0, t_elem_actor, 0)
    key_actor_mask[s] = (t_elem_actor >= 0).astype(np.uint8)
    insert[s] = tail["insert"]
    action[s] = tail["action"]
    vmeta[s] = tail["val_meta"]
    raw += tail["val_raw"]
    t_pred_ctr = tail["pred_ctr"]
    has_pred = t_pred_ctr >= 0
    pred_num[s] = has_pred.astype(np.int64)
    key_str.append_null_run(nt)
    mark_name.append_null_run(nt)
    expand.append_run(False, nt)

    pred_ctr_all = np.concatenate(
        [np.asarray(pred_ctr_list, np.int64), t_pred_ctr[has_pred]]
    )
    pred_actor_all = np.concatenate(
        [np.asarray(pred_actor_list, np.int64), tail["pred_actor"][has_pred]]
    )
    ones_p = np.ones(len(pred_ctr_all), np.uint8)
    ones = np.ones(n, np.uint8)

    return [
        (COL_OBJ_ACTOR, native.rle_encode_array(obj_actor, obj_mask, False)),
        (COL_OBJ_CTR, native.rle_encode_array(obj_ctr, obj_mask, False)),
        (COL_KEY_ACTOR, native.rle_encode_array(key_actor, key_actor_mask, False)),
        (COL_KEY_CTR, native.delta_encode_array(key_ctr, key_ctr_mask)),
        (COL_KEY_STR, key_str.finish()),
        (COL_INSERT, native.bool_encode_array(insert)),
        (COL_ACTION, native.rle_encode_array(action, ones, False)),
        (COL_VAL_META, native.rle_encode_array(vmeta, ones, False)),
        (COL_VAL_RAW, bytes(raw)),
        (COL_PRED_GROUP, native.rle_encode_array(pred_num, ones, False)),
        (COL_PRED_ACTOR, native.rle_encode_array(pred_actor_all, ones_p, False)),
        (COL_PRED_CTR, native.delta_encode_array(pred_ctr_all, ones_p)),
        (COL_EXPAND, expand.finish()),
        (COL_MARK_NAME, mark_name.finish()),
    ]


def encode_map_tail_cols(tail) -> List[Tuple[int, bytes]]:
    """Encode op columns for a pure map-put change from a numpy tail (the
    native map session's export; no prefix rows) — identical bytes to ``encode_change_ops``
    over the materialized op list, at array speed.

    ``tail`` fields (chunk-local actor indices, one row per op):
      obj_ctr/obj_actor   ints (the session's object; obj_actor -1 = root)
      key_idx (i64 into keys), keys (string table)
      val_meta (i64: (byte_len << 4) | type_code), val_raw (bytes)
      pred_ctr/pred_actor (i64, -1 = no pred)
    """
    import numpy as np

    from ..types import Action

    n = len(tail["key_idx"])
    ones = np.ones(n, np.uint8)
    zero_mask = np.zeros(n, np.uint8)
    zeros = np.zeros(n, np.int64)

    root = int(tail["obj_actor"]) < 0
    obj_mask = zero_mask if root else ones
    obj_ctr = zeros if root else np.full(n, int(tail["obj_ctr"]), np.int64)
    obj_actor = zeros if root else np.full(n, int(tail["obj_actor"]), np.int64)

    action = np.full(n, int(Action.PUT), np.int64)
    t_pred_ctr = np.asarray(tail["pred_ctr"], np.int64)
    has_pred = t_pred_ctr >= 0
    pred_ctr = t_pred_ctr[has_pred]
    pred_actor = np.asarray(tail["pred_actor"], np.int64)[has_pred]
    ones_p = np.ones(len(pred_ctr), np.uint8)

    expand = MaybeBooleanEncoder()
    expand.append_run(False, n)
    mark_name = RleEncoder("str")
    mark_name.append_null_run(n)

    return [
        (COL_OBJ_ACTOR, native.rle_encode_array(obj_actor, obj_mask, False)),
        (COL_OBJ_CTR, native.rle_encode_array(obj_ctr, obj_mask, False)),
        (COL_KEY_ACTOR, native.rle_encode_array(zeros, zero_mask, False)),
        (COL_KEY_CTR, native.delta_encode_array(zeros, zero_mask)),
        (COL_KEY_STR, native.rle_encode_strtab(
            np.asarray(tail["key_idx"], np.int64), tail["keys"])),
        (COL_INSERT, native.bool_encode_array(zero_mask)),
        (COL_ACTION, native.rle_encode_array(action, ones, False)),
        (COL_VAL_META, native.rle_encode_array(
            np.asarray(tail["val_meta"], np.int64), ones, False)),
        (COL_VAL_RAW, bytes(tail["val_raw"])),
        (COL_PRED_GROUP, native.rle_encode_array(
            has_pred.astype(np.int64), ones, False)),
        (COL_PRED_ACTOR, native.rle_encode_array(pred_actor, ones_p, False)),
        (COL_PRED_CTR, native.delta_encode_array(pred_ctr, ones_p)),
        (COL_EXPAND, expand.finish()),
        (COL_MARK_NAME, mark_name.finish()),
    ]


def encode_change_cols_arrays(a) -> List[Tuple[int, bytes]]:
    """Full-array change-op column encode — byte-identical to
    ``encode_change_ops`` over the materialized ChangeOp list (the fast
    document-load path re-encoding reconstructed changes for hashing).

    ``a`` fields, all length n in op-id order with chunk-local actor
    indices: obj_ctr/obj_actor/obj_mask, key_str_ids (+key_str_table),
    key_ctr/key_ctr_mask/key_actor/key_actor_mask, insert (u8), action,
    val_meta, val_raw (bytes), pred_num, pred_ctr/pred_actor (flat),
    expand (u8), mark_ids (+mark_table).
    """
    import numpy as np

    from ..utils.codecs import _bool_runs_col

    str_col = native.rle_encode_strtab

    n = len(a["action"])
    ones = np.ones(n, np.uint8)
    ones_p = np.ones(len(a["pred_ctr"]), np.uint8)
    return [
        (COL_OBJ_ACTOR, native.rle_encode_array(a["obj_actor"], a["obj_mask"], False)),
        (COL_OBJ_CTR, native.rle_encode_array(a["obj_ctr"], a["obj_mask"], False)),
        (COL_KEY_ACTOR, native.rle_encode_array(a["key_actor"], a["key_actor_mask"], False)),
        (COL_KEY_CTR, native.delta_encode_array(a["key_ctr"], a["key_ctr_mask"])),
        (COL_KEY_STR, str_col(a["key_str_ids"], a["key_str_table"])),
        (COL_INSERT, native.bool_encode_array(a["insert"])),
        (COL_ACTION, native.rle_encode_array(a["action"], ones, False)),
        (COL_VAL_META, native.rle_encode_array(a["val_meta"], ones, False)),
        (COL_VAL_RAW, a["val_raw"]),
        (COL_PRED_GROUP, native.rle_encode_array(a["pred_num"], ones, False)),
        (COL_PRED_ACTOR, native.rle_encode_array(a["pred_actor"], ones_p, False)),
        (COL_PRED_CTR, native.delta_encode_array(a["pred_ctr"], ones_p)),
        (COL_EXPAND, _bool_runs_col(a["expand"], MaybeBooleanEncoder())),
        (COL_MARK_NAME, str_col(a["mark_ids"], a["mark_table"])),
    ]


def decode_change_ops(col_data: dict[int, bytes]) -> List[ChangeOp]:
    """Decode op columns from a dict of normalized spec -> bytes."""

    def col(s):
        return col_data.get(s, b"")

    # Row count is the longest primary column; every column must then cover
    # (or legitimately null-fill) all n rows — truncation is a parse error.
    actions = rle_decode(col(COL_ACTION), "uint")
    key_str = rle_decode(col(COL_KEY_STR), "str")
    key_ctr = delta_decode(col(COL_KEY_CTR))
    n = max(len(actions), len(key_str), len(key_ctr))
    insert = boolean_decode(col(COL_INSERT), n)
    actions = _pad(actions, n)
    obj_actor = _pad(rle_decode(col(COL_OBJ_ACTOR), "uint"), n)
    obj_ctr = _pad(rle_decode(col(COL_OBJ_CTR), "uint"), n)
    key_actor = _pad(rle_decode(col(COL_KEY_ACTOR), "uint"), n)
    key_ctr = _pad(key_ctr, n)
    key_str = _pad(key_str, n)
    values = decode_values(col(COL_VAL_META), col(COL_VAL_RAW), n)
    pred_num = _pad(rle_decode(col(COL_PRED_GROUP), "uint"), n)
    total_preds = sum(p or 0 for p in pred_num)
    pred_actor = rle_decode(col(COL_PRED_ACTOR), "uint", total_preds)
    pred_ctr = delta_decode(col(COL_PRED_CTR), total_preds)
    expand = boolean_decode(col(COL_EXPAND), n)
    mark_name = _pad(rle_decode(col(COL_MARK_NAME), "str"), n)

    ops: List[ChangeOp] = []
    pi = 0
    for i in range(n):
        if actions[i] is None:
            raise ValueError(f"op {i}: missing action")
        obj = _decode_objid(obj_ctr[i], obj_actor[i], i)
        if key_str[i] is not None:
            key = Key.map(key_str[i])
        elif key_ctr[i] == 0 and key_actor[i] is None:
            key = Key.seq(HEAD_STORED)
        elif key_ctr[i] is not None and key_actor[i] is not None:
            key = Key.seq((key_ctr[i], key_actor[i]))
        else:
            raise ValueError(f"op {i}: neither map key nor elem id present")
        np = pred_num[i] or 0
        pred = []
        for _ in range(np):
            if pi >= len(pred_ctr) or pred_ctr[pi] is None or pred_actor[pi] is None:
                raise ValueError(f"op {i}: truncated pred column")
            pred.append((pred_ctr[pi], pred_actor[pi]))
            pi += 1
        ops.append(
            ChangeOp(
                obj=obj,
                key=key,
                insert=insert[i],
                action=actions[i],
                value=values[i],
                pred=pred,
                expand=expand[i],
                mark_name=mark_name[i],
            )
        )
    return ops


def _decode_objid(ctr, actor, i: int) -> OpId:
    """Decode an obj id column pair: both null = root, both set = op id."""
    if ctr is None and actor is None:
        return ROOT_STORED
    if ctr is None or actor is None:
        raise ValueError(f"op {i}: half-null object id")
    return (ctr, actor)


def _pad(lst: list, n: int) -> list:
    if len(lst) < n:
        lst.extend([None] * (n - len(lst)))
    return lst


class LazyOps:
    """List-like view over a change's ops, decoded from the retained column
    bytes on first element access. ``len`` is always O(1); the log
    extraction reads ``op_col_data`` directly and never materializes
    ChangeOp objects."""

    __slots__ = ("_col_data", "_n", "_ops")

    def __init__(self, col_data: dict, n: int):
        self._col_data = col_data
        self._n = n
        self._ops = None

    def _mat(self) -> List[ChangeOp]:
        if self._ops is None:
            self._ops = decode_change_ops(self._col_data)
        return self._ops

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]


def build_change(change: StoredChange, cols=None) -> StoredChange:
    """Encode ``change`` into chunk bytes, filling ``hash``/``raw_bytes``.

    ``cols`` supplies precomputed op columns (the array-native encoders
    above); when given, ``change.ops`` may be a LazyOps placeholder."""
    data = bytearray()
    deps = sorted(change.dependencies)
    change.dependencies = deps
    encode_uleb(len(deps), data)
    for d in deps:
        if len(d) != 32:
            raise ValueError("change hash must be 32 bytes")
        data += d
    encode_uleb(len(change.actor), data)
    data += change.actor
    encode_uleb(change.seq, data)
    if change.start_op < 1:
        raise ValueError("start_op must be >= 1")
    encode_uleb(change.start_op, data)
    encode_sleb(change.timestamp, data)
    msg = (change.message or "").encode("utf-8")
    encode_uleb(len(msg), data)
    data += msg
    encode_uleb(len(change.other_actors), data)
    for a in change.other_actors:
        encode_uleb(len(a), data)
        data += a
    if cols is None:
        cols = encode_change_ops(change.ops)
    C.write_columns(cols, data)
    data += change.extra_bytes
    raw = write_chunk(CHUNK_CHANGE, bytes(data))
    change.hash = chunk_hash(CHUNK_CHANGE, bytes(data))
    change.raw_bytes = raw
    change.op_col_data = dict(cols)
    return change


def parse_change_data(data: bytes, chunk_hash_: bytes, raw: bytes) -> StoredChange:
    """Parse the body of a change chunk (after the chunk header)."""
    pos = 0
    ndeps, pos = decode_uleb(data, pos)
    deps = []
    for _ in range(ndeps):
        if pos + 32 > len(data):
            raise ValueError("truncated change deps")
        deps.append(bytes(data[pos : pos + 32]))
        pos += 32
    alen, pos = decode_uleb(data, pos)
    actor = bytes(data[pos : pos + alen])
    if len(actor) != alen:
        raise ValueError("truncated actor id")
    pos += alen
    seq, pos = decode_uleb(data, pos)
    start_op, pos = decode_uleb(data, pos)
    if start_op < 1:
        raise ValueError("start_op must be >= 1")
    if start_op > 0xFFFFFFFF:
        raise ValueError("op counter too large")  # reference rejects > u32
    timestamp, pos = decode_sleb(data, pos)
    mlen, pos = decode_uleb(data, pos)
    message = data[pos : pos + mlen].decode("utf-8")
    pos += mlen
    nother, pos = decode_uleb(data, pos)
    others = []
    for _ in range(nother):
        olen, pos = decode_uleb(data, pos)
        others.append(bytes(data[pos : pos + olen]))
        pos += olen
    metas, pos = C.parse_columns(data, pos)
    for s, _ in metas:
        if C.spec_deflate(s):
            raise ValueError("change chunks must not contain compressed columns")
    col_data = C.slice_column_data(data, metas, pos)
    pos += C.total_column_len(metas)
    extra = bytes(data[pos:])
    n_ops = native.change_check(col_data, 1 + len(others))
    return StoredChange(
        dependencies=deps,
        actor=actor,
        other_actors=others,
        seq=seq,
        start_op=start_op,
        timestamp=timestamp,
        message=message or None,
        ops=LazyOps(col_data, n_ops),
        extra_bytes=extra,
        hash=chunk_hash_,
        raw_bytes=raw,
        op_col_data=col_data,
    )


def parse_change(buf: bytes, pos: int = 0) -> tuple[StoredChange, int]:
    chunk, end = parse_chunk(buf, pos)
    if chunk.chunk_type != CHUNK_CHANGE:
        raise ValueError(f"expected change chunk, got type {chunk.chunk_type}")
    if not chunk.checksum_valid:
        raise ValueError("change chunk checksum mismatch")
    if buf[pos + 8] == 2:  # was stored compressed: rebuild uncompressed chunk
        raw = write_chunk(CHUNK_CHANGE, chunk.data)
    else:
        raw = bytes(buf[pos:end])
    change = parse_change_data(chunk.data, chunk.hash, raw)
    return change, end


def _check_actor_bounds(op: ChangeOp, i: int, n_actors: int) -> None:
    """The per-op form of the actor bounds check ``native.change_check``
    makes over a change's columns: raises ValueError for an op that names
    an actor index outside the chunk's table."""
    refs = []
    if op.obj != ROOT_STORED:
        refs.append(op.obj[1])
    if op.key.elem is not None and op.key.elem != HEAD_STORED:
        refs.append(op.key.elem[1])
    refs.extend(p[1] for p in op.pred)
    for a in refs:
        if a < 0 or a >= n_actors:
            raise ValueError(f"op {i} references missing actor index {a}")


def chunk_local_ops(rows, author, actor_bytes_of, extra_refs=()):
    """Translate ops with *global* actor indices into chunk-local ChangeOps.

    Builds the chunk-local actor table — author first, remaining referenced
    actors sorted by their bytes (reference: change/change_actors.rs) — and
    rewrites obj / elem / pred references through it. ``rows`` are ChangeOp-
    shaped records whose OpIds carry global indices; ``actor_bytes_of`` maps
    a global index to actor bytes; ``extra_refs`` adds global indices
    referenced outside ``rows`` (the native-session tail) to the table.
    Returns (chunk_ops, other_global_indices, local_of_global).

    This is the single encoder shared by transaction commit and document
    save/reconstruct so both always produce byte-identical change chunks for
    the same logical change.
    """
    other: List[int] = []
    seen = {author}
    for r in rows:
        refs = []
        if r.obj != ROOT_STORED:
            refs.append(r.obj[1])
        if r.key.elem is not None and r.key.elem[0] != 0:
            refs.append(r.key.elem[1])
        refs.extend(p[1] for p in r.pred)
        for a in refs:
            if a not in seen:
                seen.add(a)
                other.append(a)
    for a in extra_refs:
        a = int(a)
        if a not in seen:
            seen.add(a)
            other.append(a)
    other.sort(key=actor_bytes_of)
    local = {author: 0}
    for j, g in enumerate(other):
        local[g] = j + 1

    def tr(opid: OpId) -> OpId:
        return (opid[0], local[opid[1]])

    ops = []
    for r in rows:
        if r.key.prop is not None:
            key = r.key
        elif r.key.elem[0] == 0:
            key = Key.seq(HEAD_STORED)
        else:
            key = Key.seq(tr(r.key.elem))
        ops.append(
            ChangeOp(
                obj=ROOT_STORED if r.obj == ROOT_STORED else tr(r.obj),
                key=key,
                insert=r.insert,
                action=r.action,
                value=r.value,
                pred=[tr(p) for p in r.pred],
                expand=r.expand,
                mark_name=r.mark_name,
            )
        )
    return ops, other, local
