"""The change-chunk encoder the generators use, frozen here.

A copy of the port's pure-Python encoder (``storage/change.py``
``build_change`` and ``encode_change_ops``, ``storage/chunk.py``,
``storage/columns.py``, ``storage/values.py``, ``utils/codecs.py`` and
``utils/leb128.py``), cut to what encoding needs and importing nothing of
the port, so that a change to the program cannot change the traffic. The
bytes are automerge's change chunk format (rust/automerge/src/storage).

An op is a tuple ``(obj, prop, elem, insert, action, value, pred)``:

- ``obj``: ``None`` for the root, else ``(counter, actor index)``;
- ``prop``: the map key, or ``None`` for a sequence op;
- ``elem``: ``None`` for a map op, ``HEAD`` or ``(counter, actor index)``;
- ``value``: ``(tag, payload)``, with the tags null, bool, int, str, counter;
- ``pred``: a list of ``(counter, actor index)``.

Actor indices are chunk-local: 0 is the change's author, 1.. its other
actors in byte order.
"""

from __future__ import annotations

import hashlib

HEAD = (0, -1)
MAGIC_BYTES = bytes([0x85, 0x6F, 0x4A, 0x83])
CHUNK_CHANGE = 1


def encode_uleb(value: int, out: bytearray) -> None:
    if value < 0:
        raise ValueError(f"cannot uleb-encode negative value {value}")
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return


def encode_sleb(value: int, out: bytearray) -> None:
    while True:
        byte = value & 0x7F
        value >>= 7
        sign_bit = byte & 0x40
        if (value == 0 and not sign_bit) or (value == -1 and sign_bit):
            out.append(byte)
            return
        out.append(byte | 0x80)


def _lebsize(value: int) -> int:
    bits = (value if value >= 0 else ~value).bit_length() + 1
    return (bits + 6) // 7


def _encode_uint(value: int, out: bytearray) -> None:
    encode_uleb(value, out)


def _encode_int(value: int, out: bytearray) -> None:
    encode_sleb(value, out)


def _encode_str(value: str, out: bytearray) -> None:
    raw = value.encode("utf-8")
    encode_uleb(len(raw), out)
    out += raw


_EMPTY, _INITIAL_NULLS, _NULLS, _LONE, _RUN, _LITERAL = range(6)


class RleEncoder:
    """Run-length encoder over optional values of one kind (uint, int, str)."""

    def __init__(self, kind: str = "uint"):
        self.out = bytearray()
        self._enc = {"uint": _encode_uint, "int": _encode_int, "str": _encode_str}[kind]
        self._state = _EMPTY
        self._value = None
        self._count = 0
        self._lits: list = []

    def _flush_run(self, value, count: int) -> None:
        encode_sleb(count, self.out)
        self._enc(value, self.out)

    def _flush_nulls(self, count: int) -> None:
        encode_sleb(0, self.out)
        encode_uleb(count, self.out)

    def _flush_literals(self, values) -> None:
        encode_sleb(-len(values), self.out)
        for v in values:
            self._enc(v, self.out)

    def append_null(self) -> None:
        st = self._state
        if st == _EMPTY:
            self._state, self._count = _INITIAL_NULLS, 1
        elif st in (_INITIAL_NULLS, _NULLS):
            self._count += 1
        elif st == _LONE:
            self._flush_literals([self._value])
            self._state, self._count = _NULLS, 1
        elif st == _RUN:
            self._flush_run(self._value, self._count)
            self._state, self._count = _NULLS, 1
        else:
            self._lits.append(self._value)
            self._flush_literals(self._lits)
            self._lits = []
            self._state, self._count = _NULLS, 1

    def append_value(self, value) -> None:
        st = self._state
        if st == _EMPTY:
            self._state, self._value = _LONE, value
        elif st == _LONE:
            if self._value == value:
                self._state, self._count = _RUN, 2
            else:
                self._lits = [self._value]
                self._value = value
                self._state = _LITERAL
        elif st == _RUN:
            if self._value == value:
                self._count += 1
            else:
                self._flush_run(self._value, self._count)
                self._state, self._value = _LONE, value
        elif st == _LITERAL:
            if self._value == value:
                self._flush_literals(self._lits)
                self._lits = []
                self._state, self._count = _RUN, 2
            else:
                self._lits.append(self._value)
                self._value = value
        else:
            self._flush_nulls(self._count)
            self._state, self._value = _LONE, value

    def finish(self) -> bytes:
        st = self._state
        if st == _NULLS:
            self._flush_nulls(self._count)
        elif st == _LONE:
            self._flush_literals([self._value])
        elif st == _RUN:
            self._flush_run(self._value, self._count)
        elif st == _LITERAL:
            self._lits.append(self._value)
            self._flush_literals(self._lits)
        self._state = _EMPTY
        return bytes(self.out)


class DeltaEncoder:
    """RLE over successive differences; absolute values start at 0."""

    def __init__(self):
        self._rle = RleEncoder("int")
        self._abs = 0

    def append(self, value) -> None:
        if value is None:
            self._rle.append_null()
        else:
            self._rle.append_value(value - self._abs)
            self._abs = value

    def finish(self) -> bytes:
        return self._rle.finish()


class BooleanEncoder:
    """Alternating run lengths, starting with the count of ``False``."""

    def __init__(self):
        self.out = bytearray()
        self._last = False
        self._count = 0

    def append(self, value: bool) -> None:
        if value == self._last:
            self._count += 1
        else:
            encode_uleb(self._count, self.out)
            self._last = value
            self._count = 1

    def finish(self) -> bytes:
        if self._count > 0:
            encode_uleb(self._count, self.out)
        return bytes(self.out)


def _value_meta(tag: str, v) -> int:
    if tag == "null":
        return 0
    if tag == "bool":
        return 2 if v else 1
    if tag == "int":
        return (_lebsize(v) << 4) | 4
    if tag == "str":
        return (len(v.encode("utf-8")) << 4) | 6
    if tag == "counter":
        return (_lebsize(v) << 4) | 8
    raise ValueError(f"unsupported scalar tag {tag!r}")


def _encode_raw(tag: str, v, out: bytearray) -> None:
    if tag in ("int", "counter"):
        encode_sleb(v, out)
    elif tag == "str":
        out += v.encode("utf-8")


# normalized column specs (column id << 4 | type)
_COLS = (1, 2, 17, 19, 21, 52, 66, 86, 87, 112, 113, 115, 148, 165)


def encode_ops(ops) -> list:
    """The op columns of ``ops`` as [(spec, bytes)] in spec order."""
    obj_actor, obj_ctr = RleEncoder("uint"), RleEncoder("uint")
    key_actor, key_ctr, key_str = RleEncoder("uint"), DeltaEncoder(), RleEncoder("str")
    insert, action = BooleanEncoder(), RleEncoder("uint")
    val_meta, val_raw = RleEncoder("uint"), bytearray()
    pred_num, pred_actor, pred_ctr = RleEncoder("uint"), RleEncoder("uint"), DeltaEncoder()
    mark_name = RleEncoder("str")
    for obj, prop, elem, ins, act, (tag, v), pred in ops:
        if obj is None:
            obj_actor.append_null()
            obj_ctr.append_null()
        else:
            obj_actor.append_value(obj[1])
            obj_ctr.append_value(obj[0])
        if prop is not None:
            key_actor.append_null()
            key_ctr.append(None)
            key_str.append_value(prop)
        elif elem[0] == 0:
            key_actor.append_null()
            key_ctr.append(0)
            key_str.append_null()
        else:
            key_actor.append_value(elem[1])
            key_ctr.append(elem[0])
            key_str.append_null()
        insert.append(ins)
        action.append_value(act)
        val_meta.append_value(_value_meta(tag, v))
        _encode_raw(tag, v, val_raw)
        pred_num.append_value(len(pred))
        for c, a in pred:
            pred_actor.append_value(a)
            pred_ctr.append(c)
        mark_name.append_null()
    data = (obj_actor.finish(), obj_ctr.finish(), key_actor.finish(), key_ctr.finish(),
            key_str.finish(), insert.finish(), action.finish(), val_meta.finish(),
            bytes(val_raw), pred_num.finish(), pred_actor.finish(), pred_ctr.finish(),
            b"", mark_name.finish())
    return list(zip(_COLS, data))


def _chunk_hash(data: bytes) -> bytes:
    body = bytearray([CHUNK_CHANGE])
    encode_uleb(len(data), body)
    body += data
    return hashlib.sha256(bytes(body)).digest()


def build_change(deps, actor: bytes, other_actors, seq: int, start_op: int, ops):
    """(chunk bytes, change hash) of one change with timestamp 0 and no
    message."""
    data = bytearray()
    deps = sorted(deps)
    encode_uleb(len(deps), data)
    for d in deps:
        data += d
    encode_uleb(len(actor), data)
    data += actor
    encode_uleb(seq, data)
    encode_uleb(start_op, data)
    encode_sleb(0, data)
    encode_uleb(0, data)
    encode_uleb(len(other_actors), data)
    for a in other_actors:
        encode_uleb(len(a), data)
        data += a
    present = [(s, d) for s, d in encode_ops(ops) if d]
    encode_uleb(len(present), data)
    for s, d in present:
        encode_uleb(s, data)
        encode_uleb(len(d), data)
    for _, d in present:
        data += d
    data = bytes(data)
    h = _chunk_hash(data)
    out = bytearray(MAGIC_BYTES)
    out += h[:4]
    out.append(CHUNK_CHANGE)
    encode_uleb(len(data), out)
    out += data
    return bytes(out), h
