"""Columnar codec primitives: RLE, delta-RLE, boolean run-length, raw values.

Byte-compatible with the reference's columnar encoding layer (reference:
rust/automerge/src/columnar/encoding/{rle.rs,delta.rs,boolean.rs}). The exact
run/literal/null-run state machine is mirrored because change hashes are
computed over these bytes — any drift breaks interop and head verification.

Wire format (per RLE column):
  - sleb n > 0: a run; followed by one value repeated n times
  - sleb n < 0: a literal run of |n| values
  - sleb 0:     a null run; followed by uleb count
A column that is entirely null encodes to zero bytes.

Value encodings within columns:
  - uint  -> ULEB128
  - int   -> SLEB128
  - str   -> ULEB128 byte length + UTF-8 bytes
"""

from __future__ import annotations

from .leb128 import decode_sleb, decode_uleb, encode_sleb, encode_uleb

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _sat_i64(v: int) -> int:
    """Saturate to i64 range (the reference uses saturating arithmetic)."""
    if v > _I64_MAX:
        return _I64_MAX
    if v < _I64_MIN:
        return _I64_MIN
    return v


def _encode_uint(value: int, out: bytearray) -> None:
    encode_uleb(value, out)


def _encode_int(value: int, out: bytearray) -> None:
    encode_sleb(value, out)


def _encode_str(value: str, out: bytearray) -> None:
    raw = value.encode("utf-8")
    encode_uleb(len(raw), out)
    out += raw


def _decode_uint(buf, pos):
    return decode_uleb(buf, pos)


def _decode_int(buf, pos):
    return decode_sleb(buf, pos)


def _decode_str(buf, pos):
    n, pos = decode_uleb(buf, pos)
    if pos + n > len(buf):
        raise ValueError("string column: truncated")
    return buf[pos : pos + n].decode("utf-8"), pos + n


# State tags for the RLE encoder
_EMPTY = 0
_INITIAL_NULLS = 1
_NULLS = 2
_LONE = 3
_RUN = 4
_LITERAL = 5


class RleEncoder:
    """Run-length encoder over optional values.

    ``kind`` is one of "uint", "int", "str" and selects the value codec.
    """

    def __init__(self, kind: str = "uint"):
        self.out = bytearray()
        if kind == "uint":
            self._enc = _encode_uint
        elif kind == "int":
            self._enc = _encode_int
        elif kind == "str":
            self._enc = _encode_str
        else:
            raise ValueError(f"unknown rle kind {kind!r}")
        self._state = _EMPTY
        self._value = None  # current run / lone value / last literal value
        self._count = 0  # run or null-run length
        self._lits: list = []  # accumulated literal run (excluding _value)

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

    def append(self, value) -> None:
        if value is None:
            self.append_null()
        else:
            self.append_value(value)

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
        elif st == _LITERAL:
            self._lits.append(self._value)
            self._flush_literals(self._lits)
            self._lits = []
            self._state, self._count = _NULLS, 1

    def append_null_run(self, n: int) -> None:
        """Append ``n`` nulls in O(1) (bulk columns with long null tails)."""
        if n <= 0:
            return
        self.append_null()
        if self._state in (_INITIAL_NULLS, _NULLS):
            self._count += n - 1

    def append_value_run(self, value, n: int) -> None:
        """Append ``n`` equal values in O(1) (bulk run-encoded columns)."""
        if n <= 0:
            return
        self.append_value(value)
        if n == 1:
            return
        self.append_value(value)  # any state + same value twice -> _RUN
        self._count += n - 2

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
        else:  # null runs
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
        # _EMPTY and _INITIAL_NULLS emit nothing: an all-null column is empty.
        self._state = _EMPTY
        return bytes(self.out)


# Bound on values decoded from a column when the caller doesn't know the row
# count up front: a crafted 10-byte header must not demand a terabyte list.
MAX_COLUMN_VALUES = 1 << 24


def rle_decode(
    buf, kind: str = "uint", count: int | None = None, max_total: int = MAX_COLUMN_VALUES
) -> list:
    """Decode an RLE column into a list of optional values.

    If ``count`` is given, stop after that many values; runs are clamped to
    the remaining demand so attacker-controlled run lengths never materialize
    beyond it. Without ``count``, decoding is bounded by ``max_total``.
    """
    if kind == "uint":
        dec = _decode_uint
    elif kind == "int":
        dec = _decode_int
    elif kind == "str":
        dec = _decode_str
    else:
        raise ValueError(f"unknown rle kind {kind!r}")
    limit = count if count is not None else max_total
    out: list = []
    pos = 0
    n = len(buf)
    while pos < n and len(out) < limit:
        header, pos = decode_sleb(buf, pos)
        take = limit - len(out)
        if header > 0:
            value, pos = dec(buf, pos)
            out.extend([value] * min(header, take))
        elif header < 0:
            for _ in range(-header):
                value, pos = dec(buf, pos)
                if len(out) < limit:
                    out.append(value)
        else:
            nulls, pos = decode_uleb(buf, pos)
            out.extend([None] * min(nulls, take))
    if count is None and len(out) >= max_total and pos < n:
        raise ValueError("rle column demands too many values")
    return out


class DeltaEncoder:
    """RLE over successive differences; absolute values start at 0.

    Reference: rust/automerge/src/columnar/encoding/delta.rs.
    """

    def __init__(self):
        self._rle = RleEncoder("int")
        self._abs = 0

    def append(self, value) -> None:
        if value is None:
            self._rle.append_null()
        else:
            self._rle.append_value(_sat_i64(value - self._abs))
            self._abs = value

    def finish(self) -> bytes:
        return self._rle.finish()


def delta_decode(buf, count: int | None = None, max_total: int = MAX_COLUMN_VALUES) -> list:
    deltas = rle_decode(buf, "int", count, max_total)
    out: list = []
    absolute = 0
    for d in deltas:
        if d is None:
            out.append(None)
        else:
            absolute = _sat_i64(absolute + d)
            out.append(absolute)
    return out


class BooleanEncoder:
    """Alternating run lengths, starting with the count of ``False`` values.

    Reference: rust/automerge/src/columnar/encoding/boolean.rs.
    """

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

    def append_run(self, value: bool, n: int) -> None:
        """Append ``n`` equal values in O(1)."""
        if n <= 0:
            return
        self.append(value)
        self._count += n - 1

    def finish(self) -> bytes:
        if self._count > 0:
            encode_uleb(self._count, self.out)
        return bytes(self.out)


def boolean_decode(
    buf, count: int | None = None, max_total: int = MAX_COLUMN_VALUES
) -> list[bool]:
    limit = count if count is not None else max_total
    out: list[bool] = []
    pos = 0
    value = True
    while pos < len(buf) and len(out) < limit:
        run, pos = decode_uleb(buf, pos)
        value = not value
        out.extend([value] * min(run, limit - len(out)))
    if count is None and len(out) >= max_total and pos < len(buf):
        raise ValueError("boolean column demands too many values")
    if count is not None and len(out) < count:
        # Decoder yields False once input is exhausted.
        out.extend([False] * (count - len(out)))
    return out


class MaybeBooleanEncoder:
    """BooleanEncoder that emits zero bytes when every value is False.

    Reference: boolean.rs MaybeBooleanEncoder (used for expand columns).
    """

    def __init__(self):
        self._inner = BooleanEncoder()
        self._all_false = True

    def append(self, value: bool) -> None:
        if value:
            self._all_false = False
        self._inner.append(value)

    def append_run(self, value: bool, n: int) -> None:
        if value and n > 0:
            self._all_false = False
        self._inner.append_run(value, n)

    def finish(self) -> bytes:
        if self._all_false:
            return b""
        return self._inner.finish()


def _run_bounds(arr):
    """[(start, end)] of equal-value runs in ``arr``."""
    import numpy as np

    n = len(arr)
    if not n:
        return []
    b = np.flatnonzero(np.diff(arr)) + 1
    starts = np.concatenate([[0], b])
    ends = np.concatenate([b, [n]])
    return zip(starts.tolist(), ends.tolist())


def _str_runs_col(ids, table, enc) -> bytes:
    """Drive a string RleEncoder from an int-id column (-1 = null) using
    vectorized run boundaries + O(1) bulk appends."""
    for s, e in _run_bounds(ids):
        v = int(ids[s])
        if v < 0:
            enc.append_null_run(e - s)
        else:
            enc.append_value_run(table[v], e - s)
    return enc.finish()


def _bool_runs_col(vals, enc) -> bytes:
    for s, e in _run_bounds(vals):
        enc.append_run(bool(vals[s]), e - s)
    return enc.finish()
