"""Column specifications and raw column metadata blocks.

Byte-compatible with the reference (reference:
rust/automerge/src/storage/columns/column_specification.rs, raw_column.rs).

A column spec packs into a u32: ``(column_id << 4) | (deflate << 3) | type``
with types Group=0, Actor=1, Integer=2, DeltaInteger=3, Boolean=4, String=5,
ValueMetadata=6, Value=7. Column metadata is ULEB(count) then per column
ULEB(spec), ULEB(byte length); data follows concatenated in the same order.
Empty columns are omitted. Columns must appear in ascending normalized
(deflate-bit-cleared) spec order.
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

from ..utils.leb128 import decode_uleb, encode_uleb

TYPE_GROUP = 0
TYPE_ACTOR = 1
TYPE_INTEGER = 2
TYPE_DELTA = 3
TYPE_BOOLEAN = 4
TYPE_STRING = 5
TYPE_VALUE_META = 6
TYPE_VALUE = 7

DEFLATE_BIT = 0b1000


def spec(column_id: int, col_type: int, deflate: bool = False) -> int:
    return (column_id << 4) | (DEFLATE_BIT if deflate else 0) | col_type


def spec_id(s: int) -> int:
    return s >> 4


def spec_type(s: int) -> int:
    return s & 0b0111


def spec_deflate(s: int) -> bool:
    return bool(s & DEFLATE_BIT)


def normalize(s: int) -> int:
    return s & ~DEFLATE_BIT


from ..errors import AutomergeError


class ColumnLayoutError(AutomergeError):
    pass


def write_columns(
    cols: List[Tuple[int, bytes]],
    out: bytearray,
    deflate_threshold: int | None = None,
) -> None:
    """Write column metadata + data for ``cols`` (list of (spec, bytes)).

    Empty columns are filtered. If ``deflate_threshold`` is set, columns whose
    data meets the threshold are DEFLATE-compressed and flagged (reference:
    raw_column.rs compress / document/compression.rs).
    """
    present = [(s, d) for s, d in cols if d]
    encoded = []
    for s, d in present:
        if deflate_threshold is not None and len(d) >= deflate_threshold:
            co = zlib.compressobj(level=6, wbits=-15)
            encoded.append((s | DEFLATE_BIT, co.compress(d) + co.flush()))
        else:
            encoded.append((s, d))
    encode_uleb(len(encoded), out)
    for s, d in encoded:
        encode_uleb(s, out)
        encode_uleb(len(d), out)
    for _, d in encoded:
        out += d


def parse_columns(buf: bytes, pos: int) -> tuple[List[Tuple[int, int]], int]:
    """Parse column metadata at ``pos``; returns ([(spec, length)], new_pos)."""
    count, pos = decode_uleb(buf, pos)
    metas: List[Tuple[int, int]] = []
    last_norm = -1
    for _ in range(count):
        s, pos = decode_uleb(buf, pos)
        length, pos = decode_uleb(buf, pos)
        ns = normalize(s)
        if ns < last_norm:
            raise ColumnLayoutError("columns not in normalized order")
        last_norm = ns
        metas.append((s, length))
    return metas, pos


def slice_column_data(
    buf: bytes, metas: List[Tuple[int, int]], data_start: int
) -> dict[int, bytes]:
    """Slice (and inflate if flagged) each column's bytes out of ``buf``.

    Returns a dict keyed by normalized spec.
    """
    out: dict[int, bytes] = {}
    offset = data_start
    for s, length in metas:
        data = bytes(buf[offset : offset + length])
        if len(data) != length:
            raise ColumnLayoutError("column data out of range")
        offset += length
        if spec_deflate(s):
            try:
                data = zlib.decompress(data, wbits=-15)
            except zlib.error as e:
                raise ColumnLayoutError(f"bad deflate column: {e}") from e
        out[normalize(s)] = data
    return out


def total_column_len(metas: List[Tuple[int, int]]) -> int:
    return sum(length for _, length in metas)
