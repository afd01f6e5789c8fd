"""Edit files for the typist ``type_edits.c``, and the same typing
through the Python API, so the two can be held byte for byte.

A record is ``("splice", pos, ndel, text)`` with ``text`` as UTF-8 bytes
(which may be malformed), or ``("put", key, tag, value)`` with ``tag`` an
``am.h`` ``AMvalType`` (``shim.py``'s item tags). ``type_records`` types
them as the typist does: a text object "text" made in a first commit, a
map "map" made at the first put, the records with a commit every
``every`` of them and one at the end; a record that fails is skipped, as
the typist reports it and goes on.
"""

from __future__ import annotations

import struct
from typing import List

from . import shim


def encode(records) -> bytes:
    """The edit file of ``records`` (``type_edits.c``'s format)."""
    out = bytearray()
    for r in records:
        if r[0] == "splice":
            _, pos, ndel, text = r
            out += struct.pack("<BIII", 0, pos, ndel, len(text)) + text
            continue
        _, key, tag, value = r
        k = key.encode()
        out += struct.pack("<BBI", 1, tag, len(k)) + k
        if tag in (shim.STR, shim.BYTES):
            v = value.encode() if tag == shim.STR else value
            out += struct.pack("<I", len(v)) + v
        elif tag == shim.F64:
            out += struct.pack("<d", value)
        elif tag != shim.NULL:
            out += struct.pack("<q", int(value))
    return bytes(out)


def from_trace(edits) -> List[tuple]:
    """``workload.load_trace()``'s edits ([pos, ndel, *chars]) as records."""
    return [("splice", pos, ndel, "".join(chars).encode())
            for pos, ndel, *chars in edits]


def type_records(doc, records, every: int) -> List[int]:
    """``records`` typed into ``doc`` (an ``AutoDoc``) through its
    ``splice_text`` and ``put``; returns the indices of those that raised."""
    from ..errors import AutomergeError
    from ..types import ObjType

    text = doc.put_object("_root", "text", ObjType.TEXT)
    doc.commit()
    m = None
    failed = []
    for i, r in enumerate(records):
        try:
            if r[0] == "splice":
                doc.splice_text(text, r[1], r[2], r[3].decode())
            else:
                if m is None:
                    m = doc.put_object("_root", "map", ObjType.MAP)
                doc.put(m, r[1], shim._scalar(r[2], r[3]))
        except (AutomergeError, UnicodeDecodeError):
            failed.append(i)
        if every > 0 and i % every == every - 1:
            doc.commit()
    doc.commit()
    return failed
