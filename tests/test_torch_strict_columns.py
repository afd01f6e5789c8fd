"""A column that runs past its chunk's rows: the port refuses what the JAX
package refuses and accepts what it accepts.

A document chunk's key-string column (spec 21) past the action column's
row count is refused by the reference's native decoder; its per-op decoder
then raises ``ValueError: value metadata column shorter than row count``.
The port's decoder takes a strict argument for that column alone. The
mark-name column (spec 165) is read by both packages up to the row count
and its tail ignored: that document loads in both, and so does a change
chunk whose mark-name column runs past its rows.

Each case saves one small document (a text object, a map key, a mark,
fixed actor) undeflated, appends a run to one op column, rebuilds the
chunk with its checksum and drives ``AutoDoc.load``, ``load_incremental``
and the salvage load of both packages on the same bytes.
"""

import pytest

import automerge_tpu.api as RA
import automerge_tpu.types as RT
import automerge_tpu_torch.api as PA
import automerge_tpu_torch.types as PT
from automerge_tpu.storage import change as RC
from automerge_tpu.storage import columns as C
from automerge_tpu.storage import document as D
from automerge_tpu.storage.chunk import CHUNK_DOCUMENT, parse_chunk, write_chunk
from automerge_tpu.utils.leb128 import decode_uleb, encode_sleb, encode_uleb

ACTOR = b"\x07" * 16
OTHER = b"\x08" * 16


def run_bytes(kind):
    """One RLE run of the string column codec, appended past the rows."""
    out = bytearray()
    if kind == "null":
        encode_sleb(0, out)
        encode_uleb(50, out)
    elif kind == "value":
        encode_sleb(3, out)
        encode_uleb(1, out)
        out += b"k"
    else:  # a literal run of one string
        encode_sleb(-1, out)
        encode_uleb(1, out)
        out += b"k"
    return bytes(out)


def source_doc():
    d = RA.AutoDoc(RT.ActorId(ACTOR))
    t = d.put_object("_root", "text", RT.ObjType.TEXT)
    d.splice_text(t, 0, 0, "hello world")
    d.put("_root", "title", "x")
    d.mark(t, 0, 5, "bold", True)
    d.commit()
    return d


def overlong_document(spec, extra):
    """The saved document with ``extra`` appended to op column ``spec``."""
    buf = source_doc().save(deflate=False)
    ch, _ = parse_chunk(buf, 0)
    data = ch.data
    p = 0
    n, p = decode_uleb(data, p)
    for _ in range(n):
        ln, p = decode_uleb(data, p)
        p += ln
    nh, p = decode_uleb(data, p)
    p += 32 * nh
    head = bytes(data[:p])
    cm, p = C.parse_columns(data, p)
    om, p = C.parse_columns(data, p)
    cd = C.slice_column_data(data, cm, p)
    p += C.total_column_len(cm)
    od = C.slice_column_data(data, om, p)
    p += C.total_column_len(om)
    tail = bytes(data[p:])
    assert spec in od
    cblock, oblock = bytearray(), bytearray()
    C.write_columns([(s, cd[s]) for s, _ in cm], cblock, None)
    C.write_columns([(s, od[s] + (extra if s == spec else b""))
                     for s, _ in om], oblock, None)
    return write_chunk(
        CHUNK_DOCUMENT, head + D.change_block_meta_and_data(cblock, oblock) + tail)


def overlong_change(spec, extra):
    """The document's change chunk with ``extra`` appended to ``spec``."""
    ch, _ = RC.parse_change(source_doc().get_last_local_change().raw_bytes)
    cols = [(s, ch.op_col_data[s] + (extra if s == spec else b""))
            for s in sorted(ch.op_col_data)]
    assert spec in ch.op_col_data
    return RC.build_change(ch, cols=cols).raw_bytes


def outcome(fn):
    """What a load gave: ("ok", value) or ("error", class name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # both packages' errors compared by name and text
        return ("error", type(e).__name__, str(e))


def report(r):
    return (r.scanned_bytes, r.applied_chunks,
            [(x.offset, x.end, x.reason, bytes(x.checksum or b""),
              bytes(x.computed_hash or b"")) for x in r.dropped])


def loads(data):
    """Every load of ``data`` through one package's ``AutoDoc``, both."""
    out = {}
    for name, mod, types, kw in (("ref", RA, RT, {}),
                                 ("port", PA, PT, {"device": "cpu"})):
        out[name] = {
            "load": outcome(lambda: mod.AutoDoc.load(data, **kw).hydrate()),
            "load_incremental": outcome(lambda: mod.AutoDoc(
                types.ActorId(OTHER), **kw).load_incremental(data)),
            "salvage": outcome(lambda: report(mod.AutoDoc.load(
                data, on_error="salvage", **kw).salvage_report)),
        }
    return out


@pytest.mark.parametrize("kind", ["null", "value", "literal"])
def test_overlong_key_string_column_is_refused_by_both(kind):
    got = loads(overlong_document(D.OP_KEY_STR, run_bytes(kind)))
    assert got["port"] == got["ref"]
    assert got["ref"]["load"][0] == "error"
    assert got["ref"]["load_incremental"] == ("ok", 0)
    scanned, applied, dropped = got["ref"]["salvage"][1]
    assert applied == 0 and len(dropped) == 1
    if kind == "null":
        # the reference's own words, from its per-op decoder
        assert got["ref"]["load"][1:] == (
            "ValueError", "value metadata column shorter than row count")
        assert dropped[0][2] == (
            "chunk body rejected: value metadata column shorter than row count")


@pytest.mark.parametrize("kind", ["null", "value"])
def test_overlong_mark_name_column_loads_in_both(kind):
    got = loads(overlong_document(D.OP_MARK_NAME, run_bytes(kind)))
    assert got["port"] == got["ref"]
    assert got["ref"]["load"] == (
        "ok", {"text": "hello world", "title": "x"})
    assert got["ref"]["load_incremental"] == ("ok", 1)
    assert got["ref"]["salvage"][1][1:] == (1, [])


@pytest.mark.parametrize("kind", ["null", "value"])
def test_overlong_change_chunk_column_loads_in_both(kind):
    data = overlong_change(RC.COL_MARK_NAME, run_bytes(kind))
    got = loads(data)
    assert got["port"] == got["ref"]
    assert got["ref"]["load_incremental"] == ("ok", 1)
    assert got["ref"]["load"] == (
        "ok", {"text": "hello world", "title": "x"})
    assert got["ref"]["salvage"][1][1:] == (1, [])


@pytest.mark.parametrize("kind", ["null", "value"])
def test_overlong_change_chunk_key_string_is_refused_by_both(kind):
    """A change's key-string column counts toward its op count in both
    parsers, so its overrun leaves ops without an action: both refuse the
    chunk. The port's message is its native column check's own (the
    change parser's, since it decodes no op), so only the class and the
    counts are compared."""
    got = loads(overlong_change(RC.COL_KEY_STR, run_bytes(kind)))
    for name in ("ref", "port"):
        assert got[name]["load"][:2] == ("error", "ValueError")
        assert got[name]["load_incremental"] == ("ok", 0)
        scanned, applied, dropped = got[name]["salvage"][1]
        assert applied == 0 and len(dropped) == 1
    assert got["port"]["salvage"][1][0] == got["ref"]["salvage"][1][0]
