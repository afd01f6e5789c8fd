"""Native column extraction with deferred op decoding: the port's parse,
``OpLog.from_changes`` and the served splice against the JAX package's.

The port's ``parse_change`` keeps the column bytes (``LazyOps``) and
checks them in one native pass; its ``OpLog.from_changes`` assembles the
columns natively (``assemble.assemble_log``), and ``fast=False`` is the
per-op oracle. On the same change bytes the native log, the oracle's and
the JAX package's ``from_changes`` must be equal on every column,
``props``, ``mark_names`` and value, for the three workloads at small
size, the seeded histories and every text encoding; a log assembled
alone must equal the same log assembled after another one that shares
its changes (the JAX package's hash cache does not, ROADMAP §3). A seeded
corpus of mutated change chunks (bytes flipped, inserted or cut inside
the op columns, actor indices set past the table, the checksum
recomputed) must be accepted and rejected by both parsers alike, and
where both accept, decode to the same ops and assemble to the same log.
"""

import functools
import random
import warnings

import numpy as np
import pytest

from automerge_tpu.api import AutoDoc
from automerge_tpu.ops import extract as JX
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu.types import ActorId, ObjType
from automerge_tpu.types import using_text_encoding as j_using
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.ops import assemble as A
from automerge_tpu_torch.ops.oplog import OpLog
from automerge_tpu_torch.storage import columns as C
from automerge_tpu_torch.storage.change import (
    COL_KEY_ACTOR, COL_KEY_CTR, COL_OBJ_ACTOR, COL_OBJ_CTR, COL_PRED_ACTOR,
    COL_PRED_CTR, parse_change)
from automerge_tpu_torch.storage.chunk import CHUNK_CHANGE, parse_chunk, write_chunk
from automerge_tpu_torch.types import using_text_encoding
from automerge_tpu_torch.utils.codecs import RleEncoder, rle_decode
from automerge_tpu_torch.utils.leb128 import decode_sleb, decode_uleb

from .test_torch_histories import _history

COLUMNS = ("id_key", "obj_key", "obj_table", "obj_dense", "prop", "elem_ref",
           "action", "insert", "value_tag", "value_int", "width", "expand",
           "mark_name_idx", "pred_src", "pred_tgt")
ENCODINGS = ("unicode", "utf8", "utf16")


@pytest.fixture(autouse=True)
def cold_jax_change_cache(monkeypatch):
    """The JAX package's per-change-hash cache starts empty (ROADMAP §3)."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)


def _values(log):
    return [tuple(log.values[i]) for i in range(log.n)]


def assert_logs_equal(got, want, where=""):
    assert (got.n, got.n_objs) == (want.n, want.n_objs), where
    assert list(got.props) == list(want.props), where
    assert list(got.mark_names) == list(want.mark_names), where
    assert [a.bytes for a in got.actors] == [a.bytes for a in want.actors], where
    for k in COLUMNS:
        g, w = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert g.dtype == w.dtype, f"{where} {k}"
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")
    assert _values(got) == _values(want), where


def _text_blobs(make_trace):
    trace = make_trace(3000)
    base = W.build_base(trace, 2000)
    return [c.raw_bytes for c in base.changes + W.synth_fanin(base, trace, 16, 100, 2000)]


def _record_blobs():
    base, reps, _ = W.record_store(256, 16, 20)
    return [base.raw_bytes] + [r.raw_bytes for r in reps]


def _unicode_blobs():
    """Forks splicing multi-byte and supplementary-plane characters into
    one text, with marks and map keys outside ASCII."""
    base = AutoDoc(actor=ActorId(bytes([1]) * 16))
    t = base.put_object("_root", "tëxt", ObjType.TEXT)
    base.splice_text(t, 0, 0, "héllo wörld 😀 中文")
    base.commit()
    forks = [base.fork(actor=ActorId(bytes([20 + i]) * 16)) for i in range(4)]
    for i, f in enumerate(forks):
        f.splice_text(t, 2 + i, 1, "🎉é" * (i + 1))
        f.mark(t, 1, 5 + i, "bøld", True)
        f.put("_root", f"ключ{i}", "värde")
        f.commit()
    seen, out = set(), []
    for d in [base] + forks:
        for a in d.doc.history:
            if a.stored.hash not in seen:
                seen.add(a.stored.hash)
                out.append(a.stored.raw_bytes)
    return out


SOURCES = {
    "text": lambda: _text_blobs(W.load_trace),
    "typing": lambda: _text_blobs(lambda n: W.typing_trace(n, 1)),
    "records": _record_blobs,
    "unicode": _unicode_blobs,
    **{f"history{s}": (lambda s=s: _history(s)[1]) for s in range(8)},
}


@functools.lru_cache(maxsize=None)
def _blobs(name):
    return SOURCES[name]()


def _j_log(blobs, fast=None):
    return JOpLog.from_changes([j_parse_change(b)[0] for b in blobs], fast=fast)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_native_log_equals_oracle_and_jax(name):
    blobs = _blobs(name)
    log = OpLog.from_changes([parse_change(b)[0] for b in blobs])
    assert A.route([parse_change(b)[0] for b in blobs]) == A.ROUTE_ASSEMBLE
    oracle = OpLog.from_changes([parse_change(b)[0] for b in blobs], fast=False)
    assert_logs_equal(log, oracle, f"{name} oracle")
    assert_logs_equal(log, _j_log(blobs), f"{name} jax")


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("name", ["unicode", "history1"])
def test_native_log_follows_the_text_encoding(name, encoding):
    """The same change objects assembled under each encoding in turn: the
    cached columns recompute their widths (ChangeCols.ensure_width_encoding)."""
    blobs = _blobs(name)
    changes = [parse_change(b)[0] for b in blobs]
    for enc in ENCODINGS:  # warm the caches under every other encoding
        if enc != encoding:
            with using_text_encoding(enc):
                OpLog.from_changes(changes)
    with using_text_encoding(encoding):
        log = OpLog.from_changes(changes)
        oracle = OpLog.from_changes([parse_change(b)[0] for b in blobs], fast=False)
    with j_using(encoding):
        jlog = _j_log(blobs)
    assert_logs_equal(log, oracle, encoding)
    assert_logs_equal(log, jlog, encoding)


@pytest.mark.parametrize("name", ["history0", "history2", "records", "unicode"])
def test_a_log_assembled_alone_equals_one_assembled_after_another(name):
    """The changes of a smaller log are first assembled into a larger one
    (their column caches then hold that batch's decode); the smaller log
    built from them again equals the same log from freshly parsed changes,
    and the per-op oracle's: its props are its own keys in order of first
    use, not the larger log's."""
    blobs = _blobs(name)
    changes = [parse_change(b)[0] for b in blobs]
    OpLog.from_changes(changes)
    part = changes[: max(1, len(changes) // 3)]
    again = OpLog.from_changes(part)
    alone = OpLog.from_changes([parse_change(c.raw_bytes)[0] for c in part])
    assert_logs_equal(again, alone, "alone")
    oracle = OpLog.from_changes([parse_change(c.raw_bytes)[0] for c in part],
                                fast=False)
    assert_logs_equal(again, oracle, "oracle")


def _negative(name):
    """A change of history0 whose first element (``elem``) or pred
    (``pred``) counter is set to -5: a counter the parsers accept (both
    columns are delta-coded, signed) and the assembler does not place."""
    from automerge_tpu_torch.utils.codecs import DeltaEncoder, delta_decode

    spec = {"elem": COL_KEY_CTR, "pred": COL_PRED_CTR}[name]
    blobs = _blobs("history0")
    for i, blob in enumerate(blobs):
        head, cols, extra, _ = _split(blob)
        vals = delta_decode(cols.get(spec, b""))
        hit = [k for k, v in enumerate(vals) if v]
        if hit:
            vals[hit[0]] = -5
            enc = DeltaEncoder()
            for v in vals:
                enc.append(v)
            cols[spec] = enc.finish()
            return i, _join(head, cols, extra)
    raise AssertionError(f"history0 has no {name} counter")


@pytest.mark.parametrize("name", ["elem", "pred"])
def test_a_negative_counter_takes_the_batch_extraction(name, monkeypatch):
    """A negative element or pred counter routes, before any call, to the
    batch extraction (``OpLog._collect_fast``), which places it as a
    missing reference: its log equals the per-op oracle's and the JAX
    package's, and the assembler never runs."""
    i, blob = _negative(name)
    blobs = list(_blobs("history0"))
    blobs[i] = blob
    changes = [parse_change(b)[0] for b in blobs]
    assert A.route(changes) == A.ROUTE_BATCH
    ran = []
    collect_fast = OpLog._collect_fast.__func__

    def spy(cls, *args):
        ran.append(True)
        return collect_fast(cls, *args)

    def refuse(*args):
        raise AssertionError("the assembler ran on a negative counter")

    monkeypatch.setattr(OpLog, "_collect_fast", classmethod(spy))
    monkeypatch.setattr(A, "assemble_log", refuse)
    log = OpLog.from_changes(changes)
    assert ran == [True]
    if name == "elem":
        assert (log.elem_ref == -3).any()  # ELEM_MISSING
    else:
        assert (log.pred_tgt == -1).any()
    oracle = OpLog.from_changes([parse_change(b)[0] for b in blobs], fast=False)
    assert_logs_equal(log, oracle, "oracle")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert_logs_equal(log, _j_log(blobs), "jax")


@pytest.mark.parametrize("name", ["records", "history3", "unicode"])
def test_the_batch_extraction_equals_the_assembler(name):
    """``_collect_fast`` forced on changes the assembler takes gives the
    assembler's log, from the same column caches."""
    changes = [parse_change(b)[0] for b in _blobs(name)]
    log = OpLog.from_changes(changes)
    assert_logs_equal(OpLog._collect_fast(*OpLog._start(changes)), log, name)


def _root_keys_change(actor, keys):
    """A change of one put of null a key into the root map, for ``keys``,
    its columns written directly (a literal run of distinct strings)."""
    from automerge_tpu_torch.storage.change import COL_ACTION, COL_KEY_STR, COL_VAL_META
    from automerge_tpu_torch.storage.change import StoredChange, build_change
    from automerge_tpu_torch.utils.leb128 import sleb_bytes, uleb_bytes

    one = build_change(StoredChange(
        dependencies=[], actor=actor, other_actors=[], seq=1, start_op=1,
        timestamp=0, message=None, ops=_root_puts(1)))
    head, _, extra, _ = _split(one.raw_bytes)
    n = len(keys)
    strs = b"".join(uleb_bytes(len(k)) + k for k in (k.encode() for k in keys))
    cols = {COL_ACTION: sleb_bytes(n) + uleb_bytes(1),
            COL_KEY_STR: sleb_bytes(-n) + strs,
            COL_VAL_META: sleb_bytes(n) + uleb_bytes(0)}
    return _join(head, cols, extra)


def test_more_distinct_keys_than_a_million():
    """Two changes whose map keys, 2^20 + 22 distinct strings, are interned
    in one batch: the string table is sized by the rows, so the log
    assembles, every row keyed as written, props in order of first use."""
    n, overlap = (1 << 19) + 16, 10
    keys = [[f"k{j}" for j in range(n)], [f"k{j}" for j in range(n - overlap, 2 * n - overlap)]]
    actors = [bytes([1]) * 16, bytes([2]) * 16]
    blobs = [_root_keys_change(a, k) for a, k in zip(actors, keys)]
    log = OpLog.from_changes([parse_change(b)[0] for b in blobs])
    assert log.n == 2 * n
    assert log.props == list(dict.fromkeys(keys[0] + keys[1]))
    assert len(log.props) == 2 * n - overlap > 1 << 20
    from automerge_tpu_torch.types import ACTOR_BITS

    ctr = log.id_key >> ACTOR_BITS
    rank = log.id_key & ((1 << ACTOR_BITS) - 1)
    want = np.asarray(keys[0] + keys[1], object)[rank * n + ctr - 1]
    got = np.asarray(log.props, object)[log.prop]
    assert (got == want).all()


def test_bulk_text_read_equals_the_value_read():
    """``LazyValues.text`` (one gather, one decode) equals the rows' values
    joined one by one, with the stand-in for rows that hold no string."""
    from automerge_tpu_torch.ops.extract import LazyValues

    parts = [(6, "héllo".encode()), (3, bytes([0x2A])), (6, "😀中".encode()),
             (0, b""), (6, b""), (5, bytes(8)), (6, b"z")]
    raw = b"".join(p for _, p in parts)
    ln = np.asarray([len(p) for _, p in parts], np.int64)
    off = np.cumsum(ln) - ln
    vals = LazyValues(np.asarray([c for c, _ in parts], np.int32), off, ln,
                      bytearray(raw))
    for rows in ([0, 1, 2, 3, 4, 5, 6], [6, 2, 2, 0], [1, 3], [], [4]):
        want = "".join(vals[r].value if vals[r].tag == "str" else "\ufffc"
                       for r in rows)
        assert vals.text(np.asarray(rows, np.int64), "\ufffc") == want


@pytest.mark.parametrize("name", ["text", "unicode", "history0", "history5"])
def test_device_doc_text_equals_the_oracle_documents(name):
    """``DeviceDoc.text`` over the native log (the bulk read) equals it
    over the per-op oracle's log (a value a row)."""
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.types import ObjType, objtype_for_action

    blobs = _blobs(name)
    doc = DeviceDoc.merge(blobs, device="cpu")
    slow = DeviceDoc.resolve(
        OpLog.from_changes([parse_change(b)[0] for b in blobs], fast=False),
        device="cpu")
    texts = [doc.log.export_id(int(doc.log.id_key[r])) for r in range(doc.log.n)
             if objtype_for_action(int(doc.log.action[r])) == ObjType.TEXT]
    assert texts, name
    for t in texts:
        assert doc.text(t) == slow.text(t), t


class SpliceOracle:
    """The per-op oracle's log beside a served document's: every append
    the document's log makes (through ``_extract_delta``, counted) is
    repeated on the oracle with ``fast=False``, and a rebuilt document
    rebuilds the oracle. ``check`` holds the document's log to the
    oracle's splice and to a fresh ``from_changes`` of its changes."""

    def __init__(self, monkeypatch, doc):
        self.calls, self.deltas = [], 0
        append, extract = OpLog.append_changes, OpLog._extract_delta

        def spy_append(log, changes, fast=True):
            changes = list(changes)
            self.calls.append((log, changes, fast))
            return append(log, changes, fast)

        def spy_extract(log, fresh, rank_of):
            self.deltas += 1
            return extract(log, fresh, rank_of)

        monkeypatch.setattr(OpLog, "append_changes", spy_append)
        monkeypatch.setattr(OpLog, "_extract_delta", spy_extract)
        self.log = doc.log
        self.oracle = OpLog.from_changes(list(doc.log.changes), fast=False)

    def check(self, doc, where=""):
        calls, self.calls = self.calls, []
        for log, changes, fast in calls:
            if log is self.log and fast:
                assert self.oracle.append_changes(changes, fast=False) is not None, where
        if doc.log is not self.log:  # rebuilt
            self.log = doc.log
            self.oracle = OpLog.from_changes(list(doc.log.changes), fast=False)
        assert_logs_equal(doc.log, self.oracle, f"{where} oracle splice")
        fresh = OpLog.from_changes([parse_change(c.raw_bytes)[0]
                                    for c in doc.log.changes])
        assert_logs_equal(doc.log, fresh, f"{where} fresh from_changes")


def test_a_counter_past_the_packed_range_raises():
    """A built change whose op counters pass 2^43 (the packed ids' range;
    a parsed one cannot: its start_op is at most 2^32 - 1) raises in the
    port, in from_changes and in the served splice, where the per-op
    oracle overflows; it never gives a log."""
    from automerge_tpu_torch.ops.device_doc import DeviceDoc
    from automerge_tpu_torch.storage.change import StoredChange, build_change

    base, _, _ = W.record_store(16, 2, 20)
    far = build_change(StoredChange(
        dependencies=[base.hash], actor=bytes([9]) * 16, other_actors=[],
        seq=1, start_op=A.PACKED_CTR - 2, timestamp=0, message=None,
        ops=_root_puts(3)))
    with pytest.raises(A.AssembleError, match="packed range"):
        OpLog.from_changes([base, far])
    with pytest.raises(OverflowError):
        OpLog.from_changes([base, far], fast=False)
    doc = DeviceDoc.merge([base.raw_bytes], device="cpu")
    n = doc.log.n
    with pytest.raises(A.AssembleError, match="packed range"):
        doc.apply_changes([far])
    assert doc.log.n == n


def _root_puts(k):
    from automerge_tpu_torch.storage.change import ChangeOp
    from automerge_tpu_torch.types import Key, ScalarValue

    return [ChangeOp(obj=(0, -1), key=Key.map(f"far{i}"), insert=False, action=1,
                     value=ScalarValue("int", i)) for i in range(k)]


# -- the mutation corpus ------------------------------------------------------

OP_SPECS = (1, 2, 17, 19, 21, 52, 66, 86, 87, 112, 113, 115, 148, 165)
ACTOR_SPECS = (COL_OBJ_ACTOR, COL_KEY_ACTOR, COL_PRED_ACTOR)


def _split(blob):
    """(the body before its column metadata, op columns by spec, extra
    bytes, actor table size) of a change chunk."""
    chunk, _ = parse_chunk(blob)
    data = chunk.data
    pos = 0
    ndeps, pos = decode_uleb(data, pos)
    pos += 32 * ndeps
    alen, pos = decode_uleb(data, pos)
    pos += alen
    for _ in range(2):  # seq, start_op
        _, pos = decode_uleb(data, pos)
    _, pos = decode_sleb(data, pos)
    mlen, pos = decode_uleb(data, pos)
    pos += mlen
    nother, pos = decode_uleb(data, pos)
    for _ in range(nother):
        olen, pos = decode_uleb(data, pos)
        pos += olen
    head = bytes(data[:pos])
    metas, start = C.parse_columns(data, pos)
    cols = C.slice_column_data(data, metas, start)
    extra = bytes(data[start + C.total_column_len(metas):])
    return head, cols, extra, 1 + nother


def _join(head, cols, extra):
    body = bytearray(head)
    C.write_columns(sorted(cols.items()), body)
    body += extra
    return write_chunk(CHUNK_CHANGE, bytes(body))


def _reencode(cols, s, rng, value):
    """Column ``s`` with one of its non-null values replaced by ``value``
    (False when the column has none)."""
    vals = rle_decode(cols.get(s, b""), "uint")
    idx = [i for i, v in enumerate(vals) if v is not None]
    if not idx:
        return False
    vals[rng.choice(idx)] = value
    enc = RleEncoder("uint")
    for v in vals:
        enc.append(v)
    cols[s] = enc.finish()
    return True


def _mutate(rng, blob):
    """One seeded mutation of a change chunk's op columns: a byte flipped,
    inserted or cut, an actor index set past the table, or (now and then)
    an object counter set past the packed ids' range; the column metadata
    and the checksum are rewritten around it."""
    head, cols, extra, n_actors = _split(blob)
    kind = rng.choice(("flip", "flip", "insert", "truncate", "actor") * 4 + ("counter",))
    if kind == "counter":
        if _reencode(cols, COL_OBJ_CTR, rng, A.PACKED_CTR + rng.randrange(1 << 20)):
            return _join(head, cols, extra), kind
        kind = "flip"
    if kind == "actor":
        present = [s for s in ACTOR_SPECS if cols.get(s)]
        if present and _reencode(cols, rng.choice(present), rng,
                                 n_actors + rng.randrange(3)):
            return _join(head, cols, extra), kind
        kind = "flip"
    present = [s for s in OP_SPECS if cols.get(s)]
    s = rng.choice(present)
    buf = bytearray(cols[s])
    if kind == "flip":
        buf[rng.randrange(len(buf))] ^= rng.randrange(1, 256)
    elif kind == "insert":
        buf.insert(rng.randrange(len(buf) + 1), rng.randrange(256))
    else:
        del buf[rng.randrange(len(buf)):]
    cols[s] = bytes(buf)
    return _join(head, cols, extra), kind


def _crafted(name):
    """A change of history0 with one op column replaced by a crafted one at
    the edges of the per-op decoder's rules."""
    from automerge_tpu_torch.utils.leb128 import sleb_bytes, uleb_bytes

    blob = _blobs("history0")[3]
    head, cols, extra, _ = _split(blob)
    n = len(parse_change(blob)[0].ops)
    run = lambda k, v: sleb_bytes(k) + uleb_bytes(v)  # noqa: E731
    # a column's n rows (an empty column: n nulls), then more past them
    full = lambda s: cols.get(s) or run(0, n)  # noqa: E731
    text = lambda v: uleb_bytes(len(v)) + v  # noqa: E731
    spec, col = {
        # the action column read without a row count: capped at 2^24 values
        "action_run_past_the_cap": (66, run(1 << 25, 1)),
        "action_run_at_the_cap": (66, run(1 << 24, 1)),
        "action_bytes_after_the_cap": (66, run(1 << 24, 1) + run(0, 0)),
        # columns longer than the op count: accepted, their tail unread
        "obj_actor_longer": (1, full(1) + run(3, 0)),
        "mark_name_longer": (165, full(165) + sleb_bytes(1) + text(b"tail")),
        "pred_group_longer": (112, full(112) + run(2, 7)),
        "insert_huge_run": (52, uleb_bytes(1 << 40)),
        # a surrogate in a string past the ops, a value longer than the heap
        "mark_name_surrogate": (165, full(165) + sleb_bytes(1) + text(b"\xed\xa0")),
        "value_longer_than_the_heap": (86, sleb_bytes(-1) + uleb_bytes((1 << 62) | 6)
                                       + cols.get(86, b"")),
    }[name]
    cols[spec] = col
    return _join(head, cols, extra)


CRAFTED = ("action_run_past_the_cap", "action_run_at_the_cap",
           "action_bytes_after_the_cap", "obj_actor_longer", "mark_name_longer",
           "pred_group_longer", "insert_huge_run", "mark_name_surrogate",
           "value_longer_than_the_heap")


@pytest.mark.parametrize("name", CRAFTED)
def test_crafted_chunks_parse_and_assemble_alike(name):
    """Chunks at the edges of the per-op decoder's rules: both parsers
    raise or both accept, and an accepted one assembles (with the
    document's other changes) to the JAX package's log and the oracle's."""
    blob = _crafted(name)
    j, jerr = _outcome(lambda: j_parse_change(blob)[0])
    t, terr = _outcome(lambda: parse_change(blob)[0])
    assert (jerr is None) == (terr is None), f"jax {jerr!r} port {terr!r}"
    if terr is not None:
        assert isinstance(terr, ValueError)
        return
    assert [_op_key(o) for o in t.ops] == [_op_key(o) for o in j.ops]
    rest = [b for k, b in enumerate(_blobs("history0")) if k != 3]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jlog = JOpLog.from_changes([j_parse_change(b)[0] for b in rest] + [j])
    log = OpLog.from_changes([parse_change(b)[0] for b in rest] + [t])
    assert_logs_equal(log, jlog, "jax")
    oracle = OpLog.from_changes([parse_change(b)[0] for b in rest + [blob]], fast=False)
    assert_logs_equal(log, oracle, "oracle")


def _op_key(o):
    return (o.obj, o.key.prop, o.key.elem, o.insert, o.action, tuple(o.value),
            o.pred, o.expand, o.mark_name)


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return None, e


CORPUS_SOURCES = ("history0", "history1", "history2", "history3", "history4",
                  "unicode", "records", "text")
PER_CASE = 50


@pytest.mark.parametrize("case", range(12))
def test_mutated_chunks_parse_and_assemble_alike(case, monkeypatch):
    """PER_CASE mutated chunks a case (600 over the cases): both parsers
    raise or both accept; where both accept, the ops are the same, and the
    log of the document's other changes plus the mutated one is the JAX
    package's, or, where the port refuses a counter past the packed range,
    the per-op paths of both packages raise too."""
    rng = random.Random(7919 * case + 1)
    name = CORPUS_SOURCES[case % len(CORPUS_SOURCES)]
    blobs = _blobs(name)
    if len(blobs) > 24:
        blobs = blobs[:24]
    others_t = {}  # the port's parsed changes, reused (their caches too)
    accepted = 0
    for m in range(PER_CASE):
        i = rng.randrange(len(blobs))
        mutated, kind = _mutate(rng, blobs[i])
        j, jerr = _outcome(lambda: j_parse_change(mutated)[0])
        t, terr = _outcome(lambda: parse_change(mutated)[0])
        where = f"{name} #{m} {kind} change {i}"
        assert (jerr is None) == (terr is None), f"{where}: jax {jerr!r} port {terr!r}"
        if terr is not None:
            assert isinstance(terr, ValueError), where
            continue
        accepted += 1
        assert len(t.ops) == len(j.ops), where
        assert [_op_key(o) for o in t.ops] == [_op_key(o) for o in j.ops], where
        rest = [b for k, b in enumerate(blobs) if k != i]
        t_changes = [others_t.setdefault(b, parse_change(b)[0]) for b in rest] + [t]
        monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)
        j_changes = [j_parse_change(b)[0] for b in rest] + [j]
        tlog, terr = _outcome(lambda: OpLog.from_changes(t_changes))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jlog, jerr = _outcome(lambda: JOpLog.from_changes(j_changes))
        if terr is None:
            assert jerr is None, f"{where}: jax {jerr!r}"
            assert_logs_equal(tlog, jlog, where)
            continue
        assert isinstance(terr, A.AssembleError) and "packed range" in str(terr), where
        _, slow = _outcome(lambda: JOpLog.from_changes(
            [j_parse_change(b)[0] for b in rest] + [j], fast=False))
        _, oracle = _outcome(lambda: OpLog.from_changes(t_changes, fast=False))
        assert slow is not None and oracle is not None, where
    assert accepted, name
