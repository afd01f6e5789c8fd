"""The N-replica fan-in workloads, built at the change level.

Two documents: the edit trace (a text object, below) and the record store
(a map of records, ``record_store`` at the end of the module).

The edit trace:

A copy of ``automerge_tpu/bench.py``'s generator (:37-232) that needs no
document or transaction layer: ``build_base`` replays the trace into ONE
change exactly as a document's ``splice_text`` calls would (the same ops,
ids and bytes), keeping the visible-element list as it goes; each replica
(``synth_seq_change``) then gets a distinct actor, distinct anchor
positions and payload from its own trace slice, with deps = the base heads.

The trace is the reference's edit trace when a path to it is given, else
a deterministic synthetic one (``numpy.random.default_rng(0)``);
``typing_trace`` is a seeded trace shaped like typing, whose inserts chain.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .storage.change import HEAD_STORED, ChangeOp, StoredChange, build_change
from .types import Key, ScalarValue

TRACE_EDITS = 260_000
BASE_ACTOR = bytes([1]) * 16

_ACTION_MAKE_MAP = 0
_ACTION_PUT = 1
_ACTION_DELETE = 3
_ACTION_MAKE_TEXT = 4
_ACTION_INCREMENT = 5


def load_trace(limit: Optional[int] = None, path: Optional[str] = None) -> list:
    """The edit trace at ``path`` (a JSON list of [pos, ndel, *chars]), or
    the deterministic synthetic fallback of ``limit`` (default 260,000)
    edits: 85% single-character inserts, else single deletes."""
    if path is not None:
        with open(path) as f:
            edits = json.load(f)
        return edits[:limit] if limit else edits
    rng = np.random.default_rng(0)
    n = limit or TRACE_EDITS
    edits, length = [], 0
    for _ in range(n):
        if length == 0 or rng.random() < 0.85:
            edits.append([int(rng.integers(0, length + 1)), 0, "x"])
            length += 1
        else:
            edits.append([int(rng.integers(0, length)), 1])
            length -= 1
    return edits


# The automerge-perf editing trace (the 259,778 edits that automerge's
# rust/edit-trace replays) publishes its counts as 182,315 single-character
# inserts and 77,463 single-character deletes.
TYPING_INSERT_SHARE = 182_315 / 259_778
# Edits in one typing stretch plus the delete stretch after it, fitted so
# that typing_trace's BASELINE fan-in (260,000-edit base, 1024 replicas x
# 250 edits) has the condensed run count that the JAX package's bench
# counted on the real trace at that fan-in: 20,205 runs
# (BENCH_builder_r05.json, "condensed_runs").
TYPING_CYCLE = 46


def typing_trace(n: int, seed: int = 0) -> list:
    """A seeded trace of ``n`` edits in ``load_trace``'s [pos, ndel,
    *chars] form, shaped like typing: the writer types a stretch of
    characters (a-z) at the cursor, then moves the cursor to a uniformly
    random position and deletes a stretch backwards from there, then
    types there again, and so on. Stretch lengths are geometric, with the
    inserts' share of the edits ``TYPING_INSERT_SHARE`` and a mean cycle
    of ``TYPING_CYCLE`` edits (at position 0 a delete types instead).
    Consecutive typing chains each character off the one before, which is
    what the condensed linearization condenses; ``load_trace``'s
    synthetic fallback edits at a random position every time, so almost
    nothing chains there."""
    rng = np.random.default_rng(seed)
    end_typing = 1 / (TYPING_CYCLE * TYPING_INSERT_SHARE)
    end_deleting = 1 / (TYPING_CYCLE * (1 - TYPING_INSERT_SHARE))
    u = rng.random(n)
    where = rng.random(n)
    chars = rng.integers(0, 26, n)
    edits, length, cursor, typing = [], 0, 0, True
    for i in range(n):
        if typing and u[i] < end_typing:
            typing = False
            cursor = int(where[i] * (length + 1))
        elif not typing and u[i] < end_deleting:
            typing = True
        if typing or cursor == 0:
            edits.append([cursor, 0, chr(ord("a") + int(chars[i]))])
            cursor += 1
            length += 1
        else:
            edits.append([cursor - 1, 1])
            cursor -= 1
            length -= 1
    return edits


class BaseInfo:
    """Everything the synthesizers need to know about the base document."""

    def __init__(self, change: StoredChange, elems: List[Tuple[int, bytes]]):
        self.changes = [change]
        self.heads = [change.hash]
        self.max_op = change.max_op
        self.text_obj: Tuple[int, bytes] = (1, change.actor)
        self.text_exid = f"1@{change.actor.hex()}"
        # visible elements in document order as (counter, actor bytes)
        self.elems = elems


def build_base(trace: Sequence, n_edits: int) -> BaseInfo:
    """The base document: ``base_change`` encoded into a change chunk."""
    change, elems = base_change(trace, n_edits)
    return BaseInfo(build_change(change), elems)


def base_change(trace: Sequence, n_edits: int):
    """Replay ``trace[:n_edits]`` into a text object "text" at the root as
    one (not yet encoded) change of actor ``BASE_ACTOR``: op 1 makes the
    text object; each edit deletes (each delete preds the element's insert
    op) then inserts characters chained off one another, anchored on the
    visible element before the position (HEAD at 0). Positions and delete
    counts are clamped to the current length. Returns the change and the
    visible elements in document order as (counter, actor bytes)."""
    text = (1, 0)
    ops: List[ChangeOp] = [
        ChangeOp(
            obj=(0, -1),
            key=Key.map("text"),
            insert=False,
            action=_ACTION_MAKE_TEXT,
            value=ScalarValue("null"),
        )
    ]
    ctr = 1
    elems: List[int] = []  # visible element counters in document order
    for e in trace[:n_edits]:
        pos = min(int(e[0]), len(elems))
        ndel = min(int(e[1]), len(elems) - pos)
        for el in elems[pos : pos + ndel]:
            ctr += 1
            ops.append(
                ChangeOp(
                    obj=text,
                    key=Key.seq((el, 0)),
                    insert=False,
                    action=_ACTION_DELETE,
                    value=ScalarValue("null"),
                    pred=[(el, 0)],
                )
            )
        del elems[pos : pos + ndel]
        anchor = (elems[pos - 1], 0) if pos else HEAD_STORED
        new = []
        for ch in "".join(e[2:]):
            ctr += 1
            ops.append(
                ChangeOp(
                    obj=text,
                    key=Key.seq(anchor),
                    insert=True,
                    action=_ACTION_PUT,
                    value=ScalarValue("str", ch),
                )
            )
            anchor = (ctr, 0)
            new.append(ctr)
        elems[pos:pos] = new
    change = StoredChange(
        dependencies=[],
        actor=BASE_ACTOR,
        other_actors=[],
        seq=1,
        start_op=1,
        timestamp=0,
        message=None,
        ops=ops,
    )
    return change, [(c, BASE_ACTOR) for c in elems]


def _replica_actor(i: int) -> bytes:
    return b"\x03" + i.to_bytes(3, "big") + bytes(12)


def synth_seq_change(
    base: BaseInfo,
    actor: bytes,
    edits: Sequence,
    seed: int,
) -> StoredChange:
    """``seq_change`` encoded into a change chunk."""
    return build_change(seq_change(base, actor, edits, seed))


def seq_change(
    base: BaseInfo,
    actor: bytes,
    edits: Sequence,
    seed: int,
) -> StoredChange:
    """One replica's divergent (not yet encoded) change against ``base``:
    trace-slice edits re-anchored onto the base document's element ids.

    Inserts chain off one another exactly as a replayed splice would
    (transaction/inner.rs:672-683); deletes pred the element's insert op
    (elements of a pure-splice doc are never overwritten). Anchors come
    from the slice's own positions, so every replica diverges genuinely.
    """
    rng = np.random.default_rng(seed)
    n_base = len(base.elems)
    # chunk-local actor table: author first, then referenced others sorted
    others = sorted(({a for _, a in base.elems} | {base.text_obj[1]}) - {actor})
    local = {actor: 0, **{a: i + 1 for i, a in enumerate(others)}}
    obj = (base.text_obj[0], local[base.text_obj[1]])

    ops: List[ChangeOp] = []
    ctr = base.max_op  # ids start at max_op + 1
    deleted: set = set()
    last_insert: Optional[Tuple[int, int]] = None
    last_insert_pos = -2
    for e in edits:
        pos = min(int(e[0]), max(n_base - 1, 0))
        text = "".join(e[2:])
        if e[1] and n_base:
            # delete a not-yet-deleted base element near the trace position
            k = pos
            for _ in range(8):
                if k not in deleted and k < n_base:
                    break
                k = int(rng.integers(0, n_base))
            if k in deleted or k >= n_base:
                continue
            deleted.add(k)
            ec, ea = base.elems[k]
            elem = (ec, local[ea])
            ctr += 1
            ops.append(
                ChangeOp(
                    obj=obj,
                    key=Key.seq(elem),
                    insert=False,
                    action=_ACTION_DELETE,
                    value=ScalarValue("null"),
                    pred=[elem],
                )
            )
        for ch in text:
            if last_insert is not None and pos == last_insert_pos + 1:
                elem = last_insert  # chain onto our own previous insert
            elif pos == 0 or n_base == 0:
                elem = HEAD_STORED
            else:
                ec, ea = base.elems[min(pos - 1, n_base - 1)]
                elem = (ec, local[ea])
            ctr += 1
            ops.append(
                ChangeOp(
                    obj=obj,
                    key=Key.seq(elem),
                    insert=True,
                    action=_ACTION_PUT,
                    value=ScalarValue("str", ch),
                )
            )
            last_insert = (ctr, 0)
            last_insert_pos = pos
            pos += 1
    return StoredChange(
        dependencies=list(base.heads),
        actor=actor,
        other_actors=others,
        seq=1,
        start_op=base.max_op + 1,
        timestamp=0,
        message=None,
        ops=ops,
    )


def synth_fanin(
    base: BaseInfo, trace: Sequence, n_replicas: int, per_replica: int, offset: int
) -> List[StoredChange]:
    """``fanin_changes`` encoded into change chunks."""
    return [
        build_change(c)
        for c in fanin_changes(base, trace, n_replicas, per_replica, offset)
    ]


def fanin_changes(
    base: BaseInfo, trace: Sequence, n_replicas: int, per_replica: int, offset: int
) -> List[StoredChange]:
    """N divergent replicas (changes not yet encoded), each replaying its
    own trace slice.

    Slices wrap within [offset/2, end) — the full-trace base leaves no
    tail, and the LATE trace is what carries real editing behavior
    (cursor jumps, deletes, spread positions). Early-trace slices are
    pure sequential typing whose inserts all chain locally, which would
    flatter every engine's fast path and measure nothing."""
    out = []
    lo0 = min(offset // 2, max(len(trace) - per_replica - 1, 0))
    span = max(len(trace) - lo0 - per_replica, 1)
    for i in range(n_replicas):
        lo = lo0 + (offset // 2 + i * per_replica) % span
        out.append(
            seq_change(
                base, _replica_actor(i), trace[lo : lo + per_replica], seed=1000 + i
            )
        )
    return out


def expected_text_length(changes: Sequence[StoredChange]) -> int:
    """Characters a merge of ``changes`` must show, counted from the ops
    alone: inserted elements minus the distinct elements deleted. Holds
    for this workload's changes (one-character inserts, each delete
    targeting an inserted element by its id)."""
    inserts = 0
    deleted = set()
    for ch in changes:
        actors = ch.actors
        for op in ch.ops:
            if op.insert:
                inserts += 1
            elif op.action == _ACTION_DELETE:
                deleted.add((op.key.elem[0], actors[op.key.elem[1]]))
    return inserts - len(deleted)


# -- the record store ----------------------------------------------------
#
# BASELINE's "Map+Counter CRDT" workload reshaped into the collection
# layout Automerge documents use for keyed records (a todo list, a kanban
# board, a table of rows): ``_root.records`` is a map of R records, each a
# map of seven scalar fields and one counter, ``votes``. Every replica
# forks from the base heads with one change of about 60% puts to random
# (record, scalar field) keys, 25% ``votes`` increments, 10% new records
# (a make_map under a key of its own plus its fields) and 5% deletes of a
# base record. Each replica puts a given key at most once and deletes a
# given record at most once, so the merge's counts follow from the ops.

RECORDS = 65_536
RECORD_REPLICAS, RECORD_PER_REPLICA = 1024, 250
RECORD_BATCH = 16  # replica changes per served batch
# the seven scalar fields and their types; the eighth field is the counter
RECORD_FIELDS = (
    ("title", "str"), ("owner", "str"), ("status", "str"),
    ("priority", "int"), ("points", "int"), ("done", "bool"), ("due", "null"),
)
COUNTER_FIELD = "votes"
RECORDS_OBJ = f"1@{BASE_ACTOR.hex()}"  # _root.records, the base's op 1
_OPS_PER_RECORD = 2 + len(RECORD_FIELDS)  # make_map, scalars, counter


def _record_key(i: int) -> str:
    return f"r{i:06d}"


def _field_value(field_type: str, i: int) -> ScalarValue:
    if field_type == "str":
        return ScalarValue("str", f"v{i}")
    if field_type == "int":
        return ScalarValue("int", i % 1000)
    if field_type == "bool":
        return ScalarValue("bool", bool(i & 1))
    return ScalarValue("null")


def _make_record(obj, key: str) -> ChangeOp:
    return ChangeOp(obj=obj, key=Key.map(key), insert=False,
                    action=_ACTION_MAKE_MAP, value=ScalarValue("null"))


def _field_ops(record, i: int) -> List[ChangeOp]:
    """The eight field puts of the record whose make_map is ``record``."""
    ops = [
        ChangeOp(obj=record, key=Key.map(name), insert=False,
                 action=_ACTION_PUT, value=_field_value(t, i))
        for name, t in RECORD_FIELDS
    ]
    ops.append(ChangeOp(obj=record, key=Key.map(COUNTER_FIELD), insert=False,
                        action=_ACTION_PUT, value=ScalarValue("counter", 0)))
    return ops


def record_base_change(n_records: int) -> StoredChange:
    """The base (actor ``BASE_ACTOR``, not yet encoded): op 1 makes
    ``_root.records``; record i is the make_map at op 2 + 9i under key
    ``r%06d``, then its fields at the next eight ops (``votes`` last)."""
    ops: List[ChangeOp] = [
        ChangeOp(obj=(0, -1), key=Key.map("records"), insert=False,
                 action=_ACTION_MAKE_MAP, value=ScalarValue("null"))
    ]
    for i in range(n_records):
        ops.append(_make_record((1, 0), _record_key(i)))
        ops += _field_ops((len(ops), 0), i)  # the make_map's counter
    return StoredChange(dependencies=[], actor=BASE_ACTOR, other_actors=[],
                        seq=1, start_op=1, timestamp=0, message=None, ops=ops)


def _record_ctr(i: int) -> int:
    """Op counter of base record i's make_map."""
    return 2 + _OPS_PER_RECORD * i


def _record_replica_actor(i: int) -> bytes:
    return b"\x04" + i.to_bytes(3, "big") + bytes(12)


class RecordExpect:
    """What a merge of the base and some replicas must show, counted from
    the generator's own ops: visible records, the sum of ``votes`` over
    them, and the (record, scalar field) keys with more than one visible
    value."""

    def __init__(self, n_records: int):
        self.n_records = n_records
        self.deleted: set = set()
        self.created = 0
        self.votes: Dict[int, int] = {}  # base record -> increments landed
        self.puts: Dict[Tuple[int, int], int] = {}  # (record, field) -> puts

    def counts(self) -> dict:
        live = lambda rec: rec not in self.deleted  # noqa: E731
        return {
            "records": self.n_records - len(self.deleted) + self.created,
            "votes": sum(v for rec, v in self.votes.items() if live(rec)),
            "conflict_keys": sum(
                1 for (rec, _), n in self.puts.items() if n > 1 and live(rec)),
        }


def record_replica_change(base: StoredChange, n_records: int, replica: int,
                          n_ops: int, expect: RecordExpect) -> StoredChange:
    """Replica ``replica``'s change (not yet encoded), forked from the
    base heads: n_ops ops, of which 10% new records (whole records of
    nine ops), 5% deletes, 25% increments and the rest puts, in a seeded
    order. Puts and deletes pred the base op they overwrite, increments
    the base counter put. Adds what it does to ``expect``."""
    rng = np.random.default_rng(1000 + replica)
    n_new = int(n_ops * 0.10 / _OPS_PER_RECORD + 0.5)
    if n_ops >= 2 * _OPS_PER_RECORD:
        n_new = max(n_new, 1)  # a small change still makes a record
    n_del = int(n_ops * 0.05 + 0.5)
    n_inc = int(n_ops * 0.25 + 0.5)
    n_put = n_ops - n_new * _OPS_PER_RECORD - n_del - n_inc
    n_fields = len(RECORD_FIELDS)
    puts = rng.choice(n_records * n_fields, n_put, replace=False)
    dels = rng.choice(n_records, n_del, replace=False)
    incs = rng.integers(0, n_records, n_inc)
    amounts = rng.integers(1, 6, n_inc)
    events = ([("put", int(x)) for x in puts] + [("del", int(x)) for x in dels]
              + [("inc", j) for j in range(n_inc)]
              + [("new", j) for j in range(n_new)])
    order = rng.permutation(len(events))

    B = 1  # the base actor's index in this change's actor table
    ops: List[ChangeOp] = []
    ctr = base.max_op
    for e in order:
        kind, x = events[int(e)]
        if kind == "put":
            rec, f = divmod(x, n_fields)
            name, t = RECORD_FIELDS[f]
            ops.append(ChangeOp(
                obj=(_record_ctr(rec), B), key=Key.map(name), insert=False,
                action=_ACTION_PUT, value=_field_value(t, replica + x),
                pred=[(_record_ctr(rec) + 1 + f, B)]))
            expect.puts[(rec, f)] = expect.puts.get((rec, f), 0) + 1
        elif kind == "del":
            ops.append(ChangeOp(
                obj=(1, B), key=Key.map(_record_key(x)), insert=False,
                action=_ACTION_DELETE, value=ScalarValue("null"),
                pred=[(_record_ctr(x), B)]))
            expect.deleted.add(x)
        elif kind == "inc":
            rec, by = int(incs[x]), int(amounts[x])
            votes = _record_ctr(rec) + 1 + n_fields
            ops.append(ChangeOp(
                obj=(_record_ctr(rec), B), key=Key.map(COUNTER_FIELD),
                insert=False, action=_ACTION_INCREMENT,
                value=ScalarValue("int", by), pred=[(votes, B)]))
            expect.votes[rec] = expect.votes.get(rec, 0) + by
        else:
            ops.append(_make_record((1, B), f"n{replica:06d}x{x}"))
            ops += _field_ops((ctr + len(ops), 0), replica + x)
            expect.created += 1
    return StoredChange(
        dependencies=[base.hash], actor=_record_replica_actor(replica),
        other_actors=[BASE_ACTOR], seq=1, start_op=ctr + 1, timestamp=0,
        message=None, ops=ops)


def record_store(n_records: int = RECORDS, n_replicas: int = RECORD_REPLICAS,
                 per_replica: int = RECORD_PER_REPLICA):
    """(encoded base change, encoded replica changes, expected counts of
    their merge). The records map is the object ``RECORDS_OBJ``."""
    base = build_change(record_base_change(n_records))
    expect = RecordExpect(n_records)
    reps = [
        build_change(record_replica_change(base, n_records, i, per_replica,
                                           expect))
        for i in range(n_replicas)
    ]
    return base, reps, expect.counts()


def record_batches(changes: Sequence, batch: int = RECORD_BATCH) -> List[list]:
    """The served order: the replicas in groups of ``batch``."""
    return [list(changes[i : i + batch]) for i in range(0, len(changes), batch)]


def record_counts(doc) -> dict:
    """The counts of ``RecordExpect`` read off a merged ``DeviceDoc``:
    ``keys`` of the records map, ``map_entries`` of every visible record for the
    ``votes`` sum, and the winner rows of its scalar fields whose
    conflict count exceeds one."""
    records = doc.keys(RECORDS_OBJ)
    votes = 0
    rec_objs = []
    for _, (_, _, rec), _ in doc.map_entries(RECORDS_OBJ):
        rec_objs.append(doc.log.import_id(rec))
        for name, value, _ in doc.map_entries(rec):
            if name == COUNTER_FIELD:
                votes += value[1]
    log = doc.log
    n = log.n
    scalar = [log.props.index(f) for f, _ in RECORD_FIELDS if f in log.props]
    rows = np.arange(n)
    winners = (
        np.isin(log.obj_key[:n], np.asarray(rec_objs, np.int64))
        & np.isin(log.prop[:n], np.asarray(scalar, np.int32))
        & (doc.winner[:n] == rows)
        & (doc.conflicts[:n] > 1)
    )
    return {"records": len(records), "votes": votes,
            "conflict_keys": int(np.count_nonzero(winners))}


# -- the serve-shaped documents ----------------------------------------------
#
# A server's hot set (``automerge_tpu/bench.py`` ``sb_workload``, :1196-1226):
# every document has a text ``_root.live`` seeded with "live seed text " and
# an untouched text ``_root.archive`` of ``ballast`` "x"s (the resident
# history that keeps a drained delta's dirty rows a small share of the
# log), and one editor that types into ``live`` each cycle and commits
# once. The editor's actor is ``bytes([31 + (tag & 1)]) + bytes([i % 250])``
# then zeros; in cycle c it types ``ops`` characters, the j-th ("a" or "b")
# at position ``(i + c * ops + j) % max(len + j, 1)`` of the text as it
# stood at the cycle's start (length ``len``).

SERVE_ACTOR = bytes([0x15]) * 16
SERVE_LIVE = f"1@{SERVE_ACTOR.hex()}"  # _root.live, the base's op 1
SERVE_SEED = "live seed text "
SERVE_ARCHIVE = f"{2 + len(SERVE_SEED)}@{SERVE_ACTOR.hex()}"


def _chained_text(obj, counter: int, text: str) -> List[ChangeOp]:
    """Inserts of ``text`` at the head of ``obj``, each anchored on the one
    before it (a splice of fresh text), the first at op ``counter``."""
    ops = []
    anchor = HEAD_STORED
    for i, ch in enumerate(text):
        ops.append(ChangeOp(obj=obj, key=Key.seq(anchor), insert=True,
                            action=_ACTION_PUT, value=ScalarValue("str", ch)))
        anchor = (counter + i, 0)
    return ops


def serve_base_change(ballast: int) -> StoredChange:
    """The base every serve-shaped document shares (actor ``SERVE_ACTOR``,
    not yet encoded): op 1 makes ``live``, then its seed text; the next op
    makes ``archive``, then ``ballast`` "x"s."""
    ops = [ChangeOp(obj=(0, -1), key=Key.map("live"), insert=False,
                    action=_ACTION_MAKE_TEXT, value=ScalarValue("null"))]
    ops += _chained_text((1, 0), 2, SERVE_SEED)
    archive = len(ops) + 1
    ops.append(ChangeOp(obj=(0, -1), key=Key.map("archive"), insert=False,
                        action=_ACTION_MAKE_TEXT, value=ScalarValue("null")))
    ops += _chained_text((archive, 0), archive + 1, "x" * ballast)
    return StoredChange(dependencies=[], actor=SERVE_ACTOR, other_actors=[],
                        seq=1, start_op=1, timestamp=0, message=None, ops=ops)


def serve_editor_actor(i: int, tag: int = 0) -> bytes:
    return bytes([31 + (tag & 1), i % 250]) + bytes(14)


class ServeEditor:
    """Document ``i``'s editor: its changes (not yet encoded), one a cycle,
    and its own model of ``live`` (the characters in document order)."""

    def __init__(self, base: StoredChange, i: int, tag: int = 0):
        self.i = i
        self.actor = serve_editor_actor(i, tag)
        self.heads = [base.hash]
        self.next_op = base.max_op + 1
        self.seq = 0
        # live's elements in document order: (counter, author or base)
        self.elems = [(2 + j, SERVE_ACTOR) for j in range(len(SERVE_SEED))]
        self.chars = list(SERVE_SEED)

    def cycle(self, c: int, ops: int, n: Optional[int] = None) -> StoredChange:
        """Cycle ``c``'s change: ``n`` characters (default ``ops``) typed at
        the bench's positions (``ops`` sets their stride between cycles)."""
        local = {self.actor: 0, SERVE_ACTOR: 1}
        length = len(self.elems)
        out = []
        start = self.next_op
        for j in range(ops if n is None else n):
            pos = (self.i + c * ops + j) % max(length + j, 1)
            if pos:
                ctr, actor = self.elems[pos - 1]
                anchor = (ctr, local[actor])
            else:
                anchor = HEAD_STORED
            ch = "ab"[j % 2]
            out.append(ChangeOp(obj=(1, 1), key=Key.seq(anchor), insert=True,
                                action=_ACTION_PUT, value=ScalarValue("str", ch)))
            self.elems.insert(pos, (start + j, self.actor))
            self.chars.insert(pos, ch)
        self.seq += 1
        change = StoredChange(dependencies=list(self.heads), actor=self.actor,
                              other_actors=[SERVE_ACTOR], seq=self.seq,
                              start_op=start, timestamp=0, message=None, ops=out)
        self.next_op += len(out)
        return change

    def text(self) -> str:
        return "".join(self.chars)


def serve_workload(n_docs: int, cycles: int, ops: int, ballast: int, tag: int = 0,
                   burst: Optional[Dict[Tuple[int, int], int]] = None):
    """``n_docs`` serve-shaped documents over ``cycles`` cycles: (the base
    chunk, shared by every document, ``deltas[i][c]`` document i's change
    chunk of cycle c, each editor's model of ``live`` at the end).
    ``burst`` maps (document, cycle) to a number of characters typed then
    instead of ``ops``."""
    base = build_change(serve_base_change(ballast))
    burst = burst or {}
    deltas, texts = [], []
    for i in range(n_docs):
        ed = ServeEditor(base, i, tag)
        chunks = []
        for c in range(cycles):
            ch = build_change(ed.cycle(c, ops, burst.get((i, c))))
            ed.heads = [ch.hash]
            chunks.append(ch.raw_bytes)
        deltas.append(chunks)
        texts.append(ed.text())
    return base.raw_bytes, deltas, texts
