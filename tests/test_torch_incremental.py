"""The port's serving path against the JAX package's, batch by batch.

A resident ``DeviceDoc`` of each package takes the same change bytes in the
same batches (``apply_changes``, ``apply_batches``, and the port's
pipelined apply, which the card runs, here on the plain kernels). After
every batch the two must agree exactly (everything compared is integer or
a read): the ``READ_FETCH`` arrays, ``succ_count``/``inc_count``/
``counter_val``, the reads and ``pending_changes``. The batches are
chosen so that, between the record store and the text fan-in, every
branch of the apply runs: the tail delta on the host, the subset and the
full re-resolve, the rebuild, changes that wait for their dependencies,
re-delivered duplicates and a new actor that ranks below the resident
ones.
"""

import functools

import numpy as np
import pytest

from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.ops import device_doc as D
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.storage.change import ChangeOp, StoredChange, build_change
from automerge_tpu_torch.types import Key, ScalarValue

from .test_torch_extract import SpliceOracle

MODES = ("apply_changes", "apply_batches", "pipelined")


def _change(actor, seq, start_op, deps, ops, others):
    return build_change(StoredChange(
        dependencies=deps, actor=actor, other_actors=others, seq=seq,
        start_op=start_op, timestamp=0, message=None, ops=ops))


def _put(obj, prop, value, pred):
    return ChangeOp(obj=obj, key=Key.map(prop), insert=False, action=1,
                    value=value, pred=pred)


@functools.lru_cache(maxsize=None)
def _records():
    """Record store R=256, 16 replicas x 20 ops, plus a follow-up of
    replica 9 (seq 2, depending on it) and a change of an actor that ranks
    below every resident one. Steps: (blobs, apply_changes kwargs,
    branches it must take, branches the card's pipeline must take: it
    has no host delta path, as in the JAX package's)."""
    base, reps, _ = W.record_store(256, 16, 20)
    B = W.BASE_ACTOR
    r9 = reps[9]
    follow9 = _change(r9.actor, 2, r9.max_op + 1, [r9.hash], [
        # record 7's title (base op 2 + 9*7 + 1) and a field of its own
        _put((65, 1), "title", ScalarValue("str", "later"), [(66, 1)]),
        _put((65, 1), "extra", ScalarValue("int", 7), []),
    ], [B])
    low = bytes(16)  # ranks below BASE_ACTOR: every packed id is remapped
    low_change = _change(low, 1, base.max_op + 1, [base.hash], [
        _put((29, 1), "owner", ScalarValue("str", "low"), [(31, 1)]),
        ChangeOp(obj=(1, 1), key=Key.map("r000003"), insert=False, action=3,
                 value=ScalarValue("null"), pred=[(29, 1)]),
    ], [B])
    blobs = lambda chs: [c.raw_bytes for c in chs]  # noqa: E731
    steps = [
        (blobs(reps[0:4]), {}, {"delta"}, {"subset"}),
        (blobs(reps[4:8] + [follow9]), {}, {"subset"}, {"subset"}),
        (blobs(reps[8:12]), {}, {"subset"}, {"subset"}),
        (blobs(reps[0:2] + [low_change]), {}, {"subset"}, {"subset"}),
        (blobs(reps[12:16]), {"incremental": False}, {"rebuild"}, {"rebuild"}),
        (blobs(reps[12:16]), {}, set(), set()),
    ]
    return [base.raw_bytes], steps


@functools.lru_cache(maxsize=None)
def _text():
    """Text fan-in (2000-edit base, 16 x 60); the first batch is a tail
    append, every later one dirties the one text object (full
    re-resolve). It starts from an empty document: the first apply is a
    rebuild."""
    trace = W.load_trace(3000)
    base = W.build_base(trace, 2000)
    reps = [c.raw_bytes for c in W.synth_fanin(base, trace, 16, 60, 2000)]
    steps = [
        ([base.changes[0].raw_bytes], {}, {"rebuild"}, {"rebuild"}),
        (reps[0:5], {}, {"delta"}, {"full"}),
        (reps[5:10], {}, {"full"}, {"full"}),
        (reps[10:16] + reps[3:5], {}, {"full"}, {"full"}),
    ]
    return [], steps


SCENARIOS = {"records": _records, "text": _text}


def _j_parse(blobs):
    return [j_parse_change(b)[0] for b in blobs]


def _reads(doc, scenario):
    """Every read the scenario's objects answer (the same calls on both
    packages' documents)."""
    out = {"pending": doc.pending_changes(), "keys": doc.keys(),
           "root": doc.map_entries()}
    if scenario == "records":
        entries = doc.map_entries(W.RECORDS_OBJ)
        out["records"] = entries
        out["record_keys"] = doc.keys(W.RECORDS_OBJ)
        for _, (_, _, rec), _ in entries:
            out[rec] = (doc.map_entries(rec), doc.get(rec, "votes"),
                        doc.get_all(rec, "title"))
    for name, value, _ in out["root"]:
        if scenario == "text" and value[0] == "obj":
            obj = value[2]
            out[name] = (doc.text(obj), doc.length(obj),
                         doc.get(obj, 0), doc.get_all(obj, 3))
    return out


def _assert_same(doc, jdoc, scenario, where):
    n = doc.log.n
    assert (n, doc.log.n_objs) == (jdoc.log.n, jdoc.log.n_objs), where
    np.testing.assert_array_equal(doc.log.id_key, jdoc.log.id_key[:n])
    for k in DeviceDoc.READ_FETCH:
        a, b = np.asarray(doc.res[k]), np.asarray(jdoc.res[k])
        cut = doc.log.n_objs + 2 if k.startswith("obj_") else n
        np.testing.assert_array_equal(a[:cut], b[:cut], err_msg=f"{where} {k}")
    for k in ("succ_count", "inc_count", "counter_val"):
        np.testing.assert_array_equal(
            getattr(doc, k)[:n], getattr(jdoc, k)[:n], err_msg=f"{where} {k}")
    assert _reads(doc, scenario) == _reads(jdoc, scenario), where


@pytest.fixture
def branches(monkeypatch):
    """The apply branches the port's document takes, by name."""
    taken = []
    in_reresolve = []
    delta, rebuild, reresolve = (DeviceDoc._delta_resolve, DeviceDoc._rebuild,
                                 DeviceDoc._reresolve)
    resolve_log, merge_columns = D._resolve_log, D.merge_columns

    def spy_delta(self, info):
        ok = delta(self, info)
        if ok:
            taken.append("delta")
        return ok

    def spy_rebuild(self, changes):
        taken.append("rebuild")
        return rebuild(self, changes)

    def spy_reresolve(self, dirty):
        in_reresolve.append(True)
        try:
            return reresolve(self, dirty)
        finally:
            in_reresolve.pop()

    def spy_full(*a, **k):
        if in_reresolve:
            taken.append("full")
        in_reresolve.append(False)  # its merge_columns call is not a subset
        try:
            return resolve_log(*a, **k)
        finally:
            in_reresolve.pop()

    def spy_subset(*a, **k):
        if in_reresolve and in_reresolve[-1]:
            taken.append("subset")
        return merge_columns(*a, **k)

    def spy_dispatch(self, dirty, phases=None):
        handle = dispatch(self, dirty, phases)
        if handle is not None:
            taken.append("full" if handle.get("fallback") else "subset")
        return handle

    dispatch = DeviceDoc._dispatch_async
    monkeypatch.setattr(DeviceDoc, "_delta_resolve", spy_delta)
    monkeypatch.setattr(DeviceDoc, "_rebuild", spy_rebuild)
    monkeypatch.setattr(DeviceDoc, "_reresolve", spy_reresolve)
    monkeypatch.setattr(DeviceDoc, "_dispatch_async", spy_dispatch)
    monkeypatch.setattr(D, "_resolve_log", spy_full)
    monkeypatch.setattr(D, "merge_columns", spy_subset)
    return taken


def _apply(doc, blobs, kw, mode):
    if mode == "apply_changes":
        return doc.apply_changes(blobs, **kw)
    if kw.get("incremental") is False:
        return doc.apply_changes(blobs, **kw)  # only apply_changes rebuilds on request
    if mode == "apply_batches":
        return doc.apply_batches([blobs])
    return doc._apply_pipelined([blobs])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_served_document_equals_jax_after_every_batch(scenario, mode, branches):
    start, steps = SCENARIOS[scenario]()
    doc = DeviceDoc.merge(start, device="cpu")
    jdoc = JDeviceDoc.resolve(JOpLog.from_changes(_j_parse(start)))
    for i, (blobs, kw, want, want_pipelined) in enumerate(steps):
        del branches[:]
        got = _apply(doc, blobs, kw, mode)
        jgot = jdoc.apply_changes(_j_parse(blobs), **kw)
        assert got == jgot, i
        assert set(branches) == (want_pipelined if mode == "pipelined" else want), (
            i, branches)
        _assert_same(doc, jdoc, scenario, f"step {i}")
    if scenario == "records":  # the low actor was ranked in, remapping ids
        assert doc.log.actors[0].bytes == bytes(16)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_served_splice_equals_the_oracle_splice_and_a_rebuild(scenario, mode,
                                                             monkeypatch):
    """After every step the served log, spliced through the native delta
    (``_extract_delta``), equals the per-op oracle's splice of the same
    changes and a fresh ``OpLog.from_changes`` of them (every column,
    ``props``, ``mark_names`` and value)."""
    start, steps = SCENARIOS[scenario]()
    doc = DeviceDoc.merge(start, device="cpu")
    oracle = SpliceOracle(monkeypatch, doc)
    for i, (blobs, kw, _, _) in enumerate(steps):
        _apply(doc, blobs, kw, mode)
        oracle.check(doc, f"step {i}")
    assert oracle.deltas > 0


def test_changes_wait_for_their_dependencies():
    _, steps = _records()
    blobs = steps[1][0]  # replicas 4..7 and the follow-up of replica 9
    start, _ = _records()
    doc = DeviceDoc.merge(start, device="cpu")
    assert doc.apply_changes(blobs) == 4
    assert doc.pending_changes() == 1
    assert doc.apply_changes(steps[2][0]) == 5  # replica 9 releases it
    assert doc.pending_changes() == 0
    assert doc.apply_changes(steps[2][0]) == 0  # re-delivered: no-ops


def test_pipelined_batches_equal_one_shot_merge():
    """The card's pipeline (several batches, one resolution in flight
    while the next splices) ends where the one-shot fan-in merge of the
    same changes is, on every READ_FETCH array."""
    base, reps, want = W.record_store(256, 32, 20)
    served = DeviceDoc.merge([base.raw_bytes], device="cpu")
    batches = W.record_batches([r.raw_bytes for r in reps], 4)
    phases = {}
    served._apply_pipelined(batches, phases)
    assert len(phases.pop("batches")) == len(batches)
    assert set(phases) == {"parse", "order", "splice", "materialize", "subset",
                           "launch", "readback", "scatter"}
    merged = DeviceDoc.merge([base.raw_bytes] + [r.raw_bytes for r in reps],
                             device="cpu")
    n = merged.log.n
    for k in DeviceDoc.READ_FETCH:
        cut = merged.log.n_objs + 2 if k.startswith("obj_") else n
        np.testing.assert_array_equal(np.asarray(served.res[k])[:cut],
                                      np.asarray(merged.res[k])[:cut], err_msg=k)
    assert W.record_counts(served) == W.record_counts(merged) == want


def test_document_keeps_its_device():
    start, _ = _records()
    doc = DeviceDoc.merge(start, device="cpu")
    assert doc.device.type == "cpu"
    doc.apply_changes(_records()[1][0][0])
    assert doc.device.type == "cpu"
