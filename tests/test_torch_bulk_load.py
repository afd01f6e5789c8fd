"""The port's bulk catch-up (``core/bulk_load.py`` through
``core/document.py``) against the JAX package's, on the CPU, where the
merge kernels run as their plain PyTorch versions.

A replica applies a large fan-in in one ``apply_changes``: at least 8,000
ops over 16 or more actors inserting concurrently. Its stale text reads
(answered by one merge of the history, no op store built) and the op
store it rebuilds on the first edit (document order from the merge) must
equal the reference's under both of the reference's engines: its default
(the native sequential integrate below its device gate of 20,000 ops and
16 actors, the device merge above it) and ``AUTOMERGE_TPU_BULK=device``.
The store is compared op for op through ``dump()`` (every op's id, key,
value, pred and succ in document order), ``hydrate`` and the reads.

And the failures: a kernel failure inside the bulk path propagates from
the read and from the next edit, and the store stays stale; only the
rebuild's own validation (``MalformedHistory``) sends a history to the
per-op replay.
"""

import io

import numpy as np
import pytest

import automerge_tpu.api as RA
import automerge_tpu.types as RT
from automerge_tpu import native as rnative
from automerge_tpu.core import bulk_load as RB
from automerge_tpu.core.document import Document as RDocument
from automerge_tpu.storage.change import parse_change as rparse

import automerge_tpu_torch.api as PA
import automerge_tpu_torch.types as PT
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.core import bulk_load as PB
from automerge_tpu_torch.core.document import Document as PDocument
from automerge_tpu_torch.ops import merge as M
from automerge_tpu_torch.ops.oplog import OpLog
from automerge_tpu_torch.storage.change import parse_change as pparse

from .test_torch_histories import _history

CATCH_UP = 0x77  # the catching-up replica's actor byte


def fanin(base_edits: int, replicas: int, per: int):
    """(change bytes, text object id) of a text fan-in: a base and
    ``replicas`` actors inserting concurrently into it."""
    trace = W.load_trace(base_edits + replicas * per)
    base = W.build_base(trace, base_edits)
    chs = base.changes + W.synth_fanin(base, trace, replicas, per, base_edits)
    return [c.raw_bytes for c in chs], base.text_exid


# (base edits, replicas, edits a replica): under the reference's device
# gate (its native integrate is the default engine), and over it
SIZES = {"under the gate": (2000, 16, 400), "over the gate": (6000, 24, 700)}


def dump(doc) -> str:
    out = io.StringIO()
    doc.dump(out)
    return out.getvalue()


def catch_up(blobs, engine, monkeypatch):
    """(reference doc, port doc) after one apply of ``blobs`` each, the
    reference under ``engine`` (None: its default)."""
    monkeypatch.setenv("AUTOMERGE_TPU_DEBUG", "1")  # no silent fallback
    if engine is None:
        monkeypatch.delenv("AUTOMERGE_TPU_BULK", raising=False)
    else:
        monkeypatch.setenv("AUTOMERGE_TPU_BULK", engine)
    ref = RA.AutoDoc(RT.ActorId(bytes([CATCH_UP]) * 16))
    port = PA.AutoDoc(PT.ActorId(bytes([CATCH_UP]) * 16), device="cpu")
    ref.apply_changes([rparse(b)[0] for b in blobs])
    port.apply_changes([pparse(b)[0] for b in blobs])
    assert ref.doc._ops_stale and port.doc._ops_stale
    return ref, port


@pytest.fixture(scope="module")
def fanins():
    return {name: fanin(*size) for name, size in SIZES.items()}


@pytest.mark.parametrize("engine", [None, "device"], ids=["default", "device"])
@pytest.mark.parametrize("size", list(SIZES))
def test_bulk_catch_up_equals_the_reference(fanins, size, engine, monkeypatch):
    blobs, text = fanins[size]
    ops = sum(len(pparse(b)[0].ops) for b in blobs)
    actors = {pparse(b)[0].actor for b in blobs}
    assert ops >= 8000 and len(actors) >= 16
    if size == "under the gate":
        assert ops < RB.DEVICE_MIN_OPS  # the reference's native integrate
    ref, port = catch_up(blobs, engine, monkeypatch)
    # the stale read: one merge, no store built
    assert port.text(text) == ref.text(text)
    assert port.doc._ops_stale and ref.doc._ops_stale
    # the rebuild, on the first local edit
    for d in (ref, port):
        d.splice_text(text, 5, 2, "<edit>")
        d.commit(timestamp=3)
    assert not port.doc._ops_stale
    assert dump(port.doc) == dump(ref.doc)
    assert port.hydrate() == ref.hydrate()
    assert port.get_heads() == ref.get_heads()
    assert port.get_cursor(text, 100) == ref.get_cursor(text, 100)
    assert port.save() == ref.save()


def test_seq_export_equals_both_reference_engines(fanins, monkeypatch):
    """(obj_keys, obj_off, elem_rows) of the port's export equal the
    reference's device export and its native sequential integrate."""
    monkeypatch.setenv("AUTOMERGE_TPU_DEBUG", "1")
    for blobs, _ in fanins.values():
        pst = [pparse(b)[0] for b in blobs]
        rst = [rparse(b)[0] for b in blobs]
        doc = PDocument(PT.ActorId(bytes([CATCH_UP]) * 16), device="cpu")
        doc.apply_changes(pst)
        assert [a.stored.hash for a in doc.history] == [c.hash for c in pst]
        got = PB._seq_export(doc, PB.flatten_changes(pst))
        rflat = RB.flatten_changes(rst)
        device = RB._export_via_device(rst, rflat)
        host = rnative.seq_apply_export(
            rflat["op_id"], rflat["obj"], rflat["elem"], rflat["prop"],
            rflat["action"], rflat["insert"], rflat["is_counter"],
            rflat["pred_off"], rflat["pred_flat"])
        for want in (device, host):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_history_catch_up_equals_the_reference(seed, monkeypatch):
    """A seeded history (maps, lists, text, marks, counters, deletes,
    conflicts) caught up in bulk: every text read stale, then the store
    rebuilt, equal to the reference under both its engines."""
    base, blobs = _history(seed)
    monkeypatch.setattr(RDocument, "BULK_MIN_OPS", 1)
    monkeypatch.setattr(PDocument, "BULK_MIN_OPS", 1)
    for engine in ("native", "device"):
        ref, port = catch_up(blobs, engine, monkeypatch)
        log = OpLog.from_changes([pparse(b)[0] for b in blobs])
        texts = [log.export_id(int(k)) for k in log.id_key[log.action == 4]]
        assert [port.text(t) for t in texts] == [ref.text(t) for t in texts]
        assert port.doc._ops_stale
        assert dump(port.doc) == dump(ref.doc)
        assert port.hydrate() == ref.hydrate()
        for t in texts:
            assert [(m.start, m.end, m.name) for m in port.marks(t)] == \
                [(m.start, m.end, m.name) for m in ref.marks(t)]


def test_flatten_equals_its_oracle_and_the_reference():
    base, blobs = _history(3)
    pst = [pparse(b)[0] for b in blobs]
    fast, slow = PB._flatten_fast(pst), PB._flatten_slow(pst)
    ref = RB._flatten_fast([rparse(b)[0] for b in blobs])
    for k in ("op_id", "obj", "elem", "prop", "action", "insert", "is_counter",
              "pred_off", "pred_flat"):
        np.testing.assert_array_equal(np.asarray(fast[k]), np.asarray(slow[k]), k)
        np.testing.assert_array_equal(np.asarray(fast[k]), np.asarray(ref[k]), k)
    assert fast["rank_of"] == slow["rank_of"] == ref["rank_of"]


def test_the_export_has_no_host_engine(monkeypatch):
    """Document order comes from the merge at every size: a two-op
    history's rebuild runs one merge, and there is no size gate or
    engine knob to route it elsewhere."""
    assert not hasattr(PB, "DEVICE_MIN_OPS") and not hasattr(PB, "DEVICE_MIN_ACTORS")
    calls = []
    real = M.merge_columns
    monkeypatch.setattr(M, "merge_columns",
                        lambda *a, **k: calls.append(k.get("device")) or real(*a, **k))
    monkeypatch.setattr(PDocument, "BULK_MIN_OPS", 1)
    monkeypatch.setenv("AUTOMERGE_TPU_BULK", "native")  # the reference's knob
    src = PA.AutoDoc(PT.ActorId(bytes([1]) * 16), device="cpu")
    t = src.put_object("_root", "t", PT.ObjType.TEXT)
    src.splice_text(t, 0, 0, "hi")
    src.commit()
    doc = PA.AutoDoc(PT.ActorId(bytes([2]) * 16), device="cpu")
    doc.apply_changes(src.get_changes([]))
    assert doc.doc._ops_stale and calls == []
    doc.put("_root", "k", 1)  # the rebuild
    assert [str(c) for c in calls] == ["cpu"]
    assert doc.text(t) == "hi"


class KernelFault(RuntimeError):
    pass


def _broken(*args, **kwargs):
    raise KernelFault("injected launch failure")


def test_kernel_failure_propagates_and_the_store_stays_stale(fanins, monkeypatch):
    blobs, text = fanins["under the gate"]
    doc = PA.AutoDoc(PT.ActorId(bytes([CATCH_UP]) * 16), device="cpu")
    doc.apply_changes([pparse(b)[0] for b in blobs])
    slow = []
    monkeypatch.setattr(PDocument, "_rebuild_slow", lambda self: slow.append(1))
    monkeypatch.setattr(M, "merge_columns", _broken)
    with pytest.raises(KernelFault):
        doc.text(text)  # the stale read
    with pytest.raises(KernelFault):
        doc.splice_text(text, 0, 0, "x")  # the rebuild
    for read in (lambda: doc.text(text), lambda: doc.hydrate(),
                 lambda: doc.keys(), lambda: doc.length(text)):
        with pytest.raises(KernelFault):
            read()
        assert doc.doc._ops_stale
    assert slow == []  # a launch failure never reaches the per-op replay
    monkeypatch.undo()
    ref = RA.AutoDoc(RT.ActorId(bytes([CATCH_UP]) * 16))
    ref.apply_changes([rparse(b)[0] for b in blobs])
    assert doc.text(text) == ref.text(text)


def test_kernel_failure_in_the_patch_drain_propagates(fanins, monkeypatch):
    """A catch-up that touches only the text object, with an observer
    attached: its patches are drained through the rebuild, so a kernel
    failure there raises from ``apply_changes`` and ``make_patches``, the
    patch log's cursor stays where it was, and once the merge works the
    drain gives the reference's patches."""
    from .test_torch_document import norm

    blobs, text = fanins["under the gate"]
    doc = PA.AutoDoc(PT.ActorId(bytes([CATCH_UP]) * 16), device="cpu")
    ref = RA.AutoDoc(RT.ActorId(bytes([CATCH_UP]) * 16))
    seen, ref_seen = [], []
    monkeypatch.setattr(PDocument, "BULK_MIN_OPS", 1)  # the replicas' 6,400 ops
    for d, parse, out in ((doc, pparse, seen), (ref, rparse, ref_seen)):
        d.apply_changes([parse(blobs[0])[0]])  # the base: it makes the text
        d.set_patch_callback(out.append)
    log = doc.patch_log
    cursor = (log._cursor, log._cursor_len)
    replicas = [pparse(b)[0] for b in blobs[1:]]  # they touch the text only
    monkeypatch.setattr(M, "merge_columns", _broken)
    with pytest.raises(KernelFault):
        doc.apply_changes(replicas)
    assert doc.doc._ops_stale and seen == []
    with pytest.raises(KernelFault):
        doc.make_patches()
    assert (log._cursor, log._cursor_len) == cursor
    monkeypatch.undo()
    ref.apply_changes([rparse(b)[0] for b in blobs[1:]])
    assert ref_seen and norm(doc.make_patches()) == norm(ref_seen[-1])
    assert doc.text(text) == ref.text(text)


def test_failure_of_the_save_order_propagates(monkeypatch):
    doc = PA.AutoDoc(PT.ActorId(bytes([1]) * 16), device="cpu")
    t = doc.put_object("_root", "t", PT.ObjType.TEXT)
    doc.splice_text(t, 0, 0, "abc")
    monkeypatch.setattr(M, "merge_columns", _broken)
    with pytest.raises(KernelFault):
        doc.save()


def test_malformed_bulk_change_replays_per_op_and_fails_on_every_read(monkeypatch):
    """A seq key on a map object entering by the bulk path: the rebuild's
    validation refuses it by name (MalformedHistory), the per-op replay
    raises the store's own error, and every read raises."""
    from automerge_tpu_torch.storage.change import (
        ChangeOp, Key, ROOT_STORED, StoredChange, build_change,
    )

    bad = build_change(StoredChange(
        dependencies=[], actor=bytes([5]) * 16, other_actors=[], seq=1,
        start_op=1, timestamp=0, message=None,
        ops=[ChangeOp(obj=ROOT_STORED, key=Key.seq((999, 0)), insert=True,
                      action=1, value=PT.ScalarValue("str", "x"), pred=[])]))
    monkeypatch.setattr(PDocument, "BULK_MIN_OPS", 1)
    refused, replays = [], []
    real_rebuild, real_slow = PB._rebuild_op_store, PDocument._rebuild_slow

    def rebuild(doc):
        try:
            real_rebuild(doc)
        except PB.MalformedHistory as e:
            refused.append(str(e))
            raise

    monkeypatch.setattr(PB, "_rebuild_op_store", rebuild)
    monkeypatch.setattr(PDocument, "_rebuild_slow",
                        lambda self: replays.append(1) or real_slow(self))
    d = PA.AutoDoc(PT.ActorId(bytes([3]) * 16), device="cpu")
    d.apply_changes([bad])
    for _ in range(2):
        with pytest.raises(Exception):
            d.keys()
        assert d.doc._ops_stale
    assert refused and len(replays) == 2


def _counting(monkeypatch):
    calls = []
    real = M.merge_columns
    monkeypatch.setattr(M, "merge_columns",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("edit", [False, True], ids=["read_save", "read_edit_save"])
def test_memo_one_merge_a_history_length(fanins, edit, monkeypatch):
    """A catch-up's stale read, rebuild and save at one history length
    share one merge (``Document._history_merge``): read -> save merges
    once; read -> edit -> save merges once for the read and the rebuild,
    once more for the save at the edited length. The results equal the
    reference's."""
    blobs, text = fanins["under the gate"]
    ref, port = catch_up(blobs, None, monkeypatch)
    calls = _counting(monkeypatch)
    assert port.text(text) == ref.text(text) and calls == [1]
    assert port.text(text) == ref.text(text) and calls == [1]  # the memo
    if edit:
        for d in (ref, port):
            d.splice_text(text, 5, 2, "<edit>")
            d.commit(timestamp=3)
        assert not port.doc._ops_stale and calls == [1]  # the rebuild: none
        assert dump(port.doc) == dump(ref.doc)
    else:
        assert port.doc._ops_stale
    assert port.save() == ref.save()
    assert len(calls) == (2 if edit else 1)
    assert port.save() == ref.save() and len(calls) == (2 if edit else 1)


def test_memo_dropped_by_a_new_change_a_load_and_a_fork(fanins, monkeypatch):
    blobs, text = fanins["under the gate"]
    ref, port = catch_up(blobs[:-1], None, monkeypatch)
    calls = _counting(monkeypatch)
    port.text(text)
    memo = port.doc._merge_memo
    assert calls == [1] and memo["n"] == len(port.doc.history)
    # a new change: the history grows, the next read merges again
    for d, parse in ((ref, rparse), (port, pparse)):
        d.apply_changes([parse(blobs[-1])[0]])
    assert port.text(text) == ref.text(text) and len(calls) == 2
    assert port.doc._merge_memo is not memo
    # a fork and a load are new documents: their memo starts empty
    fork = port.fork(PT.ActorId(bytes([9]) * 16))
    assert fork.doc._merge_memo is None and fork.doc._ops_stale
    assert fork.text(text) == ref.text(text) and len(calls) == 3
    loaded = PA.AutoDoc.load(port.save(), device="cpu")
    assert loaded.doc._merge_memo is not port.doc._merge_memo
    assert loaded.text(text) == ref.text(text)
    # a failed merge memoises nothing
    n = len(calls)
    monkeypatch.setattr(M, "merge_columns", _broken)
    other = port.fork(PT.ActorId(bytes([10]) * 16))
    with pytest.raises(KernelFault):
        other.text(text)
    assert other.doc._merge_memo is None
    monkeypatch.undo()
    assert other.text(text) == ref.text(text) and len(calls) == n
