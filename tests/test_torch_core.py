"""The port's document core against the JAX package's, unit by unit, on
the CPU: ``core/clock.py``, ``core/change_graph.py``, ``core/op_store.py``
(a seeded random op sequence inserted and removed in both stores),
``utils/indexed_cache.py``, the array-native change encoders and the
chunk-local actor table of ``storage/change.py``, the document chunk of
``storage/document.py`` (the per-op and the array encoders, the native
decode and its validation) and ``DeviceDoc.merge`` of documents. Exact
equality throughout.
"""

import numpy as np
import pytest

import automerge_tpu.api as RA
import automerge_tpu.types as RT
from automerge_tpu.core import change_graph as RG
from automerge_tpu.core import clock as RC
from automerge_tpu.core import op_store as RS
from automerge_tpu.ops import extract as RX
from automerge_tpu.storage import change as RCH
from automerge_tpu.storage import document as RD
from automerge_tpu.utils.indexed_cache import IndexedCache as RCache

import automerge_tpu_torch.api as PA
import automerge_tpu_torch.types as PT
from automerge_tpu_torch import errors as PE
from automerge_tpu_torch.core import change_graph as PG
from automerge_tpu_torch.core import clock as PC
from automerge_tpu_torch.core import op_store as PS
from automerge_tpu_torch.ops import extract as PX
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.storage import change as PCH
from automerge_tpu_torch.storage import document as PD
from automerge_tpu_torch.utils.indexed_cache import IndexedCache as PCache

from .test_torch_document import Session, norm
from .test_torch_histories import _history


def test_clock_equals_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        clocks = []
        seed = int(rng.integers(1 << 30))
        for C, D in ((RC.Clock, RC.ClockData), (PC.Clock, PC.ClockData)):
            a, b = C(), C()
            r = np.random.default_rng(seed)
            for _ in range(int(r.integers(0, 8))):
                a.include(int(r.integers(0, 5)), D(int(r.integers(0, 50)), int(r.integers(1, 9))))
                b.include(int(r.integers(0, 5)), D(int(r.integers(0, 50)), int(r.integers(1, 9))))
            ids = [(int(r.integers(0, 60)), int(r.integers(0, 6))) for _ in range(20)]
            out = [a.compare(b), b.compare(a), [a.covers(i) for i in ids],
                   a.as_dense(6), [a.seq_of(k) for k in range(6)],
                   [a.max_op_of(k) for k in range(6)], a == b]
            m = a.copy()
            m.merge(b)
            m.isolate(2)
            out += [m.as_dense(6), [m.covers(i) for i in ids]]
            clocks.append(out)
        assert clocks[0] == clocks[1]


def _graph(G, rng_seed: int):
    rng = np.random.default_rng(rng_seed)
    g = G.ChangeGraph()
    hashes = []
    for i in range(60):
        h = bytes([i]) * 32
        deps = sorted({hashes[int(j)] for j in rng.integers(0, len(hashes), 2)}) \
            if hashes else []
        g.add_change(h, int(rng.integers(0, 4)), i + 1, 3 * i + 3, deps)
        hashes.append(h)
    return g, hashes


@pytest.mark.parametrize("seed", range(3))
def test_change_graph_equals_the_reference(seed):
    (rg, hs), (pg, _) = _graph(RG, seed), _graph(PG, seed)
    rng = np.random.default_rng(seed + 10)
    for _ in range(20):
        heads = [hs[int(i)] for i in rng.integers(0, len(hs), 3)]
        assert rg.clock_for_heads(heads).as_dense(4) == pg.clock_for_heads(heads).as_dense(4)
        assert rg.ancestor_hashes(heads) == pg.ancestor_hashes(heads)
        rs, ps = set(hs[:40]), set(hs[:40])
        rg.remove_ancestors(rs, heads)
        pg.remove_ancestors(ps, heads)
        assert rs == ps
    assert len(rg) == len(pg)
    for G in (RG, PG):
        with pytest.raises(G.ChangeGraphError):
            G.ChangeGraph().add_change(b"x" * 32, 0, 1, 1, [b"y" * 32])
    assert issubclass(PG.ChangeGraphError, PE.AutomergeError)


def test_indexed_cache_equals_the_reference():
    r, p = RCache(), PCache()
    words = ["d", "a", "c", "a", "b", "e", "d"]
    assert [r.cache(w) for w in words] == [p.cache(w) for w in words]
    for c in (r, p):
        c.remove_last()
    assert (r.ranks(), r.sorted_order(), list(r), len(r)) == \
        (p.ranks(), p.sorted_order(), list(p), len(p))
    assert [r.lookup(w) for w in "abcxz"] == [p.lookup(w) for w in "abcxz"]


def _store_ops(S, T, seed: int):
    """A store built by a seeded op sequence (inserts with RGA siblings,
    map puts and deletes, counters and increments), half its last ops
    removed again: its reads, as plain data."""
    rng = np.random.default_rng(seed)
    actors = RCache() if S is RS else PCache()
    for a in range(4):
        actors.cache(T.ActorId(bytes([a + 1]) * 16))
    store = S.OpStore(actors)
    make = S.Op(id=(1, 0), action=int(T.Action.MAKE_TEXT), value=T.ScalarValue("null"),
                key=0, pred=[])
    store.insert_op((0, 0), make)
    text = (1, 0)
    applied, ctr = [], 2
    elems = [T.HEAD]
    for _ in range(120):
        ctr += 1
        oid = (ctr, int(rng.integers(0, 4)))
        r = rng.random()
        if r < 0.55:
            op = S.Op(id=oid, action=int(T.Action.PUT),
                      value=T.ScalarValue("str", "abcdefé"[int(rng.integers(0, 7))]),
                      elem=elems[int(rng.integers(0, len(elems)))], insert=True, pred=[])
            store.insert_op(text, op)
            elems.append(oid)
            applied.append((text, op))
        elif r < 0.7 and len(elems) > 1:
            el = store.get_obj(text).data.by_id[elems[int(rng.integers(1, len(elems)))]]
            vis = el.visible_ops(None)
            op = S.Op(id=oid, action=int(T.Action.DELETE), value=T.ScalarValue("null"),
                      elem=el.elem_id, pred=store.sort_opids([o.id for o in vis]))
            store.insert_op(text, op)
            applied.append((text, op))
        else:
            key = int(rng.integers(1, 4))
            vis = store.visible_map_ops((0, 0), key, None)
            op = S.Op(id=oid, action=int(T.Action.PUT),
                      value=T.ScalarValue("counter" if key == 3 else "int", int(rng.integers(0, 9))),
                      key=key, pred=store.sort_opids([o.id for o in vis]))
            if key == 3 and vis and vis[-1].is_counter:
                op = S.Op(id=oid, action=int(T.Action.INCREMENT),
                          value=T.ScalarValue("int", 2), key=key, pred=[vis[-1].id])
            store.insert_op((0, 0), op)
            applied.append(((0, 0), op))
    reads = []
    for undo in range(2):
        data = store.get_obj(text).data
        reads.append((
            store.text(text), store.seq_length(text, S.TEXT_ENC),
            [(e.elem_id, [o.id for o in e.run()], [o.id for o in e.visible_ops(None)])
             for e in data.elements()],
            [store.nth(text, i, S.LIST_ENC).elem_id
             for i in range(store.seq_length(text))],
            store.map_keys((0, 0)),
            [[(o.id, o.succ, o.visible(), o.counter_value_at(None))
              for o in store.map_ops((0, 0), k)] for k in range(1, 4)],
        ))
        for obj, op in reversed(applied[len(applied) // 2:]):
            store.remove_op(obj, op)
    return norm(reads)


@pytest.mark.parametrize("seed", range(4))
def test_op_store_equals_the_reference(seed):
    assert _store_ops(RS, RT, seed) == _store_ops(PS, PT, seed)


def _session_changes(seed):
    s = Session(seed, 40)
    s.run()
    return s.docs.ref.get_changes([]), s.docs


@pytest.mark.parametrize("seed", range(3))
def test_array_change_encoders_equal_the_per_op_encoder(seed):
    """``encode_change_cols_arrays`` (from the ops' columns) and
    ``chunk_local_ops`` equal the per-op encoder and the reference's."""
    changes, _ = _session_changes(seed)
    for ch in changes:
        pch = PCH.parse_change(ch.raw_bytes)[0]
        ops = list(pch.ops)
        want = dict(PCH.encode_change_ops(ops))
        assert want == dict(RCH.encode_change_ops(list(ch.ops)))
        a = _change_arrays(ops)
        got = dict(PCH.encode_change_cols_arrays(a))
        assert {k: v for k, v in got.items() if v} == {k: v for k, v in want.items() if v}
        assert got == dict(RCH.encode_change_cols_arrays(a))
        for i, op in enumerate(ops):
            PCH._check_actor_bounds(op, i, len(pch.actors))
        with pytest.raises(ValueError, match="missing actor"):
            PCH._check_actor_bounds(PCH.ChangeOp(
                obj=(1, len(pch.actors)), key=PCH.Key.map("k"), insert=False,
                action=1, value=PT.ScalarValue("int", 1), pred=[]), 0, len(pch.actors))


def _change_arrays(ops):
    """The columns ``encode_change_cols_arrays`` takes, from ChangeOps."""
    keys, marks = [], []
    a = {k: [] for k in ("obj_ctr", "obj_actor", "obj_mask", "key_str_ids", "key_ctr",
                         "key_ctr_mask", "key_actor", "key_actor_mask", "insert",
                         "action", "val_meta", "pred_num", "pred_ctr", "pred_actor",
                         "expand", "mark_ids")}
    raw = bytearray()
    from automerge_tpu_torch.storage.values import encode_raw_value, value_meta

    for op in ops:
        root = op.obj == PCH.ROOT_STORED
        a["obj_mask"].append(0 if root else 1)
        a["obj_ctr"].append(0 if root else op.obj[0])
        a["obj_actor"].append(0 if root else op.obj[1])
        if op.key.prop is not None:
            if op.key.prop not in keys:
                keys.append(op.key.prop)
            a["key_str_ids"].append(keys.index(op.key.prop))
            a["key_ctr"].append(0), a["key_ctr_mask"].append(0)
            a["key_actor"].append(0), a["key_actor_mask"].append(0)
        else:
            e = op.key.elem
            head = e == PCH.HEAD_STORED
            a["key_str_ids"].append(-1)
            a["key_ctr"].append(0 if head else e[0]), a["key_ctr_mask"].append(1)
            a["key_actor"].append(0 if head else e[1])
            a["key_actor_mask"].append(0 if head else 1)
        a["insert"].append(int(op.insert))
        a["action"].append(int(op.action))
        a["val_meta"].append(value_meta(op.value))
        encode_raw_value(op.value, raw)
        a["pred_num"].append(len(op.pred))
        a["pred_ctr"] += [p[0] for p in op.pred]
        a["pred_actor"] += [p[1] for p in op.pred]
        a["expand"].append(int(op.expand))
        if op.mark_name is None:
            a["mark_ids"].append(-1)
        else:
            if op.mark_name not in marks:
                marks.append(op.mark_name)
            a["mark_ids"].append(marks.index(op.mark_name))
    out = {k: np.asarray(v, np.uint8 if k in ("obj_mask", "key_ctr_mask",
                                              "key_actor_mask", "insert", "expand")
                         else np.int64) for k, v in a.items()}
    out.update(key_str_table=keys, mark_table=marks, val_raw=bytes(raw))
    return out


def test_tail_encoders_equal_the_per_op_encoder():
    """The session tails' encoders (a text tail after prefix ops, a map
    tail) equal the per-op encoder over the same ops, and the reference's
    encoders."""
    rng = np.random.default_rng(4)
    for _ in range(20):
        n = int(rng.integers(1, 30))
        prefix = [PCH.ChangeOp(obj=PCH.ROOT_STORED, key=PCH.Key.map("p"), insert=False,
                               action=1, value=PT.ScalarValue("int", 7), pred=[(3, 1)])]
        refs = rng.integers(0, 3, n)
        preds = rng.integers(0, 2, n)
        is_del = rng.random(n) < 0.3
        cps = rng.choice([ord("a"), ord("é"), 0x4E2D, 0x1F600], n)
        ops = list(prefix)
        for k in range(n):
            elem = PCH.HEAD_STORED if refs[k] == 0 else (int(refs[k]) + 10, 1)
            if is_del[k]:
                ops.append(PCH.ChangeOp(obj=(2, 0), key=PCH.Key.seq(elem), insert=False,
                                        action=3, value=PT.ScalarValue("null"),
                                        pred=[(int(refs[k]) + 10, 1)] if preds[k] else []))
            else:
                ops.append(PCH.ChangeOp(obj=(2, 0), key=PCH.Key.seq(elem), insert=True,
                                        action=1, value=PT.ScalarValue("str", chr(cps[k])),
                                        pred=[]))
        ins = ~is_del
        u8 = np.array([len(chr(c).encode()) for c in cps], np.int64)
        tail = {
            "obj_ctr": 2, "obj_actor": 0,
            "elem_ctr": np.where(refs == 0, 0, refs + 10).astype(np.int64),
            "elem_actor": np.where(refs == 0, -1, 1).astype(np.int64),
            "insert": ins.astype(np.uint8),
            "action": np.where(is_del, 3, 1).astype(np.int64),
            "val_meta": np.where(is_del, 0, (u8 << 4) | 6).astype(np.int64),
            "val_raw": "".join(chr(c) for c in cps[ins]).encode(),
            "pred_ctr": np.where(is_del & (preds == 1), refs + 10, -1).astype(np.int64),
            "pred_actor": np.ones(n, np.int64),
        }
        want = PCH.encode_change_ops(ops)
        assert PCH.encode_ops_with_tail(prefix, tail) == want
        assert PCH.encode_ops_with_tail(prefix, tail) == RCH.encode_ops_with_tail(
            [RCH.ChangeOp(obj=o.obj, key=RCH.Key.map(o.key.prop), insert=o.insert,
                          action=o.action, value=RT.ScalarValue(o.value.tag, o.value.value),
                          pred=o.pred) for o in prefix], tail)
        keys = ["x", "yé", "z"]
        kidx = rng.integers(0, 3, n)
        vals = rng.integers(0, 100, n)
        mtail = {"obj_ctr": 0, "obj_actor": -1, "key_idx": kidx.astype(np.int64),
                 "keys": keys, "val_meta": np.array([(1 << 4) | 3 if v < 64 else (2 << 4) | 3
                                                      for v in vals], np.int64),
                 "val_raw": b"".join(bytes([v]) if v < 64 else bytes([v | 0x80, 0])
                                     for v in vals.tolist()),
                 "pred_ctr": np.where(vals % 3 == 0, 5, -1).astype(np.int64),
                 "pred_actor": np.zeros(n, np.int64)}
        mops = [PCH.ChangeOp(obj=PCH.ROOT_STORED, key=PCH.Key.map(keys[kidx[k]]),
                             insert=False, action=1,
                             value=PT.ScalarValue("uint", int(vals[k]) if vals[k] < 64
                                                  else int(vals[k]) | 0),
                             pred=[(5, 0)] if vals[k] % 3 == 0 else [])
                for k in range(n)]
        got = PCH.encode_map_tail_cols(mtail)
        assert got == RCH.encode_map_tail_cols(mtail)
        if (vals < 64).all():
            assert got == PCH.encode_change_ops(mops)


def test_chunk_local_ops_equals_the_reference():
    changes, docs = _session_changes(5)
    names = {i: bytes([i + 1]) * 16 for i in range(8)}
    for ch in changes:
        rows = list(PCH.parse_change(ch.raw_bytes)[0].ops)
        got = PCH.chunk_local_ops(rows, 0, lambda g: names[g % 8], extra_refs=[3, 5])
        want = RCH.chunk_local_ops(list(ch.ops), 0, lambda g: names[g % 8],
                                   extra_refs=[3, 5])
        assert norm(got) == norm(want)


@pytest.mark.parametrize("seed", range(3))
def test_document_chunk_equals_the_reference(seed):
    """The save's columns by both encoders, the native decode of them and
    its validation equal the reference's; the per-op document decode
    reads the same ops."""
    changes, docs = _session_changes(seed)
    data = docs.port.save(deflate=False)
    assert data == docs.ref.save(deflate=False)
    pdoc, _ = PD.parse_document(data)
    rdoc, _ = RD.parse_document(data)
    assert norm(pdoc.ops) == norm(rdoc.ops)
    assert PD.encode_doc_ops(pdoc.ops) == RD.encode_doc_ops(rdoc.ops)
    a, ra = PX.doc_op_arrays(pdoc.op_col_data), RX.doc_op_arrays(rdoc.op_col_data)
    assert norm({k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in a.items()}) == \
        norm({k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in ra.items()})
    PX.validate_doc_arrays(a, len(pdoc.actors))
    with pytest.raises(PX.ExtractError):
        PX.validate_doc_arrays(a, 0)
    changes_fast = [c.raw_bytes for c in
                    __import__("automerge_tpu_torch.core.document", fromlist=["x"])
                    .reconstruct_changes_fast(pdoc)]
    changes_slow = [c.raw_bytes for c in
                    __import__("automerge_tpu_torch.core.document", fromlist=["x"])
                    .reconstruct_changes(pdoc)]
    assert changes_fast == changes_slow == [c.raw_bytes for c in changes]


def test_device_doc_merge_of_documents_equals_the_reference():
    """``DeviceDoc.merge`` of AutoDocs and Documents (an open autocommit
    transaction committed first) equals the reference's."""
    from automerge_tpu.ops.device_doc import DeviceDoc as RDeviceDoc
    from automerge_tpu.ops.extract import _CHANGE_COLS_CACHE

    base, blobs = _history(1)
    docs = []
    for pkg, T, kw in ((RA, RT, {}), (PA, PT, {"device": "cpu"})):
        a = pkg.AutoDoc(T.ActorId(bytes([9]) * 16), **kw)
        a.apply_changes([(__import__(f"{pkg.__name__.rsplit('.', 1)[0]}.storage.change",
                                     fromlist=["x"]).parse_change(b)[0]) for b in blobs])
        b = a.fork(T.ActorId(bytes([10]) * 16))
        b.put("_root", "fork", "side")
        t = b.put_object("_root", "new text", T.ObjType.TEXT)
        b.splice_text(t, 0, 0, "open transaction")  # left uncommitted
        docs.append((a, b))
    _CHANGE_COLS_CACHE.clear()
    # a Document under an open transaction is refused; its AutoDoc commits
    with pytest.raises(ValueError, match="open manual transaction"):
        RDeviceDoc.merge([docs[0][0], docs[0][1].doc])
    with pytest.raises(ValueError, match="open manual transaction"):
        DeviceDoc.merge([docs[1][0], docs[1][1].doc], device="cpu")
    want = RDeviceDoc.merge([docs[0][0].doc, docs[0][1]])
    got = DeviceDoc.merge([docs[1][0].doc, docs[1][1]], device="cpu")
    assert got.log.n == want.log.n
    for k in DeviceDoc.READ_FETCH:
        cut = got.log.n_objs + 2 if k.startswith("obj_") else got.log.n
        np.testing.assert_array_equal(np.asarray(got.res[k])[:cut],
                                      np.asarray(want.res[k])[:cut], err_msg=k)
    assert norm(got.hydrate()) == norm(want.hydrate())
    assert got.hydrate() == docs[1][1].hydrate() | {}
    with pytest.raises(TypeError):
        DeviceDoc.merge([docs[1][0], blobs[0]], device="cpu")


def test_errors_and_types_carry_the_reference_names():
    import automerge_tpu.errors as RE

    for name in RE.__all__:
        if name == "SyncError":
            continue  # the sync layer is not ported yet
        assert getattr(PE, name).__name__ == name
    assert [PT.action_for_objtype(t) for t in PT.ObjType] == \
        [int(RT.action_for_objtype(RT.ObjType(int(t)))) for t in PT.ObjType]
    assert PT.ActorId(b"ab").with_concurrency_suffix(300).bytes == \
        RT.ActorId(b"ab").with_concurrency_suffix(300).bytes
    assert (PT.VALUE_TYPE_COUNTER, PT.hash_hex(b"\x01\xff")) == \
        (RT.VALUE_TYPE_COUNTER, RT.hash_hex(b"\x01\xff"))
    for v in (None, True, 3, 2.5, "s", b"b"):
        assert norm(PT.ScalarValue.from_py(v)) == norm(RT.ScalarValue.from_py(v))
