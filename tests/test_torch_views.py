"""Historical views, the read API and the device differ of the port's
``DeviceDoc`` on the CPU against the JAX package's, on the same change
bytes.

Each seeded history (``test_torch_histories._history``) is merged by both
packages. At each round boundary of its causal order (the base, then the
base and every fork's first k changes), at one fork's first change alone
(a concurrent cut), at ``[]`` and at ``None`` (the current state), every
read of every object the log ever made must be equal, exactly:
``current_heads``, ``text``, ``keys``, ``length``, ``get``, ``get_all``,
``map_entries``, ``list_items``, ``map_range``, ``list_range``,
``values``, ``hydrate``, ``parents``, ``get_cursor``,
``get_cursor_position`` and ``marks``; and ``diff`` between every ordered
pair of those heads, and ``make_patches``. Applying the port's
``diff(a, b)`` to ``hydrate(heads=a)`` gives ``hydrate(heads=b)``. Also:
a counter incremented after a snapshot, views taken again after the
document is served (an append with no new row, an append by a new actor
that moves every actor rank), and the guards of a view.
"""

import dataclasses

import numpy as np
import pytest

from automerge_tpu.api import AutoDoc
from automerge_tpu.ops import extract as JX
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu.types import ActorId, ObjType, ScalarValue
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.patches import PutMap, apply_patches
from automerge_tpu_torch.storage.change import parse_change

from .test_torch_histories import KEYS, _history

BASE_ACTOR = bytes([1]) * 16


@pytest.fixture(autouse=True)
def cold_jax_change_cache(monkeypatch):
    """Each test starts with the JAX package's per-change-hash extraction
    cache empty, so both packages number map keys alike (ROADMAP §3)."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)


def _j_doc(blobs):
    return JDeviceDoc.resolve(JOpLog.from_changes([j_parse_change(b)[0] for b in blobs]))


def _heads_of(changes):
    deps = {d for c in changes for d in c.dependencies}
    return sorted(c.hash for c in changes if c.hash not in deps)


def _cuts(blobs):
    """[(name, heads)]: [], the base, each round's boundary, one fork's
    first change alone, None."""
    chs = [parse_change(b)[0] for b in blobs]
    base = [c for c in chs if c.actor == BASE_ACTOR]
    forks = [c for c in chs if c.actor != BASE_ACTOR]
    cuts = [("empty", []), ("base", _heads_of(base))]
    for r in range(1, max(c.seq for c in forks) + 1):
        cuts.append((f"round{r}", _heads_of(base + [c for c in forks if c.seq <= r])))
    first = min(forks, key=lambda c: c.actor)
    cuts.append(("one_fork", _heads_of(base + [first])))
    cuts.append(("current", None))
    return cuts


def _norm(x):
    """Patches, marks and values of either package as plain data: a
    dataclass is its class name and fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [_norm(v) for v in x]
    return x


def _try(fn, *args, **kw):
    try:
        return "ok", _norm(fn(*args, **kw))
    except (KeyError, ValueError, IndexError) as e:
        return "raise", type(e).__name__


def _objects(doc):
    return sorted(doc.log.export_id(k) for k in doc._obj_type)


def _view_reads(doc, heads, objs):
    """Every read of every object at ``heads``."""
    out = {"current_heads": doc.current_heads(),
           "view_heads": doc.at(heads).current_heads()}
    for obj in objs:
        t = doc.object_type(obj)
        r = {"parents": _try(doc.parents, obj, heads=heads),
             "hydrate": _try(doc.hydrate, obj, heads=heads),
             "length": _try(doc.length, obj, heads=heads),
             "values": _try(doc.values, obj, heads=heads)}
        if t in (ObjType.MAP, ObjType.TABLE):
            r["keys"] = _try(doc.keys, obj, heads=heads)
            r["map_entries"] = _try(doc.map_entries, obj, heads=heads)
            r["map_range"] = [_try(doc.map_range, obj, s, e, heads=heads)
                              for s, e in ((None, None), ("b", "n"), ("c", None))]
            for k in (*KEYS, "missing"):
                r[f"get {k}"] = _try(doc.get, obj, k, heads=heads)
                r[f"get_all {k}"] = _try(doc.get_all, obj, k, heads=heads)
        else:
            n = doc.length(obj, heads=heads)
            r["text"] = _try(doc.text, obj, heads=heads)
            r["list_items"] = _try(doc.list_items, obj, heads=heads)
            r["list_range"] = [_try(doc.list_range, obj, s, e, heads=heads)
                               for s, e in ((0, None), (1, 4), (2, 2))]
            r["marks"] = _try(doc.marks, obj, heads=heads)
            for i in range(n + 2):
                r[f"get {i}"] = _try(doc.get, obj, i, heads=heads)
                r[f"get_all {i}"] = _try(doc.get_all, obj, i, heads=heads)
                r[f"get_cursor {i}"] = _try(doc.get_cursor, obj, i, heads=heads)
            base = doc._base
            for e in base._all_elems(base.log.import_id(obj)):
                cur = base.log.export_id(int(base.log.id_key[e]))
                r[f"cursor_position {cur}"] = _try(
                    doc.get_cursor_position, obj, cur, heads=heads)
        out[obj] = r
    return out


SEEDS = (0, 1, 2, 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_views_and_reads_equal_jax_at_every_cut(seed):
    base, rest = _history(seed)
    blobs = base + [b for b in rest if b not in base]
    doc = DeviceDoc.merge(blobs, device="cpu")
    jdoc = _j_doc(blobs)
    objs = _objects(doc)
    assert objs == _objects(jdoc) and len(objs) > 5
    assert doc.current_heads() == jdoc.current_heads()
    cuts = _cuts(blobs)
    assert len(cuts) >= 6
    for name, heads in cuts:
        view = doc.at(heads)
        assert view.device == doc.device and view.staging == doc.staging
        if heads is not None:
            assert doc.at(list(reversed(heads))) is view  # cached by the sorted set
            np.testing.assert_array_equal(view.covered, doc.at(heads).covered)
            jview = jdoc.at(heads)
            np.testing.assert_array_equal(view.covered, jview.covered, err_msg=name)
            for k in DeviceDoc.VIEW_FETCH:
                cut = doc.log.n_objs + 2 if k.startswith("obj_") else doc.log.n
                np.testing.assert_array_equal(np.asarray(view.res[k])[:cut],
                                              np.asarray(jview.res[k])[:cut],
                                              err_msg=f"{name} {k}")
            np.testing.assert_array_equal(view.counter_val, jview.counter_val,
                                          err_msg=name)
        assert _view_reads(doc, heads, objs) == _view_reads(jdoc, heads, objs), name
    assert doc.hydrate(heads=[]) == {} == jdoc.hydrate(heads=[])
    assert not doc.at([]).covered.any()


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_diff_between_every_pair_of_cuts_equals_jax_and_applies(seed):
    base, rest = _history(seed)
    blobs = base + [b for b in rest if b not in base]
    doc = DeviceDoc.merge(blobs, device="cpu")
    jdoc = _j_doc(blobs)
    cuts = _cuts(blobs)
    for na, a in cuts:
        for nb, b in cuts:
            got = doc.diff(a, b)
            assert _norm(got) == _norm(jdoc.diff(a, b)), (na, nb)
            # diff's before is the empty document when ``a`` is None
            before = doc.hydrate(heads=a if a is not None else [])
            assert apply_patches(before, got) == doc.hydrate(heads=b), (na, nb)
    patches = doc.make_patches()
    assert _norm(patches) == _norm(jdoc.make_patches())
    assert apply_patches({}, patches) == doc.hydrate() == jdoc.hydrate()
    assert doc.diff(None) == patches  # before None: from nothing


def _counter_history():
    """A counter put and a snapshot, then increments by two actors after
    it, one of them concurrent with a put that replaces another key."""
    base = AutoDoc(actor=ActorId(BASE_ACTOR))
    base.put("_root", "n", ScalarValue("counter", 3))
    lst = base.put_object("_root", "l", ObjType.LIST)
    base.insert(lst, 0, ScalarValue("counter", 10))
    base.put("_root", "k", ScalarValue("str", "v0"))
    base.commit()
    snap = base.get_heads()
    a = base.fork(actor=ActorId(bytes([10]) * 16))
    b = base.fork(actor=ActorId(bytes([11]) * 16))
    a.increment("_root", "n", 4)
    a.increment(lst, 0, -2)
    a.commit()
    b.increment("_root", "n", 100)
    b.put("_root", "k", ScalarValue("str", "v1"))
    b.commit()
    mid = a.get_heads()
    a.merge(b)
    a.increment("_root", "n", 1)
    a.commit()
    blobs = []
    seen = set()
    for c in (h.stored for h in a.doc.history):
        if c.hash not in seen:
            seen.add(c.hash)
            blobs.append(c.raw_bytes)
    return blobs, snap, mid


def test_a_counter_incremented_after_a_snapshot():
    blobs, snap, mid = _counter_history()
    doc = DeviceDoc.merge(blobs, device="cpu")
    jdoc = _j_doc(blobs)
    lst = doc.get("_root", "l")[0][2]
    for heads, n, item in ((snap, 3, 10), (mid, 7, 8), (None, 108, 8)):
        assert doc.get("_root", "n", heads=heads)[0] == ("counter", n)
        assert doc.get(lst, 0, heads=heads)[0] == ("counter", item)
        assert doc.hydrate(heads=heads) == jdoc.hydrate(heads=heads)
        assert _norm(doc.diff(snap, heads)) == _norm(jdoc.diff(snap, heads))
    kinds = [type(p.action).__name__ for p in doc.diff(snap, None)]
    assert kinds.count("IncrementPatch") == 2 and "PutMap" in kinds
    assert apply_patches(doc.hydrate(heads=snap), doc.diff(snap)) == doc.hydrate()
    assert doc.diff(snap, None)[0].action == PutMap("k", "v1", False)


def _full_doc(blobs):
    """A reference host document holding ``blobs``, to write more changes."""
    host = AutoDoc(actor=ActorId(bytes([200]) * 16))
    host.apply_changes([j_parse_change(b)[0] for b in blobs])
    return host


def _serve(doc, blobs, mode):
    if mode == "pipelined":  # the card's drain, run on the plain kernels
        return doc._apply_pipelined([blobs])
    return doc.apply_changes(blobs)


@pytest.mark.parametrize("mode", ["apply_changes", "pipelined"])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_views_taken_again_after_serving_equal_a_fresh_documents(seed, mode):
    """A view, then an append with no new row (an empty change by a new
    actor), then one by another new actor that sorts first (every actor
    rank moves): each time the views were dropped, and ``at`` the same
    heads equals a fresh document's view, reads and ``diff``."""
    base, rest = _history(seed)
    blobs = base + [b for b in rest if b not in base]
    doc = DeviceDoc.merge(blobs, device="cpu")
    cuts = [c for c in _cuts(blobs) if c[1]]
    objs = _objects(doc)
    first = {name: _view_reads(doc, heads, objs) for name, heads in cuts}
    views = {name: doc.at(heads) for name, heads in cuts}

    host = _full_doc(blobs)
    empty = host.fork(actor=ActorId(bytes([7]) * 16))
    empty.transaction(message="ack").commit()
    empty_change = empty.get_last_local_change()
    assert len(empty_change.ops) == 0
    n = doc.log.n
    assert _serve(doc, [empty_change.raw_bytes], mode) == 1
    assert doc.log.n == n
    blobs.append(empty_change.raw_bytes)

    early = host.fork(actor=ActorId(bytes([0]) * 16))
    early.put("_root", "late", ScalarValue("str", "x"))
    early.splice_text(early.get("_root", "text")[0][2], 0, 0, "new ")
    late_change = early.get_last_local_change()
    for step, extra in (("empty", []), ("new actor", [late_change.raw_bytes])):
        if extra:
            assert _serve(doc, extra, mode) == 1
            blobs += extra
        assert not doc._views
        fresh = DeviceDoc.merge(blobs, device="cpu")
        assert doc.current_heads() == fresh.current_heads()
        objs = _objects(fresh)
        assert _objects(doc) == objs
        for name, heads in cuts:
            view = doc.at(heads)
            assert view is not views[name], (step, name)
            np.testing.assert_array_equal(view.covered, fresh.at(heads).covered)
            got = _view_reads(doc, heads, objs)
            assert got == _view_reads(fresh, heads, objs), (step, name)
            assert _norm(doc.diff(heads)) == _norm(fresh.diff(heads)), (step, name)
            if step == "empty":  # only the heads moved
                same = {k for k in got if not k.endswith("heads")}
                assert {k: got[k] for k in same} == {k: first[name][k] for k in same}
    assert doc.get("_root", "late")[0][1] == ScalarValue("str", "x")
    assert doc.get("_root", "late", heads=cuts[-1][1]) is None


def test_a_view_refuses_to_be_served():
    base, rest = _history(0)
    blobs = base + [b for b in rest if b not in base]
    doc = DeviceDoc.merge(blobs, device="cpu")
    view = doc.at(_cuts(blobs)[1][1])
    assert view._base is doc and view.at(None) is doc
    with pytest.raises(ValueError, match="historical view"):
        view.apply_changes(blobs[-1:])
    with pytest.raises(ValueError, match="historical view"):
        view.apply_batches([blobs[-1:]])
    with pytest.raises(ValueError, match="historical view"):
        view.enable_mesh(devices=["cpu"] * 2)
    with pytest.raises(KeyError, match="unknown head"):
        doc.at([b"\0" * 32])


def test_views_of_a_mesh_document_resolve_on_its_device(monkeypatch):
    """A view carries the base's mesh state but resolves on the base's
    device, never over the mesh."""
    base, rest = _history(1)
    blobs = base + [b for b in rest if b not in base]
    doc = DeviceDoc.merge(blobs, device="cpu")
    mesh = doc.enable_mesh(devices=["cpu"] * 2, min_rows=0)
    ran = []
    monkeypatch.setattr(DeviceDoc, "_mesh_resolve_inner",
                        lambda self: ran.append(1))
    heads = _cuts(blobs)[2][1]
    view = doc.at(heads)
    assert view._mesh is mesh and not ran
    assert view.hydrate() == DeviceDoc.merge(blobs, device="cpu").hydrate(heads=heads)
