"""The port's cross-document batched merge (``ops/batched.py``) on the CPU
against the JAX package's and against its own per-document apply.

Every case feeds the same change bytes to documents of both packages:
the port's through ``apply_cross_doc`` / ``CrossDocBatcher`` (one packed
launch for many documents' dirty subsets, here on the plain kernels), the
JAX package's through its own ``apply_cross_doc``, and a port document
through ``apply_changes`` one document at a time (the serial oracle).
After every drain the three must agree exactly: the ``READ_FETCH``
arrays, ``hydrate``, the heads and the pending changes. The cases are the
reference's (``tests/test_batched_merge.py``): random interleavings with
shuffled, split, duplicated and gapped delivery, mixed sizes in one
launch, empty deltas, the whale rule's boundary and a whale end to end,
a document listed twice, the ``stage_batches`` contract, the batcher
under threads and inactive, pipelined chunks. And four of the port's own:
``elem_index`` of two documents packed against their separate launches,
a packed batch that crosses the scatter gate its documents pass alone,
documents whose prop ids collide, and a view taken before a drain.
"""

import random
import threading

import numpy as np
import pytest

from automerge_tpu.api import AutoDoc
from automerge_tpu.ops import assemble as JA
from automerge_tpu.ops import batched as JB
from automerge_tpu.ops import extract as JX
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu.types import ActorId, ObjType, ScalarValue
from automerge_tpu_torch.ops import batched as B
from automerge_tpu_torch.ops import merge as M
from automerge_tpu_torch.ops.batched import (
    BatchStage, CrossDocBatcher, apply_cross_doc, plan_stages, resolve_stages,
)
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.oplog import pad_columns

from .test_torch_views import _norm

CPU = "cpu"


@pytest.fixture(autouse=True)
def cold_jax_change_cache(monkeypatch):
    """Each test starts with the JAX package's per-change-hash extraction
    cache empty, so both packages number map keys alike (ROADMAP §3)."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)


def actor(i: int) -> ActorId:
    return ActorId(bytes([i]) * 16)


def blobs_of(doc) -> list:
    return [a.stored.raw_bytes for a in doc.doc.history]


def j_parse(blobs) -> list:
    """The JAX package's parse of ``blobs``, each change's columns decoded
    alone. Its batch decode gives every change of a batch the batch's
    whole key table (``automerge_tpu/ops/assemble.py:306``) and remembers
    it by hash, so a drain decoding several documents' changes at once
    would add the other documents' keys to each log's props (ROADMAP §3);
    the port keeps each change's own table."""
    out = [j_parse_change(b)[0] for b in blobs]
    for ch in out:
        JA.ensure_change_cols([ch])
    return out


class Trio:
    """One document three times from the same bytes: the port's packed
    (``dev``), the JAX package's packed (``jdev``) and the port's serial
    oracle (``ref``)."""

    def __init__(self, blobs):
        self.dev = DeviceDoc.merge(blobs, device=CPU)
        self.ref = DeviceDoc.merge(blobs, device=CPU)
        self.jdev = JDeviceDoc.resolve(JOpLog.from_changes(j_parse(blobs)))


def run_drain(trios, batches_of, **kw):
    """One drain: the port's and the JAX package's ``apply_cross_doc`` over
    the same batches (``batches_of[i]``: lists of change bytes), the port's
    oracle by ``apply_changes``. Returns both packages' outputs."""
    out = apply_cross_doc([(t.dev, b) for t, b in zip(trios, batches_of)],
                          device=CPU, **kw)
    jout = JB.apply_cross_doc([(t.jdev, [j_parse(x) for x in b])
                               for t, b in zip(trios, batches_of)], **kw)
    for t, batches in zip(trios, batches_of):
        for b in batches:
            t.ref.apply_changes(b)
    return out, jout


def assert_same(doc, other, where=""):
    """``doc`` equals ``other`` (either package) on every READ_FETCH array,
    hydrate, heads and pending changes."""
    n = doc.log.n
    assert (n, doc.log.n_objs) == (other.log.n, other.log.n_objs), where
    for k in DeviceDoc.READ_FETCH:
        cut = doc.log.n_objs + 2 if k.startswith("obj_") else n
        np.testing.assert_array_equal(np.asarray(doc.res[k])[:cut],
                                      np.asarray(other.res[k])[:cut],
                                      err_msg=f"{where} {k}")
    assert _norm(doc.hydrate()) == _norm(other.hydrate()), where
    assert sorted(doc.current_heads()) == sorted(other.current_heads()), where
    assert doc.pending_changes() == other.pending_changes(), where


def assert_trio(t, where=""):
    assert_same(t.dev, t.jdev, f"{where} jax")
    assert_same(t.dev, t.ref, f"{where} serial")


def build_base(ballast: int = 300):
    """A document with a live text, a list and a counter, and an untouched
    ballast text (keeps a drain's dirty rows under the full re-resolve's
    share: the serving shape)."""
    base = AutoDoc(actor=actor(1))
    t = base.put_object("_root", "t", ObjType.TEXT)
    base.splice_text(t, 0, 0, "the quick brown fox")
    lst = base.put_object("_root", "l", ObjType.LIST)
    for i in range(5):
        base.insert(lst, i, i * 10)
    base.put("_root", "c", ScalarValue("counter", 5))
    if ballast:
        arch = base.put_object("_root", "archive", ObjType.TEXT)
        base.splice_text(arch, 0, 0, "x" * ballast)
    base.commit()
    return base, t, lst


def edit_fork(f, t, lst, rng, tag):
    ln = f.length(t)
    pos = rng.randrange(0, max(ln, 1))
    if rng.random() < 0.3 and ln > 1:
        f.splice_text(t, min(pos, ln - 1), 1, "")
    else:
        f.splice_text(t, pos, 0, f"<{tag}>")
    r = rng.random()
    if r < 0.3:
        f.increment("_root", "c", rng.randrange(1, 5))
    elif r < 0.6:
        f.put("_root", f"k{rng.randrange(3)}", tag)
    elif f.length(lst):
        if rng.random() < 0.5:
            f.insert(lst, rng.randrange(0, f.length(lst) + 1), tag)
        else:
            f.delete(lst, rng.randrange(0, f.length(lst)))
    f.commit()


def doc_with_delta(i, ballast=300, edits=1):
    """(base bytes, one fork's delta bytes)."""
    base, t, _ = build_base(ballast=ballast)
    chs = blobs_of(base)
    f = base.fork(actor=actor(10 + i))
    for j in range(edits):
        f.splice_text(t, (i + j) % max(f.length(t), 1), 0, f"<{i}.{j}>")
    f.commit()
    return chs, [b for b in blobs_of(f) if b not in chs]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_random_interleavings_match_jax_and_serial(seed):
    """Documents of mixed sizes drained over several cycles, under
    shuffled, split, duplicated and dependency-gapped delivery and empty
    drains: the packed drain equals the JAX package's and the serial
    apply after every cycle; so do views at the final heads."""
    rng = random.Random(seed)
    docs = []
    for i in range(4):
        # one small document with no ballast: its deltas pass the dirty
        # share and resolve whole inside its staging
        base, t, lst = build_base(ballast=0 if i == 0 else 150 * i)
        docs.append({"base": base, "t": t, "lst": lst, "trio": Trio(blobs_of(base)),
                     "forks": [base.fork(actor=actor(20 + 4 * i + j)) for j in range(2)],
                     "seen": set(blobs_of(base))})
    for cycle in range(4):
        feeds = []
        for i, d in enumerate(docs):
            if rng.random() < 0.2:
                feeds.append([])  # an empty drain for this document
                continue
            f = d["forks"][rng.randrange(len(d["forks"]))]
            edit_fork(f, d["t"], d["lst"], rng, f"{seed}.{cycle}.{i}")
            delta = [b for b in blobs_of(f) if b not in d["seen"]]
            d["seen"].update(delta)
            rng.shuffle(delta)  # dependencies may arrive late
            batches = []
            while delta:
                k = rng.randrange(1, len(delta) + 1)
                b, delta = delta[:k], delta[k:]
                if b and rng.random() < 0.3:
                    b = b + [b[0]]  # re-delivered
                batches.append(b)
            feeds.append(batches)
            d["base"].apply_changes([a.stored for a in f.doc.history])
            for g in d["forks"]:
                g.merge(d["base"])
        out, jout = run_drain([d["trio"] for d in docs], feeds)
        assert out == jout
        for i, d in enumerate(docs):
            assert_trio(d["trio"], f"seed {seed} cycle {cycle} doc {i}")
    for d in docs:
        t = d["trio"]
        heads = t.dev.current_heads()
        assert _norm(t.dev.at(heads).hydrate()) == _norm(t.jdev.at(heads).hydrate())


def test_mixed_sizes_share_one_launch():
    """Documents of very different (non-whale) sizes: one packed launch."""
    trios, feeds = [], []
    for i, (ballast, edits) in enumerate([(150, 1), (400, 2), (800, 3)]):
        chs, delta = doc_with_delta(i, ballast=ballast, edits=edits)
        trios.append(Trio(chs))
        feeds.append([delta])
    B.reset_stats()
    out, jout = run_drain(trios, feeds)
    assert out == jout
    assert out["batched"] == 3 and out["fallback"] == 0, out
    assert B.stats()["launches"] == 1
    for t in trios:
        assert_trio(t)


def test_empty_deltas_no_launch():
    chs, delta = doc_with_delta(0)
    t = Trio(chs)
    B.reset_stats()
    assert apply_cross_doc([(t.dev, []), (t.dev, [[]])], device=CPU) == {
        "applied": 0, "batched": 0, "fallback": 0}
    # re-delivered resident changes are no-ops too
    t.dev.apply_changes(delta)
    assert apply_cross_doc([(t.dev, [delta])], device=CPU) == {
        "applied": 0, "batched": 0, "fallback": 0}
    assert B.stats()["launches"] == 0


def test_fallback_ratio_boundary():
    """The whale rule is strict: a document at exactly ratio x total stays;
    one row over is peeled (largest first, totals recomputed). The JAX
    package's plan is the same on every case."""
    cases = [
        ((10, 10, 20), 0.5, [10, 10, 20], []),
        ((10, 10, 21), 0.5, [10, 10], [21]),
        ((1, 1000), 1.0, [1, 1000], []),  # ratio >= 1 never peels
        ((3, 2, 1), 0.0, [1], [3, 2]),  # ratio 0 peels down to the smallest
        ((50,), 0.0, [50], []),  # a lone document is never peeled
    ]
    for sizes, ratio, want_batch, want_whales in cases:
        batch, whales = plan_stages(
            [BatchStage(None, np.arange(n), np.arange(1)) for n in sizes], ratio)
        jbatch, jwhales = JB.plan_stages(
            [JB.BatchStage(None, np.arange(n), np.arange(1)) for n in sizes], ratio)
        assert [s.n_rows for s in batch] == want_batch == [s.n_rows for s in jbatch]
        assert [s.n_rows for s in whales] == want_whales == [s.n_rows for s in jwhales]


def test_whale_resolves_on_its_own_end_to_end():
    """A document whose dirty rows dwarf the others' is peeled and resolved
    alone; the rest share one launch; every document equal."""
    trios, feeds = [], []
    for i, (ballast, edits) in enumerate([(150, 1), (150, 1), (2500, 60)]):
        chs, delta = doc_with_delta(i, ballast=ballast, edits=edits)
        trios.append(Trio(chs))
        feeds.append([delta])
    B.reset_stats()
    out, jout = run_drain(trios, feeds, fallback_ratio=0.5)
    assert out == jout
    assert out["batched"] == 2 and out["fallback"] == 1, out
    s = B.stats()
    assert s["launches"] == 1 and s["batched_fallback"] == 1
    for t in trios:
        assert_trio(t)


def test_duplicate_document_merges_into_one_staging():
    """The same document twice in one drain merges into one staging: a
    second append would move the first stage's rows."""
    base, t, _ = build_base(ballast=300)
    chs = blobs_of(base)
    f1 = base.fork(actor=actor(10))
    f1.splice_text(t, 2, 0, "<one>")
    f1.commit()
    f2 = base.fork(actor=actor(11))
    f2.splice_text(t, 0, 0, "<two>")
    f2.put("_root", "k0", "dup")
    f2.commit()
    d1 = [b for b in blobs_of(f1) if b not in chs]
    d2 = [b for b in blobs_of(f2) if b not in chs]
    trio = Trio(chs)
    out = apply_cross_doc([(trio.dev, [d1]), (trio.dev, [d2])], device=CPU)
    jout = JB.apply_cross_doc([(trio.jdev, [j_parse(d1)]), (trio.jdev, [j_parse(d2)])])
    trio.ref.apply_changes(d1)
    trio.ref.apply_changes(d2)
    assert out == jout
    assert out["applied"] == len(d1) + len(d2)
    assert out["batched"] + out["fallback"] <= 1  # one stage for the document
    assert_trio(trio)


def test_stage_batches_contract():
    chs, delta = doc_with_delta(0)
    dev = DeviceDoc.merge(chs, device=CPU)
    view = dev.at(dev.current_heads())
    with pytest.raises(ValueError):
        view.stage_batches([delta])
    with pytest.raises(ValueError):
        view.stage_ready([])
    n, stage = dev.stage_batches([delta])
    assert n == len(delta) and stage is not None
    assert stage.doc is dev and len(stage.rows) > 0
    assert resolve_stages([stage], device=CPU) == {"batched": 1, "fallback": 0}
    jdev = JDeviceDoc.resolve(JOpLog.from_changes(j_parse(chs)))
    jn, jstage = jdev.stage_batches([j_parse(delta)])
    assert jn == n
    np.testing.assert_array_equal(stage.rows, jstage.rows)
    np.testing.assert_array_equal(stage.dirty, jstage.dirty)
    JB.resolve_stages([jstage])
    ref = DeviceDoc.merge(chs, device=CPU)
    ref.apply_changes(delta)
    assert_same(dev, jdev, "jax")
    assert_same(dev, ref, "serial")
    # nothing to stage: no stage; a whole-log resolve: no stage either
    assert dev.stage_batches([delta]) == (0, None)
    small, small_delta = doc_with_delta(1, ballast=0)
    sdev = DeviceDoc.merge(small, device=CPU)
    assert sdev.stage_batches([small_delta]) == (len(small_delta), None)
    sref = DeviceDoc.merge(small, device=CPU)
    sref.apply_changes(small_delta)
    assert_same(sdev, sref)


def _batcher_drain(batcher, trios, feeds):
    errs = []
    barrier = threading.Barrier(len(trios))

    def worker(dev, batches):
        try:
            barrier.wait()
            batcher.apply(dev, batches)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(t.dev, b)) for t, b in zip(trios, feeds)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=60)
    assert not errs, errs


@pytest.mark.parametrize("staging", ["vectorized", "scalar"])
def test_cross_doc_batcher_threads(staging, monkeypatch):
    """Concurrent workers draining different documents share one launch,
    whether the leader stages them all (vectorized) or each submitter
    stages its own; every document equals the JAX package's."""
    from automerge_tpu_torch.ops import host_batch

    monkeypatch.setattr(host_batch, "VECTORIZED", staging == "vectorized")
    n = 3
    trios, feeds = [], []
    for i in range(n):
        chs, delta = doc_with_delta(i, ballast=200 + 100 * i)
        trios.append(Trio(chs))
        feeds.append([delta])
    batcher = CrossDocBatcher(mode="1", window_ms=2000.0, max_docs=n, device=CPU)
    B.reset_stats()
    _batcher_drain(batcher, trios, feeds)
    assert B.stats()["launches"] == 1 and B.stats()["batched_error"] == 0
    JB.apply_cross_doc([(t.jdev, [j_parse(x) for x in b]) for t, b in zip(trios, feeds)])
    for t, b in zip(trios, feeds):
        t.ref.apply_changes(b[0])
        assert_trio(t)


def test_cross_doc_batcher_inactive_modes():
    """mode "0", and "auto" on a CPU document, apply per document."""
    for mode in ("0", "auto"):
        chs, delta = doc_with_delta(0)
        t = Trio(chs)
        batcher = CrossDocBatcher(mode=mode, device=CPU)
        assert not batcher.active(t.dev)
        B.reset_stats()
        assert batcher.apply(t.dev, [delta]) == len(delta)
        assert B.stats()["launches"] == 0
        t.ref.apply_changes(delta)
        assert_same(t.dev, t.ref)
    assert CrossDocBatcher(mode="1").active(t.dev)


def test_batcher_degrades_each_document_on_a_failed_launch(monkeypatch):
    """A packed path that raises is counted (``batched_error``) and every
    document of the generation is resolved on its own, on its device."""
    n = 3
    trios, feeds = [], []
    for i in range(n):
        chs, delta = doc_with_delta(i, ballast=200)
        trios.append(Trio(chs))
        feeds.append([delta])

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(B, "_dispatch_packed", broken)
    B.reset_stats()
    _batcher_drain(CrossDocBatcher(mode="1", window_ms=2000.0, max_docs=n, device=CPU),
                   trios, feeds)
    assert B.stats()["batched_error"] == 1
    for t, b in zip(trios, feeds):
        t.ref.apply_changes(b[0])
        assert t.dev.device.type == "cpu"
        assert_same(t.dev, t.ref)


@pytest.mark.parametrize("pipeline", [True, False])
def test_pipelined_chunks(pipeline, monkeypatch):
    """``max_docs_per_launch`` below the document count: one launch a
    chunk; with the pipeline on, chunk N is read back only after chunk
    N+1 is launched; every document equal."""
    events = []
    dispatch, collect = B.dispatch_stages, B.collect_stages

    def noting_dispatch(stages, *a, **k):
        events.append(("dispatch", len(stages)))
        return dispatch(stages, *a, **k)

    def noting_collect(d, *a, **k):
        events.append(("collect", d["batched"]))
        return collect(d, *a, **k)

    monkeypatch.setattr(B, "dispatch_stages", noting_dispatch)
    monkeypatch.setattr(B, "collect_stages", noting_collect)
    trios, feeds = [], []
    for i in range(5):
        # equal subsets: no document of a chunk of two is a whale
        chs, delta = doc_with_delta(i, ballast=300)
        trios.append(Trio(chs))
        feeds.append([delta])
    B.reset_stats()
    out, jout = run_drain(trios, feeds, max_docs_per_launch=2, pipeline=pipeline)
    assert out == jout and out["batched"] == 5
    assert B.stats()["launches"] == 3
    if pipeline:
        assert [e[0] for e in events] == ["dispatch", "dispatch", "collect",
                                          "dispatch", "collect", "collect"]
    for t in trios:
        assert_trio(t)


# -- the port's own cases -------------------------------------------------------


def _subset(doc, delta):
    """A document's stage after ``delta`` (not resolved)."""
    n, st = doc.stage_batches([delta])
    assert st is not None
    return st


def test_elem_index_of_packed_documents_equals_their_own_launches():
    """``forest`` + ``linearize`` over two documents packed: each
    document's slice of ``elem_index`` equals its own launch, unshifted
    (the rank starts again at each object)."""
    stages, alone = [], []
    for i, ballast in enumerate((200, 500)):
        chs, delta = doc_with_delta(i, ballast=ballast, edits=3)
        st = _subset(DeviceDoc.merge(chs, device=CPU), delta)
        stages.append(st)
        cols = pad_columns(st.doc._subset_cols(st.rows, st.dirty), len(st.dirty))
        alone.append(M.merge_columns(cols, fetch=DeviceDoc.READ_FETCH,
                                     n_objs=len(st.dirty), n_props=len(st.doc.log.props),
                                     device=CPU))
    cols, metas, rows, objs = B._pack(stages)
    packed = B._launch_packed(cols, objs, max(len(s.doc.log.props) for s in stages),
                              "cpu", "run_native")
    for (st, r0, S, o0, D), own in zip(metas, alone):
        ei = packed["elem_index"][r0 : r0 + S]
        assert (ei >= 0).any()
        np.testing.assert_array_equal(ei, own["elem_index"][:S])
        np.testing.assert_array_equal(packed["obj_text_width"][o0 : o0 + D],
                                      own["obj_text_width"][:D])
    assert metas[1][1] == metas[0][2] and rows == sum(m[2] for m in metas)


def _many_objects_doc(i, n_keys, n_objs, names):
    """A root map of ``n_keys`` keys (named by ``names``) and ``n_objs`` child
    maps; the delta puts into every child map (``n_objs`` dirty objects,
    a small share of the log)."""
    base = AutoDoc(actor=actor(1))
    for k in range(n_keys):
        base.put("_root", names(k), k)
    kids = [base.put_object("_root", f"m{j}", ObjType.MAP) for j in range(n_objs)]
    for j, m in enumerate(kids):
        base.put(m, names(j), j)
    base.commit()
    chs = blobs_of(base)
    f = base.fork(actor=actor(30 + i))
    for j, m in enumerate(kids):
        f.put(m, names(j), -j)
    f.commit()
    return chs, [b for b in blobs_of(f) if b not in chs]


@pytest.mark.parametrize("collide", [False, True])
def test_a_packed_batch_that_crosses_the_scatter_gate(collide, monkeypatch):
    """Two documents whose subsets pass ``scatter_geometry_ok`` alone pack
    into a batch that does not: the packed launch takes ``sort_winners``
    (K5), each document alone ``scatter_winners``, and the answers are the
    same. With ``collide``, the documents' prop ids name different keys
    (K5's key separates them by the object offset alone)."""
    calls = {"scatter_winners": 0, "sort_winners": 0}
    for name in calls:
        real = getattr(M, name)

        def counting(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(M, name, counting)
    names = [lambda k: f"k{k}", (lambda k: f"z{k}") if collide else (lambda k: f"k{k}")]
    trios, feeds, stages = [], [], []
    for i in range(2):
        chs, delta = _many_objects_doc(i, 900, 60, names[i])
        trios.append(Trio(chs))
        feeds.append([delta])
        # each document staged once more, to be resolved alone
        stages.append(_subset(DeviceDoc.merge(chs, device=CPU), delta))
    # the gate, from the subsets' own geometry
    n_props = max(len(s.doc.log.props) for s in stages)
    for s in stages:
        assert M.scatter_geometry_ok(len(pad_columns(
            s.doc._subset_cols(s.rows, s.dirty), len(s.dirty))["action"]),
            len(s.dirty), len(s.doc.log.props))
    cols, _, _, objs = B._pack(stages)
    assert not M.scatter_geometry_ok(len(pad_columns(cols, objs)["action"]), objs, n_props)
    if collide:
        assert stages[0].doc.log.props[:5] != stages[1].doc.log.props[:5]
    calls.update(scatter_winners=0, sort_winners=0)
    out, jout = run_drain(trios, feeds)
    assert out == jout and out["batched"] == 2
    assert calls == {"sort_winners": 1, "scatter_winners": 0}  # the packed launch
    for st, t in zip(stages, trios):
        resolve_stages([st], device=CPU)
        assert_same(st.doc, t.dev, "alone")
    assert calls == {"sort_winners": 1, "scatter_winners": 2}  # each alone
    for t in trios:
        assert_trio(t)


def test_a_view_taken_before_a_drain_is_not_served_after_it():
    """A view of the resident document, taken before a packed drain, is
    dropped by it: ``at`` the same heads afterwards is a new view, equal
    to the JAX package's; the current state moved on."""
    chs, delta = doc_with_delta(0, ballast=300, edits=2)
    chs2, delta2 = doc_with_delta(1, ballast=200)
    a, b = Trio(chs), Trio(chs2)
    heads = a.dev.current_heads()
    before = a.dev.at(heads)
    text_before = _norm(before.hydrate())
    run_drain([a, b], [[delta], [delta2]])
    assert not a.dev._views
    after = a.dev.at(heads)
    assert after is not before
    assert _norm(after.hydrate()) == text_before == _norm(a.jdev.at(heads).hydrate())
    assert _norm(a.dev.hydrate()) != text_before
    assert_trio(a)
    assert_trio(b)


def test_documents_on_another_device_are_refused():
    chs, delta = doc_with_delta(0)
    dev = DeviceDoc.merge(chs, device=CPU)
    with pytest.raises(ValueError, match="batch for"):
        apply_cross_doc([(dev, [delta])], device="meta")


def test_batcher_under_thread_stress():
    """More workers than cores with a short switch interval: every
    submission lands in exactly one generation of at most ``max_docs``,
    every generation is flushed, and every document equals its own apply."""
    import sys

    from automerge_tpu_torch import workload as W

    n = 24
    base, deltas, texts = W.serve_workload(n, 2, 4, 30)
    docs = [DeviceDoc.merge([base], device=CPU) for _ in range(n)]
    refs = [DeviceDoc.merge([base], device=CPU) for _ in range(n)]
    sizes = []

    class Noting(CrossDocBatcher):
        def _flush(self, gen):
            sizes.append(len(gen.subs) + len(gen.stages))
            super()._flush(gen)

    batcher = Noting(mode="1", window_ms=5.0, max_docs=5, device=CPU)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for c in range(2):
            B.reset_stats()
            sizes.clear()
            errs, applied = [], [0] * n

            def worker(i, c=c):
                try:
                    applied[i] = batcher.apply(docs[i], [[deltas[i][c]]])
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

            ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in ts) and not errs, errs
            assert applied == [1] * n
            assert sum(sizes) == n and max(sizes) <= 5, sizes
            s = B.stats()
            assert s["vectorized_docs"] == n and s["batched_error"] == 0, s
            for i in range(n):
                refs[i].apply_changes([deltas[i][c]])
                assert_same(docs[i], refs[i], (c, i))
    finally:
        sys.setswitchinterval(old)
    assert [d.text(W.SERVE_LIVE) for d in docs] == texts
