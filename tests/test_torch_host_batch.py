"""The port's vectorized cross-document staging (``ops/host_batch.py``) on
the CPU: against its own scalar path (``DeviceDoc.stage_ready``, the
oracle) and against the JAX package's ``stage_docs``.

Documents of mixed sizes take the same change bytes, cycle by cycle,
through ``stage_docs`` (then the packed launch) and through
``stage_batches`` one at a time. After every cycle the two port documents
must be identical column by column (the log's columns, actors, string
tables, values and unresolved-reference counts; the resolution arrays,
the successor counts, the object index and the object types) and equal
the JAX package's document staged by its own ``stage_docs``. The cases are
the reference's (``tests/test_host_batch.py``): random interleavings,
the scalar path forced, out-of-order delivery, an empty log, a non-tail
delta, the batcher's leader-staged flush, a document listed twice, a
historical view refused; and ``OpLog.n_miss_elem`` / ``n_miss_pred``
against the JAX log's after every append of a partial history.
"""

import random
import threading

import numpy as np
import pytest

from automerge_tpu.api import AutoDoc
from automerge_tpu.ops import batched as JB
from automerge_tpu.ops import extract as JX
from automerge_tpu.ops import host_batch as JH
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.types import ActorId, ObjType, ScalarValue
from automerge_tpu_torch.ops import batched as B
from automerge_tpu_torch.ops import host_batch
from automerge_tpu_torch.ops.batched import CrossDocBatcher, resolve_stages
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.oplog import OpLog
from automerge_tpu_torch.storage.change import parse_change

from .test_torch_batched import blobs_of, j_parse
from .test_torch_views import _norm

CPU = "cpu"
LOG_COLS = (
    "id_key", "obj_key", "elem_key", "action", "prop", "insert",
    "value_tag", "value_int", "width", "expand", "mark_name_idx",
    "elem_ref", "obj_dense", "pred_src", "pred_tgt", "pred_key",
    "obj_table",
)
DEV_COLS = (
    "visible", "winner", "conflicts", "elem_index", "succ_count",
    "inc_count", "counter_val",
)


@pytest.fixture(autouse=True)
def cold_jax_change_cache(monkeypatch):
    """Each test starts with the JAX package's per-change-hash extraction
    cache empty, so both packages number map keys alike (ROADMAP §3)."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)


def assert_logs_equal(a, b, tag=""):
    """Column-level equality of two logs (either package)."""
    assert a.n == b.n and a.n_objs == b.n_objs, tag
    assert [x.bytes for x in a.actors] == [x.bytes for x in b.actors], tag
    assert a.props == b.props and a.mark_names == b.mark_names, tag
    assert (a.n_miss_elem, a.n_miss_pred) == (b.n_miss_elem, b.n_miss_pred), tag
    for c in LOG_COLS:
        va, vb = np.asarray(getattr(a, c)), np.asarray(getattr(b, c))
        assert va.shape == vb.shape and np.array_equal(va, vb), (tag, c)
    for row in range(a.n):
        assert a.values[row].tag == b.values[row].tag, (tag, row)
        assert a.values[row].value == b.values[row].value, (tag, row)


def assert_docs_equal(vec, other, tag=""):
    """Log and resolution state equality (either package)."""
    assert_logs_equal(vec.log, other.log, tag)
    for c in DEV_COLS:
        assert np.array_equal(np.asarray(getattr(vec, c)),
                              np.asarray(getattr(other, c))), (tag, c)
    n2 = vec.log.n_objs + 2
    for c in ("obj_vis_len", "obj_text_width"):
        assert np.array_equal(np.asarray(vec.res[c])[:n2],
                              np.asarray(other.res[c])[:n2]), (tag, c)
    assert np.array_equal(vec._rows_by_obj, other._rows_by_obj), tag
    assert np.array_equal(vec._obj_sorted, other._obj_sorted), tag
    assert _norm(vec.hydrate()) == _norm(other.hydrate()), tag


def assert_identical(vec, sca, tag=""):
    """Two port documents: everything, the host caches too."""
    assert_docs_equal(vec, sca, tag)
    for c in ("obj_vis_len", "obj_text_width"):
        assert np.array_equal(vec.res[c], sca.res[c]), (tag, c)
    assert np.array_equal(vec.covered, sca.covered), tag
    assert sorted(vec._obj_type.items()) == sorted(sca._obj_type.items()), tag
    assert vec._rank_of == sca._rank_of and vec.pending_changes() == sca.pending_changes()


def build_workload(seed, n_docs=5, cycles=4, dup=True, shuffle=True, ballast=0):
    """Mixed-size documents, two editors each (one ranked below the base
    actor, one above), text edits, counters, marks, new objects and props,
    deletes; each cycle's delta (change bytes) optionally shuffled and
    re-delivered. ``ballast`` adds an untouched archive text so drained
    deltas stay on the dirty-subset path. Returns (base bytes per
    document, deltas[document][cycle])."""
    rng = random.Random(seed)
    bases, deltas = [], []
    for i in range(n_docs):
        base = AutoDoc(actor=ActorId(bytes([20]) * 16))
        t = base.put_object("_root", "t", ObjType.TEXT)
        base.splice_text(t, 0, 0, "seed text " * (i + 1))
        base.put("_root", "ctr", ScalarValue("counter", 0))
        if ballast:
            arch = base.put_object("_root", "archive", ObjType.TEXT)
            base.splice_text(arch, 0, 0, "x" * ballast)
        base.commit()
        e1 = base.fork(actor=ActorId(bytes([3 + i]) + bytes(15)))
        e2 = base.fork(actor=ActorId(bytes([190 - i]) + bytes(15)))
        seen = set(blobs_of(base))
        cyc = []
        for c in range(cycles):
            for j in range(2 + i):
                e1.splice_text(t, (c + j) % 5, 0, "A")
                e2.splice_text(t, (c + j) % 3, 0, "B")
            e1.increment("_root", "ctr", 1)
            if c == 1:
                e2.mark(t, 1, 4, "em", True)
                e2.put_object("_root", f"obj{i}", ObjType.LIST)
                e1.put("_root", f"key{i}", "v")
            if c == 2:
                e1.delete("_root", f"key{i}")
            e1.commit()
            e2.commit()
            e1.merge(e2)
            e2.merge(e1)
            d = [b for b in blobs_of(e1) if b not in seen]
            seen.update(d)
            if shuffle:
                rng.shuffle(d)
            if dup and d and rng.random() < 0.5:
                d = d + rng.sample(d, 1)  # re-delivered
            cyc.append(d)
        bases.append(blobs_of(base))
        deltas.append(cyc)
    return bases, deltas


def port_docs(bases):
    return [DeviceDoc.merge(b, device=CPU) for b in bases]


def jax_docs(bases):
    return [JDeviceDoc.resolve(JOpLog.from_changes(j_parse(b))) for b in bases]


def stage_resolve(work, **kw):
    stages, results = host_batch.stage_docs(work, **kw)
    for r in results.values():
        assert r.error is None, repr(r.error)
    if stages:
        resolve_stages(stages, device=CPU)
    return results


def j_stage_resolve(work):
    stages, results = JH.stage_docs([(d, [j_parse(x) for x in b]) for d, b in work])
    for r in results.values():
        assert r.error is None, repr(r.error)
    if stages:
        JB.resolve_stages(stages)
    return results


def scalar_stage(doc, batches):
    _, st = doc.stage_batches(batches)
    if st is not None:
        resolve_stages([st], device=CPU)


def drive(bases, deltas, cycles, vectorized=None):
    """The port's vectorized documents, its scalar ones and the JAX
    package's, cycle by cycle; returns (port vectorized, port scalar, JAX,
    vectorized stagings)."""
    vec, sca, jax = port_docs(bases), port_docs(bases), jax_docs(bases)
    n_vec = 0
    for c in range(cycles):
        results = stage_resolve([(vec[i], [deltas[i][c]]) for i in range(len(vec))],
                                vectorized=vectorized)
        n_vec += sum(r.vectorized for r in results.values())
        j_stage_resolve([(jax[i], [deltas[i][c]]) for i in range(len(vec))])
        for i in range(len(vec)):
            scalar_stage(sca[i], [deltas[i][c]])
        for i in range(len(vec)):
            assert_identical(vec[i], sca[i], (c, i))
            assert_docs_equal(vec[i], jax[i], (c, i, "jax"))
    return vec, sca, jax, n_vec


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_differential_random_interleavings(seed):
    bases, deltas = build_workload(seed)
    vec, sca, jax, n_vec = drive(bases, deltas, 4)
    # the vectorized path took most cycles, cycle 0 too, where both
    # editors' actors are new to the resident log (the monotone remap)
    assert n_vec >= len(bases) * 3, n_vec
    for i in (0, len(bases) - 1):
        heads = vec[i].current_heads()
        for h in (heads, []):
            assert _norm(vec[i].at(h).hydrate()) == _norm(sca[i].at(h).hydrate()) \
                == _norm(jax[i].at(h).hydrate())
    # the marks of cycle 1, read off the base: its covered mask grew with
    # every append, on both staging paths
    for i in range(len(bases)):
        text = vec[i].get("_root", "t")[0][2]
        marks = _norm(jax[i].marks(text))
        assert marks and _norm(vec[i].marks(text)) == _norm(sca[i].marks(text)) == marks


def test_the_scalar_path_forced(monkeypatch):
    """``vectorized=False`` (and the module default set so) stages every
    document by the scalar path, equal all the same."""
    bases, deltas = build_workload(5, n_docs=3, cycles=2)
    assert drive(bases, deltas, 2, vectorized=False)[3] == 0
    monkeypatch.setattr(host_batch, "VECTORIZED", False)
    assert drive(bases, deltas, 2)[3] == 0


def test_out_of_order_delivery_buffers_pending():
    bases, deltas = build_workload(9, n_docs=3, cycles=3, dup=False, shuffle=False)
    vec, sca, jax = port_docs(bases), port_docs(bases), jax_docs(bases)
    # cycle 1 before cycle 0: the gap buffers cycle 1, cycle 0 releases both
    stage_resolve([(vec[i], [deltas[i][1]]) for i in range(3)])
    j_stage_resolve([(jax[i], [deltas[i][1]]) for i in range(3)])
    assert all(vec[i].pending_changes() > 0 for i in range(3))
    stage_resolve([(vec[i], [deltas[i][0]]) for i in range(3)])
    j_stage_resolve([(jax[i], [deltas[i][0]]) for i in range(3)])
    for i in range(3):
        sca[i].stage_batches([deltas[i][1]])
        scalar_stage(sca[i], [deltas[i][0]])
        assert vec[i].pending_changes() == sca[i].pending_changes() == 0
        assert_identical(vec[i], sca[i], i)
        assert_docs_equal(vec[i], jax[i], i)


def test_an_empty_log_stages_on_the_scalar_path():
    """A document opened before any history (an empty resident log) is
    built by the scalar path (a rebuild), equal all the same."""
    base = AutoDoc(actor=ActorId(bytes([20]) * 16))
    t = base.put_object("_root", "t", ObjType.TEXT)
    base.splice_text(t, 0, 0, "hello")
    base.commit()
    chs = blobs_of(base)
    vec, sca = DeviceDoc.merge([], device=CPU), DeviceDoc.merge([], device=CPU)
    results = stage_resolve([(vec, [chs])])
    assert not any(r.vectorized for r in results.values())
    assert [r.applied for r in results.values()] == [len(chs)]
    scalar_stage(sca, [chs])
    assert_identical(vec, sca)
    jax = JDeviceDoc.resolve(JOpLog.from_changes([]))
    j_stage_resolve([(jax, [chs])])
    assert_docs_equal(vec, jax)


def test_a_non_tail_delta_is_demoted_to_the_scalar_path():
    """A delta whose ids sit below the resident maximum (a slow replica's
    old edits arriving late) is demoted to the scalar splice, counted,
    and still equal."""
    base = AutoDoc(actor=ActorId(bytes([20]) * 16))
    t = base.put_object("_root", "t", ObjType.TEXT)
    base.splice_text(t, 0, 0, "base ")
    base.commit()
    have = set(blobs_of(base))
    slow = base.fork(actor=ActorId(bytes([9]) + bytes(15)))
    slow.splice_text(t, 0, 0, "S")
    slow.commit()
    slow_delta = [b for b in blobs_of(slow) if b not in have]
    fast = base.fork(actor=ActorId(bytes([80]) + bytes(15)))
    for c in range(3):
        fast.splice_text(t, c, 0, "F" * 4)
        fast.commit()
    fast_delta = [b for b in blobs_of(fast) if b not in have]
    vec, sca = port_docs([blobs_of(base)] * 2)
    jax = jax_docs([blobs_of(base)])[0]
    stage_resolve([(vec, [fast_delta])])
    j_stage_resolve([(jax, [fast_delta])])
    scalar_stage(sca, [fast_delta])
    B.reset_stats()
    results = stage_resolve([(vec, [slow_delta])])
    assert not any(r.vectorized for r in results.values())
    assert B.stats()["demoted_docs"] == 1
    j_stage_resolve([(jax, [slow_delta])])
    scalar_stage(sca, [slow_delta])
    assert_identical(vec, sca)
    assert_docs_equal(vec, jax)


def test_cross_doc_batcher_leader_staged():
    """Concurrent submitters hand raw batches to the flush leader, which
    stages every document in one vectorized pass before one shared
    launch; equal to the scalar path and the JAX package's."""
    bases, deltas = build_workload(13, n_docs=4, cycles=2, dup=False, ballast=400)
    vec, sca, jax = port_docs(bases), port_docs(bases), jax_docs(bases)
    batcher = CrossDocBatcher(window_ms=2000.0, max_docs=4, mode="1", device=CPU)
    for c in range(2):
        B.reset_stats()
        applied, errors = {}, []

        def worker(i, c=c):
            try:
                applied[i] = batcher.apply(vec[i], [deltas[i][c]])
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(60)
        assert not errors, errors
        assert all(applied[i] > 0 for i in range(4)), applied
        s = B.stats()
        # all four shared ONE packed launch, all staged by the leader's pass
        assert s["launches"] == 1 and s["vectorized_docs"] == 4, s
        j_stage_resolve([(jax[i], [deltas[i][c]]) for i in range(4)])
        for i in range(4):
            scalar_stage(sca[i], [deltas[i][c]])
            assert_identical(vec[i], sca[i], (c, i))
            assert_docs_equal(vec[i], jax[i], (c, i))


def test_duplicate_document_entries_merge_into_one_staging():
    bases, deltas = build_workload(21, n_docs=2, cycles=2, dup=False)
    vec, sca, jax = port_docs(bases), port_docs(bases), jax_docs(bases)
    work = [(0, [deltas[0][0]]), (1, [deltas[1][0]]), (0, [deltas[0][1]])]
    stage_resolve([(vec[i], b) for i, b in work])
    j_stage_resolve([(jax[i], b) for i, b in work])
    scalar_stage(sca[0], [deltas[0][0], deltas[0][1]])
    scalar_stage(sca[1], [deltas[1][0]])
    for i in range(2):
        assert_identical(vec[i], sca[i], i)
        assert_docs_equal(vec[i], jax[i], i)


def test_stage_docs_refuses_historical_views():
    base = AutoDoc(actor=ActorId(bytes([20]) * 16))
    base.put("_root", "x", 1)
    base.commit()
    dev = DeviceDoc.merge(blobs_of(base), device=CPU)
    with pytest.raises(ValueError):
        host_batch.stage_docs([(dev.at(dev.current_heads()), [[]])])


@pytest.mark.parametrize("fast", [True, False])
def test_miss_counters_follow_the_jax_log(fast):
    """A partial history (changes whose references are not in the log yet)
    appended change by change: ``n_miss_elem`` / ``n_miss_pred`` equal the
    JAX log's after every append, and a recount of the columns."""
    bases, deltas = build_workload(3, n_docs=1, cycles=4, dup=False, shuffle=False)
    blobs = bases[0] + [b for c in deltas[0] for b in c]
    chs = [parse_change(b)[0] for b in blobs]
    jchs = j_parse(blobs)
    # the base, then the later changes first: their refs miss until the
    # earlier ones arrive
    first = [0] + list(range(len(chs) // 2, len(chs)))
    rest = [i for i in range(len(chs)) if i not in first]
    log = OpLog.from_changes([chs[i] for i in first], fast=fast)
    jlog = JOpLog.from_changes([jchs[i] for i in first])
    seen = [(log.n_miss_elem, log.n_miss_pred)]
    assert seen[0] == (jlog.n_miss_elem, jlog.n_miss_pred)
    have, jhave = [chs[i] for i in first], [jchs[i] for i in first]
    appended = 0
    for i in rest:
        have.append(chs[i])
        jhave.append(jchs[i])
        # an assembled partial history keeps no reference keys to
        # re-resolve: the append refuses, and the caller (DeviceDoc) rebuilds
        if log.append_changes([chs[i]], fast=fast) is None:
            log = OpLog.from_changes(have, fast=fast)
        else:
            appended += 1
        if jlog.append_changes([jchs[i]]) is None:
            jlog = JOpLog.from_changes(jhave)
        got = (log.n_miss_elem, log.n_miss_pred)
        assert got == (jlog.n_miss_elem, jlog.n_miss_pred)
        recount = OpLog()
        recount.elem_ref, recount.pred_tgt = log.elem_ref, log.pred_tgt
        recount.count_missing()
        assert got == (recount.n_miss_elem, recount.n_miss_pred)
        seen.append(got)
    assert seen[0] != (0, 0) and seen[-1] == (0, 0), seen
    if not fast:  # the per-op log keeps its keys: every step an append
        assert appended == len(rest)
