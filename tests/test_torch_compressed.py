"""The port's compressed residency (``ops/compressed.py``) on the CPU,
against the JAX package's with exact equality.

The codec: ``StrideRuns`` tables field for field after ``encode``,
``slice``, ``splice`` (at a run's head, its middle, its last row and past
the last run) and a sequence of ``extend_tail``; ``join`` against the JAX
package's ``join`` and the port's native ``join_rows``, its edge cases
and an unsorted column's refusal. The image: ``CompressedOpColumns`` of
the port's log and the JAX package's on the text, typing and record
workloads (entries, cursors, demotions, bytes, ratio, run counts), a
degenerate column's demotion, and the residency figures of ``OpLog`` and
``DeviceDoc`` after ``from_changes`` and after every append. The dense
differential: compressed residency on and off (``compressed.ENABLED``)
over a per-document drain with out-of-order delivery and over an
``apply_cross_doc`` drain, every document identical in both modes and
equal to the JAX package's, the offset-value-coded join counted on both
append paths, the image faithful after every append and dropped by every
append that rewrites the prefix.
"""

import random

import numpy as np
import pytest

from automerge_tpu.api import AutoDoc
from automerge_tpu.ops import batched as JB
from automerge_tpu.ops import compressed as JC
from automerge_tpu.ops import extract as JX
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.types import ActorId, ObjType
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.ops import batched as B
from automerge_tpu_torch.ops import compressed as C
from automerge_tpu_torch.ops import host_batch
from automerge_tpu_torch.ops.compressed import CompressedOpColumns, StrideRuns
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.oplog import OpLog, join_rows
from automerge_tpu_torch.storage.change import parse_change

from .test_torch_batched import blobs_of, j_parse
from .test_torch_host_batch import (
    assert_docs_equal, assert_identical, build_workload, jax_docs,
)

CPU = "cpu"
MISSING = -3


@pytest.fixture(autouse=True)
def cold_jax_change_cache(monkeypatch):
    """Each test starts with the JAX package's per-change-hash extraction
    cache empty, so both packages number map keys alike (ROADMAP §3)."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)


# -- the codec ------------------------------------------------------------------


def _random_column(rng, n, kind):
    """The reference's four column shapes (``tests/test_compressed.py``)."""
    if kind == 0:  # low cardinality (action, value_tag)
        return rng.integers(0, 3, n).astype(np.int32)
    if kind == 1:  # strictly sorted keys (id_key)
        return np.cumsum(rng.integers(1, 5, n)).astype(np.int64)
    if kind == 2:  # a typing chain (elem_ref)
        return (np.arange(n) - 1).astype(np.int32)
    return rng.integers(-50, 50, n).astype(np.int32)  # degenerate


def assert_runs_equal(p, j, tag=""):
    """A port ``StrideRuns`` equals a JAX one field for field."""
    for f in ("starts", "vals", "strides"):
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), (tag, f)
    assert (p.n, p.dtype, p.is_sorted, p.stride_mode) == \
        (j.n, j.dtype, j.is_sorted, j.stride_mode), tag


def _splice_points(r):
    """Rows at a run's head, in its middle and at its last row (for the
    first runs), and past the last run."""
    ln = r.lengths()
    pts = {r.n}
    for s, L in list(zip(r.starts.tolist(), ln.tolist()))[:4]:
        pts.update((s, s + L // 2, s + L - 1))
    return sorted(pts)


@pytest.mark.parametrize("kind", range(4))
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_codec_tables_equal_jax(seed, kind):
    rng = np.random.default_rng(seed * 4 + kind)
    for trial in range(12):
        n = int(rng.integers(0, 120))
        x = _random_column(rng, n, kind)
        for stride in (True, False):
            tag = (trial, stride)
            r = StrideRuns.encode(x, stride=stride)
            assert_runs_equal(r, JC.StrideRuns.encode(x, stride=stride), tag)
            assert np.array_equal(r.decode(), x) and r.decode().dtype == x.dtype
            assert (r.run_count, r.nbytes) == (len(r.starts), 24 * r.run_count)
            if n:
                assert r.last_value() == int(x[-1])
                lo = int(rng.integers(0, n))
                hi = int(rng.integers(lo, n + 1))
                js = JC.StrideRuns.encode(x, stride=stride).slice(lo, hi)
                assert_runs_equal(r.slice(lo, hi), js, (tag, lo, hi))
                assert np.array_equal(r.slice(lo, hi).decode(), x[lo:hi])
            ins = _random_column(rng, int(rng.integers(1, 9)), kind)
            for pos in _splice_points(r):
                got = StrideRuns.encode(x, stride=stride).splice(pos, ins)
                want = JC.StrideRuns.encode(x, stride=stride).splice(pos, ins)
                assert_runs_equal(got, want, (tag, "splice", pos))
                assert np.array_equal(got.decode(), np.concatenate(
                    [x[:pos], ins.astype(x.dtype), x[pos:]]))
            # a stream of tail appends: each step equal to the JAX package's
            cuts = sorted(set(rng.integers(0, n + 1, 4).tolist()) | {n})
            p = StrideRuns.encode(x[:cuts[0]], stride=stride)
            j = JC.StrideRuns.encode(x[:cuts[0]], stride=stride)
            for a, b in zip(cuts, cuts[1:]):
                p.extend_tail(x[a:b])
                j.extend_tail(x[a:b])
                assert_runs_equal(p, j, (tag, "extend", b))
                assert np.array_equal(p.decode(), x[:b])


@pytest.mark.parametrize("seed", [2, 13])
def test_join_equals_jax_and_join_rows(seed):
    rng = np.random.default_rng(seed)
    for trial in range(30):
        kind = (1, 2)[trial % 2]
        x = _random_column(rng, int(rng.integers(1, 300)), kind).astype(np.int64)
        if kind == 2:
            x = x + 1 + int(rng.integers(0, 100))  # a chain of positive keys
        cut = int(rng.integers(0, len(x)))
        r, jr = StrideRuns.encode(x[:cut]), JC.StrideRuns.encode(x[:cut])
        r.extend_tail(x[cut:])
        jr.extend_tail(x[cut:])
        assert r.is_sorted
        keys = rng.integers(int(x[0]) - 20, int(x[-1]) + 20, 200).astype(np.int64)
        keys = np.concatenate([keys, x[::5], [MISSING]])
        got = r.join(keys, MISSING)
        assert got.dtype == np.int32
        assert np.array_equal(got, jr.join(keys, MISSING))
        assert np.array_equal(got, join_rows(x, keys, MISSING))


def test_join_edge_cases():
    # runs: [5, 7] stride 2, the singleton 100 (stride 0), [1000..1002]
    # stride 1, the singleton 5000
    x = np.array([5, 7, 100, 1000, 1001, 1002, 5000], np.int64)
    r = StrideRuns.encode(x)
    assert r.run_count == len(r.strides) and 0 in r.strides.tolist()
    keys = np.array([
        -(1 << 40), 0, 4,  # below the first head
        5, 6, 7, 8,  # in a stride-2 run and between its strides
        99, 100, 101,  # around a stride-0 singleton
        999, 1000, 1002, 1003,  # a stride-1 run's ends
        4999, 5000, 5001, 1 << 50,  # the last run and above it
        MISSING,  # the missing value itself
    ], np.int64)
    got = r.join(keys, MISSING)
    assert np.array_equal(got, JC.StrideRuns.encode(x).join(keys, MISSING))
    assert np.array_equal(got, join_rows(x, keys, MISSING))
    assert got.tolist() == [-3, -3, -3, 0, -3, 1, -3, -3, 2, -3, -3, 3, 5, -3,
                            -3, 6, -3, -3, -3]
    empty = StrideRuns.encode(np.empty(0, np.int64))
    assert empty.join(keys, MISSING).tolist() == [MISSING] * len(keys)
    assert r.join(np.empty(0, np.int64), MISSING).shape == (0,)


def test_unsorted_column_refuses_join():
    for mod in (C, JC):
        r = mod.StrideRuns.encode(np.array([5, 3, 9], np.int64))
        assert not r.is_sorted
        with pytest.raises(ValueError, match="strictly sorted"):
            r.join(np.array([3], np.int64), -1)
    # a tail that steps back unsorts a sorted column, in both packages
    p = StrideRuns.encode(np.array([1, 2, 3], np.int64))
    j = JC.StrideRuns.encode(np.array([1, 2, 3], np.int64))
    p.extend_tail(np.array([3, 4], np.int64))
    j.extend_tail(np.array([3, 4], np.int64))
    assert_runs_equal(p, j)
    assert not p.is_sorted


# -- the image of a log -----------------------------------------------------------


def _text_blobs():
    from automerge_tpu import bench as JBench

    trace = JBench.load_trace(1500)
    base = JBench.build_base(trace, 1000)
    return [c.raw_bytes for c in base.changes + JBench.synth_fanin(base, trace, 8, 40, 1000)]


def _typing_blobs():
    trace = W.typing_trace(1500, seed=5)
    base = W.build_base(trace, 1000)
    return [c.raw_bytes for c in base.changes + W.synth_fanin(base, trace, 8, 40, 1000)]


def _record_blobs():
    base, reps, _ = W.record_store(128, 8, 20)
    return [c.raw_bytes for c in [base] + reps]


WORKLOADS = {"text": _text_blobs, "typing": _typing_blobs, "records": _record_blobs}


def logs_of(blobs):
    """The port's and the JAX package's log of the same change bytes."""
    return (OpLog.from_changes([parse_change(b)[0] for b in blobs]),
            JOpLog.from_changes(j_parse(blobs)))


def assert_images_equal(p, j, plog, jlog, tag=""):
    """Two ``CompressedOpColumns`` (port, JAX): every entry, cursor,
    demotion and figure."""
    assert set(p.entries) == set(j.entries), tag
    for name, ent in p.entries.items():
        if isinstance(ent, str):  # the dense marker
            assert j.entries[name] == ent == C._DENSE, (tag, name)
        else:
            assert_runs_equal(ent, j.entries[name], (tag, name))
    assert p.covered == j.covered and p.demoted == j.demoted, tag
    assert p.run_counts() == j.run_counts(), tag
    assert p.nbytes(plog) == j.nbytes(jlog), tag
    assert p.dense_nbytes(plog) == j.dense_nbytes(jlog), tag
    assert p.ratio(plog) == j.ratio(jlog), tag


def residency(obj):
    """A log's or a document's residency figures, in either package."""
    if hasattr(obj, "resident_nbytes"):
        return (obj.resident_nbytes(), obj.dense_nbytes(), obj.compress_ratio(),
                obj.resident_nbytes_estimate())
    return (obj.resident_column_nbytes(), obj.dense_column_nbytes(),
            obj.compress_ratio())


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_image_and_residency_equal_jax(name):
    plog, jlog = logs_of(WORKLOADS[name]())
    assert plog._comp is None
    assert plog.dense_column_nbytes() == jlog.dense_column_nbytes()
    assert plog._comp is None  # the dense arithmetic reads only
    p, j = plog.compressed(), jlog.compressed()
    assert_images_equal(p, j, plog, jlog, name)
    assert residency(plog) == residency(jlog)
    assert p.verify_against(plog) == [] and not p.all_dense(list(p.entries))
    assert plog.compressed(sync=False) is p  # kept, not encoded again
    # the figures count what is resident: the text logs compress
    if name != "records":
        assert plog.compress_ratio() > 2.0
    assert plog.resident_column_nbytes() < plog.dense_column_nbytes()
    # an unmaterialized column counts on neither side
    if plog.elem_key is None:
        assert "elem_key" not in p.entries and p.covered["elem_key"] == 0


def test_degenerate_columns_demote_as_in_jax():
    class FakeLog:
        pass

    rng = np.random.default_rng(5)
    n = 512
    log = FakeLog()
    log.n = n
    log.pred_src = np.empty(0, np.int32)
    log.pred_tgt = np.empty(0, np.int32)
    log.pred_key = np.empty(0, np.int64)
    for name, _, _ in C.ROW_SPEC:
        setattr(log, name, rng.integers(0, 1 << 30, n).astype(np.int64))
    log.insert = np.asarray(rng.integers(0, 2, n), np.bool_)
    log.expand = np.zeros(n, np.bool_)
    C.reset_stats()
    p = CompressedOpColumns().sync(log)
    j = JC.CompressedOpColumns().sync(log)
    assert_images_equal(p, j, log, log)
    demoted = sorted(k for k, v in p.run_counts().items() if v == -1)
    assert "id_key" in demoted and "action" in demoted and "insert" in demoted
    assert "expand" not in demoted  # one run
    assert C.stats()["compress_fallback"] == dict.fromkeys(demoted, 1)
    assert p.id_runs() is None and p.extend_id(np.array([1], np.int64)) is None
    assert p.nbytes(log) <= p.dense_nbytes(log)
    assert p.all_dense(demoted) and not p.all_dense(demoted + ["expand"])
    # a demoted column stays demoted as rows arrive: only its cursor moves
    log.n = n - 8
    p2 = CompressedOpColumns().sync(log)
    log.n = n
    p2.sync(log)
    assert p2.run_counts() == p.run_counts() and p2.covered == p.covered


def _serve_docs(n_docs=3, cycles=4, ops=8, ballast=60):
    base, deltas, texts = W.serve_workload(n_docs, cycles, ops, ballast)
    return base, deltas, texts


def _appending_cases():
    """(base change bytes, the deltas appended one after another): a
    served document (new editor, then tail appends by a known actor) and
    two documents of mixed edits delivered shuffled and twice."""
    base, deltas, _ = _serve_docs(n_docs=1, cycles=4)
    yield [base], [[x] for x in deltas[0]]
    bases, wdeltas = build_workload(7, n_docs=2, cycles=3)
    yield from zip(bases, wdeltas)


def test_residency_follows_every_append():
    """Each package's document from its base and after every append: the
    residency figures and the image equal the JAX package's."""
    for ci, (chs, batches) in enumerate(_appending_cases()):
        doc = DeviceDoc.merge(chs, device=CPU)
        jdoc = JDeviceDoc.resolve(JOpLog.from_changes(j_parse(chs)))
        assert doc.log._comp is None
        assert doc.resident_nbytes_estimate() == jdoc.resident_nbytes_estimate() \
            == doc.dense_nbytes()
        assert doc.log._comp is None  # the estimate reads only
        assert residency(doc) == residency(jdoc)
        assert residency(doc.log) == residency(jdoc.log)
        for k, batch in enumerate(batches):
            doc.apply_changes(batch)
            jdoc.apply_changes(j_parse(batch))
            tag = (ci, k)
            assert residency(doc) == residency(jdoc), tag
            assert doc.audit_columns() == jdoc.audit_columns() == [], tag
            assert_images_equal(doc.log._comp, jdoc.log._comp, doc.log,
                                jdoc.log, tag)


# -- the dense differential -------------------------------------------------------


def _per_doc_drain(bases, deltas, orders):
    """Each document applies its cycles' deltas in its own order; after
    every append the image (where one survives) decodes to the columns."""
    docs = [DeviceDoc.merge(b, device=CPU) for b in bases]
    for i, d in enumerate(docs):
        assert d.audit_columns() == []  # an image before the first remap
        for c in orders[i % len(orders)]:
            d.apply_changes(deltas[i][c])
            comp = d.log._comp
            if comp is not None:
                assert comp.verify_against(d.log) == [], (i, c)
            assert d.audit_columns() == [], (i, c)
    return docs


@pytest.mark.parametrize("seed", [4, 31])
def test_per_document_drain_dense_differential(monkeypatch, seed):
    bases, deltas = build_workload(seed, n_docs=3, cycles=4, dup=True)
    orders = ([2, 0, 1, 3], [1, 3, 0, 2], [0, 1, 2, 3])
    C.reset_stats()
    comp = _per_doc_drain(bases, deltas, orders)
    ovc = C.stats()["ovc_join"]
    monkeypatch.setattr(C, "ENABLED", False)
    dense = _per_doc_drain(bases, deltas, orders)
    assert all(d.log._comp is None for d in dense)
    assert C.stats()["ovc_join"] == ovc  # dense mode never joins over runs
    monkeypatch.setattr(C, "ENABLED", True)
    jax = jax_docs(bases)
    for i, d in enumerate(jax):
        for c in orders[i % len(orders)]:
            d.apply_changes(j_parse(deltas[i][c]))
    for i in range(len(bases)):
        assert_identical(comp[i], dense[i], i)
        assert_docs_equal(comp[i], jax[i], (i, "jax"))
        heads = comp[i].current_heads()
        assert comp[i].at(heads).hydrate() == dense[i].at(heads).hydrate()
    assert ovc > 0  # the offset-value-coded join ran in append_changes


def _cross_doc_drain(bases, deltas, cycles):
    docs = [DeviceDoc.merge(b, device=CPU) for b in bases]
    # an image on every base, which the first cycle's new editors (one
    # ranked below the base's actor) must drop
    assert all(d.audit_columns() == [] for d in docs)
    B.reset_stats()
    for c in range(cycles):
        B.apply_cross_doc([(d, [deltas[i][c]]) for i, d in enumerate(docs)],
                          device=CPU, max_docs_per_launch=2)
        for d in docs:
            comp = d.log._comp
            if comp is not None:
                assert comp.verify_against(d.log) == [], c
    s = B.stats()
    assert s["vectorized_docs"] > 0 and s["batched_error"] == 0, s
    return docs


@pytest.mark.parametrize("seed", [4, 23])
def test_cross_doc_drain_dense_differential(monkeypatch, seed):
    bases, deltas = build_workload(seed, n_docs=4, cycles=4, ballast=120)
    C.reset_stats()
    comp = _cross_doc_drain(bases, deltas, 4)
    ovc = C.stats()["ovc_join"]
    monkeypatch.setattr(C, "ENABLED", False)
    dense = _cross_doc_drain(bases, deltas, 4)
    assert C.stats()["ovc_join"] == ovc
    monkeypatch.setattr(C, "ENABLED", True)
    jax = jax_docs(bases)
    for c in range(4):
        JB.apply_cross_doc([(d, [j_parse(deltas[i][c])]) for i, d in enumerate(jax)],
                           max_docs_per_launch=2)
    for i in range(len(bases)):
        assert_identical(comp[i], dense[i], i)
        assert_docs_equal(comp[i], jax[i], (i, "jax"))
        assert comp[i].audit_columns() == []
        assert residency(comp[i]) == residency(jax[i])
    assert ovc > 0  # the offset-value-coded join ran in the staged splice


def test_staged_splice_joins_over_the_id_runs(monkeypatch):
    """``host_batch._splice_doc`` joins a tail delta by known actors over
    the id runs, and each answer is ``join_rows``'s over the column the
    runs stand for."""
    base, deltas, texts = _serve_docs(n_docs=2, cycles=3)
    docs = [DeviceDoc.merge([base], device=CPU) for _ in range(2)]
    joins = []
    real = StrideRuns.join

    def spy(self, keys, missing):
        out = real(self, keys, missing)
        joins.append((self.decode(), np.asarray(keys).copy(), out))
        return out

    monkeypatch.setattr(StrideRuns, "join", spy)
    for c in range(3):
        del joins[:]
        stages, results = host_batch.stage_docs(
            [(d, [[deltas[i][c]]]) for i, d in enumerate(docs)])
        assert all(r.vectorized and r.error is None for r in results.values())
        B.resolve_stages(stages, device=CPU)
        if c == 0:
            # new editors: the rank remap drops the image, nothing joins
            assert joins == [] and all(d.log._comp is None for d in docs)
        else:
            assert len(joins) >= 2 and all(d.log._comp is not None for d in docs)
        for ids, keys, out in joins:
            assert np.array_equal(out, join_rows(ids, keys, MISSING))
    assert [d.text(W.SERVE_LIVE) for d in docs] == texts
    for d in docs:
        assert d.audit_columns() == []


# -- what drops the image -----------------------------------------------------------


def _actor(i):
    return ActorId(bytes([i]) * 16)


def test_prefix_rewrites_drop_the_image():
    """A non-tail splice, a new actor and re-resolved MISSING references
    each leave ``_comp`` None; a tail append by a known actor keeps it,
    extended. The image encoded again afterwards decodes to the columns."""
    a = AutoDoc(actor=_actor(10))
    t = a.put_object("_root", "t", ObjType.TEXT)
    a.splice_text(t, 0, 0, "abc")
    a.commit()
    b = a.fork(actor=_actor(20))
    b.splice_text(t, 0, 0, "B")
    b.commit()
    a.merge(b)
    for k in range(6):  # a's counters run ahead of b's
        a.splice_text(t, 0, 0, "xyz")
        a.commit()
    b.splice_text(t, 1, 0, "late")  # b has not seen them: a low start_op
    b.commit()
    blobs_a = blobs_of(a)
    late = [x for x in blobs_of(b) if x not in blobs_a]
    c = a.fork(actor=_actor(30))
    c.splice_text(t, 0, 0, "C")
    c.commit()
    new_actor = [x for x in blobs_of(c) if x not in blobs_a]
    a.splice_text(t, 0, 0, "tail")
    a.commit()
    tail = [x for x in blobs_of(a) if x not in blobs_a]

    def fresh():
        log = OpLog.from_changes([parse_change(x)[0] for x in blobs_a])
        log.compressed()
        return log

    log = fresh()
    comp = log._comp
    info = log.append_changes([parse_change(x)[0] for x in tail])
    assert info.tail and not info.actors_changed
    assert log._comp is comp and comp.covered["id_key"] == log.n
    assert comp.verify_against(log) == []
    log = fresh()
    info = log.append_changes([parse_change(x)[0] for x in late])
    assert not info.tail and log._comp is None
    log = fresh()
    info = log.append_changes([parse_change(x)[0] for x in new_actor])
    assert info.actors_changed and log._comp is None
    # a partial history (the per-op log keeps the reference keys): a
    # change whose targets arrive after it
    p = AutoDoc(actor=_actor(40))
    pt = p.put_object("_root", "t", ObjType.TEXT)
    p.splice_text(pt, 0, 0, "abc")
    p.commit()
    p.splice_text(pt, 3, 0, "d")
    p.commit()
    first, second = [parse_change(x)[0] for x in blobs_of(p)]
    log = OpLog.from_changes([second], fast=False)
    log.compressed()
    assert log.n_miss_elem == 1
    info = log.append_changes([first])
    assert len(info.rere_elem_rows) == 1 and log.n_miss_elem == 0
    assert log._comp is None
    assert log.compressed().verify_against(log) == []
    full = OpLog.from_changes([first, second], fast=False)
    for name in ("id_key", "elem_ref", "obj_dense", "pred_tgt"):
        assert np.array_equal(getattr(log, name), getattr(full, name)), name


def test_ensure_ref_keys_then_tail_append_keeps_the_image_faithful():
    """An assembled log defers ``elem_key`` / ``pred_key``; its first
    append materializes them, and the image then encodes them from
    scratch."""
    base, deltas, texts = _serve_docs(n_docs=1, cycles=3)
    log = OpLog.from_changes([parse_change(base)[0]])
    assert log.elem_key is None
    log.compressed()
    for c in range(3):
        log.append_changes([parse_change(deltas[0][c])[0]])
        assert log.elem_key is not None
        if log._comp is not None:
            assert log._comp.verify_against(log) == []
        comp = log.compressed()
        assert "elem_key" in comp.entries and comp.verify_against(log) == []
    jlog = JOpLog.from_changes(j_parse([base]))
    jlog.compressed()
    for c in range(3):
        jlog.append_changes(j_parse([deltas[0][c]]))
        jlog.compressed()
    assert_images_equal(log._comp, jlog._comp, log, jlog)


def test_threads_estimate_while_the_owner_appends():
    """``resident_nbytes_estimate`` from other threads while the owner
    applies batches: it never creates or syncs the image."""
    import threading

    base, deltas, texts = _serve_docs(n_docs=1, cycles=4)
    doc = DeviceDoc.merge([base], device=CPU)
    seen, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            seen.append(doc.resident_nbytes_estimate())

    ts = [threading.Thread(target=reader) for _ in range(2)]
    for t in ts:
        t.start()
    try:
        for c in range(4):
            doc.apply_changes([deltas[0][c]])
    finally:
        stop.set()
        for t in ts:
            t.join()
    assert seen and doc._resident_cache is None
    assert doc.log._comp is None or doc.log._comp.entries.keys() <= {"id_key"}
    assert doc.text(W.SERVE_LIVE) == texts[0]
    r = doc.resident_nbytes()
    assert doc.resident_nbytes_estimate() == r < doc.dense_nbytes()


def test_random_interleaving_images_match_jax():
    """Random per-document deliveries in both packages, the image synced
    at random points on both sides alike: equal after every step."""
    rng = random.Random(9)
    bases, deltas = build_workload(17, n_docs=2, cycles=4, dup=False)
    for i, b in enumerate(bases):
        doc = DeviceDoc.merge(b, device=CPU)
        jdoc = JDeviceDoc.resolve(JOpLog.from_changes(j_parse(b)))
        for c in range(4):
            for x in deltas[i][c]:
                doc.apply_changes([x])
                jdoc.apply_changes(j_parse([x]))
                if rng.random() < 0.5:
                    doc.log.compressed()
                    jdoc.log.compressed()
                if doc.log._comp is None:
                    assert jdoc.log._comp is None
                else:
                    assert_images_equal(doc.log._comp, jdoc.log._comp,
                                        doc.log, jdoc.log, (i, c))
        assert residency(doc) == residency(jdoc)
