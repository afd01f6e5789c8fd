"""automerge_tpu_torch.workload against the JAX package's bench generator.

The port replays the trace into the base change without a document layer;
for the same trace and parameters it must yield the JAX helpers' changes
byte for byte (hence the same op columns), the same visible-element list,
and a text length the merge confirms.
"""

import numpy as np
import pytest

from automerge_tpu import bench as JB
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.oplog import OpLog

PARAMS = [
    # (trace edits, base edits, replicas, edits per replica)
    (3000, 2000, 16, 100),
    (800, 500, 8, 60),
    (400, 1, 4, 40),
    (600, 0, 3, 30),
]


def test_synthetic_trace_matches():
    assert W.load_trace(5000) == JB.load_trace(5000)


def test_trace_from_path(tmp_path):
    p = tmp_path / "edits.json"
    p.write_text('[[0, 0, "a"], [1, 0, "b", "c"], [0, 1]]')
    assert W.load_trace(path=str(p)) == [[0, 0, "a"], [1, 0, "b", "c"], [0, 1]]
    assert W.load_trace(2, path=str(p)) == [[0, 0, "a"], [1, 0, "b", "c"]]


@pytest.mark.parametrize("n_trace, n_base, n_rep, per", PARAMS)
def test_generator_matches_jax_helpers(n_trace, n_base, n_rep, per):
    trace = W.load_trace(n_trace)
    jb = JB.build_base(trace, n_base)
    tb = W.build_base(trace, n_base)
    assert [c.raw_bytes for c in tb.changes] == [c.raw_bytes for c in jb.changes]
    assert tb.heads == jb.heads and tb.max_op == jb.max_op
    assert tb.elems == jb.elems
    assert tb.text_exid == jb.text_exid
    jr = JB.synth_fanin(jb, trace, n_rep, per, n_base)
    tr = W.synth_fanin(tb, trace, n_rep, per, n_base)
    assert [c.raw_bytes for c in tr] == [c.raw_bytes for c in jr]
    cols_j = JOpLog.from_changes(jb.changes + jr).columns()
    cols_t = OpLog.from_changes(tb.changes + tr).columns()
    for k in cols_j:
        np.testing.assert_array_equal(cols_t[k], cols_j[k], err_msg=k)


def test_multi_character_edits_match_jax_helpers():
    trace = [[0, 0, "h", "e"], [2, 0, "llo"], [1, 2], [9, 0, "!"], [0, 9], [0, 0, "ok"]]
    jb = JB.build_base(trace, len(trace))
    tb = W.build_base(trace, len(trace))
    assert tb.changes[0].raw_bytes == jb.changes[0].raw_bytes
    assert tb.elems == jb.elems


@pytest.mark.parametrize("n_trace, n_base, n_rep, per", PARAMS[:2])
def test_expected_text_length_is_what_the_merge_shows(n_trace, n_base, n_rep, per):
    trace = W.load_trace(n_trace)
    base = W.build_base(trace, n_base)
    changes = base.changes + W.synth_fanin(base, trace, n_rep, per, n_base)
    want = W.expected_text_length(changes)
    assert len(DeviceDoc.from_changes(changes, device="cpu").text(base.text_exid)) == want
    jlog = JOpLog.from_changes(
        JB.build_base(trace, n_base).changes
        + JB.synth_fanin(JB.build_base(trace, n_base), trace, n_rep, per, n_base)
    )
    assert len(JDeviceDoc.resolve(jlog).text(base.text_exid)) == want


def test_unencoded_changes_encode_to_the_built_ones():
    trace = W.load_trace(1000)
    change, elems = W.base_change(trace, 700)
    base = W.build_base(trace, 700)
    assert elems == base.elems
    assert [(o.key, o.insert, o.action, o.pred) for o in change.ops] == [
        (o.key, o.insert, o.action, o.pred) for o in base.changes[0].ops]
    raw = W.fanin_changes(base, trace, 3, 50, 700)
    built = W.synth_fanin(base, trace, 3, 50, 700)
    assert [len(c.ops) for c in raw] == [len(c.ops) for c in built]
    assert all(c.hash is None for c in raw)


def _bench_serve_docs(n_docs, cycles, ops, ballast, tag=0):
    """``bench.py``'s ``sb_workload`` (:1196-1226, nested in its ``main``),
    through the JAX package's document layer: each editor's ``live`` and
    ``archive`` text after every cycle."""
    from automerge_tpu.api import AutoDoc
    from automerge_tpu.types import ActorId, ObjType

    out = []
    for i in range(n_docs):
        base = AutoDoc(actor=ActorId(bytes([21]) * 16))
        live = base.put_object("_root", "live", ObjType.TEXT)
        base.splice_text(live, 0, 0, "live seed text ")
        arch = base.put_object("_root", "archive", ObjType.TEXT)
        base.splice_text(arch, 0, 0, "x" * ballast)
        base.commit()
        ed = base.fork(actor=ActorId(bytes([31 + (tag & 1)]) + bytes([i % 250]) + bytes(14)))
        texts = []
        for c in range(cycles):
            ln = ed.length(live)
            for j in range(ops):
                ed.splice_text(live, (i + c * ops + j) % max(ln + j, 1), 0, "ab"[j % 2])
            ed.commit()
            texts.append((ed.text(live), ed.text(arch)))
        out.append((live, arch, texts))
    return out


@pytest.mark.parametrize("tag", [0, 1])
def test_serve_documents_read_as_the_bench_generator(tag):
    """The serve-shaped documents (``serve_workload``), loaded by the JAX
    package cycle by cycle, read the same ``live`` and ``archive`` texts as
    the bench's generator, and the port's merge the editor's own model."""
    from automerge_tpu.storage.change import parse_change as j_parse_change

    n_docs, cycles, ops, ballast = 3, 4, 6, 40
    base, deltas, texts = W.serve_workload(n_docs, cycles, ops, ballast, tag)
    bench = _bench_serve_docs(n_docs, cycles, ops, ballast, tag)
    for i, (live, arch, want) in enumerate(bench):
        assert (live, arch) == (W.SERVE_LIVE, W.SERVE_ARCHIVE)
        for c in range(cycles):
            blobs = [base] + deltas[i][: c + 1]
            jdoc = JDeviceDoc.resolve(JOpLog.from_changes([j_parse_change(b)[0]
                                                           for b in blobs]))
            assert (jdoc.text(live), jdoc.text(arch)) == want[c], (i, c)
        doc = DeviceDoc.merge([base] + deltas[i], device="cpu")
        assert doc.text(live) == texts[i] == want[-1][0]


def test_a_serve_burst_types_its_characters():
    base, deltas, texts = W.serve_workload(2, 3, 5, 10, burst={(1, 1): 37})
    lens = [len(t) for t in texts]
    assert lens == [len(W.SERVE_SEED) + 15, len(W.SERVE_SEED) + 5 + 37 + 5]
    doc = DeviceDoc.merge([base] + deltas[1], device="cpu")
    assert doc.text(W.SERVE_LIVE) == texts[1]
    assert doc.text(W.SERVE_ARCHIVE) == "x" * 10
