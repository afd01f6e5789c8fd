"""The whole fan-in slice: automerge_tpu_torch against automerge_tpu on the
same change bytes.

The JAX package builds the changes (its bench fan-in generator, and a
distinct-character multi-replica document); both packages parse the same
bytes. Their op columns must be equal, the port's merge (plain PyTorch on
the CPU) must give the JAX ``merge_kernel``'s 13 outputs exactly, and the
port's ``DeviceDoc`` reads must agree with the JAX ``DeviceDoc``'s.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from automerge_tpu import bench as JB
from automerge_tpu.api import AutoDoc
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.merge import ALL_OUTPUTS as J_ALL_OUTPUTS
from automerge_tpu.ops.merge import merge_kernel as j_merge_kernel
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu.types import ActorId, ObjType, ScalarValue
from automerge_tpu_torch.convert import columns_from_numpy
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.merge import ALL_OUTPUTS, merge_columns, merge_kernel
from automerge_tpu_torch.ops.oplog import OpLog
from automerge_tpu_torch.storage.change import parse_change


def _fanin():
    trace = JB.load_trace(3000)
    base = JB.build_base(trace, 2000)
    reps = JB.synth_fanin(base, trace, 16, 125, 2000)
    return [c.raw_bytes for c in base.changes + reps], [("text", base.text_exid)], []


def _distinct_chars():
    """Like the JAX package's example workload: forks splice distinct
    characters into one text and increment one counter."""
    base = AutoDoc(actor=ActorId(bytes([1]) * 16))
    text = base.put_object("_root", "text", ObjType.TEXT)
    base.splice_text(text, 0, 0, "the quick brown fox")
    base.put("_root", "counter", ScalarValue("counter", 0))
    base.commit()
    forks = [base.fork(actor=ActorId(bytes([10 + i]) * 16)) for i in range(6)]
    for i, f in enumerate(forks):
        for j in range(8):
            f.splice_text(text, (i + j) % f.length(text), 1 if j % 3 else 0, f"{i}")
        f.increment("_root", "counter", i + 1)
        f.put("_root", f"by{i}", i)
        f.put("_root", "last", f"fork {i}")
        f.commit()
    blobs = []
    seen = set()
    for f in forks:
        for a in f.doc.history:
            if a.stored.hash not in seen:
                seen.add(a.stored.hash)
                blobs.append(a.stored.raw_bytes)
    return blobs, [("text", text)], ["counter", "last", "by0", "by5", "missing"]


SCENARIOS = {"fanin_2k_x16": _fanin, "distinct_chars": _distinct_chars}


@functools.lru_cache(maxsize=None)
def _scenario(name):
    blobs, seqs, keys = SCENARIOS[name]()
    jlog = JOpLog.from_changes([j_parse_change(b)[0] for b in blobs])
    tlog = OpLog.from_changes([parse_change(b)[0] for b in blobs])
    return blobs, seqs, keys, jlog, tlog


@pytest.fixture(params=sorted(SCENARIOS))
def scenario(request):
    return _scenario(request.param)


def test_same_bytes_same_changes(scenario):
    blobs, _, _, jlog, tlog = scenario
    for b in blobs:
        j, t = j_parse_change(b)[0], parse_change(b)[0]
        assert t.hash == j.hash and t.raw_bytes == j.raw_bytes == b
        assert (t.actor, t.seq, t.start_op, t.dependencies) == (
            j.actor, j.seq, j.start_op, j.dependencies)
        assert [(o.obj, o.key.prop, o.key.elem, o.insert, o.action, tuple(o.value),
                 o.pred, o.expand, o.mark_name) for o in t.ops] == [
                (o.obj, o.key.prop, o.key.elem, o.insert, o.action, tuple(o.value),
                 o.pred, o.expand, o.mark_name) for o in j.ops]


def test_oplog_columns_equal(scenario):
    _, _, _, jlog, tlog = scenario
    assert (tlog.n, tlog.n_objs) == (jlog.n, jlog.n_objs)
    assert tlog.props == list(jlog.props)
    assert [a.bytes for a in tlog.actors] == [a.bytes for a in jlog.actors]
    np.testing.assert_array_equal(tlog.id_key, jlog.id_key)
    for cols_j, cols_t in ((jlog.columns(), tlog.columns()),
                           (jlog.padded_columns(), tlog.padded_columns())):
        assert set(cols_j) == set(cols_t)
        for k in cols_j:
            assert cols_t[k].dtype == cols_j[k].dtype, k
            np.testing.assert_array_equal(cols_t[k], cols_j[k], err_msg=k)


def test_merge_outputs_equal_reference(scenario):
    _, _, _, jlog, tlog = scenario
    ref = j_merge_kernel({k: jnp.asarray(v) for k, v in jlog.padded_columns().items()})
    assert ALL_OUTPUTS == J_ALL_OUTPUTS and len(ALL_OUTPUTS) == 13
    got = merge_columns(tlog.columns(), device="cpu")
    direct = merge_kernel(columns_from_numpy(tlog.padded_columns(), "cpu"),
                          tlog.n_objs, len(tlog.props))
    for k in ALL_OUTPUTS:
        want = np.asarray(ref[k])
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
        np.testing.assert_array_equal(direct[k].numpy(), want, err_msg=k)


def test_device_doc_reads_agree(scenario):
    blobs, seqs, keys, jlog, _ = scenario
    jdoc = JDeviceDoc.resolve(jlog)
    doc = DeviceDoc.merge(blobs, device="cpu")
    for _, obj in seqs:
        assert doc.text(obj) == jdoc.text(obj)
        assert doc.length(obj) == jdoc.length(obj)
        assert doc.list_items(obj) == jdoc.list_items(obj)
        for pos in (0, 3, doc.length(obj) - 1, doc.length(obj) + 5):
            assert doc.get(obj, pos) == jdoc.get(obj, pos)
            assert doc.get_all(obj, pos) == jdoc.get_all(obj, pos)
    assert doc.keys() == jdoc.keys()
    assert doc.map_entries() == jdoc.map_entries()
    assert doc.length() == jdoc.length()
    for k in keys:
        assert doc.get("_root", k) == jdoc.get("_root", k)
        assert doc.get_all("_root", k) == jdoc.get_all("_root", k)
    for name, obj in seqs:
        assert doc.object_type(obj) == jdoc.object_type(obj)
        assert doc.get("_root", name) == jdoc.get("_root", name)


def test_merge_is_order_and_duplicate_independent(scenario):
    blobs, seqs, _, _, _ = scenario
    doc = DeviceDoc.merge(blobs, device="cpu")
    shuffled = [blobs[i] for i in np.random.default_rng(1).permutation(len(blobs))]
    again = DeviceDoc.merge(shuffled + blobs[:3], device="cpu")
    for _, obj in seqs:
        assert again.text(obj) == doc.text(obj)
    assert again.map_entries() == doc.map_entries()


def test_merge_phases_are_recorded():
    blobs, seqs, _, _, _ = _scenario("distinct_chars")
    phases = {}
    DeviceDoc.merge(blobs, device="cpu", phases=phases)
    assert set(phases) == {
        "parse", "oplog", "pad", "encode", "h2d", "expand", "succ_vis",
        "scatter_winners", "forest", "linearize", "readback",
        "h2d_bytes", "h2d_dense_bytes", "d2h_bytes",
    }
    assert all(v >= 0 for v in phases.values())
    # run-native staging copies run tables, not the dense columns
    assert 0 < phases["h2d_bytes"] < phases["h2d_dense_bytes"]


@pytest.mark.parametrize("encoding", ["unicode", "utf8", "utf16"])
def test_width_column_follows_text_encoding(encoding):
    from automerge_tpu.types import using_text_encoding as j_using
    from automerge_tpu_torch.types import using_text_encoding

    doc = AutoDoc(actor=ActorId(bytes([4]) * 16))
    t = doc.put_object("_root", "t", ObjType.TEXT)
    doc.splice(t, 0, 0, ["a", "é", "😀", "xyz"])
    doc.commit()
    blobs = [a.stored.raw_bytes for a in doc.doc.history]
    with j_using(encoding):
        jlog = JOpLog.from_changes([j_parse_change(b)[0] for b in blobs])
    with using_text_encoding(encoding):
        tlog = OpLog.from_changes([parse_change(b)[0] for b in blobs])
    np.testing.assert_array_equal(tlog.width, jlog.width)
    doc_t = DeviceDoc.resolve(tlog, device="cpu")
    assert doc_t.length(t) == JDeviceDoc.resolve(jlog).length(t)
