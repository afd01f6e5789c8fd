"""The port's ARSN run image (``storage/runsnap.py``) on the CPU, against
the JAX package's with exact equality.

A round trip gives a log column-equal to its source, with the source's
compressed image installed. The port's bytes equal the JAX package's for
the same changes (fan-ins of the text, typing and record workloads, a
document of mixed values, served documents after their appends), and
each package's ``parse(...).to_oplog()`` reads the other's. Dense mode
writes the flag clear and installs no image. Every corruption (a flipped
byte in each section, a CRC byte, truncations, a bad magic, a bad
version, a missing section, structural damage under a good CRC, a change
chunk whose checksum fails) gives the JAX package's ``RunSnapError``
message and ``verify_container`` dict. ``_load_changes`` gives what
``parse_change`` gives; ``RunImage.from_log`` what ``parse`` gives. A
document hydrated from an image equals its fan-in: resolved, as a view,
rebuilt and served.
"""

import zlib

import numpy as np
import pytest

from automerge_tpu.api import AutoDoc
from automerge_tpu.ops import batched as JB
from automerge_tpu.ops import compressed as JC
from automerge_tpu.ops import extract as JX
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.storage import runsnap as JR
from automerge_tpu.types import ActorId, ObjType
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.ops import batched as B
from automerge_tpu_torch.ops import compressed as C
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.oplog import OpLog
from automerge_tpu_torch.storage import runsnap as R
from automerge_tpu_torch.storage.change import parse_change
from automerge_tpu_torch.utils.leb128 import decode_uleb, uleb_bytes

from .test_torch_batched import assert_same, blobs_of, j_parse
from .test_torch_compressed import (
    WORKLOADS, assert_images_equal, assert_runs_equal, logs_of, residency,
)
from .test_torch_host_batch import assert_docs_equal, assert_logs_equal
from .test_torch_views import _norm

CPU = "cpu"


@pytest.fixture(autouse=True)
def cold_jax_change_cache(monkeypatch):
    """Each test starts with the JAX package's per-change-hash extraction
    cache empty, so both packages number map keys alike (ROADMAP §3)."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)


def _actor(i):
    return ActorId(bytes([i]) * 16)


def _mixed_blobs():
    """Text, maps, a list, floats, strings, bytes, booleans, null, a
    counter, a mark and deletes: every value kind in the heap."""
    d = AutoDoc(actor=_actor(1))
    t = d.put_object("_root", "t", ObjType.TEXT)
    lst = d.put_object("_root", "l", ObjType.LIST)
    for i in range(12):
        d.splice_text(t, d.length(t), 0, f"w{i} ")
        d.put("_root", f"k{i % 5}", i)
        d.insert(lst, 0, i * 1.5)
        d.commit()
    d.put("_root", "s", "str-value")
    d.put("_root", "b", b"\x00\x01")
    d.put("_root", "flag", True)
    d.put("_root", "none", None)
    d.mark(t, 1, 5, "bold", True)
    d.delete("_root", "k0")
    d.commit()
    e = d.fork(actor=_actor(9))
    e.splice_text(t, 2, 3, "XY")
    e.commit()
    d.merge(e)
    return blobs_of(d)


SOURCES = dict(WORKLOADS, mixed=_mixed_blobs)


def heads_of(changes):
    deps = {d for ch in changes for d in ch.dependencies}
    return [ch.hash for ch in changes if ch.hash not in deps]


def assert_installed(hyd, src, tag=""):
    """The image ``to_oplog`` installed on ``hyd`` is ``src``'s (either
    package), entry for entry; a sync, which adds the absent columns' zero
    cursors, changes no run."""
    comp = hyd._comp
    entries = dict(comp.entries)
    assert hyd.compressed() is comp
    assert all(comp.entries[k] is v for k, v in entries.items()), tag
    assert_images_equal(comp, src.compressed(), hyd, src, tag)


def assert_same_log(a, b, tag=""):
    """Two logs (either package) equal column for column, dtypes, the
    deferred columns and the unresolved-reference counts included."""
    for name, _, _ in C.ROW_SPEC + C.EDGE_SPEC:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, (tag, name)
            continue
        assert x.dtype == y.dtype and np.array_equal(x, y), (tag, name)
    assert np.array_equal(a.obj_table, b.obj_table) and a.n_objs == b.n_objs, tag
    assert (a.n, a.n_miss_elem, a.n_miss_pred) == (b.n, b.n_miss_elem, b.n_miss_pred)
    assert [x.bytes for x in a.actors] == [x.bytes for x in b.actors], tag
    assert (a.props, a.mark_names) == (b.props, b.mark_names), tag
    for f in ("code", "off", "ln"):
        x, y = getattr(a.values, f), getattr(b.values, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), (tag, f)
    assert bytes(a.values.raw) == bytes(b.values.raw), tag
    assert [ch.hash for ch in a.changes] == [ch.hash for ch in b.changes], tag


# -- the codec ----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_round_trip_equals_the_source(name):
    blobs = SOURCES[name]()
    changes = [parse_change(b)[0] for b in blobs]
    log = OpLog.from_changes(changes)
    heads = heads_of(changes)
    data = R.encode_snapshot(log, heads)
    assert R.is_runsnap(data) and data[5] == R.FLAG_COMPRESSED
    img = R.parse(data)
    assert (img.n, img.n_changes) == (log.n, len(changes))
    assert sorted(img.heads) == sorted(heads)
    assert [c.raw_bytes for c in img.changes] == blobs
    assert img.change_hashes() == [c.hash for c in changes]
    hyd = img.to_oplog()
    assert_same_log(hyd, log, name)
    # the source's image, installed as it was written, and faithful
    assert hyd._comp is not None and hyd._comp.verify_against(hyd) == []
    assert_installed(hyd, log, name)
    assert hyd._comp.entries["id_key"].starts is not img.cols["id_key"].starts
    assert residency(hyd) == residency(log)
    assert img.nbytes < len(data) and R.verify_container(data)["ok"]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_bytes_equal_jax_and_each_reads_the_other(name):
    blobs = SOURCES[name]()
    plog, jlog = logs_of(blobs)
    heads = heads_of(plog.changes)
    pb = R.encode_snapshot(plog, heads)
    jb = JR.encode_snapshot(jlog, heads)
    assert pb == jb
    from_jax = R.parse(jb).to_oplog()
    assert_same_log(from_jax, plog, name)
    assert_installed(from_jax, plog, name)
    from_port = JR.parse(pb).to_oplog()
    assert_same_log(from_port, jlog, name)
    assert_installed(from_jax, from_port, name)
    # an image written again from a hydrated log is the same image
    assert R.encode_snapshot(from_jax, heads) == pb
    assert JR.encode_snapshot(from_port, heads) == pb


def test_served_images_equal_jax_after_every_append():
    """Served documents in both packages, an image of each after each
    cycle (the first introduces the editors, later ones are tail appends
    over the extended id runs): the bytes agree, and the image read back
    by the other package equals its log."""
    base, deltas, texts = W.serve_workload(3, 4, 8, 60)
    docs = [DeviceDoc.merge([base], device=CPU) for _ in range(3)]
    jdocs = [JDeviceDoc.resolve(JOpLog.from_changes(j_parse([base]))) for _ in range(3)]
    for c in range(4):
        B.apply_cross_doc([(d, [[deltas[i][c]]]) for i, d in enumerate(docs)],
                          device=CPU)
        JB.apply_cross_doc([(d, [j_parse([deltas[i][c]])]) for i, d in enumerate(jdocs)])
        for i, (d, j) in enumerate(zip(docs, jdocs)):
            heads = d.current_heads()
            pb = R.encode_snapshot(d.log, heads)
            assert pb == JR.encode_snapshot(j.log, heads), (c, i)
            assert_same_log(JR.parse(pb).to_oplog(), j.log, (c, i))
            assert_images_equal(d.log._comp, j.log._comp, d.log, j.log, (c, i))
    assert [d.text(W.SERVE_LIVE) for d in docs] == texts


def test_dense_mode_writes_no_runs(monkeypatch):
    blobs = _mixed_blobs()
    plog, jlog = logs_of(blobs)
    heads = heads_of(plog.changes)
    compressed = R.encode_snapshot(plog, heads)
    monkeypatch.setattr(C, "ENABLED", False)
    monkeypatch.setenv("AUTOMERGE_TPU_COMPRESSED", "0")
    fresh, jfresh = logs_of(blobs)
    pb = R.encode_snapshot(fresh, heads)
    assert pb == JR.encode_snapshot(jfresh, heads)
    assert pb[5] & R.FLAG_COMPRESSED == 0 and fresh._comp is None
    img = R.parse(pb)
    assert not any(isinstance(v, R._RunCol) for v in img.cols.values())
    hyd = img.to_oplog()
    assert hyd._comp is None
    assert_same_log(hyd, plog)
    # a compressed image opened in dense mode installs no image either
    hyd = R.parse(compressed).to_oplog()
    assert hyd._comp is None
    assert_same_log(hyd, plog)
    assert R.RunImage.from_log(plog).flags == 0


def test_all_dense_image_skips_the_sync():
    """A log whose every live column is demoted writes dense without a
    sync (``STATS["dense_shortcut"]``), as the JAX package does."""
    plog, jlog = logs_of(_mixed_blobs())
    heads = heads_of(plog.changes)
    for log, mod in ((plog, C), (jlog, JC)):
        comp = log.compressed()
        for nm, _, _ in C.ROW_SPEC + C.EDGE_SPEC:
            if getattr(log, nm) is not None:
                comp.entries[nm] = mod._DENSE
    C.reset_stats()
    pb = R.encode_snapshot(plog, heads)
    assert C.stats()["dense_shortcut"] == 1
    assert pb == JR.encode_snapshot(jlog, heads)
    assert not any(isinstance(v, R._RunCol) for v in R.parse(pb).cols.values())


def test_missing_raw_bytes_raises():
    changes = [parse_change(b)[0] for b in _mixed_blobs()]
    log = OpLog.from_changes(changes)
    log.changes[0].raw_bytes = None
    with pytest.raises(R.RunSnapError, match="without raw chunk bytes"):
        R.encode_snapshot(log, [])
    log.changes[0].raw_bytes = b"x"
    with pytest.raises(R.RunSnapError, match="not 32 bytes"):
        R.encode_snapshot(log, [b"short"])


# -- corruption -----------------------------------------------------------------------


def _frames(data):
    """(tag, frame start, payload start, payload end) of each section."""
    out, pos = [], 6
    while pos < len(data):
        plen, body = decode_uleb(data, pos + 1)
        out.append((data[pos], pos, body, body + plen))
        pos = body + plen + 4
    return out


def _reframe(data, tag, payload):
    """``data`` with section ``tag``'s payload replaced, its CRC good."""
    out = bytearray(data[:6])
    for t, start, body, end in _frames(data):
        if t == tag:
            frame = bytes([t]) + uleb_bytes(len(payload)) + payload
            out += frame + zlib.crc32(frame).to_bytes(4, "little")
        else:
            out += data[start:end + 4]
    return bytes(out)


def _flip(data, at):
    bad = bytearray(data)
    bad[at] ^= 0xFF
    return bytes(bad)


def _corruptions(data):
    frames = _frames(data)
    cases = {}
    for tag, start, body, end in frames:
        name = R.SECTION_NAMES[tag]
        cases[f"{name} first payload byte"] = _flip(data, body)
        cases[f"{name} last payload byte"] = _flip(data, end - 1)
        cases[f"{name} crc"] = _flip(data, end)
        cases[f"{name} tag"] = _flip(data, start)
    for cut in (3, 5, 6, 7, frames[3][2] + 1, len(data) // 2, len(data) - 1):
        cases[f"truncated at {cut}"] = data[:cut]
    cases["bad magic"] = b"ARSX" + data[4:]
    cases["bad version"] = data[:4] + bytes([2]) + data[5:]
    t, start, body, end = frames[-1]
    cases["missing objtab"] = data[:start] + data[end + 4:]
    t, start, body, end = frames[0]
    cases["missing meta"] = data[:6] + data[end + 4:]
    runs = data[frames[4][2]:frames[4][3]]
    cases["runs unknown kind"] = _reframe(data, R.SEC_RUNS, bytes([9]) + runs[1:])
    cases["runs truncated"] = _reframe(data, R.SEC_RUNS, runs[:len(runs) // 3])
    meta = data[frames[0][2]:frames[0][3]]
    cases["meta row count"] = _reframe(data, R.SEC_META,
                                       uleb_bytes(decode_uleb(meta, 0)[0] + 1) + meta[1:])
    chs = data[frames[3][2]:frames[3][3]]
    n_ch, p = decode_uleb(chs, 0)
    _, p = decode_uleb(chs, p)
    raw_len, p = decode_uleb(chs, p)
    cases["change chunk checksum"] = _reframe(
        data, R.SEC_CHANGES, chs[:p + raw_len - 1] + bytes([chs[p + raw_len - 1] ^ 1])
        + chs[p + raw_len:])
    cases["unknown section"] = data + bytes([99, 1, 0]) + zlib.crc32(
        bytes([99, 1, 0])).to_bytes(4, "little")
    return cases


def _outcome(mod, data):
    """What ``parse`` then ``changes`` raise (class name and message) and
    what ``verify_container`` reports."""
    try:
        img = mod.parse(data)
        img.changes
        got = ("ok", None)
    except Exception as e:  # noqa: BLE001 - compared across packages
        got = (type(e).__name__, str(e))
    return got, mod.verify_container(data)


def test_corruptions_give_the_jax_answers():
    blobs = _mixed_blobs()
    plog, jlog = logs_of(blobs)
    data = R.encode_snapshot(plog, heads_of(plog.changes))
    assert data == JR.encode_snapshot(jlog, heads_of(plog.changes))
    assert _outcome(R, data) == _outcome(JR, data) == (
        ("ok", None), R.verify_container(data))
    cases = _corruptions(data)
    assert len(cases) >= 40
    refused = 0
    for name, bad in cases.items():
        got, want = _outcome(R, bad), _outcome(JR, bad)
        assert got == want, name
        if got[0][0] != "ok":
            refused += 1
            assert got[0][0] in ("RunSnapError", "ChunkParseError", "LEBDecodeError"), \
                (name, got)
    # every case but the forward-compatible unknown section is refused
    assert _outcome(R, cases["unknown section"])[0] == ("ok", None)
    assert refused == len(cases) - 1
    assert _outcome(R, cases["change chunk checksum"])[1]["reason"] == \
        "change 0: chunk checksum mismatch"
    assert _outcome(R, cases["runs unknown kind"])[0] == (
        "RunSnapError", "column action: unknown kind 9")


# -- the loaders ------------------------------------------------------------------------


HEADER = ("hash", "raw_bytes", "dependencies", "actor", "other_actors", "seq",
          "start_op", "timestamp", "message", "extra_bytes", "op_col_data")


@pytest.mark.parametrize("name", ["mixed", "records"])
def test_load_changes_gives_parse_change(name):
    blobs = SOURCES[name]()
    changes = [parse_change(b)[0] for b in blobs]
    img = R.parse(R.encode_snapshot(OpLog.from_changes(changes), []))
    loaded = img.changes
    assert img.changes is loaded  # decoded once
    jloaded = JR.parse(R.encode_snapshot(OpLog.from_changes(changes), [])).changes
    for got, want, jgot in zip(loaded, changes, jloaded):
        for f in HEADER:
            assert getattr(got, f) == getattr(want, f) == getattr(jgot, f), f
        assert len(got.ops) == len(want.ops) and got.cached_cols is None
        assert list(got.ops) == list(want.ops)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_from_log_equals_parse(name):
    log = OpLog.from_changes([parse_change(b)[0] for b in SOURCES[name]()])
    log.compressed()
    parsed = R.parse(R.encode_snapshot(log, []))
    img = R.RunImage.from_log(log)
    for f in ("version", "flags", "n", "q", "n_changes", "n_objs", "actors",
              "props", "mark_names", "heads"):
        assert getattr(img, f) == getattr(parsed, f), f
    assert img.cols.keys() == parsed.cols.keys()
    for k, v in img.cols.items():
        w = parsed.cols[k]
        if isinstance(v, R._RunCol):
            assert isinstance(w, R._RunCol) and (v.flags, v.dtype, v.rows) == \
                (w.flags, w.dtype, w.rows), k
            assert_runs_equal(v._runs(), w._runs(), k)
            assert v.starts is not log._comp.entries[k].starts
        elif v is None:
            assert w is None, k
        else:
            assert v.dtype == w.dtype and np.array_equal(v, w), k
    for a, b in zip(img.values[:3], parsed.values[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert img.values[3] == parsed.values[3]
    assert np.array_equal(img.obj_table, parsed.obj_table)
    assert_same_log(img.to_oplog(), parsed.to_oplog(), name)


# -- documents hydrated from images ---------------------------------------------------


def hydrate(doc, device=CPU):
    """A document opened cold from an image of ``doc``."""
    data = R.encode_snapshot(doc.log, doc.current_heads())
    return DeviceDoc.resolve(R.parse(data).to_oplog(), device=device)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_hydrated_document_equals_its_fan_in(name):
    blobs = SOURCES[name]()
    doc = DeviceDoc.merge(blobs, device=CPU)
    hyd = hydrate(doc)
    assert_docs_equal(hyd, doc, name)
    assert_same(hyd, doc, name)
    assert hyd.audit_columns() == [] and residency(hyd) == residency(doc)
    # views at a prefix's heads, and hydrate there
    cut = [parse_change(b)[0] for b in blobs[:max(1, len(blobs) // 3)]]
    heads = heads_of(cut)
    assert _norm(hyd.at(heads).hydrate()) == _norm(doc.at(heads).hydrate())
    assert _norm(hyd.hydrate(heads=heads)) == _norm(doc.hydrate(heads=heads))
    assert sorted(hyd.current_heads()) == sorted(doc.current_heads())
    # a re-delivered change is known through the loaded changes' hashes
    assert hyd.apply_changes(blobs[:2]) == 0
    # the rebuild re-extracts the loaded changes (no column cache on them)
    assert all(ch.cached_cols is None for ch in hyd.log.changes)
    hyd._rebuild(list(hyd.log.changes))
    assert_docs_equal(hyd, doc, (name, "rebuild"))
    jdoc = JDeviceDoc.resolve(JR.parse(R.encode_snapshot(doc.log, doc.current_heads()))
                              .to_oplog())
    assert_same(hyd, jdoc, (name, "jax"))


def test_hydrated_documents_serve_like_change_built_ones():
    """Served documents opened from images take the cross-document drain
    and the per-document apply exactly as change-built ones, with the
    offset-value-coded join on both append paths."""
    base, deltas, texts = W.serve_workload(4, 4, 8, 60)
    built = [DeviceDoc.merge([base], device=CPU) for _ in range(4)]
    staged = [hydrate(d) for d in built]
    single = [hydrate(d) for d in built]
    jdocs = [JDeviceDoc.resolve(JR.parse(R.encode_snapshot(d.log, d.current_heads()))
                                .to_oplog()) for d in built]
    ovc = {"staged": 0, "single": 0}
    for c in range(4):
        B.apply_cross_doc([(d, [[deltas[i][c]]]) for i, d in enumerate(built)],
                          device=CPU, max_docs_per_launch=2)
        C.reset_stats()
        B.apply_cross_doc([(d, [[deltas[i][c]]]) for i, d in enumerate(staged)],
                          device=CPU, max_docs_per_launch=2)
        ovc["staged"] += C.stats()["ovc_join"]
        C.reset_stats()
        for i, d in enumerate(single):
            d.apply_batches([[deltas[i][c]]])
        ovc["single"] += C.stats()["ovc_join"]
        JB.apply_cross_doc([(d, [j_parse([deltas[i][c]])]) for i, d in enumerate(jdocs)],
                           max_docs_per_launch=2)
        for i in range(4):
            assert_same(staged[i], built[i], (c, i, "staged"))
            assert_same(single[i], built[i], (c, i, "single"))
            assert_same(staged[i], jdocs[i], (c, i, "jax"))
    assert ovc["staged"] > 0 and ovc["single"] > 0, ovc
    for docs in (staged, single):
        assert [d.text(W.SERVE_LIVE) for d in docs] == texts
        assert all(d.audit_columns() == [] for d in docs)
    for a, b in zip(staged, built):
        assert_logs_equal(a.log, b.log)
