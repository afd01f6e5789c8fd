"""Durable storage in the port (``storage/journal.py``, ``storage/durable.py``,
``storage/crashsim.py``, ``Document.open`` / ``AutoDoc.open``) against the
JAX package's, on the CPU.

Differential cases first: seeded journal records give byte-identical
journal files and the same scans of seeded torn tails, corrupt middles and
corrupt headers; a seeded durable session (commits, merges,
``load_incremental``, meta records, compactions at small thresholds) run
through both packages' ``AutoDoc.open`` writes identical ``snapshot.am``
and ``journal.waj`` after every ack, and each package reopens the other's
directory to the same heads, digest, read and salvage report, with the
run-coded snapshot, the legacy one (``AUTOMERGE_TPU_RUNSNAP=0``), dense
residency (``AUTOMERGE_TPU_COMPRESSED=0``), no snapshot, and a damaged
one. The port's resident mirror (``mirror=True, device="cpu"``) equals the
reference's (``device=True``) array for array after the open, the journal
replay, a demotion and a promotion, and the recovery counters agree. Then
the narrowed ``except``s (each lets a foreign error through) and the
salvage handler (no merge runs inside it).

The reference's ``tests/test_durability.py`` follows, ported to the
port's modules: the journal's unit cases, the ``SimFS`` crash sweeps (the
sampled ones here, the full ones ``slow`` as in the reference),
compaction, snapshot damage, the mirror's warm recovery, group commit and
the live disk faults. Their documents run on the CPU (``AutoDoc`` below).
"""

import os
import random
import shutil

import numpy as np
import pytest

import automerge_tpu.api as RA
import automerge_tpu.types as RT
from automerge_tpu import obs as robs
from automerge_tpu.storage import journal as RJ
import automerge_tpu_torch.types as PT
from automerge_tpu_torch import obs as pobs
from automerge_tpu_torch import trace
from automerge_tpu_torch.api import AutoDoc as _PortAutoDoc
from automerge_tpu_torch.core.document import Document as PDocument
from automerge_tpu_torch.native import NativeUnavailable
from automerge_tpu_torch.ops.device_doc import DeviceDoc as PDeviceDoc
from automerge_tpu_torch.storage import durable as PD
from automerge_tpu_torch.storage import journal as PJ
from automerge_tpu_torch.storage import runsnap as PR
from automerge_tpu_torch.storage.crashsim import CrashPoint, SimFS
from automerge_tpu_torch.storage.journal import (
    JOURNAL_MAGIC,
    Journal,
    REC_CHANGE,
    REC_META,
    decode_meta,
    encode_meta,
    encode_record,
    scan_records,
)
from automerge_tpu_torch.types import ActorId, ObjType


class AutoDoc(_PortAutoDoc):
    """The port's ``AutoDoc`` with its merges on the CPU unless told
    otherwise (the port's own default is the card)."""

    def __init__(self, actor=None, document=None, text_encoding=None,
                 device="cpu"):
        super().__init__(actor, document, text_encoding, device=device)

    @classmethod
    def open(cls, path, **kw):
        kw.setdefault("device", "cpu")
        return super().open(path, **kw)

    @classmethod
    def load(cls, data, *a, **kw):
        kw.setdefault("device", "cpu")
        return super().load(data, *a, **kw)


@pytest.fixture(autouse=True)
def _fresh_obs():
    robs.reset_all()
    pobs.reset_all()
    yield


@pytest.fixture(autouse=True)
def _reference_decodes_fresh(monkeypatch):
    """The reference's logs number props in the order of its per-change
    key tables, which keep the key table of whatever batch first decoded
    the change (ROADMAP §3): a snapshot's prop table then depends on the
    process's history. Its column builds here start from changes with no
    such residue, as the port's always do, so that both write the same
    bytes."""
    import automerge_tpu.ops.extract as RX
    from automerge_tpu.ops.oplog import OpLog as ROpLog

    real_from, real_append = ROpLog.from_changes.__func__, ROpLog.append_changes

    def scrub(changes):
        changes = list(changes)
        for c in changes:
            if hasattr(c, "cached_cols"):
                c.cached_cols = None
        if RX._CHANGE_COLS_CACHE is not None:
            RX._CHANGE_COLS_CACHE.clear()
        return changes

    monkeypatch.setattr(ROpLog, "from_changes", classmethod(
        lambda cls, changes, fast=None: real_from(cls, scrub(changes), fast)))
    monkeypatch.setattr(ROpLog, "append_changes",
                        lambda self, changes: real_append(self, scrub(changes)))


def norm(x):
    """A value of either package as plain, comparable data."""
    import dataclasses
    import enum

    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if hasattr(x, "tag") and hasattr(x, "value") and hasattr(x, "to_py"):
        return ("scalar", x.tag, norm(x.value))
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    return x


def ctr(obs_mod, name, label=None):
    """A counter's total (``label`` None) or its values by one label."""
    if label is not None:
        return obs_mod.counter_values(name, label)
    return sum(
        e["value"] for e in obs_mod.snapshot()
        if e["type"] == "counter" and e["name"] == name
    )


def assert_same_mirror(dev, other, where=""):
    """The port's mirror equals the reference's on every READ_FETCH
    array, hydrate and heads."""
    n = dev.log.n
    assert (n, dev.log.n_objs) == (other.log.n, other.log.n_objs), where
    for k in PDeviceDoc.READ_FETCH:
        cut = dev.log.n_objs + 2 if k.startswith("obj_") else n
        np.testing.assert_array_equal(np.asarray(dev.res[k])[:cut],
                                      np.asarray(other.res[k])[:cut],
                                      err_msg=f"{where} {k}")
    assert norm(dev.hydrate()) == norm(other.hydrate()), where
    assert sorted(dev.current_heads()) == sorted(other.current_heads()), where


# -- the journal, byte for byte -------------------------------------------------


def seeded_records(seed, n=24):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if rng.random() < 0.25:
            name = f"sync/peer{int(rng.integers(0, 4))}"
            out.append((REC_META, encode_meta(name, rng.bytes(int(rng.integers(0, 40))))))
        else:
            out.append((REC_CHANGE, rng.bytes(int(rng.integers(0, 300)))))
    return out


def write_journal(mod, path, records):
    j, _, _ = mod.Journal.open(path, fsync="never")
    for rec_type, payload in records:
        j.append(rec_type, payload)
    j.close()
    with open(path, "rb") as f:
        return f.read()


def rec_tuples(records):
    return [(r.rec_type, r.payload, r.offset, r.end) for r in records]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_journal_files_byte_identical_and_cross_read(tmp_path, seed):
    recs = seeded_records(seed)
    rpath, ppath = str(tmp_path / "r.waj"), str(tmp_path / "p.waj")
    rbytes = write_journal(RJ, rpath, recs)
    pbytes = write_journal(PJ, ppath, recs)
    assert rbytes == pbytes
    # each package reads the other's journal
    for mod, path in ((PJ, rpath), (RJ, ppath)):
        j, got, tail = mod.Journal.open(path)
        assert [(r.rec_type, r.payload) for r in got] == recs
        assert not tail.torn and j.record_count == len(recs)
        j.close()
    for rec_type, payload in recs:
        assert PJ.encode_record(rec_type, payload) == RJ.encode_record(rec_type, payload)
        if rec_type == REC_META:
            assert PJ.decode_meta(payload) == RJ.decode_meta(payload)


def damage(data, kind, rng):
    """One seeded damage of a journal file."""
    b = bytearray(data)
    if kind == "torn":
        return bytes(b[: len(b) - int(rng.integers(1, 40))])
    if kind == "middle":
        i = int(rng.integers(len(JOURNAL_MAGIC) + 8, len(b) - 8))
        b[i] ^= 0x5A
        return bytes(b)
    if kind == "header":
        b[int(rng.integers(0, len(JOURNAL_MAGIC)))] ^= 0x01
        return bytes(b)
    if kind == "type":
        # an unknown record type where the second record starts
        first = RJ.scan_records(data)[0][0]
        b[first.end + 4] = 7
        return bytes(b)
    if kind == "garbage":
        return bytes(b) + rng.bytes(int(rng.integers(1, 30)))
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["torn", "middle", "header", "type", "garbage"])
@pytest.mark.parametrize("seed", [3, 4])
def test_journal_scans_agree_on_damage(tmp_path, kind, seed):
    rng = np.random.default_rng(seed)
    data = write_journal(RJ, str(tmp_path / "r.waj"), seeded_records(seed))
    bad = damage(data, kind, rng)
    for fn in ("scan_records",):
        r_recs, r_tail = getattr(RJ, fn)(bad)
        p_recs, p_tail = getattr(PJ, fn)(bad)
        assert rec_tuples(p_recs) == rec_tuples(r_recs)
        assert tuple(p_tail) == tuple(r_tail)
        assert (p_tail.torn, p_tail.dropped_bytes) == (r_tail.torn, r_tail.dropped_bytes)
    assert rec_tuples(PJ.salvage_header_scan(bad)) == rec_tuples(RJ.salvage_header_scan(bad))
    seq = bad[len(JOURNAL_MAGIC):]
    outs = []
    for mod in (RJ, PJ):
        try:
            outs.append(("ok", rec_tuples(mod.scan_record_seq(seq))))
        except mod.JournalError as e:
            outs.append(("raised", str(e)))
    assert outs[0] == outs[1]
    # the open's recovery: the same records, the same rewritten file and
    # the same bytes dropped
    files = {}
    for name, mod, ob in (("r", RJ, robs), ("p", PJ, pobs)):
        path = str(tmp_path / f"{name}-bad.waj")
        with open(path, "wb") as f:
            f.write(bad)
        j, got, tail = mod.Journal.open(path)
        j.close()
        with open(path, "rb") as f:
            files[name] = (rec_tuples(got), tuple(tail), f.read(),
                           ctr(ob, "journal.truncated_tail"))
    assert files["p"] == files["r"]


# -- the durable document, both packages ---------------------------------------

ACTOR = bytes([1]) * 16
PEER = bytes([9]) * 16


class Typed:
    """An argument made of each package's own types."""

    def __init__(self, what):
        self.what = what


def _typed(a, T):
    if not isinstance(a, Typed):
        return a
    if a.what == "counter":
        return T.ScalarValue("counter", 0)
    return getattr(T.ObjType, a.what)


class DurablePair:
    """One seeded session through the reference's durable AutoDoc and the
    port's, in two directories; ``step`` acks and compares the files."""

    def __init__(self, tmp_path, seed, **kw):
        self.rdir, self.pdir = str(tmp_path / "ref"), str(tmp_path / "port")
        self.kw = kw
        self.rng = np.random.default_rng(seed)
        self.ts = 1_000
        self.ref = RA.AutoDoc.open(self.rdir, actor=RT.ActorId(ACTOR), **kw)
        self.port = AutoDoc.open(self.pdir, actor=ActorId(ACTOR), **kw)
        self.rpeer = RA.AutoDoc(actor=RT.ActorId(PEER))
        self.ppeer = AutoDoc(actor=ActorId(PEER))
        self.text = self.both("put_object", "_root", "text", Typed("TEXT"))
        self.list = self.both("put_object", "_root", "list", Typed("LIST"))
        self.both("put", "_root", "count", Typed("counter"))
        self.commit()

    def both(self, name, *args):
        out = [getattr(doc, name)(*[_typed(a, T) for a in args])
               for doc, T in ((self.ref, RT), (self.port, PT))]
        assert norm(out[0]) == norm(out[1]), (name, args)
        return out[1]

    def commit(self):
        self.ts += 1
        hr = self.ref.commit(timestamp=self.ts)
        hp = self.port.commit(timestamp=self.ts)
        assert hr == hp
        self.check_files()

    def check_files(self):
        for name in (PD.SNAPSHOT_NAME, PD.JOURNAL_NAME):
            rp, pp = os.path.join(self.rdir, name), os.path.join(self.pdir, name)
            assert os.path.exists(rp) == os.path.exists(pp), name
            if os.path.exists(rp):
                with open(rp, "rb") as a, open(pp, "rb") as b:
                    assert a.read() == b.read(), name

    def peer_edit(self, n):
        for _ in range(n):
            k = f"p{int(self.rng.integers(0, 6))}"
            v = int(self.rng.integers(-50, 50))
            self.rpeer.put("_root", k, v)
            self.ppeer.put("_root", k, v)
            self.ts += 1
            assert self.rpeer.commit(timestamp=self.ts) == self.ppeer.commit(timestamp=self.ts)

    def step(self, i):
        kind = int(self.rng.integers(0, 8))
        if kind == 0:
            self.both("put", "_root", f"k{int(self.rng.integers(0, 8))}",
                      int(self.rng.integers(-1000, 1000)))
        elif kind == 1:
            n = self.port.length(self.text)
            pos = int(self.rng.integers(0, n + 1))
            self.both("splice_text", self.text, pos, 0, f"w{i} ")
        elif kind == 2:
            n = self.port.length(self.list)
            self.both("insert", self.list, int(self.rng.integers(0, n + 1)), i)
        elif kind == 3:
            self.both("increment", "_root", "count", int(self.rng.integers(1, 5)))
        elif kind == 4:
            self.peer_edit(2)
            self.ref.merge(self.rpeer)
            self.port.merge(self.ppeer)
            self.check_files()
            return
        elif kind == 5:
            heads = self.port.get_heads()
            self.peer_edit(2)
            rb = self.rpeer.save_incremental_after(heads)
            pb = self.ppeer.save_incremental_after(heads)
            assert rb == pb
            self.ref.load_incremental(rb)
            self.port.load_incremental(pb)
            self.check_files()
            return
        elif kind == 6:
            name, blob = f"sync/p{int(self.rng.integers(0, 3))}", self.rng.bytes(8)
            self.ref.set_meta(name, blob)
            self.port.set_meta(name, blob)
            self.check_files()
            return
        else:
            self.peer_edit(1)
            self.ref.apply_changes(self.rpeer.get_changes(self.ref.get_heads()))
            self.port.apply_changes(self.ppeer.get_changes(self.port.get_heads()))
            self.check_files()
            return
        self.commit()

    def close(self):
        self.ref.close()
        self.port.close()
        self.check_files()


def facts(dd):
    return {
        "heads": sorted(dd.get_heads()),
        "digest": dd.doc_digest(),
        "hydrate": norm(dd.hydrate()),
        "salvage": norm(dd.doc.salvage_report),
        "meta": dd.meta,
        "queue": sorted(c.hash for c in dd.doc.queue),
    }


MODES = {
    "arsn": ({}, 5),
    "legacy": ({"AUTOMERGE_TPU_RUNSNAP": "0"}, 5),
    "dense": ({"AUTOMERGE_TPU_COMPRESSED": "0"}, 5),
    "no_snapshot": ({}, 1 << 30),
    "damaged": ({}, 5),
}


def run_session(tmp_path, monkeypatch, mode, seed, steps=30):
    env, threshold = MODES[mode]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pair = DurablePair(tmp_path, seed, fsync="always",
                       compact_max_records=threshold)
    for i in range(steps):
        pair.step(i)
    if threshold < (1 << 30):
        pair.ref.compact()
        pair.port.compact()
        pair.check_files()
        # a tail that stays in the journal
        for i in range(3):
            pair.both("put", "_root", f"tail{i}", i)
            pair.commit()
    pair.close()
    if mode == "damaged":
        for d in (pair.rdir, pair.pdir):
            p = os.path.join(d, PD.SNAPSHOT_NAME)
            data = bytearray(open(p, "rb").read())
            data[len(data) // 2] ^= 0xFF
            open(p, "wb").write(bytes(data))
    return pair


@pytest.mark.parametrize("mode", sorted(MODES))
def test_durable_session_byte_identical_and_cross_open(tmp_path, monkeypatch, mode):
    pair = run_session(tmp_path, monkeypatch, mode, seed=11)
    has_snap = os.path.exists(os.path.join(pair.rdir, PD.SNAPSHOT_NAME))
    assert has_snap == (mode != "no_snapshot")
    got = {}
    for writer, d in (("ref", pair.rdir), ("port", pair.pdir)):
        for reader, opener in (("ref", RA.AutoDoc.open), ("port", AutoDoc.open)):
            # a copy each: an open may truncate or rewrite what it reads
            cp = str(tmp_path / f"{writer}-by-{reader}")
            shutil.copytree(d, cp)
            dd = opener(cp)
            got[(writer, reader)] = facts(dd)
            dd.close()
    first = got[("ref", "ref")]
    for key, f in got.items():
        assert f == first, key
    if mode == "damaged":
        assert first["salvage"] is not None


@pytest.mark.parametrize("mode", ["arsn", "legacy", "no_snapshot"])
def test_mirror_equals_reference_after_open_replay_and_promotion(
        tmp_path, monkeypatch, mode):
    pair = run_session(tmp_path, monkeypatch, mode, seed=5, steps=20)
    robs.reset_all()
    pobs.reset_all()
    rd = RA.AutoDoc.open(pair.rdir, device=True)
    pd = AutoDoc.open(pair.pdir, mirror=True)
    assert pd.device_doc.device.type == "cpu"
    assert_same_mirror(pd.device_doc, rd.device_doc, f"{mode} open")
    assert norm(pd.device_doc.hydrate()) == norm(pd.hydrate())
    # the demotion keeps the run image; the promotion decodes it
    rd.drop_device_mirror()
    pd.drop_device_mirror()
    assert pd.device_doc is None
    rdev, pdev = rd.build_device_mirror(), pd.build_device_mirror()
    assert_same_mirror(pdev, rdev, f"{mode} promote")
    assert pdev.audit_columns() == [] == rdev.audit_columns()
    for name in ("journal.replayed_records", "journal.rejected_records",
                 "oplog.hydrate_reencode", "compact.runs",
                 "compact.image_rebuild", "store.promote_resident_bytes"):
        assert ctr(pobs, name) == ctr(robs, name), name
    assert (ctr(pobs, "store.hydrate_bytes", "codec")
            == ctr(robs, "store.hydrate_bytes", "codec"))
    assert ctr(pobs, "journal.replayed_records") > 0
    rd.close()
    pd.close()


def test_recovery_counters_equal_on_compaction_and_rejected_records(
        tmp_path, monkeypatch):
    """A CRC-valid journal record whose chunk does not parse is counted
    and skipped by both; compaction counts the same runs and rebuilds."""
    pair = run_session(tmp_path, monkeypatch, "legacy", seed=8, steps=12)
    for d in (pair.rdir, pair.pdir):
        with open(os.path.join(d, PD.JOURNAL_NAME), "ab") as f:
            f.write(encode_record(REC_CHANGE, b"\x85\x6f\x4a\x83 not a chunk"))
    robs.reset_all()
    pobs.reset_all()
    monkeypatch.delenv("AUTOMERGE_TPU_RUNSNAP")
    rd = RA.AutoDoc.open(pair.rdir)
    pd = AutoDoc.open(pair.pdir)
    rd.compact()
    pd.compact()
    for name in ("journal.replayed_records", "journal.rejected_records",
                 "compact.runs", "compact.image_rebuild",
                 "oplog.hydrate_reencode"):
        assert ctr(pobs, name) == ctr(robs, name), name
    assert ctr(pobs, "journal.rejected_records") == 1
    assert ctr(pobs, "compact.image_rebuild") == 1
    for name in (PD.SNAPSHOT_NAME, PD.JOURNAL_NAME):
        with open(os.path.join(pair.rdir, name), "rb") as a, \
                open(os.path.join(pair.pdir, name), "rb") as b:
            assert a.read() == b.read(), name
    rd.close()
    pd.close()


def test_replicated_apply_feeds_the_follower_mirror(tmp_path):
    """``apply_replicated_snapshot`` then ``apply_replicated(...,
    device_feed=)``: the feed gets ``(doc, dev, changes)`` after the
    durable apply, and a ``CrossDocBatcher`` drain keeps the follower's
    mirror equal to the leader's."""
    from automerge_tpu_torch.ops.batched import CrossDocBatcher

    leader = AutoDoc.open(str(tmp_path / "leader"), actor=ActorId(ACTOR),
                          mirror=True)
    t = leader.put_object("_root", "text", ObjType.TEXT)
    leader.splice_text(t, 0, 0, "hello durable world")
    leader.commit(timestamp=1)
    follower = AutoDoc.open(str(tmp_path / "follower"), mirror=True)
    follower.apply_replicated_snapshot(leader.snapshot_bytes(), b"cursor-1")
    assert follower.replication_cursor == b"cursor-1"
    follower.drop_device_mirror()
    follower.build_device_mirror()
    leader.journal.truncate()
    for i in range(4):
        leader.splice_text(t, i, 0, f"<{i}>")
        leader.commit(timestamp=2 + i)
    with open(os.path.join(str(tmp_path / "leader"), PD.JOURNAL_NAME), "rb") as f:
        records = [(r.rec_type, r.payload) for r in scan_records(f.read())[0]]
    batcher = CrossDocBatcher(mode="1", device="cpu")
    fed = []

    def feed(doc, dev, changes):
        fed.append(batcher.apply(dev, [changes]))

    n = follower.apply_replicated(records, b"cursor-2", device_feed=feed)
    assert n == 4 and fed == [4]
    assert follower.replication_cursor == b"cursor-2"
    assert follower.acked_prefix()[0] == follower.acked_prefix()[1]
    leader.drop_device_mirror()
    ldev = leader.build_device_mirror()
    assert_same_mirror(follower.device_doc, ldev, "follower")
    assert follower.device_doc.text(t) == leader.text(t)
    leader.close()
    follower.close()


# -- the narrowed excepts -------------------------------------------------------


def _arsn_dir(tmp_path, name="d", tail=2):
    d = str(tmp_path / name)
    dd = AutoDoc.open(d, actor=ActorId(ACTOR), fsync="never")
    t = dd.put_object("_root", "text", ObjType.TEXT)
    dd.splice_text(t, 0, 0, "abcdef")
    dd.commit(timestamp=1)
    dd.compact()
    for i in range(tail):
        dd.put("_root", f"k{i}", i)
        dd.commit(timestamp=2 + i)
    dd.close()
    return d


def test_image_to_oplog_fault_falls_back_and_native_fault_propagates(
        tmp_path, monkeypatch):
    d = _arsn_dir(tmp_path)
    real = PR.RunImage.to_oplog

    def inconsistent(self, changes=None):
        raise ValueError("sections do not fit together")

    monkeypatch.setattr(PR.RunImage, "to_oplog", inconsistent)
    dd = AutoDoc.open(d, mirror=True)
    assert ctr(pobs, "oplog.hydrate_reencode") == 1  # the re-encode ran
    assert norm(dd.device_doc.hydrate()) == norm(dd.hydrate())
    dd.close()

    def no_library(self, changes=None):
        raise NativeUnavailable("no g++")

    monkeypatch.setattr(PR.RunImage, "to_oplog", no_library)
    with pytest.raises(NativeUnavailable):
        AutoDoc.open(d, mirror=True)
    monkeypatch.setattr(PR.RunImage, "to_oplog", real)
    AutoDoc.open(d).close()  # the failed open released the journal lock


def test_image_log_fault_falls_back_and_native_fault_propagates(
        tmp_path, monkeypatch):
    d = _arsn_dir(tmp_path)
    dd = AutoDoc.open(d)
    assert dd._run_image is not None
    monkeypatch.setattr(PR.RunImage, "to_oplog",
                        lambda self, changes=None: (_ for _ in ()).throw(
                            IndexError("run past the end")))
    dev = dd.build_device_mirror()  # falls back to from_changes
    assert ctr(pobs, "oplog.hydrate_reencode") == 1
    assert norm(dev.hydrate()) == norm(dd.hydrate())
    dd.drop_device_mirror()
    monkeypatch.setattr(PR.RunImage, "to_oplog",
                        lambda self, changes=None: (_ for _ in ()).throw(
                            NativeUnavailable("no g++")))
    with pytest.raises(NativeUnavailable):
        dd.build_device_mirror()
    dd.close()


class _StandIn:
    """A mirror without an op log (a duck-typed stand-in)."""

    res = {"visible": np.zeros(3, np.int64)}


def test_drop_mirror_lets_foreign_errors_through(tmp_path, monkeypatch):
    d = _arsn_dir(tmp_path)
    dd = AutoDoc.open(d, mirror=True)
    dd.device_doc = _StandIn()
    assert isinstance(dd.drop_device_mirror(), _StandIn)  # AttributeError: kept quiet
    dd.build_device_mirror()

    def boom(cls, log):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(PR.RunImage, "from_log", classmethod(boom))
    with pytest.raises(RuntimeError, match="CUDA"):
        dd.drop_device_mirror()
    dd.close()


def test_snapshot_log_lets_foreign_errors_through(tmp_path):
    d = _arsn_dir(tmp_path)
    dd = AutoDoc.open(d, mirror=True)
    real = dd.device_doc
    dd.device_doc = _StandIn()
    assert dd.compact()  # the stand-in has no log: the image path serves
    dd.device_doc = real

    class Broken:
        @property
        def log(self):
            raise RuntimeError("CUDA error: device-side assert")

    dd.device_doc = Broken()
    with pytest.raises(RuntimeError, match="CUDA"):
        dd.compact()
    dd.device_doc = real
    dd.close()


def test_device_resident_bytes_lets_foreign_errors_through():
    from automerge_tpu_torch.store.policy import device_resident_bytes

    assert device_resident_bytes(_StandIn()) == 24  # no estimate: the readbacks

    class NoArrays:
        pass

    assert device_resident_bytes(NoArrays()) == 0

    class Failing:
        def resident_nbytes_estimate(self):
            raise RuntimeError("CUDA error: out of memory")

    with pytest.raises(RuntimeError, match="CUDA"):
        device_resident_bytes(Failing())


def test_no_merge_runs_inside_the_salvage_handler(tmp_path, monkeypatch):
    """A legacy snapshot always loads through the salvage scan. With the
    bulk path on, its changes only mark the op store stale there; the
    merges run after the handler. A kernel failure then reaches the
    caller, not ``salvage_report``."""
    import automerge_tpu_torch.ops.merge as M

    monkeypatch.setenv("AUTOMERGE_TPU_RUNSNAP", "0")
    monkeypatch.setattr(PDocument, "BULK_MIN_OPS", 10)
    d = str(tmp_path / "d")
    dd = AutoDoc.open(d, actor=ActorId(ACTOR), fsync="never")
    t = dd.put_object("_root", "text", ObjType.TEXT)
    dd.splice_text(t, 0, 0, "x" * 60)
    dd.commit(timestamp=1)
    dd.compact()
    dd.close()
    inside = []
    launches = []
    real_load = PDocument._load_salvage
    real_kernel = M.succ_vis  # the first kernel of every merge

    def spy_load(self, data, verify):
        inside.append(True)
        try:
            return real_load(self, data, verify)
        finally:
            inside.pop()

    def spy_kernel(*a, **kw):
        launches.append(bool(inside))
        return real_kernel(*a, **kw)

    monkeypatch.setattr(PDocument, "_load_salvage", spy_load)
    monkeypatch.setattr(M, "succ_vis", spy_kernel)
    dd = AutoDoc.open(d, mirror=True)
    assert dd.doc.salvage_report is not None and not dd.doc.salvage_report.dropped
    assert dd.doc._ops_stale  # the bulk apply deferred the rebuild
    assert dd.text(t) == "x" * 60
    assert launches and not any(launches)  # merges ran, none in the handler
    dd.close()

    def failing(*a, **kw):
        raise RuntimeError("CUDA error: launch failure")

    monkeypatch.setattr(M, "succ_vis", failing)
    with pytest.raises(RuntimeError, match="launch failure"):
        AutoDoc.open(d, mirror=True)
    dd = AutoDoc.open(d)  # the failed open released the journal lock
    assert not dd.doc.salvage_report.dropped  # nothing landed in the report
    with pytest.raises(RuntimeError, match="launch failure"):
        dd.text(t)
    dd.close()


# -- the reference's durability cases, ported -----------------------------------

DIR = "/dd"  # SimFS namespace is flat; any path works


def actor(i):
    return ActorId(bytes([i]) * 16)


# -- journal unit coverage ----------------------------------------------------


def test_journal_append_reopen_roundtrip(tmp_path):
    p = str(tmp_path / "j.waj")
    j, records, tail = Journal.open(p, fsync="always")
    assert records == [] and not tail.torn
    payloads = [bytes([i]) * (i + 1) for i in range(5)]
    for pl in payloads:
        j.append(REC_CHANGE, pl)
    j.append_meta("k", b"v1")
    j.append_meta("k", b"v2")  # latest wins at replay time
    assert j.record_count == 7
    j.close()

    j2, records, tail = Journal.open(p)
    assert not tail.torn
    assert [r.payload for r in records if r.rec_type == REC_CHANGE] == payloads
    metas = [decode_meta(r.payload) for r in records if r.rec_type == REC_META]
    assert metas == [("k", b"v1"), ("k", b"v2")]
    assert j2.record_count == 7
    j2.close()


def test_journal_truncates_torn_tail(tmp_path):
    p = str(tmp_path / "j.waj")
    j, _, _ = Journal.open(p)
    j.append(REC_CHANGE, b"alpha")
    j.append(REC_CHANGE, b"beta")
    j.close()
    good_size = (tmp_path / "j.waj").stat().st_size

    # every possible torn suffix of a third record truncates back to the
    # two valid records
    rec = encode_record(REC_CHANGE, b"gamma")
    base = (tmp_path / "j.waj").read_bytes()
    for cut in range(1, len(rec)):
        (tmp_path / "j.waj").write_bytes(base + rec[:cut])
        trace.reset_counters()
        j2, records, tail = Journal.open(p)
        assert tail.torn and tail.dropped_bytes == cut
        assert [r.payload for r in records] == [b"alpha", b"beta"]
        assert trace.counters.get("journal.truncated_tail") == cut
        j2.close()
        assert (tmp_path / "j.waj").stat().st_size == good_size
    # a full third record appended after recovery still lands cleanly
    j3, records, _ = Journal.open(p)
    j3.append(REC_CHANGE, b"gamma")
    j3.close()
    recs, rep = scan_records((tmp_path / "j.waj").read_bytes())
    assert [r.payload for r in recs] == [b"alpha", b"beta", b"gamma"]
    assert not rep.torn


def test_journal_rejects_corrupt_middle_as_tail(tmp_path):
    """A flipped byte in record 2 of 3 drops records 2 AND 3: the journal
    never resynchronises past damage (append-only ⇒ first failure IS the
    tail)."""
    p = str(tmp_path / "j.waj")
    j, _, _ = Journal.open(p)
    for pl in (b"one", b"two", b"three"):
        j.append(REC_CHANGE, pl)
    j.close()
    data = bytearray((tmp_path / "j.waj").read_bytes())
    second = len(JOURNAL_MAGIC) + len(encode_record(REC_CHANGE, b"one"))
    data[second + 8] ^= 0xFF  # inside record 2's payload
    (tmp_path / "j.waj").write_bytes(bytes(data))
    _, records, tail = Journal.open(p)
    assert [r.payload for r in records] == [b"one"]
    assert tail.reason == "record checksum mismatch"


def test_journal_corrupt_header_salvages_records(tmp_path):
    """Single-sector damage to the 4-byte header must not destroy the
    CRC-framed records behind it: they re-verify under a synthetic header
    and the file is rewritten around them."""
    p = str(tmp_path / "j.waj")
    j, _, _ = Journal.open(p)
    for pl in (b"one", b"two", b"three"):
        j.append(REC_CHANGE, pl)
    j.close()
    data = bytearray((tmp_path / "j.waj").read_bytes())
    data[1] ^= 0xFF  # hit the magic
    (tmp_path / "j.waj").write_bytes(bytes(data))

    trace.reset_counters()
    j2, records, tail = Journal.open(p)
    assert [r.payload for r in records] == [b"one", b"two", b"three"]
    assert j2.record_count == 3
    assert trace.counters.get("journal.truncated_tail") == 4  # just the header
    j2.append(REC_CHANGE, b"four")
    j2.close()
    recs, rep = scan_records((tmp_path / "j.waj").read_bytes())
    assert [r.payload for r in recs] == [b"one", b"two", b"three", b"four"]
    assert not rep.torn


def test_header_salvage_is_crash_atomic():
    """The bad-header rewrite itself is swept: a crash at any boundary of
    the salvaging open leaves either the old damaged file (salvage reruns)
    or the complete rewritten one — never fewer records."""
    base = SimFS()
    j, _, _ = Journal.open("/j", fs=base)
    for pl in (b"one", b"two", b"three"):
        j.append(REC_CHANGE, pl)
    j.close()
    damaged = bytearray(base.read_bytes("/j"))
    damaged[0] ^= 0xFF

    probe = SimFS.from_disk({"/j": bytes(damaged)})
    Journal.open("/j", fs=probe)[0].close()
    total = probe.ops
    for k in range(1, total + 1):
        fs = SimFS.from_disk({"/j": bytes(damaged)})
        fs.crash_at = k
        try:
            Journal.open("/j", fs=fs)[0].close()
        except CrashPoint:
            pass
        for state in fs.crash_states(random.Random(k)):
            fs2 = SimFS.from_disk(state)
            j2, records, _ = Journal.open("/j", fs=fs2)
            assert [r.payload for r in records] == [b"one", b"two", b"three"], (
                f"crash at {k}: salvage lost records"
            )
            j2.close()


def test_durable_doc_survives_corrupt_journal_header(tmp_path):
    d = str(tmp_path / "doc")
    dd = AutoDoc.open(d, fsync="always", actor=actor(1))
    for i in range(3):
        dd.put("_root", f"k{i}", i)
        dd.commit()
    dd.close()
    jp = tmp_path / "doc" / "journal.waj"
    data = bytearray(jp.read_bytes())
    data[0] ^= 0x01
    jp.write_bytes(bytes(data))
    dd2 = AutoDoc.open(d)
    assert dd2.hydrate() == {"k0": 0, "k1": 1, "k2": 2}
    dd2.close()


def test_journal_empty_and_garbage_files_reinitialise(tmp_path):
    for content in (b"", b"AM", b"garbage-not-a-journal"):
        p = tmp_path / "j.waj"
        p.write_bytes(content)
        j, records, tail = Journal.open(str(p))
        assert records == []
        j.append(REC_CHANGE, b"x")
        j.close()
        recs, rep = scan_records(p.read_bytes())
        assert [r.payload for r in recs] == [b"x"] and not rep.torn
        p.unlink()


def test_journal_fsync_policies(tmp_path):
    trace.reset_timers()
    j, _, _ = Journal.open(str(tmp_path / "a.waj"), fsync="always")
    for i in range(4):
        j.append(REC_CHANGE, b"x")
    j.close()
    assert trace.timing_summary()["journal.fsync"]["n"] >= 4

    trace.reset_timers()
    j, _, _ = Journal.open(
        str(tmp_path / "i.waj"), fsync="interval", fsync_interval=4
    )
    for i in range(8):
        j.append(REC_CHANGE, b"x")
    assert trace.timing_summary()["journal.fsync"]["n"] == 2
    j.close()

    trace.reset_timers()
    j, _, _ = Journal.open(str(tmp_path / "n.waj"), fsync="never")
    for i in range(8):
        j.append(REC_CHANGE, b"x")
    assert "journal.fsync" not in trace.timing_summary()
    j.close()  # close still syncs so the bytes are not lost on clean exit

    with pytest.raises(ValueError):
        Journal.open(str(tmp_path / "z.waj"), fsync="sometimes")


def test_meta_roundtrip():
    for name, blob in (("k", b""), ("sync/peer-1", b"\x00\xff" * 40), ("", b"x")):
        assert decode_meta(encode_meta(name, blob)) == (name, blob)


# -- the crash-point property suite ------------------------------------------


def _run_workload(fs, *, fsync="always", compact_max_records=4):
    """The deterministic durable workload; returns the acked change
    hashes in ack order. Raises CrashPoint mid-flight on a scheduled
    crash (the partial acked list is attached to the exception)."""
    acked = []
    try:
        peer = AutoDoc(actor=actor(9))
        for i in range(3):
            peer.put("_root", f"p{i}", i)
            peer.commit()
        peer_changes = peer.get_changes([])

        dd = AutoDoc.open(
            DIR, fs=fs, fsync=fsync, actor=actor(1),
            compact_max_records=compact_max_records,
        )
        for i in range(8):
            dd.put("_root", f"k{i}", i)
            h = dd.commit()
            acked.append(h)
            if i == 2:
                dd.set_meta("note", b"mid-run")  # metadata rides along
            if i in (3, 5) and peer_changes:
                ch = peer_changes.pop(0)
                dd.apply_changes([ch])  # a change absorbed "from sync"
                acked.append(ch.hash)
        return acked
    except CrashPoint as e:
        e.acked = acked
        raise


def _check_crash_point(k, seed):
    fs = SimFS(crash_at=k)
    try:
        acked = _run_workload(fs)
    except CrashPoint as e:
        acked = e.acked
    rng = random.Random(seed * 100_003 + k)
    for si, state in enumerate(fs.crash_states(rng)):
        fs2 = SimFS.from_disk(state)
        trace.reset_counters()
        dd = AutoDoc.open(DIR, fs=fs2)
        try:
            have = set(dd.doc.history_index)
            missing = [h for h in acked if h not in have]
            assert not missing, (
                f"crash at boundary {k} state {si}: {len(missing)} acked "
                f"changes lost (last fs ops: {fs.op_trace[-4:]})"
            )
            # per-actor seq prefix: recovery must never create gaps
            for actor_idx, idxs in dd.doc.states.items():
                seqs = sorted(dd.doc.history[i].stored.seq for i in idxs)
                assert seqs == list(range(1, len(seqs) + 1)), (
                    f"crash at {k} state {si}: seq gap for actor {actor_idx}"
                )
            dd.hydrate()  # the recovered doc must actually read
        finally:
            dd.close()


def _total_boundaries():
    fs = SimFS()
    _run_workload(fs)
    return fs.ops


def test_crash_point_sweep_sampled():
    """Tier-1 version: every 3rd write boundary (plus both ends) of the
    mixed workload, all crash-state variants."""
    total = _total_boundaries()
    assert total > 20  # the workload really does hit the fs
    for k in sorted(set(range(1, total + 1, 3)) | {1, total}):
        _check_crash_point(k, seed=0)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(4))
def test_crash_point_sweep_full(seed):
    """Every write boundary, four seeds of torn/reorder variants."""
    total = _total_boundaries()
    for k in range(1, total + 1):
        _check_crash_point(k, seed=seed)


def _run_incremental_compact_workload(fs):
    """Commit → compact → commit → compact …: after the first compaction
    the doc holds a run-coded image, so every later compact() exercises
    the INCREMENTAL path (retained image + journal-tail merge). Crashing
    at every write boundary of this workload proves a torn incremental
    merge never leaves a half-spliced snapshot on disk."""
    acked = []
    try:
        dd = AutoDoc.open(
            DIR, fs=fs, fsync="always", actor=actor(1),
            compact_max_records=1 << 30,  # only the explicit compacts below
        )
        for r in range(3):
            for i in range(3):
                dd.put("_root", f"r{r}k{i}", i)
                acked.append(dd.commit())
            dd.compact()
        return acked
    except CrashPoint as e:
        e.acked = acked
        raise


def _check_incremental_crash_point(k, seed):
    from automerge_tpu_torch.integrity import verify_snapshot_bytes
    from automerge_tpu_torch.storage.durable import SNAPSHOT_NAME

    fs = SimFS(crash_at=k)
    try:
        acked = _run_incremental_compact_workload(fs)
    except CrashPoint as e:
        acked = e.acked
    rng = random.Random(seed * 100_003 + k)
    for si, state in enumerate(fs.crash_states(rng)):
        fs2 = SimFS.from_disk(state)
        snap_path = DIR + "/" + SNAPSHOT_NAME
        if fs2.exists(snap_path):
            # the visible snapshot is atomic-rename-protected: whatever
            # boundary the crash hit, it must verify clean end to end —
            # a half-spliced image would surface exactly here
            rep = verify_snapshot_bytes(fs2.read_bytes(snap_path))
            assert rep.ok, (
                f"crash at boundary {k} state {si}: torn snapshot "
                f"({rep.reason} at {rep.first_bad_offset})"
            )
        dd = AutoDoc.open(DIR, fs=fs2)
        try:
            have = set(dd.doc.history_index)
            missing = [h for h in acked if h not in have]
            assert not missing, (
                f"crash at boundary {k} state {si}: {len(missing)} acked "
                f"changes lost after incremental compaction"
            )
            dd.hydrate()
        finally:
            dd.close()


def _incremental_total_boundaries():
    fs = SimFS()
    _run_incremental_compact_workload(fs)
    return fs.ops


def test_incremental_compact_crash_sweep_sampled():
    """Tier-1: every 4th write boundary (plus both ends) of the
    compact-heavy workload, all crash-state variants."""
    total = _incremental_total_boundaries()
    assert total > 20
    for k in sorted(set(range(1, total + 1, 4)) | {1, total}):
        _check_incremental_crash_point(k, seed=0)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(3))
def test_incremental_compact_crash_sweep_full(seed):
    """Every write boundary of the compact-heavy workload."""
    total = _incremental_total_boundaries()
    for k in range(1, total + 1):
        _check_incremental_crash_point(k, seed=seed)


def test_crash_sweep_reports_truncated_tails():
    """Across a sweep, at least one torn state exercises the journal
    tail-truncation counter."""
    total = _total_boundaries()
    saw_truncate = 0
    for k in range(1, total + 1, 2):
        fs = SimFS(crash_at=k)
        try:
            _run_workload(fs)
        except CrashPoint:
            pass
        for state in fs.crash_states(random.Random(k)):
            trace.reset_counters()
            dd = AutoDoc.open(DIR, fs=SimFS.from_disk(state))
            saw_truncate += trace.counters.get("journal.truncated_tail", 0)
            dd.close()
    assert saw_truncate > 0


def test_harness_catches_missing_dir_fsync():
    """Sensitivity check: a durable layer that skips the directory fsync
    between snapshot rename and journal truncation MUST fail the sweep
    (rename-before-flush reordering loses acked changes)."""

    class NoSyncDirFS(SimFS):
        def sync_dir(self, path):
            self._tick(("sync_dir-skipped",))  # boundary counted, no commit

    fs = NoSyncDirFS()
    _run_workload(fs)
    total = fs.ops
    violations = 0
    for k in range(1, total + 1):
        fs = NoSyncDirFS(crash_at=k)
        try:
            acked = _run_workload(fs)
        except CrashPoint as e:
            acked = e.acked
        for state in fs.crash_states(random.Random(k)):
            dd = AutoDoc.open(DIR, fs=SimFS.from_disk(state))
            have = set(dd.doc.history_index)
            if any(h not in have for h in acked):
                violations += 1
            dd.close()
    assert violations > 0


def test_weaker_fsync_policies_stay_prefix_consistent():
    """Under fsync="never"/"interval" acked changes may be lost on crash,
    but the reopened document must still be a gap-free prefix."""
    for policy in ("interval", "never"):
        total_fs = SimFS()
        _run_workload(total_fs, fsync=policy)
        for k in range(1, total_fs.ops + 1, 4):
            fs = SimFS(crash_at=k)
            try:
                _run_workload(fs, fsync=policy)
            except CrashPoint:
                pass
            for state in fs.crash_states(random.Random(k)):
                dd = AutoDoc.open(DIR, fs=SimFS.from_disk(state))
                for actor_idx, idxs in dd.doc.states.items():
                    seqs = sorted(
                        dd.doc.history[i].stored.seq for i in idxs
                    )
                    assert seqs == list(range(1, len(seqs) + 1))
                dd.hydrate()
                dd.close()


# -- compaction ---------------------------------------------------------------


def test_compaction_bounds_replay(tmp_path):
    """With a low threshold, reopening replays far fewer records than the
    total committed changes — recovery time is bounded by the threshold,
    not the document's age."""
    d = str(tmp_path / "doc")
    n_commits = 40
    dd = AutoDoc.open(d, fsync="never", compact_max_records=8, actor=actor(1))
    for i in range(n_commits):
        dd.put("_root", f"k{i}", i)
        dd.commit()
    expect = dd.hydrate()
    assert dd.journal.record_count <= 9  # thresholds actually engaged
    dd.close()

    trace.reset_counters()
    dd2 = AutoDoc.open(d)
    assert trace.counters.get("journal.replayed_records", 0) < n_commits
    assert trace.counters.get("compact.runs", 0) == 0  # replay alone, no churn
    assert dd2.hydrate() == expect
    dd2.close()


def test_compaction_preserves_meta_and_queue(tmp_path):
    d = str(tmp_path / "doc")
    dd = AutoDoc.open(d, fsync="never", actor=actor(1))
    dd.set_meta("sync/peer", b"\x01\x02")
    dd.put("_root", "x", 1)
    dd.commit()
    assert dd.compact()
    assert dd.journal.record_count == 1  # just the re-appended meta
    dd.close()
    dd2 = AutoDoc.open(d)
    assert dd2.meta == {"sync/peer": b"\x01\x02"}
    assert dd2.hydrate() == {"x": 1}
    dd2.close()


def test_compact_skipped_during_open_manual_transaction(tmp_path):
    dd = AutoDoc.open(str(tmp_path / "doc"), fsync="never", actor=actor(1))
    tx = dd.transaction()
    tx.put("_root", "x", 1)
    assert dd.compact() is False  # pending ops: deferred, not raised
    tx.commit()
    assert dd.compact() is True
    dd.close()


# -- snapshot damage ----------------------------------------------------------


def test_damaged_snapshot_degrades_to_salvage(tmp_path):
    d = tmp_path / "doc"
    dd = AutoDoc.open(str(d), fsync="never", actor=actor(1))
    for i in range(4):
        dd.put("_root", f"k{i}", i)
        dd.commit()
    dd.compact()
    dd.put("_root", "post", "journal")
    post_hash = dd.commit()
    dd.close()

    snap = d / "snapshot.am"
    data = bytearray(snap.read_bytes())
    data[len(data) // 2] ^= 0xFF
    snap.write_bytes(bytes(data))

    trace.reset_counters()
    dd2 = AutoDoc.open(str(d))
    # open degrades instead of refusing, reports what it dropped, and the
    # journaled change is retained — applied if its deps survived, queued
    # awaiting them otherwise (re-fetchable via sync), never silently lost
    assert dd2.doc.salvage_report is not None
    assert trace.counters.get("load.dropped_chunks", 0) >= 1
    in_history = post_hash in dd2.doc.history_index
    in_queue = any(c.hash == post_hash for c in dd2.doc.queue)
    assert in_history or in_queue
    dd2.hydrate()
    dd2.close()


# -- device warm recovery -----------------------------------------------------


def test_device_warm_recovery_matches_host(tmp_path):
    d = str(tmp_path / "doc")
    dd = AutoDoc.open(d, fsync="never", compact_max_records=5, actor=actor(1))
    for i in range(8):
        dd.put("_root", f"k{i}", i)
        dd.commit()
    dd.put("_root", "tail", "x")
    dd.commit()
    expect = dd.hydrate()
    assert dd.journal.record_count > 0  # journal really has post-snapshot work
    dd.close()

    trace.reset_counters()
    trace.reset_timers()
    dd2 = AutoDoc.open(d, mirror=True)
    timings = trace.timing_summary()
    assert "device.recover" in timings  # the recovery span covers the feed
    # warm path: replayed changes went through OpLog.append_changes, never
    # a from-scratch rebuild
    assert trace.counters.get("device.apply_rebuild", 0) == 0
    assert dd2.device_doc is not None
    assert dd2.device_doc.hydrate() == expect == dd2.hydrate()
    dd2.close()


def test_device_recovery_without_snapshot(tmp_path):
    d = str(tmp_path / "doc")
    dd = AutoDoc.open(d, fsync="never", actor=actor(1))
    dd.put("_root", "only", "journal")
    dd.commit()
    dd.close()
    dd2 = AutoDoc.open(d, mirror=True)
    assert dd2.device_doc.hydrate() == dd2.hydrate()
    dd2.close()


def test_batch_apply_pays_one_fsync(tmp_path):
    """A 20-change batch absorbed through an ack-point method fsyncs once
    at the boundary, not once per change — same acked-durable guarantee."""
    peer = AutoDoc(actor=actor(9))
    for i in range(20):
        peer.put("_root", f"p{i}", i)
        peer.commit()
    changes = peer.get_changes([])

    dd = AutoDoc.open(str(tmp_path / "doc"), fsync="always", actor=actor(1))
    trace.reset_timers()
    dd.apply_changes(changes)
    t = trace.timing_summary()
    assert t["journal.append"]["n"] == 20
    assert t["journal.fsync"]["n"] == 1
    assert dd.journal.record_count == 20
    dd.close()
    dd2 = AutoDoc.open(str(tmp_path / "doc"))
    assert len(dd2.doc.history) == 20
    dd2.close()


def test_second_open_of_live_journal_is_refused(tmp_path):
    """Two live journals on one file would interleave appends and corrupt
    it; the advisory lock turns that into a clean error (and releases on
    close, with no stale-lockfile hazard)."""
    import fcntl  # noqa: F401 — the guard is POSIX-only, like this test

    from automerge_tpu_torch.storage.journal import JournalError

    d = str(tmp_path / "doc")
    dd = AutoDoc.open(d, fsync="never", actor=actor(1))
    with pytest.raises(JournalError, match="locked"):
        AutoDoc.open(d)
    dd.close()
    dd2 = AutoDoc.open(d)  # released with the handle
    dd2.close()


# -- real-filesystem integration ---------------------------------------------


def test_real_fs_reopen_after_partial_append(tmp_path):
    """Torn tail on the real OS filesystem: bytes chopped off the journal
    mid-record recover to the last full record."""
    d = tmp_path / "doc"
    dd = AutoDoc.open(str(d), fsync="always", actor=actor(1))
    dd.put("_root", "a", 1)
    h1 = dd.commit()
    dd.put("_root", "b", 2)
    dd.commit()
    dd.close()

    jp = d / "journal.waj"
    data = jp.read_bytes()
    jp.write_bytes(data[:-7])  # tear the second record

    dd2 = AutoDoc.open(str(d))
    assert h1 in dd2.doc.history_index
    assert dd2.hydrate() == {"a": 1}
    dd2.close()


def test_failed_append_poisons_until_compaction_repairs(tmp_path):
    """A journal append failure leaves memory ahead of disk: further
    changes must be refused (never acked over a stranded dependency)
    until compact() re-establishes disk >= memory from the full
    in-memory history."""
    from automerge_tpu_torch.storage.journal import JournalError

    d = str(tmp_path / "doc")
    dd = AutoDoc.open(d, fsync="never", actor=actor(1))
    dd.put("_root", "ok", 0)
    dd.commit()

    orig_append = dd.journal.append

    def boom(*a, **kw):
        raise OSError(28, "No space left on device")

    dd.journal.append = boom
    dd.put("_root", "lost", 1)
    with pytest.raises(OSError):
        dd.commit()  # change entered history but never hit the journal
    dd.journal.append = orig_append

    dd.put("_root", "dependent", 2)
    with pytest.raises(JournalError, match="out of sync"):
        dd.commit()  # poisoned: refuses instead of stranding a dependent

    assert dd.compact() is True  # snapshot carries the full history
    dd.put("_root", "after", 3)
    dd.commit()
    dd.close()
    dd2 = AutoDoc.open(d)
    h = dd2.hydrate()
    assert h["lost"] == 1 and h["dependent"] == 2 and h["after"] == 3
    dd2.close()


def test_failed_append_keeps_reads_consistent_with_heads(tmp_path):
    """When the journal listener raises mid-apply, the change is already
    in history/heads — reads must still surface its ops (the op store is
    marked stale and rebuilds from history), never a torn in-memory doc."""
    d = str(tmp_path / "doc")
    dd = AutoDoc.open(d, fsync="never", actor=actor(1))
    dd.put("_root", "ok", 0)
    dd.commit()

    src = AutoDoc(actor=actor(2))
    src.put("_root", "incoming", 1)
    src.commit()
    change = src.doc.get_changes([])[-1]

    def boom(*a, **kw):
        raise OSError(28, "No space left on device")

    dd.journal.append = boom
    with pytest.raises(OSError):
        dd.apply_changes([change])
    assert change.hash in dd.doc.history_index  # heads advertise it...
    assert dd.hydrate()["incoming"] == 1  # ...and reads must agree
    dd.close()


def test_close_commits_pending_autocommit_tx(tmp_path):
    """close() (and the context manager) must flush a pending autocommit
    transaction like every other AutoDoc exit surface does."""
    d = str(tmp_path / "doc")
    with AutoDoc.open(d, actor=actor(1)) as dd:
        dd.put("_root", "k", 1)  # no explicit commit
    dd2 = AutoDoc.open(d)
    assert dd2.hydrate() == {"k": 1}
    dd2.close()


def test_open_is_reusable_across_generations(tmp_path):
    """Three open/edit/close generations accumulate state correctly."""
    d = str(tmp_path / "doc")
    for gen in range(3):
        dd = AutoDoc.open(d, fsync="never", actor=actor(gen + 1))
        dd.put("_root", f"gen{gen}", gen)
        dd.commit()
        dd.close()
    dd = AutoDoc.open(d)
    assert dd.hydrate() == {"gen0": 0, "gen1": 1, "gen2": 2}
    dd.close()


# -- group commit (the serving layer's durability contract) -------------------


def test_journal_fsync_combiner_under_concurrent_appends(tmp_path):
    """N threads appending + syncing one journal: every record durable,
    strictly fewer physical fsyncs than sync calls (the leader-elected
    combiner), and the group_commit.batch_size histogram saw a multi-
    append fsync."""
    import threading
    import time as _time

    from automerge_tpu_torch import obs
    from automerge_tpu_torch.storage.journal import OS_FS

    class SlowFS:
        """Real FS with an fsync slow enough that arrivals overlap."""

        def __getattr__(self, name):
            return getattr(OS_FS, name)

        def fsync(self, f):
            _time.sleep(0.005)
            OS_FS.fsync(f)

    p = str(tmp_path / "j.waj")
    j, _, _ = Journal.open(p, fs=SlowFS(), fsync="always")
    trace.reset_timers()
    h = obs.registry.histogram("group_commit.batch_size")
    n0, max0 = h.n, h.vmax
    n_threads, n_appends = 6, 5
    errs = []

    def committer(ti):
        try:
            for k in range(n_appends):
                j.append(REC_CHANGE, bytes([ti]) * (k + 1))
        except Exception as e:  # noqa: BLE001
            errs.append(repr(e))

    ts = [__import__("threading").Thread(target=committer, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    j.close()
    assert not errs, errs
    total = n_threads * n_appends
    fsyncs = trace.timing_summary().get("journal.fsync", {}).get("n", 0)
    assert 0 < fsyncs < total, (fsyncs, total)
    assert h.vmax >= 2 and h.n > n0, (h.n, h.vmax)
    # every record survived, uninterleaved and verifiable
    _, records, tail = Journal.open(p)
    assert not tail.torn and len(records) == total


def _run_grouped_workload(fs):
    """The group-commit workload: commits batch inside ack_scope exactly
    like the serving layer's drained flights; a change counts as ACKED
    only once its scope (and its single deferred fsync) has exited."""
    acked = []
    try:
        dd = AutoDoc.open(DIR, fs=fs, fsync="always", actor=actor(1),
                          compact_max_records=6)
        for g in range(4):
            staged = []
            with dd.ack_scope():
                for i in range(3):
                    dd.put("_root", f"g{g}_k{i}", i)
                    staged.append(dd.commit())
            acked.extend(staged)  # ack AFTER the group fsync
        dd.close()
        return acked
    except CrashPoint as e:
        e.acked = acked
        raise


def test_group_commit_crash_sweep():
    """Crash at every write boundary of the batched workload: every
    post-crash image must replay to (at least) the acked prefix — group
    commit defers fsyncs inside a scope, it must never weaken the
    acked-means-durable contract."""
    fs = SimFS()
    _run_grouped_workload(fs)
    total = fs.ops
    assert total > 10
    for k in range(1, total + 1):
        fs = SimFS(crash_at=k)
        try:
            acked = _run_grouped_workload(fs)
        except CrashPoint as e:
            acked = e.acked
        for si, state in enumerate(fs.crash_states(random.Random(k))):
            dd = AutoDoc.open(DIR, fs=SimFS.from_disk(state))
            try:
                have = set(dd.doc.history_index)
                missing = [h for h in acked if h not in have]
                assert not missing, (
                    f"group-commit crash at {k} state {si}: "
                    f"{len(missing)} acked changes lost"
                )
                for actor_idx, idxs in dd.doc.states.items():
                    seqs = sorted(
                        dd.doc.history[i].stored.seq for i in idxs
                    )
                    assert seqs == list(range(1, len(seqs) + 1))
            finally:
                dd.close()


def test_nested_ack_scope_defers_to_outermost_fsync(tmp_path):
    """The serving layer wraps whole batches of (already ack-wrapped)
    calls in one outer scope: only the OUTERMOST exit pays the policy
    fsync, so k batched commits cost one fsync, not k."""
    dd = AutoDoc.open(str(tmp_path / "doc"), actor=actor(1))
    trace.reset_timers()
    with dd.ack_scope():
        for i in range(5):
            dd.put("_root", f"k{i}", i)
            dd.commit()  # inner (memoized) ack wrapper: nested scope
    t = trace.timing_summary()
    assert t["journal.fsync"]["n"] == 1, t.get("journal.fsync")
    dd.close()
    dd2 = AutoDoc.open(str(tmp_path / "doc"))
    assert len(dd2.doc.history) == 5
    dd2.close()


def test_background_compaction_catches_up_off_ack_path(tmp_path):
    """background_compact=True: threshold crossings schedule compaction
    on the daemon thread; the journal shrinks without any ack paying the
    snapshot, and close() retires the compactor cleanly."""
    import time as _time

    dd = AutoDoc.open(str(tmp_path / "doc"), actor=actor(1),
                      fsync="never", compact_max_records=8,
                      background_compact=True)
    # the background-compaction contract: mutations serialize under the
    # doc lock (the serving layer's executor does exactly this per batch)
    for i in range(40):
        with dd.lock:
            dd.put("_root", f"k{i}", i)
            dd.commit()
    deadline = _time.monotonic() + 10
    while dd.journal.record_count > 8 and _time.monotonic() < deadline:
        _time.sleep(0.01)
    assert dd.journal.record_count <= 8, dd.journal.record_count
    dd.close()
    dd2 = AutoDoc.open(str(tmp_path / "doc"))
    assert len(dd2.doc.history) == 40
    assert dd2.hydrate()["k39"] == 39
    dd2.close()


def test_cost_ratio_defers_compaction_for_large_snapshots(tmp_path):
    """compact_cost_ratio: a journal far smaller than the snapshot defers
    compaction (cost model) even past the record threshold; growth past
    the ratio compacts as usual."""
    d = str(tmp_path / "doc")
    dd = AutoDoc.open(d, actor=actor(1), fsync="never",
                      compact_max_records=4)
    # build a snapshot worth of (incompressible) state, compacted
    import hashlib

    for i in range(50):
        blob = "".join(
            hashlib.sha256(f"{i}:{r}".encode()).hexdigest()
            for r in range(4)
        )
        dd.put("_root", f"base{i:03}", blob)
        dd.commit()
    dd.compact()
    snap_bytes = dd._last_snapshot_bytes
    assert snap_bytes > 0
    dd.close()

    dd = AutoDoc.open(d, fsync="never", compact_max_records=4,
                      compact_cost_ratio=0.5)
    assert dd._last_snapshot_bytes > 0  # tracked from the existing snapshot
    trace.reset_counters()
    for i in range(8):  # past the record threshold, tiny vs the snapshot
        dd.put("_root", f"n{i}", i)
        dd.commit()
    assert dd.journal.record_count >= 8  # deferred by cost
    assert trace.counters.get("compact.deferred_by_cost", 0) > 0
    dd.close()


# -- live disk faults: group-commit fsync failure semantics -------------------


def test_group_commit_fsync_eio_errors_every_covered_waiter(tmp_path):
    """An injected EIO on the COMBINED fsync: every ack_scope waiter the
    fsync covered errors (an un-fsynced ack is no ack, for the whole
    group), the journal poisons itself — no retry-after-fsync-failure —
    and the on-disk acked prefix (everything acked before the fault)
    replays intact on reopen."""
    import threading
    import time as _time

    from automerge_tpu_torch import obs
    from automerge_tpu_torch.storage.crashsim import FaultyFS
    from automerge_tpu_torch.storage.journal import OS_FS, JournalPoisoned

    class SlowFaultyFS(FaultyFS):
        """Arrivals overlap the in-flight fsync, so the combiner forms
        real multi-waiter groups before the injected fault lands."""

        def fsync(self, f):
            _time.sleep(0.005)
            super().fsync(f)

    fs = SlowFaultyFS(OS_FS)
    d = str(tmp_path / "doc")
    dd = AutoDoc.open(d, fs=fs, fsync="always", actor=actor(1))
    pre = [f"pre{i}" for i in range(5)]
    for k in pre:
        dd.put("_root", k, 1)
        dd.commit()  # acked + durable before any fault

    obs.reset_all()
    n_threads = 6
    results = [None] * n_threads
    start = threading.Barrier(n_threads)

    def committer(ti):
        start.wait()
        try:
            with dd.ack_scope():
                with dd.lock:
                    dd.put("_root", f"w{ti}", ti)
                    dd.commit()
            results[ti] = "acked"
        except Exception as e:  # noqa: BLE001
            results[ti] = type(e).__name__

    fs.arm("fsync", "EIO", count=1)
    ts = [threading.Thread(target=committer, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()

    # the fault fired, the journal poisoned, and NO waiter the poisoned
    # fsync covered was acked: with count=1 the very first physical fsync
    # dies, so every committer errors (none can have been covered by an
    # earlier successful fsync)
    assert dd.journal.poisoned and dd.journal.poisoned_reason == "fsync"
    assert obs.counter_values("journal.poisoned", "reason") == {"fsync": 1}
    assert all(r != "acked" for r in results), results
    assert dd.degraded

    # no-ack-after-poison: the journal never acks another write until
    # reopened/compacted, and the refusal is the retriable kind
    with pytest.raises(JournalPoisoned):
        dd.put("_root", "late", 1)
        dd.commit()
    assert JournalPoisoned.retriable is True

    # the acked prefix is replayable: everything acked pre-fault reads
    # back; the un-acked group MAY be present (durability is allowed to
    # exceed acks, never to lag them)
    dd2 = AutoDoc.open(d, actor=actor(2))
    got = dd2.hydrate()
    for k in pre:
        assert got.get(k) == 1, (k, sorted(got))
    dd2.close()
