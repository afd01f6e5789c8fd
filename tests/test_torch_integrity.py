"""End-to-end integrity in the port (``integrity.py``) and the durable
peers of the sync and run-image layers, against the JAX package's, on
the CPU.

The digests (``doc_digest``, ``column_digests`` over dense and resident
columns) equal the reference's for the same history, and hold across
merge orders, out-of-order delivery and residency modes. The read-back
checks (``verify_snapshot_bytes``, ``verify_journal_bytes``,
``verify_doc_dir``) give the reference's reports on seeded corruptions of
both snapshot formats and of journals. ``Scrubber.run_round`` over the
stand-in server of ``test_torch_store`` (its ``_lock``,
``_durable_names``, ``_docs``, ``store``) repairs a live document's bit
rot, salvages a cold one or re-fetches it from a peer over a localhost
socket, sees a read-path bit flip, and drops a mirror whose encoded
columns disagree with its dense ones. Then the reference's durable sync
peers (``tests/test_sync_faults.py``) and durable run-image cases
(``tests/test_runsnap.py``), ported.
"""

import base64
import json
import os
import random
import socket
import threading

import numpy as np
import pytest

import automerge_tpu.api as RA
import automerge_tpu.integrity as RI
import automerge_tpu.types as RT
from automerge_tpu import obs as robs
import automerge_tpu_torch.api as PA
import automerge_tpu_torch.types as PT
from automerge_tpu_torch import integrity, trace
from automerge_tpu_torch import obs as pobs
from automerge_tpu_torch.storage import runsnap
from automerge_tpu_torch.storage.durable import JOURNAL_NAME, SNAPSHOT_NAME
from automerge_tpu_torch.sync import FaultyChannel, SyncDriver, SyncSession
from automerge_tpu_torch.types import ActorId, ObjType

from tests.test_torch_durable import AutoDoc
from tests.test_torch_store import MiniServer

MAX_TICKS = 3000


@pytest.fixture(autouse=True)
def _fresh_obs():
    robs.reset_all()
    pobs.reset_all()
    yield


def actor(i):
    return ActorId(bytes([i]) * 16)


def _ctr(name):
    return sum(e["value"] for e in pobs.snapshot()
               if e["type"] == "counter" and e["name"] == name)


def _flip_byte(path, frac=0.5):
    data = open(path, "rb").read()
    i = int(len(data) * frac) % max(1, len(data))
    bad = data[:i] + bytes([data[i] ^ 0x40]) + data[i + 1:]
    with open(path, "wb") as f:
        f.write(bad)
    return i


def _build_forks(seed, n_forks=4, edits=5, api=None, types=None):
    """The reference's fork workload, in either package, with fixed
    timestamps so both packages make the same changes."""
    api = api or PA
    types = types or PT
    kw = {"device": "cpu"} if api is PA else {}
    rng = random.Random(seed)
    base = api.AutoDoc(actor=types.ActorId(bytes([1]) * 16), **kw)
    t = base.put_object("_root", "text", types.ObjType.TEXT)
    base.splice_text(t, 0, 0, "seed text")
    base.put("_root", "n", 0)
    base.commit(timestamp=1)
    forks = []
    for i in range(n_forks):
        f = base.fork(actor=types.ActorId(bytes([10 + i]) * 16))
        for e in range(edits):
            if rng.random() < 0.5:
                pos = rng.randrange(0, f.length(t) + 1)
                f.splice_text(t, pos, 0, f"w{i}.{e} ")
            else:
                f.put("_root", f"k{i}", e * 7 + i)
            f.commit(timestamp=2 + e)
        forks.append(f)
    return base, t, forks


# -- digests ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 11, 27])
def test_digest_invariant_across_merge_orders_and_equal_to_reference(seed):
    base, _t, forks = _build_forks(seed)
    digests = set()
    for order in range(4):
        rng = random.Random(seed * 10 + order)
        fs = list(forks)
        rng.shuffle(fs)
        m = AutoDoc.load(base.save())
        for f in fs:
            m.merge(f)
        digests.add(integrity.doc_digest(m.doc)["digest"])
    assert len(digests) == 1, digests
    rbase, _rt, rforks = _build_forks(seed, api=RA, types=RT)
    rm = RA.AutoDoc.load(rbase.save())
    for f in rforks:
        rm.merge(f)
    assert RI.doc_digest(rm.doc)["digest"] in digests


@pytest.mark.parametrize("seed", [5, 19, 42])
def test_digest_invariant_under_out_of_order_delivery(seed):
    base, _t, forks = _build_forks(seed, n_forks=3)
    per_fork = [f.doc.get_changes(base.get_heads()) for f in forks]
    want = None
    for trial in range(3):
        rng = random.Random(seed * 100 + trial)
        m = AutoDoc.load(base.save())
        idx = [0] * len(per_fork)
        while any(idx[i] < len(per_fork[i]) for i in range(len(per_fork))):
            live = [i for i in range(len(per_fork)) if idx[i] < len(per_fork[i])]
            i = rng.choice(live)
            m.apply_changes([per_fork[i][idx[i]]])
            idx[i] += 1
        d = integrity.doc_digest(m.doc)
        want = want or d
        assert d == want


def test_digest_invariant_across_residency_modes(monkeypatch):
    from automerge_tpu_torch.ops.oplog import OpLog

    base, _t, forks = _build_forks(7)
    m = AutoDoc.load(base.save())
    for f in forks:
        m.merge(f)
    want = None
    for comp in ("1", "0"):
        monkeypatch.setenv("AUTOMERGE_TPU_COMPRESSED", comp)
        d = integrity.doc_digest(AutoDoc.load(m.save()).doc)
        want = want or d
        assert d == want, comp
    monkeypatch.setenv("AUTOMERGE_TPU_COMPRESSED", "1")
    log = OpLog.from_changes([a.stored for a in m.doc.history])
    dense = integrity.column_digests(log, source="dense")
    resident = integrity.column_digests(log, source="resident")
    assert dense == resident
    # the reference's digests of the same changes, decoded afresh
    import automerge_tpu.ops.extract as RX
    from automerge_tpu.ops.oplog import OpLog as ROpLog
    from automerge_tpu.storage.change import parse_change as rparse

    if RX._CHANGE_COLS_CACHE is not None:
        RX._CHANGE_COLS_CACHE.clear()
    rlog = ROpLog.from_changes(
        [rparse(a.stored.raw_bytes)[0] for a in m.doc.history])
    assert RI.column_digests(rlog, source="dense") == dense
    assert RI.column_digests(rlog, source="resident") == resident


def test_durable_digest_incremental_matches_full(tmp_path):
    dd = AutoDoc.open(str(tmp_path / "d1"))
    base, _t, forks = _build_forks(9, n_forks=2, edits=3)
    dd.merge(base)
    for f in forks:
        dd.merge(f)
    got = dd.doc_digest()
    assert got == integrity.doc_digest(dd._core)
    dd.close()
    dd2 = AutoDoc.open(str(tmp_path / "d1"))
    assert dd2.doc_digest() == got
    dd2.close()
    rd = RA.AutoDoc.open(str(tmp_path / "d1"))  # the reference's reading
    assert rd.doc_digest() == got
    rd.close()


# -- read-back verification -----------------------------------------------------


def test_verify_doc_dir_clean_and_first_bad_offset(tmp_path):
    dd = AutoDoc.open(str(tmp_path / "v"))
    dd.put("_root", "k", "v" * 200)
    dd.commit()
    dd.compact()
    dd.close()
    path = str(tmp_path / "v")
    reports = integrity.verify_doc_dir(path)
    assert len(reports) == 2 and all(r.ok for r in reports), reports
    _flip_byte(os.path.join(path, SNAPSHOT_NAME))
    bad = [r for r in integrity.verify_doc_dir(path) if not r.ok]
    assert [r.kind for r in bad] == ["snapshot"]
    assert bad[0].first_bad_offset is not None


def test_verify_journal_detects_mid_file_rot(tmp_path):
    dd = AutoDoc.open(str(tmp_path / "j"))
    for i in range(6):
        dd.put("_root", f"k{i}", "payload-%03d" % i)
        dd.commit()
    dd.close()
    jpath = os.path.join(str(tmp_path / "j"), JOURNAL_NAME)
    r = integrity.verify_journal_bytes(open(jpath, "rb").read())
    assert r.ok and r.units >= 6
    _flip_byte(jpath, frac=0.6)
    r = integrity.verify_journal_bytes(open(jpath, "rb").read())
    assert not r.ok and r.valid_bytes < r.total_bytes
    assert r.first_bad_offset == r.valid_bytes


@pytest.mark.parametrize("runsnap_env", ["1", "0"])
def test_verify_reports_equal_reference_on_seeded_corruption(
        tmp_path, monkeypatch, runsnap_env):
    monkeypatch.setenv("AUTOMERGE_TPU_RUNSNAP", runsnap_env)
    path = str(tmp_path / "s")
    dd = AutoDoc.open(path, actor=actor(2))
    t = dd.put_object("_root", "t", ObjType.TEXT)
    for i in range(8):
        dd.splice_text(t, dd.length(t), 0, f"x{i} ")
        dd.commit(timestamp=i + 1)
    dd.compact()
    for i in range(4):
        dd.put("_root", f"k{i}", i)
        dd.commit(timestamp=20 + i)
    dd.close()
    assert [tuple(r) for r in integrity.verify_doc_dir(path)] == \
        [tuple(r) for r in RI.verify_doc_dir(path)]
    rng = np.random.default_rng(int(runsnap_env))
    for name, fn, rfn in ((SNAPSHOT_NAME, integrity.verify_snapshot_bytes,
                           RI.verify_snapshot_bytes),
                          (JOURNAL_NAME, integrity.verify_journal_bytes,
                           RI.verify_journal_bytes)):
        data = open(os.path.join(path, name), "rb").read()
        for _ in range(12):
            bad = bytearray(data)
            kind = int(rng.integers(0, 3))
            if kind == 0:
                bad[int(rng.integers(0, len(bad)))] ^= 1 << int(rng.integers(0, 8))
            elif kind == 1:
                bad = bad[: int(rng.integers(0, len(bad)))]
            else:
                bad += rng.bytes(int(rng.integers(1, 16)))
            got, want = fn(bytes(bad)), rfn(bytes(bad))
            assert tuple(got) == tuple(want), (name, kind)


def test_compressed_verify_against_catches_divergence(monkeypatch):
    from automerge_tpu_torch.ops.oplog import OpLog

    base, _t, forks = _build_forks(21, n_forks=2)
    m = AutoDoc.load(base.save())
    for f in forks:
        m.merge(f)
    log = OpLog.from_changes([a.stored for a in m.doc.history])
    comp = log.compressed(sync=True)
    assert comp is not None
    assert comp.verify_against(log) == []
    for name in ("action", "obj_dense", "prop"):
        arr = getattr(log, name, None)
        ent = comp.entries.get(name)
        if arr is not None and ent is not None and comp.covered.get(name, 0) > 0:
            old = arr[0]
            arr[0] = old + 1
            try:
                assert name in comp.verify_against(log)
            finally:
                arr[0] = old
            assert comp.verify_against(log) == []
            return
    raise AssertionError("no run-coded column to tamper with")


# -- the scrubber ----------------------------------------------------------------


@pytest.fixture
def server(tmp_path):
    s = MiniServer(tmp_path / "docs")
    yield s
    s.close()


def test_scrubber_repairs_live_doc_bit_rot_with_zero_loss(server):
    s = server
    dd = s.open("live")
    for i in range(5):
        dd.put("_root", f"k{i}", i)
        dd.commit()
    digest_before = dd.doc_digest()
    path = s._durable_path("live")
    _flip_byte(os.path.join(path, JOURNAL_NAME), frac=0.5)
    scrub = integrity.Scrubber(s, interval=3600, sample=8)
    summary = scrub.run_round()
    assert summary["corrupt"] >= 1 and summary["repaired"] >= 1, summary
    assert pobs.counter_values("journal.scrub_repaired", "kind") == {"live": 1}
    assert all(r.ok for r in integrity.verify_doc_dir(path))
    assert dd.doc_digest() == digest_before
    assert dd.hydrate() == {f"k{i}": i for i in range(5)}
    summary = scrub.run_round()
    assert summary["corrupt"] == 0 and summary["files"] == 1
    assert _ctr("journal.scrub_clean") >= 1
    assert _ctr("scrub.rounds") == 2


def test_scrubber_detects_cold_doc_rot_and_salvages(server):
    s = server
    dd = s.open("cold")
    dd.put("_root", "k", "vv")
    dd.commit()
    s.store.demote("cold", TIER_COLD := "cold")
    path = s._durable_path("cold")
    _flip_byte(os.path.join(path, JOURNAL_NAME), frac=0.7)
    summary = integrity.Scrubber(s, interval=3600).run_round()
    assert summary["corrupt"] >= 1, summary
    assert pobs.counter_values("journal.scrub_repaired", "kind") == {"salvage": 1}
    assert all(r.ok for r in integrity.verify_doc_dir(path))
    assert s.store.tier("cold") != TIER_COLD  # the repair hydrated it


class _Peer:
    """A one-request-per-connection peer answering ``replHarvest`` with a
    document's full state, on a localhost port."""

    def __init__(self, snapshot):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self.snapshot = snapshot
        self.requests = []
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.sock.accept()
        with conn:
            f = conn.makefile("r")
            req = json.loads(f.readline())
            self.requests.append(req)
            res = {"snapshot": base64.b64encode(self.snapshot).decode("ascii")}
            conn.sendall((json.dumps({"id": req["id"], "result": res})
                          + "\n").encode("utf-8"))

    def close(self):
        self.thread.join(timeout=10)
        self.sock.close()


def test_scrubber_repairs_cold_doc_from_a_peer(server, tmp_path):
    s = server
    dd = s.open("pc")
    for i in range(4):
        dd.put("_root", f"k{i}", i)
        dd.commit()
    healthy = dd.save()
    s.store.demote("pc", "cold")  # compacts: the snapshot holds it all
    # the snapshot's second half lost: only the peer still has it
    sp = os.path.join(s._durable_path("pc"), SNAPSHOT_NAME)
    data = open(sp, "rb").read()
    open(sp, "wb").write(data[: len(data) // 2])
    peer = _Peer(healthy)
    s.leader_hint = peer.addr
    try:
        summary = integrity.Scrubber(s, interval=3600).run_round()
    finally:
        peer.close()
    assert peer.requests[0]["method"] == "replHarvest"
    assert peer.requests[0]["params"] == {"name": "pc"}
    assert summary["repaired"] == 1, summary
    assert pobs.counter_values("journal.scrub_repaired", "kind") == {"peer": 1}
    assert s.doc("pc").hydrate() == {f"k{i}": i for i in range(4)}
    assert all(r.ok for r in integrity.verify_doc_dir(s._durable_path("pc")))


def test_scrubber_chaos_bitflip_detected_without_disk_damage(server):
    from automerge_tpu_torch.storage.crashsim import FaultyFS

    s = server
    fs = s._chaos_fs["bf"] = FaultyFS()
    dd = s.open("bf")
    dd.put("_root", "k", 1)
    dd.commit()
    fs.arm("read", "BITFLIP", count=1)
    scrub = integrity.Scrubber(s, interval=3600)
    summary = scrub.run_round()
    assert summary["corrupt"] >= 1, summary
    assert pobs.counter_values("chaos.injected", "kind").get("disk_read_flip") == 1
    summary = scrub.run_round()
    assert summary["corrupt"] == 0, summary


def test_scrubber_drops_a_mirror_that_disagrees_with_its_columns(server):
    s = server
    dd = s.open("mir", mirror=True)
    t = dd.put_object("_root", "t", ObjType.TEXT)
    dd.splice_text(t, 0, 0, "hello " * 40)
    dd.commit()
    s.store.demote("mir", "warm")
    s.doc("mir")  # promotes: the mirror holds the text
    assert s.store.tier("mir") == "hot"
    dev = dd.device_doc
    assert dev.audit_columns() == []
    scrub = integrity.Scrubber(s, interval=3600)
    assert scrub.run_round()["divergent"] == 0
    comp = dev.log.compressed(sync=True)
    name = next(n for n in ("action", "obj_dense", "prop")
                if comp.entries.get(n) not in (None, "dense"))
    getattr(dev.log, name)[0] += 1  # silent rot under a run entry
    summary = scrub.run_round()
    assert summary["divergent"] == 1 and summary["mirrors"] == 1, summary
    assert pobs.counter_values("device.mirror_divergence", "column") == {name: 1}
    assert dd.device_doc is None and s.store.tier("mir") == "warm"
    assert pobs.counter_values("store.demotions", "reason").get("integrity") == 1


def test_faultyfs_read_bitflip_semantics(tmp_path):
    from automerge_tpu_torch.storage.crashsim import FaultyFS

    p = str(tmp_path / "blob")
    with open(p, "wb") as f:
        f.write(b"A" * 64)
    fs = FaultyFS()
    fs.arm("read", "BITFLIP", count=1)
    flipped = fs.read_bytes(p)
    assert len(flipped) == 64
    assert sum(a != b for a, b in zip(flipped, b"A" * 64)) == 1
    assert fs.read_bytes(p) == b"A" * 64
    with pytest.raises(ValueError):
        fs.arm("write", "BITFLIP")
    fs.arm("read", "EIO", count=1)
    with pytest.raises(OSError):
        fs.read_bytes(p)


def test_digest_gauge_removed_on_close_and_demotion(server):
    s = server

    def gauge(name):
        for e in pobs.snapshot():
            if (e["name"] == "doc.digest_changes"
                    and e["labels"].get("doc") == name):
                return e["value"]
        return None

    dd = s.open("g1")
    dd.put("_root", "k", 1)
    dd.commit()
    assert gauge("g1") == 1
    s.store.demote("g1", "cold")
    assert gauge("g1") is None
    dd2 = s.open("g2")
    dd2.put("_root", "k", 1)
    dd2.commit()
    assert gauge("g2") == 1
    dd2.close()
    assert gauge("g2") is None


def test_scrub_knobs_equal_reference(monkeypatch):
    monkeypatch.setenv("AUTOMERGE_TPU_SCRUB_INTERVAL", "2.5")
    monkeypatch.setenv("AUTOMERGE_TPU_SCRUB_SAMPLE", "3")
    monkeypatch.setenv("AUTOMERGE_TPU_SCRUB", "0")
    p, r = integrity.Scrubber(object()), RI.Scrubber(object())
    assert (p.interval, p.sample) == (r.interval, r.sample) == (2.5, 3)
    assert integrity.scrub_enabled() is RI.scrub_enabled() is False
    p.start()
    assert p._thread is None  # switched off


# -- durable sync peers (the reference's test_sync_faults.py) --------------------


def test_durable_peer_restart_resumes_without_full_resync(tmp_path):
    a = AutoDoc(actor=actor(1))
    for i in range(4):
        a.put("_root", f"a{i}", i)
        a.commit()
    bd = AutoDoc.open(str(tmp_path / "b"), fsync="never", actor=actor(2))
    bd.put("_root", "b0", 0)
    bd.commit()
    sa = SyncSession(a, epoch=1)
    sb = bd.attach_sync_session("peer-a", SyncSession(bd, epoch=2))
    stats = SyncDriver(a, bd, session_a=sa, session_b=sb).run()
    assert stats.converged
    shared = list(sb.state.shared_heads)
    assert shared
    assert "sync/peer-a" in bd.meta
    bd.close()

    bd2 = AutoDoc.open(str(tmp_path / "b"))
    sb2 = bd2.restore_sync_session("peer-a")
    assert sb2.state.shared_heads == shared
    assert sb2.epoch != sb.epoch
    a.put("_root", "new_a", 1)
    a.commit()
    bd2.put("_root", "new_b", 2)
    bd2.commit()
    stats2 = SyncDriver(a, bd2, session_a=sa, session_b=sb2).run()
    assert stats2.converged
    assert a.get_heads() == bd2.get_heads()
    assert sa.stats["resets"] >= 1
    assert stats2.a["resyncs"] + stats2.b["resyncs"] == 0
    assert sb2.state.shared_heads

    shared2 = list(sb2.state.shared_heads)
    bd2.close()
    bd3 = AutoDoc.open(str(tmp_path / "b"))
    sb3 = bd3.restore_sync_session("peer-a")
    assert sb3.state.shared_heads == shared2
    a.put("_root", "new_a2", 3)
    a.commit()
    drv = SyncDriver(
        a, bd3,
        FaultyChannel(seed=11, drop=0.2, dup=0.2, reorder=0.2),
        FaultyChannel(seed=12, drop=0.2, dup=0.2, reorder=0.2),
        session_a=sa, session_b=sb3,
    )
    stats3 = drv.run(max_ticks=MAX_TICKS)
    assert stats3.converged
    assert a.get_heads() == bd3.get_heads()
    bd3.close()


def test_durable_peer_with_a_mirror_feeds_it(tmp_path):
    """The restored session's ``device_doc`` is the wrapper's mirror: the
    changes it receives reach the mirror, and the meta record of the
    persisted shared heads rides the same ack."""
    a = AutoDoc(actor=actor(1))
    for i in range(3):
        a.put("_root", f"a{i}", i)
        a.commit()
    bd = AutoDoc.open(str(tmp_path / "b"), fsync="never", actor=actor(2),
                      mirror=True)
    sb = bd.restore_sync_session("peer-a")
    assert sb.device_doc is bd.device_doc
    assert SyncDriver(a, bd, session_a=SyncSession(a, epoch=7),
                      session_b=sb).run().converged
    assert bd.device_doc.hydrate() == a.hydrate()
    assert sb.stats["device_feeds"]["apply_changes"] >= 1
    bd.close()


def test_durable_sync_state_survives_compaction(tmp_path):
    a = AutoDoc(actor=actor(3))
    a.put("_root", "x", 1)
    a.commit()
    bd = AutoDoc.open(str(tmp_path / "b"), fsync="never", actor=actor(4))
    sb = bd.attach_sync_session("a", SyncSession(bd, epoch=1))
    stats = SyncDriver(a, bd, session_a=SyncSession(a, epoch=2),
                       session_b=sb).run()
    assert stats.converged
    shared = list(sb.state.shared_heads)
    assert shared
    assert bd.compact()
    bd.close()
    bd2 = AutoDoc.open(str(tmp_path / "b"))
    assert bd2.restore_sync_session("a").state.shared_heads == shared
    bd2.close()


def test_durable_restore_bumps_epoch_even_without_progress(tmp_path):
    d = str(tmp_path / "b")
    bd = AutoDoc.open(d, fsync="never", actor=actor(6))
    bd.attach_sync_session("p", SyncSession(bd, epoch=1))._maybe_persist()
    bd.close()
    epochs = []
    for _ in range(3):
        bd = AutoDoc.open(d)
        epochs.append(bd.restore_sync_session("p").epoch)
        bd.close()
    assert len(set(epochs)) == 3, epochs


def test_durable_sync_receive_batches_fsync(tmp_path):
    peer = AutoDoc(actor=actor(7))
    for i in range(10):
        peer.put("_root", f"p{i}", i)
        peer.commit()
    gs = SyncSession(peer, epoch=5)
    gs.state.their_have = []
    gs.state.their_need = [c.hash for c in peer.doc.get_changes([])]
    frame = gs.poll(0)
    dd = AutoDoc.open(str(tmp_path / "b"), fsync="always", actor=actor(8))
    sess = SyncSession(dd, epoch=1)
    trace.reset_timers()
    assert sess.receive(frame, 0) is True
    t = trace.timing_summary()
    assert t["journal.append"]["n"] == 10
    assert t["journal.fsync"]["n"] == 1
    dd.close()


def test_durable_restore_unknown_peer_is_fresh(tmp_path):
    bd = AutoDoc.open(str(tmp_path / "b"), fsync="never", actor=actor(5))
    sess = bd.restore_sync_session("never-met")
    assert sess.state.shared_heads == []
    assert sess.epoch == 1
    bd.close()


# -- durable run images (the reference's test_runsnap.py) --------------------------


def roundtrip_digest(tmp_path, monkeypatch, name, env=None):
    with monkeypatch.context() as m:
        for k, v in (env or {}).items():
            m.setenv(k, v)
        p = str(tmp_path / name)
        d = AutoDoc.open(p, actor=actor(2))
        t = d.put_object("_root", "t", ObjType.TEXT)
        for i in range(12):
            d.splice_text(t, d.length(t), 0, f"x{i} ")
            d.commit(timestamp=i + 1)
        assert d.compact()
        d.put("_root", "tail", 1)
        d.commit(timestamp=100)
        dig = d.doc_digest()["digest"]
        text = d.text(t)
        d.close()
        snap = open(os.path.join(p, SNAPSHOT_NAME), "rb").read()
        d2 = AutoDoc.open(p)
        dig2 = d2.doc_digest()["digest"]
        assert d2.text(t) == text
        d2.close()
        return dig, dig2, snap


def test_digest_identity_all_modes(tmp_path, monkeypatch):
    a = roundtrip_digest(tmp_path, monkeypatch, "runsnap")
    b = roundtrip_digest(tmp_path, monkeypatch, "dense",
                         {"AUTOMERGE_TPU_COMPRESSED": "0"})
    c = roundtrip_digest(tmp_path, monkeypatch, "legacy",
                         {"AUTOMERGE_TPU_RUNSNAP": "0"})
    assert a[0] == a[1] == b[0] == b[1] == c[0] == c[1]
    assert runsnap.is_runsnap(a[2])
    assert runsnap.is_runsnap(b[2])
    assert not runsnap.is_runsnap(c[2])
    assert runsnap.parse(a[2]).flags & runsnap.FLAG_COMPRESSED
    assert not runsnap.parse(b[2]).flags & runsnap.FLAG_COMPRESSED


def test_legacy_snapshot_upgrade(tmp_path, monkeypatch):
    p = str(tmp_path / "up")
    with monkeypatch.context() as m:
        m.setenv("AUTOMERGE_TPU_RUNSNAP", "0")
        d = AutoDoc.open(p, actor=actor(3))
        for i in range(6):
            d.put("_root", f"k{i}", i)
            d.commit()
        assert d.compact()
        dig = d.doc_digest()["digest"]
        d.close()
    assert not runsnap.is_runsnap(open(os.path.join(p, SNAPSHOT_NAME), "rb").read())
    d2 = AutoDoc.open(p)
    assert d2.doc_digest()["digest"] == dig
    assert d2.compact()
    d2.close()
    assert runsnap.is_runsnap(open(os.path.join(p, SNAPSHOT_NAME), "rb").read())
    d3 = AutoDoc.open(p)
    assert d3.doc_digest()["digest"] == dig
    d3.close()


def test_cold_open_zero_reencode(tmp_path, monkeypatch):
    p = str(tmp_path / "zero")
    d = AutoDoc.open(p, actor=actor(4))
    for i in range(10):
        d.put("_root", f"k{i}", i)
        d.commit()
    assert d.compact()
    d.close()
    trace.reset_counters()
    d2 = AutoDoc.open(p, mirror=True)
    assert trace.counters.get("oplog.hydrate_reencode", 0) == 0
    assert d2.device_doc is not None
    d2.close()
    trace.reset_counters()
    d3 = AutoDoc.open(p)
    d3.build_device_mirror()
    d3.drop_device_mirror()
    d3.build_device_mirror()
    assert trace.counters.get("oplog.hydrate_reencode", 0) == 0
    d3.close()
    with monkeypatch.context() as m:
        m.setenv("AUTOMERGE_TPU_RUNSNAP", "0")
        d4 = AutoDoc.open(p)
        assert d4.compact()
        d4.close()
        trace.reset_counters()
        d5 = AutoDoc.open(p, mirror=True)
        assert trace.counters.get("oplog.hydrate_reencode", 0) > 0
        d5.close()


def _codec_bytes():
    return dict(pobs.counter_values("store.hydrate_bytes", "codec"))


def test_hydrate_bytes_codec_labels(tmp_path, monkeypatch):
    p = str(tmp_path / "lab")
    d = AutoDoc.open(p, actor=actor(5))
    d.put("_root", "k", 1)
    d.commit()
    assert d.compact()
    d.close()
    before = _codec_bytes()
    AutoDoc.open(p).close()
    after = _codec_bytes()
    assert after.get("runsnap", 0) > before.get("runsnap", 0)
    assert after.get("chunk", 0) == before.get("chunk", 0)
    with monkeypatch.context() as m:
        m.setenv("AUTOMERGE_TPU_RUNSNAP", "0")
        d2 = AutoDoc.open(p)
        assert d2.compact()
        d2.close()
    before = _codec_bytes()
    AutoDoc.open(p).close()
    after = _codec_bytes()
    assert after.get("chunk", 0) > before.get("chunk", 0)


def test_replicated_snapshot_ships_arsn_verbatim(tmp_path):
    p1 = str(tmp_path / "leader")
    d1 = AutoDoc.open(p1, actor=actor(6))
    t = d1.put_object("_root", "t", ObjType.TEXT)
    for i in range(9):
        d1.splice_text(t, d1.length(t), 0, f"s{i} ")
        d1.commit()
    blob = d1.snapshot_bytes()
    assert runsnap.is_runsnap(blob)
    dig = d1.doc_digest()["digest"]
    d2 = AutoDoc.open(str(tmp_path / "follower"), actor=actor(7))
    before = _codec_bytes()
    d2.apply_replicated_snapshot(blob, b"cursor-1")
    after = _codec_bytes()
    assert d2.doc_digest()["digest"] == dig
    assert d2.text(t) == d1.text(t)
    assert d2._run_image is not None
    assert after.get("runsnap", 0) - before.get("runsnap", 0) == len(blob)
    bad = bytearray(blob)
    bad[len(blob) // 2] ^= 0xFF
    d3 = AutoDoc.open(str(tmp_path / "f2"), actor=actor(8))
    with pytest.raises(runsnap.RunSnapError):
        d3.apply_replicated_snapshot(bytes(bad), None)
    d3.close()
    # the reference's follower takes the port leader's image verbatim too
    rd = RA.AutoDoc.open(str(tmp_path / "rf"), actor=RT.ActorId(bytes([7]) * 16))
    rd.apply_replicated_snapshot(blob, b"cursor-1")
    assert rd.doc_digest()["digest"] == dig
    rd.close()
    d1.close()
    d2.close()


def test_corrupt_arsn_salvages_embedded_changes(tmp_path):
    p = str(tmp_path / "sal")
    d = AutoDoc.open(p, actor=actor(9))
    for i in range(5):
        d.put("_root", f"k{i}", i)
        d.commit()
    assert d.compact()
    n_changes = len(d.doc.history)
    d.close()
    sp = os.path.join(p, SNAPSHOT_NAME)
    blob = bytearray(open(sp, "rb").read())
    blob[8] ^= 0xFF
    open(sp, "wb").write(bytes(blob))
    d2 = AutoDoc.open(p)
    assert len(d2.doc.history) == n_changes
    assert d2._run_image is None
    d2.close()
