"""The port's cluster tier (``automerge_tpu_torch/cluster/``) against the
JAX package's, on the CPU: the hash ring, the replication wire codecs,
``_wire_blob``, leader/follower pairs of each package and the two mixed
pairings over real sockets, a mirrored follower's batched drain, the
serial knob, and the port's own rules (a failed follower feed answers
with the error, a snapshot resync rebuilds the mirror).

Every pair runs in this process as threads over TCP, as the reference's
``tests/test_cluster.py`` runs it: the port's nodes on ``device="cpu"``,
the JAX package's on its CPU backend. Random actors and stream ids are
made sequential in both packages, so both write the same bytes. Every
wait polls with a deadline of at least 60 s; nothing sleeps to
synchronise. The router, migration, failover, chaos, the advisor, the
scrubber's follower passes and ``rpc.main``'s cluster mode are in
``tests/test_torch_cluster_router.py``.
"""

import json
import os
import socket
import time
import types as pytypes
import uuid

import numpy as np
import pytest

import automerge_tpu.cluster as RC
import automerge_tpu_torch.cluster as PC
from automerge_tpu import obs as robs
from automerge_tpu.cluster import node as rnode
from automerge_tpu_torch import obs as pobs
from automerge_tpu_torch.cluster import node as pnode
from automerge_tpu_torch.ops.device_doc import DeviceDoc as PDeviceDoc
from automerge_tpu_torch.ops.oplog import OpLog as POpLog
from automerge_tpu_torch.storage import durable as PD

TIMEOUT = 60.0  # seconds: every socket read and every wait
PACKAGES = {"ref": RC, "port": PC}
OBS = {"ref": robs, "port": pobs}


# -- fixtures and helpers (the router tests import these) ---------------------


@pytest.fixture(autouse=True)
def _fresh_obs():
    robs.reset_all()
    pobs.reset_all()
    yield


@pytest.fixture(autouse=True)
def _reference_decodes_fresh(monkeypatch):
    """The JAX package's logs number props in the order of its per-change
    key tables, which keep the key table of whatever batch first decoded
    the change (ROADMAP §3); its column builds here start from changes
    with no such residue, as the port's always do."""
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


class Sequential:
    """Random actors (``types.uuid``) and replication stream ids
    (``cluster.replication.uuid``) of both packages drawn from one
    counter, so a run draws the same sequence whichever package each
    node is; ``reset()`` restarts it."""

    def __init__(self, monkeypatch):
        import automerge_tpu.cluster.replication as RR
        import automerge_tpu.types as RT
        import automerge_tpu_torch.cluster.replication as PRp
        import automerge_tpu_torch.types as PT

        self.fakes = {}
        for mod in (RT, PT, RR, PRp):
            fake = pytypes.SimpleNamespace()
            monkeypatch.setattr(mod, "uuid", fake)
            self.fakes[mod] = fake
        self.reset()

    def reset(self):
        counter = iter(range(1, 1 << 30))
        for fake in self.fakes.values():
            # the counter in the high bits: a stream id keeps 12 hex digits
            fake.uuid4 = lambda c=counter: uuid.UUID(int=(next(c) << 96) | (0xA5 << 88))


@pytest.fixture
def seq(monkeypatch):
    return Sequential(monkeypatch)


class Client:
    """A JSON-line client with a read timeout (no call can hang)."""

    def __init__(self, address):
        self.sock = socket.create_connection(tuple(address), timeout=TIMEOUT)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.f = self.sock.makefile("r")
        self.rid = 0

    def raw(self, method, **params):
        self.rid += 1
        self.sock.sendall((json.dumps(
            {"id": self.rid, "method": method, "params": params}) + "\n").encode())
        line = self.f.readline()
        assert line, f"{method}: connection closed"
        return json.loads(line)

    def call(self, method, allow_error=False, **params):
        resp = self.raw(method, **params)
        if not allow_error:
            assert "error" not in resp, resp
        return resp if "error" in resp else resp.get("result")

    def close(self):
        self.sock.close()


def addr_of(node):
    return "%s:%d" % tuple(node.address)


def start_node(pkg, root, name, **kw):
    if pkg == "port":
        kw.setdefault("device", "cpu")
    node = PACKAGES[pkg].ClusterNode(
        node_id=name, host="127.0.0.1", port=0,
        durable_dir=os.path.join(str(root), name), **kw)
    node.start()
    return node


def wait_until(pred, timeout=TIMEOUT, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def cursor_lsn(node, name):
    """The follower's persisted cursor LSN for ``name`` (None: none)."""
    cur = ((node.rpc.clusterStatus({}).get("docs") or {}).get(name) or {}).get("cursor")
    return None if cur is None else cur["lsn"]


def read_files(root):
    """{relative path: bytes} of every document file under ``root``."""
    out = {}
    for name in sorted(os.listdir(root)):
        for f in (PD.SNAPSHOT_NAME, PD.JOURNAL_NAME):
            p = os.path.join(root, name, f)
            if os.path.exists(p):
                with open(p, "rb") as fh:
                    out[f"{name}/{f}"] = fh.read()
    return out


def assert_same_mirror(dev, other, where=""):
    """Equal on every READ_FETCH array and on ``hydrate``."""
    n = dev.log.n
    assert (n, dev.log.n_objs) == (other.log.n, other.log.n_objs), where
    for k in PDeviceDoc.READ_FETCH:
        cut = dev.log.n_objs + 2 if k.startswith("obj_") else n
        np.testing.assert_array_equal(np.asarray(dev.res[k])[:cut],
                                      np.asarray(other.res[k])[:cut],
                                      err_msg=f"{where} {k}")
    assert json.dumps(dev.hydrate(), default=repr, sort_keys=True) == json.dumps(
        other.hydrate(), default=repr, sort_keys=True), where


def fresh_resolve(doc):
    """A port ``DeviceDoc`` resolved afresh from a durable document's
    history (what a mirror must equal)."""
    log = POpLog.from_changes([a.stored for a in doc._core.history])
    return PDeviceDoc.resolve(log, device="cpu")


def replica(node, name):
    with node.rpc._lock:
        return node.rpc._docs.get(node.rpc._durable_names.get(name))


VALUES = [1, -7, 2.5, "str", True, None, {"$counter": 3}]


def seeded_writes(c, d, rng, n, text):
    """``n`` seeded writes of document ``d``, each committed: the answers
    (``commit``'s hash included) in order."""
    out = []
    for i in range(n):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            out.append(c.raw("put", doc=d, obj="_root", prop=f"k{int(rng.integers(0, 5))}",
                             value=VALUES[int(rng.integers(0, len(VALUES)))]))
        elif kind == 1:
            ln = c.call("length", doc=d, obj=text)
            out.append(c.raw("spliceText", doc=d, obj=text,
                             pos=int(rng.integers(0, ln + 1)), text=f"w{i}"))
        else:
            out.append(c.raw("increment", doc=d, obj="_root", prop="n",
                             by=int(rng.integers(1, 4))))
        out.append(c.raw("commit", doc=d, message=f"step {i}"))
    return out


STATUS_KEYS = ("acked", "appended", "cursor", "digest", "digestChanges", "lsn")


def status_view(status):
    """``clusterStatus`` less its clocks and staleness: per document the
    journal prefix, cursor, digest and LSN; the role and stream."""
    return {"role": status["role"], "stream": status.get("stream"),
            "docs": {n: {k: v for k, v in info.items() if k in STATUS_KEYS}
                     for n, info in status["docs"].items()}}


DOCS = ("da", "db")


def drive_pair(root, seq, leader_pkg, follower_pkg, writes=6):
    """A leader of ``leader_pkg`` replicating to a follower of
    ``follower_pkg`` (``ack_replicas=1``), driven by one client with
    seeded writes to two documents. Returns the answers, both nodes'
    status views and both directories' files."""
    seq.reset()
    fol = start_node(follower_pkg, root, "f", role="follower")
    led = start_node(leader_pkg, root, "l", role="leader",
                     replicate_to=[addr_of(fol)], ack_replicas=1)
    try:
        c = Client(led.address)
        answers, handles = [], {}
        for name in DOCS:
            r = c.raw("openDurable", name=name)
            answers.append(r)
            handles[name] = r["result"]["doc"]
            # the follower's snapshot of the empty document lands before
            # the first write, so every change ships as a tail record
            wait_until(lambda: cursor_lsn(fol, name) is not None,
                       msg=f"{name}'s snapshot on the follower")
            d = handles[name]
            answers.append(c.raw("putObject", doc=d, obj="_root", prop="t", type="text"))
            answers.append(c.raw("put", doc=d, obj="_root", prop="n", value={"$counter": 0}))
            answers.append(c.raw("commit", doc=d))
        rng = np.random.default_rng(7)
        for _ in range(2):
            for name in DOCS:
                text = c.call("get", doc=handles[name], obj="_root", prop="t")["$obj"]
                answers.extend(seeded_writes(c, handles[name], rng, writes // 2, text))
        for name in DOCS:
            d = handles[name]
            answers.append(c.raw("materialize", doc=d))
            answers.append(c.raw("getHeads", doc=d))
            answers.append(c.raw("docDigest", doc=d))
        lsns = led.rpc.hub.doc_lsns()
        for name in DOCS:
            wait_until(lambda: cursor_lsn(fol, name) == lsns[name],
                       msg=f"{name} level on the follower")
        fc = Client(fol.address)
        answers.append(fc.raw("put", doc=1, obj="_root", prop="x", value=1))  # NotLeader
        status = (status_view(led.rpc.clusterStatus({})),
                  status_view(fol.rpc.clusterStatus({})))
        c.close()
        fc.close()
    finally:
        led.stop()
        fol.stop()
    return answers, status, read_files(os.path.join(str(root), "l")), read_files(
        os.path.join(str(root), "f"))


# -- pure units ---------------------------------------------------------------


def test_ring_placement_and_movement_equal_for_1000_seeded_names():
    rng = np.random.default_rng(3)
    names = [f"doc-{int(x):x}" for x in rng.integers(0, 1 << 48, 1000)]
    members = ["g0", "g1", "g2", "g3"]
    r, p = RC.HashRing(members, vnodes=64), PC.HashRing(members, vnodes=64)
    assert [p.member_for(n) for n in names] == [r.member_for(n) for n in names]
    for ring in (r, p):
        ring.remove("g2")
        ring.add("g4")
    assert [p.member_for(n) for n in names] == [r.member_for(n) for n in names]
    assert p.members == r.members and len(p) == len(r) and ("g4" in p) == ("g4" in r)
    with pytest.raises(ValueError):
        PC.HashRing(vnodes=0)
    with pytest.raises(ValueError):
        PC.HashRing().member_for("x")


def test_batch_and_cursor_codecs_are_byte_equal_and_cross_decode():
    from automerge_tpu.storage.journal import JournalError as RJE
    from automerge_tpu_torch.storage.journal import REC_CHANGE, REC_META
    from automerge_tpu_torch.storage.journal import JournalError as PJE

    rng = np.random.default_rng(5)
    records = [((REC_CHANGE, REC_META)[int(rng.integers(0, 2))],
                bytes(rng.integers(0, 256, int(n), dtype=np.uint8)))
               for n in rng.integers(0, 300, 24)]
    rb, pb = RC.encode_batch(records), PC.encode_batch(records)
    assert pb == rb
    assert PC.decode_batch(rb) == RC.decode_batch(pb) == records
    for stream, lsn in (("n1/abc", 0), ("node-7/0123456789ab", 991), ("é/x", 1 << 40)):
        rc, pc = RC.encode_cursor(stream, lsn), PC.encode_cursor(stream, lsn)
        assert pc == rc
        assert PC.decode_cursor(rc) == RC.decode_cursor(pc) == (stream, lsn)
    wire = bytearray(pb)
    wire[10] ^= 0xFF
    with pytest.raises(RJE):
        RC.decode_batch(bytes(wire))
    with pytest.raises(PJE):
        PC.decode_batch(bytes(wire))
    assert PC.decode_batch(b"") == []


@pytest.mark.parametrize("compressed", ["1", "0"])
def test_wire_blob_equal_on_both_sides_of_compressed(compressed, monkeypatch):
    monkeypatch.setenv("AUTOMERGE_TPU_COMPRESSED", compressed)
    rng = np.random.default_rng(9)
    blobs = [b"", b"x" * 100, b"ab" * 400, bytes(rng.integers(0, 256, 2048, dtype=np.uint8)),
             bytes(rng.integers(0, 4, 4096, dtype=np.uint8))]
    codecs = []
    for data in blobs:
        got, want = pnode._wire_blob(data), rnode._wire_blob(data)
        assert got == want
        assert pnode._unwire_blob(*want) == rnode._unwire_blob(*got) == data
        codecs.append(got[1])
    assert ("zlib" in codecs) == (compressed == "1")
    assert pobs.legacy_counters["cluster.migrate_raw_bytes"] == \
        robs.legacy_counters["cluster.migrate_raw_bytes"] == sum(map(len, blobs))
    assert pobs.legacy_counters["cluster.migrate_wire_bytes"] == \
        robs.legacy_counters["cluster.migrate_wire_bytes"]


# -- leader/follower pairs ------------------------------------------------------


@pytest.mark.parametrize("leader,follower", [("port", "port"), ("ref", "port"),
                                             ("port", "ref")])
def test_pairs_answer_and_write_as_the_jax_pair(leader, follower, tmp_path, seq):
    """One seeded client run through a JAX leader and follower, then the
    same through the pair under test (both the port's, or one of each):
    the same answers, the same ``clusterStatus`` (journal prefixes,
    cursors, digests, LSNs), and byte for byte the same ``snapshot.am``
    and ``journal.waj`` on the leader and on the follower."""
    want = drive_pair(tmp_path / "want", seq, "ref", "ref")
    got = drive_pair(tmp_path / "got", seq, leader, follower)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert sorted(got[2]) == sorted(want[2]) == [
        f"{n}/{PD.JOURNAL_NAME}" for n in DOCS]
    assert got[2] == want[2], "the leaders' files differ"
    assert got[3] == want[3], "the followers' files differ"
    # the follower's journal holds the cursor records of the stream
    assert got[1][1]["docs"]["da"]["cursor"]["stream"] == got[1][0]["stream"]


def mirrored_pair(pkg, root, names, **kw):
    """A follower with ``names`` opened mirrored (``{"device": true}``)
    before its leader exists, then the leader (``ack_replicas=1``) with
    the documents opened and snapshotted over. Returns (leader,
    follower, leader client, leader handles)."""
    fol = start_node(pkg, root, "f", role="follower", **kw)
    fc = Client(fol.address)
    for name in names:
        fc.call("openDurable", name=name, device=True)
    fc.close()
    led = start_node(pkg, root, "l", role="leader", replicate_to=[addr_of(fol)],
                     ack_replicas=1, **kw)
    c = Client(led.address)
    handles = {}
    for name in names:
        handles[name] = c.call("openDurable", name=name)["doc"]
        wait_until(lambda: cursor_lsn(fol, name) is not None, msg=f"{name} snapshot")
    return led, fol, c, handles


def test_mirrored_follower_equals_the_jax_follower_after_every_drain(tmp_path, seq):
    """Three mirrored replicas on a follower of each package, the same
    seeded writes through both leaders: after every acked commit (the ack
    comes after the follower's drain, its mirror feed included) the
    port's mirror equals the JAX package's on every READ_FETCH array and
    on ``hydrate``, and a fresh resolve of the port follower's history."""
    names = ("ma", "mb", "mc")
    seq.reset()
    ref = mirrored_pair("ref", tmp_path / "ref", names)
    seq.reset()
    port = mirrored_pair("port", tmp_path / "port", names)
    try:
        rng = np.random.default_rng(12)
        texts = {}
        for side in (ref, port):
            c, handles = side[2], side[3]
            for name in names:
                t = c.call("putObject", doc=handles[name], obj="_root", prop="t",
                           type="text")["$obj"]
                c.call("commit", doc=handles[name])
                texts[(id(side), name)] = t
        for step in range(12):
            name = names[int(rng.integers(0, len(names)))]
            pos = int(rng.integers(0, 3))
            for side in (ref, port):
                c, h = side[2], side[3][name]
                t = texts[(id(side), name)]
                ln = c.call("length", doc=h, obj=t)
                c.call("spliceText", doc=h, obj=t, pos=min(pos, ln), text=f"s{step}")
                c.call("put", doc=h, obj="_root", prop=f"p{step % 3}", value=step)
                c.call("commit", doc=h)
            rdoc, pdoc = replica(ref[1], name), replica(port[1], name)
            with rdoc.lock, pdoc.lock:
                assert pdoc.device_doc.device.type == "cpu"
                assert_same_mirror(pdoc.device_doc, rdoc.device_doc, f"step {step}")
                assert_same_mirror(pdoc.device_doc, fresh_resolve(pdoc), f"step {step}")
        for o in OBS.values():
            hist = [e for e in o.snapshot() if e["name"] == "cluster.repl_apply_batch_size"]
            assert hist and hist[0]["count"] > 0
        assert pobs.legacy_counters.get("cluster.repl_device_feed_error", 0) == 0
    finally:
        for side in (ref, port):
            side[2].close()
            side[0].stop()
            side[1].stop()


def test_serial_knob_leaves_the_mirror_unfed_in_both_packages(tmp_path, monkeypatch, seq):
    """``AUTOMERGE_TPU_REPL_BATCH=0``: no coalesced drain, the mirror is
    not fed (``hydrate() == {}``, the reference's A/B baseline), the host
    replica converges."""
    monkeypatch.setenv("AUTOMERGE_TPU_REPL_BATCH", "0")
    for pkg in ("ref", "port"):
        led, fol, c, handles = mirrored_pair(pkg, tmp_path / pkg, ("ds",))
        try:
            if pkg == "port":
                assert fol.repl_batch is False
            d = handles["ds"]
            for i in range(4):
                c.call("put", doc=d, obj="_root", prop=f"k{i}", value=i)
                c.call("commit", doc=d)
            assert cursor_lsn(fol, "ds") >= 4
            doc = replica(fol, "ds")
            with doc.lock:
                assert doc.get("_root", "k3") is not None
                assert doc.device_doc.hydrate() == {}
            assert not [e for e in OBS[pkg].snapshot()
                        if e["name"] == "cluster.repl_apply_batch_size"]
        finally:
            c.close()
            led.stop()
            fol.stop()


def test_a_failed_follower_feed_is_answered_then_converges(tmp_path, monkeypatch, seq):
    """A mirror whose feed raises (a stand-in for the card failing):
    the JAX follower counts ``cluster.repl_device_feed_error``, drops the
    mirror and acks; the port's counts it, drops the mirror (hot to warm)
    and answers the ``replApply`` with the error. The port's leader
    counts one link error, reconnects, finds the follower's cursor past
    the batch (the host apply was journaled first) and ships on: no
    snapshot, no record lost, no second error. The next shipped batch
    touches the replica, which rebuilds its mirror from the history."""
    def boom(changes):
        raise RuntimeError("the card went away")

    for pkg in ("ref", "port"):
        o = OBS[pkg]
        led, fol, c, handles = mirrored_pair(pkg, tmp_path / pkg, ("df",))
        try:
            d = handles["df"]
            c.call("put", doc=d, obj="_root", prop="a", value=1)
            c.call("commit", doc=d)
            doc = replica(fol, "df")
            monkeypatch.setattr(doc.device_doc, "_dedup_into_pending", boom)
            c.call("put", doc=d, obj="_root", prop="b", value=2)
            c.call("commit", doc=d)  # the client's ack: the host copy is durable
            assert o.legacy_counters.get("cluster.repl_device_feed_error") == 1
            assert doc.device_doc is None
            assert doc.get("_root", "b") is not None
            wait_until(lambda: cursor_lsn(fol, "df") == led.rpc.hub.lsn("df"),
                       msg="the follower level with the leader")
            if pkg == "ref":
                # the reference acked: its link never saw an error
                assert o.legacy_counters.get("cluster.link_error", 0) == 0
                continue
            errors = o.counter_values("rpc.errors", "type")
            assert errors.get("RuntimeError") == 1, errors
            assert o.legacy_counters.get("cluster.link_error") == 1
            assert fol.rpc.store.tier("df") == "warm"
            c.call("put", doc=d, obj="_root", prop="c", value=3)
            c.call("commit", doc=d)
            wait_until(lambda: cursor_lsn(fol, "df") == led.rpc.hub.lsn("df"),
                       msg="the next batch applied")
            assert fol.rpc.store.tier("df") == "hot"
            with doc.lock:
                assert doc.device_doc.hydrate() == {"a": 1, "b": 2, "c": 3}
                assert_same_mirror(doc.device_doc, fresh_resolve(doc), "rebuilt")
            assert o.legacy_counters.get("cluster.repl_device_feed_error") == 1
            assert o.legacy_counters.get("cluster.link_error") == 1
            assert o.legacy_counters.get("cluster.catchup_snapshots", 0) == 0
            assert o.counter_values("rpc.errors", "type").get("RuntimeError") == 1
        finally:
            c.close()
            led.stop()
            fol.stop()


def test_a_snapshot_resync_rebuilds_the_mirror(tmp_path, seq):
    """A mirrored replica caught up by a snapshot that holds changes: the
    port rebuilds the mirror from the grown history (it then equals a
    fresh resolve); the JAX package's mirror keeps missing them."""
    for pkg in ("ref", "port"):
        root = tmp_path / pkg
        fol = start_node(pkg, root, "f", role="follower")
        led = start_node(pkg, root, "l", role="leader", ack_replicas=0)
        try:
            fc = Client(fol.address)
            fc.call("openDurable", name="dr", device=True)
            c = Client(led.address)
            d = c.call("openDurable", name="dr")["doc"]
            for i in range(3):
                c.call("put", doc=d, obj="_root", prop=f"k{i}", value=i)
                c.call("commit", doc=d)
            c.call("clusterReplicateTo", addr=addr_of(fol))
            wait_until(lambda: cursor_lsn(fol, "dr") == 3, msg="the snapshot")
            doc = replica(fol, "dr")
            with doc.lock:
                assert doc.get("_root", "k2") is not None
                if pkg == "ref":
                    assert doc.device_doc.hydrate() == {}
                else:
                    assert doc.device_doc.hydrate() == {"k0": 0, "k1": 1, "k2": 2}
                    assert_same_mirror(doc.device_doc, fresh_resolve(doc), "resync")
            assert OBS[pkg].legacy_counters.get("cluster.snapshots_applied") == 1
            if pkg == "port":
                assert pobs.legacy_counters.get("cluster.mirror_resyncs") == 1
                c.call("put", doc=d, obj="_root", prop="k3", value=3)
                c.call("commit", doc=d)
                wait_until(lambda: cursor_lsn(fol, "dr") == 4, msg="the tail")
                wait_until(lambda: doc.device_doc.hydrate().get("k3") == 3,
                           msg="the tail fed to the rebuilt mirror")
                with doc.lock:
                    assert_same_mirror(doc.device_doc, fresh_resolve(doc), "fed")
            c.close()
            fc.close()
        finally:
            led.stop()
            fol.stop()


def test_node_device_and_warm_open_rules(tmp_path, monkeypatch):
    """The node's documents live on its device; a refused directory is
    counted and skipped at warm open; another failure propagates."""
    import torch

    fol = start_node("port", tmp_path, "f", role="follower")
    try:
        assert fol.rpc.device == torch.device("cpu")
        assert fol.batcher.device == torch.device("cpu")
        h = Client(fol.address).call("openDurable", name="dv", device=True)["doc"]
        assert fol.rpc._docs[h].device_doc.device.type == "cpu"
    finally:
        fol.stop()
    # a journal path that is a directory: the durable layer's OSError
    os.makedirs(tmp_path / "g" / "broken" / PD.JOURNAL_NAME)
    os.makedirs(tmp_path / "g" / "fine")
    node = start_node("port", tmp_path, "g", role="leader")
    try:
        assert set(node.rpc._durable_names) == {"fine"}
        assert pobs.legacy_counters.get("cluster.warm_open_error") == 1
    finally:
        node.stop()

    def lost(self, p):
        raise RuntimeError("the card went away")

    monkeypatch.setattr(pnode.ClusterRpcServer, "openDurable", lost)
    with pytest.raises(RuntimeError, match="the card went away"):
        start_node("port", tmp_path, "g", role="leader")
