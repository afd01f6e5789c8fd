"""automerge_tpu_torch stands alone: it imports neither JAX nor anything
of automerge_tpu (its sharded merge, ``parallel/``, its cross-document
batching, ``ops/batched.py`` and ``ops/host_batch.py``, its compressed
residency and run image, ``ops/compressed.py`` and
``storage/runsnap.py``, its document layer, ``api.py``, ``core/``,
``storage/document.py`` and ``patches/``, its observability layer,
``obs/`` and ``trace.py``, and its durable storage, ``storage/journal.py``,
``storage/durable.py``, ``storage/crashsim.py``, ``integrity.py``,
``degrade.py``, ``store/`` and ``testing.py``, its serving layer,
``rpc.py`` and ``serve/``, its cluster tier, ``cluster/``, its command
line, ``cli.py`` and ``__main__.py``, its native edit sessions and
fastcall extension, and ``visualisation.py`` included), and its entry
points refuse to fall back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import automerge_tpu_torch
from automerge_tpu_torch.convert import columns_from_numpy
from automerge_tpu_torch.device import resolve_device
from automerge_tpu_torch.ops.batched import CrossDocBatcher, apply_cross_doc
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.merge import merge_columns
from automerge_tpu_torch.ops.oplog import OpLog
from automerge_tpu_torch import workload as W

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "automerge_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "scripts").glob("profile_*_torch.py")))

_NO_JAX_RUN = r"""
import importlib, pkgutil, sys
import automerge_tpu_torch
for m in pkgutil.walk_packages(automerge_tpu_torch.__path__, "automerge_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from automerge_tpu_torch import api, errors, types
from automerge_tpu_torch.core import (
    bulk_load, change_graph, clock, document, marks, op_store, transaction)
from automerge_tpu_torch.patches import diff, patch_log
from automerge_tpu_torch.storage import document as storage_document
from automerge_tpu_torch.utils import indexed_cache
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.ops.device_doc import DeviceDoc
trace = W.load_trace(300)
base = W.build_base(trace, 200)
changes = base.changes + W.synth_fanin(base, trace, 3, 20, 200)
doc = DeviceDoc.merge([c.raw_bytes for c in changes], device="cpu")
assert len(doc.text(base.text_exid)) == W.expected_text_length(changes)
packed = DeviceDoc.merge([c.raw_bytes for c in changes], device="cpu",
                         transport="packed")
assert packed.text(base.text_exid) == doc.text(base.text_exid)
expand = DeviceDoc.merge([c.raw_bytes for c in changes], device="cpu",
                         staging="expand")
assert expand.text(base.text_exid) == doc.text(base.text_exid)
from automerge_tpu_torch.patches import apply_patches
deps = {d for c in base.changes for d in c.dependencies}
bheads = [c.hash for c in base.changes if c.hash not in deps]
view = doc.at(bheads)
assert view.device.type == "cpu" and view._base is doc
bdoc = DeviceDoc.merge([c.raw_bytes for c in base.changes], device="cpu")
assert view.text(base.text_exid) == bdoc.text(base.text_exid)
assert doc.hydrate(heads=bheads) == bdoc.hydrate()
assert apply_patches(doc.hydrate(heads=bheads), doc.diff(bheads)) == doc.hydrate()
assert apply_patches({}, doc.make_patches()) == doc.hydrate()
rbase, reps, expect = W.record_store(64, 8, 20)
served = DeviceDoc.merge([rbase.raw_bytes], device="cpu")
served.apply_changes([r.raw_bytes for r in reps[:4]])
served.apply_batches(W.record_batches([r.raw_bytes for r in reps[4:]], 2))
assert W.record_counts(served) == expect
from automerge_tpu_torch.convert import columns_from_numpy
from automerge_tpu_torch.kernels import linearize_condensed
from automerge_tpu_torch.ops.merge import condensed_caps, merge_kernel_condensed
from automerge_tpu_torch.ops.oplog import OpLog
tbase = W.build_base(W.typing_trace(300, 1), 200)
tlog = OpLog.from_changes(tbase.changes)
cond = merge_kernel_condensed(condensed_caps(tlog))(
    columns_from_numpy(tlog.padded_columns(include_aorder=True), "cpu"))
assert int((cond["elem_index"] >= 0).sum()) == int(tlog.insert.sum())
assert linearize_condensed.linearize_condensed.launches == 0
from automerge_tpu_torch.ops.merge import merge_columns
from automerge_tpu_torch.parallel import default_mesh, sharded_merge_columns
log = OpLog.from_changes(changes)
kw = dict(n_objs=log.n_objs, n_props=len(log.props))
single = merge_columns(log.padded_columns(), device="cpu", **kw)
for arm in ("condensed", "rows"):
    out = sharded_merge_columns(log.padded_columns(),
                                default_mesh(devices=["cpu"] * 2),
                                linearize=arm, **kw)
    assert all((out[k][:len(v)] == v).all() for k, v in single.items())
    # distinct devices: the doubling loops' per-round exchange
    from automerge_tpu_torch.parallel import Mesh
    out = sharded_merge_columns(log.padded_columns(), Mesh(["cpu:0", "cpu:1"]),
                                linearize=arm, **kw)
    assert all((out[k][:len(v)] == v).all() for k, v in single.items())
import torch
from automerge_tpu_torch.kernels import linearize as L
links = torch.tensor([1, 2, 9, -1], dtype=torch.int32)
ans, done, jump = L.linearize_thread_rounds(
    links, torch.tensor([False, False, True, True]), links, 3)
assert ans.tolist() == [9, 9, 9, -1] and done.all()
dist, nxt = L.linearize_rank_rounds(torch.ones(4, dtype=torch.int32), links, 3)
assert dist.tolist() == [8, 8, 8, 8]
assert L.linearize_thread_rounds.launches == L.linearize_rank_rounds.launches == 0
fc_e = torch.tensor([-1, -1, 3, -1], dtype=torch.int32)
dist, nxt = L.linearize_rank_from_thread(fc_e, links, 3, 3)
assert (dist.tolist(), nxt.tolist()) == ([3, 2, 1, 0], [3, 3, 3, 3])
assert L.linearize_rank_first(fc_e, links, 3, 0, 4)[0].tolist() == [2, 2, 1, 0]
assert L.linearize_rank_from_thread.launches == L.linearize_rank_first.launches == 0
from automerge_tpu_torch.kernels import emit_packed as EP
flat = EP.emit_packed({"visible": torch.tensor([True, False, True])}, ("visible",), 0)
assert flat.tolist() == [5] and EP.emit_packed.launches == 0
mesh_runs = []
inner = DeviceDoc._mesh_resolve_inner
DeviceDoc._mesh_resolve_inner = lambda self: mesh_runs.append(1) or inner(self)
mdoc = DeviceDoc.merge([c.raw_bytes for c in changes[:-1]], device="cpu")
mdoc.enable_mesh(devices=["cpu"] * 2, min_rows=0)
mdoc.apply_changes([changes[-1].raw_bytes])
assert mesh_runs == [1] and mdoc.text(base.text_exid) == doc.text(base.text_exid)
from automerge_tpu_torch.ops import batched
sbase, sdeltas, stexts = W.serve_workload(3, 2, 5, 40)
sdocs = [DeviceDoc.merge([sbase], device="cpu") for _ in range(3)]
batched.reset_stats()
for c in range(2):
    out = batched.apply_cross_doc([(d, [[sdeltas[i][c]]]) for i, d in enumerate(sdocs)],
                                  device="cpu")
    assert out == {"applied": 3, "batched": 3, "fallback": 0}, out
assert [d.text(W.SERVE_LIVE) for d in sdocs] == stexts
s = batched.stats()
assert s["launches"] == 2 and s["vectorized_docs"] == 6 and s["scalar_docs"] == 0, s
from automerge_tpu_torch import native
from automerge_tpu_torch.ops import assemble, extract
from automerge_tpu_torch.storage.change import LazyOps, parse_change
ch = parse_change(changes[1].raw_bytes)[0]
assert isinstance(ch.ops, LazyOps) and len(ch.ops) == len(changes[1].ops)
assert assemble.route(log.changes) == assemble.ROUTE_ASSEMBLE
assert isinstance(log.values, extract.LazyValues)
from automerge_tpu_torch.ops import compressed
from automerge_tpu_torch.storage import runsnap
data = runsnap.encode_snapshot(doc.log, doc.current_heads())
assert runsnap.verify_container(data)["ok"]
img = runsnap.parse(data)
hyd = DeviceDoc.resolve(img.to_oplog(), device="cpu")
assert hyd.text(base.text_exid) == doc.text(base.text_exid)
assert hyd.log._comp is not None and hyd.audit_columns() == []
assert hyd.compress_ratio() > 1.0 and hyd.resident_nbytes() < hyd.dense_nbytes()
compressed.reset_stats()
sdocs = [DeviceDoc.resolve(runsnap.parse(runsnap.encode_snapshot(
    DeviceDoc.merge([sbase], device="cpu").log, [])).to_oplog(), device="cpu")
    for _ in range(3)]
for c in range(2):
    batched.apply_cross_doc([(d, [[sdeltas[i][c]]]) for i, d in enumerate(sdocs)],
                            device="cpu")
assert [d.text(W.SERVE_LIVE) for d in sdocs] == stexts
assert compressed.stats()["ovc_join"] > 0
# the document layer: an edit, save and load, and a bulk catch-up
adoc = api.AutoDoc(types.ActorId(bytes([7]) * 16), device="cpu")
t = adoc.put_object("_root", "t", types.ObjType.TEXT)
adoc.splice_text(t, 0, 0, "hello")
adoc.mark(t, 0, 2, "bold", True)
adoc.commit()
saved = adoc.save()
back = api.AutoDoc.load(saved, device="cpu")
assert back.text(t) == "hello" and back.save() == saved and back.marks(t)
document.Document.BULK_MIN_OPS = 100
catch = api.AutoDoc(types.ActorId(bytes([8]) * 16), device="cpu")
catch.apply_changes(changes)
assert catch.doc._ops_stale
assert catch.text(base.text_exid) == doc.text(base.text_exid)
catch.splice_text(base.text_exid, 0, 0, "x")
assert catch.text(base.text_exid) == "x" + doc.text(base.text_exid)
assert DeviceDoc.merge([catch], device="cpu").text(base.text_exid) == \
    catch.text(base.text_exid)
# sync: two sessions over lossy channels, one feeding a resident document
from automerge_tpu_torch import expanded, functional as F, sync
sa = api.AutoDoc(types.ActorId(bytes([9]) * 16), device="cpu")
sb = api.AutoDoc(types.ActorId(bytes([10]) * 16), device="cpu")
st = sa.put_object("_root", "t", types.ObjType.TEXT)
sa.splice_text(st, 0, 0, "sync me")
sa.commit()
sdev = DeviceDoc.resolve(OpLog.from_changes([]), device="cpu")
drv = sync.SyncDriver(sa, sb, sync.FaultyChannel(seed=1, drop=0.3, dup=0.2),
                      sync.FaultyChannel(seed=2, drop=0.3, dup=0.2),
                      session_b=sync.SyncSession(sb, epoch=2, device_doc=sdev))
assert drv.run().converged and sb.text(st) == "sync me" == sdev.text(st)
assert drv.session_b.stats["device_feeds"]["apply_changes"] >= 1
ch = sa.get_changes([])[0]
assert expanded.collapse_change(expanded.expand_change(ch)).raw_bytes == ch.raw_bytes
fa = F.from_dict({"k": [1, 2], "t": F.Text("ab")}, actor=bytes([11]) * 16, device="cpu")
fb = F.init(actor=bytes([12]) * 16, device="cpu")
xa, xb = F.init_sync_state(), F.init_sync_state()
for _ in range(10):
    xa, m = F.generate_sync_message(fa, xa)
    if m is not None:
        fb, xb = F.receive_sync_message(fb, xb, m)
    xb, m2 = F.generate_sync_message(fb, xb)
    if m2 is not None:
        fa, xa = F.receive_sync_message(fa, xa, m2)
    if m is None and m2 is None:
        break
assert F.to_dict(fb) == {"k": [1, 2], "t": "ab"}
raw = F.get_all_changes(fa)[0]
assert F.encode_change(F.decode_change(raw)) == raw
# observability: the registry, the span ring, a profiled cycle and a
# torch.profiler capture with the named ranges, all without JAX
import json, tempfile
from automerge_tpu_torch import obs, trace as amtrace
from automerge_tpu_torch.obs import flight, heat, history, metrics, prof, spans, views
obs.reset_all()
tdir = tempfile.mkdtemp()
odocs = [DeviceDoc.merge([sbase], device="cpu") for _ in range(3)]
assert prof.torch_profile_start(tdir)["ok"]
with prof.cycle(kind="iso") as cyc:
    batched.apply_cross_doc([(d, [[sdeltas[i][0]]]) for i, d in enumerate(odocs)],
                            device="cpu")
stop = prof.torch_profile_stop()
assert stop["ok"] and cyc.report["launches"] == 1 and cyc.report["docs"] == 3
names = {e.get("name") for e in json.load(open(stop["trace"]))["traceEvents"]}
assert "amtpu.batched_launch" in names, names
assert "device_kernel_launches_total" in obs.render_prometheus()
assert obs.export_trace(tdir + "/spans.json") > 0
amtrace.count("iso.count")
assert amtrace.counters["iso.count"] == 1
# durable storage: a journaled document with a mirror, its store and
# scrubber, the crash harness and the test DSL
from automerge_tpu_torch import degrade, integrity, testing
from automerge_tpu_torch.storage import crashsim, durable, journal
from automerge_tpu_torch.store import DocStore, StoreBudgets, docstore, policy
ddir = tempfile.mkdtemp()
dd = api.AutoDoc.open(ddir + "/d", mirror=True, device="cpu", actor=types.ActorId(bytes([13]) * 16))
dt = dd.put_object("_root", "t", types.ObjType.TEXT)
dd.splice_text(dt, 0, 0, "durable")
dd.commit()
assert dd.compact() and not degrade.brownout_active()
dd.close()
dd = document.Document.open(ddir + "/d", mirror=True, device="cpu")
assert dd.device_doc.text(dt) == "durable" == dd.text(dt)
assert dd.device_doc.audit_columns() == [] and dd.device_doc.device.type == "cpu"
assert [r.ok for r in integrity.verify_doc_dir(ddir + "/d")] == [True, True]
class _Ops:
    def open_cold(self, name): raise AssertionError(name)
    def close_cold(self, name, compact): raise AssertionError(name)
    def drop_device(self, name): dd.drop_device_mirror()
    def build_device(self, name): return dd.build_device_mirror() is not None
st = DocStore(_Ops(), StoreBudgets(evict_interval_s=0.0))
st.admit("d", dd, mirror=True)
assert st.demote("d", "warm") == "warm" and dd.device_doc is None
st.touch("d")
assert st.tier("d") == "hot" and dd.device_doc.text(dt) == "durable"
dd.close()
sfs = crashsim.SimFS()
j, recs, tail = journal.Journal.open("/j", fs=sfs)
j.append_meta("k", b"v")
j.close()
assert journal.scan_records(sfs.read_bytes("/j"))[1].records == 1
assert testing.realize(api.AutoDoc.load(adoc.save(), device="cpu"))[0] == "map"
# the serving layer: the stdio frontend and the socket server over TCP,
# a mirrored durable document fed by a sync peer
from automerge_tpu_torch import rpc
from automerge_tpu_torch.serve import admission, server, shards
from automerge_tpu_torch.serve import QueueFull, ShardPool, SocketRpcServer
import io, socket as _socket
srv = rpc.RpcServer(device="cpu")
out = io.StringIO()
srv.serve(stdin=io.StringIO('{"id":1,"method":"create","params":{}}\n'), stdout=out)
assert json.loads(out.getvalue())["result"] == {"doc": 1}
assert admission.priority_class("put") == (1, "mutation")
sock_srv = SocketRpcServer(host="127.0.0.1", port=0, durable_dir=tempfile.mkdtemp(),
                           device="cpu", workers=2)
sock_srv.start()
try:
    conn = _socket.create_connection(sock_srv.address, timeout=60)
    rf = conn.makefile("r")
    def rcall(method, **params):
        conn.sendall((json.dumps({"id": 1, "method": method, "params": params})
                      + "\n").encode())
        resp = json.loads(rf.readline())
        assert "error" not in resp, resp
        return resp["result"]
    md = rcall("openDurable", name="iso", device=True)["doc"]
    peer = rcall("create", actor="0e" * 16)["doc"]
    rcall("put", doc=peer, obj="_root", prop="k", value=1)
    rcall("commit", doc=peer)
    sp, sd = rcall("syncStateNew")["sync"], rcall("syncStateNew")["sync"]
    for _ in range(6):
        m = rcall("generateSyncMessage", doc=peer, sync=sp)
        if m is not None:
            rcall("receiveSyncMessage", doc=md, sync=sd, data=m)
        b = rcall("generateSyncMessage", doc=md, sync=sd)
        if b is not None:
            rcall("receiveSyncMessage", doc=peer, sync=sp, data=b)
    assert sock_srv.rpc._docs[md].device_doc.hydrate() == {"k": 1}
    conn.close()
finally:
    sock_srv.stop()
# the cluster tier: a leader, a mirrored follower and a router on the CPU
from automerge_tpu_torch.cluster import (
    ClusterNode, ClusterRouter, advisor, chaos, hashring, node, replication, router)
croot = tempfile.mkdtemp()
fol = ClusterNode(node_id="f", host="127.0.0.1", port=0, durable_dir=croot + "/f",
                  role="follower", device="cpu")
fol.start()
led = ClusterNode(node_id="l", host="127.0.0.1", port=0, durable_dir=croot + "/l",
                  role="leader", replicate_to=["%s:%d" % fol.address], ack_replicas=1,
                  device="cpu")
led.start()
rtr = ClusterRouter([["%s:%d" % led.address, "%s:%d" % fol.address]], heartbeat=5.0)
rtr.start()
try:
    fh = fol.rpc.openDurable({"name": "cd", "device": True})["doc"]
    conn = _socket.create_connection(rtr.address, timeout=60)
    rf = conn.makefile("r")
    cd = rcall("openDurable", name="cd")["doc"]
    import time as _time
    deadline = _time.monotonic() + 60
    while fol.rpc._docs[fh].replication_cursor is None:
        assert _time.monotonic() < deadline, "no snapshot on the follower"
        _time.sleep(0.02)
    rcall("put", doc=cd, obj="_root", prop="k", value=1)
    rcall("commit", doc=cd)
    assert fol.rpc._docs[fh].device_doc.hydrate() == {"k": 1}
    assert rcall("clusterInfo")["groups"][0]["up"] is True
    conn.close()
finally:
    rtr.stop()
    led.stop()
    fol.stop()
# the native edit sessions and the command line
from automerge_tpu_torch import cli, visualisation
from automerge_tpu_torch.core.transaction import Transaction
tdoc = api.AutoDoc(types.ActorId(bytes([14]) * 16), device="cpu")
tt = tdoc.put_object("_root", "t", types.ObjType.TEXT)
tdoc.commit()
for i in range(Transaction.SMALL_TAIL_OPS + 44):
    tdoc.splice_text(tt, i, 0, "abc"[i % 3])
assert len(tdoc._tx._sessions) == 1
tdoc.commit()
assert tdoc.doc._ops_stale
for i in range(8):
    tdoc.put("_root", f"k{i}", i)
assert len(tdoc._tx._msessions) == 1
tdoc.commit()
assert tdoc.text(tt) == ("abc" * 100)[:300] and not tdoc.doc._ops_stale
assert "digraph" in visualisation.doc_to_dot(tdoc)
cdir = tempfile.mkdtemp()
fork = tdoc.fork(types.ActorId(bytes([15]) * 16))
fork.splice_text(tt, 0, 0, "fork ")
fork.commit()
open(cdir + "/a.am", "wb").write(tdoc.save())
open(cdir + "/b.am", "wb").write(fork.save())
assert cli.main(["--device", "cpu", "merge", cdir + "/a.am", cdir + "/b.am",
                 "-o", cdir + "/m.am"]) == 0
assert cli.main(["--device", "cpu", "export", cdir + "/m.am",
                 "-o", cdir + "/m.json"]) == 0
assert json.load(open(cdir + "/m.json"))["t"] == "fork " + ("abc" * 100)[:300]
maps = open("/proc/self/maps").read()
assert str(native.library_path()) in maps
assert str(native._fastcall_path()) in maps
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "automerge_tpu") or m.startswith(("jax.", "automerge_tpu."))
)
bad += sorted({line.split()[-1] for line in maps.splitlines()
               if "automerge_tpu/native/" in line or "_codecs-" in line
               or "_am_fastcall-" in line})
print("FORBIDDEN", bad)
sys.exit(1 if bad else 0)
"""

_NO_GXX_RUN = r"""
import sys, tempfile
from pathlib import Path
from automerge_tpu_torch import native
native.BUILD_DIR = Path(tempfile.mkdtemp())
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.ops.oplog import OpLog
from automerge_tpu_torch.storage.change import parse_change
from automerge_tpu_torch.ops.device_doc import DeviceDoc
base, reps, _ = W.record_store(16, 2, 20)
for name, call in (("from_changes", lambda: OpLog.from_changes([base] + reps)),
                   ("parse_change", lambda: parse_change(base.raw_bytes)),
                   ("merge", lambda: DeviceDoc.merge([base.raw_bytes], device="cpu"))):
    try:
        call()
    except native.NativeUnavailable as e:
        print(name, "raised", str(e).splitlines()[0])
    else:
        print(name, "returned")
        sys.exit(1)
assert not list(native.BUILD_DIR.iterdir())
"""


_NO_GXX_LOAD = r"""
import sys, tempfile
from pathlib import Path
from automerge_tpu_torch import native
native.BUILD_DIR = Path(tempfile.mkdtemp())
from automerge_tpu_torch.api import AutoDoc
data = Path(sys.argv[1]).read_bytes()
for name, call in (("load", lambda: AutoDoc.load(data, device="cpu")),
                   ("load_incremental", lambda: AutoDoc(device="cpu").load_incremental(data)),
                   ("salvage", lambda: AutoDoc.load(data, on_error="salvage", device="cpu"))):
    try:
        call()
    except native.NativeUnavailable as e:
        print(name, "raised", str(e).splitlines()[0])
    else:
        print(name, "returned")
        sys.exit(1)
"""


def test_no_native_library_no_document_load(tmp_path):
    """Without g++, loading a saved document raises ``NativeUnavailable``
    from every load route, the tolerant ones (``on_partial="ignore"``,
    salvage) too: they skip malformed chunks, never a missing library."""
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.types import ActorId, ObjType

    doc = AutoDoc(ActorId(bytes([1]) * 16), device="cpu")
    doc.splice_text(doc.put_object("_root", "t", ObjType.TEXT), 0, 0, "saved")
    saved = tmp_path / "doc.automerge"
    saved.write_bytes(doc.save())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PATH"] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", _NO_GXX_LOAD, str(saved)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("raised g++ not found") == 3, r.stdout


def test_no_native_library_no_log(tmp_path):
    """Without g++ (PATH holds none) and with an empty build directory,
    ``OpLog.from_changes``, ``parse_change`` and ``DeviceDoc.merge`` raise
    ``NativeUnavailable``: there is no pure-Python fallback."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PATH"] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", _NO_GXX_RUN], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("raised g++ not found") == 3, r.stdout


def _forbidden(name: str) -> bool:
    return name in ("jax", "automerge_tpu") or name.startswith(("jax.", "automerge_tpu."))


def test_port_imports_and_merges_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _NO_JAX_RUN], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FORBIDDEN []" in r.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)]


def _cols():
    trace = W.load_trace(100)
    base = W.build_base(trace, 80)
    return base, OpLog.from_changes(base.changes).columns()


def test_entry_points_without_device_raise_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base, cols = _cols()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        merge_columns(cols)
    with pytest.raises(RuntimeError):
        columns_from_numpy(cols)
    with pytest.raises(RuntimeError):
        DeviceDoc.merge([c.raw_bytes for c in base.changes])
    with pytest.raises(RuntimeError):
        merge_columns(cols, device="cuda")
    with pytest.raises(RuntimeError):
        merge_columns(cols, transport="packed", staging="expand")
    rbase, reps, _ = W.record_store(16, 2, 20)
    with pytest.raises(RuntimeError):
        DeviceDoc.merge([rbase.raw_bytes])
    with pytest.raises(RuntimeError):
        DeviceDoc(OpLog.from_changes([rbase]), {})
    sbase, sdeltas, _ = W.serve_workload(1, 1, 3, 10)
    doc = DeviceDoc.merge([sbase], device="cpu")
    with pytest.raises(RuntimeError):
        apply_cross_doc([(doc, [sdeltas[0]])])
    with pytest.raises(RuntimeError):
        CrossDocBatcher(mode="1").apply(doc, [sdeltas[0]])
    assert doc.log.n == len(W.serve_base_change(10).ops)  # nothing applied
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.core.document import Document

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Document()
    with pytest.raises(RuntimeError):
        AutoDoc()
    saved = AutoDoc(device="cpu").save()
    with pytest.raises(RuntimeError):
        AutoDoc.load(saved)


def test_durable_open_without_device_raises_when_no_gpu(monkeypatch, tmp_path):
    """A durable document, with or without its mirror, lives on the card
    by default: without a GPU its open raises and leaves no journal lock
    behind; ``device="cpu"`` opens it."""
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.core.document import Document

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path / "d")
    for call in (lambda: AutoDoc.open(d, mirror=True), lambda: AutoDoc.open(d),
                 lambda: Document.open(d, mirror=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    dd = AutoDoc.open(d, mirror=True, device="cpu")
    assert dd.device_doc.device == torch.device("cpu")
    dd.close()


def test_sync_and_functional_without_device_raise_when_no_gpu(monkeypatch):
    """Functional documents and synced ``AutoDoc``s live on the card by
    default: without a GPU they raise, and nothing falls back to the CPU."""
    from automerge_tpu_torch import functional as F
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.sync import SyncSession

    saved = F.save(F.from_dict({"k": 1}, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (F.init, lambda: F.from_dict({"k": 1}), lambda: F.load(saved),
                 lambda: SyncSession(AutoDoc())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    doc = F.load(saved, device="cpu")
    assert F.clone(doc)._auto.doc.device == torch.device("cpu")


def test_servers_without_device_raise_when_no_gpu(monkeypatch, tmp_path):
    """The JSON-RPC frontend, the socket server and a cluster node serve
    the card by default: without a GPU they raise before any thread,
    socket or store exists, and ``python -m automerge_tpu_torch.rpc``
    exits 1, in cluster mode too."""
    from automerge_tpu_torch import rpc
    from automerge_tpu_torch.cluster import ClusterNode, ClusterRpcServer
    from automerge_tpu_torch.serve import SocketRpcServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (rpc.RpcServer, SocketRpcServer,
                 lambda: rpc.RpcServer(durable_dir=str(tmp_path)),
                 lambda: SocketRpcServer(host="127.0.0.1", port=0,
                                         durable_dir=str(tmp_path)),
                 lambda: ClusterRpcServer(durable_dir=str(tmp_path), node_id="n"),
                 lambda: ClusterNode(node_id="n", host="127.0.0.1", port=0,
                                     durable_dir=str(tmp_path)),
                 lambda: ClusterNode(node_id="f", host="127.0.0.1", port=0,
                                     durable_dir=str(tmp_path), role="follower")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert rpc.main(["--socket", "127.0.0.1:0"]) == 1
    assert rpc.main(["--socket", "127.0.0.1:0", "--durable", str(tmp_path / "n"),
                     "--node-id", "n"]) == 1
    assert rpc.RpcServer(device="cpu").device == torch.device("cpu")


def test_served_document_stays_on_its_device(monkeypatch):
    """A document resolved on the CPU applies and re-resolves there; it
    never reaches for the card."""
    rbase, reps, expect = W.record_store(64, 8, 20)
    doc = DeviceDoc.merge([rbase.raw_bytes], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert doc.apply_changes([r.raw_bytes for r in reps[:4]]) == 4
    assert doc.apply_batches(
        W.record_batches([r.raw_bytes for r in reps[4:]], 2)) == 4
    assert W.record_counts(doc) == expect
    # a view resolves where its base does
    view = doc.at([rbase.hash])
    assert view.device == doc.device
    fresh = DeviceDoc.merge([rbase.raw_bytes], device="cpu")
    assert view.map_entries(W.RECORDS_OBJ) == fresh.map_entries(W.RECORDS_OBJ)


def test_cpu_is_taken_only_when_asked():
    _, cols = _cols()
    assert resolve_device("cpu") == torch.device("cpu")
    out = merge_columns(cols, device="cpu")
    assert isinstance(out["winner"], np.ndarray)
    assert set(automerge_tpu_torch.__all__) == {"DeviceDoc", "OpLog", "merge_columns"}
    assert automerge_tpu_torch.DeviceDoc is DeviceDoc
