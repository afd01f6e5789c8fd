"""The port's JSON-RPC frontend (``automerge_tpu_torch/rpc.py``) against
the JAX package's, on the CPU.

Differential cases first: the JAX package's ``RpcServer`` and the port's
``RpcServer(device="cpu")`` get the same seeded request sequences, and
their wire answers (the JSON each writes) must be equal once handle
numbers are mapped: every document method, sync states and sessions,
``popPatches``, the error shapes, the durable methods through the tiered
store, with the two ``durable_dir``s holding identical ``snapshot.am`` and
``journal.waj`` bytes, and the resident mirror (``openDurable {"device":
true}``) equal to the JAX package's array for array after sync feeds and
after a promotion. Answers that are timing or process state (``metrics``,
``perfStatus``, ``heatStatus``, ``historyStatus``, ``storeStatus``'s RSS)
are compared by their keys.

Then the port alone: the reference's subprocess and C-client cases on
``python -m automerge_tpu_torch.rpc --device cpu``, the no-GPU refusal,
the ``torch.profiler`` capture, and the two narrowed ``except``s of
``rpc.py`` (a failed mirror feed, a failed promotion): each is counted
and answers the request with its error. Cluster mode is tested in
``tests/test_torch_cluster_router.py``.
"""

import base64
import copy
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import automerge_tpu.rpc as RR
from automerge_tpu import obs as robs
import automerge_tpu_torch.rpc as PR
from automerge_tpu_torch import obs as pobs
from automerge_tpu_torch.ops.device_doc import DeviceDoc as PDeviceDoc
from automerge_tpu_torch.storage import durable as PD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CMD = [sys.executable, "-m", "automerge_tpu_torch.rpc", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _fresh_obs():
    robs.reset_all()
    pobs.reset_all()
    yield


@pytest.fixture(autouse=True)
def _reference_decodes_fresh(monkeypatch):
    """The JAX package's logs number props in the order of its per-change
    key tables, which keep the key table of whatever batch first decoded
    the change (ROADMAP §3). Its column builds here start from changes
    with no such residue, as the port's always do, so both servers write
    the same snapshot bytes."""
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


@pytest.fixture(autouse=True)
def _seeded_actors(monkeypatch):
    """Documents opened without an actor (``openDurable``, ``load``) get
    a random one in both packages; here each package draws the same
    sequence, so both servers write the same change bytes."""
    import types as pytypes
    import uuid

    import automerge_tpu.types as RT
    import automerge_tpu_torch.types as PT

    for mod in (RT, PT):
        counter = iter(range(1, 1 << 30))
        fake = pytypes.SimpleNamespace(uuid4=lambda c=counter: uuid.UUID(
            int=(0xA5 << 120) | next(c)))
        monkeypatch.setattr(mod, "uuid", fake)


RESULT_HANDLES = ("doc", "sync", "session")
PARAM_HANDLES = ("doc", "other", "sync", "session")


class Pair:
    """The JAX package's server (``ref``) and the port's (``port``), each
    over its own durable directory, driven request by request. ``hmap``
    maps the reference's handles to the port's."""

    def __init__(self, root=None, *, dirs=None, **kw):
        self.rdir, self.pdir = dirs or (None, None)
        if root is not None:
            self.rdir, self.pdir = str(root / "ref"), str(root / "port")
            os.makedirs(self.rdir)
            os.makedirs(self.pdir)
        self.ref = RR.RpcServer(durable_dir=self.rdir, **kw)
        self.port = PR.RpcServer(durable_dir=self.pdir, device="cpu", **kw)
        self.hmap = {}
        self.rid = 0

    def _to_port(self, params):
        out = dict(params)
        for k in PARAM_HANDLES:
            if isinstance(out.get(k), int):
                out[k] = self.hmap.get(out[k], out[k])
        return out

    def _from_port(self, rresp, presp):
        """The port's answer with its handles replaced by the
        reference's (recording new pairs)."""
        res, pres = rresp.get("result"), presp.get("result")
        if isinstance(res, dict) and isinstance(pres, dict):
            pres = dict(pres)
            for k in RESULT_HANDLES:
                if isinstance(res.get(k), int) and isinstance(pres.get(k), int):
                    self.hmap[res[k]] = pres[k]
                    pres[k] = res[k]
            presp = dict(presp, result=pres)
        return presp

    @staticmethod
    def wire(srv, req):
        return json.loads(srv._encode_response(srv.handle(req)))

    def request(self, method, params=None, *, expired=False, compare=True):
        """One request to both; returns both wire answers (the port's
        with mapped handles). ``expired`` stamps a deadline already past
        on each server's own clock."""
        self.rid += 1
        params = params or {}
        rreq = {"id": self.rid, "method": method, "params": copy.deepcopy(params)}
        preq = {"id": self.rid, "method": method, "params": self._to_port(params)}
        if expired:
            rreq["_deadline_ts"] = robs.now() - 1.0
            preq["_deadline_ts"] = pobs.now() - 1.0
        rr = self.wire(self.ref, rreq)
        pr = self._from_port(rr, self.wire(self.port, preq))
        if compare:
            assert pr == rr, (method, params)
        return rr, pr

    def call(self, method, **params):
        rr, _ = self.request(method, params)
        assert "error" not in rr, (method, rr)
        return rr.get("result")

    def error(self, method, **params):
        rr, _ = self.request(method, params)
        assert "error" in rr, (method, rr)
        return rr["error"]

    def keys_only(self, method, **params):
        rr, pr = self.request(method, params, compare=False)
        assert "error" not in rr and "error" not in pr, (rr, pr)
        got = dict(pr["result"])
        if "torch_profiler" in got:
            # the capture's summary names its profiler (the JAX
            # package's key is "jax_profiler")
            got["jax_profiler"] = got.pop("torch_profiler")
        assert key_tree(got) == key_tree(rr["result"]), method
        return rr["result"], pr["result"]

    def docs(self, h):
        return self.ref._docs[h], self.port._docs[self.hmap.get(h, h)]

    def check_files(self):
        """Both directories hold the same documents, byte for byte."""
        names = sorted(os.listdir(self.rdir))
        assert sorted(os.listdir(self.pdir)) == names
        for name in names:
            for f in (PD.SNAPSHOT_NAME, PD.JOURNAL_NAME):
                rp = os.path.join(self.rdir, name, f)
                pp = os.path.join(self.pdir, name, f)
                assert os.path.exists(rp) == os.path.exists(pp), (name, f)
                if os.path.exists(rp):
                    with open(rp, "rb") as a, open(pp, "rb") as b:
                        assert a.read() == b.read(), (name, f)

    def close(self):
        self.ref.close_durables()
        self.port.close_durables()


def key_tree(x):
    """The shape of a JSON answer: dict keys all the way down, list
    lengths, no values."""
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return ["list"]
    return type(x).__name__


def assert_same_mirror(dev, other, where=""):
    """The port's mirror equals the reference's on every READ_FETCH array
    and its hydrate."""
    n = dev.log.n
    assert (n, dev.log.n_objs) == (other.log.n, other.log.n_objs), where
    for k in PDeviceDoc.READ_FETCH:
        cut = dev.log.n_objs + 2 if k.startswith("obj_") else n
        np.testing.assert_array_equal(np.asarray(dev.res[k])[:cut],
                                      np.asarray(other.res[k])[:cut],
                                      err_msg=f"{where} {k}")
    assert json.dumps(dev.hydrate(), default=repr, sort_keys=True) == json.dumps(
        other.hydrate(), default=repr, sort_keys=True), where


VALUES = [
    1, -7, 2.5, "str", True, None, {"$counter": 3}, {"$timestamp": 1700000000000},
    {"$bytes": base64.b64encode(b"\x00\x01\x02").decode()},
]


def seeded_edits(p, d, objs, rng, n):
    """``n`` seeded edits of document ``d`` through both servers."""
    text, lst, mp = objs
    for i in range(n):
        kind = int(rng.integers(0, 10))
        if kind == 0:
            p.call("put", doc=d, obj="_root", prop=f"k{int(rng.integers(0, 6))}",
                   value=VALUES[int(rng.integers(0, len(VALUES)))])
        elif kind == 1:
            ln = p.call("length", doc=d, obj=text)
            pos = int(rng.integers(0, ln + 1))
            p.call("spliceText", doc=d, obj=text, pos=pos,
                   **{"del": int(rng.integers(0, 2)) if pos < ln else 0}, text=f"w{i}")
        elif kind == 2:
            ln = p.call("length", doc=d, obj=lst)
            p.call("insert", doc=d, obj=lst, index=int(rng.integers(0, ln + 1)),
                   value=VALUES[int(rng.integers(0, len(VALUES)))])
        elif kind == 3:
            p.call("increment", doc=d, obj="_root", prop="count",
                   by=int(rng.integers(1, 5)))
        elif kind == 4:
            ln = p.call("length", doc=d, obj=text)
            if ln >= 2:
                p.call("mark", doc=d, obj=text, start=0, end=int(rng.integers(1, ln)),
                       name="bold", value=True)
        elif kind == 5:
            ln = p.call("length", doc=d, obj=lst)
            if ln:
                p.call("delete", doc=d, obj=lst, index=int(rng.integers(0, ln)))
        elif kind == 6:
            p.call("put", doc=d, obj=mp, prop=f"m{int(rng.integers(0, 4))}",
                   value=int(rng.integers(0, 100)))
        elif kind == 7:
            ln = p.call("length", doc=d, obj=lst)
            p.call("insertObject", doc=d, obj=lst, index=int(rng.integers(0, ln + 1)),
                   type="map")
        elif kind == 8:
            ln = p.call("length", doc=d, obj=text)
            if ln >= 2:
                p.call("unmark", doc=d, obj=text, start=0, end=1, name="bold")
        else:
            p.call("commit", doc=d, message=f"step {i}")


def new_doc(p, actor):
    d = p.call("create", actor=actor)["doc"]
    text = p.call("putObject", doc=d, obj="_root", prop="t", type="text")["$obj"]
    lst = p.call("putObject", doc=d, obj="_root", prop="l", type="list")["$obj"]
    mp = p.call("putObject", doc=d, obj="_root", prop="m", type="map")["$obj"]
    p.call("put", doc=d, obj="_root", prop="count", value={"$counter": 0})
    p.call("commit", doc=d)
    return d, (text, lst, mp)


def reads(p, d, objs, heads=None):
    """Every read method of ``d`` through both servers."""
    text, lst, mp = objs
    h = {} if heads is None else {"heads": heads}
    p.call("get", doc=d, obj="_root", prop="count", **h)
    p.call("getAll", doc=d, obj="_root", prop="k1", **h)
    p.call("keys", doc=d, obj="_root", **h)
    p.call("keys", doc=d, obj=mp, **h)
    p.call("length", doc=d, obj=lst, **h)
    for i in range(p.call("length", doc=d, obj=lst, **h)):
        p.call("get", doc=d, obj=lst, index=i, **h)
    p.call("text", doc=d, obj=text, **h)
    p.call("marks", doc=d, obj=text, **h)
    if p.call("length", doc=d, obj=text, **h):
        cur = p.call("getCursor", doc=d, obj=text, pos=0, **h)
        p.call("getCursorPosition", doc=d, obj=text, cursor=cur, **h)
    p.call("materialize", doc=d, **h)
    p.call("materialize", doc=d, obj=lst, **h)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_document_methods_answer_as_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    p = Pair()
    a, objs = new_doc(p, "01" * 16)
    assert p.call("actor", doc=a) == "01" * 16
    seeded_edits(p, a, objs, rng, 30)
    h1 = p.call("commit", doc=a, message="first")
    heads1 = p.call("heads", doc=a)
    assert h1 is None or heads1 == [h1]
    seeded_edits(p, a, objs, rng, 30)
    p.call("commit", doc=a)
    reads(p, a, objs)
    reads(p, a, objs, heads=heads1)
    # forks, at the tip and at heads, keep their document's answers
    f1 = p.call("fork", doc=a, actor="03" * 16)["doc"]
    f0 = p.call("fork", doc=a, heads=heads1)["doc"]
    reads(p, f0, objs)
    seeded_edits(p, f1, objs, rng, 10)
    p.call("commit", doc=f1)
    # save / load / saveIncremental / applyChanges / merge
    data = p.call("save", doc=a)
    b = p.call("load", data=data)["doc"]
    inc = p.call("saveIncremental", doc=f1, heads=p.call("heads", doc=a))
    p.call("applyChanges", doc=b, data=inc)
    p.call("merge", doc=a, other=f1)
    assert p.call("heads", doc=a) == p.call("heads", doc=b)
    reads(p, b, objs)
    p.call("docFence", doc=a)
    # a damaged save loads with onError "salvage": the same report
    raw = bytearray(base64.b64decode(data))
    raw[len(raw) // 2] ^= 0xFF
    bad = base64.b64encode(bytes(raw)).decode()
    p.error("load", data=bad)
    p.call("load", data=bad, onError="salvage")
    # a text encoding other than the default counts widths its own way
    u = p.call("create", actor="04" * 16, textEncoding="utf16")["doc"]
    ut = p.call("putObject", doc=u, obj="_root", prop="t", type="text")["$obj"]
    p.call("spliceText", doc=u, obj=ut, pos=0, text="a\U0001F600b")
    p.call("length", doc=u, obj=ut)
    p.call("getCursor", doc=u, obj=ut, pos=3)
    p.call("configure", syncTimeoutMs=250, maxRequestBytes=1 << 20)
    p.call("configure")
    for h in (a, b, f0, f1):
        p.call("free", doc=h)
    p.error("text", doc=a, obj=objs[0])


def test_pop_patches_and_sync_states_answer_as_the_jax_package():
    p = Pair()
    a, objs = new_doc(p, "0a" * 16)
    b = p.call("create", actor="0b" * 16)["doc"]
    assert p.call("popPatches", doc=b) == []  # pins the cursor
    assert p.call("popPatches", doc=a) == []
    seeded_edits(p, a, objs, np.random.default_rng(7), 25)
    p.call("popPatches", doc=a)  # the open transaction stays open
    p.call("commit", doc=a, message="kept")
    p.call("popPatches", doc=a)
    sa = p.call("syncStateNew")["sync"]
    sb = p.call("syncStateNew")["sync"]
    for _ in range(20):
        ma = p.call("generateSyncMessage", doc=a, sync=sa)
        mb = p.call("generateSyncMessage", doc=b, sync=sb)
        if ma is None and mb is None:
            break
        if ma is not None:
            p.call("receiveSyncMessage", doc=b, sync=sb, data=ma)
        if mb is not None:
            p.call("receiveSyncMessage", doc=a, sync=sa, data=mb)
    assert p.call("heads", doc=a) == p.call("heads", doc=b)
    assert p.call("popPatches", doc=b)  # the remote changes, as patches
    enc = p.call("syncStateEncode", sync=sa)
    sa2 = p.call("syncStateDecode", data=enc)["sync"]
    p.call("generateSyncMessage", doc=a, sync=sa2)
    p.call("syncStateFree", sync=sa)
    p.error("generateSyncMessage", doc=a, sync=sa)


def test_sync_sessions_answer_as_the_jax_package(tmp_path):
    p = Pair(tmp_path)
    # a retransmit timeout far past the test's length: every poll answers
    # by the protocol's state alone, never by the clock
    p.call("configure", syncTimeoutMs=600_000)
    a, objs = new_doc(p, "01" * 16)
    seeded_edits(p, a, objs, np.random.default_rng(3), 20)
    p.call("commit", doc=a)
    b = p.call("openDurable", name="sessions", device=True)["doc"]
    p.call("put", doc=b, obj="_root", prop="from_b", value=2)
    p.call("commit", doc=b)
    sa = p.call("syncSessionNew", doc=a, epoch=1, seed=4)["session"]
    sb = p.call("syncSessionAttach", doc=b, peer="client-a")["session"]
    assert p.call("syncSessionAttach", doc=b, peer="client-a")["session"] == sb
    for _ in range(30):
        fa = p.call("syncSessionPoll", session=sa)
        if fa is not None:
            bad = bytearray(base64.b64decode(fa))
            bad[len(bad) // 2] ^= 0xFF
            assert p.call("syncSessionReceive", session=sb,
                          data=base64.b64encode(bytes(bad)).decode()) == {
                              "accepted": False}
            p.call("syncSessionReceive", session=sb, data=fa)
            p.call("syncSessionReceive", session=sb, data=fa)  # duplicate
        fb = p.call("syncSessionPoll", session=sb)
        if fb is not None:
            p.call("syncSessionReceive", session=sa, data=fb)
        if (p.call("syncSessionStats", session=sa)["converged"]
                and p.call("syncSessionStats", session=sb)["converged"]):
            break
    assert p.call("heads", doc=a) == p.call("heads", doc=b)
    rdoc, pdoc = p.docs(b)
    assert_same_mirror(pdoc.device_doc, rdoc.device_doc, "session feeds")
    enc = p.call("syncSessionEncode", session=sa)
    sa2 = p.call("syncSessionRestore", doc=a, data=enc, epoch=9)["session"]
    assert p.call("syncSessionStats", session=sa2)["epoch"] == 9
    p.call("syncSessionFree", session=sa)
    p.error("syncSessionPoll", session=sa)
    p.error("syncSessionNew", doc=a, timeoutMs=0)
    p.error("syncSessionAttach", doc=a, peer="x")  # not durable
    p.close()
    p.check_files()


HOSTILE = [
    "123", "[1,2]", "not json at all", '{"not json',
    json.dumps({"id": 0, "method": [1, 2], "params": {}}),
    json.dumps({"id": 1, "method": "serve", "params": {"x": 1}}),
    json.dumps({"id": 2, "method": "_doc", "params": {}}),
    '{"id": 3, "method": "noSuchMethod"}',
    '{"method": "heads", "params": {"doc": 1}}',
    '{"id": 4, "method": "load", "params": {"data": "!!!not-base64!!"}}',
    '{"id": 5, "method": "create", "params": {"actor": "zz"}}',
    json.dumps({"id": 6, "method": "create",
                "params": {"actor": "世" * 600}}, ensure_ascii=False),
    '{"id": 7, "method": "configure", "params": {"maxRequestBytes": 1024}}',
    json.dumps({"id": 8, "method": "load", "params": {"data": "A" * 4096}}),
    "Z" * 100_000,
    '{"id": 9, "method": "create", "deadlineMs": 60000}',
    '{"id": 10, "method": "get", "params": {"doc": 999, "obj": "_root", "prop": "x"}}',
    '{"id": 11, "method": "put", "params": {"doc": 9}}',
    '{"id": 12, "method": "configure", "params": {"syncTimeoutMs": -5}}',
    '{"id": 13, "method": "configure", "params": {"maxRequestBytes": "many"}}',
    '{"id": 14, "method": "openDurable", "params": {"name": "x"}}',
    '{"id": 15, "method": "materialize", "params": {"doc": 9}}',
    '{"id": 16, "method": "shutdown"}',
    '{"id": 17, "method": "create"}',
]


def test_stdio_framing_and_error_shapes_equal_the_jax_package():
    """The same lines through both servers' stdio loops give the same
    bytes out: malformed JSON, non-object JSON, unknown and non-API
    methods, a missing id, bad base64 and hex, a request over the limit
    in bytes (not characters), a newline-free flood, bad handles and
    params, a non-durable ``openDurable``, and ``shutdown`` stopping the
    loop."""
    outs = []
    for srv in (RR.RpcServer(), PR.RpcServer(device="cpu")):
        out = io.StringIO()
        srv.serve(stdin=io.StringIO("".join(ln + "\n" for ln in HOSTILE)), stdout=out)
        outs.append(out.getvalue())
    assert outs[1] == outs[0]
    resps = [json.loads(x) for x in outs[1].splitlines()]
    assert len(resps) == HOSTILE.index('{"id": 16, "method": "shutdown"}') + 1
    assert all(isinstance(r["error"]["retriable"], bool) for r in resps if "error" in r)
    kinds = [r["error"]["type"] if "error" in r else "ok" for r in resps]
    for want in ("ParseError", "UnknownMethod", "RequestTooLarge", "ValueError"):
        assert want in kinds


def test_expired_deadline_and_bad_handles_answer_as_the_jax_package():
    p = Pair()
    a, objs = new_doc(p, "07" * 16)
    rr, _ = p.request("put", {"doc": a, "obj": "_root", "prop": "x", "value": 2},
                      expired=True)
    assert rr["error"] == {"type": "DeadlineExceeded", "retriable": True,
                           "message": "client deadline expired before pre_fsync"}
    assert p.call("keys", doc=a, obj="_root") == ["count", "l", "m", "t"]
    for name in ("robs", "pobs"):
        mod = robs if name == "robs" else pobs
        assert mod.counter_values("serve.deadline_expired", "stage") == {"pre_fsync": 1}
    p.error("get", doc=999, obj="_root", prop="x")
    p.error("merge", doc=a, other=999)
    p.error("put", doc=a)
    p.error("nope")
    # every frame-level error of the parser, through both
    for line in ("{definitely not json", "[1, 2, 3]",
                 json.dumps({"id": 1, "method": "put",
                             "params": {"pad": "x" * (32 << 20)}})):
        r, _ = p.ref._handle_line(line)
        q, _ = p.port._handle_line(line)
        assert q == r and r["error"]["retriable"] is False


def test_observability_answers_have_the_jax_package_keys():
    from automerge_tpu.obs import prof as rprof
    from automerge_tpu_torch.obs import prof as pprof

    # the drain-cycle observatory keeps what earlier drains in the
    # process attributed: both start empty here
    rprof.profiler.reset()
    pprof.profiler.reset()
    p = Pair()
    a, objs = new_doc(p, "05" * 16)
    seeded_edits(p, a, objs, np.random.default_rng(1), 10)
    rr, pr = p.request("metrics", {"format": "json"}, compare=False)
    assert set(pr["result"]) == set(rr["result"]) == {"format", "metrics",
                                                      "counters", "timings"}
    r, q = p.keys_only("metrics")
    assert q["format"] == "prometheus" and "rpc_request" in q["body"]
    p.error("metrics", format="xml")
    p.keys_only("perfStatus")
    p.keys_only("perfStatus", top=3)
    p.keys_only("heatStatus")
    p.keys_only("historyStatus")


def test_profile_capture_is_a_torch_profiler_trace(tmp_path):
    srv = PR.RpcServer(device="cpu")
    start = srv.handle({"id": 1, "method": "profileStart",
                        "params": {"dir": str(tmp_path / "cap")}})["result"]
    assert start == {"ok": True, "dir": str(tmp_path / "cap")}
    again = srv.handle({"id": 2, "method": "profileStart", "params": {}})["result"]
    assert again["ok"] is False and "already active" in again["reason"]
    srv.handle({"id": 3, "method": "create", "params": {}})
    stop = srv.handle({"id": 4, "method": "profileStop", "params": {}})["result"]
    assert stop["ok"] and os.path.exists(stop["trace"])
    none = srv.handle({"id": 5, "method": "profileStop", "params": {}})["result"]
    assert none == {"ok": False, "reason": "no active capture"}


def feed_from_peers(p, d, rng, n_peers=3, rounds=3):
    """Peers sync seeded edits into durable document ``d`` over sync
    states (``receiveSyncMessage``: the mirror's feed)."""
    peers = []
    for i in range(n_peers):
        q = p.call("create", actor=f"{0x40 + i:02x}" * 16)["doc"]
        peers.append((q, p.call("syncStateNew")["sync"], p.call("syncStateNew")["sync"]))
    for r in range(rounds):
        for i, (q, _, _) in enumerate(peers):
            for k in range(int(rng.integers(1, 4))):
                p.call("put", doc=q, obj="_root", prop=f"p{i}_{r}_{k}",
                       value=int(rng.integers(0, 1000)))
            p.call("commit", doc=q)
        for _ in range(10):
            moved = False
            for q, sq, sd in peers:
                m = p.call("generateSyncMessage", doc=q, sync=sq)
                if m is not None:
                    moved = True
                    p.call("receiveSyncMessage", doc=d, sync=sd, data=m)
                back = p.call("generateSyncMessage", doc=d, sync=sd)
                if back is not None:
                    moved = True
                    p.call("receiveSyncMessage", doc=q, sync=sq, data=back)
            if not moved:
                break
    return peers


def test_durable_methods_files_and_mirror_equal_the_jax_package(tmp_path):
    p = Pair(tmp_path)
    rng = np.random.default_rng(11)
    plain = p.call("openDurable", name="plain")["doc"]
    assert p.call("openDurable", name="plain")["doc"] == plain
    p.error("openDurable", name="plain", fsync="never")
    p.error("openDurable", name="plain", textEncoding="utf8")
    for bad in ("../evil", "a/b", "", ".hidden", None, 7, "x" * 100):
        p.error("openDurable", name=bad)
    objs = tuple(p.call("putObject", doc=plain, obj="_root", prop=k, type=t)["$obj"]
                 for k, t in (("t", "text"), ("l", "list"), ("m", "map")))
    p.call("put", doc=plain, obj="_root", prop="count", value={"$counter": 0})
    p.call("commit", doc=plain)
    for _ in range(3):
        seeded_edits(p, plain, objs, rng, 12)
        p.call("commit", doc=plain)
        p.check_files()
    r, q = p.request("durableInfo", {"doc": plain}, compare=False)
    assert dict(q["result"], path=None) == dict(r["result"], path=None)
    p.call("durableCompact", doc=plain)
    p.check_files()
    p.call("put", doc=plain, obj="_root", prop="post", value=1)
    p.call("commit", doc=plain)
    p.check_files()
    p.call("docDigest", doc=plain)
    p.call("docDigest", name="plain")
    p.error("docDigest", name="nowhere")

    # a mirrored document fed by sync peers
    dev = p.call("openDurable", name="mirrored", device=True)["doc"]
    feed_from_peers(p, dev, rng)
    rdoc, pdoc = p.docs(dev)
    assert pdoc.device_doc is not None and pdoc.device_doc.device.type == "cpu"
    assert_same_mirror(pdoc.device_doc, rdoc.device_doc, "after feeds")
    p.check_files()
    p.call("scrubNow")

    # the store: hot -> warm -> cold, then a request hydrates and promotes
    st_r, st_p = p.keys_only("storeStatus", docs=True)
    assert st_p["tiers"] == st_r["tiers"] == {"hot": 1, "warm": 1, "cold": 0}
    assert p.call("storeDemote", name="mirrored", to="warm") == {
        "name": "mirrored", "tier": "warm"}
    assert p.docs(dev)[1].device_doc is None
    assert p.call("storeDemote", name="mirrored", to="cold")["tier"] == "cold"
    p.check_files()
    p.call("docFence", doc=dev)  # fencing a cold document leaves it cold
    assert p.port.store.tier("mirrored") == p.ref.store.tier("mirrored") == "cold"
    p.call("materialize", doc=dev)  # hydrates, then promotes on touch
    assert p.port.store.tier("mirrored") == p.ref.store.tier("mirrored") == "hot"
    rdoc, pdoc = p.docs(dev)
    assert_same_mirror(pdoc.device_doc, rdoc.device_doc, "after the promotion")
    p.error("storeDemote", name="mirrored", to="hot")
    p.error("storeDemote", to="cold")

    # durableReopen keeps the handle; with wipe it starts from nothing
    assert p.call("durableReopen", name="plain") == {"doc": plain, "reopened": True}
    p.call("materialize", doc=plain)
    p.check_files()
    assert p.call("durableReopen", name="mirrored", device=True, wipe=True) == {
        "doc": dev, "reopened": True}
    assert p.call("materialize", doc=dev) == {}
    rdoc, pdoc = p.docs(dev)
    assert_same_mirror(pdoc.device_doc, rdoc.device_doc, "after the wipe")
    p.call("put", doc=dev, obj="_root", prop="fresh", value=1)
    p.call("commit", doc=dev)
    p.error("durableInfo", doc=p.call("create")["doc"])
    p.error("chaosDisk", name="plain", op="write")  # chaos mode is off
    p.call("free", doc=plain)
    p.close()
    p.check_files()
    # each server opens the other's directory to the same document
    q = Pair(dirs=(p.pdir, p.rdir))
    for name in ("plain", "mirrored"):
        h = q.call("openDurable", name=name, device=True)["doc"]
        q.call("materialize", doc=h)
        q.call("docDigest", doc=h)
        rdoc, pdoc = q.docs(h)
        assert_same_mirror(pdoc.device_doc, rdoc.device_doc, "cross open")
    q.close()


def test_chaos_disk_faults_answer_as_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOMERGE_TPU_CHAOS", "1")
    p = Pair(tmp_path)
    d = p.call("openDurable", name="chaos")["doc"]
    p.call("put", doc=d, obj="_root", prop="a", value=1)
    p.call("commit", doc=d)
    assert p.call("chaosDisk", name="chaos", op="fsync", err="EIO", count=1) == {
        "armed": {"fsync": ["EIO", 1]}}
    p.call("put", doc=d, obj="_root", prop="b", value=2)
    p.request("commit", {"doc": d})  # the fault's answer, compared
    r, q = p.request("durableInfo", {"doc": d}, compare=False)
    assert dict(q["result"], path=None) == dict(r["result"], path=None)
    p.call("chaosDisk", name="chaos", clear=True)
    p.error("chaosDisk", name="nope", op="write")
    assert p.call("durableReopen", name="chaos") == {"doc": d, "reopened": True}
    p.call("materialize", doc=d)
    p.close()
    p.check_files()


# -- the port alone -------------------------------------------------------------


def test_a_failed_mirror_feed_is_counted_and_answered(tmp_path, monkeypatch):
    """``receiveSyncMessage``'s feed into the mirror: the JAX package
    counts a failure and acks; the port counts it and answers with the
    error (the host document holds the changes)."""
    srv = PR.RpcServer(durable_dir=str(tmp_path), device="cpu")
    call = lambda m, **kw: srv.handle({"id": 1, "method": m, "params": kw})  # noqa: E731
    d = call("openDurable", name="fed", device=True)["result"]["doc"]
    q = call("create", actor="0c" * 16)["result"]["doc"]
    call("put", doc=q, obj="_root", prop="k", value=1)
    call("commit", doc=q)
    sq = call("syncStateNew")["result"]["sync"]
    sd = call("syncStateNew")["result"]["sync"]
    mirror = srv._docs[d].device_doc

    def lost(changes):
        raise RuntimeError("the card went away")

    monkeypatch.setattr(mirror, "apply_changes", lost)
    resp = None
    for _ in range(10):
        m = call("generateSyncMessage", doc=q, sync=sq)["result"]
        if m is None:
            break
        resp = call("receiveSyncMessage", doc=d, sync=sd, data=m)
        if "error" in resp:
            break
        back = call("generateSyncMessage", doc=d, sync=sd)["result"]
        if back is not None:
            call("receiveSyncMessage", doc=q, sync=sq, data=back)
    assert resp["error"] == {"type": "RuntimeError", "message": "the card went away",
                             "retriable": False}
    assert sum(pobs.counter_values("sync.device_feed_error", "error").values()) == 1
    assert pobs.counter_values("rpc.errors", "type").get("RuntimeError") == 1
    assert call("get", doc=d, obj="_root", prop="k")["result"] == 1
    srv.close_durables()


def test_a_failed_promotion_is_counted_and_answered(tmp_path, monkeypatch):
    """``_store_build_device``: the JAX package counts a failed promotion
    and serves the document warm; the port counts it and the request
    that touched the document answers with the error. Once the card is
    back the next request promotes."""
    srv = PR.RpcServer(durable_dir=str(tmp_path), device="cpu")
    call = lambda m, **kw: srv.handle({"id": 1, "method": m, "params": kw})  # noqa: E731
    d = call("openDurable", name="promo", device=True)["result"]["doc"]
    call("put", doc=d, obj="_root", prop="k", value=1)
    call("commit", doc=d)
    assert call("storeDemote", name="promo", to="warm")["result"]["tier"] == "warm"

    def lost(self):
        raise RuntimeError("no card for the mirror")

    real = PD.DurableDocument.build_device_mirror
    monkeypatch.setattr(PD.DurableDocument, "build_device_mirror", lost)
    resp = call("keys", doc=d, obj="_root")
    assert resp["error"] == {"type": "RuntimeError",
                             "message": "no card for the mirror", "retriable": False}
    assert sum(pobs.counter_values("store.promote_error", "error").values()) == 1
    assert srv.store.tier("promo") == "warm"
    monkeypatch.setattr(PD.DurableDocument, "build_device_mirror", real)
    assert call("keys", doc=d, obj="_root")["result"] == ["k"]
    assert srv.store.tier("promo") == "hot"
    assert srv._docs[d].device_doc.hydrate() == {"k": 1}
    srv.close_durables()


def test_the_server_serves_on_its_device_and_refuses_without_a_gpu(monkeypatch, tmp_path):
    srv = PR.RpcServer(durable_dir=str(tmp_path), device="cpu")
    call = lambda m, **kw: srv.handle({"id": 1, "method": m, "params": kw})["result"]  # noqa: E731
    a = call("create")["doc"]
    b = call("load", data=call("save", doc=a))["doc"]
    f = call("fork", doc=a)["doc"]
    d = call("openDurable", name="x", device=True)["doc"]
    for h in (a, b, f):
        assert srv._docs[h].doc.device == torch.device("cpu")
    assert srv._docs[d].doc.device == torch.device("cpu")
    assert srv._docs[d].device_doc.device == torch.device("cpu")
    srv.close_durables()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PR.RpcServer()
    assert PR.main(["--durable", str(tmp_path / "d")]) == 1


def _spawn(args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen(args, cwd=REPO, env=env, text=True, **kw)


@pytest.mark.skipif(os.name != "posix", reason="subprocess stdio test")
def test_subprocess_two_peer_session():
    """The frontend as a separate process, as an embedder runs it."""
    proc = _spawn(PORT_CMD, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    rid = [0]

    def rpc(method, **params):
        rid[0] += 1
        proc.stdin.write(json.dumps({"id": rid[0], "method": method,
                                     "params": params}) + "\n")
        proc.stdin.flush()
        resp = json.loads(proc.stdout.readline())
        assert resp["id"] == rid[0]
        assert "error" not in resp, resp
        return resp["result"]

    try:
        a = rpc("create", actor="0a" * 16)["doc"]
        t = rpc("putObject", doc=a, obj="_root", prop="t", type="text")["$obj"]
        rpc("spliceText", doc=a, obj=t, pos=0, text="over the wire")
        rpc("commit", doc=a)
        b = rpc("load", data=rpc("save", doc=a))["doc"]
        rpc("spliceText", doc=b, obj=t, pos=0, text=">> ")
        rpc("commit", doc=b)
        rpc("merge", doc=a, other=b)
        assert rpc("text", doc=a, obj=t) == ">> over the wire"
        rpc("shutdown")
    finally:
        proc.stdin.close()
        try:
            assert proc.wait(timeout=120) == 0
        finally:
            proc.kill()


@pytest.mark.skipif(os.name != "posix", reason="subprocess stdio test")
def test_subprocess_mid_request_eof_is_a_clean_shutdown():
    proc = _spawn(PORT_CMD, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                  stderr=subprocess.PIPE)
    try:
        proc.stdin.write('{"id": 1, "method": "create"}\n')
        proc.stdin.write('{"id": 2, "method": "put", "par')  # cut mid-request
        proc.stdin.flush()
        proc.stdin.close()
        assert proc.wait(timeout=120) == 0
        lines = proc.stdout.read().splitlines()
        assert json.loads(lines[0])["result"]["doc"] == 1
        assert proc.stderr.read() == ""
    finally:
        proc.kill()


@pytest.mark.skipif(os.name != "posix", reason="subprocess stdio test")
def test_subprocess_without_device_takes_the_card_or_refuses():
    """``python -m automerge_tpu_torch.rpc`` with no ``--device`` serves
    the card: without a GPU it exits 1 with the port's no-GPU error."""
    r = subprocess.run([sys.executable, "-m", "automerge_tpu_torch.rpc"],
                       cwd=REPO, stdin=subprocess.DEVNULL, capture_output=True,
                       text=True, timeout=120)
    if torch.cuda.is_available():
        assert r.returncode == 0, r.stderr
    else:
        assert r.returncode == 1 and "device='cpu'" in r.stderr, r.stderr
        assert r.stdout == ""


@pytest.mark.skipif(shutil.which("gcc") is None, reason="no C toolchain")
@pytest.mark.skipif(os.name != "posix", reason="fork/exec pipes")
def test_c_client_live_patch_convergence(tmp_path):
    """The pure-C client (clients/c) drives the port's server to the end
    of its session: live patches applied in C converge with the server's
    ``materialize`` snapshots."""
    exe = str(tmp_path / "rpc_client")
    r = subprocess.run(["gcc", "-O1", "-Wall", "-Werror", "-o", exe,
                        os.path.join(REPO, "clients", "c", "rpc_client.c")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([exe] + PORT_CMD, capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert r.returncode == 0, f"stdout: {r.stdout}\nstderr: {r.stderr}"
    assert "all assertions passed" in r.stdout
