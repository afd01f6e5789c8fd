"""The port's concurrent serving layer (``automerge_tpu_torch/serve/``:
``ShardPool``, ``AdmissionController``, ``SocketRpcServer``) on the CPU.

The reference's ``tests/test_serve.py`` and ``tests/test_overload.py``
cases, ported to ``SocketRpcServer(device="cpu")`` (the replication
breaker's cases wait for ``cluster/``): shard ordering and bounding,
backpressure, group commit, coalesced receive runs, admission shedding by
priority class, brownout hysteresis, deadlines. Then differential cases
against the JAX package's server: one seeded multi-client run over TCP
gives the same responses on every connection, and with
``AUTOMERGE_TPU_SERVE_BATCHED=1`` eight mirrored documents fed by
concurrent peers through the cross-document batcher hold mirrors equal to
the JAX package's. Last the port's own rules: no GPU, no server without
``device``; a failed feed of a coalesced run is counted and answers every
request of the run with its error.

Every socket has a timeout, every thread is joined with one, every server
stops in a ``finally`` or a fixture, and nothing asserts a wall-clock
threshold.
"""

import base64
import json
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from automerge_tpu_torch import obs
from automerge_tpu_torch import trace
from automerge_tpu_torch.api import AutoDoc as _PortAutoDoc
from automerge_tpu_torch.ops import batched as pbatched
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.rpc import RpcServer
from automerge_tpu_torch.serve import QueueFull, ShardPool, SocketRpcServer
from automerge_tpu_torch.serve.admission import (
    NO_SHED_RANK,
    AdmissionController,
    Overloaded,
    priority_class,
)
from automerge_tpu_torch.types import ActorId

TIMEOUT = 60  # seconds: every socket read and every join


def AutoDoc(actor=None, **kw):
    kw.setdefault("device", "cpu")
    return _PortAutoDoc(actor, **kw)


@pytest.fixture(autouse=True)
def _fresh_obs():
    from automerge_tpu import obs as robs

    robs.reset_all()
    obs.reset_all()
    yield


def join_all(threads):
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


# -- ShardPool units ----------------------------------------------------------


def test_shard_pool_per_key_fifo_and_cross_key_parallel():
    """Items for one key execute in submission order (even across many
    drains); two keys can be in flight on two workers at once."""
    order = {"a": [], "b": []}
    in_flight = set()
    overlap = []
    lock = threading.Lock()
    both_in = threading.Event()

    def execute(key, items):
        with lock:
            in_flight.add(key)
            if len(in_flight) == 2:
                overlap.append(True)
                both_in.set()
        if 0 in items:
            # each key's FIRST batch parks until both keys are in flight
            both_in.wait(TIMEOUT)
        order[key].extend(items)
        with lock:
            in_flight.discard(key)

    pool = ShardPool(execute, workers=2, max_queue=64, max_batch=4)
    for i in range(16):
        pool.submit("a", i)
        pool.submit("b", i)
    pool.stop(drain=True)
    assert order["a"] == list(range(16))
    assert order["b"] == list(range(16))
    assert overlap, "two keys never executed concurrently"


def test_shard_pool_backpressure_raises_queue_full():
    blocker = threading.Event()
    started = threading.Event()

    def execute(key, items):
        started.set()
        blocker.wait(TIMEOUT)

    pool = ShardPool(execute, workers=1, max_queue=2, max_batch=1)
    try:
        pool.submit("d", 0)
        assert started.wait(TIMEOUT)  # the worker now holds item 0
        pool.submit("d", 1)
        pool.submit("d", 2)
        with pytest.raises(QueueFull):
            pool.submit("d", 3)
    finally:
        blocker.set()
        pool.stop(drain=True)


def test_shard_pool_single_writer_per_key():
    active, bad = [], []
    lock = threading.Lock()

    def execute(key, items):
        with lock:
            if key in active:
                bad.append(key)
            active.append(key)
        time.sleep(0.001)
        with lock:
            active.remove(key)

    pool = ShardPool(execute, workers=8, max_queue=512, max_batch=2)
    for i in range(64):
        pool.submit("hot", i)
        pool.submit(f"cold{i % 4}", i)
    pool.stop(drain=True)
    assert not bad


def test_shard_pool_expected_wait_and_gauge_hygiene():
    started = threading.Event()
    release = threading.Event()

    def execute(key, items):
        for it in items:
            if it == "block":
                started.set()
                release.wait(TIMEOUT)

    waits = []
    pool = ShardPool(execute, workers=1, max_queue=8, max_batch=1, name="ol")
    pool.wait_observer = waits.append
    try:
        pool.submit("k", "block")
        assert started.wait(TIMEOUT)
        with pool._lock:
            pool._svc_ewma = 0.1
        pool.submit("k", "a")
        pool.submit("k", "b")
        assert pool.utilization() == 1.0
        assert pool.backlog() == 2 and pool.depth("k") == 2
        assert pool.expected_wait() == pytest.approx(0.2)
        release.set()
        deadline = time.monotonic() + TIMEOUT
        while pool.backlog() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pool.backlog() == 0
        assert pool.expected_wait() == 0.0
        assert pool._svc_ewma > 0.0
        assert waits and all(w >= 0.0 for w in waits)
        # drained queues drop their rpc.queue_depth series
        series = None
        while time.monotonic() < deadline:
            series = [e for e in obs.snapshot() if e["name"] == "rpc.queue_depth"
                      and e["labels"].get("doc") == "k"]
            if not series:
                break
            time.sleep(0.01)
        assert not series, series
    finally:
        release.set()
        pool.stop()


def test_remove_doc_gauges_queue_key():
    obs.gauge_set("rpc.queue_depth", 3.0, labels={"doc": "gone-42"})
    assert obs.remove_doc_gauges(None, queue_key="gone-42") >= 1
    assert not any(e["name"] == "rpc.queue_depth" and e["labels"].get("doc") == "gone-42"
                   for e in obs.snapshot())


# -- admission control ----------------------------------------------------------


@pytest.mark.parametrize("method,rank,cls", [
    ("replApply", 0, "replication"), ("clusterStatus", 0, "replication"),
    ("metrics", 0, "replication"), ("profileStart", 0, "replication"),
    ("put", 1, "mutation"), ("someBrandNewMethod", 1, "mutation"),
    ("generateSyncMessage", 2, "sync"), ("syncSessionPoll", 2, "sync"),
    ("get", 3, "read"), ("save", 3, "read"), ("storeStatus", 3, "read"),
    ("durableCompact", 4, "background"), ("storeDemote", 4, "background"),
    ("docFence", 4, "background"),
])
def test_priority_class_mapping_equals_the_jax_package(method, rank, cls):
    from automerge_tpu.serve.admission import priority_class as rpriority

    assert priority_class(method) == (rank, cls) == rpriority(method)


def test_shed_fraction_band_and_shed_rank():
    ac = AdmissionController(enabled=True)
    try:
        soft, hard = ac.soft, ac.hard
        assert ac.shed_fraction(0, 1e9) == 0.0
        assert ac.shed_fraction(4, soft * 0.99) == 0.0
        assert ac.shed_fraction(4, soft * 1.5) == pytest.approx(0.5)
        assert ac.shed_fraction(4, soft * 2.0) == pytest.approx(1.0)
        assert ac.shed_fraction(4, soft * 9.0) == 1.0
        assert ac.shed_fraction(1, hard * 0.99) == 0.0
        assert ac.shed_fraction(1, hard * 1.5) == pytest.approx(0.5)
        assert ac.shed_rank(score=soft * 0.5) == NO_SHED_RANK
        assert ac.shed_rank(score=soft * 2.0) == 4
        assert ac.shed_rank(score=hard * 2.0) == 1
    finally:
        ac.reset()


def test_admit_sheds_by_class_and_overloaded_contract():
    ac = AdmissionController(enabled=True)
    try:
        ac.load_score = lambda now=None: 1.6
        assert ac.hard > 1.6 >= 2.0 * ac._shed_threshold(4)
        with pytest.raises(Overloaded) as ei:
            ac.admit("durableCompact")
        err = ei.value
        assert err.retriable is True and err.shed_class == "background"
        assert 50 <= err.retry_after_ms <= 5000
        assert obs.counter_values("serve.shed", "class") == {"background": 1}
        ac.admit("put")
        ac.load_score = lambda now=None: 100.0
        ac.admit("replApply")
        ac.admit("metrics")
    finally:
        ac.reset()


def test_admit_disabled_is_a_noop():
    ac = AdmissionController(enabled=False)
    try:
        ac.load_score = lambda now=None: 100.0
        ac.admit("durableCompact")
        ac.admit("put")
        assert ac.advertisement(now=1.0)["shedClass"] == NO_SHED_RANK
    finally:
        ac.reset()


class _FakePool:
    def __init__(self):
        self.util = 0.0

    def utilization(self):
        return self.util

    def backlog(self):
        return 0

    def expected_wait(self):
        return 0.0


def test_brownout_hysteresis_and_batcher_widen():
    """Enter after the hold, exit after the exit hold, a spike resets the
    exit clock, and the batcher's window widens and comes back; the
    port's flag is its own (the JAX package's stays clear)."""
    from automerge_tpu.degrade import brownout_active as rbrownout
    from automerge_tpu_torch.degrade import BROWNOUT, brownout_active

    fp = _FakePool()
    batcher = SimpleNamespace(window=8.0)
    ac = AdmissionController(pool=fp, batcher=batcher, enabled=True)
    try:
        step = ac.sample_s + 0.01
        t = 100.0
        fp.util = ac.brownout_enter + 1.0
        assert ac.load_score(now=t) == pytest.approx(fp.util)
        assert not brownout_active()
        t += ac.enter_hold_s / 2
        ac.load_score(now=t)
        assert not brownout_active()
        t += ac.enter_hold_s
        ac.load_score(now=t)
        assert brownout_active() and not rbrownout()
        assert ac.transitions == {"on": 1, "off": 0}
        assert batcher.window == pytest.approx(8.0 * ac.window_widen)
        fp.util = 0.0
        t += step
        ac.load_score(now=t)
        t += ac.exit_hold_s / 2
        fp.util = ac.brownout_exit + 0.2
        ac.load_score(now=t)
        fp.util = 0.0
        t += step
        ac.load_score(now=t)
        t += ac.exit_hold_s / 2
        ac.load_score(now=t)
        assert brownout_active()
        t += ac.exit_hold_s
        ac.load_score(now=t)
        assert not brownout_active()
        assert ac.transitions == {"on": 1, "off": 1}
        assert batcher.window == pytest.approx(8.0)
        assert not BROWNOUT.is_set()
    finally:
        ac.reset()


# -- deadlines and error envelopes on the RPC surface ---------------------------


def call(srv, method, **params):
    resp = srv.handle({"id": 1, "method": method, "params": params})
    assert "error" not in resp, resp
    return resp["result"]


def test_expired_deadline_refused_without_executing():
    srv = RpcServer(device="cpu")
    d = call(srv, "create", actor="07" * 16)["doc"]
    call(srv, "put", doc=d, obj="_root", prop="k", value=1)
    call(srv, "commit", doc=d)
    heads0 = call(srv, "heads", doc=d)
    resp = srv.handle({"id": 5, "method": "put",
                       "params": {"doc": d, "obj": "_root", "prop": "x", "value": 2},
                       "_deadline_ts": obs.now() - 1.0})
    assert resp["error"]["type"] == "DeadlineExceeded"
    assert resp["error"]["retriable"] is True
    assert obs.counter_values("serve.deadline_expired", "stage") == {"pre_fsync": 1}
    assert call(srv, "heads", doc=d) == heads0
    assert call(srv, "keys", doc=d, obj="_root") == ["k"]
    live = {"id": 6, "method": "put",
            "params": {"doc": d, "obj": "_root", "prop": "x", "value": 2},
            "_deadline_ts": obs.now() + 60.0}
    assert "error" not in srv.handle(live)
    assert call(srv, "get", doc=d, obj="_root", prop="x") == 2


def test_expired_deadline_executes_when_admission_disabled(monkeypatch):
    monkeypatch.setenv("AUTOMERGE_TPU_ADMISSION", "0")
    srv = RpcServer(device="cpu")
    assert srv.deadlines_enabled is False
    d = call(srv, "create", actor="08" * 16)["doc"]
    assert "error" not in srv.handle({
        "id": 2, "method": "put",
        "params": {"doc": d, "obj": "_root", "prop": "x", "value": 7},
        "_deadline_ts": obs.now() - 1.0})
    assert call(srv, "get", doc=d, obj="_root", prop="x") == 7


def test_parse_line_stamps_deadline():
    srv = RpcServer(device="cpu")
    req, early = srv._parse_line(json.dumps(
        {"id": 1, "method": "heads", "params": {}, "deadlineMs": 1500}))
    t0 = obs.now()
    assert early is None and t0 < req["_deadline_ts"] <= t0 + 1.6
    for bad in (0, -5, True, "100"):
        req, early = srv._parse_line(json.dumps(
            {"id": 1, "method": "heads", "params": {}, "deadlineMs": bad}))
        assert early is None and "_deadline_ts" not in req


@pytest.mark.parametrize("case", [
    "unknown_method", "bad_doc", "bad_params", "bad_changes",
    "open_durable_unsupported", "bad_sync_state", "expired_deadline",
])
def test_every_error_answer_carries_an_explicit_retriable_flag(case):
    """Each error envelope of the dispatch surface carries ``retriable``
    as a bool, and equals the JAX package's answer to the same request."""
    from automerge_tpu import obs as robs
    from automerge_tpu.rpc import RpcServer as RRpcServer

    answers = []
    for srv, clock in ((RRpcServer(), robs), (RpcServer(device="cpu"), obs)):
        d = call(srv, "create", actor="0a" * 16)["doc"]
        req = {
            "unknown_method": {"method": "nope", "params": {}},
            "bad_doc": {"method": "get",
                        "params": {"doc": 999, "obj": "_root", "prop": "x"}},
            "bad_params": {"method": "put", "params": {"doc": d}},
            "bad_changes": {"method": "applyChanges",
                            "params": {"doc": d, "changes": ["!!not-b64!!"]}},
            "open_durable_unsupported": {"method": "openDurable",
                                         "params": {"name": "x"}},
            "bad_sync_state": {"method": "receiveSyncMessage",
                               "params": {"doc": d, "state": "@@@",
                                          "message": "@@@"}},
            "expired_deadline": {"method": "put",
                                 "params": {"doc": d, "obj": "_root",
                                            "prop": "x", "value": 1},
                                 "_deadline_ts": clock.now() - 1.0},
        }[case]
        answers.append(srv.handle(dict(req, id=1)))
    resp = answers[1]
    assert resp == answers[0]
    err = resp["error"]
    assert isinstance(err.get("retriable"), bool), (case, err)
    if case == "expired_deadline":
        assert err["type"] == "DeadlineExceeded" and err["retriable"] is True
    if case == "unknown_method":
        assert err["type"] == "UnknownMethod" and err["retriable"] is False


# -- the socket server ----------------------------------------------------------


class Client:
    """Minimal pipelining JSON-RPC socket client, every read bounded."""

    def __init__(self, address):
        self.sock = socket.create_connection(address, timeout=TIMEOUT)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.f = self.sock.makefile("r")
        self.rid = 0

    def pipeline(self, reqs, allow_errors=False):
        first = self.rid + 1
        lines = []
        for method, params in reqs:
            self.rid += 1
            lines.append(json.dumps({"id": self.rid, "method": method,
                                     "params": params}))
        self.sock.sendall(("\n".join(lines) + "\n").encode())
        by = {}
        while len(by) < len(reqs):
            line = self.f.readline()
            assert line, "connection closed"
            resp = json.loads(line)
            if not allow_errors:
                assert "error" not in resp, resp
            by[resp["id"]] = resp
        return [by[first + i] for i in range(len(reqs))]

    def call(self, method, **params):
        return self.pipeline([(method, params)])[0].get("result")

    def close(self):
        self.sock.close()


def start(tmp_path=None, module=None, *, shedding=False, **kw):
    """A started server of the port (``module`` None) or of the JAX
    package. Its admission controller sheds only with ``shedding``: a
    loaded test machine must not turn the other cases' requests into
    ``Overloaded`` answers (deadlines stay enforced either way)."""
    if module is None:
        kw.setdefault("device", "cpu")
        cls = SocketRpcServer
    else:
        cls = module.SocketRpcServer
    kw.setdefault("workers", 4)
    srv = cls(host="127.0.0.1", port=0,
              durable_dir=None if tmp_path is None else str(tmp_path), **kw)
    srv.admission.enabled = shedding
    srv.start()
    return srv


@pytest.fixture
def server(tmp_path):
    srv = start(tmp_path)
    try:
        yield srv
    finally:
        srv.stop()


def test_concurrent_clients_distinct_docs(server):
    errs = []

    def one(ci):
        try:
            c = Client(server.address)
            d = c.call("create", actor=f"{ci:02x}" * 16)["doc"]
            for k in range(30):
                c.call("put", doc=d, obj="_root", prop=f"k{k}", value=k)
            c.call("commit", doc=d)
            assert c.call("length", doc=d, obj="_root") == 30
            c.close()
        except Exception as e:  # noqa: BLE001 — surfaced in the main thread
            errs.append(f"{ci}: {e}")

    ts = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    join_all(ts)
    assert not errs, errs


def test_same_doc_requests_keep_arrival_order(server):
    c = Client(server.address)
    d = c.call("create")["doc"]
    reqs = [("put", {"doc": d, "obj": "_root", "prop": "x", "value": k})
            for k in range(50)]
    reqs += [("commit", {"doc": d}), ("get", {"doc": d, "obj": "_root", "prop": "x"})]
    assert c.pipeline(reqs)[-1]["result"] == 49
    c.close()


def test_group_commit_amortizes_fsyncs(server):
    """Concurrent committers against ONE durable doc: fewer fsyncs than
    commit requests, a multi-append fsync, every acked key durable."""
    trace.reset_timers()
    n_clients, n_commits = 4, 8
    errs = []

    def committer(ci):
        try:
            c = Client(server.address)
            d = c.call("openDurable", name="grp")["doc"]
            reqs = []
            for k in range(n_commits):
                reqs.append(("put", {"doc": d, "obj": "_root",
                                     "prop": f"c{ci}_{k}", "value": k}))
                reqs.append(("commit", {"doc": d}))
            c.pipeline(reqs)
            c.close()
        except Exception as e:  # noqa: BLE001
            errs.append(f"{ci}: {e}")

    ts = [threading.Thread(target=committer, args=(i,)) for i in range(n_clients)]
    for t in ts:
        t.start()
    join_all(ts)
    assert not errs, errs
    fsyncs = trace.timing_summary().get("journal.fsync", {}).get("n", 0)
    assert 0 < fsyncs < n_clients * n_commits
    h = obs.registry.histogram("group_commit.batch_size")
    assert h.n > 0 and h.vmax >= 2, (h.n, h.vmax)
    server.stop()
    dd = _PortAutoDoc.open(str(server.rpc.durable_dir) + "/grp", device="cpu")
    keys = set(dd.keys())
    dd.close()
    assert not [f"c{ci}_{k}" for ci in range(n_clients) for k in range(n_commits)
                if f"c{ci}_{k}" not in keys]


def test_backpressure_error_surfaces_and_server_survives(tmp_path):
    srv = start(tmp_path, workers=1, max_queue=4, max_batch=1)
    try:
        c = Client(srv.address)
        d = c.call("openDurable", name="bp")["doc"]
        reqs = []
        for k in range(60):
            reqs.append(("put", {"doc": d, "obj": "_root", "prop": f"k{k}", "value": k}))
            reqs.append(("commit", {"doc": d}))
        kinds = [r["error"]["type"] if "error" in r else "ok"
                 for r in c.pipeline(reqs, allow_errors=True)]
        assert "Backpressure" in kinds and "ok" in kinds
        assert set(kinds) <= {"ok", "Backpressure"}, set(kinds)
        assert c.call("length", doc=d, obj="_root") >= 1
        c.close()
    finally:
        srv.stop()


def test_merge_across_shards_under_concurrent_edits(server):
    c = Client(server.address)
    a = c.call("create", actor="aa" * 16)["doc"]
    b = c.call("create", actor="bb" * 16)["doc"]
    c.call("put", doc=b, obj="_root", prop="seed", value=1)
    c.call("commit", doc=b)
    errs = []
    stop = threading.Event()

    def editor():
        try:
            c2 = Client(server.address)
            k = 0
            while not stop.is_set():
                c2.call("put", doc=b, obj="_root", prop=f"e{k}", value=k)
                c2.call("commit", doc=b)
                k += 1
            c2.close()
        except Exception as e:  # noqa: BLE001
            errs.append(str(e))

    t = threading.Thread(target=editor)
    t.start()
    try:
        for _ in range(10):
            c.call("merge", doc=a, other=b)
    finally:
        stop.set()
        join_all([t])
    assert not errs, errs
    assert c.call("get", doc=a, obj="_root", prop="seed") == 1
    c.close()


def sync_peers_into(c, d, n_peers=3, keys=4, rounds=10):
    """Peers on the server push their changes into ``d`` over sync
    states, each round's frames pipelined so runs are adjacent in the
    document's queue."""
    peers = []
    for i in range(n_peers):
        p = c.call("create", actor=f"{i + 1:02x}" * 16)["doc"]
        for k in range(keys):
            c.call("put", doc=p, obj="_root", prop=f"p{i}_{k}", value=k)
        c.call("commit", doc=p)
        peers.append((p, c.call("syncStateNew")["sync"], c.call("syncStateNew")["sync"]))
    for _ in range(rounds):
        frames = []
        for p, sp, sd in peers:
            m = c.call("generateSyncMessage", doc=p, sync=sp)
            if m is not None:
                frames.append(("receiveSyncMessage", {"doc": d, "sync": sd, "data": m}))
        if not frames:
            break
        c.pipeline(frames, allow_errors=True)
        for p, sp, sd in peers:
            back = c.call("generateSyncMessage", doc=d, sync=sd)
            if back is not None:
                c.call("receiveSyncMessage", doc=p, sync=sp, data=back)
    return peers


def test_receive_sync_coalescing_feeds_device_once(server):
    """A pipelined run of receiveSyncMessage frames for one mirrored
    document coalesces its feed into ``apply_batches``; the mirror ends
    in step with the host history and equals a fresh resolve."""
    c = Client(server.address)
    d = c.call("openDurable", name="dev", device=True)["doc"]
    trace.reset_counters()
    sync_peers_into(c, d)
    keys = c.call("keys", doc=d, obj="_root")
    assert all(f"p{i}_{k}" in keys for i in range(3) for k in range(4))
    dd = server.rpc._docs[d]
    assert dd.device_doc is not None and dd.device_doc.device.type == "cpu"
    assert len(dd.device_doc.log.changes) == len(dd.doc.history)
    assert trace.counters.get("rpc.coalesced", 0) >= 2
    fresh = DeviceDoc.merge([dd.doc], device="cpu")
    assert dd.device_doc.hydrate() == fresh.hydrate()
    c.close()


def test_hostile_frames_over_socket(server):
    c = Client(server.address)
    c.call("configure", maxRequestBytes=4096)
    c.sock.sendall(b"this is not json\n")
    assert json.loads(c.f.readline())["error"]["type"] == "ParseError"
    c.sock.sendall(b"Z" * 10_000 + b"\n")
    assert json.loads(c.f.readline())["error"]["type"] == "RequestTooLarge"
    assert c.call("create")["doc"] >= 1
    c.close()


def test_shutdown_request_flushes_and_releases(tmp_path):
    srv = start(tmp_path, workers=2)
    try:
        c = Client(srv.address)
        d = c.call("openDurable", name="sd")["doc"]
        c.call("put", doc=d, obj="_root", prop="n", value=7)  # no commit
        assert c.call("shutdown") is None
        assert srv.wait_stopped(TIMEOUT)
        dd = _PortAutoDoc.open(str(tmp_path / "sd"), device="cpu")
        assert dd.hydrate() == {"n": 7}
        dd.close()
        c.close()
    finally:
        srv.stop()


def test_unix_socket_transport(tmp_path):
    path = str(tmp_path / "rpc.sock")
    srv = SocketRpcServer(unix_path=path, workers=2, device="cpu")
    srv.start()
    try:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(TIMEOUT)
        sock.connect(path)
        f = sock.makefile("r")
        sock.sendall(b'{"id":1,"method":"create","params":{}}\n')
        assert json.loads(f.readline())["result"]["doc"] == 1
        sock.close()
    finally:
        srv.stop()
    assert not (tmp_path / "rpc.sock").exists()


def test_stdio_transport_death_is_counted():
    class Exploding:
        def readline(self, limit=None):
            raise OSError("carrier lost")

    trace.reset_counters()
    RpcServer(device="cpu").serve(stdin=Exploding(), stdout=None)
    assert trace.counters.get("rpc.errors", 0) >= 1

    class OkOnce:
        def __init__(self):
            self.lines = ['{"id":1,"method":"create"}\n', ""]

        def readline(self, limit=None):
            return self.lines.pop(0)

    class BrokenOut:
        def write(self, s):
            raise BrokenPipeError("gone")

        def flush(self):
            pass

    before = trace.counters.get("rpc.errors", 0)
    RpcServer(device="cpu").serve(stdin=OkOnce(), stdout=BrokenOut())
    assert trace.counters.get("rpc.errors", 0) > before


def test_session_receive_many_batches_device_feed():
    from automerge_tpu_torch.sync import SyncSession

    a = AutoDoc(ActorId(bytes([1]) * 16))
    b = AutoDoc(ActorId(bytes([2]) * 16))
    for i in range(3):
        a.put("_root", f"k{i}", i)
        a.commit()

    class RecordingDev:
        def __init__(self):
            self.batch_calls, self.change_calls = [], []

        def apply_batches(self, batches):
            self.batch_calls.append([len(x) for x in batches])

        def apply_changes(self, changes):
            self.change_calls.append(len(changes))

    dev = RecordingDev()
    sa = SyncSession(a, epoch=1)
    sb = SyncSession(b, epoch=2, device_doc=dev)
    pending = []
    for now in range(40):
        fa = sa.poll(now)
        if fa is not None:
            pending.append(fa)
        if len(pending) >= 2 or (fa is None and pending):
            sb.receive_many(list(pending), now)
            pending.clear()
        fb = sb.poll(now)
        if fb is not None:
            sa.receive(fb, now)
        if sa.converged() and sb.converged():
            break
    assert a.get_heads() == b.get_heads()
    assert dev.batch_calls and not dev.change_calls
    assert sum(n for c in dev.batch_calls for n in c) == len(b.doc.history)


def drive_session(client_sess, c, server_session, rounds=60):
    for now in range(rounds):
        frame = client_sess.poll(float(now))
        if frame is not None:
            c.call("syncSessionReceive", session=server_session,
                   data=base64.b64encode(frame).decode())
        back = c.call("syncSessionPoll", session=server_session)
        if back is not None:
            client_sess.receive(base64.b64decode(back), float(now))
        stats = c.call("syncSessionStats", session=server_session)
        if client_sess.converged() and stats["converged"]:
            return stats
    raise AssertionError("sessions never converged")


def test_socket_session_resumes_across_server_restart(tmp_path):
    """The epoch handshake over the socket: a durable server session
    (``syncSessionAttach``) survives a server restart on the same
    directory with zero full resyncs on either side."""
    from automerge_tpu_torch.sync import SessionConfig, SyncSession

    local = AutoDoc(ActorId(bytes([5]) * 16))
    for i in range(4):
        local.put("_root", f"pre{i}", i)
        local.commit()
    sess = SyncSession(local, epoch=1, config=SessionConfig(timeout=1000.0))
    srv = start(tmp_path, workers=2)
    try:
        c = Client(srv.address)
        d = c.call("openDurable", name="resume", device=True)["doc"]
        att = c.call("syncSessionAttach", doc=d, peer="client-A")
        stats = drive_session(sess, c, att["session"])
        assert stats["resyncs"] == 0 and sess.stats["resyncs"] == 0
        first_epoch = att["epoch"]
        c.close()
    finally:
        srv.stop()
    srv2 = start(tmp_path, workers=2)
    try:
        c2 = Client(srv2.address)
        d2 = c2.call("openDurable", name="resume", device=True)["doc"]
        att2 = c2.call("syncSessionAttach", doc=d2, peer="client-A")
        assert att2["epoch"] > first_epoch
        local.put("_root", "post", "after-restart")
        local.commit()
        stats = drive_session(sess, c2, att2["session"])
        assert stats["resyncs"] == 0 and sess.stats["resyncs"] == 0
        assert sess.stats["resets"] >= 1
        assert c2.call("get", doc=d2, obj="_root", prop="post") == "after-restart"
        dd = srv2.rpc._docs[d2]
        assert dd.device_doc.hydrate() == dd.hydrate()
        c2.close()
    finally:
        srv2.stop()


def test_admission_sheds_and_deadlines_at_the_server(tmp_path):
    """Shedding by class through the socket (Overloaded with its backoff
    hint, mutations admitted, replication and control never shed), and
    the admission-stage deadline gate before any queue slot."""
    server = start(tmp_path, shedding=True)
    try:
        admission_at(server)
    finally:
        server.stop()


def admission_at(server):
    c = Client(server.address)
    d = c.call("openDurable", name="shed")["doc"]
    server.admission.load_score = lambda now=None: 1.6
    r = c.pipeline([("durableCompact", {"doc": d})], allow_errors=True)[0]
    assert r["error"]["type"] == "Overloaded" and r["error"]["retriable"] is True
    assert 50 <= r["error"]["retryAfterMs"] <= 5000
    c.call("put", doc=d, obj="_root", prop="k", value=1)
    c.call("metrics", format="json")
    sent = []
    conn = SimpleNamespace(send=sent.append)
    server._route(conn, {"id": 9, "method": "put", "_deadline_ts": obs.now() - 1.0,
                         "params": {"doc": d, "obj": "_root", "prop": "k", "value": 2}})
    assert json.loads(sent[0])["error"]["type"] == "DeadlineExceeded"
    assert obs.counter_values("serve.deadline_expired", "stage") == {"admission": 1}
    assert obs.counter_values("serve.shed", "class") == {"background": 1}
    assert c.call("get", doc=d, obj="_root", prop="k") == 1
    c.close()


def test_the_dequeue_deadline_gate_answers_without_executing(server):
    sent = []
    conn = SimpleNamespace(send=sent.append)
    d = server.rpc.handle({"id": 1, "method": "create", "params": {}})["result"]["doc"]
    server._execute_batch(d, [(conn, {"id": 2, "method": "put",
                                      "_deadline_ts": obs.now() - 1.0,
                                      "params": {"doc": d, "obj": "_root",
                                                 "prop": "k", "value": 1}})])
    assert json.loads(sent[0])["error"]["type"] == "DeadlineExceeded"
    assert obs.counter_values("serve.deadline_expired", "stage") == {"dequeue": 1}
    assert server.rpc.handle({"id": 3, "method": "keys",
                              "params": {"doc": d, "obj": "_root"}})["result"] == []


# -- differential: the JAX package's server on the same traffic -------------------


def _script(rng, n):
    """A seeded per-connection request script over its own documents
    ``{plain}`` and ``{durable}`` (no handle is created in it)."""
    out = []
    for i in range(n):
        kind = int(rng.integers(0, 8))
        doc = "{durable}" if rng.random() < 0.5 else "{plain}"
        if kind <= 2:
            out.append(("put", {"doc": doc, "obj": "_root",
                                "prop": f"k{int(rng.integers(0, 5))}",
                                "value": int(rng.integers(-9, 99))}))
        elif kind == 3:
            out.append(("commit", {"doc": doc, "message": f"m{i}"}))
        elif kind == 4:
            out.append(("keys", {"doc": doc, "obj": "_root"}))
        elif kind == 5:
            out.append(("materialize", {"doc": doc}))
        elif kind == 6:
            out.append(("heads", {"doc": doc}))
        else:
            out.append(("get", {"doc": doc, "obj": "_root", "prop": "k1"}))
    out.append(("commit", {"doc": "{durable}"}))
    out.append(("save", {"doc": "{durable}"}))
    out.append(("durableInfo", {"doc": "{nosuch}"}))
    return out


def _run_clients(srv, scripts, errs):
    """Handles made in one order, then every connection's script
    pipelined concurrently in chunks; the answers by connection."""
    clients, docs = [], []
    for ci in range(len(scripts)):
        c = Client(srv.address)
        clients.append(c)
        docs.append({"plain": c.call("create", actor=f"{0x20 + ci:02x}" * 16)["doc"],
                     "durable": c.call("openDurable", name=f"c{ci}")["doc"],
                     "nosuch": 10_000 + ci})
    answers = [None] * len(scripts)

    def run(ci):
        try:
            out = []
            reqs = [(m, {k: (docs[ci][v[1:-1]] if isinstance(v, str) and v.startswith("{")
                             else v) for k, v in p.items()}) for m, p in scripts[ci]]
            for j in range(0, len(reqs), 7):
                out += clients[ci].pipeline(reqs[j:j + 7], allow_errors=True)
            answers[ci] = out
        except Exception as e:  # noqa: BLE001
            errs.append(f"{ci}: {e!r}")

    ts = [threading.Thread(target=run, args=(ci,)) for ci in range(len(scripts))]
    for t in ts:
        t.start()
    join_all(ts)
    for c in clients:
        c.close()
    return answers


@pytest.fixture
def seeded_actors(monkeypatch):
    """The same random-actor sequence in both packages (``openDurable``
    picks a random actor), so both write the same change bytes."""
    import types as pytypes
    import uuid

    import automerge_tpu.types as RT
    import automerge_tpu_torch.types as PT

    for mod in (RT, PT):
        counter = iter(range(1, 1 << 30))
        monkeypatch.setattr(mod, "uuid", pytypes.SimpleNamespace(
            uuid4=lambda c=counter: uuid.UUID(int=(0xA5 << 120) | next(c))))


def test_a_scripted_multi_client_run_answers_as_the_jax_package(tmp_path, monkeypatch,
                                                                 seeded_actors):
    """Six connections, each with its own seeded script, concurrently
    against each package's server: every connection gets the same
    answers from both. Actors drawn per open are made sequential first
    (``openDurable`` takes a random actor in both packages)."""
    import automerge_tpu.serve as rserve

    scripts = [_script(np.random.default_rng(40 + ci), 30) for ci in range(6)]
    got = {}
    for name, mod in (("ref", rserve), ("port", None)):
        errs = []
        srv = start(tmp_path / name, module=mod)
        try:
            got[name] = _run_clients(srv, scripts, errs)
        finally:
            srv.stop()
        assert not errs, errs
    for ci, (r, p) in enumerate(zip(got["ref"], got["port"])):
        assert [x.get("id") for x in p] == [x.get("id") for x in r]
        assert p == r, ci
    kinds = {x["error"]["type"] for a in got["port"] for x in a if "error" in x}
    assert kinds == {"ValueError"}  # the bad handle only


N_BATCHED = 8


def _feed_mirrors(srv, rounds=4):
    """Eight mirrored durable documents, each fed by its own peer on its
    own connection, concurrently: even documents over sync states
    (``receiveSyncMessage``), odd ones over a sync session. Each peer
    writes a 600-character archive first (the mirror's first feed
    rebuilds it), then types into a small live text, so every later feed
    dirties a small share of the rows and rides a packed launch."""
    c0 = Client(srv.address)
    c0.call("configure", syncTimeoutMs=600_000)
    docs = [c0.call("openDurable", name=f"m{i}", device=True)["doc"]
            for i in range(N_BATCHED)]
    peers = []
    for i in range(N_BATCHED):
        p = c0.call("create", actor=f"{0x50 + i:02x}" * 16)["doc"]
        arch = c0.call("putObject", doc=p, obj="_root", prop="archive",
                       type="text")["$obj"]
        c0.call("spliceText", doc=p, obj=arch, pos=0, text=f"{i}" * 600)
        live = c0.call("putObject", doc=p, obj="_root", prop="live", type="text")["$obj"]
        c0.call("commit", doc=p)
        peers.append((p, live))
    c0.close()
    errs = []

    def peer(i):
        try:
            c = Client(srv.address)
            d, (p, live) = docs[i], peers[i]
            if i % 2 == 0:
                sp = c.call("syncStateNew")["sync"]
                sd = c.call("syncStateNew")["sync"]
            else:
                sp = c.call("syncSessionNew", doc=p, epoch=1)["session"]
                sd = c.call("syncSessionNew", doc=d, epoch=2)["session"]
            for r in range(rounds + 1):
                if r:
                    for k in range(3):
                        c.call("spliceText", doc=p, obj=live, pos=0, text=f"r{r}k{k} ")
                    c.call("commit", doc=p)
                for _ in range(12):
                    if i % 2 == 0:
                        m = c.call("generateSyncMessage", doc=p, sync=sp)
                        if m is not None:
                            c.call("receiveSyncMessage", doc=d, sync=sd, data=m)
                        b = c.call("generateSyncMessage", doc=d, sync=sd)
                        if b is not None:
                            c.call("receiveSyncMessage", doc=p, sync=sp, data=b)
                        if m is None and b is None:
                            break
                    else:
                        f = c.call("syncSessionPoll", session=sp)
                        if f is not None:
                            c.call("syncSessionReceive", session=sd, data=f)
                        b = c.call("syncSessionPoll", session=sd)
                        if b is not None:
                            c.call("syncSessionReceive", session=sp, data=b)
                        if f is None and b is None:
                            break
            assert c.call("heads", doc=d) == c.call("heads", doc=p)
            c.close()
        except Exception as e:  # noqa: BLE001
            errs.append(f"{i}: {e!r}")

    ts = [threading.Thread(target=peer, args=(i,)) for i in range(N_BATCHED)]
    for t in ts:
        t.start()
    join_all(ts)
    assert not errs, errs
    return docs


def mirror_facts(dev):
    """A mirror's READ_FETCH arrays (to its rows and objects) and hydrate."""
    out = {"rows": (dev.log.n, dev.log.n_objs),
           "hydrate": json.dumps(dev.hydrate(), default=repr, sort_keys=True)}
    for k in DeviceDoc.READ_FETCH:
        cut = dev.log.n_objs + 2 if k.startswith("obj_") else dev.log.n
        out[k] = np.asarray(dev.res[k])[:cut].tolist()
    return out


def test_batched_feeds_hold_mirrors_equal_to_the_jax_package(tmp_path, monkeypatch,
                                                             seeded_actors):
    """``AUTOMERGE_TPU_SERVE_BATCHED=1``: concurrent peers' feeds ride the
    cross-document batcher (packed launches of the plain versions on the
    CPU); each mirror equals the JAX package's server's, array for array,
    and a fresh resolve of its document."""
    import automerge_tpu.serve as rserve

    monkeypatch.setenv("AUTOMERGE_TPU_SERVE_BATCHED", "1")
    facts = {}
    for name, mod in (("ref", rserve), ("port", None)):
        pbatched.reset_stats()
        srv = start(tmp_path / name, module=mod, workers=N_BATCHED)
        try:
            if mod is None:
                assert srv.batcher.mode == "1" and srv.batcher.device.type == "cpu"
            docs = [srv.rpc._docs[d] for d in _feed_mirrors(srv)]
            facts[name] = [mirror_facts(dd.device_doc) for dd in docs]
            if mod is None:
                stats = pbatched.stats()
                assert stats["launches"] > 0, stats
                assert obs.counter_values("device.kernel_launches", "path").get(
                    "batched", 0) == stats["launches"]
                for dd in docs:
                    assert dd.device_doc.device.type == "cpu"
                    fresh = DeviceDoc.merge([dd.doc], device="cpu")
                    assert dd.device_doc.hydrate() == fresh.hydrate()
        finally:
            srv.stop()
    for i, (r, p) in enumerate(zip(facts["ref"], facts["port"])):
        assert p == r, i


# -- the port's own rules ---------------------------------------------------------


def test_no_server_without_device_when_no_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SocketRpcServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SocketRpcServer(host="127.0.0.1", port=0, durable_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RpcServer()
    srv = SocketRpcServer(host="127.0.0.1", port=0, device="cpu")
    try:
        assert srv.rpc.device.type == "cpu" and srv.batcher.device.type == "cpu"
        # under "auto", a CPU mirror resolves its own delta
        assert srv.batcher.mode == "auto"
        assert not srv.batcher.active(SimpleNamespace(device=torch.device("cpu")))
    finally:
        srv.stop()


@pytest.mark.parametrize("batched", ["0", "1"])
def test_a_failed_coalesced_feed_is_counted_and_answered(server, monkeypatch, batched):
    """``_run_receive_sync``: the JAX package's server counts a failed
    feed of a coalesced run and acks every frame; the port counts it and
    answers each request of the run with the error."""
    server.batcher.mode = batched
    c = Client(server.address)
    d = c.call("openDurable", name="fail", device=True)["doc"]
    mirror = server.rpc._docs[d].device_doc

    def lost(*a, **kw):
        raise RuntimeError("the card went away")

    # every route a feed can take to the mirror's resolution: its own
    # apply, the batcher's staging, a rebuild, a re-resolve
    for attr in ("apply_batches", "stage_batches", "_rebuild", "_reresolve"):
        monkeypatch.setattr(mirror, attr, lost)
    peers = []
    for i in range(3):
        p = c.call("create", actor=f"{0x61 + i:02x}" * 16)["doc"]
        c.call("put", doc=p, obj="_root", prop=f"x{i}", value=i)
        c.call("commit", doc=p)
        peers.append((p, c.call("syncStateNew")["sync"], c.call("syncStateNew")["sync"]))
    frames = []
    for p, sp, sd in peers:
        # the handshake first: the peer's second message carries its change
        c.call("receiveSyncMessage", doc=d, sync=sd,
               data=c.call("generateSyncMessage", doc=p, sync=sp))
        c.call("receiveSyncMessage", doc=p, sync=sp,
               data=c.call("generateSyncMessage", doc=d, sync=sd))
        m = c.call("generateSyncMessage", doc=p, sync=sp)
        frames.append(("receiveSyncMessage", {"doc": d, "sync": sd, "data": m}))
    answers = c.pipeline(frames, allow_errors=True)
    assert len(answers) == 3
    errors = [a["error"] for a in answers if "error" in a]
    assert errors and all(e == {"type": "RuntimeError", "message": "the card went away",
                                "retriable": False} for e in errors)
    assert sum(obs.counter_values("sync.device_feed_error", "error").values()) >= 1
    assert obs.counter_values("rpc.errors", "type").get("RuntimeError", 0) >= len(errors)
    c.close()


def test_a_failed_session_feed_is_counted_and_answered(server, monkeypatch):
    """``_run_session_receive``: the session counts the failed feed and
    it propagates; every request of the run answers with the error."""
    c = Client(server.address)
    c.call("configure", syncTimeoutMs=600_000)
    d = c.call("openDurable", name="sfail", device=True)["doc"]
    p = c.call("create", actor="71" * 16)["doc"]
    c.call("put", doc=p, obj="_root", prop="k", value=1)
    c.call("commit", doc=p)
    sp = c.call("syncSessionNew", doc=p, epoch=1)["session"]
    sd = c.call("syncSessionNew", doc=d, epoch=2)["session"]
    mirror = server.rpc._docs[d].device_doc

    def lost(*a, **kw):
        raise RuntimeError("no card")

    for attr in ("apply_batches", "apply_changes", "stage_batches", "_rebuild",
                 "_reresolve"):
        monkeypatch.setattr(mirror, attr, lost)
    server.batcher.mode = "1"  # even a length-1 run takes the coalesced path
    err = None
    for _ in range(12):
        f = c.call("syncSessionPoll", session=sp)
        if f is not None:
            r = c.pipeline([("syncSessionReceive", {"session": sd, "data": f})],
                           allow_errors=True)[0]
            if "error" in r:
                err = r["error"]
                break
        b = c.call("syncSessionPoll", session=sd)
        if b is not None:
            c.call("syncSessionReceive", session=sp, data=b)
    assert err == {"type": "RuntimeError", "message": "no card", "retriable": False}
    assert sum(obs.counter_values("sync.device_feed_error", "error").values()) == 1
    assert c.call("get", doc=d, obj="_root", prop="k") == 1  # the host holds it
    c.close()


def test_concurrent_first_launches_build_the_kernels_once(tmp_path, monkeypatch):
    """A server's workers that launch at once on a fresh checkout share
    one build: with ``nvcc`` a stand-in that records its runs, eight
    threads calling ``_build.build()`` together run one link, and each
    source compiles once."""
    import os
    import stat

    from automerge_tpu_torch.kernels import _build

    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text(f"""#!/bin/sh
echo "$@" >> {log}
sleep 0.2
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then touch "$2"; fi
  shift
done
""")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    spent, errs = [], []

    def first_launch():
        try:
            spent.append(_build.build())
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    import sys

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # threads interleave at every few bytecodes
    try:
        ts = [threading.Thread(target=first_launch) for _ in range(8)]
        for t in ts:
            t.start()
        join_all(ts)
    finally:
        sys.setswitchinterval(switch)
    assert not errs, errs
    runs = log.read_text().splitlines()
    assert sum("-shared" in r for r in runs) == 1
    assert len(runs) == len(_build._sources()) + 1
    assert sorted(s > 0 for s in spent) == [False] * 7 + [True]
    assert _build.library_path().exists() and os.path.getsize(_build.library_path()) == 0


def test_a_capture_over_the_rpc_records_the_workers_ranges(server, tmp_path):
    """``profileStart`` runs on a connection thread and the feeds on the
    shard workers: the capture still holds the workers' ``amtpu.*``
    ranges (the profiler records every thread)."""
    from automerge_tpu_torch.obs import prof

    c = Client(server.address)
    d = c.call("openDurable", name="cap", device=True)["doc"]
    start = c.call("profileStart", dir=str(tmp_path / "cap"))
    assert start["ok"], start
    try:
        sync_peers_into(c, d)
    finally:
        stop = c.call("profileStop")
    assert stop["ok"], stop
    cap = prof.read_capture(stop["trace"])
    assert cap["ranges"], cap
    assert all(r.startswith("amtpu.") for r in cap["ranges"])
    c.close()
