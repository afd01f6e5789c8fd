"""The port's router tier, chaos fabric, advisor, the scrubber's follower
passes and ``rpc.main``'s cluster mode, on the CPU.

The router (``automerge_tpu_torch/cluster/router.py``) fronts nodes of
the port on ``device="cpu"``: the same seeded requests through a JAX
cluster and the port's give the same answers (virtual handles
included); failover loses no acked write; a warm and a cold document
migrate between groups; ``clusterMetrics`` merges every node. The
advisor runs the reference's own cases (``tests/test_advisor.py``) with
both packages' ``advise`` and ``render_text`` compared on every call;
the chaos pipes of both packages fault the same bytes from one seed. A
follower that diverges is counted, repaired by ``replReset`` and
quarantined on a repeat, as the JAX package's scrubber does. Last,
``python -m automerge_tpu_torch.rpc`` runs a leader and a follower as
processes that converge.

Helpers come from ``tests/test_torch_cluster.py``; every wait polls with
a deadline of at least 60 s and nothing sleeps to synchronise.
"""

import ast
import inspect
import os
import random
import socket
import subprocess
import sys
import threading

import pytest

import automerge_tpu.cluster as RC
import automerge_tpu_torch.cluster as PC
from automerge_tpu_torch import obs as pobs
from automerge_tpu_torch.api import AutoDoc as PAutoDoc

from .test_torch_cluster import (  # noqa: F401 — fixtures used by name
    OBS,
    TIMEOUT,
    Client,
    _fresh_obs,
    _reference_decodes_fresh,
    addr_of,
    cursor_lsn,
    replica,
    seq,
    start_node,
    wait_until,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTERS = {"ref": RC.ClusterRouter, "port": PC.ClusterRouter}


def start_router(pkg, groups, **kw):
    router = ROUTERS[pkg]([[addr_of(n) for n in g] for g in groups], **kw)
    router.start()
    return router


def kill_node_sockets(node):
    """A node's abrupt death in process: stop listening and cut every
    connection without a flush."""
    node._shutdown.set()
    if node._listener is not None:
        node._listener.close()
    with node._conns_lock:
        conns = list(node._conns.values())
    for conn in conns:
        conn.close()


# -- proxying ------------------------------------------------------------------


def routed_run(pkg, root, seq):
    """A router over two single-node groups: durable and plain documents,
    reads, a reopen and ``clusterInfo`` (less addresses)."""
    seq.reset()
    nodes = [start_node(pkg, root, f"g{i}", role="leader") for i in range(2)]
    router = start_router(pkg, [[nodes[0]], [nodes[1]]], heartbeat=5.0)
    try:
        c = Client(router.address)
        out = []
        docs = {}
        for name in ("alpha", "beta", "gamma", "delta"):
            r = c.raw("openDurable", name=name)
            out.append(r)
            docs[name] = r["result"]["doc"]
        for i, (name, d) in enumerate(sorted(docs.items())):
            for k in range(4):
                out.append(c.raw("put", doc=d, obj="_root", prop=f"k{k}", value=i * 10 + k))
            out.append(c.raw("commit", doc=d))
            out.append(c.raw("materialize", doc=d))
            out.append(c.raw("openDurable", name=name))  # the same virtual handle
        p = c.raw("create")
        out.append(p)
        out.append(c.raw("put", doc=p["result"]["doc"], obj="_root", prop="x", value=1))
        out.append(c.raw("commit", doc=p["result"]["doc"]))
        out.append(c.raw("keys", doc=p["result"]["doc"], obj="_root"))
        out.append(c.raw("get", doc=987654, obj="_root", prop="x"))  # unknown handle
        info = c.call("clusterInfo")
        out.append([{k: v for k, v in g.items() if k not in ("leader", "addrs")}
                    for g in info["groups"]])
        placed = {name: [n for n in nodes if name in n.rpc._durable_names]
                  for name in docs}
        out.append({name: [nodes.index(n) for n in ns] for name, ns in placed.items()})
        c.close()
        return out
    finally:
        router.stop()
        for n in nodes:
            n.stop()


def test_router_proxies_and_virtualizes_handles_as_the_jax_router(tmp_path, seq):
    want = routed_run("ref", tmp_path / "ref", seq)
    got = routed_run("port", tmp_path / "port", seq)
    assert got == want
    # every name placed on exactly the group the ring names
    ring = PC.HashRing([0, 1])
    assert got[-1] == {n: [ring.member_for(n)] for n in got[-1]}


def test_failover_loses_no_acked_write(tmp_path):
    fol1 = start_node("port", tmp_path, "n1", role="follower")
    fol2 = start_node("port", tmp_path, "n2", role="follower")
    led = start_node("port", tmp_path, "n0", role="leader",
                     replicate_to=[addr_of(fol1), addr_of(fol2)], ack_replicas=1)
    led_addr = addr_of(led)
    router = start_router("port", [[led, fol1, fol2]], heartbeat=0.1, miss_limit=3)
    try:
        c = Client(router.address)
        d = c.call("openDurable", name="docA")["doc"]
        c.call("syncSessionAttach", doc=d, peer="client-x")
        acked = []
        for i in range(10):
            c.call("put", doc=d, obj="_root", prop=f"k{i}", value=i)
            c.call("commit", doc=d)
            acked.append(i)
        kill_node_sockets(led)
        # writes through the failover: Unavailable is retriable
        wait_until(lambda: _write(c, d, acked), interval=0.05,
                   msg="writes acked through the failover")
        info = c.call("clusterInfo")
        assert info["groups"][0]["gen"] >= 1
        new = info["groups"][0]["leader"]
        assert new != led_addr
        for k in acked:
            assert c.call("get", doc=d, obj="_root", prop=f"k{k}") == k
        assert c.call("syncSessionAttach", doc=d, peer="client-x")["epoch"] >= 2
        promoted = next(n for n in (fol1, fol2) if addr_of(n) == new)
        assert promoted.rpc.cluster_role == "leader"
        assert replica(promoted, "docA").doc.device.type == "cpu"
        assert pobs.legacy_counters.get("cluster.promotions") == 1
        c.close()
    finally:
        router.stop()
        for n in (led, fol1, fol2):
            n.stop()


def _write(c, d, acked):
    """One attempt at the next write (key ``len(acked)``), kept in
    ``acked`` once acked (a retriable error mid-failover is not): True
    when 16 writes are acked."""
    k = len(acked)
    if "error" not in (c.call("put", doc=d, obj="_root", prop=f"k{k}", value=k,
                              allow_error=True) or {}) \
            and "error" not in (c.call("commit", doc=d, allow_error=True) or {}):
        acked.append(k)
    return len(acked) >= 16


def test_live_and_cold_migration_between_groups(tmp_path):
    n0 = start_node("port", tmp_path, "g0", role="leader")
    n1 = start_node("port", tmp_path, "g1", role="leader")
    router = start_router("port", [[n0], [n1]], heartbeat=5.0)
    try:
        c = Client(router.address)
        ring = PC.HashRing([0, 1])
        for name, cold in (("warmdoc", False), ("colddoc", True)):
            d = c.call("openDurable", name=name)["doc"]
            sess = c.call("syncSessionAttach", doc=d, peer=f"{name}-peer")
            for i in range(12):
                c.call("put", doc=d, obj="_root", prop=f"k{i}", value=i)
            c.call("commit", doc=d)
            home = ring.member_for(name)
            src = (n0, n1)[home]
            if cold:
                src.rpc.store.demote(name, "cold", "test")
            before = pobs.legacy_counters.get("cluster.migrate_cold_source", 0)
            assert c.call("clusterMigrate", name=name, to=1 - home)["migrated"] is True
            after = pobs.legacy_counters.get("cluster.migrate_cold_source", 0)
            assert (after - before >= 2) if cold else after == before
            for i in range(12):
                assert c.call("get", doc=d, obj="_root", prop=f"k{i}") == i
            c.call("put", doc=d, obj="_root", prop="after", value="moved")
            c.call("commit", doc=d)
            assert c.call("get", doc=d, obj="_root", prop="after") == "moved"
            if not cold:
                stats = c.call("syncSessionStats", session=sess["session"])
                assert stats["epoch"] > sess["epoch"]
            assert c.call("clusterInfo")["overrides"][name] == 1 - home
            # the source released the document: its flock is free
            assert src.rpc.store.tier(name) is None
            PAutoDoc.open(os.path.join(str(tmp_path), f"g{home}", name),
                          device="cpu").close()
            dst = (n0, n1)[1 - home]
            assert replica(dst, name).doc.device.type == "cpu"
        assert pobs.legacy_counters.get("cluster.migrations_in", 0) >= 2
        c.close()
    finally:
        router.stop()
        n0.stop()
        n1.stop()


def test_cluster_metrics_merges_every_node(tmp_path):
    from automerge_tpu_torch.obs.metrics import parse_prometheus

    fol = start_node("port", tmp_path, "f1", role="follower")
    led = start_node("port", tmp_path, "l1", role="leader",
                     replicate_to=[addr_of(fol)], ack_replicas=1)
    router = start_router("port", [[led, fol]], heartbeat=5.0)
    try:
        c = Client(router.address)
        d = c.call("openDurable", name="docM")["doc"]
        c.call("put", doc=d, obj="_root", prop="x", value=1)
        c.call("commit", doc=d)
        res = c.call("clusterMetrics")
        assert res["format"] == "prometheus" and not res["unreachable"]
        parsed = parse_prometheus(res["body"])
        nodes = {dict(k[1]).get("node") for k in parsed}
        assert None not in nodes
        assert nodes >= {"router", addr_of(led), addr_of(fol)}
        assert ("doc_journal_bytes", (("doc", "docM"), ("node", addr_of(led)))) in parsed
        assert res["body"].count("# TYPE rpc_request_count") <= 1
        adv = c.call("clusterAdvise")
        assert "recommendations" in adv
        c.close()
    finally:
        router.stop()
        led.stop()
        fol.stop()


# -- the advisor -----------------------------------------------------------------


def _reference_advisor_cases():
    from tests import test_advisor

    return [f for name, f in inspect.getmembers(test_advisor, inspect.isfunction)
            if name.startswith("test_")]


@pytest.mark.parametrize("case", _reference_advisor_cases(), ids=lambda f: f.__name__)
def test_advisor_answers_the_reference_cases_as_the_jax_advisor(case, monkeypatch):
    """Each case of ``tests/test_advisor.py`` with its ``advisor`` swapped
    for one that calls both packages on the same input and asserts equal
    output (then hands the case the port's answer)."""
    import copy

    from automerge_tpu.cluster import advisor as radv
    from automerge_tpu_torch.cluster import advisor as padv
    from tests import test_advisor

    calls = []

    def both(fn):
        def call(*a, **kw):
            want = getattr(radv, fn)(*copy.deepcopy(a), **copy.deepcopy(kw))
            got = getattr(padv, fn)(*a, **kw)
            assert got == want, fn
            calls.append(fn)
            return got
        return call

    shim = type(padv)("advisor_both")
    shim.advise, shim.render_text = both("advise"), both("render_text")
    monkeypatch.setattr(test_advisor, "advisor", shim)
    case()
    assert calls


# -- the chaos fabric ------------------------------------------------------------


def drive_pipe(pkg, seed, chunks, **policy):
    """``chunks`` through one chaos pipe of ``pkg`` (drop, corrupt,
    reorder from ``seed``): the bytes that came out and the faults
    counted."""
    mod = sys.modules[f"{'automerge_tpu' if pkg == 'ref' else 'automerge_tpu_torch'}"
                      ".cluster.chaos"]
    OBS[pkg].reset_all()
    proxy = mod.ChaosProxy("127.0.0.1:1", seed=seed)
    proxy.set_policy("c2s", **policy)
    a, b = socket.socketpair()
    b.settimeout(TIMEOUT)
    pipe = mod._Pipe(proxy, "c2s", None, a, random.Random(seed))
    for ch in chunks:
        assert pipe._forward(ch)
    a.shutdown(socket.SHUT_WR)
    out = bytearray()
    while True:
        got = b.recv(1 << 16)
        if not got:
            break
        out += got
    a.close()
    b.close()
    return bytes(out), OBS[pkg].counter_values("chaos.injected", "kind")


def test_chaos_pipes_fault_the_same_bytes_from_one_seed():
    rnd = random.Random(21)
    chunks = [bytes(rnd.randrange(256) for _ in range(rnd.randrange(1, 64)))
              for _ in range(300)]
    for seed in (1, 2, 1234):
        want = drive_pipe("ref", seed, chunks, drop=0.2, corrupt=0.2, reorder=0.1)
        got = drive_pipe("port", seed, chunks, drop=0.2, corrupt=0.2, reorder=0.1)
        assert got == want
        assert set(got[1]) == {"drop", "corrupt", "reorder"}


def test_chaos_proxy_and_schedule_count_the_same_faults():
    """A proxy of each package between a client and a line echo: a
    partition, a heal and a sever on one seeded schedule, the same
    injected-fault counts and the same plan."""

    def run(pkg):
        mod = PC if pkg == "port" else RC
        OBS[pkg].reset_all()
        ls = socket.socket()
        ls.bind(("127.0.0.1", 0))
        ls.listen(4)

        def echo():
            try:
                conn, _ = ls.accept()
            except OSError:
                return
            with conn:
                while True:
                    try:
                        d = conn.recv(4096)
                    except OSError:
                        return
                    if not d:
                        return
                    conn.sendall(d)

        t = threading.Thread(target=echo, daemon=True)
        t.start()
        proxy = mod.ChaosProxy("127.0.0.1:%d" % ls.getsockname()[1], seed=5).start()
        rng = random.Random(5)
        sched = mod.ChaosSchedule()
        for at, label, action in sorted(
                (rng.random() * 0.01, lbl, fn) for lbl, fn in (
                    ("partition", lambda: proxy.partition("s2c")),
                    ("heal", proxy.heal), ("sever", proxy.sever))):
            sched.at(at, label, action)
        try:
            host, _, port = proxy.address.rpartition(":")
            s = socket.create_connection((host, int(port)), timeout=TIMEOUT)
            s.sendall(b"ping\n")
            assert s.recv(16) == b"ping\n"
            sched.start()
            assert sched.join(timeout=TIMEOUT)
            s.close()
            return (sched.plan(), sched.executed, sched.errors,
                    OBS[pkg].counter_values("chaos.injected", "kind"))
        finally:
            proxy.stop()
            ls.close()
            t.join(TIMEOUT)

    want, got = run("ref"), run("port")
    assert got == want
    assert got[3] == {"partition_s2c": 1, "heal": 1, "sever": 1}


# -- the scrubber's follower passes ----------------------------------------------


def diverge(pkg, fol, name, key):
    """A foreign change applied to the follower's replica alone."""
    if pkg == "port":
        other = PAutoDoc(device="cpu")
    else:
        from automerge_tpu.api import AutoDoc as RAutoDoc

        other = RAutoDoc()
    other.put("_root", key, 1)
    other.commit()
    doc = replica(fol, name)
    with doc.lock:
        doc.apply_changes(other.get_changes([]))


def scrub_run(pkg, root):
    fol = start_node(pkg, root, "f", role="follower")
    led = start_node(pkg, root, "l", role="leader", replicate_to=[addr_of(fol)],
                     ack_replicas=1)
    try:
        c = Client(led.address)
        d = c.call("openDurable", name="sd")["doc"]
        for i in range(3):
            c.call("put", doc=d, obj="_root", prop=f"k{i}", value=i)
            c.call("commit", doc=d)
        lsn = led.rpc.hub.lsn("sd")
        wait_until(lambda: cursor_lsn(fol, "sd") == lsn, msg="the follower level")
        rounds = [c.call("scrubNow")]  # clean
        diverge(pkg, fol, "sd", "rot1")
        rounds.append(c.call("scrubNow"))  # diverged: repaired by replReset
        fc = Client(fol.address)
        digests = (c.call("docDigest", name="sd")["digest"],
                   fc.call("docDigest", name="sd")["digest"])
        diverge(pkg, fol, "sd", "rot2")
        rounds.append(c.call("scrubNow"))  # again: quarantined
        o = OBS[pkg]
        counts = {k: o.legacy_counters.get(k, 0) for k in (
            "cluster.digest_ok", "cluster.divergence", "cluster.divergence_repaired",
            "cluster.repl_resets", "cluster.quarantine", "scrub.repair_error")}
        quarantined = led.rpc.hub.quarantined_addrs() == [addr_of(fol)]
        c.close()
        fc.close()
        return rounds, digests, counts, quarantined
    finally:
        led.stop()
        fol.stop()


def test_scrubber_repairs_then_quarantines_a_diverged_follower(tmp_path):
    want = scrub_run("ref", tmp_path / "ref")
    got = scrub_run("port", tmp_path / "port")
    assert [r["divergent"] for r in got[0]] == [0, 1, 1]
    assert [r["repaired"] for r in got[0]] == [0, 1, 0]
    assert [r["quarantined"] for r in got[0]] == [0, 0, 1]
    assert got[1][0] == got[1][1], "the repaired follower's digest"
    assert got[2]["cluster.divergence"] == 2 and got[2]["cluster.quarantine"] == 1
    assert got[3] is True
    assert (got[0], got[2], got[3]) == (want[0], want[2], want[3])


# -- rpc.main's cluster mode -----------------------------------------------------


def spawn_node(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "automerge_tpu_torch.rpc", "--device", "cpu", *args],
        cwd=REPO, env=env, text=True, stdin=subprocess.DEVNULL,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    lines = []
    for line in proc.stderr:
        lines.append(line)
        if line.startswith("serving on "):
            host, port = ast.literal_eval(line[len("serving on "):].strip())
            threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True).start()
            return proc, (host, port), lines
    proc.wait(TIMEOUT)
    raise AssertionError("no 'serving on' line: " + "".join(lines)[-2000:])


@pytest.mark.skipif(os.name != "posix", reason="subprocess test")
def test_rpc_main_runs_a_leader_and_a_follower_that_converge(tmp_path):
    procs = []
    try:
        fproc, faddr, _ = spawn_node([
            "--socket", "127.0.0.1:0", "--durable", str(tmp_path / "f"),
            "--node-id", "f1", "--follow", "127.0.0.1:1"])
        procs.append(fproc)
        lproc, laddr, _ = spawn_node([
            "--socket", "127.0.0.1:0", "--durable", str(tmp_path / "l"),
            "--node-id", "l1", "--replicate-to", "%s:%d" % faddr, "--ack-replicas", "1"])
        procs.append(lproc)
        c, fc = Client(laddr), Client(faddr)
        assert c.call("clusterStatus")["role"] == "leader"
        st = fc.call("clusterStatus")
        assert st["role"] == "follower" and st["leader"] == "127.0.0.1:1"
        d = c.call("openDurable", name="proc")["doc"]
        for i in range(5):
            c.call("put", doc=d, obj="_root", prop=f"k{i}", value=i)
            c.call("commit", doc=d)  # acked: on the follower's disk too
        lsn = c.call("clusterStatus")["docs"]["proc"]["lsn"]
        docs = fc.call("clusterStatus")["docs"]
        assert docs["proc"]["cursor"]["lsn"] == lsn
        assert docs["proc"]["digest"] == c.call("docDigest", name="proc")["digest"]
        err = fc.call("put", allow_error=True, doc=1, obj="_root", prop="x", value=1)
        assert err["error"]["type"] == "NotLeader"
        for cl in (c, fc):
            assert cl.call("shutdown") is None
            cl.close()
        for p in procs:
            assert p.wait(TIMEOUT) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(TIMEOUT)


def test_rpc_main_cluster_mode_needs_socket_and_durable(tmp_path, capsys):
    from automerge_tpu_torch import rpc as PR

    switch = sys.getswitchinterval()  # main sets a server process's
    for flags in (["--node-id", "n1"], ["--follow", "127.0.0.1:1"],
                  ["--replicate-to", "127.0.0.1:1"]):
        assert PR.main(flags + ["--unix", str(tmp_path / "s"), "--device", "cpu"]) == 2
        assert "requires --socket and --durable" in capsys.readouterr().err
    sys.setswitchinterval(switch)
