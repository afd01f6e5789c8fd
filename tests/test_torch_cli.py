"""The port's command line (``automerge_tpu_torch/cli.py``,
``python -m automerge_tpu_torch``) against the JAX package's.

Every subcommand runs in both packages on the same seeded inputs: the
port with ``--device cpu``, the JAX package on its CPU backend. Their
exit codes, stdout, stderr and the files they write must be equal (bar
the package's own name in the text that names it, and the seconds in a
metrics dump). Random actors are drawn from one counter in both
packages. The commands that scrape a server over the network read one
canned answer from a stand-in server; ``serve`` and ``cluster-router``
run as subprocesses and answer one request each. Without ``--device`` a
document command takes the card, and without one it exits 1.
"""

import ast
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import types as pytypes
import uuid
from pathlib import Path

import pytest
import torch

import automerge_tpu.api as RA
import automerge_tpu.cli as RCLI
import automerge_tpu.obs as RO
import automerge_tpu.types as RT
import automerge_tpu_torch.api as PA
import automerge_tpu_torch.cli as PCLI
import automerge_tpu_torch.obs as PO
import automerge_tpu_torch.types as PT

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 120
MAIN = {"ref": RCLI.main, "port": lambda argv: PCLI.main(["--device", "cpu", *argv])}


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """Both registries empty, and both packages' random actors drawn from
    one counter that restarts before each package's run."""
    import automerge_tpu.ops.extract as RX

    RO.reset_all()
    PO.reset_all()
    if RX._CHANGE_COLS_CACHE is not None:
        RX._CHANGE_COLS_CACHE.clear()
    fakes = []
    for mod in (RT, PT):
        fake = pytypes.SimpleNamespace()
        monkeypatch.setattr(mod, "uuid", fake)
        fakes.append(fake)

    def restart():
        counter = iter(range(1, 1 << 30))
        for fake in fakes:
            fake.uuid4 = lambda c=counter: uuid.UUID(int=(next(c) << 96) | 0xC1)

    restart()
    yield restart


def actor(pkg, i):
    return (RT if pkg is RA else PT).ActorId(bytes([i]) * 16)


def sample_doc(pkg, i=1):
    """A small document with text, a map, a list and a counter."""
    d = pkg.AutoDoc(actor=actor(pkg, i), **({} if pkg is RA else {"device": "cpu"}))
    T = RT if pkg is RA else PT
    t = d.put_object("_root", "title", T.ObjType.TEXT)
    d.splice_text(t, 0, 0, "hello cli")
    d.put("_root", "count", 3)
    lst = d.put_object("_root", "items", T.ObjType.LIST)
    for k, v in enumerate([1, "two", 3.5, None, True]):
        d.insert(lst, k, v)
    m = d.put_object("_root", "meta", T.ObjType.MAP)
    d.put(m, "v", 1)
    d.put("_root", "hits", T.ScalarValue("counter", 4))
    d.commit(timestamp=11)
    return d


def _norm_err(err: bytes) -> bytes:
    return err.replace(b"automerge_tpu_torch", b"automerge_tpu")


def run_both(capsysbinary, tmp_path, argv, setup=None, restart=None, norm=None):
    """Run ``argv`` (``{dir}`` is each package's own directory) in both
    packages: equal exit codes, raised errors, stdout, stderr and files."""
    res = {}
    for kind in ("ref", "port"):
        d = tmp_path / kind
        d.mkdir(exist_ok=True)
        if setup is not None:
            setup(d)
        if restart is not None:
            restart()
        args = [a.replace("{dir}", str(d)) for a in argv]
        capsysbinary.readouterr()
        try:
            rc, exc = MAIN[kind](args), None
        except Exception as e:  # noqa: BLE001 — compared across packages
            rc, exc = None, (type(e).__name__, str(e).replace(str(d), "{dir}"))
        cap = capsysbinary.readouterr()
        files = {}
        for p in sorted(d.rglob("*")):
            if p.is_file() and not p.name.endswith(".lock"):
                files[str(p.relative_to(d))] = _norm_err(p.read_bytes())
        out = (rc, exc, _norm_err(cap.out),
               _norm_err(cap.err).replace(str(d).encode(), b"{dir}"),
               files)
        res[kind] = norm(out) if norm is not None else out
    assert res["port"][:2] == res["ref"][:2]
    assert res["port"][2] == res["ref"][2]
    assert res["port"][3] == res["ref"][3]
    assert res["port"][4].keys() == res["ref"][4].keys()
    for k in res["ref"][4]:
        assert res["port"][4][k] == res["ref"][4][k], k
    return res["port"]


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


@pytest.fixture
def doc_file(tmp_path):
    p = tmp_path / "doc.automerge"
    p.write_bytes(sample_doc(RA).save())
    return p


# -- document commands ---------------------------------------------------------


@pytest.mark.parametrize("to_file", [True, False])
def test_export(doc_file, tmp_path, capsysbinary, to_file):
    argv = ["export", str(doc_file)] + (["-o", "{dir}/doc.json"] if to_file else [])
    rc, _, out, _, files = run_both(capsysbinary, tmp_path, argv)
    assert rc == 0
    body = files["doc.json"] if to_file else out
    assert json.loads(body)["title"] == "hello cli"


def test_import_roundtrip(tmp_path, capsysbinary, _fresh_state):
    src = tmp_path / "in.json"
    src.write_text(json.dumps({"a": 1, "items": [1, 2, {"x": True}], "s": "txt",
                               "nested": {"z": [None, 2.5, "u"]}}))
    rc, *_ = run_both(capsysbinary, tmp_path,
                      ["import", str(src), "-o", "{dir}/out.automerge"],
                      restart=_fresh_state)
    assert rc == 0
    rc, _, out, _, _ = run_both(capsysbinary, tmp_path,
                                ["export", "{dir}/out.automerge"])
    assert json.loads(out)["items"] == [1, 2, {"x": True}]


def test_import_rejects_a_non_object(tmp_path, capsysbinary):
    src = tmp_path / "in.json"
    src.write_text("[1, 2]")
    rc, _, _, err, _ = run_both(capsysbinary, tmp_path, ["import", str(src)])
    assert rc == 1 and b"must be an object" in err


def test_merge(doc_file, tmp_path, capsysbinary):
    files = [str(doc_file)]
    base = RA.AutoDoc.load(doc_file.read_bytes())
    for i in range(3):
        f = base.fork(actor=actor(RA, 10 + i))
        f.put("_root", f"extra{i}", i)
        f.splice_text(f.get("_root", "title")[0][2], i, 1, f"<{i}>")
        f.commit(timestamp=12)
        p = tmp_path / f"other{i}.automerge"
        p.write_bytes(f.save())
        files.append(str(p))
    rc, *_ = run_both(capsysbinary, tmp_path,
                      ["merge", *files, "-o", "{dir}/merged.automerge"])
    assert rc == 0
    merged = PA.AutoDoc.load((tmp_path / "port" / "merged.automerge").read_bytes(),
                             device="cpu")
    assert merged.hydrate()["extra2"] == 2


def test_merge_without_inputs(tmp_path, capsysbinary):
    rc, _, _, err, _ = run_both(capsysbinary, tmp_path, ["merge"])
    assert rc == 1 and b"at least one input" in err


def test_merge_runs_the_bulk_catch_up_on_the_device(doc_file, tmp_path, monkeypatch):
    """Every document the merge builds lives on ``--device``: a catch-up
    past the bulk threshold merges through the kernels there."""
    from automerge_tpu_torch.core.document import Document
    from automerge_tpu_torch.ops import merge as M

    monkeypatch.setattr(Document, "BULK_MIN_OPS", 5)
    seen = []
    real = M.merge_columns
    monkeypatch.setattr(M, "merge_columns",
                        lambda *a, **k: seen.append(str(k.get("device"))) or real(*a, **k))
    big = sample_doc(RA, 2)
    t = big.get("_root", "title")[0][2]
    big.splice_text(t, 0, 0, "x" * 40)
    big.commit(timestamp=3)
    other = tmp_path / "big.automerge"
    other.write_bytes(big.save())
    out = tmp_path / "m.automerge"
    assert MAIN["port"](["merge", str(doc_file), str(other), "-o", str(out)]) == 0
    assert seen and set(seen) == {"cpu"}


def test_examine(doc_file, tmp_path, capsysbinary):
    rc, _, out, _, _ = run_both(capsysbinary, tmp_path, ["examine", str(doc_file)])
    assert rc == 0 and json.loads(out)[0]["ops"][0]["action"] == "makeText"


def _damaged(tmp_path):
    d = RA.AutoDoc(actor=actor(RA, 1))
    d.put("_root", "keep", 1)
    d.commit(timestamp=1)
    good = d.save_incremental_after([])
    d.put("_root", "lost", 2)
    d.commit(timestamp=2)
    bad = bytearray(d.save_incremental_after([]))
    bad[len(good) + 14] ^= 0xFF
    p = tmp_path / "damaged.automerge"
    p.write_bytes(bytes(bad))
    return p


@pytest.mark.parametrize("cmd", ["export", "examine"])
@pytest.mark.parametrize("flags", [[], ["--salvage"], ["--skip-verifying-heads"]])
def test_damaged_save(tmp_path, capsysbinary, cmd, flags):
    rc, exc, out, err, _ = run_both(capsysbinary, tmp_path,
                                    [cmd, str(_damaged(tmp_path)), *flags])
    if "--salvage" in flags:
        assert rc == 0 and b"dropped span" in err
    else:
        assert exc is not None


def test_examine_sync(doc_file, tmp_path, capsysbinary):
    from automerge_tpu.sync import SyncState

    d = RA.AutoDoc.load(doc_file.read_bytes())
    msg = tmp_path / "msg.sync"
    msg.write_bytes(d.generate_sync_message(SyncState()).encode())
    rc, _, out, _, _ = run_both(capsysbinary, tmp_path, ["examine-sync", str(msg)])
    assert rc == 0 and json.loads(out)["heads"] == [h.hex() for h in d.get_heads()]


def test_examine_sync_session_frames(tmp_path, capsysbinary):
    from automerge_tpu.sync import SyncSession
    from automerge_tpu.sync.session import encode_frame

    d = RA.AutoDoc(actor=actor(RA, 1))
    d.put("_root", "x", 1)
    d.commit(timestamp=1)
    frame = tmp_path / "frame.sync"
    frame.write_bytes(SyncSession(d, epoch=5).poll(0))
    rc, _, out, _, _ = run_both(capsysbinary, tmp_path, ["examine-sync", str(frame)])
    assert rc == 0 and json.loads(out)["frame"]["epoch"] == 5
    empty = tmp_path / "empty.sync"
    empty.write_bytes(encode_frame(3, b"", flags=1, seq=9))
    rc, _, out, _, _ = run_both(capsysbinary, tmp_path, ["examine-sync", str(empty)])
    assert rc == 0 and json.loads(out) == {"frame": {"epoch": 3, "flags": 1, "seq": 9}}


@pytest.mark.parametrize("script", [
    'set .title "doc"; set .meta \'{"v": 1}\'; counter .n 5; increment .n 3',
    "set .t 'abc'; splice .t 1 1 XY; insert .l 0 1",
    "set .l '[1, [2, 3], {\"k\": \"v\"}]'; insert .l[1] 0 9; delete .l[0]; inc .c",
    "bogus .x 1",
])
def test_change_script(tmp_path, capsysbinary, _fresh_state, script):
    rc, exc, *_ = run_both(capsysbinary, tmp_path,
                           ["change", script, "-o", "{dir}/new.automerge"],
                           restart=_fresh_state)
    assert rc in (0, 1) or exc is not None


def test_change_on_existing(doc_file, tmp_path, capsysbinary, _fresh_state):
    rc, *_ = run_both(capsysbinary, tmp_path,
                      ["change", str(doc_file), "splice .title 5 0 ' brave'; delete .count",
                       "-o", "{dir}/edited.automerge"], restart=_fresh_state)
    assert rc == 0
    d = PA.AutoDoc.load((tmp_path / "port" / "edited.automerge").read_bytes(),
                        device="cpu")
    assert d.hydrate()["title"] == "hello brave cli"


# -- durable directories ---------------------------------------------------------


def _durable(path, n=3, compact=False):
    dd = RA.AutoDoc.open(str(path), fsync="never", actor=actor(RA, 1))
    for i in range(n):
        dd.put("_root", f"k{i}", "x" * (10 * i))
        dd.commit(timestamp=i)
    if compact:
        dd.compact()
        dd.put("_root", "tail", 1)
        dd.commit(timestamp=99)
    dd.close()
    return path


@pytest.mark.parametrize("damage", ["none", "torn", "header", "snapshot"])
@pytest.mark.parametrize("verify", [False, True])
def test_journal_info(tmp_path, capsysbinary, damage, verify):
    src = _durable(tmp_path / "src", compact=damage == "snapshot")
    if damage == "torn":
        jp = src / "journal.waj"
        jp.write_bytes(jp.read_bytes() + b"\x99torn-garbage")
    elif damage == "header":
        jp = src / "journal.waj"
        data = bytearray(jp.read_bytes())
        data[0] ^= 0xFF
        jp.write_bytes(bytes(data))
    elif damage == "snapshot":
        sp = next(p for p in src.iterdir() if p.name != "journal.waj"
                  and not p.name.endswith(".lock"))
        data = bytearray(sp.read_bytes())
        data[len(data) // 2] ^= 0x40
        sp.write_bytes(bytes(data))
    rc, _, out, err, _ = run_both(
        capsysbinary, tmp_path,
        ["journal-info", str(src), *(["--verify"] if verify else [])])
    assert json.loads(out)["records"] >= 1
    if damage == "none" or not verify:
        assert rc == 0
    if verify and damage == "snapshot":
        assert rc == 1 and b"corrupt at byte" in err


def test_journal_info_missing_dir(tmp_path, capsysbinary):
    rc, *_ = run_both(capsysbinary, tmp_path, ["journal-info", str(tmp_path / "nope")])
    assert rc == 1


@pytest.mark.parametrize("compacted", [False, True])
def test_compact(tmp_path, capsysbinary, compacted):
    src = _durable(tmp_path / "src", compact=compacted)

    def setup(d):
        shutil.rmtree(d / "dd", ignore_errors=True)
        shutil.copytree(src, d / "dd")

    rc, _, out, _, _ = run_both(capsysbinary, tmp_path,
                                ["compact", "{dir}/dd"], setup=setup)
    assert rc == 0 and json.loads(out)["compacted"] is True
    dd = PA.AutoDoc.open(str(tmp_path / "port" / "dd"), device="cpu")
    assert dd.hydrate()["k2"] == "x" * 20
    dd.close()


def test_compact_missing_dir(tmp_path, capsysbinary):
    rc, *_ = run_both(capsysbinary, tmp_path, ["compact", "{dir}/aplha"])
    assert rc == 1 and not (tmp_path / "port" / "aplha").exists()


_SECONDS = re.compile(rb'(_bucket\{le=")[^"]*("\})|(_sum )\S+')


def _mask_seconds(res):
    """Histogram sums and bucket edges are seconds: equal only in shape."""
    rc, exc, out, err, files = res
    mask = lambda b: _SECONDS.sub(lambda m: (m.group(1) or m.group(3)) + b"T"
                                  + (m.group(2) or b""), b)  # noqa: E731
    return rc, exc, mask(out), err, {k: mask(v) for k, v in files.items()}


def _mask_json_seconds(res):
    rc, exc, out, err, files = res
    body = json.loads(out)
    keep = {"counters": body["counters"],
            "timings": sorted(body["timings"]),
            "metrics": sorted(json.dumps(m.get("name")) for m in body["metrics"])}
    return rc, exc, json.dumps(keep).encode(), err, files


@pytest.mark.parametrize("source", ["none", "file", "durable", "damaged"])
def test_metrics_prometheus(tmp_path, capsysbinary, doc_file, source):
    arg = {"none": [], "file": [str(doc_file)],
           "durable": [str(_durable(tmp_path / "src"))],
           "damaged": [str(_damaged(tmp_path))]}[source]
    res = run_both(capsysbinary, tmp_path, ["metrics", *arg], norm=_mask_seconds,
                   setup=lambda d: (RO.reset_all(), PO.reset_all()))
    assert res[0] == 0


def test_metrics_json_and_trace(tmp_path, capsysbinary, doc_file):
    res = run_both(capsysbinary, tmp_path,
                   ["metrics", str(doc_file), "--format", "json"],
                   norm=_mask_json_seconds,
                   setup=lambda d: (RO.reset_all(), PO.reset_all()))
    assert res[0] == 0
    for kind in ("ref", "port"):
        (RO if kind == "ref" else PO).reset_all()
        trace = tmp_path / f"{kind}.trace.json"
        assert MAIN[kind](["metrics", str(doc_file), "-o", str(tmp_path / "x.prom"),
                           "--trace-out", str(trace)]) == 0
    names = {k: sorted(e["name"] for e in json.loads(
        (tmp_path / f"{k}.trace.json").read_text())["traceEvents"] if e.get("ph") == "X")
        for k in ("ref", "port")}
    assert names["port"] == names["ref"] and "load" in names["port"]


# -- flight dumps and perf reports -------------------------------------------------


def _flight_dumps(root):
    """Two processes' flight dumps, one with a profiled drain cycle: the
    port's recorder after a cross-document launch on the CPU, and a
    simulated second process with its own clock origin."""
    from automerge_tpu_torch import workload as W
    from automerge_tpu_torch.obs import prof
    from automerge_tpu_torch.obs.flight import FlightRecorder
    from automerge_tpu_torch.obs.metrics import MetricsRegistry
    from automerge_tpu_torch.obs.spans import SpanRecord, SpanRecorder
    from automerge_tpu_torch.ops.batched import apply_cross_doc
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    root.mkdir()
    base, deltas, _ = W.serve_workload(2, 1, 3, 20)
    docs = [DeviceDoc.merge([base], device="cpu") for _ in range(2)]
    with prof.cycle(kind="t"):
        apply_cross_doc([(d, [[deltas[i][0]]]) for i, d in enumerate(docs)],
                        device="cpu")
    first = PO.flight.dump(str(root / "flight-a-1.json"))
    srec = SpanRecorder(8)
    srec.record(SpanRecord("two", 12, 11, 0.0, 0.05, 1, {}, "ok"))
    rec = FlightRecorder(srec, MetricsRegistry(), capacity=8)
    rec.node_id = "b"
    second = str(root / "flight-b-2.json")
    rec.dump(second, reason="test")
    d = json.loads(Path(second).read_text())
    d["origin_wall"] = d.get("origin_wall", 0.0) + 5.0
    Path(second).write_text(json.dumps(d))
    return root, first


def test_flight_merge(tmp_path, capsysbinary):
    dumps, first = _flight_dumps(tmp_path / "dumps")
    rc, _, _, err, files = run_both(capsysbinary, tmp_path,
                                    ["flight-merge", str(dumps), "-o", "{dir}/merged.json"])
    assert rc == 0 and b"2 processes" in err
    rc, *_ = run_both(capsysbinary, tmp_path, ["flight-merge", first])
    assert rc == 0
    rc, *_ = run_both(capsysbinary, tmp_path, ["flight-merge", str(tmp_path / "none")])
    assert rc == 1
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    rc, *_ = run_both(capsysbinary, tmp_path, ["flight-merge", str(bad)])
    assert rc == 1


@pytest.mark.parametrize("fmt", [[], ["--format", "json"], ["--top", "1"]])
def test_perf_report_from_dumps(tmp_path, capsysbinary, fmt):
    dumps, first = _flight_dumps(tmp_path / "dumps")
    rc, _, out, _, _ = run_both(capsysbinary, tmp_path, ["perf-report", str(dumps), *fmt])
    assert rc == 0 and out
    rc, *_ = run_both(capsysbinary, tmp_path, ["perf-report"])
    assert rc == 1
    rc, *_ = run_both(capsysbinary, tmp_path,
                      ["perf-report", str(dumps / "flight-b-2.json")])
    assert rc == 1
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    rc, *_ = run_both(capsysbinary, tmp_path, ["perf-report", str(bad)])
    assert rc == 1


# -- commands that scrape a server ---------------------------------------------


class CannedServer:
    """A line-JSON server answering each method with one canned result
    (or error), so both packages' scrapers read the same answer."""

    def __init__(self, answers):
        self.answers = answers
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.sock.settimeout(0.05)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while not self.stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            conn.settimeout(TIMEOUT)
            with conn:
                req = json.loads(conn.makefile("r").readline())
                ans = self.answers[req["method"]]
                key = "error" if isinstance(ans, str) else "result"
                conn.sendall((json.dumps({"id": req["id"], key: ans}) + "\n").encode())

    def close(self):
        self.stop.set()
        self.thread.join(TIMEOUT)
        assert not self.thread.is_alive()
        self.sock.close()


def _rpc(addr, method, **params):
    with socket.create_connection(addr, timeout=TIMEOUT) as s:
        s.sendall((json.dumps({"id": 1, "method": method, "params": params})
                   + "\n").encode())
        return json.loads(s.makefile("r").readline())


@pytest.fixture
def live_answers(tmp_path):
    """Real answers of the port's cluster tier on the CPU: a router over a
    leader and a follower, a write through it, then each scraped method's
    result, and the port's CLI scraping the live router and node."""
    from automerge_tpu_torch.cluster import ClusterNode, ClusterRouter

    fol = ClusterNode(node_id="f", host="127.0.0.1", port=0, role="follower",
                      durable_dir=str(tmp_path / "f"), device="cpu")
    fol.start()
    led = ClusterNode(node_id="l", host="127.0.0.1", port=0, role="leader",
                      durable_dir=str(tmp_path / "l"), device="cpu",
                      replicate_to=["%s:%d" % fol.address], ack_replicas=1)
    led.start()
    rtr = ClusterRouter([["%s:%d" % led.address, "%s:%d" % fol.address]],
                        heartbeat=5.0)
    rtr.start()
    try:
        d = _rpc(rtr.address, "openDurable", name="cli")["result"]["doc"]
        _rpc(rtr.address, "put", doc=d, obj="_root", prop="k", value=1)
        _rpc(rtr.address, "commit", doc=d)
        answers = {
            "clusterMetrics": _rpc(rtr.address, "clusterMetrics")["result"],
            "clusterAdvise": _rpc(rtr.address, "clusterAdvise", snapshot=True)["result"],
            "historyStatus": _rpc(led.address, "historyStatus")["result"],
            "perfStatus": _rpc(led.address, "perfStatus", top=8)["result"],
        }
        raddr, laddr = "%s:%d" % rtr.address, "%s:%d" % led.address
        for argv in (["cluster-metrics", raddr], ["cluster-top", raddr],
                     ["cluster-history", laddr], ["perf-report", "--connect", laddr]):
            assert PCLI.main(argv + ["-o", str(tmp_path / "live.out")]) == 0, argv
            assert (tmp_path / "live.out").stat().st_size > 0
        yield answers
    finally:
        rtr.stop()
        led.stop()
        fol.stop()


SCRAPES = [
    ["cluster-metrics", "{addr}"],
    ["cluster-metrics", "{addr}", "--format", "json"],
    ["cluster-history", "{addr}"],
    ["cluster-history", "{addr}", "--format", "json", "--metric", "rpc.request"],
    ["cluster-history", "{addr}", "--tier", "0", "--last", "2"],
    ["cluster-top", "{addr}"],
    ["cluster-top", "{addr}", "--format", "json", "--snapshot"],
    ["cluster-top", "{addr}", "--top", "1"],
    ["perf-report", "--connect", "{addr}"],
    ["perf-report", "--connect", "{addr}", "--format", "json", "--top", "2"],
]


def test_scrapes_read_the_same_answers(tmp_path, capsysbinary, live_answers):
    srv = CannedServer(live_answers)
    try:
        for argv in SCRAPES:
            rc, _, out, _, _ = run_both(
                capsysbinary, tmp_path, [a.replace("{addr}", srv.addr) for a in argv])
            assert rc == 0 and out, argv
    finally:
        srv.close()


def test_scrapes_of_an_erring_or_absent_server(tmp_path, capsysbinary):
    srv = CannedServer({m: "no such method" for m in
                        ("clusterMetrics", "historyStatus", "clusterAdvise", "perfStatus")})
    try:
        for argv in SCRAPES[::3]:
            rc, _, _, err, _ = run_both(
                capsysbinary, tmp_path, [a.replace("{addr}", srv.addr) for a in argv])
            assert rc == 1 and b"no such method" in err
    finally:
        srv.close()
    gone = socket.create_server(("127.0.0.1", 0))
    addr = "127.0.0.1:%d" % gone.getsockname()[1]
    gone.close()
    for argv in SCRAPES[::3]:
        rc, *_ = run_both(capsysbinary, tmp_path, [a.replace("{addr}", addr) for a in argv])
        assert rc == 1


# -- serve and cluster-router as subprocesses -------------------------------------


def _spawn(args, ready):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env=env,
                            text=True, stdin=subprocess.DEVNULL,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    lines = []
    for line in proc.stderr:
        lines.append(line)
        if line.startswith(ready):
            threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True).start()
            return proc, ast.literal_eval(line[len(ready):].strip())
    proc.wait(TIMEOUT)
    raise AssertionError(f"no {ready!r} line: " + "".join(lines)[-2000:])


def _stop(proc, addr):
    try:
        _rpc(addr, "shutdown")
        assert proc.wait(TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(TIMEOUT)


@pytest.mark.skipif(os.name != "posix", reason="subprocess test")
def test_serve_answers_a_request(tmp_path):
    """``serve`` in both packages, the port's with ``--device cpu``: one
    request each, the same answer."""
    answers = {}
    for kind, prefix in (("ref", ["automerge_tpu"]),
                         ("port", ["automerge_tpu_torch", "--device", "cpu"])):
        proc, addr = _spawn([*prefix, "serve", "--socket", "127.0.0.1:0",
                             "--durable", str(tmp_path / kind), "--workers", "2"],
                            "serving on ")
        try:
            answers[kind] = _rpc(addr, "openDurable", name="served")
        finally:
            _stop(proc, addr)
    assert answers["port"] == answers["ref"] and "error" not in answers["port"]


@pytest.mark.skipif(os.name != "posix", reason="subprocess test")
def test_cluster_router_answers_a_request(tmp_path):
    """``cluster-router`` in both packages in front of one of their own
    cluster nodes: one routed request each, the same answer."""
    import automerge_tpu.cluster as RCl
    import automerge_tpu_torch.cluster as PCl

    answers = {}
    for kind, pkg, prefix in (("ref", RCl, ["automerge_tpu"]),
                              ("port", PCl, ["automerge_tpu_torch"])):
        kw = {} if kind == "ref" else {"device": "cpu"}
        node = pkg.ClusterNode(node_id="n", host="127.0.0.1", port=0,
                               durable_dir=str(tmp_path / kind), **kw)
        node.start()
        try:
            proc, addr = _spawn([*prefix, "cluster-router", "--listen", "127.0.0.1:0",
                                 "--group", "%s:%d" % node.address,
                                 "--heartbeat", "5", "--miss-limit", "3"],
                                "routing on ")
            try:
                answers[kind] = _rpc(addr, "openDurable", name="routed")
            finally:
                _stop(proc, addr)
        finally:
            node.stop()
    assert answers["port"] == answers["ref"] and "error" not in answers["port"]


def test_serve_without_an_address(tmp_path, capsysbinary):
    rc, _, _, err, _ = run_both(capsysbinary, tmp_path, ["serve"])
    assert rc == 1 and b"provide --socket" in err


# -- the device ---------------------------------------------------------------------


@pytest.mark.skipif(os.name != "posix", reason="subprocess test")
def test_module_invocation(doc_file):
    """``python -m automerge_tpu_torch --device cpu export`` prints what
    ``python -m automerge_tpu export`` prints; without ``--device`` and
    without a GPU it exits 1 with the port's no-GPU message."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = {}
    for kind, prefix in (("ref", ["automerge_tpu"]),
                         ("port", ["automerge_tpu_torch", "--device", "cpu"])):
        r = subprocess.run([sys.executable, "-m", *prefix, "export", str(doc_file),
                            "-o", "-"], cwd=REPO, env=env, capture_output=True,
                           timeout=TIMEOUT)
        assert r.returncode == 0, r.stderr
        out[kind] = r.stdout
    assert out["port"] == out["ref"]
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "-m", "automerge_tpu_torch", "export",
                            str(doc_file)], cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=TIMEOUT)
        assert r.returncode == 1 and "device='cpu'" in r.stderr and not r.stdout


DOCUMENT_COMMANDS = [
    ["export", "{doc}"], ["import", "{json}"], ["merge", "{doc}"], ["examine", "{doc}"],
    ["change", "set .a 1"], ["compact", "{dur}"], ["metrics", "{doc}"],
]


@pytest.mark.parametrize("argv", DOCUMENT_COMMANDS, ids=lambda a: a[0])
def test_document_commands_take_the_card_by_default(argv, doc_file, tmp_path,
                                                    monkeypatch, capsys):
    """Left out, ``--device`` is the card: without a GPU a command that
    builds a document exits 1 with the no-GPU message and writes nothing."""
    (tmp_path / "in.json").write_text('{"a": 1}')
    dur = _durable(tmp_path / "dur")
    before = sorted(p.name for p in dur.iterdir())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a.format(doc=doc_file, json=tmp_path / "in.json", dur=dur) for a in argv]
    assert PCLI.main([*args, "-o", str(tmp_path / "out")]) == 1
    err = capsys.readouterr()
    assert "device='cpu'" in err.err and not err.out
    assert not (tmp_path / "out").exists()
    assert sorted(p.name for p in dur.iterdir()) == before


def test_serve_takes_the_card_by_default(monkeypatch, tmp_path):
    """``serve`` passes ``--device`` on to ``rpc.main``: left out, the
    server takes the card and refuses without one."""
    from automerge_tpu_torch import rpc

    seen = []
    monkeypatch.setattr(rpc, "main", lambda argv: seen.append(argv) or 0)
    assert PCLI.main(["--device", "cpu", "serve", "--socket", "127.0.0.1:0"]) == 0
    assert PCLI.main(["serve", "--unix", str(tmp_path / "s")]) == 0
    assert seen == [["--socket", "127.0.0.1:0", "--device", "cpu"],
                    ["--unix", str(tmp_path / "s")]]
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PCLI.main(["serve", "--socket", "127.0.0.1:0"]) == 1


def test_commands_without_a_document_take_no_device(tmp_path, monkeypatch, capsys):
    """``journal-info``, ``examine-sync``, ``flight-merge`` and
    ``perf-report`` run without a GPU and without ``--device``."""
    from automerge_tpu.sync import SyncState

    dur = _durable(tmp_path / "dur")
    msg = tmp_path / "m.sync"
    msg.write_bytes(sample_doc(RA).generate_sync_message(SyncState()).encode())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PCLI.main(["journal-info", str(dur), "--verify"]) == 0
    assert PCLI.main(["examine-sync", str(msg)]) == 0
    assert PCLI.main(["flight-merge", str(tmp_path / "none")]) == 1
    assert PCLI.main(["perf-report"]) == 1
    assert "device='cpu'" not in capsys.readouterr().err


def test_every_subcommand_of_the_reference():
    def commands(parser):
        sub = next(a for a in parser._actions if a.dest == "cmd")
        return {name: sorted(o for a in p._actions for o in a.option_strings)
                for name, p in sub.choices.items()}

    assert commands(PCLI.build_parser()) == commands(RCLI.build_parser())
    assert PCLI.build_parser().prog == "automerge_tpu_torch"
