"""The port's observability layer (``automerge_tpu_torch/obs/``,
``automerge_tpu_torch/trace.py``) on the CPU.

The first part is the reference's own cases (``tests/test_obs.py``,
``test_flight.py``, ``test_heat.py``, ``test_history.py``,
``test_prof.py``) on the port's modules, less those that need the RPC
server, the CLI, the serving layer or durable storage (not ported yet),
and less the reference's overhead bound (a wall-clock threshold). The
cycle profiler's cases run on an injected clock instead of spinning, so
they assert exact sums and no wall-clock bound.

The second part holds the port against the JAX package: the same
instruments fed the same values render the same Prometheus text byte for
byte, and four seeded flows (a fan-in merge, a served ``apply_batches``
drain, an ``apply_cross_doc`` drain, a faulty ``SyncSession`` exchange)
run through both packages on the CPU record the same span names and
counter families with the same labels, and equal values for the counts
that depend only on the data. The differences made on purpose are listed
in ``BY_DESIGN`` with their reasons. Each test starts from
``obs.reset_all()`` in both packages.
"""

import json
import logging
import math
import os
import threading

import numpy as np
import pytest

import automerge_tpu.obs as RO
from automerge_tpu.ops import batched as JB
from automerge_tpu.ops import extract as JX
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu_torch import obs, trace
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.obs import heat, prof
from automerge_tpu_torch.obs.flight import FlightRecorder, merge_flights
from automerge_tpu_torch.obs.heat import HeatTable
from automerge_tpu_torch.obs.history import TIERS, HistoryRing
from automerge_tpu_torch.obs.metrics import (
    FACTOR,
    MetricsRegistry,
    parse_prometheus,
)
from automerge_tpu_torch.obs.spans import SpanRecord, SpanRecorder
from automerge_tpu_torch.ops import batched as PB
from automerge_tpu_torch.ops.device_doc import DeviceDoc

CPU = "cpu"


@pytest.fixture(autouse=True)
def fresh_obs(monkeypatch):
    """Both packages' registries, legacy views and span rings empty, the
    port's cycle profiler and flight rings too, and the JAX package's
    per-change-hash extraction cache cold (ROADMAP §3)."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)
    for o in (obs, RO):
        o.reset_all()
    obs.flight.events.clear()
    obs.flight.deltas.clear()
    prof.profiler.reset()
    heat.reset()
    yield
    prof.profiler.reset()


class Clock:
    """An injected ``perf_counter``: ``spin(s)`` moves it by ``s``."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def spin(self, s):
        self.t += s


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(obs, "_perf_counter", c)
    monkeypatch.setattr(prof, "perf_counter", c)
    return c


# -- metrics, spans, events, shims (tests/test_obs.py)-----------


def test_histogram_bucket_boundaries():
    reg = MetricsRegistry()
    h = reg.histogram("x")
    # 1.0 sits exactly on the upper bound of bucket 0 -> (FACTOR^-1, 1.0]
    h.observe(1.0)
    cum = h.cumulative_buckets()
    assert cum == [(1.0, 1)]
    # nudging past the boundary moves to the next bucket, le == FACTOR
    h.observe(1.0 + 1e-9)
    cum = dict(h.cumulative_buckets())
    assert cum[1.0] == 1
    assert math.isclose(max(cum), FACTOR)
    # zero and negatives take the dedicated zero bucket (le == 0.0)
    h.observe(0.0)
    h.observe(-3.0)
    assert dict(h.cumulative_buckets())[0.0] == 2
    assert h.n == 4 and h.vmin == -3.0


def test_histogram_percentiles_match_numpy():
    reg = MetricsRegistry()
    h = reg.histogram("lat")
    rng = np.random.default_rng(7)
    xs = rng.lognormal(mean=-6.0, sigma=1.5, size=4000)
    for x in xs:
        h.observe(float(x))
    for q in (0.50, 0.95, 0.99):
        est = h.percentile(q)
        exact = float(np.quantile(xs, q))
        # one log bucket is ~19% wide; that bounds the estimate error
        assert abs(est - exact) / exact < 0.2, (q, est, exact)
    # exact accumulators are untouched by bucketing
    assert h.n == len(xs)
    assert math.isclose(h.total, float(xs.sum()), rel_tol=1e-9)
    assert h.percentile(0.0) >= h.vmin and h.percentile(1.0) <= h.vmax


def test_histogram_empty_and_summary():
    reg = MetricsRegistry()
    h = reg.histogram("empty")
    assert h.percentile(0.5) == 0.0
    s = h.summary()
    assert s["count"] == 0 and s["sum"] == 0.0
    h.observe(2.0)
    s = h.summary()
    assert s["count"] == 1 and s["p50"] == 2.0  # clamped to min==max


def test_label_cardinality_cap():
    reg = MetricsRegistry(max_label_sets=4)
    for i in range(20):
        reg.counter("req", peer=f"p{i}").inc()
    fam = reg._families[("req", "counter")]
    # 4 real children + the overflow catch-all
    assert len(fam.children) == 5
    overflow = reg.counter("req", overflow="true")
    assert overflow.value == 16
    total = sum(c.value for c in fam.children.values())
    assert total == 20  # no increment is lost, only its label detail


def test_same_name_counter_and_histogram_coexist():
    reg = MetricsRegistry()
    reg.counter("device.delta_resolve").inc()
    reg.histogram("device.delta_resolve").observe(0.5)
    text = reg.render_prometheus()
    parsed = parse_prometheus(text)
    assert parsed[("device_delta_resolve_total", ())] == 1.0
    assert parsed[("device_delta_resolve_count", ())] == 1.0


def test_concurrent_increments_are_exact():
    obs.reset_all()
    n_threads, n_incs = 8, 2500

    def worker(k):
        for i in range(n_incs):
            trace.count("stress.total")  # the shim path (the old race)
            obs.count("stress.labeled", labels={"t": str(k)})
            with obs.span("stress.span"):
                pass

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    want = n_threads * n_incs
    assert trace.counters["stress.total"] == want
    assert trace.counters["stress.labeled"] == want
    per_label = [
        obs.registry.counter("stress.labeled", t=str(k)).value
        for k in range(n_threads)
    ]
    assert per_label == [n_incs] * n_threads
    assert trace.timings["stress.span"][1] == want
    assert obs.registry.histogram("stress.span").n == want


def test_prometheus_render_round_trip():
    reg = MetricsRegistry()
    reg.counter("sync.retry").inc(3)
    reg.counter("sync.reset", source="peer").inc()
    reg.gauge("journal.bytes", path="/tmp/x").set(1234.5)
    # hostile label values: spaces, '=', quotes, backslash, newline
    reg.counter("rpc.errors", type='Bad "quote"=x\\y\nz').inc(2)
    h = reg.histogram("rpc.request", method="put")
    for v in (0.001, 0.002, 0.004, 5.0):
        h.observe(v)
    text = reg.render_prometheus()
    parsed = parse_prometheus(text)
    assert parsed[("sync_retry_total", ())] == 3.0
    assert parsed[("sync_reset_total", (("source", "peer"),))] == 1.0
    assert parsed[("journal_bytes", (("path", "/tmp/x"),))] == 1234.5
    assert parsed[
        ("rpc_errors_total", (("type", 'Bad "quote"=x\\y\nz'),))
    ] == 2.0
    assert parsed[("rpc_request_count", (("method", "put"),))] == 4.0
    assert math.isclose(
        parsed[("rpc_request_sum", (("method", "put"),))], 5.007
    )
    # cumulative bucket series: the +Inf bucket equals the count, and
    # cumulative counts are monotone over increasing le
    buckets = sorted(
        (math.inf if dict(k[1])["le"] == "+Inf" else float(dict(k[1])["le"]), v)
        for k, v in parsed.items()
        if k[0] == "rpc_request_bucket"
    )
    counts = [v for _, v in buckets]
    assert counts == sorted(counts) and counts[-1] == 4.0
    # TYPE lines are present and well-formed
    assert "# TYPE sync_retry_total counter" in text
    assert "# TYPE rpc_request histogram" in text
    assert "# TYPE journal_bytes gauge" in text


def test_prometheus_name_sanitization():
    reg = MetricsRegistry()
    reg.counter("load.salvaged-chunks").inc()
    parsed = parse_prometheus(reg.render_prometheus())
    assert parsed[("load_salvaged_chunks_total", ())] == 1.0


def test_span_nesting_and_export(tmp_path):
    obs.reset_all()
    with obs.span("outer", kind="test"):
        with obs.span("middle"):
            with obs.span("leaf", rows=7):
                pass
        with obs.span("middle2"):
            pass
    path = str(tmp_path / "trace.json")
    n = obs.export_trace(path)
    assert n == 4
    doc = json.load(open(path))
    events = doc["traceEvents"]
    assert isinstance(events, list) and len(events) == 4
    by_name = {e["name"]: e for e in events}
    for e in events:  # chrome-trace schema
        assert e["ph"] == "X"
        for key in ("name", "cat", "ts", "dur", "pid", "tid", "args"):
            assert key in e, (key, e)
    outer, middle, leaf = by_name["outer"], by_name["middle"], by_name["leaf"]
    assert "parent_id" not in outer["args"]
    assert middle["args"]["parent_id"] == outer["args"]["span_id"]
    assert leaf["args"]["parent_id"] == middle["args"]["span_id"]
    assert by_name["middle2"]["args"]["parent_id"] == outer["args"]["span_id"]
    # time containment (what makes Perfetto render the flame chart)
    for child, parent in ((middle, outer), (leaf, middle)):
        assert child["ts"] >= parent["ts"]
        assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1e-3
    assert outer["args"]["kind"] == "test" and leaf["args"]["rows"] == 7


def test_span_ring_buffer_is_bounded():
    rec = obs.SpanRecorder(capacity=16)
    for i in range(100):
        rec.record(obs.SpanRecord(f"s{i}", i, None, 0.0, 0.1, 1, {}, "ok"))
    assert len(rec) == 16
    assert rec.snapshot()[0].name == "s84"  # oldest evicted


def test_span_error_status():
    obs.reset_all()
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("x")
    rec = obs.recorder.snapshot()[-1]
    assert rec.name == "boom" and rec.status == "error"
    assert trace.timings["boom"][1] == 1  # timing still accumulated


def test_event_quotes_hostile_values():
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    h = Capture()
    obs.logger.addHandler(h)
    old = obs.logger.level
    obs.logger.setLevel(logging.DEBUG)
    try:
        obs.event("sync.malformed", error='bad frame: got "x" a=1 b\\c',
                  n=3, ok="plain")
    finally:
        obs.logger.removeHandler(h)
        obs.logger.setLevel(old)
    (line,) = records
    name, _, body = line.partition(" ")
    assert name == "sync.malformed"
    fields = obs.parse_event_fields(body)
    assert fields["error"] == 'bad frame: got "x" a=1 b\\c'
    assert fields["n"] == "3" and fields["ok"] == "plain"
    # literal backslash-n must round-trip as backslash+n, not newline
    # (sequential-replace unescaping gets this wrong)
    for hostile in ("path\\nfile", "C:\\new\\table", 'x\\"y', "a\nb\\n"):
        enc = obs._fmt_field(hostile)
        assert obs.parse_event_fields(f"v={enc}")["v"] == hostile, hostile
    # unquoted simple values stay bare (grep-ably identical to before)
    assert "ok=plain" in body and 'n=3' in body


def test_trace_shims_feed_legacy_views():
    trace.reset_counters()
    trace.reset_timers()
    trace.count("compat.hits")
    trace.count("compat.hits", n=4)
    assert trace.counters["compat.hits"] == 5
    with trace.time("compat.phase", rows=3):
        pass
    with trace.span("compat.phase"):
        pass
    summary = trace.timing_summary()
    assert summary["compat.phase"]["n"] == 2
    assert summary["compat.phase"]["s"] >= 0.0
    trace.reset_timers()
    assert trace.timing_summary() == {}
    trace.reset_counters()
    assert trace.counters == {}
    # the shim shares the obs registry: labels visible in Prometheus
    obs.count("compat.labeled", labels={"kind": "a"})
    assert ("compat_labeled_total", (("kind", "a"),)) in parse_prometheus(
        obs.render_prometheus()
    )


def test_trace_dicts_alias_obs_objects():
    # bench.py stashes/clears/updates trace.timings in place; that only
    # works if the module-level names alias the live obs dicts
    assert trace.counters is obs.legacy_counters
    assert trace.timings is obs.legacy_timings


def _spans_named(name):
    return [r for r in obs.recorder.snapshot() if r.name == name]


def test_trace_scope_propagates_into_spans():
    obs.reset_all()
    with obs.trace_scope("trace-abc", 4242):
        with obs.span("ts.outer") as sp:
            assert obs.current_trace_context() == ("trace-abc", sp.span_id)
            with obs.span("ts.inner"):
                pass
    outer, inner = _spans_named("ts.outer")[0], _spans_named("ts.inner")[0]
    # the remote parent heads the local chain; the trace id rides every span
    assert outer.parent_id == 4242 and outer.trace_id == "trace-abc"
    assert inner.parent_id == outer.span_id and inner.trace_id == "trace-abc"
    # outside the scope: no trace, no context
    assert obs.current_trace_context() is None
    with obs.span("ts.bare"):
        pass
    assert _spans_named("ts.bare")[0].trace_id is None


def test_trace_scope_rejects_hostile_input():
    obs.reset_all()
    for tid, sid in (({"x": 1}, "nope"), ("", 1), ("t" * 500, 1),
                     (None, None), (7, True)):
        with obs.trace_scope(tid, sid):
            with obs.span("ts.hostile"):
                pass
    assert all(r.trace_id is None for r in _spans_named("ts.hostile"))
    # sane id + junk parent: trace id still propagates, parent is local
    with obs.trace_scope("ok", "junk"):
        with obs.span("ts.half"):
            pass
    r = _spans_named("ts.half")[0]
    assert r.trace_id == "ok" and r.parent_id is None


def test_span_links_recorded_and_exported(tmp_path):
    obs.reset_all()
    with obs.span("lk.covered", links=[("tr1", 11), ("tr2", None)]):
        pass
    r = _spans_named("lk.covered")[0]
    assert r.links == (("tr1", 11), ("tr2", None))
    path = str(tmp_path / "links.json")
    obs.export_trace(path)
    ev = [e for e in json.load(open(path))["traceEvents"]
          if e["name"] == "lk.covered"][0]
    assert ev["args"]["links"] == [["tr1", 11], ["tr2", None]]


def test_decode_wire_traces_sanitizes():
    good = [["t1", 5], ["t2", None]]
    assert obs.decode_wire_traces(good) == [("t1", 5), ("t2", None)]
    hostile = [["t", "x"], "junk", [1, 2], ["", 3], ["ok", True],
               ["a" * 500, 1], ["fine", 9]]
    assert obs.decode_wire_traces(hostile) == [("fine", 9)]
    assert obs.decode_wire_traces("notalist") == []
    assert obs.decode_wire_traces([["t", 1]] * 100, limit=4) == [("t", 1)] * 4


def test_spans_dropped_counter_on_ring_wrap(monkeypatch):
    obs.reset_all()
    small = obs.SpanRecorder(capacity=8)
    monkeypatch.setattr(obs, "recorder", small)
    for _ in range(20):
        with obs.span("wrap.me"):
            pass
    parsed = parse_prometheus(obs.render_prometheus())
    assert parsed[("obs_spans_dropped_total", ())] == 12.0


def test_merge_prometheus_multi_node_families():
    from automerge_tpu_torch.obs.metrics import MetricsRegistry, merge_prometheus

    a, b = MetricsRegistry(), MetricsRegistry()
    # conflicting label SETS on one family name across nodes
    a.counter("rpc.errors", method="put").inc(2)
    b.counter("rpc.errors", type="transport", peer="x").inc(5)
    b.gauge("cluster.replication_lag", doc="d1").set(3)
    merged = merge_prometheus({"n1": a.render_prometheus(),
                               "n2": b.render_prometheus()})
    parsed = parse_prometheus(merged)  # lossless: re-parses cleanly
    assert parsed[("rpc_errors_total",
                   (("method", "put"), ("node", "n1")))] == 2.0
    assert parsed[("rpc_errors_total",
                   (("node", "n2"), ("peer", "x"),
                    ("type", "transport")))] == 5.0
    assert parsed[("cluster_replication_lag",
                   (("doc", "d1"), ("node", "n2")))] == 3.0
    # ONE merged family set: a single TYPE line per family
    assert merged.count("# TYPE rpc_errors_total counter") == 1


def test_merge_prometheus_histogram_bucket_union():
    from automerge_tpu_torch.obs.metrics import MetricsRegistry, merge_prometheus

    a, b = MetricsRegistry(), MetricsRegistry()
    a.histogram("lat").observe(0.001)   # hits a tiny bucket
    b.histogram("lat").observe(100.0)   # hits a huge bucket
    b.histogram("lat").observe(200.0)
    merged = merge_prometheus({"a": a.render_prometheus(),
                               "b": b.render_prometheus()})
    assert merged.count("# TYPE lat histogram") == 1
    parsed = parse_prometheus(merged)
    # each node's sparse buckets survive under its node label…
    a_buckets = [k for k in parsed
                 if k[0] == "lat_bucket" and ("node", "a") in k[1]]
    b_buckets = [k for k in parsed
                 if k[0] == "lat_bucket" and ("node", "b") in k[1]]
    assert a_buckets and b_buckets
    # …with per-node counts intact
    assert parsed[("lat_count", (("node", "a"),))] == 1.0
    assert parsed[("lat_count", (("node", "b"),))] == 2.0
    # and the +Inf bound survives both parse and merge
    assert any(("le", "+Inf") in k[1] for k in a_buckets)


def test_merge_prometheus_hostile_node_labels():
    from automerge_tpu_torch.obs.metrics import MetricsRegistry, merge_prometheus

    r = MetricsRegistry()
    r.counter("c").inc()
    evil = 'node"with\\quotes\nand newlines'
    merged = merge_prometheus({evil: r.render_prometheus()})
    parsed = parse_prometheus(merged)
    assert parsed[("c_total", (("node", evil),))] == 1.0
    # a pre-existing node label is replaced by the scraper's identity
    r2 = MetricsRegistry()
    r2.counter("c", node="liar").inc(9)
    merged = merge_prometheus({"true-node": r2.render_prometheus()})
    parsed = parse_prometheus(merged)
    assert parsed[("c_total", (("node", "true-node"),))] == 9.0


def test_parse_prometheus_zero_sample_family():
    from automerge_tpu_torch.obs.metrics import merge_prometheus

    text = "# HELP lonely no samples yet\n# TYPE lonely counter\n"
    assert parse_prometheus(text) == {}
    # a zero-sample family merges away without crashing the scrape
    merged = merge_prometheus({"n1": text})
    assert parse_prometheus(merged) == {}


def test_nonfinite_gauges_render_parse_and_merge():
    from automerge_tpu_torch.obs.metrics import merge_prometheus

    reg = MetricsRegistry()
    reg.gauge("g", k="nan").set(float("nan"))
    reg.gauge("g", k="pinf").set(float("inf"))
    reg.gauge("g", k="ninf").set(float("-inf"))
    reg.gauge("g", k="fin").set(1.5)
    text = reg.render_prometheus()
    # the Prometheus exposition spellings, not Python's repr
    assert 'g{k="pinf"} +Inf' in text
    assert 'g{k="ninf"} -Inf' in text
    assert 'g{k="nan"} NaN' in text
    parsed = parse_prometheus(text)
    assert parsed[("g", (("k", "pinf"),))] == math.inf
    assert parsed[("g", (("k", "ninf"),))] == -math.inf
    assert math.isnan(parsed[("g", (("k", "nan"),))])
    assert parsed[("g", (("k", "fin"),))] == 1.5
    # and the multi-node merge keeps them intact under the node label
    merged = merge_prometheus({"a": text})
    parsed = parse_prometheus(merged)
    assert parsed[("g", (("k", "pinf"), ("node", "a")))] == math.inf
    assert math.isnan(parsed[("g", (("k", "nan"), ("node", "a")))])


def test_merged_histogram_buckets_stay_cumulative_monotone():
    from automerge_tpu_torch.obs.metrics import merge_prometheus

    a, b = MetricsRegistry(), MetricsRegistry()
    for v in (0.0005, 0.002, 0.9):
        a.histogram("lat").observe(v)
    for v in (40.0, 150.0, 151.0, 0.001):
        b.histogram("lat").observe(v)
    merged = merge_prometheus({"a": a.render_prometheus(),
                               "b": b.render_prometheus()})
    parsed = parse_prometheus(merged)
    for node, n_obs in (("a", 3), ("b", 4)):
        rows = []
        for (name, labels), v in parsed.items():
            if name != "lat_bucket" or ("node", node) not in labels:
                continue
            le = dict(labels)["le"]
            rows.append((math.inf if le == "+Inf" else float(le), v))
        rows.sort()
        assert rows, f"no buckets for node {node}"
        # cumulative-monotone: counts never decrease with the bound
        counts = [v for _, v in rows]
        assert counts == sorted(counts)
        # the +Inf bucket equals the series count exactly
        assert rows[-1][0] == math.inf
        assert rows[-1][1] == float(n_obs)
        assert parsed[("lat_count", (("node", node),))] == float(n_obs)


# -- flight recorder (tests/test_flight.py)


def test_flight_dump_contents(tmp_path):
    obs.reset_all()
    obs.flight.events.clear()
    obs.flight.deltas.clear()
    with obs.span("fl.work", rows=3):
        obs.count("fl.counter", n=2, labels={"k": "v"})
        obs.gauge_set("fl.gauge", 7.5)
        obs.event("fl.event", what="happened")
    rec = FlightRecorder(obs.recorder, obs.registry)
    rec.install(str(tmp_path), "node-1")
    path = rec.dump(reason="test")
    assert os.path.basename(path).startswith("flight-node-1-")
    d = json.load(open(path))
    assert d["format"] == "automerge_tpu-flight-v1"
    assert d["node_id"] == "node-1" and d["reason"] == "test"
    assert d["origin_wall"] > 0
    assert any(s["name"] == "fl.work" and s["fields"] == {"rows": 3}
               for s in d["spans"])
    # events and metric deltas landed in the GLOBAL flight rings (the
    # obs entry points feed obs.flight, not this scratch recorder)
    gpath = tmp_path / "global.json"
    obs.flight.dump(str(gpath), reason="test")
    g = json.load(open(gpath))
    assert any(e["name"] == "fl.event" and e["fields"] == {"what": "happened"}
               for e in g["events"])
    deltas = {(e["kind"], e["name"]) for e in g["metric_deltas"]}
    assert ("count", "fl.counter") in deltas
    assert ("gauge", "fl.gauge") in deltas
    assert any(m["name"] == "fl.counter" for m in g["metrics"])
    # a second dump gets a fresh sequence number, never overwrites
    assert rec.dump(reason="again") != path


def test_flight_rings_are_bounded():
    rec = FlightRecorder(SpanRecorder(4), MetricsRegistry(), capacity=8)
    for i in range(100):
        rec.note_event(f"e{i}", {"i": i})
        rec.note_delta("count", f"c{i}", None, 1)
    assert len(rec.events) == 8 and len(rec.deltas) == 8
    assert rec.events[0][1] == "e92"  # oldest evicted
    off = FlightRecorder(SpanRecorder(4), MetricsRegistry(), capacity=0)
    off.note_event("x", {})
    off.note_delta("count", "x", None, 1)
    assert len(off.events) == 0 and len(off.deltas) == 0


def _fake_process(tmp_path, node_id, spans, origin_wall, clock_sync=()):
    """Write a flight dump for a simulated process: its own span
    recorder, its own clock origin."""
    srec = SpanRecorder(64)
    for s in spans:
        srec.record(s)
    rec = FlightRecorder(srec, MetricsRegistry(), capacity=8)
    for cs in clock_sync:
        rec.note_clock_sync(*cs)
    path = str(tmp_path / f"flight-{node_id}.json")
    rec.node_id = node_id
    rec.dump(path, reason="test")
    # dumps self-report origin_wall from the shared process clock; the
    # simulated processes need distinct origins
    d = json.load(open(path))
    d["node_id"] = node_id
    d["origin_wall"] = origin_wall
    json.dump(d, open(path, "w"))
    return path


def test_merge_connects_parents_and_links_across_dumps(tmp_path):
    """The acceptance shape: one client request's spans across router,
    leader and follower processes connect by parent/link ids in a single
    merged timeline."""
    tid = "req-cross"
    # "router" process: root span of the trace
    router_span = SpanRecord("router.request", 1001, None, 0.10, 0.30,
                             1, {}, "ok", trace_id=tid)
    # "leader" process: rpc.request parented to the ROUTER's span id,
    # plus a group-commit fsync linking the trace
    leader_req = SpanRecord("rpc.request", 2001, 1001, 0.02, 0.20,
                            1, {}, "ok", trace_id=tid)
    leader_fsync = SpanRecord("journal.fsync", 2002, None, 0.10, 0.05,
                              2, {}, "ok", links=((tid, 2001),))
    # "follower" process: repl.apply linking back to the leader span
    follower_apply = SpanRecord("repl.apply", 3001, None, 0.01, 0.04,
                                1, {}, "ok", trace_id=tid,
                                links=((tid, 2001),))
    p_router = _fake_process(tmp_path, "router", [router_span], 1000.0)
    p_leader = _fake_process(
        tmp_path, "leader", [leader_req, leader_fsync], 1000.1)
    p_follower = _fake_process(
        tmp_path, "follower", [follower_apply], 1000.2)

    doc, info = merge_flights([p_router, p_leader, p_follower])
    ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    by_id = {e["args"]["span_id"]: e for e in ev}
    assert len(info["processes"]) == 3 and info["spans"] == 4

    # each process got its own pid, named
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M"}
    assert names == {"router", "leader", "follower"}

    # the parent chain crosses dumps: the leader's rpc.request names the
    # router's span as parent, and both carry the trace id
    lr = by_id[2001]
    assert lr["args"]["parent_id"] == 1001
    assert by_id[1001]["args"]["trace_id"] == tid
    assert lr["pid"] != by_id[1001]["pid"]

    # links cross dumps too: the follower's apply (and the leader's
    # group-commit fsync) both name the leader request span
    assert by_id[3001]["args"]["links"] == [[tid, 2001]]
    assert by_id[2002]["args"]["links"] == [[tid, 2001]]
    assert by_id[3001]["pid"] != lr["pid"]

    # wall-clock alignment: all three processes share one timeline, so
    # the leader's request (origin 1000.1 + 0.02) sits inside the
    # router's span (origin 1000.0 + 0.10 .. 0.40)
    assert by_id[1001]["ts"] <= lr["ts"] <= by_id[1001]["ts"] + 0.30e6


def test_merge_aligns_clocks_from_rtt_midpoints(tmp_path):
    """A follower whose self-reported wall origin is WRONG (skewed
    clock) still lands correctly: the leader's RTT samples around the
    follower's monotonic 'now' pin it to the shared timeline."""
    leader_span = SpanRecord("a", 1, None, 1.0, 0.1, 1, {}, "ok")
    follower_span = SpanRecord("b", 2, None, 4.0, 0.1, 1, {}, "ok")
    # truth: leader origin_wall=1000, follower's TRUE origin is 1005 —
    # at leader-mono 10.0 (wall 1010) the follower's mono clock reads
    # 5.0, and again at 20.0/15.0 (median of consistent samples).
    samples = [("follower", 9.9, 10.1, 5.0), ("follower", 19.9, 20.1, 15.0)]
    p_leader = _fake_process(tmp_path, "leader", [leader_span], 1000.0,
                             clock_sync=samples)
    # follower lies about its wall origin by a full minute
    p_follower = _fake_process(tmp_path, "follower", [follower_span], 1060.0)
    doc, info = merge_flights([p_leader, p_follower])
    ev = {e["args"]["span_id"]: e for e in doc["traceEvents"]
          if e.get("ph") == "X"}
    # leader span at wall 1001.0, follower span at true wall 1005+4=1009
    # -> 8s apart on the merged timeline, not 64s
    dt_us = ev[2]["ts"] - ev[1]["ts"]
    assert abs(dt_us - 8e6) < 1e3, dt_us
    assert info["processes"]["follower"]["aligned"] == "rtt"
    assert info["processes"]["leader"]["aligned"] == "wall"


def test_merge_collapses_multiple_dumps_from_one_process(tmp_path):
    """A process that dumped twice (failover + exit) with overlapping
    span rings renders each span ONCE, under one pid."""
    s1 = SpanRecord("early", 21, None, 0.0, 0.1, 1, {}, "ok")
    s2 = SpanRecord("late", 22, None, 1.0, 0.1, 1, {}, "ok")
    p_a = str(tmp_path / "flight-r-1.json")
    p_b = str(tmp_path / "flight-r-2.json")
    # failover dump holds s1; the later exit dump holds s1 AND s2
    for path, spans, mono in ((p_a, [s1], 5.0), (p_b, [s1, s2], 9.0)):
        srec = SpanRecorder(16)
        for s in spans:
            srec.record(s)
        rec = FlightRecorder(srec, MetricsRegistry(), capacity=4)
        rec.node_id = "router-7"
        rec.dump(path, reason="x")
        d = json.load(open(path))
        d["node_id"] = "router-7"
        d["dumped_at_mono"] = mono
        json.dump(d, open(path, "w"))
    doc, info = merge_flights([p_b, p_a])  # order must not matter
    ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert sorted(e["args"]["span_id"] for e in ev) == [21, 22]
    assert len({e["pid"] for e in ev}) == 1
    assert len(info["processes"]) == 1
    assert info["processes"]["router-7"]["spans"] == 2
    assert info["spans"] == 2


def test_merge_aligns_when_sampler_is_not_first_dump(tmp_path):
    """The RTT BFS roots at the dump that HOLDS samples — a sampled-only
    follower sorting first (alphabetically or by mtime) must not disable
    alignment."""
    a = SpanRecord("a", 1, None, 1.0, 0.1, 1, {}, "ok")
    b = SpanRecord("b", 2, None, 4.0, 0.1, 1, {}, "ok")
    p_fol = _fake_process(tmp_path, "a-follower", [b], 2060.0)
    p_led = _fake_process(tmp_path, "z-leader", [a], 2000.0,
                          clock_sync=[("a-follower", 9.9, 10.1, 5.0)])
    # follower first: the old first-dump root would reach nobody
    doc, info = merge_flights([p_fol, p_led])
    assert info["processes"]["a-follower"]["aligned"] == "rtt"
    ev = {e["args"]["span_id"]: e for e in doc["traceEvents"]
          if e.get("ph") == "X"}
    assert abs((ev[2]["ts"] - ev[1]["ts"]) - 8e6) < 1e3


def test_merge_rejects_non_flight_files(tmp_path):
    bad = tmp_path / "x.json"
    bad.write_text("{}")
    with pytest.raises(ValueError):
        merge_flights([str(bad)])
    with pytest.raises(ValueError):
        merge_flights([])


def test_sigusr2_dumps_flight_recording(tmp_path):
    import glob
    import signal
    import time

    rec = FlightRecorder(obs.recorder, obs.registry)
    rec.install(str(tmp_path), "sig-node")
    os.kill(os.getpid(), signal.SIGUSR2)
    # the handler runs at the next bytecode boundary of the main thread
    deadline = time.monotonic() + 5.0
    dumps = []
    while time.monotonic() < deadline:
        dumps = glob.glob(str(tmp_path / "flight-sig-node-*.json"))
        if dumps:
            break
        time.sleep(0.01)
    assert dumps, "SIGUSR2 produced no flight dump"
    d = json.load(open(dumps[0]))
    assert d["reason"] == "signal"
    assert d["node_id"] == "sig-node"


def test_dump_carries_history_rings(tmp_path):
    from automerge_tpu_torch.obs.history import HistoryRing
    from automerge_tpu_torch.obs.metrics import MetricsRegistry as _Reg

    reg = _Reg()
    reg.counter("rpc.bytes_in").inc(7)
    ring = HistoryRing(allowlist=("rpc.bytes_in",), slots=4, registry=reg)
    ring.sample(now=1.0)
    ring.sample(now=2.0)
    rec = FlightRecorder(obs.recorder, obs.registry)
    rec.install(str(tmp_path), "hist-node")
    rec.history_provider = ring.status
    d = json.load(open(rec.dump(reason="test")))
    hist = d["history"]
    assert hist["samples"] == 2
    assert [s["name"] for s in hist["series"]] == ["rpc.bytes_in"]
    # a broken provider never breaks the dump itself
    rec.history_provider = lambda: (_ for _ in ()).throw(RuntimeError())
    d2 = json.load(open(rec.dump(reason="test2")))
    assert "history" not in d2


# -- heat (tests/test_heat.py)


def test_heat_note_and_snapshot_rates():
    t = HeatTable(cap=8, half_life=60.0, enabled=True)
    for _ in range(10):
        t.note("a", "read", now=100.0)
    t.note("a", "bytes", 4096, now=100.0)
    snap = t.snapshot(now=100.0)
    assert snap["docs"] == 1 and snap["evictions"] == 0
    e = snap["entries"][0]
    assert e["doc"] == "a"
    # 10 undecayed read events -> rank 10, rate 10 * ln2 / half_life
    assert e["rank"] == 10.0
    assert math.isclose(e["rates"]["read"], 10 * math.log(2) / 60.0)
    assert e["totals"]["read"] == 10.0 and e["totals"]["bytes"] == 4096.0
    # bytes do not contribute to rank (unit mismatch would drown counts)
    t.note("b", "bytes", 1e9, now=100.0)
    snap = t.snapshot(now=100.0)
    assert [x["doc"] for x in snap["entries"]] == ["a", "b"]
    assert snap["entries"][1]["rank"] == 0.0


def test_heat_decay_half_life():
    t = HeatTable(cap=8, half_life=10.0, enabled=True)
    t.note("a", "write", 8.0, now=0.0)
    e = t.snapshot(now=10.0)["entries"][0]
    assert math.isclose(e["rank"], 4.0)  # one half-life
    e = t.snapshot(now=30.0)["entries"][0]
    assert math.isclose(e["rank"], 1.0)  # three half-lives
    # totals never decay
    assert e["totals"]["write"] == 8.0


def test_heat_cap_is_bounded_and_space_saving_eviction():
    t = HeatTable(cap=4, half_life=60.0, enabled=True)
    # one genuinely hot doc, then a stream of cold one-shot docs
    for _ in range(100):
        t.note("hot", "read", now=0.0)
    for i in range(50):
        t.note(f"cold{i}", "read", now=0.0)
    snap = t.snapshot(now=0.0)
    assert snap["docs"] <= 4  # bounded by construction
    assert snap["evictions"] > 0
    # the hot doc survives the cold stream (the space-saving guarantee)
    assert snap["entries"][0]["doc"] == "hot"
    assert snap["entries"][0]["rank"] >= 100.0
    # a late newcomer inherits the victim's rank as its error bound
    late = [e for e in snap["entries"] if e["doc"] != "hot"]
    assert all(e["err"] >= 1.0 for e in late)


def test_heat_disabled_table_records_nothing():
    t = HeatTable(cap=4, enabled=False)
    t.note("a", "read", now=0.0)
    assert t.snapshot(now=0.0)["entries"] == []
    assert t.snapshot(now=0.0)["enabled"] is False


def test_heat_unknown_kind_and_empty_doc_ignored():
    t = HeatTable(cap=4, enabled=True)
    t.note("", "read", now=0.0)
    t.note("a", "nonsense", now=0.0)
    assert t.snapshot(now=0.0)["entries"] == []


def test_heat_forget_and_reset():
    t = HeatTable(cap=4, enabled=True)
    t.note("a", "read", now=0.0)
    t.note("b", "read", now=0.0)
    assert t.forget("a") is True
    assert t.forget("a") is False
    assert [e["doc"] for e in t.snapshot(now=0.0)["entries"]] == ["b"]
    t.reset()
    assert t.snapshot(now=0.0)["docs"] == 0


def test_heat_snapshot_deterministic_order_and_top():
    t = HeatTable(cap=8, half_life=60.0, enabled=True)
    for d in ("z", "m", "a"):
        t.note(d, "read", 5.0, now=0.0)  # identical ranks
    docs = [e["doc"] for e in t.snapshot(now=0.0)["entries"]]
    assert docs == ["a", "m", "z"]  # ties broken by name
    t.note("hotter", "read", 9.0, now=0.0)
    snap = t.snapshot(now=0.0, top=2)
    assert [e["doc"] for e in snap["entries"]] == ["hotter", "a"]
    assert snap["docs"] == 4  # top= truncates entries, not the count


def test_heat_publish_gauges_removes_stale_series():
    obs.reset_all()
    t = HeatTable(cap=8, half_life=60.0, enabled=True)
    t.note("a", "read", 10.0, now=0.0)
    t.note("b", "read", 5.0, now=0.0)
    assert t.publish_gauges(top=2, now=0.0) == 2
    names = {(e["labels"].get("doc"), e["labels"].get("kind"))
             for e in obs.snapshot() if e["name"] == "doc.heat"}
    assert names == {("a", "read"), ("b", "read")}
    # b falls out of the top set -> its series must disappear
    t.note("c", "write", 20.0, now=0.0)
    t.publish_gauges(top=2, now=0.0)
    names = {(e["labels"].get("doc"), e["labels"].get("kind"))
             for e in obs.snapshot() if e["name"] == "doc.heat"}
    assert names == {("a", "read"), ("c", "write")}
    obs.reset_all()


def test_heat_global_table_hooks():
    heat.reset()
    heat.note("gdoc", "sync", now=0.0)
    snap = heat.snapshot(now=0.0)
    assert any(e["doc"] == "gdoc" for e in snap["entries"])
    heat.reset()
    assert heat.snapshot(now=0.0)["docs"] == 0


# -- history rings (tests/test_history.py)


def _ring(allowlist, slots=8, cap=64):
    reg = MetricsRegistry()
    return reg, HistoryRing(allowlist=allowlist, slots=slots, cap=cap,
                            registry=reg)


def test_history_counter_deltas_per_slot():
    reg, ring = _ring(("c.x",))
    c = reg.counter("c.x")
    ring.sample(now=1.0)          # baseline: first sample's delta is 0
    c.inc(3)
    ring.sample(now=2.0)
    c.inc(2)
    ring.sample(now=3.0)
    slots = ring.series("c.x", tier=0)
    assert [s["delta"] for s in slots] == [0.0, 3.0, 2.0]
    assert [s["t"] for s in slots] == [1.0, 2.0, 3.0]


def test_history_counter_reset_protection():
    reg, ring = _ring(("c.x",))
    c = reg.counter("c.x")
    c.inc(10)
    ring.sample(now=1.0)
    reg.reset()                   # process restart: total drops to 0
    reg.counter("c.x").inc(4)
    ring.sample(now=2.0)
    deltas = [s["delta"] for s in ring.series("c.x", tier=0)]
    assert deltas[-1] >= 0.0      # never a negative rate


def test_history_counter_aggregates_across_label_sets():
    reg, ring = _ring(("c.x",))
    reg.counter("c.x", k="a").inc(2)
    reg.counter("c.x", k="b").inc(5)
    ring.sample(now=1.0)
    reg.counter("c.x", k="a").inc(1)
    ring.sample(now=2.0)
    assert ring.series("c.x", tier=0)[-1]["delta"] == 1.0


def test_history_gauge_max_and_last():
    reg, ring = _ring(("g.x",))
    reg.gauge("g.x", n="1").set(5.0)
    reg.gauge("g.x", n="2").set(9.0)
    ring.sample(now=1.0)
    s = ring.series("g.x", tier=0)[-1]
    assert s["max"] == 9.0 and s["last"] == 9.0


def test_history_downsampling_preserves_delta_sums_and_max_envelope():
    reg, ring = _ring(("c.x", "g.x"), slots=200)
    c = reg.counter("c.x")
    g = reg.gauge("g.x")
    per1 = int(round(TIERS[1] / TIERS[0]))
    per2 = int(round(TIERS[2] / TIERS[1]))
    n = per1 * per2               # exactly one tier-2 slot's worth
    total = 0
    peak = 0.0
    for i in range(n):
        c.inc(i % 3)
        total += i % 3
        val = float((i * 7) % 11)
        peak = max(peak, val)
        g.set(val)
        ring.sample(now=float(i + 1))
    t1 = ring.series("c.x", tier=1)
    assert len(t1) == per2
    # additivity: the coarse deltas sum to everything except the first
    # sample's baseline (delta 0), i.e. to the true total
    assert sum(s["delta"] for s in t1) == float(total)
    t2 = ring.series("c.x", tier=2)
    assert len(t2) == 1 and t2[0]["delta"] == float(total)
    # the gauge spike envelope survives both downsampling folds
    assert ring.series("g.x", tier=1)[0]["max"] <= peak
    assert ring.series("g.x", tier=2)[0]["max"] == peak


def test_history_rings_are_bounded():
    reg, ring = _ring(("c.x",), slots=4)
    c = reg.counter("c.x")
    for i in range(1000):
        c.inc()
        ring.sample(now=float(i))
    for tier in range(len(TIERS)):
        assert len(ring.series("c.x", tier=tier)) <= 4
    assert ring.samples == 1000


def test_history_series_cap_counts_dropped():
    reg, ring = _ring(tuple(f"m{i}" for i in range(8)), cap=3)
    for i in range(8):
        reg.counter(f"m{i}").inc()
    ring.sample(now=1.0)
    st = ring.status()
    assert len(st["series"]) == 3
    assert st["droppedSeries"] == 5


def test_history_allowlist_filters():
    reg, ring = _ring(("wanted",))
    reg.counter("wanted").inc()
    reg.counter("unwanted").inc()
    reg.gauge("also.unwanted").set(1)
    ring.sample(now=1.0)
    assert [s["name"] for s in ring.status()["series"]] == ["wanted"]


def test_history_status_filters_and_reset():
    reg, ring = _ring(("a", "b"))
    reg.counter("a").inc()
    reg.gauge("b").set(2)
    ring.sample(now=1.0)
    st = ring.status(name="b")
    assert [s["name"] for s in st["series"]] == ["b"]
    st = ring.status(tier=1)
    assert all(list(s["tiers"].keys()) == ["1"] for s in st["series"])
    ring.reset()
    assert ring.status()["series"] == [] and ring.samples == 0


def test_history_background_sampler_start_stop():
    reg, ring = _ring(("c.x",))
    reg.counter("c.x").inc()
    assert ring.start() is True
    assert ring.start() is False  # idempotent
    ring.stop()
    assert ring._thread is None


# -- the device-merge pipeline and a sync round as spans (tests/test_obs.py)


def _device_apply(n_deltas=3):
    """A base document and a few committed deltas pushed through the
    resident ``DeviceDoc``'s incremental path on the CPU."""
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.types import ActorId, ObjType

    base = AutoDoc(actor=ActorId(bytes([1]) * 16), device=CPU)
    tobj = base.put_object("_root", "t", ObjType.TEXT)
    base.splice_text(tobj, 0, 0, "hello world")
    base.commit()
    dev = DeviceDoc.merge([a.stored for a in base.doc.history], device=CPU)
    for i in range(n_deltas):
        base.splice_text(tobj, 0, 0, f"d{i} ")
        base.commit()
        dev.apply_changes([base.doc.history[-1].stored])
    return dev


def test_export_covers_device_merge_apply_and_sync_round(tmp_path):
    """A device-merge apply and a full sync round render as nested spans
    in the exported Perfetto JSON."""
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.sync.session import SyncSession

    _device_apply()
    a, b = AutoDoc(device=CPU), AutoDoc(device=CPU)
    a.put("_root", "x", 1)
    a.commit()
    sa, sb = SyncSession(a, epoch=1), SyncSession(b, epoch=2)
    for tick in range(32):
        fa, fb = sa.poll(float(tick)), sb.poll(float(tick))
        if fa is not None:
            sb.receive(fa, float(tick))
        if fb is not None:
            sa.receive(fb, float(tick))
        if sa.converged() and sb.converged():
            break
    assert a.get_heads() == b.get_heads()

    path = str(tmp_path / "pipeline.json")
    obs.export_trace(path)
    events = json.load(open(path))["traceEvents"]
    by_id = {e["args"]["span_id"]: e for e in events}
    names = {e["name"] for e in events}
    assert {"device.apply", "device.extract", "device.kernel"} <= names, names
    applies = {e["args"]["span_id"] for e in events if e["name"] == "device.apply"}
    nested = {e["name"] for e in events if e["args"].get("parent_id") in applies}
    assert {"device.stage.dedup", "device.stage.causal_order",
            "device.stage.splice", "device.materialize"} <= nested, nested
    assert {"sync.generate", "sync.receive", "sync.apply"} <= names, names
    sync_applies = [e for e in events if e["name"] == "sync.apply"]
    assert sync_applies
    for e in sync_applies:
        assert by_id[e["args"]["parent_id"]]["name"] == "sync.receive"


# -- per-document gauges -----------------------------------------------------


def _gauges(o, doc):
    return {e["name"]: e["value"] for e in o.snapshot()
            if e["type"] == "gauge" and e["labels"] == {"doc": doc}}


def test_per_doc_gauges_device_layer_equal_the_reference():
    """``DeviceDoc.obs_name`` labels the gauges ``_export_doc_gauges``
    sets after every apply: resident ops, resident bytes and the compress
    ratio, equal to the JAX package's on the same log."""
    from .test_torch_batched import j_parse

    base, deltas, _ = W.serve_workload(1, 3, 8, 200)
    dev = DeviceDoc.merge([base], device=CPU)
    jdev = JDeviceDoc.resolve(JOpLog.from_changes(j_parse([base])))
    assert _gauges(obs, "docB") == {}
    dev.apply_changes([deltas[0][0]])
    assert _gauges(obs, "docB") == {}  # unnamed: nothing exported
    dev.obs_name = jdev.obs_name = "docB"
    jdev.apply_changes(j_parse([deltas[0][0]]))
    for c in (1, 2):
        dev.apply_changes([deltas[0][c]])
        jdev.apply_changes(j_parse([deltas[0][c]]))
        got = _gauges(obs, "docB")
        assert got == _gauges(RO, "docB")
        assert got["doc.resident_ops"] == dev.log.n > 0
        assert got["doc.device_bytes"] == dev.resident_nbytes() > 0
    # the hygiene call drops the document's series
    assert obs.remove_doc_gauges("docB", device_only=True) == 3
    assert _gauges(obs, "docB") == {}


# -- the drain-cycle profiler (tests/test_prof.py), on an injected clock ------


def test_cycle_attributes_stages_and_split(clock):
    with prof.cycle(kind="t") as c:
        with obs.span("device.stage.dedup"):
            clock.spin(0.002)
        with obs.span("device.apply"):
            with obs.span("device.stage.splice"):
                clock.spin(0.004)
            clock.spin(0.001)
        with obs.span("device.kernel"):
            clock.spin(0.003)
        with obs.span("journal.fsync"):
            clock.spin(0.002)
    r = c.report
    assert r["stages"] == pytest.approx(
        {"dedup": 0.002, "splice": 0.004, "kernel": 0.003, "fsync": 0.002})
    # the host umbrella counts once; splice stays breakdown-only
    assert r["host_s"] == pytest.approx(0.007)
    assert r["device_s"] == pytest.approx(0.003)
    assert r["fsync_s"] == pytest.approx(0.002)
    assert r["wall_s"] == pytest.approx(0.012)
    assert r["attributed_frac"] == pytest.approx(1.0)


def test_nested_device_work_never_double_counts(clock):
    with prof.cycle(kind="t") as c:
        with obs.span("device.apply"):
            with obs.span("device.kernel"):
                clock.spin(0.004)
            clock.spin(0.001)
    r = c.report
    assert r["attributed_s"] == pytest.approx(r["wall_s"])
    assert r["stages"]["kernel"] == pytest.approx(0.004)
    assert r["device_s"] == pytest.approx(0.004)  # moved to the device side
    assert r["host_s"] == pytest.approx(0.001)  # the pure host remainder


def test_cycle_notes_and_occupancy():
    with prof.cycle(kind="t", docs=3) as c:
        prof.note("useful_rows", 75)
        prof.note("padded_rows", 25)
        prof.note("launches")
    r = c.report
    assert r["occupancy"] == 0.75
    assert r["docs"] == 3 and r["launches"] == 1
    s = prof.profiler.status()
    assert s["occupancy"] == 0.75
    assert s["docs_per_launch"] == 3.0


def test_summarize_reports_matches_status(clock):
    reports = []
    for _ in range(3):
        with prof.cycle(kind="t") as c:
            with obs.span("device.kernel"):
                clock.spin(0.001)
        reports.append(c.report)
    merged = prof.summarize_reports(reports)
    status = prof.profiler.status()
    assert merged["cycles"] == status["cycles"] == 3
    assert merged["stages"].keys() == status["stages"].keys()
    assert merged["attributed_s"] == status["attributed_s"]


def test_disabled_profiler_is_a_noop(monkeypatch):
    monkeypatch.setattr(prof.profiler, "enabled", False)
    with prof.cycle(kind="t") as c:
        with obs.span("device.kernel"):
            pass
    assert c.report is None
    assert prof.profiler.cycles == 0


def test_top_k_table_stays_bounded():
    k = prof.profiler.top_k
    for i in range(50 * k):
        with prof.cycle(kind="t", doc=f"doc{i % (10 * k)}"):
            pass
    assert len(prof.profiler._doc_costs) <= 4 * k
    top = prof.profiler.top_docs()
    assert len(top) <= k
    secs = [e["seconds"] for e in top]
    assert secs == sorted(secs, reverse=True)


def test_cycle_doc_wall_does_not_double_count_staging(clock):
    with prof.cycle(kind="t", doc="d1") as c:
        prof.note_doc("d1", 0.001)
        clock.spin(0.004)
    r = c.report
    assert r["doc_costs"]["d1"] == r["wall_s"] == pytest.approx(0.004)


def test_umbrella_opened_before_cycle_clamps_to_cycle_wall(clock):
    outer = obs.span("device.apply")
    outer.__enter__()
    clock.spin(0.01)
    with prof.cycle(kind="t") as c:
        clock.spin(0.002)
        outer.__exit__(None, None, None)
    r = c.report
    # only the overlap with the cycle attributes
    assert r["attributed_s"] == pytest.approx(0.002) == r["wall_s"]
    assert prof.summarize_reports([r])["attributed_frac"] <= 1.0


def test_device_umbrella_under_host_umbrella_reassigns_split(clock):
    with prof.cycle(kind="t") as c:
        with obs.span("rpc.request"):
            with obs.span("device.batched"):
                with obs.span("device.kernel"):
                    clock.spin(0.004)
            clock.spin(0.001)
    r = c.report
    assert r["attributed_s"] == pytest.approx(r["wall_s"])
    assert r["device_s"] == pytest.approx(0.004)
    assert r["host_s"] == pytest.approx(0.001)
    assert r["stages"]["kernel"] == pytest.approx(0.004)


def test_whale_doc_survives_pruning():
    prof.profiler._doc_costs["whale"] = 100.0
    for i in range(100 * prof.profiler.top_k):
        with prof.cycle(kind="t", doc=f"cheap{i}"):
            pass
    assert "whale" in {e["doc"] for e in prof.profiler.top_docs()}


def _cross_doc_work(n, seed=0):
    """``n`` serve-shaped documents on the CPU and one delta batch each."""
    base, deltas, _ = W.serve_workload(n, 1, 4, 300, tag=seed)
    return [(DeviceDoc.merge([base], device=CPU), [[deltas[i][0]]])
            for i in range(n)]


def test_batched_drain_cycle_report():
    work = _cross_doc_work(3)
    obs.reset_all()  # the documents' own merges are not the drain's
    with prof.cycle(kind="t") as c:
        PB.apply_cross_doc(work, device=CPU)
    r = c.report
    assert r["attributed_s"] <= r["wall_s"]
    assert r["launches"] == 1 and r["docs"] == 3 and r["changes"] == 3
    assert r["useful_rows"] > 0 and 0 < r["occupancy"] <= 1.0
    for stage in ("dedup", "causal_order", "host_pack", "host_sort",
                  "host_splice", "pack", "h2d", "kernel", "readback", "scatter"):
        assert stage in r["stages"], (stage, r["stages"])
    # the pack site's counters fired alongside, the same rows
    rows = obs.counter_values("device.batch_rows", "").get("", 0)
    pad = obs.counter_values("device.batch_padding_rows", "").get("", 0)
    assert (rows, pad) == (r["useful_rows"], r["padded_rows"])
    assert r["h2d_bytes"] == obs.counter_values("device.h2d_bytes", "")[""]
    assert [e["doc"] for e in prof.profiler.top_docs()] != []


def test_served_drain_cycle_notes_launches():
    base, deltas, _ = W.serve_workload(1, 4, 6, 200)
    doc = DeviceDoc.merge([base], device=CPU)
    obs.reset_all()
    with prof.cycle(kind="serve") as c:
        doc.apply_batches([[d] for d in deltas[0]])
    r = c.report
    # the CPU applies batch by batch: tail appends resolve on the host
    kl = obs.counter_values("device.kernel_launches", "path")
    assert r["launches"] == kl.get("per_doc", 0)
    assert obs.counter_values("device.delta_resolve", "")[""] == 4
    assert "materialize" in r["stages"] and "dedup" in r["stages"]
    assert obs.counter_values("device.coalesced_batches", "")[""] == 4


def test_cycle_report_lands_in_flight_ring():
    with prof.cycle(kind="t"):
        PB.apply_cross_doc(_cross_doc_work(2, seed=6), device=CPU)
    evs = [{"name": n, "fields": f} for _t, n, f in obs.flight.events
           if n == "drain.cycle_report"]
    assert evs
    merged = prof.summarize_flight_events(evs)
    assert merged["cycles"] >= 1
    assert "kernel" in merged["stages"]


def test_status_is_json_and_renders():
    with prof.cycle(kind="t"):
        PB.apply_cross_doc(_cross_doc_work(2, seed=3), device=CPU)
    s = prof.profiler.status()
    json.dumps(s)
    assert s["torch_profiler"] == {"active": False, "dir": None}
    assert {"host_pct", "device_pct", "stages", "drain_cycle_seconds",
            "queue_wait_seconds", "extract_cache", "heat"} <= set(s)
    text = prof.render_text(s)
    assert text.startswith("drain cycles: 1") and "split: host" in text


# -- the torch.profiler capture and the named ranges -------------------------


def test_annotate_is_free_when_inactive():
    from contextlib import nullcontext

    cm = prof.annotate("amtpu.test")
    assert isinstance(cm, nullcontext)
    with cm:
        pass
    assert prof._torch_trace["active"] is False


def test_capture_holds_the_ranges_of_a_drain(tmp_path):
    d = str(tmp_path / "torchprof")
    assert prof.torch_profile_stop()["ok"] is False  # nothing active
    start = prof.torch_profile_start(d)
    assert start == {"ok": True, "dir": d}
    try:
        again = prof.torch_profile_start()
        assert again["ok"] is False and again["dir"] == d
        PB.apply_cross_doc(_cross_doc_work(2, seed=9), device=CPU)
        DeviceDoc.merge([W.serve_workload(1, 1, 2, 20)[0]], device=CPU)
    finally:
        stop = prof.torch_profile_stop()
    assert stop["ok"] is True and stop["dir"] == d
    assert stop["trace"] == os.path.join(d, prof.TRACE_FILE)
    names = {e.get("name") for e in json.load(open(stop["trace"]))["traceEvents"]}
    assert {"amtpu.batched_launch", "amtpu.resolve"} <= names, names
    assert obs.counter_values("device.profiler_captures", "")[""] == 1
    assert prof.torch_profile_stop()["ok"] is False


def test_capture_that_cannot_start_answers_and_counts(monkeypatch):
    import torch

    def broken(**kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    r = prof.torch_profile_start()
    assert r == {"ok": False, "reason": "no profiler here"}
    assert obs.counter_values("device.profiler_unavailable", "reason") == {
        "RuntimeError": 1}
    assert prof._torch_trace["active"] is False


def test_a_failing_nvtx_range_raises(monkeypatch):
    """On the card a range is also an NVTX range; its failure is not
    swallowed (the reference returned a null context)."""
    import torch

    def broken(name):
        raise RuntimeError("nvtx failed")

    monkeypatch.setitem(prof._torch_trace, "active", True)
    monkeypatch.setitem(prof._torch_prof, "nvtx", True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", broken)
    with pytest.raises(RuntimeError, match="nvtx failed"):
        with prof.annotate("amtpu.resolve"):
            pass



# -- the port against the JAX package ----------------------------------------


def _feed(reg):
    """The same instruments, fed the same values, in one registry."""
    reg.counter("device.kernel_launches", path="per_doc").inc(3)
    reg.counter("device.kernel_launches", path="batched").inc()
    reg.counter("sync.malformed", stage='fr"a\\me').inc(2)
    reg.gauge("doc.device_bytes", doc="d 1").set(12345.5)
    reg.gauge("doc.compress_ratio", doc="d2").set(float("inf"))
    for v in (0.0, 1e-7, 0.001, 0.5, 1.0, 2.0, 7.5, 1e4):
        reg.histogram("device.kernel").observe(v)
        reg.histogram("drain.stage_seconds", stage="h2d").observe(v / 3)


def test_prometheus_text_equals_the_reference_byte_for_byte():
    from automerge_tpu.obs.metrics import MetricsRegistry as RReg
    from automerge_tpu.obs.metrics import merge_prometheus as r_merge

    from automerge_tpu_torch.obs.metrics import merge_prometheus

    a, b = MetricsRegistry(), RReg()
    _feed(a)
    _feed(b)
    assert a.render_prometheus() == b.render_prometheus()
    assert a.snapshot() == b.snapshot()
    texts = {"n1": a.render_prometheus()}
    assert merge_prometheus(texts) == r_merge(texts)
    assert parse_prometheus(texts["n1"]) == parse_prometheus(
        b.render_prometheus())


def test_module_api_renders_as_the_reference():
    for o in (obs, RO):
        o.count("x.count", 2, labels={"k": "v"})
        o.gauge_set("x.gauge", 4.25)
        o.observe("x.hist", 0.125)
    assert obs.render_prometheus() == RO.render_prometheus()
    assert obs.counter_values("x.count", "k") == RO.counter_values("x.count", "k")
    assert dict(trace.counters) == {"x.count": 2}


def _capture(o):
    """(span counts by name, counters by (name, labels)) of one package."""
    spans = {k: v[1] for k, v in o.legacy_timings.items()}
    ctr = {(e["name"], tuple(sorted(e["labels"].items()))): e["value"]
           for e in o.snapshot() if e["type"] == "counter"}
    return spans, ctr


# Differences made on purpose, each with its reason:
BY_DESIGN = {
    # the JAX package ranks document order on the host beside an in-flight
    # launch (``device.linearize``); the port's ``linearize`` kernel runs
    # inside the launch, under ``device.kernel``
    "spans": {"device.linearize"},
    # the JAX package looks a change's columns up in a hash-keyed cache
    # before decoding; the port keeps them on the change object alone
    # (ROADMAP §3), so it has no hits and counts every decode a miss
    "counters": {"extract.change_cache_hit", "extract.change_cache_miss"},
}
# in a sync flow the port's documents also merge on the device for a
# save's document order, where the JAX package walks on the host
SAVE_ON_DEVICE = {"device.h2d", "device.kernel", "device.readback"}
SAVE_COUNTERS = {"device.run_native_fallback", "device.kernel_input_bytes",
                 "device.kernel_input_dense_bytes", "device.h2d_bytes",
                 "device.h2d_dense_bytes"}
# counts that depend only on the data: launches by path, rows, documents,
# changes, sync frames
DATA_COUNTERS = {
    "device.kernel_launches", "oplog.append_rows", "host_batch.docs",
    "host_batch.fallback_docs", "device.batch_rows",
    "device.batch_padding_rows", "device.coalesced_batches",
    "device.delta_resolve", "device.reresolve_subset",
    "device.reresolve_full", "device.apply_rebuild", "device.apply_deferred",
    "device.batched_fallback", "oplog.ovc_join", "oplog.compress_fallback",
    "sync.retry", "sync.dup", "sync.malformed", "sync.reset", "sync.resync",
    "sync.rejected", "sync.coalesced_batches", "load.salvaged_chunks",
}


def _fanin():
    from .test_torch_batched import j_parse

    base, deltas, _ = W.serve_workload(4, 3, 6, 60)
    blobs = [base] + [d for ds in deltas for d in ds]
    return (lambda: JDeviceDoc.resolve(JOpLog.from_changes(j_parse(blobs))),
            lambda: DeviceDoc.merge(blobs, device=CPU))


def _served():
    from .test_torch_batched import j_parse

    base, deltas, _ = W.serve_workload(2, 4, 6, 120)
    batches = deltas[0] + [deltas[1][0]]

    def ref():
        d = JDeviceDoc.resolve(JOpLog.from_changes(j_parse([base])))
        d.apply_batches([j_parse([x]) for x in batches])

    def port():
        d = DeviceDoc.merge([base], device=CPU)
        d.apply_batches([[x] for x in batches])

    return ref, port


def _cross_doc():
    from .test_torch_batched import j_parse

    n, cycles = 6, 3
    base, deltas, _ = W.serve_workload(n, cycles, 6, 80, burst={(2, 1): 300})

    def ref():
        docs = [JDeviceDoc.resolve(JOpLog.from_changes(j_parse([base])))
                for _ in range(n)]
        for c in range(cycles):
            JB.apply_cross_doc([(docs[i], [j_parse([deltas[i][c]])])
                                for i in range(n)], max_docs_per_launch=4)

    def port():
        docs = [DeviceDoc.merge([base], device=CPU) for _ in range(n)]
        for c in range(cycles):
            PB.apply_cross_doc([(docs[i], [[deltas[i][c]]]) for i in range(n)],
                               device=CPU, max_docs_per_launch=4)

    return ref, port


def _sync():
    from .test_torch_sync import run_schedule

    return (lambda: run_schedule("ref", 3, 0.2, 0.2),
            lambda: run_schedule("port", 3, 0.2, 0.2))


@pytest.mark.parametrize("flow", ["fanin", "served", "cross_doc", "sync"])
def test_flows_record_what_the_reference_records(flow):
    from automerge_tpu.obs import prof as RP

    ref, port = {"fanin": _fanin, "served": _served, "cross_doc": _cross_doc,
                 "sync": _sync}[flow]()
    RP.profiler.reset()
    with RP.cycle(kind=flow) as rcyc:
        ref()
    with prof.cycle(kind=flow) as pcyc:
        port()
    (rs, rc), (ps, pc) = _capture(RO), _capture(obs)
    # the cycle profilers' notes: what each drain staged and launched
    notes = ("docs", "changes", "launches", "useful_rows", "padded_rows")
    assert {k: pcyc.report[k] for k in notes} == {k: rcyc.report[k] for k in notes}
    skip_stages = {"linearize"} | ({"h2d", "kernel", "readback"}
                                   if flow == "sync" else set())
    assert (set(pcyc.report["stages"]) - skip_stages
            == set(rcyc.report["stages"]) - skip_stages)
    skip_spans = set(BY_DESIGN["spans"])
    skip_ctrs = set(BY_DESIGN["counters"])
    if flow == "sync":
        skip_spans |= SAVE_ON_DEVICE
        skip_ctrs |= SAVE_COUNTERS
    assert ({k for k in rs if k not in skip_spans}
            == {k for k in ps if k not in skip_spans})
    assert rs.keys() - ps.keys() <= skip_spans
    fams = {k for k in rc if k[0] not in skip_ctrs}
    assert fams == {k for k in pc if k[0] not in skip_ctrs}
    data = {k: rc[k] for k in fams if k[0] in DATA_COUNTERS}
    assert data and data == {k: pc[k] for k in data}
    if flow == "sync":
        # frame for frame the same sessions: the spans fire alike too
        assert {k: rs[k] for k in rs if k.startswith("sync.")} == {
            k: ps[k] for k in ps if k.startswith("sync.")}
    else:
        assert rc[("device.kernel_launches", (("path", "per_doc"),))] > 0
        assert pcyc.report["launches"] > 0


def test_read_capture_joins_ranges_to_their_kernels(tmp_path):
    """``prof.read_capture`` on a Chrome trace of torch.profiler's shape:
    a range's kernels are those launched on its thread between its ends
    (joined by correlation id), and the busy share is the union of the
    kernel intervals over the window."""
    def x(name, cat, ts, dur, tid=1, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "tid": tid, "pid": 1, "args": args}

    events = [
        x("smoke.window", "user_annotation", 0, 100),
        x("amtpu.resolve", "user_annotation", 10, 20),
        x("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=1),
        x("cudaLaunchKernel", "cuda_runtime", 15, 1, correlation=2),
        x("cudaLaunchKernel", "cuda_runtime", 15, 1, tid=2, correlation=3),
        x("cudaLaunchKernel", "cuda_runtime", 40, 1, correlation=4),
        x("k1", "kernel", 20, 10, tid=7, correlation=1),
        x("k2", "kernel", 25, 10, tid=7, correlation=2),  # overlaps k1
        x("k3", "kernel", 50, 5, tid=7, correlation=3),
        x("k4", "kernel", 95, 10, tid=7, correlation=4),  # past the window
        x("amtpu.resolve", "user_annotation", 60, 5),
        {"ph": "i", "name": "marker", "ts": 1},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    cap = prof.read_capture(str(path), "smoke.window")
    assert cap["ranges"] == {"amtpu.resolve": {"count": 2, "kernels": 2}}
    assert cap["kernels"] == 4
    assert cap["window_s"] == pytest.approx(100e-6)
    # k1 + k2 cover 20..35, k3 50..55, k4 95..100 inside the window
    assert cap["busy_s"] == pytest.approx(25e-6)
    assert cap["busy_share"] == pytest.approx(0.25)
    whole = prof.read_capture(str(path))
    assert whole["window_s"] == pytest.approx(105e-6)
    with pytest.raises(ValueError):
        prof.read_capture(str(path), "no.such.range")
