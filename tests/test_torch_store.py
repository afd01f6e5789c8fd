"""The tiered document store in the port (``store/policy.py``,
``store/docstore.py``) against the JAX package's, on the CPU.

The policy is a pure function: ``pick_demotions`` and
``compact_on_demote`` must equal the reference's over seeded
``DocStats`` and budgets. The store's mechanics come from an ``ops``
object the serving layer supplies; ``MiniServer`` below is that layer's
smallest form over ``DurableDocument`` (named documents under one
directory, the transitions as the reference's ``RpcServer._store_*``),
for either package. Driven by the same sequence, both packages'
``DocStore``s make the same transitions and export the same tier gauges
and ``store.promotions`` / ``store.demotions`` labels. Then the
reference's ``tests/test_store.py`` cases that need no RPC server,
ported: the policy units, gauge hygiene, the demote / hydrate round
trip, the released flock, the mirror's drop and rebuild, the evicted
instance, single-flight hydration, backpressure, the salvaging cold
open and budget-driven eviction.
"""

import os
import threading
import time

import numpy as np
import pytest

import automerge_tpu.api as RA
import automerge_tpu.store as RS
from automerge_tpu import obs as robs
import automerge_tpu_torch.api as PA
import automerge_tpu_torch.store as PS
from automerge_tpu_torch import obs as pobs
from automerge_tpu_torch.store import (
    TIER_COLD,
    TIER_HOT,
    TIER_WARM,
    DocStats,
    StoreBackpressure,
    StoreBudgets,
    pick_demotions,
)
from automerge_tpu_torch.store.docstore import ColdDocRef
from automerge_tpu_torch.store.policy import compact_on_demote


@pytest.fixture(autouse=True)
def _fresh_obs():
    robs.reset_all()
    pobs.reset_all()
    yield


class MiniServer:
    """Named durable documents under ``root`` with a ``DocStore`` over
    them; it is also the store's ``ops`` (``open_cold`` / ``close_cold``
    / ``drop_device`` / ``build_device``, as the reference's
    ``RpcServer._store_*``) and the stand-in the ``Scrubber`` reads
    (``_lock``, ``_durable_names``, ``_docs``, ``store``,
    ``_durable_path``). ``port`` picks the package: the port's documents
    run on the CPU and name the mirror ``mirror``; the reference's name
    it ``device``. A failed promotion propagates here (the reference's
    server counts it and carries on)."""

    def __init__(self, root, *, port=True, budgets=None):
        self.port = port
        self.api, store_mod = (PA, PS) if port else (RA, RS)
        self.durable_dir = str(root)
        os.makedirs(self.durable_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._durable_names = {}
        self._docs = {}
        self._chaos_fs = {}
        self.opens = []
        self.store = store_mod.DocStore(self, budgets or StoreBudgets(
            evict_interval_s=0.0))

    def _durable_path(self, name):
        return os.path.join(self.durable_dir, name)

    def _open(self, name, *, mirror=False, **kw):
        if self.port:
            kw.update(device="cpu", mirror=mirror)
        else:
            kw.update(device=mirror)
        fs = self._chaos_fs.get(name)
        if fs is not None:
            kw["fs"] = fs
        self.opens.append(name)
        return self.api.AutoDoc.open(self._durable_path(name), **kw)

    def open(self, name, *, mirror=False, **kw):
        dd = self._open(name, mirror=mirror, **kw)
        with self._lock:
            self._durable_names[name] = name
            self._docs[name] = dd
        if self.port:
            self.store.admit(name, dd, mirror=mirror)
        else:
            self.store.admit(name, dd, device=mirror)
        return dd

    def doc(self, name):
        return self.store.ensure_open(name)

    def close(self):
        self.store.close()
        for dd in list(self._docs.values()):
            dd.close()

    # -- the store's ops ---------------------------------------------------

    def open_cold(self, name):
        ref = self._docs[name]
        dd = self._open(name, fsync=ref.fsync_policy,
                        text_encoding=ref.text_encoding)
        with self._lock:
            self._docs[name] = dd
        return dd

    def close_cold(self, name, compact):
        dd = self._docs[name]
        if getattr(dd, "_closed", False):
            return dd
        with dd.lock:
            if compact and not dd.degraded:
                dd.compact()
            dd.close()
            acked, appended = dd.acked_prefix()
            cold = (ColdDocRef if self.port else RS.ColdDocRef)(
                name, fsync_policy=dd.journal.fsync_policy,
                text_encoding=dd._core.text_encoding, acked=acked,
                appended=appended, replication_cursor=dd.replication_cursor)
        with self._lock:
            self._docs[name] = cold
        return cold

    def drop_device(self, name):
        dd = self._docs[name]
        with dd.lock:
            dd.drop_device_mirror()

    def build_device(self, name):
        self._docs[name].build_device_mirror()
        return True


# -- the policy, both packages --------------------------------------------------


def seeded_stats(rng, n):
    tiers = (TIER_HOT, TIER_WARM, TIER_COLD)
    return [(f"d{i}", tiers[int(rng.integers(0, 3))],
             float(rng.uniform(0, 100)), int(rng.integers(0, 1 << 20)))
            for i in range(n)]


@pytest.mark.parametrize("seed", range(8))
def test_pick_demotions_equals_reference(seed):
    rng = np.random.default_rng(seed)
    rows = seeded_stats(rng, int(rng.integers(1, 40)))
    bud = dict(
        hot_docs=int(rng.integers(0, 6)),
        warm_bytes=int(rng.integers(0, 8 << 20)) * int(rng.integers(0, 2)),
        max_rss_bytes=int(rng.integers(0, 4 << 20)) * int(rng.integers(0, 2)),
        idle_cold_s=float(rng.uniform(0, 80)) * int(rng.integers(0, 2)),
        min_idle_s=float(rng.uniform(0, 20)),
    )
    now = 100.0
    rss = int(rng.integers(0, 8 << 20))
    got = pick_demotions([DocStats(*r) for r in rows], StoreBudgets(**bud),
                         now=now, rss_bytes=rss)
    want = RS.pick_demotions([RS.DocStats(*r) for r in rows],
                             RS.StoreBudgets(**bud), now=now, rss_bytes=rss)
    assert [(d.name, d.to, d.reason) for d in got] == \
        [(d.name, d.to, d.reason) for d in want]
    assert PS.policy.tier_counts([DocStats(*r) for r in rows]) == \
        RS.policy.tier_counts([RS.DocStats(*r) for r in rows])


@pytest.mark.parametrize("runsnap_env", ["1", "0"])
def test_compact_on_demote_equals_reference(monkeypatch, runsnap_env):
    monkeypatch.setenv("AUTOMERGE_TPU_RUNSNAP", runsnap_env)
    rng = np.random.default_rng(int(runsnap_env))
    for _ in range(64):
        jb = int(rng.integers(0, 1 << 18))
        img = bool(rng.integers(0, 2))
        hist = int(rng.integers(0, 3))
        floor = int(rng.integers(0, 1 << 17))
        assert compact_on_demote(jb, img, hist, StoreBudgets(
            cold_compact_min_bytes=floor)) == RS.policy.compact_on_demote(
            jb, img, hist, RS.StoreBudgets(cold_compact_min_bytes=floor))


def test_budgets_from_env_equal_reference(monkeypatch):
    env = {
        "AUTOMERGE_TPU_STORE_HOT_DOCS": "3",
        "AUTOMERGE_TPU_STORE_WARM_BYTES": "12345",
        "AUTOMERGE_TPU_STORE_MAX_RSS": "999999",
        "AUTOMERGE_TPU_STORE_IDLE_COLD_S": "2.5",
        "AUTOMERGE_TPU_STORE_HYDRATIONS": "7",
        "AUTOMERGE_TPU_STORE_EVICT_INTERVAL": "0.25",
        "AUTOMERGE_TPU_STORE_COLD_COMPACT_MIN": "4096",
        "AUTOMERGE_TPU_STORE_MIN_IDLE": "0.75",
    }
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    import dataclasses

    assert dataclasses.asdict(StoreBudgets.from_env()) == \
        dataclasses.asdict(RS.StoreBudgets.from_env())
    assert StoreBudgets.from_env().active


# -- the store, both packages ---------------------------------------------------


def _store_facts(srv, obs_mod):
    tiers = {n: srv.store.tier(n) for n in srv.store.names()}
    gauges = {
        e["labels"]["tier"]: e["value"] for e in obs_mod.snapshot()
        if e["name"] == "store.tier" and e["type"] == "gauge"
    }
    moves = sorted(
        (e["name"], tuple(sorted(e["labels"].items())), e["value"])
        for e in obs_mod.snapshot()
        if e["type"] == "counter"
        and e["name"] in ("store.promotions", "store.demotions")
    )
    return tiers, gauges, moves


def _drive(srv):
    """One sequence of admissions, demotions, hydrations and promotions;
    the facts after every step."""
    out = []
    for name, mirror in (("a", True), ("b", False), ("c", True)):
        dd = srv.open(name, mirror=mirror, fsync="never")
        for i in range(3):
            dd.put("_root", f"{name}{i}", i)
            dd.commit(timestamp=i + 1)
    obs_mod = pobs if srv.port else robs
    out.append(_store_facts(srv, obs_mod))
    steps = [
        lambda: srv.store.demote("a", TIER_WARM),
        lambda: srv.store.ensure_open("a"),  # wants its mirror: promotes
        lambda: srv.store.demote("b", TIER_COLD),
        lambda: srv.store.ensure_open("b"),  # cold -> warm
        lambda: srv.store.demote("c", TIER_COLD),  # hot -> warm -> cold
        lambda: srv.store.ensure_open("c"),
        lambda: srv.store.touch("c"),  # warm, wants its mirror: hot
        lambda: srv.store.demote("b", "warm"),  # already warm: no move
    ]
    for step in steps:
        step()
        out.append(_store_facts(srv, obs_mod))
    # a hot budget that arrives late: the LRU hot documents go warm
    srv.store.budgets = StoreBudgets(hot_docs=1, min_idle_s=0.0,
                                     evict_interval_s=0.0)
    srv.store.touch("c")
    assert srv.store.maybe_evict() == 1
    out.append(_store_facts(srv, obs_mod))
    out.append(sorted(
        (n, norm_hydrate(srv.store.ensure_open(n).hydrate()))
        for n in srv.store.names()))
    return out


def norm_hydrate(h):
    return {k: (v if isinstance(v, (int, str)) else repr(v)) for k, v in h.items()}


def test_store_transitions_equal_reference(tmp_path):
    port = MiniServer(tmp_path / "port", port=True)
    ref = MiniServer(tmp_path / "ref", port=False)
    try:
        got, want = _drive(port), _drive(ref)
        assert got == want
        tiers = got[-2][0]
        assert tiers == {"a": TIER_WARM, "b": TIER_WARM, "c": TIER_HOT}
        assert port.opens == ref.opens
    finally:
        port.close()
        ref.close()


# -- the reference's store cases, ported ----------------------------------------


def _stats(*rows):
    return [DocStats(n, t, la, rb) for (n, t, la, rb) in rows]


def test_policy_hot_budget_demotes_lru_first():
    b = StoreBudgets(hot_docs=2, min_idle_s=0.0)
    st = _stats(("a", TIER_HOT, 1.0, 10), ("b", TIER_HOT, 3.0, 10),
                ("c", TIER_HOT, 2.0, 10), ("d", TIER_WARM, 0.5, 10))
    out = pick_demotions(st, b, now=10.0)
    assert [(d.name, d.to, d.reason) for d in out] == [
        ("a", TIER_WARM, "hot_budget")]


def test_policy_warm_bytes_goes_cold_until_under():
    b = StoreBudgets(warm_bytes=25, min_idle_s=0.0)
    st = _stats(("a", TIER_WARM, 1.0, 10), ("b", TIER_WARM, 2.0, 10),
                ("c", TIER_WARM, 3.0, 10))
    out = pick_demotions(st, b, now=10.0)
    assert [(d.name, d.to) for d in out] == [("a", TIER_COLD)]
    assert out[0].reason == "warm_budget"


def test_policy_rss_watermark_demotes_oldest_first():
    b = StoreBudgets(max_rss_bytes=100, min_idle_s=0.0)
    st = _stats(("a", TIER_WARM, 2.0, 30), ("b", TIER_HOT, 1.0, 30))
    out = pick_demotions(st, b, now=10.0, rss_bytes=160)
    assert [(d.name, d.to, d.reason) for d in out] == [
        ("b", TIER_COLD, "rss"), ("a", TIER_COLD, "rss")]


def test_policy_min_idle_floor_protects_recent_docs():
    b = StoreBudgets(warm_bytes=1, min_idle_s=5.0)
    st = _stats(("fresh", TIER_WARM, 9.0, 100), ("old", TIER_WARM, 1.0, 100))
    out = pick_demotions(st, b, now=10.0)
    assert [d.name for d in out] == ["old"]


def test_policy_idle_age_out_and_coldest_decision_wins():
    b = StoreBudgets(hot_docs=1, warm_bytes=5, idle_cold_s=4.0,
                     min_idle_s=0.0)
    st = _stats(("a", TIER_HOT, 1.0, 10), ("b", TIER_HOT, 8.0, 10))
    out = pick_demotions(st, b, now=10.0)
    by_name = {d.name: d for d in out}
    assert by_name["a"].to == TIER_COLD and by_name["a"].reason == "idle"
    assert by_name["b"].to == TIER_COLD


def test_policy_inactive_budgets_never_demote():
    st = _stats(("a", TIER_HOT, 0.0, 10**9))
    assert pick_demotions(st, StoreBudgets(), now=1e9) == []


def test_doc_gauges_removed_on_close(tmp_path):
    dd = PA.AutoDoc.open(str(tmp_path / "g1"), device="cpu", mirror=True)
    dd.put("_root", "k", 1)
    dd.commit()
    name = dd.obs_name
    assert any(
        e["name"] == "doc.journal_bytes" and e["labels"].get("doc") == name
        for e in pobs.snapshot()
    )
    assert any(
        e["name"] == "doc.device_bytes" and e["labels"].get("doc") == name
        for e in pobs.snapshot()
    )
    dd.close()
    assert not any(
        e["name"].startswith("doc.") and e["labels"].get("doc") == name
        for e in pobs.snapshot()
    )


@pytest.fixture
def server(tmp_path):
    s = MiniServer(tmp_path / "docs")
    yield s
    s.close()


def test_demote_hydrate_round_trip_byte_identical(server):
    s = server
    dd = s.open("rt")
    dd.put("_root", "k", 42)
    dd.commit()
    save1 = dd.save()
    assert s.store.demote("rt", TIER_COLD) == TIER_COLD
    assert isinstance(s._docs["rt"], ColdDocRef)
    assert s.doc("rt").get("_root", "k")[0][1].value == 42
    assert s.store.tier("rt") == TIER_WARM
    assert s.doc("rt").save() == save1


def test_cold_releases_flock(server):
    s = server
    dd = s.open("fl")
    dd.put("_root", "k", 1)
    dd.commit()
    s.store.demote("fl", TIER_COLD)
    other = PA.AutoDoc.open(s._durable_path("fl"), device="cpu")
    assert other.get("_root", "k") is not None
    other.close()
    assert isinstance(s._docs["fl"], ColdDocRef)


def test_hot_tier_device_mirror_drops_and_rebuilds(server):
    s = server
    dd = s.open("dev", mirror=True)
    dd.put("_root", "k", 5)
    dd.commit()
    assert s.store.tier("dev") == TIER_HOT
    assert dd.device_doc is not None
    assert s.store.demote("dev", TIER_WARM) == TIER_WARM
    assert dd.device_doc is None
    assert not any(
        e["name"] in ("doc.resident_ops", "doc.device_bytes")
        and e["labels"].get("doc") == "dev"
        for e in pobs.snapshot()
    )
    # access promotes back to hot (it wants its mirror, no hot budget)
    assert s.doc("dev").hydrate() == {"k": 5}
    assert s.store.tier("dev") == TIER_HOT
    dev = s._docs["dev"].device_doc
    assert dev is not None and dev.device.type == "cpu"
    assert dev.hydrate() == {"k": 5}
    assert s.store.status()["tiers"] == {"hot": 1, "warm": 0, "cold": 0}


def test_mutation_on_evicted_instance_is_retriable(server):
    from automerge_tpu_torch.storage.durable import DocumentEvicted

    s = server
    dd = s.open("ev")
    dd.put("_root", "k", 1)
    dd.commit()
    s.store.demote("ev", TIER_COLD)
    assert dd.get("_root", "k") is not None  # reads serve
    with pytest.raises(DocumentEvicted):
        dd.put("_root", "k", 2)
    with pytest.raises(DocumentEvicted):
        dd.commit()
    assert DocumentEvicted.retriable is True
    s.doc("ev").put("_root", "k", 3)  # the re-resolved handle hydrates
    s.doc("ev").commit()


def test_single_flight_hydration_opens_exactly_once(server):
    s = server
    dd = s.open("sf")
    dd.put("_root", "k", 3)
    dd.commit()
    s.store.demote("sf", TIER_COLD)
    opens = []
    orig = s.open_cold

    def slow_open(name):
        opens.append(name)
        time.sleep(0.05)
        return orig(name)

    s.open_cold = slow_open
    results, errors = [], []

    def reader():
        try:
            results.append(s.doc("sf").hydrate()["k"])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=reader) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors
    assert results == [3] * 8
    assert opens == ["sf"], "stampede must hydrate exactly once"


def test_hydration_backpressure_is_retriable(server):
    s = server
    for n in ("bp1", "bp2"):
        dd = s.open(n)
        dd.put("_root", "k", 1)
        dd.commit()
        s.store.demote(n, TIER_COLD)
    s.store._hydrations = threading.Semaphore(1)
    orig = s.open_cold
    entered = threading.Event()

    def slow_open(name):
        entered.set()
        time.sleep(0.2)
        return orig(name)

    s.open_cold = slow_open
    out = {}
    t1 = threading.Thread(target=lambda: out.setdefault("bp1", s.doc("bp1")))
    t1.start()
    entered.wait(5)
    with pytest.raises(StoreBackpressure):
        s.doc("bp2")
    t1.join()
    assert StoreBackpressure.retriable is True
    assert out["bp1"].hydrate() == {"k": 1}
    assert s.doc("bp2").hydrate() == {"k": 1}  # the slot freed


def test_cold_open_salvages_damaged_snapshot(server):
    s = server
    dd = s.open("sv")
    dd.put("_root", "early", "snap")
    dd.commit()
    dd.compact()
    dd.put("_root", "late", "tail")
    dd.commit()
    s.store.demote("sv", TIER_COLD)  # tiny journal: closes, no compact
    snap = os.path.join(s._durable_path("sv"), "snapshot.am")
    with open(snap, "ab") as f:
        f.write(b"\x00garbage-chunk-tail\xff" * 8)
    before = pobs.legacy_counters.get("load.salvaged_chunks", 0)
    doc = s.doc("sv")
    assert doc.hydrate() == {"early": "snap", "late": "tail"}
    assert pobs.legacy_counters.get("load.salvaged_chunks", 0) > before


def test_budgets_drive_eviction_and_counters(server):
    s = server
    for i in range(4):
        dd = s.open(f"bd{i}")
        dd.put("_root", "k", i)
        dd.commit()
    s.store.budgets = StoreBudgets(
        hot_docs=1, warm_bytes=1, min_idle_s=0.0, evict_interval_s=0.0)
    s.store.maybe_evict()
    status = s.store.status()
    assert status["tiers"]["cold"] == 4, status
    demos = [e for e in pobs.snapshot()
             if e["name"] == "store.demotions" and e["type"] == "counter"]
    assert demos and all(
        set(e["labels"]) == {"from", "to", "reason"} for e in demos)
    s.store.budgets = StoreBudgets(evict_interval_s=0.0)
    for i in range(4):
        assert s.doc(f"bd{i}").hydrate() == {"k": i}
    tiers = {e["labels"]["tier"]: e["value"] for e in pobs.snapshot()
             if e["name"] == "store.tier" and e["type"] == "gauge"}
    assert sum(tiers.values()) == 4
