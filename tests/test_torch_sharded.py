"""The sharded merge (K11) of the port against the JAX package's.

The same padded columns (from the JAX package's OpLog) go through the
JAX ``sharded_merge_columns`` on the virtual CPU mesh of
``tests/conftest.py`` and the port's on a mesh of CPU shards
(``["cpu"] * n``, the plain PyTorch versions of its kernels and its own
collectives). All 13 outputs must be equal, exactly: everything is
int32/bool. The JAX package takes its condensed arm whenever its native
library loads, as it does here; the port's two arms both meet it.

Also: the port's host passes (``host_forest``, ``chain_condense``,
``condense_host``) against the JAX package's and its native library; the
collectives' volume against the reference test's own bounds
(``tests/test_sharded_merge.py:234-242``) on a fan-in that condenses; and
a resident document whose full re-resolve runs over the mesh, against
the JAX package's and a single-device one.
"""

import contextlib
import functools
import types

import jax
import numpy as np
import pytest
import torch

import automerge_tpu.parallel.sharding as JS
from automerge_tpu import bench as JB
from automerge_tpu import native as JN
from automerge_tpu.api import AutoDoc
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.ops.oplog import host_forest as j_host_forest
from automerge_tpu.parallel import default_mesh as j_default_mesh
from automerge_tpu.parallel import make_sharded_merge as j_make_sharded_merge
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu.types import ActorId, ObjType, ScalarValue
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.kernels import linearize as L
from automerge_tpu_torch.kernels.collectives import mesh_reduce, mesh_reduce_plain
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.merge import ALL_OUTPUTS, merge_columns
from automerge_tpu_torch.ops.oplog import OpLog, host_forest
from automerge_tpu_torch.parallel import (
    Mesh, default_mesh, make_sharded_merge, sharded_merge_columns,
)
from automerge_tpu_torch.parallel import collectives as C
from automerge_tpu_torch.parallel import sharding as PS
from automerge_tpu_torch.parallel.condense import chain_condense


def _actor(i):
    return ActorId(bytes([i]) * 16)


def _cpu_mesh(n):
    return default_mesh(n, devices=["cpu"] * n)


def _j_cols(log, covered=None):
    return log.padded_columns(covered=covered), log.n_objs, len(log.props)


def _forks():
    """tests/test_sharded_merge.py::test_sharded_matches_single_device."""
    base = AutoDoc(actor=_actor(1))
    t = base.put_object("_root", "t", ObjType.TEXT)
    base.splice_text(t, 0, 0, "shared base text")
    base.put("_root", "count", ScalarValue("counter", 0))
    base.commit()
    forks = [base.fork(actor=_actor(10 + i)) for i in range(4)]
    for i, f in enumerate(forks):
        f.splice_text(t, i, 2, f"[{i}]")
        f.increment("_root", "count", i + 1)
        f.commit()
    return _j_cols(JOpLog.from_documents(forks))


def _marks_log():
    """tests/test_sharded_merge.py::test_sharded_marks_and_historical."""
    base = AutoDoc(actor=_actor(1))
    t = base.put_object("_root", "t", ObjType.TEXT)
    base.splice_text(t, 0, 0, "the quick brown fox jumps")
    base.put("_root", "n", ScalarValue("counter", 10))
    base.commit()
    forks = [base.fork(actor=_actor(20 + i)) for i in range(3)]
    forks[0].mark(t, 0, 9, "bold", True)
    forks[0].increment("_root", "n", 5)
    forks[0].commit()
    forks[1].mark(t, 4, 15, "italic", True, expand="both")
    forks[1].splice_text(t, 10, 5, "red")
    forks[1].commit()
    forks[2].delete("_root", "n")
    forks[2].splice_text(t, 0, 3, "a")
    forks[2].commit()
    return JOpLog.from_documents(forks)


def _marks():
    return _j_cols(_marks_log())


def _marks_historical():
    # the clock cut at half the log's ops: a partial covered mask
    log = _marks_log()
    covered = np.zeros(log.n, np.bool_)
    covered[: log.n // 2] = True
    return _j_cols(log, covered)


def _bench_fanin():
    """tests/test_sharded_merge.py::test_sharded_packed_transport's fan-in."""
    trace = JB.load_trace(6_000)
    base = JB.build_base(trace, 3_000)
    changes = list(base.changes) + JB.synth_fanin(base, trace, 16, 100, 3_000)
    return _j_cols(JOpLog.from_changes(changes))


def _sort_fallback():
    """tests/test_sharded_merge.py::test_sharded_sort_fallback_path: a
    sparse obj x prop space past the dense group table's gate."""
    doc = AutoDoc(actor=_actor(9))
    for i in range(200):
        o = doc.put_object("_root", f"o{i}", ObjType.MAP)
        doc.put(o, f"p{i}a", i)
        doc.put(o, f"p{i}b", -i)
    doc.commit()
    return _j_cols(JOpLog.from_documents([doc]))


def _typing_fanin():
    trace = W.typing_trace(2_000)
    base = W.build_base(trace, 1_500)
    changes = base.changes + W.synth_fanin(base, trace, 6, 40, 0)
    return _j_cols(JOpLog.from_changes(
        [j_parse_change(c.raw_bytes)[0] for c in changes]))


def _no_sequence():
    # map puts only: no element, R = 0 chains
    doc = AutoDoc(actor=_actor(5))
    for i in range(40):
        doc.put("_root", f"k{i % 7}", i)
    doc.commit()
    return _j_cols(JOpLog.from_documents([doc]))


def _reference_fault():
    """ROADMAP §3: two map puts whose prop ids the JAX packed key merges
    (props 64 and 0, P = 16), without n_props."""
    cols = {
        "action": np.array([1, 1], np.int32), "insert": np.zeros(2, bool),
        "prop": np.array([64, 0], np.int32),
        "elem_ref": np.array([-2, -2], np.int32),
        "obj_dense": np.array([0, 1], np.int32),
        "value_tag": np.array([4, 4], np.int32),
        "value_i32": np.zeros(2, np.int32), "width": np.ones(2, np.int32),
        "covered": np.ones(2, bool), "pred_src": np.zeros(0, np.int32),
        "pred_tgt": np.zeros(0, np.int32),
    }
    from automerge_tpu.ops.oplog import pad_columns as j_pad_columns

    return j_pad_columns(cols, 2), 2, None


WORKLOADS = {
    "forks": _forks,
    "marks": _marks,
    "marks_historical": _marks_historical,
    "bench_fanin": _bench_fanin,
    "sort_fallback": _sort_fallback,
    "typing_fanin": _typing_fanin,
    "no_sequence": _no_sequence,
    "reference_fault": _reference_fault,
}


@functools.lru_cache(maxsize=None)
def _workload(name):
    return WORKLOADS[name]()


@functools.lru_cache(maxsize=None)
def _jax_sharded(name, n):
    cols, n_objs, n_props = _workload(name)
    return JS.sharded_merge_columns(cols, j_default_mesh(n), n_objs=n_objs,
                                    n_props=n_props)


def _assert_outputs_equal(got, want, where):
    for k in ALL_OUTPUTS:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} {k}")


@pytest.mark.parametrize("transport", PS.TRANSPORTS)
@pytest.mark.parametrize("linearize", PS.LINEARIZE)
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_sharded_merge_equals_jax(name, n, linearize, transport):
    cols, n_objs, n_props = _workload(name)
    got = sharded_merge_columns(cols, _cpu_mesh(n), n_objs=n_objs,
                                n_props=n_props, transport=transport,
                                linearize=linearize)
    _assert_outputs_equal(got, _jax_sharded(name, n), f"{name} n={n}")


@pytest.mark.parametrize("name", ["forks", "marks", "bench_fanin", "sort_fallback",
                                  "typing_fanin"])
def test_sharded_merge_equals_single_device(name):
    """The port's sharded merge and its single-device merge agree on all
    13 outputs (the per-object stats to the single-device length)."""
    cols, n_objs, n_props = _workload(name)
    got = sharded_merge_columns(cols, _cpu_mesh(4), n_objs=n_objs, n_props=n_props)
    want = merge_columns(cols, n_objs=n_objs, n_props=n_props, device="cpu")
    for k in ALL_OUTPUTS:
        m = len(want[k])
        np.testing.assert_array_equal(got[k][:m], want[k], err_msg=k)


def test_reference_fault_input_gives_the_dict_winners():
    cols, n_objs, n_props = _workload("reference_fault")
    for transport in PS.TRANSPORTS:
        got = sharded_merge_columns(cols, _cpu_mesh(2), n_objs=n_objs,
                                    n_props=n_props, transport=transport)
        assert list(got["winner"][:2]) == [0, 1], transport
        assert list(got["conflicts"][:2]) == [1, 1], transport


@pytest.mark.parametrize("side", ["at", "past"])
def test_geometry_at_the_sharded_gate(side):
    """n_objs2 * n_props exactly at the sharded gate (8 P + 65536: the
    scatter winners) and one map key past it (the sort-based ones). The
    single-device merge buckets the geometry before its gate and takes
    the sort-based winners on both sides; all outputs agree, and equal
    the JAX package's sharded merge."""
    cols, n_objs, _ = _workload("forks")
    P = len(cols["action"])
    n_props = (8 * P + 65536) // (n_objs + 2) + (side == "past")
    assert (8 * P + 65536) % (n_objs + 2) == 0
    assert PS.sharded_gate(P, n_objs + 2, n_props) == (side == "at")
    got = sharded_merge_columns(cols, _cpu_mesh(4), n_objs=n_objs, n_props=n_props)
    want = JS.sharded_merge_columns(cols, j_default_mesh(4), n_objs=n_objs,
                                    n_props=n_props)
    _assert_outputs_equal(got, want, side)
    single = merge_columns(cols, n_objs=n_objs, n_props=n_props, device="cpu")
    for k in ALL_OUTPUTS:
        m = len(single[k])
        np.testing.assert_array_equal(got[k][:m], single[k], err_msg=k)


def test_make_sharded_merge_equals_jax():
    cols, _, _ = _workload("bench_fanin")
    got = make_sharded_merge(_cpu_mesh(4))(cols)
    want = j_make_sharded_merge(j_default_mesh(4))(
        {k: jax.numpy.asarray(v) for k, v in cols.items()})
    assert set(got) == set(ALL_OUTPUTS)
    for k in ALL_OUTPUTS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_rows_that_do_not_divide_over_the_mesh_raise():
    cols, n_objs, n_props = _workload("forks")
    with pytest.raises(ValueError, match="divide evenly"):
        sharded_merge_columns(cols, _cpu_mesh(3), n_objs=n_objs, n_props=n_props)
    with pytest.raises(ValueError, match="transport"):
        sharded_merge_columns(cols, _cpu_mesh(2), transport="runs")
    with pytest.raises(ValueError, match="linearize"):
        sharded_merge_columns(cols, _cpu_mesh(2), linearize="host")


# -- the host passes ------------------------------------------------------------


@pytest.mark.parametrize("name", ["forks", "marks", "bench_fanin", "typing_fanin",
                                  "no_sequence"])
def test_host_forest_and_chain_condense_equal_the_reference(name):
    cols, n_objs, _ = _workload(name)
    ours, theirs = host_forest(cols), j_host_forest(cols)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    insert, parent_row, first_child, next_sib = ours
    P = len(insert)
    R, got = chain_condense(first_child, next_sib, parent_row, insert, P, n_objs + 2)
    R_ref, want = JN.chain_condense(first_child, next_sib, parent_row, insert, P,
                                    n_objs + 2)
    assert R == R_ref
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _forest(P, parent, first_child, next_sib, n_objs=1):
    N = 2 * P + 3
    fc = np.full(N, -1, np.int32)
    ns = np.full(N, -1, np.int32)
    fc[: len(first_child)] = first_child
    ns[: len(next_sib)] = next_sib
    return fc, ns, np.asarray(parent, np.int32), np.ones(P, bool), P, n_objs


MALFORMED = {
    # 0 -> 1 -> 2 -> 1 along first children: the walk from 0 meets 1 twice
    "first_child_cycle": _forest(4, [4, 0, 1, 2], [1, 2, 1, -1], []),
    # 1 and 2 each other's parent and first child: no walk reaches them
    "unreached_elements": _forest(3, [3, 2, 1], [-1, 2, 1], []),
    # the walk from 0 runs into 2, which heads a chain of its own
    "walk_into_a_head": _forest(3, [3, 0, 3], [1, 2, -1], []),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_chain_condense_raises_where_the_native_walk_fails(name):
    args = MALFORMED[name]
    with pytest.raises(ValueError):
        JN.chain_condense(*args)
    with pytest.raises(ValueError):
        chain_condense(*args)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["forks", "typing_fanin", "no_sequence"])
def test_condense_host_equals_the_reference(name, n):
    cols, n_objs, _ = _workload(name)
    R2, got = PS.condense_host(cols, n_objs + 2, n)
    R2_ref, want = JS.condense_host(cols, n_objs + 2, n)
    assert R2 == R2_ref and R2 % n == 0
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the collectives ------------------------------------------------------------


def test_mesh_reduce_plain_wraps_and_maxes():
    big = np.iinfo(np.int32).max
    stack = torch.tensor([[big, -5, 7], [1, -(1 << 31), 3], [big, 2, -1]],
                         dtype=torch.int32)
    # 2 * (2^31 - 1) + 1 and -2^31 - 3 wrap
    assert mesh_reduce(stack, "sum").tolist() == [-1, (1 << 31) - 3, 9]
    assert mesh_reduce(stack, "max").tolist() == [big, 2, 7]
    assert torch.equal(mesh_reduce(stack, "sum"), mesh_reduce_plain(stack, "sum"))
    with pytest.raises(ValueError):
        mesh_reduce(stack, "min")


def test_collectives_on_a_mesh_with_a_repeated_device():
    mesh = _cpu_mesh(3)
    assert mesh.size == 3 and mesh.distinct == (torch.device("cpu"),)
    parts = [torch.arange(4, dtype=torch.int32) * (i + 1) for i in range(3)]
    C.reset_stats()
    full = C.all_gather(mesh, parts)[torch.device("cpu")]
    assert full.tolist() == [0, 1, 2, 3, 0, 2, 4, 6, 0, 3, 6, 9]
    assert C.psum(mesh, parts)[torch.device("cpu")].tolist() == [0, 6, 12, 18]
    assert C.pmax(mesh, parts)[torch.device("cpu")].tolist() == [0, 3, 6, 9]
    assert C.gathers == [(4, 3 * 4 * 4)]
    assert {k: v["calls"] for k, v in C.stats.items()} == {
        "all_gather": 1, "psum": 1, "pmax": 1}
    assert C.stats["all_gather"]["bytes"] == 3 * 4 * 4


def test_launch_makes_the_streams_card_current(monkeypatch):
    """A kernel launches on the current device, so ``launch`` makes the
    card of the stream it passes the current device for the call: a
    shard's kernels on cuda:2 launch there whatever card the caller had
    current, and the caller's card is current again afterwards."""
    from automerge_tpu_torch.kernels import _build
    from automerge_tpu_torch.kernels._args import Stream

    current, calls = ["cuda:0"], []

    @contextlib.contextmanager
    def device(d):
        prev, current[0] = current[0], str(d)
        try:
            yield
        finally:
            current[0] = prev

    class Entry:
        argtypes = None

        def __call__(self, *args):
            calls.append((current[0], args[:-1]))
            args[-1]._obj.value = 3
            return 0

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(amt_fake=Entry()))
    monkeypatch.setattr(torch.cuda, "device", device)
    n = _build.launch("amt_fake", [_build.P_, _build.I_, _build.P_],
                      11, 5, Stream(77, torch.device("cuda", 2)))
    assert n == 3
    assert calls == [("cuda:2", (11, 5, 77))]
    assert current == ["cuda:0"]


def test_linearize_range_rounds_tile_the_full_round():
    """A doubling round over slices of the nodes, concatenated, is the
    round over all of them (the node count not a multiple of the slice)."""
    rng = np.random.default_rng(3)
    E = 37
    ans = torch.from_numpy(rng.integers(-1, E, E).astype(np.int32))
    done = torch.from_numpy(rng.random(E) < 0.4)
    jump = torch.from_numpy(rng.integers(0, E + 3, E).astype(np.int32))
    full = L.linearize_thread(ans, done, jump, 0, E)
    parts = [L.linearize_thread(ans, done, jump, i0, min(10, E - i0))
             for i0 in range(0, E, 10)]
    for k in range(3):
        assert torch.equal(torch.cat([p[k] for p in parts]), full[k])
    full = L.linearize_rank(ans, jump, 0, E)
    parts = [L.linearize_rank(ans, jump, i0, min(10, E - i0)) for i0 in range(0, E, 10)]
    for k in range(2):
        assert torch.equal(torch.cat([p[k] for p in parts]), full[k])


def test_linearize_collectives_scale_with_chains_not_rows():
    """The reference test's four assertions on the collectives
    (tests/test_sharded_merge.py:234-242), on the port's recorded
    all_gathers over a typing fan-in that condenses (R2 = 512 chain
    slots of P = 8192 rows): every doubling round gathers chain-sized
    slices, only the winners' two and the final expansion gather rows.
    The JAX package traces each doubling loop's body once, so its list
    holds each round's gathers once: the port's is that list with each
    loop's gathers repeated ceil_log2(R2) + 1 times."""
    trace = W.typing_trace(8_000)
    base = W.build_base(trace, 6_000)
    changes = base.changes + W.synth_fanin(base, trace, 8, 200, 0)
    log = OpLog.from_changes(changes)
    cols = log.padded_columns()
    Ptot = len(cols["action"])
    n = 4
    R2, _ = PS.condense_host(cols, log.n_objs + 2, n)
    assert R2 <= Ptot // 4, "workload must actually condense"

    C.reset_stats()
    res = sharded_merge_columns(cols, _cpu_mesh(n), n_objs=log.n_objs,
                                n_props=len(log.props))
    gathered = [length for length, _ in C.gathers]
    want = merge_columns(cols, n_objs=log.n_objs, n_props=len(log.props), device="cpu")
    for k in ALL_OUTPUTS:
        m = len(want[k])
        np.testing.assert_array_equal(res[k][:m], want[k], err_msg=k)

    Rl, Pl = R2 // n, Ptot // n
    small = [s for s in gathered if s <= Rl]
    big = [s for s in gathered if s >= Pl]
    assert small, "condensed doubling ran no chain-sized collectives"
    assert len(big) <= 4, (len(big), sorted(set(gathered)))
    assert all(s <= Rl or s >= Pl for s in gathered), sorted(set(gathered))
    assert Rl * 8 < Pl, (Rl, Pl)

    # the JAX package's all_gather shapes on the same columns
    shapes = []
    orig = jax.lax.all_gather

    def spy(x, axis_name, **kw):
        shapes.append(tuple(x.shape))
        return orig(x, axis_name, **kw)

    JS._make_sharded_fn.cache_clear()
    jax.lax.all_gather = spy
    try:
        JS.sharded_merge_columns(cols, j_default_mesh(n), n_objs=log.n_objs,
                                 n_props=len(log.props))
    finally:
        jax.lax.all_gather = orig
        JS._make_sharded_fn.cache_clear()
    rounds = L.ceil_log2(R2) + 1
    # winner, conflicts | climb: ans, done, jump | rank: dist, nxt | ranks
    assert [s[0] for s in shapes] == [Pl, Pl, Rl, Rl, Rl, Rl, Rl, Pl]
    expect = ([Pl, Pl] + [Rl] * 3 * rounds + [Rl] * 2 * rounds + [Pl])
    assert gathered == expect
    # each round copies R2 values of ans, done and jump (climb) or of dist
    # and nxt (rank) into the one device's buffers: O(R2), not O(P)
    small_bytes = sum(b for length, b in C.gathers if length == Rl)
    assert small_bytes == rounds * R2 * (4 + 1 + 4 + 4 + 4)
    assert C.stats["all_gather"]["calls"] == len(expect)


# -- mesh residency -------------------------------------------------------------


def _text_fanin_with_delta():
    """A text fan-in and one more replica's change: its ops interleave
    with the others' in Lamport order (not a tail append), so the delta
    goes to _reresolve, and the text object holds most rows (the full
    branch)."""
    trace = W.load_trace(1_400)
    base = W.build_base(trace, 1_000)
    reps = W.synth_fanin(base, trace, 9, 30, 1_000)
    start = [c.raw_bytes for c in base.changes + reps[:-1]]
    return start, [reps[-1].raw_bytes], base


def test_mesh_full_reresolve_equals_a_single_device_document(monkeypatch):
    """A port document with a mesh of two CPU shards takes a delta whose
    full re-resolve runs over the mesh (asserted by spies: the full
    branch, then the sharded merge); it then equals a single-device port
    document and the JAX package's single-device document given the same
    changes, on every READ_FETCH array and the text. The JAX package's
    own mesh document takes the same branch over its mesh of two and
    disagrees in ``elem_index``: it permutes the rows by ``_rows_by_obj``,
    which is not row-ascending within an object after this splice
    (ROADMAP §3)."""
    start, delta, base = _text_fanin_with_delta()
    j_start = [j_parse_change(b)[0] for b in start]
    j_delta = [j_parse_change(b)[0] for b in delta]
    doc = DeviceDoc.merge(start, device="cpu")
    single = DeviceDoc.merge(start, device="cpu")
    mesh = doc.enable_mesh(devices=["cpu"] * 2, min_rows=0)
    assert isinstance(mesh, Mesh) and mesh.size == 2
    jref = JDeviceDoc.resolve(JOpLog.from_changes(j_start))
    jdoc = JDeviceDoc.resolve(JOpLog.from_changes(j_start))
    assert jdoc.enable_mesh(2, min_rows=0)

    ran = {"port": [], "jax": [], "full": []}
    inner, j_inner = DeviceDoc._mesh_resolve_inner, JDeviceDoc._mesh_resolve_inner
    reresolve = DeviceDoc._reresolve

    def spy(self):
        ran["port"].append(self is doc)
        return inner(self)

    def j_spy(self):
        out = j_inner(self)
        ran["jax"].append(out is not None)
        return out

    def spy_reresolve(self, dirty):
        rows = self._subset_rows(np.asarray(dirty, np.int64))
        ran["full"].append(len(rows) / self.log.n > 0.5)
        return reresolve(self, dirty)

    monkeypatch.setattr(DeviceDoc, "_mesh_resolve_inner", spy)
    monkeypatch.setattr(JDeviceDoc, "_mesh_resolve_inner", j_spy)
    monkeypatch.setattr(DeviceDoc, "_reresolve", spy_reresolve)
    C.reset_stats()
    assert doc.apply_changes(delta) == 1
    assert single.apply_changes(delta) == 1
    assert jref.apply_changes(j_delta) == 1
    assert jdoc.apply_changes(j_delta) == 1
    # the full branch ran in both port documents, over the mesh in one;
    # the JAX mesh document's sharded merge ran and returned
    assert ran == {"port": [True], "jax": [True], "full": [True, True]}
    assert C.stats["all_gather"]["calls"] > 0

    n = doc.log.n
    for k in DeviceDoc.READ_FETCH:
        cut = doc.log.n_objs + 2 if k.startswith("obj_") else n
        a = np.asarray(doc.res[k])[:cut]
        np.testing.assert_array_equal(a, np.asarray(single.res[k])[:cut], err_msg=k)
        np.testing.assert_array_equal(a, np.asarray(jref.res[k])[:cut], err_msg=k)
    text = doc.text(base.text_exid)
    assert text == single.text(base.text_exid) == jref.text(base.text_exid)
    assert not np.array_equal(jdoc.res["elem_index"][:n], jref.res["elem_index"][:n])
    rbo = np.asarray(jdoc._rows_by_obj)
    same_obj = np.diff(jdoc.log.obj_dense[rbo]) == 0
    assert np.any(np.diff(rbo)[same_obj] < 0)

    doc.disable_mesh()
    assert doc._mesh_resolve() is None


def test_mesh_survives_a_rebuild_and_raises_instead_of_falling_back():
    start, delta, _ = _text_fanin_with_delta()
    doc = DeviceDoc.merge(start, device="cpu")
    doc.enable_mesh(devices=["cpu"] * 2, min_rows=10**9)
    assert doc._mesh_resolve() is None  # under min_rows
    doc.apply_changes(delta, incremental=False)  # a rebuild keeps the mesh
    assert doc._mesh is not None and doc._mesh_min_rows == 10**9
    # a mesh the rows do not divide over raises: no single-device fallback
    doc.enable_mesh(devices=["cpu"] * 3, min_rows=0)
    with pytest.raises(ValueError, match="divide evenly"):
        doc._mesh_resolve()


def test_enable_mesh_without_enough_cards_raises(monkeypatch):
    doc = DeviceDoc.merge(_text_fanin_with_delta()[0][:1], device="cpu")
    with pytest.raises(ValueError, match="two shards"):
        doc.enable_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match="need 4 devices"):
        doc.enable_mesh(4, devices=["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        doc.enable_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh(4)
    with pytest.raises(RuntimeError):
        default_mesh(devices=["cuda"] * 4)
    assert doc._mesh is None
