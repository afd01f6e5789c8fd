"""The chain-condensed document order (K8) of the port against the JAX
package.

The same change bytes go through both packages: the workloads of
``tests/test_condensed_linearize.py`` (documents made by the JAX
``AutoDoc``), a small bench fan-in and a small typing-trace fan-in. The
port's ``merge_kernel_condensed`` (plain PyTorch on the CPU) must give the
JAX ``merge_kernel_condensed(rcap)``'s 13 outputs, and the ``elem_index``
of the JAX ``merge_kernel`` and of the JAX ``obj_cap`` arm (the port has
no ``obj_cap``: its winner key needs none). All of it is int32/bool:
tolerance 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from automerge_tpu import bench as JB
from automerge_tpu.api import AutoDoc
from automerge_tpu.ops import extract as JX
from automerge_tpu.ops import merge as J
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.ops.oplog import pad_columns as j_pad_columns
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu.types import ActorId, ObjType
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.convert import columns_from_numpy
from automerge_tpu_torch.kernels import linearize_condensed as LC
from automerge_tpu_torch.ops.merge import (
    ALL_OUTPUTS, condensed_caps, merge_kernel_condensed,
)
from automerge_tpu_torch.ops.oplog import OpLog, pad_columns
from automerge_tpu_torch.storage.change import parse_change

from .test_torch_random_docs import _history


@pytest.fixture(autouse=True)
def cold_jax_change_cache(monkeypatch):
    """Each test starts with the JAX package's per-change-hash extraction
    cache empty, so both packages number map keys alike (ROADMAP §3)."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)


def _blobs(*docs):
    seen, out = set(), []
    for d in docs:
        for a in d.doc.history:
            if a.stored.hash not in seen:
                seen.add(a.stored.hash)
                out.append(a.stored.raw_bytes)
    return out


def _typing_chain():
    d = AutoDoc(actor=ActorId(bytes([1]) * 16))
    t = d.put_object("_root", "t", ObjType.TEXT)
    d.splice_text(t, 0, 0, "hello world, this is a chain")
    d.commit()
    return _blobs(d)


def _interleaved_actors_and_deletes():
    a = AutoDoc(actor=ActorId(bytes([1]) * 16))
    t = a.put_object("_root", "t", ObjType.TEXT)
    a.splice_text(t, 0, 0, "base text for everyone")
    a.commit()
    forks = [a.fork(actor=ActorId(bytes([10 + i]) * 16)) for i in range(6)]
    rng = np.random.default_rng(7)
    for f in forks:
        for _ in range(20):
            ln = f.length(t)
            pos = int(rng.integers(0, ln + 1))
            ndel = int(rng.integers(0, min(2, ln - pos) + 1))
            f.splice_text(t, pos, ndel, "ab"[: int(rng.integers(0, 3))])
        f.commit()
    for f in forks:
        a.merge(f)
    return _blobs(a)


def _multiple_sequence_objects():
    d = AutoDoc(actor=ActorId(bytes([2]) * 16))
    t1 = d.put_object("_root", "t1", ObjType.TEXT)
    t2 = d.put_object("_root", "t2", ObjType.TEXT)
    lst = d.put_object("_root", "l", ObjType.LIST)
    d.splice_text(t1, 0, 0, "first object")
    d.splice_text(t2, 0, 0, "second")
    for i in range(10):
        d.insert(lst, i, i)
    d.commit()
    d.splice_text(t1, 5, 3, "X")
    d.delete(lst, 2)
    d.commit()
    return _blobs(d)


def _prepend_heavy():
    # every insert at position 0: each element is its own run
    d = AutoDoc(actor=ActorId(bytes([3]) * 16))
    t = d.put_object("_root", "t", ObjType.TEXT)
    for i in range(60):
        d.splice_text(t, 0, 0, chr(ord("a") + i % 26))
    d.commit()
    return _blobs(d)


def _cross_change_continuation():
    d = AutoDoc(actor=ActorId(bytes([4]) * 16))
    t = d.put_object("_root", "t", ObjType.TEXT)
    for w in ("alpha ", "beta ", "gamma ", "delta"):
        d.splice_text(t, d.length(t), 0, w)
        d.commit()
    return _blobs(d)


def _randomized_forest(trial):
    rng = np.random.default_rng([42, trial])
    a = AutoDoc(actor=ActorId(bytes([1]) * 16))
    t = a.put_object("_root", "t", ObjType.TEXT)
    a.splice_text(t, 0, 0, "seed")
    a.commit()
    forks = [a.fork(actor=ActorId(bytes([20 + i]) * 16)) for i in range(4)]
    for f in forks:
        for _ in range(int(rng.integers(5, 40))):
            ln = f.length(t)
            pos = int(rng.integers(0, ln + 1))
            ndel = int(rng.integers(0, min(3, ln - pos) + 1))
            f.splice_text(t, pos, ndel, "xyz"[: int(rng.integers(0, 4))])
        f.commit()
    for f in forks:
        a.merge(f)
    return _blobs(a)


def _map_only():
    # no sequence object: an empty actor order, one run
    d = AutoDoc(actor=ActorId(bytes([5]) * 16))
    for i in range(12):
        d.put("_root", f"k{i % 5}", i)
    d.commit()
    return _blobs(d)


def _bench_fanin():
    trace = JB.load_trace(3000)
    base = JB.build_base(trace, 2000)
    reps = JB.synth_fanin(base, trace, 16, 125, 2000)
    return [c.raw_bytes for c in base.changes + reps]


def _typing_fanin():
    trace = W.typing_trace(3000, seed=5)
    base = W.build_base(trace, 2000)
    reps = W.synth_fanin(base, trace, 16, 125, 2000)
    return [c.raw_bytes for c in base.changes + reps]


WORKLOADS = {
    "typing_chain": _typing_chain,
    "interleaved_actors_and_deletes": _interleaved_actors_and_deletes,
    "multiple_sequence_objects": _multiple_sequence_objects,
    "prepend_heavy": _prepend_heavy,
    "cross_change_continuation": _cross_change_continuation,
    **{f"randomized_forest_{i}": functools.partial(_randomized_forest, i)
       for i in range(4)},
    "map_only": _map_only,
    "bench_fanin": _bench_fanin,
    "typing_fanin": _typing_fanin,
    # the seeded random documents: nested maps, lists and text, several
    # text objects, concurrent inserts and deletes
    **{f"history_{s}": functools.partial(lambda s: sum(_history(s), []), s)
       for s in range(3)},
}


@functools.lru_cache(maxsize=None)
def _blobs_of(name):
    return WORKLOADS[name]()


def _logs(name):
    blobs = _blobs_of(name)
    jlog = JOpLog.from_changes([j_parse_change(b)[0] for b in blobs])
    tlog = OpLog.from_changes([parse_change(b)[0] for b in blobs])
    return jlog, tlog


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_actor_order_and_caps_equal_jax(name):
    jlog, tlog = _logs(name)
    np.testing.assert_array_equal(tlog.actor_order(), jlog.actor_order())
    assert tlog.actor_order().dtype == jlog.actor_order().dtype
    assert tlog.condensed_run_count() == jlog.condensed_run_count()
    assert condensed_caps(tlog) == J.condensed_caps(jlog)[0]
    jc = jlog.padded_columns(include_aorder=True)
    tc = tlog.padded_columns(include_aorder=True)
    assert set(tc) == set(jc)
    for k in jc:
        assert tc[k].dtype == jc[k].dtype, k
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_condensed_merge_equals_jax(name):
    jlog, tlog = _logs(name)
    rcap, obj_cap = J.condensed_caps(jlog)
    jc = {k: jnp.asarray(v) for k, v in jlog.padded_columns(include_aorder=True).items()}
    ref = J.merge_kernel_condensed(rcap)(jc)
    ref_obj = J.merge_kernel_condensed(rcap, obj_cap)(jc)
    ref_plain = J.merge_kernel(jc)
    c = columns_from_numpy(tlog.padded_columns(include_aorder=True), "cpu")
    got = merge_kernel_condensed(rcap)(c)
    assert tuple(got) == ALL_OUTPUTS == tuple(J.ALL_OUTPUTS)
    for k in ALL_OUTPUTS:
        want = np.asarray(ref[k])
        assert got[k].numpy().dtype == want.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
    # the document order of both JAX arms and of the pointer-doubling merge
    for ref_k in (ref_obj, ref_plain):
        np.testing.assert_array_equal(got["elem_index"].numpy(),
                                      np.asarray(ref_k["elem_index"]))


def _elem_index_args(c, out):
    return (out["first_child"], out["next_sib"], out["is_elem"], c["elem_ref"],
            c["obj_dense"], c["aorder"])


def test_typing_fanin_condenses_and_bench_fanin_does_not():
    """The typing trace chains its inserts; the synthetic bench trace
    inserts at a random position on every edit and barely chains."""
    _, typing = _logs("typing_fanin")
    _, bench = _logs("bench_fanin")
    n_ins = [int(np.count_nonzero(log.insert)) for log in (typing, bench)]
    assert typing.condensed_run_count() < n_ins[0] // 2
    assert bench.condensed_run_count() > n_ins[1] * 9 // 10


def test_actor_order_after_append_changes_equals_a_fresh_log():
    """A served log is mutated in place: the cached actor order must follow
    every append, new actors (a rank remap) and rows alike."""
    blobs = _blobs_of("interleaved_actors_and_deletes")
    changes = [parse_change(b)[0] for b in blobs]
    log = OpLog.from_changes(changes[:2])
    log.actor_order()  # fill the cache
    for i in range(2, len(changes), 3):
        info = log.append_changes(changes[i : i + 3])
        assert info is not None
        fresh = OpLog.from_changes(changes[: i + 3])
        np.testing.assert_array_equal(log.actor_order(), fresh.actor_order())
        assert log.condensed_run_count() == fresh.condensed_run_count()
    assert log.n == OpLog.from_changes(changes).n


def _two_puts():
    """Two visible map puts, (object 0, prop 64) and (object 1, prop 0): the
    JAX package's packed winner key (its obj_cap arm) merges their groups
    at P = 16."""
    cols = {
        "action": np.array([1, 1], np.int32), "insert": np.zeros(2, bool),
        "prop": np.array([64, 0], np.int32), "elem_ref": np.array([-2, -2], np.int32),
        "obj_dense": np.array([0, 1], np.int32), "value_tag": np.array([4, 4], np.int32),
        "value_i32": np.zeros(2, np.int32), "width": np.ones(2, np.int32),
        "covered": np.ones(2, bool), "pred_src": np.zeros(0, np.int32),
        "pred_tgt": np.zeros(0, np.int32), "aorder": np.zeros(0, np.int32),
    }
    return j_pad_columns(dict(cols), 2), pad_columns(dict(cols), 2)


def test_obj_cap_arm_keeps_the_dict_winners_where_the_jax_arm_merges_groups():
    """Where the JAX ``obj_cap`` arm merges two groups, the port's
    condensed merge (which has no such arm) keeps the dict winners."""
    jcols, tcols = _two_puts()
    assert len(tcols["action"]) == 16
    np.testing.assert_array_equal(tcols["aorder"], np.full(16, 16, np.int32))
    jc = {k: jnp.asarray(v) for k, v in jcols.items()}
    j_dict = J.merge_kernel_condensed(32)(jc)
    j_packed = J.merge_kernel_condensed(32, 16)(jc)
    # the reference's fault, pinned: its obj_cap arm merges the two groups
    assert list(np.asarray(j_dict["winner"])[:2]) == [0, 1]
    assert list(np.asarray(j_dict["conflicts"])[:2]) == [1, 1]
    assert list(np.asarray(j_packed["winner"])[:2]) == [1, 1]
    assert list(np.asarray(j_packed["conflicts"])[:2]) == [2, 2]
    got = merge_kernel_condensed(32)(columns_from_numpy(tcols, "cpu"))
    assert list(got["winner"][:2].numpy()) == [0, 1]
    assert list(got["conflicts"][:2].numpy()) == [1, 1]
    for k in ALL_OUTPUTS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(j_dict[k]),
                                      err_msg=k)


def test_raises_when_the_runs_exceed_rcap():
    _, tlog = _logs("prepend_heavy")
    runs = tlog.condensed_run_count()
    assert runs == 60  # every element its own run
    c = columns_from_numpy(tlog.padded_columns(include_aorder=True), "cpu")
    with pytest.raises(ValueError, match="60 chain runs exceed rcap = 32"):
        merge_kernel_condensed(32)(c)
    with pytest.raises(ValueError, match="exceed rcap"):
        merge_kernel_condensed(59)(c)
    out = merge_kernel_condensed(60)(c)  # exactly enough
    want = merge_kernel_condensed(64)(c)
    np.testing.assert_array_equal(out["elem_index"].numpy(),
                                  want["elem_index"].numpy())
    with pytest.raises(ValueError):
        LC.linearize_condensed(*_elem_index_args(c, out), 0)


@pytest.mark.parametrize("name", ["bench_fanin", "multiple_sequence_objects"])
def test_larger_rcap_gives_the_same_order(name):
    """rcap only bounds the run tables: any rcap at or above the run count
    gives the same elem_index."""
    _, tlog = _logs(name)
    c = columns_from_numpy(tlog.padded_columns(include_aorder=True), "cpu")
    rcap = condensed_caps(tlog)
    base = merge_kernel_condensed(rcap)(c)["elem_index"].numpy()
    for r in (2 * rcap, 4 * rcap, tlog.condensed_run_count()):
        got = merge_kernel_condensed(r)(c)["elem_index"].numpy()
        np.testing.assert_array_equal(got, base, err_msg=f"rcap {r}")


# -- the CUDA kernel's design, as a numpy model --------------------------------


def _tour_model(first_child, next_sib, is_elem, elem_ref, obj_dense, aorder):
    """``csrc/linearize_condensed.cu``'s condensed Euler tour in numpy:
    (elem_index int32 [P], the tour's (succ, weight) over its nodes).

    A run of first-child slots has one enter node (its id the run's
    index, weight its length) and one exit node (ids R + x, weight 0) for
    each of its slots that bears a sibling or heads it: the exit slots
    fall through to the slot below until a sibling-bearing one, so the
    exit node holding slot k is the last such slot at or before k. The
    enter node goes to the tail's first child's run, else to the tail's
    exit node; a sibling-bearing exit node to its sibling's run; a head's
    to the exit node holding its parent's slot (none for parents < 0).
    Every successor is local: no climb. The tour is then ranked by a
    plain walk from each node that no successor names."""
    fc = np.asarray(first_child, np.int64)
    ns = np.asarray(next_sib, np.int64)
    ie = np.asarray(is_elem, bool)
    er = np.asarray(elem_ref, np.int64)
    od = np.asarray(obj_dense, np.int64)
    ao = np.asarray(aorder, np.int64)
    P, N = len(ie), len(fc)
    k = np.arange(P)
    valid = ao < P
    rc = np.clip(ao, 0, P - 1)
    er_k = er[rc]
    elem = valid & ie[rc]
    sib = np.where(elem, ns[rc], 0)
    erc = np.clip(er_k, 0, P - 1)
    prev = np.concatenate([[P], ao[:-1]])
    cont = elem & (er_k >= 0) & (er_k < P) & ie[erc] & (fc[erc] == rc) & (er_k == prev)
    brk = valid & ~cont
    flag = elem & (sib != -1)
    xslot = brk | flag
    run_of = np.cumsum(brk) - 1
    xc = np.cumsum(xslot) - 1
    start = np.maximum.accumulate(np.where(brk, k, 0))
    kpos = np.full(P, -1)
    kpos[rc[valid]] = k[valid]
    R, M = int(brk.sum()), int(brk.sum() + xslot.sum())

    def slot_of(rows):  # rows outside aorder read slot 0, as the reference
        return np.maximum(kpos[np.clip(rows, 0, P - 1)], 0)

    def enter_of(rows):
        return np.maximum(run_of[slot_of(rows)], 0)

    def exit_of(slots):
        return R + np.maximum(xc[slots], 0)

    succ = np.full(M, -1)
    weight = np.zeros(M, np.int64)
    tail = valid & ~np.append(cont[1:], False)
    t = np.flatnonzero(tail & (run_of >= 0))
    fct = fc[rc[t]]
    succ[run_of[t]] = np.where(fct >= 0, enter_of(fct), exit_of(t))
    weight[run_of[t]] = t - start[t] + 1
    xs = np.flatnonzero(xslot)
    par = er_k[xs]
    succ[R + xc[xs]] = np.where(
        flag[xs], np.where(sib[xs] >= 0, enter_of(sib[xs]), -1),
        np.where(par < 0, -1, exit_of(slot_of(par))))

    # rank: each list from its head, the weight from a node to the end
    dist = np.zeros(max(M, 1), np.int64)
    named = np.zeros(M, bool)
    named[succ[succ >= 0]] = True
    reached = 0
    for h in np.flatnonzero(~named):
        path = [h]
        while succ[path[-1]] >= 0:
            path.append(succ[path[-1]])
        dist[path] = np.cumsum(weight[path][::-1])[::-1]
        reached += len(path)
    assert reached == M, "every node lies on a list from a head"

    def t_row(rows):
        ks = kpos[rows]
        kk = np.maximum(ks, 0)
        d = np.where(run_of[kk] >= 0, dist[np.maximum(run_of[kk], 0)], 0)
        return np.where(ks >= 0, d - (kk - start[kk]), 0)

    chain = fc[np.clip(P + od, 0, N - 1)]
    out = np.where(ie & (chain >= 0), t_row(np.clip(chain, 0, P - 1)) - t_row(k), -1)
    return out.astype(np.int32), (R, succ, weight)


def _model_cases():
    cases = [(name, functools.partial(_blobs_of, name)) for name in sorted(WORKLOADS)]
    cases += [(f"history_{s}", functools.partial(lambda s: sum(_history(s), []), s))
              for s in range(3, 6)]
    cases.append(("records", _record_store_blobs))
    return cases


@functools.lru_cache(maxsize=None)
def _record_store_blobs():
    base, reps, _ = W.record_store(64, 8, 20)
    return [base.raw_bytes] + [r.raw_bytes for r in reps]


MODEL_CASES = dict(_model_cases())


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_tour_model_equals_the_plain_version(name):
    """The condensed tour's successor rule and weights, ranked by a plain
    walk, give ``linearize_condensed_plain``'s elem_index exactly."""
    blobs = MODEL_CASES[name]()
    log = OpLog.from_changes([parse_change(b)[0] for b in blobs])
    c = columns_from_numpy(log.padded_columns(include_aorder=True), "cpu")
    rcap = condensed_caps(log)
    out = merge_kernel_condensed(rcap)(c)
    args = _elem_index_args(c, out)
    want = LC.linearize_condensed_plain(*args, rcap).numpy()
    got, (R, succ, weight) = _tour_model(*(a.numpy() for a in args))
    np.testing.assert_array_equal(got, want)
    # enter nodes weigh their runs, exit nodes nothing; a sibling names a
    # run head, so the sibling-bearing slots are at most R and the tour at
    # most 3R nodes
    assert int(weight.sum()) == int((c["aorder"] < len(got)).sum())
    assert (weight[R:] == 0).all() and (weight[:R] > 0).all()
    assert len(succ) <= 3 * R
    assert LC.tour_size(*args[:4], args[5]) == (R, len(succ) - R)


def _odd_forest(P, seed):
    """A random forest over P element rows of three objects laid out in a
    shuffled actor order, its chains mostly cut: runs of every length,
    object roots as parents, siblings everywhere."""
    rng = np.random.default_rng(seed)
    elem_ref = np.full(P, -1, np.int32)
    obj_dense = rng.integers(0, 3, P).astype(np.int32)
    for r in range(1, P):
        if rng.random() < 0.85:
            p = int(rng.integers(max(0, r - 8), r))
            elem_ref[r], obj_dense[r] = p, obj_dense[p]
    action = np.ones(P, np.int32)
    insert = np.ones(P, bool)
    return action, insert, elem_ref, obj_dense


@pytest.mark.parametrize("P,seed", [(1, 0), (2, 1), (37, 2), (500, 3), (2048, 4)])
def test_tour_model_on_random_forests_in_actor_order(P, seed):
    """Synthetic forests, their rows in an actor order that keeps some
    chains (rows in order) and cuts others (a shuffled tail), padded."""
    from automerge_tpu_torch.kernels.forest import forest_plain
    import torch

    action, insert, elem_ref, obj_dense = _odd_forest(P, seed)
    Pp = P + 3  # three pad rows: no elements, pad slots at the end
    pad = lambda a, v: np.concatenate([a, np.full(3, v, a.dtype)])  # noqa: E731
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    cols = (t(pad(action, 15)), t(pad(insert, False)), t(pad(elem_ref, -2)),
            t(pad(obj_dense, 0)))
    is_elem, _parent, first_child, next_sib = forest_plain(*cols)
    rng = np.random.default_rng(seed + 100)
    order = np.arange(P)
    cut = P // 2
    order[cut:] = rng.permutation(order[cut:])
    aorder = t(np.concatenate([order, np.full(3, Pp)]).astype(np.int32))
    args = (first_child, next_sib, is_elem, cols[2], cols[3], aorder)
    runs = int(is_elem.sum())  # at most one run per element
    want = LC.linearize_condensed_plain(*args, max(runs, 1)).numpy()
    got, _ = _tour_model(*(a.numpy() for a in args))
    np.testing.assert_array_equal(got, want)
