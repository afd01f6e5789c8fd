"""The kernel profile harness (``scripts/profile_kernels_torch.py``) and
the bound it reads (``chip_smoke.bound``), on the CPU: the paths it
takes by name, its columns file, another checkout's wrappers found by
name and compared exactly, and the bytes ``succ_vis`` must move where
increment edges reach counters."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.convert import columns_from_numpy
from automerge_tpu_torch.kernels import succ_vis as SV
from automerge_tpu_torch.ops.merge import condensed_caps
from automerge_tpu_torch.ops.oplog import OpLog
from automerge_tpu_torch.storage.change import parse_change
from automerge_tpu_torch.types import Action

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "profile_kernels_torch", ROOT / "scripts" / "profile_kernels_torch.py")
PK = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PK)

SV_NAMES = ("action", "value_tag", "value_i32", "covered", "pred_src", "pred_tgt")


def _records_cols():
    """A small record store's path as ``build_paths`` keeps a fan-in: its
    columns with the actor order, n_objs, n_props and rcap."""
    base, reps, _ = W.record_store(64, 8, 20)
    log = OpLog.from_changes([parse_change(b.raw_bytes)[0] for b in [base] + reps])
    return (log.padded_columns(include_aorder=True), log.n_objs, len(log.props),
            condensed_caps(log))


@pytest.fixture(scope="module")
def records():
    return _records_cols()


def _paths(spec):
    return {name: spec for name in PK.PATHS}


@pytest.mark.parametrize("path, caps", [
    ("text", ()), ("typing", ()), ("records", ()), ("served", ()),
    ("text expand", ()), ("records packed", ()),
    ("text sharded", ("condensed",)), ("text sharded rows", ("rows",)),
    ("records sharded", ("condensed",)),
])
def test_path_spec_takes_the_fanin_and_the_sharded_arm(records, path, caps):
    spec = PK.path_spec(_paths(records), path)
    cols, n_objs, n_props, _ = records
    assert spec[0] == {k: v for k, v in cols.items() if k != "aorder"}
    assert spec[1:3] == (n_objs, n_props) and tuple(spec[3:]) == caps


@pytest.mark.parametrize("path", ["text condensed", "typing condensed",
                                  "records condensed"])
def test_path_spec_takes_a_condensed_path_with_its_actor_order(records, path):
    spec = PK.path_spec(_paths(records), path)
    assert spec == records and "aorder" in spec[0]


def test_condensed_rows_run_linearize_condensed_and_its_other_tree(records,
                                                                   monkeypatch):
    """A condensed path's kernel rows, as ``chip_smoke.kernel_rows``
    makes them: the condensed merge's kernels, ``linearize_condensed``
    last at the path's rcap, equal to its plain version and to another
    checkout's on the CPU (where nothing launches: the launch checks are
    the card's)."""
    monkeypatch.setattr(chip_smoke, "check_call_launches", lambda *a: None)
    alias = "profile_kernels_test_condensed_tree"
    PK.load_tree_as(alias, str(ROOT))
    rows = chip_smoke.kernel_rows("records condensed",
                                  PK.path_spec(_paths(records), "records condensed"),
                                  torch.device("cpu"))
    assert [r[0] for r in rows][-1] == "linearize_condensed"
    name, kern, plain, args, out, library, tag = rows[-1]
    assert args[-1] == records[3] and tag == f"rcap={records[3]}"
    assert PK.same(out, (plain(*args),))
    assert PK.same(out, (PK.counterpart(alias, kern)(*args),))


def test_condensed_path_puts_linearize_beside_it_on_its_forest(records, monkeypatch):
    """``--kernels linearize_condensed,linearize`` on a condensed path: K7
    runs on the forest K8 ranks, and both give the same order."""
    monkeypatch.setattr(chip_smoke, "check_call_launches", lambda *a: None)
    rows = chip_smoke.kernel_rows("records condensed",
                                  PK.path_spec(_paths(records), "records condensed"),
                                  torch.device("cpu"))
    name, kern, plain, args, out, library, tag = PK.beside_row(rows)
    assert name == "linearize" and args == rows[-1][3][:5] and library is None
    assert PK.same(out, rows[-1][4]) and PK.same(out, (plain(*args),))


@pytest.mark.parametrize("path", ["served condensed", "served sharded", "wide",
                                  "records sideways", "text condensed rows"])
def test_path_spec_refuses_what_it_cannot_build(records, path):
    with pytest.raises(ValueError, match="unknown path"):
        PK.path_spec(_paths(records), path)


def test_columns_file_round_trips(records, tmp_path):
    f = str(tmp_path / "cols.npz")
    PK.save_paths(f, {"records": records, "served": records})
    back = PK.load_paths(f)
    assert set(back) == {"records", "served"}
    for cols, n_objs, n_props, rcap in back.values():
        assert (n_objs, n_props, rcap) == records[1:]
        assert cols.keys() == records[0].keys()
        for k, v in records[0].items():
            assert cols[k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(cols[k], v)


def test_other_tree_wrapper_is_found_by_name_and_compared_exactly(records):
    """A second copy of this checkout, loaded under an alias, gives its
    own succ_vis, equal to this one's on the CPU; a function that is not
    the package's has no counterpart."""
    alias = "profile_kernels_test_tree"
    pkg = PK.load_tree_as(alias, str(ROOT))
    other = PK.counterpart(alias, SV.succ_vis)
    assert other is not SV.succ_vis and other.__module__ == f"{alias}.kernels.succ_vis"
    assert PK.counterpart(alias, chip_smoke.sorted_prefix) is None
    c = columns_from_numpy({k: records[0][k] for k in SV_NAMES}, "cpu")
    args = tuple(c[k] for k in SV_NAMES)
    assert PK.same(SV.succ_vis(*args), other(*args))
    pkg.kernels.reset_launches()
    other(*args)
    assert pkg.kernels.launch_counts()["succ_vis"] == 0


def test_same_is_exact_over_nested_outputs():
    a = torch.arange(4, dtype=torch.int32)
    assert PK.same((a, {"x": [a]}), (a.clone(), {"x": [a.clone()]}))
    assert not PK.same((a,), (a.long(),))
    assert not PK.same((a,), (a + 1,))
    assert not PK.same({"x": a}, {"y": a})
    assert not PK.same((a,), (a, a))


def test_succ_vis_bound_reads_value_tag_only_at_increment_targets(records):
    """With increments into counters, the bound reads value_i32 at the
    increments' distinct sources and value_tag at their distinct
    in-range targets; every other input row once, each output once."""
    c = columns_from_numpy({k: records[0][k] for k in SV_NAMES}, "cpu")
    args = tuple(c[k] for k in SV_NAMES)
    P, Q = c["action"].numel(), c["pred_src"].numel()
    src = c["pred_src"].long().clamp(0, P - 1)
    tgt = c["pred_tgt"].long()
    inc = ((tgt >= 0) & (tgt < P) & c["covered"][src]
           & (c["action"][src] == Action.INCREMENT))
    n_src, n_tgt = len(set(src[inc].tolist())), len(set(tgt[inc].tolist()))
    assert n_tgt > 0
    out = SV.succ_vis(*args)
    moved, ops = chip_smoke.work("succ_vis", args, out)
    assert moved == 8 * Q + 5 * P + 4 * (n_src + n_tgt) + 13 * P
    assert ops == 3 * Q + 6 * P
    ms, by = chip_smoke.bound("succ_vis", args, out)
    assert by == "bytes" and ms == moved / chip_smoke.HBM_BYTES_PER_S * 1e3


def test_same_compares_numpy_outputs_exactly():
    a = np.arange(5, dtype=np.int32)
    assert PK.same({"x": a}, {"x": a.copy()})
    assert not PK.same({"x": a}, {"x": a.astype(np.int64)})
    assert not PK.same({"x": a}, {"x": a + 1})
    assert not PK.same(a, torch.from_numpy(a))


def test_sharded_merge_row_runs_the_whole_merge_and_its_other_tree(records):
    """The ``sharded_merge`` row: the whole sharded merge of a sharded
    path's arm over four shards of the device, its launches by kernel
    (none on the CPU), equal to another checkout's."""
    alias = "profile_kernels_test_merge_tree"
    pkg = PK.load_tree_as(alias, str(ROOT))
    for arm in ("condensed", "rows"):
        ((name, kern, plain, args, out, library, tag),) = PK.merge_rows(
            f"records sharded {arm}", (*PK.path_spec(_paths(records), "records"), arm), torch.device("cpu"))
        assert name == "sharded_merge" and plain is None and library is None
        assert args[1].size == chip_smoke.MESH_SHARDS and args[-1] == arm
        other = PK.counterpart(alias, kern)
        assert other.__module__ == f"{alias}.parallel.sharding"
        assert PK.same(out, other(*args))
        assert PK.launches(pkg.kernels, name, lambda: other(*args)) == {}


def test_sharded_merge_row_takes_a_mesh_of_distinct_devices(records):
    """``--mesh cards``: the row's merge over the mesh it is given, here
    four shards on two CPU devices, equal to the one-device mesh's."""
    from automerge_tpu_torch.parallel import Mesh

    mesh = Mesh(["cpu:0", "cpu:1", "cpu:0", "cpu:1"])
    ((name, kern, _, args, out, _, tag),) = PK.merge_rows(
        "records sharded rows", (*PK.path_spec(_paths(records), "records"), "rows"), torch.device("cpu"), mesh)
    assert name == "sharded_merge" and args[1] is mesh
    assert tag == "4 shards on 2 devices, rows arm"
    ((_, _, _, _, want, _, tag),) = PK.merge_rows(
        "records sharded rows", (*PK.path_spec(_paths(records), "records"), "rows"), torch.device("cpu"))
    assert tag == "4 shards on one card, rows arm"
    assert PK.same(out, want)


def _rounds_work(step, plain, state, rounds):
    """The sum over ``rounds`` chained range rounds over all E nodes of
    ``chip_smoke.work`` of each, on the state that round reads."""
    E = state[0].numel()
    moved = ops = 0
    for _ in range(rounds):
        nxt = plain(*state, 0, E)
        m, o = chip_smoke.work(step, (*state, 0, E), nxt)
        moved, ops, state = moved + m, ops + o, nxt
    return moved, ops


def test_rounds_bound_sums_each_rounds_work():
    """A rounds entry's bound: the sum over its rounds of the bound of
    one range round over all E nodes of the state that round reads."""
    from automerge_tpu_torch.kernels import linearize as L

    rng = np.random.default_rng(4)
    E = 300
    dist = torch.from_numpy(rng.integers(0, 9, E).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(-1, E + 3, E).astype(np.int32))
    out = L.linearize_rank_rounds(dist, nxt, 7)
    assert chip_smoke.work("linearize_rank_rounds", (dist, nxt, 7), out) == (
        _rounds_work("linearize_rank", L.linearize_rank_plain, (dist, nxt), 7))


@pytest.mark.parametrize("loop", ["thread", "rank"])
def test_rounds_bound_shrinks_as_the_links_collapse(loop):
    """One list 0 -> 1 -> ... -> E-1, the last a fixed point: after k
    rounds each link points 2^k ahead, clamped at the end, so round k
    gathers at max(E - 2^k, 1) distinct nodes and the loop's bound is
    below rounds times its first round's."""
    from automerge_tpu_torch.kernels import linearize as L

    E, rounds = 64, 7
    node = torch.arange(E, dtype=torch.int32)
    link = torch.clamp(node + 1, max=E - 1)
    if loop == "thread":
        state, per_node = (link.clone(), node == E - 1, link), 9
    else:
        state, per_node = (torch.ones(E, dtype=torch.int32), link), 8
    name = f"linearize_{loop}"
    whole = getattr(L, f"{name}_rounds")
    plain = getattr(L, f"{name}_plain")
    moved, ops = chip_smoke.work(f"{name}_rounds", (*state, rounds),
                                 whole(*state, rounds))
    first = chip_smoke.work(name, (*state, 0, E), plain(*state, 0, E))
    # each round reads its E records and the distinct ones it jumps to,
    # and writes E records
    assert moved == sum(per_node * (2 * E + max(E - 2 ** k, 1))
                        for k in range(rounds))
    assert moved < rounds * first[0]
    assert ops == rounds * first[1]


def test_rank_loop_from_thread_bound_reads_the_answers_then_the_state():
    """The row arm's rank loop from the thread loop's answers: its bound
    is its first round's (fc_e at the nodes below P and at the distinct
    ones they step to, ans where fc_e is -1) plus the later rounds' over
    the state, as ``linearize_rank_rounds`` counts them."""
    from automerge_tpu_torch.kernels import linearize as L

    rng = np.random.default_rng(5)
    E, P, rounds = 300, 290, 7
    fc_e = torch.from_numpy(np.where(rng.random(E) < 0.5, -1,
                                     rng.integers(0, P, E)).astype(np.int32))
    ans = torch.from_numpy(rng.integers(-1, E + 3, E).astype(np.int32))
    out = L.linearize_rank_from_thread(fc_e, ans, P, rounds)
    first_in = (fc_e, ans, P, 0, E)
    first = L.linearize_rank_first(*first_in)
    moved, ops = chip_smoke.work("linearize_rank_first", first_in, first)
    nxt = L.linearize_rank_init_plain(fc_e, ans, P)[1]
    j = torch.unique(nxt.long().clamp(0, E - 1))
    j = j[j < P]
    own = 4 * (P + int((fc_e[:P] == -1).sum()))
    assert moved == own + 4 * (j.numel() + int((fc_e[j] == -1).sum())) + 8 * E
    later = _rounds_work("linearize_rank", L.linearize_rank_plain, first, rounds - 1)
    assert chip_smoke.work("linearize_rank_from_thread", (fc_e, ans, P, rounds),
                           out) == (moved + later[0], ops + later[1])

