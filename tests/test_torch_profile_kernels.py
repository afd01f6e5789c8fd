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
    base, reps, _ = W.record_store(64, 8, 20)
    log = OpLog.from_changes([parse_change(b.raw_bytes)[0] for b in [base] + reps])
    return log.padded_columns(), log.n_objs, len(log.props)


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
    assert spec[:3] == records and tuple(spec[3:]) == caps


@pytest.mark.parametrize("path", ["text condensed", "served sharded", "wide",
                                  "records sideways"])
def test_path_spec_refuses_what_it_cannot_build(records, path):
    with pytest.raises(ValueError, match="unknown path"):
        PK.path_spec(_paths(records), path)


def test_columns_file_round_trips(records, tmp_path):
    f = str(tmp_path / "cols.npz")
    PK.save_paths(f, {"records": records, "served": records})
    back = PK.load_paths(f)
    assert set(back) == {"records", "served"}
    for cols, n_objs, n_props in back.values():
        assert (n_objs, n_props) == records[1:]
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
