"""The sort-based winners (K5) of the port against the JAX package.

Record-store documents (a map of records, each a map of fields: the shape
whose group table fails ``scatter_geometry_ok``) are made by the port's
generator from seeds; both packages parse the same change bytes and build
the same padded columns. The port's ``sort_winners`` (its plain version on
the CPU) must give the JAX ``resolve_state``'s winners, conflicts and
per-object stats exactly, on whole logs and on the subset columns of a
served re-resolve, whose prop ids are the whole log's and may exceed the
subset's row count. All of it is int32/bool: tolerance 0. The mixed cases
of ``test_torch_kernels.py`` run the same check beyond the gate.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.ops import extract as JX
from automerge_tpu.ops import merge as J
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.convert import columns_from_numpy
from automerge_tpu_torch.kernels import sort_winners as SO
from automerge_tpu_torch.kernels import succ_vis as SV
from automerge_tpu_torch.ops import merge as M
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.oplog import OpLog, pad_columns
from automerge_tpu_torch.storage.change import (
    ChangeOp, StoredChange, build_change, parse_change,
)
from automerge_tpu_torch.types import Key, ScalarValue

# (records, replicas, ops per replica)
SIZES = [(256, 16, 20), (1024, 24, 60)]
NAMES = ("winner", "conflicts", "obj_vis_len", "obj_text_width")


@pytest.fixture(autouse=True)
def cold_jax_change_cache(monkeypatch):
    """The JAX package's per-change-hash extraction cache keeps, for each
    change it decoded, the key table of the whole batch the change came
    in; a log assembled later from those entries (after another test
    applied these changes with others) numbers its map keys differently,
    unused names included. Each test starts it empty."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)


@functools.lru_cache(maxsize=None)
def _store(records, replicas, per):
    base, reps, expect = W.record_store(records, replicas, per)
    return [c.raw_bytes for c in [base] + reps], expect


def _winner_args(c, visible):
    return (c["action"], c["insert"], c["elem_ref"], c["obj_dense"], c["prop"],
            c["width"], visible)


def _visible(c):
    return SV.succ_vis(c["action"], c["value_tag"], c["value_i32"],
                       c["covered"], c["pred_src"], c["pred_tgt"])[3]


def _check_against_jax(cols):
    ref = J.resolve_state({k: jnp.asarray(v) for k, v in cols.items()},
                          *J.succ_resolution({k: jnp.asarray(v)
                                              for k, v in cols.items()}))
    c = columns_from_numpy(cols, "cpu")
    got = SO.sort_winners(*_winner_args(c, _visible(c)))
    for name, t in zip(NAMES, got):
        want = np.asarray(ref[name])
        assert t.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_record_store_columns_equal(size):
    blobs, _ = _store(*size)
    jlog = JOpLog.from_changes([j_parse_change(b)[0] for b in blobs])
    tlog = OpLog.from_changes([parse_change(b)[0] for b in blobs])
    jcols, tcols = jlog.padded_columns(), tlog.padded_columns()
    for k in jcols:
        np.testing.assert_array_equal(tcols[k], jcols[k], err_msg=k)
    P = len(tcols["action"])
    assert not M.scatter_geometry_ok(P, tlog.n_objs, len(tlog.props))
    _check_against_jax(tcols)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_record_store_merge_equals_jax_merge_kernel(size):
    """Past the gate the port's merge takes ``sort_winners``; all 13
    outputs are the JAX ``merge_kernel``'s, and the phase is named after
    the kernel that ran."""
    blobs, _ = _store(*size)
    tlog = OpLog.from_changes([parse_change(b)[0] for b in blobs])
    cols = tlog.padded_columns()
    ref = J.merge_kernel({k: jnp.asarray(v) for k, v in cols.items()})
    phases = {}
    got = M.merge_kernel(columns_from_numpy(cols, "cpu"), tlog.n_objs,
                         len(tlog.props), phases)
    assert "sort_winners" in phases and "scatter_winners" not in phases
    for k in M.ALL_OUTPUTS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_record_store_reads_equal_generator_counts(size):
    blobs, expect = _store(*size)
    doc = DeviceDoc.merge(blobs, device="cpu")
    jdoc = JDeviceDoc.resolve(JOpLog.from_changes(
        [j_parse_change(b)[0] for b in blobs]))
    assert W.record_counts(doc) == W.record_counts(jdoc) == expect
    assert doc.map_entries(W.RECORDS_OBJ) == jdoc.map_entries(W.RECORDS_OBJ)


def test_subset_columns_with_prop_ids_beyond_the_subset():
    """A served re-resolve of one record that gained a new field: the
    subset has a few rows, its new key's prop id is the whole log's."""
    blobs, _ = _store(*SIZES[1])
    base = parse_change(blobs[0])[0]
    record = (2 + 9 * 5, 1)  # record 5's make_map, the base's op
    extra = build_change(StoredChange(
        dependencies=[base.hash], actor=bytes([9]) * 16,
        other_actors=[W.BASE_ACTOR], seq=1, start_op=base.max_op + 1,
        timestamp=0, message=None, ops=[ChangeOp(
            obj=record, key=Key.map("extra"), insert=False, action=1,
            value=ScalarValue("int", 1))]))
    doc = DeviceDoc.merge(blobs, device="cpu")
    doc.apply_changes([extra.raw_bytes])
    rec = doc.log.import_id(f"{record[0]}@{W.BASE_ACTOR.hex()}")
    dirty = np.searchsorted(doc.log.obj_table, [rec]).astype(np.int64)
    rows = doc._subset_rows(dirty)
    cols = pad_columns(doc._subset_cols(rows, dirty), len(dirty))
    assert cols["prop"].max() >= len(cols["action"])
    _check_against_jax(cols)


def test_keys_over_the_whole_int32_range_equal_jax():
    """Prop ids and run keys over the whole int32 range and the sentinels:
    the groups, hence winners, conflicts and stats, are the JAX
    ``resolve_state``'s."""
    rng = np.random.default_rng(0)
    P = 4096
    pool = np.array([-3, -2, -1, 0, 5, P - 1, P, P + 7, (1 << 31) - 1], np.int32)
    cols = {
        "action": rng.choice([1, 3, 15], P).astype(np.int32),
        "insert": rng.random(P) < 0.3,
        "elem_ref": rng.choice(pool, P),
        "prop": rng.choice(np.concatenate([[-1, -1, -1], pool[3:]]), P)
        .astype(np.int32),
        "obj_dense": rng.integers(0, 6, P).astype(np.int32),
        "width": rng.integers(1, 4, P).astype(np.int32),
        "value_tag": np.zeros(P, np.int32),
        "value_i32": np.zeros(P, np.int32),
        "covered": rng.random(P) < 0.8,
    }
    zeros = jnp.zeros(P, jnp.int32)
    ref = J.resolve_state({k: jnp.asarray(v) for k, v in cols.items()},
                          zeros, zeros, zeros)
    c = columns_from_numpy(cols, "cpu")
    got = SO.sort_winners(*_winner_args(c, torch.from_numpy(np.array(ref["visible"]))))
    assert len(np.unique(np.asarray(ref["winner"]))) > 100  # many groups
    for name, t in zip(NAMES, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref[name]), err_msg=name)
