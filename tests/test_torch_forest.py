"""The sibling forest's CUDA design, as a plain PyTorch model on the CPU,
against the JAX package's ``forest``.

``forest.forest_model`` runs the kernel's passes: the element rows'
sibling keys compacted block by block (the blocks in any order, as their
atomics may take their offsets), the sort of those keys alone, then
first_child from the start of each parent's run and next_sib from
neighbouring keys, -1 everywhere else. It and ``forest_plain`` (the
wrapper's CPU path) must equal ``automerge_tpu/ops/merge.py`` ``forest``
exactly on columns with no element row (a record store), one parent with
2,000 children, children of the sentinel (missing references), pad rows,
and the seeded random histories of ``test_torch_random_docs.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.ops import merge as J
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.kernels import forest as F
from automerge_tpu_torch.kernels import radix_sort as RS
from automerge_tpu_torch.ops.oplog import ELEM_HEAD, PAD_ACTION, OpLog
from automerge_tpu_torch.storage.change import parse_change

from .test_torch_random_docs import SEEDS, _history

NAMES = ("is_elem", "parent_row", "first_child", "next_sib")


def _cols(action, insert, elem_ref, obj_dense):
    return {"action": np.asarray(action, np.int32), "insert": np.asarray(insert, bool),
            "elem_ref": np.asarray(elem_ref, np.int32),
            "obj_dense": np.asarray(obj_dense, np.int32)}


def _log_cols(blobs):
    cols = OpLog.from_changes([parse_change(b)[0] for b in blobs]).padded_columns()
    return _cols(cols["action"], cols["insert"], cols["elem_ref"], cols["obj_dense"])


def _records():
    base, reps, _ = W.record_store(1024, 16, 40)
    return _log_cols([base.raw_bytes] + [r.raw_bytes for r in reps])


def _one_parent():
    """2,000 elements, each inserted at the HEAD of object 0: one parent,
    2,000 siblings in descending rows."""
    P = 2000
    return _cols(np.ones(P), np.ones(P), np.full(P, ELEM_HEAD), np.zeros(P))


def _missing_refs():
    """Elements after other elements, at HEAD, and after references that
    are missing (elem_ref < -1): those hang from the sentinel N-1."""
    rng = np.random.default_rng(5)
    P = 3000
    elem_ref = rng.integers(-1, P, P)
    elem_ref = np.where(elem_ref < np.arange(P), elem_ref, -1)
    missing = rng.random(P) < 0.2
    elem_ref[missing] = rng.integers(-9, -1, int(missing.sum()))
    return _cols(np.ones(P), rng.random(P) < 0.9, elem_ref,
                 rng.integers(0, 4, P))


def _pad_rows():
    """A text of 700 elements and map puts, then 324 pad rows (inserts,
    to show that padding never becomes an element)."""
    rng = np.random.default_rng(9)
    n, P = 1100, 1424
    action = np.where(np.arange(P) < n, 1, PAD_ACTION)
    insert = np.arange(P) < 700
    insert[n:] = True
    elem_ref = np.where(rng.random(P) < 0.5, ELEM_HEAD,
                        (rng.random(P) * np.arange(P)).astype(np.int64))
    return _cols(action, insert, elem_ref, np.zeros(P))


CASES = {"records": _records, "one_parent": _one_parent,
         "missing_refs": _missing_refs, "pad_rows": _pad_rows,
         **{f"history_{s}": functools.partial(
             lambda s: _log_cols([*_history(s)[0], *_history(s)[1]]), s)
            for s in SEEDS}}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(columns, the JAX package's forest outputs as numpy)."""
    cols = CASES[name]()
    ref = J.forest({k: jnp.asarray(v) for k, v in cols.items()})
    return cols, tuple(np.asarray(a) for a in ref)


def _check(got, ref):
    for name, g, r in zip(NAMES, got, ref):
        g = g.numpy()
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def _torch(cols):
    return [torch.from_numpy(cols[k]) for k in ("action", "insert", "elem_ref",
                                                "obj_dense")]


@pytest.mark.parametrize("variant", ["plain", "model", "model_small_blocks_reversed",
                                     "model_blocks_shuffled"])
@pytest.mark.parametrize("name", list(CASES))
def test_forest_design_equals_jax(name, variant):
    cols, ref = _case(name)
    args = _torch(cols)
    P = len(cols["action"])
    if variant == "plain":
        _check(F.forest_plain(*args), ref)
        return
    block = 32 if variant == "model_small_blocks_reversed" else 256
    blocks = -(-P // block)
    order = {"model": None,
             "model_small_blocks_reversed": range(blocks - 1, -1, -1),
             "model_blocks_shuffled": np.random.default_rng(P).permutation(blocks)
             }[variant]
    *got, n_keys = F.forest_model(*args, block=block, block_order=order)
    _check(got, ref)
    # only the element rows are sorted: none in a record store
    assert n_keys == int(ref[0].sum())
    if name == "records":
        assert n_keys == 0


def test_one_parent_runs_down_the_rows():
    cols, ref = _case("one_parent")
    P = len(cols["action"])
    assert ref[2][P] == P - 1  # object 0's root: the last insert first
    assert list(ref[3][:P]) == list(range(-1, P - 1))


@pytest.mark.parametrize("count", [0, 1, 4095, 4096, 4097, 9000])
def test_radix_sort_count_sorts_the_prefix_alone(count):
    """The device-side count's plain version: the first ``count`` keys
    sorted, the rest as they were."""
    keys = torch.from_numpy(np.random.default_rng(count).integers(
        -(1 << 62), 1 << 62, 9000))
    got = RS.radix_sort(keys, count=torch.tensor([count], dtype=torch.int32))
    assert torch.equal(got[:count], torch.sort(keys[:count]).values)
    assert torch.equal(got[count:], keys[count:])
