"""The successor counts and the visibility mask (K2+K3), as the CUDA
design's plain PyTorch model on the CPU, against the JAX package's
``succ_resolution`` + ``visibility``.

``succ_vis.succ_vis_model`` runs the kernel's two passes: the row pass
(counts zeroed, visible as if no edge counted), then the pred edges one
at a time in a given order (ascending, reversed, shuffled), each adding
to the counts and storing False into visible where it hides its target.
It, ``succ_vis_plain`` and the wrapper's CPU path must equal
``automerge_tpu/ops/merge.py`` ``succ_resolution`` and ``visibility``
exactly, on the seeded random histories of ``test_torch_random_docs.py``,
a small record store with increments into counters, and columns made
for the edge cases: increments into a counter put and into other puts,
an uncovered source, targets of -1 and P, sources past P, pad rows, P of
1, 5 and 4,097, ``counter_inc`` wrapping past 2^31, one row with many
in-edges. The sharded halves (``succ_partial`` over slices of the edges,
summed, then ``visibility``) must equal them too.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.ops import merge as J
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.kernels import succ_vis as SV
from automerge_tpu_torch.ops.oplog import PAD_ACTION, TAG_COUNTER, TAG_INT, OpLog
from automerge_tpu_torch.storage.change import parse_change
from automerge_tpu_torch.types import Action

from .test_torch_random_docs import SEEDS, _history

NAMES = ("action", "value_tag", "value_i32", "covered", "pred_src", "pred_tgt")
OUTPUTS = ("succ_count", "inc_count", "counter_inc", "visible")
ORDERS = ("ascending", "reversed", "shuffled")

PUT, DEL, INC, MARK = Action.PUT, Action.DELETE, Action.INCREMENT, Action.MARK


def _cols(action, value_tag, value_i32, covered, pred_src, pred_tgt):
    return {"action": np.asarray(action, np.int32),
            "value_tag": np.asarray(value_tag, np.int32),
            "value_i32": np.asarray(value_i32, np.int64).astype(np.int32),
            "covered": np.asarray(covered, bool),
            "pred_src": np.asarray(pred_src, np.int32),
            "pred_tgt": np.asarray(pred_tgt, np.int32)}


def _log_cols(blobs):
    cols = OpLog.from_changes([parse_change(b)[0] for b in blobs]).padded_columns()
    return {k: cols[k] for k in NAMES}


def _random_doc(seed):
    base, forks = _history(seed)
    return _log_cols(base + forks)


def _records():
    base, reps, _ = W.record_store(256, 8, 40)
    return _log_cols([base.raw_bytes] + [r.raw_bytes for r in reps])


def _counter_puts():
    """Increments into a counter put (it stays visible), into a put of an
    int (hidden), and into a counter put that also has a successor put
    (hidden); one counter put with no edge."""
    action = [PUT, PUT, PUT, PUT, INC, INC, INC, PUT]
    tag = [TAG_COUNTER, TAG_INT, TAG_COUNTER, TAG_COUNTER, TAG_INT, TAG_INT, TAG_INT,
           TAG_INT]
    value = [10, 3, 0, 7, 5, -2, 9, 1]
    return _cols(action, tag, value, [True] * 8, [4, 5, 6, 7], [0, 1, 2, 2])


def _uncovered_source():
    """A put and an increment outside the read clock: their edges count
    nowhere; the uncovered rows themselves are hidden."""
    action = [PUT, PUT, PUT, INC, PUT]
    tag = [TAG_INT, TAG_COUNTER, TAG_INT, TAG_INT, TAG_INT]
    cov = [True, True, True, False, False]
    return _cols(action, tag, [0, 0, 0, 4, 0], cov, [4, 3, 4], [0, 1, 2])


def _out_of_range():
    """Targets of -1 (unresolved) and of P (dropped as XLA drops a
    scatter), and sources past P (clamped to P - 1, as XLA gathers)."""
    P = 6
    action = [PUT, DEL, PUT, PUT, PUT, INC]
    tag = [TAG_COUNTER, 0, TAG_INT, TAG_INT, TAG_INT, TAG_INT]
    return _cols(action, tag, [0, 0, 0, 0, 0, 11], [True] * P,
                 [2, 3, 4, 1, P, P + 7, 3], [-1, P, P + 5, 0, 0, 3, -1])


def _pad_rows():
    """Rows and edges as ``pad_columns`` pads them: PAD_ACTION rows,
    uncovered, and pred edges 0 -> -1."""
    action = [PUT, PUT, DEL, MARK] + [PAD_ACTION] * 12
    cov = [True] * 4 + [False] * 12
    return _cols(action, [TAG_INT] * 16, [0] * 16, cov, [2, 0, 0, 0], [0, -1, -1, -1])


def _synthetic(P, Q, seed):
    """P rows and Q edges of every action, about a fifth uncovered, a
    third of the puts counters; targets in [-1, P], sources in [0, P]."""
    rng = np.random.default_rng(seed)
    action = rng.choice([0, PUT, PUT, PUT, 2, DEL, 4, INC, INC, MARK, PAD_ACTION], P)
    tag = np.where(rng.random(P) < 0.35, TAG_COUNTER, TAG_INT)
    value = rng.integers(-(1 << 31), 1 << 31, P)
    return _cols(action, tag, value, rng.random(P) < 0.8,
                 rng.integers(0, P + 1, Q), rng.integers(-1, P + 1, Q))


def _wraps():
    """Increments into one counter put whose values sum past 2^31 (and
    back under -2^31 into another): counter_inc wraps as int32 does."""
    P = 40
    action = [PUT, PUT] + [INC] * (P - 2)
    tag = [TAG_COUNTER, TAG_COUNTER] + [TAG_INT] * (P - 2)
    value = [0, 0] + [(1 << 31) - 5] * 20 + [-(1 << 31) + 1] * 18
    src = list(range(2, P))
    return _cols(action, tag, value, [True] * P, src, [0] * 20 + [1] * 18)


def _hot_row():
    """A counter put with 3,000 in-edges and a put with 1,000, from
    increments and puts mixed."""
    n = 4000
    P = n + 2
    action = [PUT, PUT] + [INC if i % 3 else PUT for i in range(n)]
    tag = [TAG_COUNTER, TAG_INT] + [TAG_INT] * n
    value = [0, 0] + list(range(n))
    return _cols(action, tag, value, [True] * P, range(2, P),
                 [0] * 3000 + [1] * 1000)


CASES = {
    **{f"random_doc_{s}": functools.partial(_random_doc, s) for s in SEEDS},
    "records": _records,
    "counter_puts": _counter_puts,
    "uncovered_source": _uncovered_source,
    "out_of_range": _out_of_range,
    "pad_rows": _pad_rows,
    "P1": lambda: _synthetic(1, 3, 1),
    "P5": lambda: _synthetic(5, 9, 2),
    "P4097": lambda: _synthetic(4097, 3000, 3),
    "wraps": _wraps,
    "hot_row": _hot_row,
}


@functools.lru_cache(maxsize=None)
def _case(name):
    cols = CASES[name]()
    jc = {k: jnp.asarray(v) for k, v in cols.items()}
    succ, inc, counter_inc = J.succ_resolution(jc)
    want = tuple(np.asarray(x) for x in (succ, inc, counter_inc,
                                         J.visibility(jc, succ, inc)))
    return cols, want


def _tensors(cols):
    return tuple(torch.from_numpy(cols[k].copy()) for k in NAMES)


def _eq(got, want):
    for name, g, w in zip(OUTPUTS, got, want):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_cases_reach_what_they_are_for():
    """The record store has increments into counter puts that stay
    visible; the wrap case's counter_inc wraps; the hot row's count."""
    cols, want = _case("records")
    _, inc, counter_inc, visible = want
    counter = (cols["action"] == PUT) & (cols["value_tag"] == TAG_COUNTER)
    assert (counter & (inc > 0) & visible).any()
    assert counter_inc[counter & (inc > 0)].any()
    cols, want = _case("wraps")
    assert want[2][0] == np.int32(((20 * ((1 << 31) - 5) + (1 << 31)) % (1 << 32))
                                  - (1 << 31))
    assert want[3][0] and want[3][1]
    _, want = _case("hot_row")
    assert (want[0][0], want[1][0], want[0][1], want[1][1]) == (1000, 2000, 334, 666)
    assert not want[3][0] and not want[3][1]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", CASES)
def test_model_equals_jax(name, order):
    cols, want = _case(name)
    _eq(SV.succ_vis_model(*_tensors(cols), order=order, seed=7), want)


@pytest.mark.parametrize("name", CASES)
def test_plain_equals_jax(name):
    cols, want = _case(name)
    _eq(SV.succ_vis_plain(*_tensors(cols)), want)


@pytest.mark.parametrize("name", CASES)
def test_wrapper_on_cpu_equals_jax(name):
    cols, want = _case(name)
    _eq(SV.succ_vis(*_tensors(cols)), want)


@pytest.mark.parametrize("name", CASES)
def test_sharded_halves_equal_jax(name):
    """succ_partial over four slices of the edges, summed, then
    visibility: the sharded merge's split of the same function."""
    cols, want = _case(name)
    action, value_tag, value_i32, covered, pred_src, pred_tgt = _tensors(cols)
    acc = sum(SV.succ_partial(action, value_i32, covered, s, t)
              for s, t in zip(pred_src.tensor_split(4), pred_tgt.tensor_split(4)))
    visible = SV.visibility(action, value_tag, covered, acc[0], acc[1])
    _eq((acc[0], acc[1], acc[2], visible), want)


@pytest.mark.parametrize("P", [0, 1, 3, 4, 5, 4096, 4097])
def test_one_allocation_layout(P):
    """The card's output: rows at a stride of P rounded up to 4 (each
    16-byte aligned where the buffer is), visible in the bytes after the
    third, none overlapping, all of length P."""
    out = SV._output(P, "cpu")
    s = SV._stride(P)
    assert s % 4 == 0 and P <= s < P + 4
    assert out.numel() == 3 * s + s // 4
    views = SV._views(out, P)
    assert [v.shape for v in views] == [(P,)] * 4
    assert [v.dtype for v in views] == [torch.int32] * 3 + [torch.bool]
    base = out.data_ptr()
    assert [v.data_ptr() - base for v in views] == [0, 4 * s, 8 * s, 12 * s]
    assert all(v.is_contiguous() for v in views)
    views[3].fill_(True)
    for v in views[:3]:
        v.fill_(-1)
    assert views[3].all() and all((v == -1).all() for v in views[:3])


def _cpu_args():
    cols, _ = _case("counter_puts")
    return _tensors(cols)


# (wrapper, its arguments from the six columns)
WRAPPERS = {
    "succ_vis": (SV.succ_vis, lambda a, t, v, c, s, g: (a, t, v, c, s, g)),
    "succ_partial": (SV.succ_partial, lambda a, t, v, c, s, g: (a, v, c, s, g)),
    "visibility": (SV.visibility, lambda a, t, v, c, s, g: (a, t, c, v, v)),
}


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("bad, error", [
    (lambda x: x.to(torch.int64), TypeError),
    (lambda x: x[:-1], ValueError),
    (lambda x: torch.stack([x, x], 1)[:, 0], ValueError),
    (lambda x: x.numpy(), TypeError),
    (lambda x: x.to("meta"), ValueError),
], ids=["dtype", "shape", "strided", "not-tensor", "other-device"])
def test_wrappers_reject_bad_first_column(wrapper, bad, error):
    """One pass over the columns, raising what expect and on_cuda raise."""
    fn, pick = WRAPPERS[wrapper]
    args = list(pick(*_cpu_args()))
    args[0] = bad(args[0])
    with pytest.raises(error):
        fn(*args)
