"""Run-coded staging and the packed transport of the port against the JAX
package, on the CPU.

The JAX package stages a merge's columns as slope-RLE run tables
(``_slope_rle``): run-native by default (decoded inside the resolution),
eagerly expanded under ``AUTOMERGE_TPU_RUN_NATIVE=0``, dense under
``AUTOMERGE_TPU_COMPRESSED=0``; its packed transport (``AUTOMERGE_TPU_
TRANSPORT=packed``) sends run tables and flag-packed columns and reads one
flat bit-packed vector back. The port's ``staging=`` and ``transport=``
arguments are those modes. The same seeded numpy inputs go through both
packages, and everything must be equal exactly (all int32/bool):
the encoders, the decode (``expand_runs``' plain version against
``_expander`` and ``_expand``), the flags split, the emit and its
readback, every output of every staging, the packed transport, a served
drain, and the bytes each staging copies.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu import bench as JB
from automerge_tpu import obs
from automerge_tpu.ops import extract as JX
from automerge_tpu.ops import merge as J
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu_torch import workload as W
from automerge_tpu_torch.kernels import emit_packed as EP
from automerge_tpu_torch.kernels import expand_runs as E
from automerge_tpu_torch.ops import merge as M
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.oplog import OpLog, pad_columns
from automerge_tpu_torch.storage.change import parse_change

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


@pytest.fixture(autouse=True)
def cold_jax_change_cache(monkeypatch):
    """The JAX package's per-change-hash extraction cache keeps, for each
    change it decoded, the key table of the whole batch the change came
    in: a later log assembled from those entries numbers its map keys
    differently (unused names included). Each test starts it empty."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)


# -- column generators (seeded numpy) -----------------------------------------


def _runs(rng, n, n_runs, slope=0, lo=-50, hi=50):
    """n rows in n_runs runs of value + slope * i (values may be negative)."""
    cuts = np.sort(rng.choice(np.arange(1, n), n_runs - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    x = np.empty(n, np.int64)
    vals = rng.integers(lo, hi, n_runs)
    for r in range(n_runs):
        if r and vals[r] == vals[r - 1]:
            vals[r] += 1  # adjacent runs differ: exactly n_runs runs
        x[bounds[r]:bounds[r + 1]] = vals[r]
    return (x + slope * np.arange(n)).astype(np.int32)


def _stride(rng, n, N=5):
    """Stride-N interleave, as N replicas' same-counter ops leave an
    elem_ref column in Lamport order: runs that step by N."""
    x = np.arange(n, dtype=np.int64) * N - 7
    x[n // 3:] += 1000
    x[2 * n // 3:] -= 5000
    return x.astype(np.int32)


COLUMNS = {
    "constant": lambda rng: np.full(500, -3, np.int32),
    "ramp": lambda rng: (np.arange(700) - 350).astype(np.int32),
    "stride_N": lambda rng: _stride(rng, 1200),
    "negative_runs": lambda rng: _runs(rng, 900, 40, lo=-(1 << 30), hi=-5),
    "extreme_values": lambda rng: np.repeat(
        np.array([INT32_MIN, INT32_MAX, 0, INT32_MIN], np.int32), 64),
    "bool": lambda rng: np.repeat(rng.random(30) < 0.5, 40),
    "n8_edge_in": lambda rng: _runs(rng, 256, 32),  # n // 8 runs: encodes
    "n8_edge_out": lambda rng: _runs(rng, 256, 33),  # one run more: plain
    "gate_edge_n32": lambda rng: _runs(rng, 32, 15),  # 15 runs, 2*15 < 32
    "gate_edge_n32_out": lambda rng: _runs(rng, 32, 16),
    "short_n31": lambda rng: _runs(rng, 31, 3),
    "big_stride": lambda rng: (np.arange(400, dtype=np.int64) << 21).astype(np.int32),
    "random": lambda rng: rng.integers(INT32_MIN, INT32_MAX, 300).astype(np.int32),
    "one_row": lambda rng: np.array([9], np.int32),
    "empty": lambda rng: np.zeros(0, np.int32),
    # steps of 2 and 3 equally often in the first 2^16 rows, then steps
    # of 3: the modal difference is the smaller, 2, and nothing encodes
    # (slope 3 would)
    "mode_tie": lambda rng: np.cumsum(np.concatenate([
        [0], np.full(32_767, 2), np.full(32_767, 3), [0],
        np.full(200_000, 3)])).astype(np.int32),
    # stride 3 with jumps of +-2^30: differences too spread to count
    "wide_differences": lambda rng: (np.arange(1000) * 3 + np.repeat(
        rng.choice([-(1 << 30), 0, 1 << 30], 10), 100)).astype(np.int32),
    # slope 2^19 over 70,000 rows wraps int32: its run values overflow
    "wrapping_slope": lambda rng: (np.arange(70_000, dtype=np.int64) << 19).astype(np.int32),
    # the modal difference is taken over the first 2^16 rows only: they
    # are constant, the million after them step by 7 (slope 7 would encode)
    "beyond_head": lambda rng: np.concatenate([
        np.zeros(1 << 16), np.arange(1_000_000) * 7]).astype(np.int32),
}


def _column(name):
    return COLUMNS[name](np.random.default_rng(sorted(COLUMNS).index(name)))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_slope_rle_equals_jax(name):
    x = _column(name)
    x = x.astype(np.int32) if x.dtype == np.bool_ else x
    got, want = M._slope_rle(x), J._slope_rle(x)
    assert (got is None) == (want is None)
    if want is not None:
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2]


# -- op-column workloads --------------------------------------------------------


def _text_blobs():
    trace = JB.load_trace(3000)
    base = JB.build_base(trace, 2000)
    return [c.raw_bytes for c in base.changes + JB.synth_fanin(base, trace, 16, 125, 2000)]


def _record_blobs():
    base, reps, _ = W.record_store(256, 16, 20)
    return [c.raw_bytes for c in [base] + reps]


def _small_blobs():
    trace = JB.load_trace(120)
    base = JB.build_base(trace, 40)
    return [c.raw_bytes for c in base.changes + JB.synth_fanin(base, trace, 2, 3, 40)]


WORKLOADS = {"text": _text_blobs, "records": _record_blobs, "small": _small_blobs}


@functools.lru_cache(maxsize=None)
def _log(name):
    return OpLog.from_changes([parse_change(b)[0] for b in WORKLOADS[name]()])


def _synthetic_cols(seed):
    """Padded columns with every encoding class: runs, stride-N and slope
    runs, negative values, bool runs, a column past the n/8 gate."""
    rng = np.random.default_rng(seed)
    P, Q = 4096, 1024
    return {
        "action": _runs(rng, P, 9, lo=0, hi=8),
        "insert": np.repeat(rng.random(64) < 0.5, P // 64),
        "prop": _runs(rng, P, 30, lo=-1, hi=40),
        "elem_ref": _elem_refs(P),
        "obj_dense": np.sort(rng.integers(0, 50, P)).astype(np.int32),
        "value_tag": _runs(rng, P, 12, lo=0, hi=9),
        "value_i32": rng.integers(INT32_MIN, INT32_MAX, P).astype(np.int32),
        "width": _runs(rng, P, 5, lo=1, hi=4),
        "covered": np.ones(P, bool),
        "pred_src": (np.arange(Q) * 3).astype(np.int32),
        "pred_tgt": _runs(rng, Q, 100, slope=3, lo=-1, hi=1000),
    }


def _elem_refs(P):
    """Stride-7 references into the rows, HEAD (-1) and map-op (-2) runs."""
    er = (np.arange(P, dtype=np.int64) * 7 % (P - 1)).astype(np.int32)
    er[:100] = -1
    er[-200:] = -2
    return er


COLSETS = ["text", "records", "small", "synthetic"]


def _cols(name):
    if name == "synthetic":
        return _synthetic_cols(5)
    log = _log(name)
    return log.padded_columns()


@pytest.mark.parametrize("name", COLSETS)
def test_flags_column_and_encode_transport_equal_jax(name):
    cols = _cols(name)
    np.testing.assert_array_equal(M._flags_column(cols), J._flags_column(cols))
    key, arrays = M.encode_transport(cols)
    jkey, jarrays = J.encode_transport(cols)
    assert key == jkey
    assert set(arrays) == set(jarrays)
    for k in jarrays:
        assert arrays[k].dtype == jarrays[k].dtype, k
        np.testing.assert_array_equal(arrays[k], jarrays[k], err_msg=k)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", COLSETS)
def test_unpack_transport_equals_jax(name):
    cols = _cols(name)
    key, arrays = J.encode_transport(cols)
    P, Q = len(cols["action"]), len(cols["pred_src"])
    want = J._unpack_transport(key, {k: jnp.asarray(v) for k, v in arrays.items()},
                               P, Q)
    got = M._unpack_transport(key, {k: _t(v) for k, v in arrays.items()}, P, Q)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def _stack(rng, K, n, rcap, wrap):
    """(W, C, S): run ends ascending and padded with n; with ``wrap``,
    values and slopes over the whole int32 range, so S * i wraps."""
    hi = 1 << 31 if wrap else 100
    W = rng.integers(-hi, hi, (K, rcap), dtype=np.int64).astype(np.int32)
    C = np.full((K, rcap), n, np.int32)
    for k in range(K):
        runs = int(rng.integers(1, min(rcap, n) + 1))
        C[k, : runs - 1] = np.sort(rng.choice(np.arange(1, n), runs - 1, replace=False))
    S = rng.integers(-hi, hi, K, dtype=np.int64).astype(np.int32)
    return W, C, S


@pytest.mark.parametrize("n,rcap,wrap", [
    (32, 16, False), (1000, 16, True), (4096, 64, True), (4099, 256, False),
], ids=["n32", "n1000_wrap", "n4096_wrap", "n4099"])
def test_expand_runs_plain_equals_expander_and_expand(n, rcap, wrap):
    rng = np.random.default_rng(n)
    Wn, Cn, Sn = _stack(rng, 6, n, rcap, wrap)
    bools = (False, True, False, True, False, False)
    want = J._expander(n, rcap, bools)(jnp.asarray(Wn), jnp.asarray(Cn), jnp.asarray(Sn))
    got = E.expand_runs(_t(Wn), _t(Cn), _t(Sn), n, bools)
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
        e = np.asarray(J._expand(jnp.asarray(Wn[k]), jnp.asarray(Cn[k]), Sn[k], n))
        if not bools[k]:
            np.testing.assert_array_equal(g.numpy(), e)
    # the rle form: no slope term
    got = E.expand_runs(_t(Wn), _t(Cn), None, n, bools)
    want = J._expander(n, rcap, bools)(jnp.asarray(Wn), jnp.asarray(Cn),
                                       jnp.zeros(6, jnp.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unpack_flags_plain_splits_every_bit_pattern():
    flags = np.random.default_rng(3).integers(INT32_MIN, INT32_MAX, 5000).astype(np.int32)
    want = J._unpack_transport(((), ("flags",), (), ()),
                               {"plainP": jnp.asarray(flags[None])}, 5000, 0)
    got = E.unpack_flags(_t(flags))
    for g, k in zip(got, ("action", "insert", "value_tag", "covered")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("name", ["text", "records", "small"])
def test_emit_equals_jax_and_split_flat_round_trips(name):
    cols = _cols(name)
    log = _log(name)
    core = M.merge_kernel(M.columns_from_numpy(cols, "cpu"), log.n_objs,
                          len(log.props))
    P = len(cols["action"])
    obj_cap = min(M._capacity(log.n_objs + 2, 16), P + 2)
    fetch = M.ALL_OUTPUTS
    flat = EP.emit_packed(core, fetch, obj_cap)
    want = J._emit({k: jnp.asarray(v.numpy()) for k, v in core.items()}, fetch,
                   obj_cap)
    assert flat.dtype == torch.int32
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = M._split_flat(flat.numpy(), fetch, P, obj_cap)
    jback = J._split_flat(np.asarray(want), fetch, P, obj_cap)
    for k in fetch:
        v = core[k].numpy()
        if k in M.OBJ_STATS:
            v = v[:obj_cap]
        if k == "conflicts":
            v = np.where(v > 1, 2, 1).astype(np.int32)
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        np.testing.assert_array_equal(back[k], jback[k], err_msg=k)
        assert back[k].dtype == jback[k].dtype, k


# -- stagings: the port's keyword against the JAX package's environment ---------

STAGING_ENV = {
    "run_native": {"AUTOMERGE_TPU_COMPRESSED": "1", "AUTOMERGE_TPU_RUN_NATIVE": "1"},
    "expand": {"AUTOMERGE_TPU_COMPRESSED": "1", "AUTOMERGE_TPU_RUN_NATIVE": "0"},
    "dense": {"AUTOMERGE_TPU_COMPRESSED": "0"},
}


def _jax_counter(name):
    return obs.counter_values(name, "").get("", 0)


@pytest.mark.parametrize("name", COLSETS)
@pytest.mark.parametrize("staging", sorted(STAGING_ENV))
def test_merge_columns_staging_equals_jax(monkeypatch, name, staging):
    """All 13 outputs of each staging equal the JAX package's, and so do
    the bytes it copies to the device and their dense equivalent."""
    for k, v in STAGING_ENV[staging].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("AUTOMERGE_TPU_TRANSPORT", "dict")
    cols = _cols(name)
    h0, d0 = _jax_counter("device.h2d_bytes"), _jax_counter("device.h2d_dense_bytes")
    want = J.merge_columns(dict(cols), linearize="device")
    h1, d1 = _jax_counter("device.h2d_bytes"), _jax_counter("device.h2d_dense_bytes")
    phases = {}
    got = M.merge_columns(dict(cols), device="cpu", staging=staging, phases=phases)
    for k in M.ALL_OUTPUTS:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert (phases["h2d_bytes"], phases["h2d_dense_bytes"]) == (h1 - h0, d1 - d0)
    if staging != "dense" and name != "small":
        assert phases["h2d_bytes"] < phases["h2d_dense_bytes"]


@pytest.mark.parametrize("name", COLSETS)
def test_run_native_plan_and_stacks_equal_jax(monkeypatch, name):
    monkeypatch.setenv("AUTOMERGE_TPU_COMPRESSED", "1")
    cols = _cols(name)
    jdense, jstacks, jplan = J.stage_cols_run_native(dict(cols))
    dense, stacks, plan = M.stage_cols_run_native(dict(cols), "cpu")
    assert plan == jplan
    assert set(dense) == set(jdense)
    for arrs, jarrs in zip(stacks, jstacks):
        assert len(arrs) == len(jarrs)
        for a, j in zip(arrs, jarrs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    expanded = M.stage_cols_device(dict(cols), "cpu")
    jexpanded = J.stage_cols_device(dict(cols))
    for k in cols:
        np.testing.assert_array_equal(expanded[k].numpy(), np.asarray(jexpanded[k]),
                                      err_msg=k)


# -- the packed transport --------------------------------------------------------


def _flag(res, k):
    return res[k] > 1 if k == "conflicts" else res[k]


@pytest.mark.parametrize("name", ["text", "records", "small"])
@pytest.mark.parametrize("with_props", [True, False], ids=["scatter", "sort"])
def test_packed_transport_equals_jax(monkeypatch, name, with_props):
    """Packed against the JAX package's packed transport, on READ_FETCH.
    Without n_props the JAX package packs its sort key with obj_cap
    (merge.py:144-152), which merges groups once a prop id + 4 reaches
    2^ceil_log2(P + 5); on these whole logs every prop id is below P,
    so its key is injective and the two must agree. The inputs are logs:
    the JAX package's packed transport ranks document order with a host
    walk, which agrees with the linearize kernel on the forests a log
    holds (not on the synthetic columns' references)."""
    monkeypatch.setenv("AUTOMERGE_TPU_TRANSPORT", "packed")
    cols = _cols(name)
    P = len(cols["action"])
    n_objs = int(cols["obj_dense"][cols["action"] != 15].max()) + 1
    n_props = int(cols["prop"].max()) + 1 if with_props else None
    assert int(cols["prop"].max()) + 4 < 1 << int(np.ceil(np.log2(P + 5)))
    fetch = DeviceDoc.READ_FETCH
    want = J.merge_columns(dict(cols), linearize="device", fetch=fetch,
                           n_objs=n_objs, n_props=n_props)
    phases = {}
    got = M.merge_columns(dict(cols), fetch=fetch, n_objs=n_objs, n_props=n_props,
                          device="cpu", transport="packed", phases=phases)
    for k in fetch:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k
    # against the port's dict path: conflicts as a flag, all else exact
    ref = M.merge_columns(dict(cols), fetch=fetch, n_objs=n_objs, n_props=n_props,
                          device="cpu")
    for k in fetch:
        cut = min(len(got[k]), len(ref[k]))
        np.testing.assert_array_equal(_flag(got, k)[:cut], _flag(ref, k)[:cut],
                                      err_msg=k)
    assert phases["d2h_bytes"] < sum(v.nbytes for v in ref.values())


def _fault_cols():
    """Two visible map puts, P = 16 after padding: object 0 prop 64 and
    object 1 prop 0. 64 + 4 needs more than ceil_log2(16 + 5) = 5 bits."""
    return {
        "action": np.array([1, 1], np.int32), "insert": np.zeros(2, bool),
        "prop": np.array([64, 0], np.int32),
        "elem_ref": np.array([-2, -2], np.int32),
        "obj_dense": np.array([0, 1], np.int32),
        "value_tag": np.array([4, 4], np.int32),
        "value_i32": np.zeros(2, np.int32), "width": np.ones(2, np.int32),
        "covered": np.ones(2, bool),
        "pred_src": np.zeros(0, np.int32), "pred_tgt": np.zeros(0, np.int32),
    }


def test_packed_transport_gives_the_dict_answer_where_the_jax_key_overflows(monkeypatch):
    fetch = DeviceDoc.READ_FETCH
    monkeypatch.setenv("AUTOMERGE_TPU_TRANSPORT", "dict")
    want = J.merge_columns(_fault_cols(), linearize="device", fetch=fetch,
                           n_objs=2, n_props=None)
    got = M.merge_columns(_fault_cols(), fetch=fetch, n_objs=2, n_props=None,
                          device="cpu", transport="packed")
    np.testing.assert_array_equal(want["winner"][:2], [0, 1])
    for k in fetch:
        w = np.asarray(want[k])
        cut = min(len(got[k]), len(w))
        np.testing.assert_array_equal(_flag(got, k)[:cut], _flag({k: w}, k)[:cut],
                                      err_msg=k)
    # the JAX package's own packed transport merges the two groups
    monkeypatch.setenv("AUTOMERGE_TPU_TRANSPORT", "packed")
    jpacked = J.merge_columns(_fault_cols(), linearize="device", fetch=fetch,
                              n_objs=2, n_props=None)
    np.testing.assert_array_equal(jpacked["winner"][:2], [1, 1])


def test_device_doc_resolves_with_the_packed_transport():
    blobs = _text_blobs()
    doc = DeviceDoc.merge(blobs, device="cpu", transport="packed")
    ref = DeviceDoc.merge(blobs, device="cpu")
    jdoc = JDeviceDoc.resolve(JOpLog.from_changes([j_parse_change(b)[0] for b in blobs]))
    text_obj = [v[2] for _, v, _ in ref.map_entries() if v[0] == "obj"][0]
    assert doc.text(text_obj) == ref.text(text_obj) == jdoc.text(text_obj)
    n = doc.log.n
    for k in DeviceDoc.READ_FETCH:
        cut = n if not k.startswith("obj_") else doc.log.n_objs + 2
        np.testing.assert_array_equal(_flag(doc.res, k)[:cut], _flag(ref.res, k)[:cut],
                                      err_msg=k)


# -- the served drain --------------------------------------------------------------


def test_served_drain_decodes_run_tables_and_equals_jax(monkeypatch):
    """The card's pipelined drain (here on the plain versions) stages each
    batch run-native, decoding its run tables in every batch, and ends
    where the JAX package's DeviceDoc drain does."""
    base, reps, expect = W.record_store(256, 32, 20)
    blobs = [r.raw_bytes for r in reps]
    batches = W.record_batches(blobs, 4)
    decodes = []
    expand = M.expand_runs

    def counting(*a, **k):
        decodes.append(len(a[4]))
        return expand(*a, **k)

    monkeypatch.setattr(M, "expand_runs", counting)
    served = DeviceDoc.merge([base.raw_bytes], device="cpu")
    per_batch = []
    for batch in batches:
        del decodes[:]
        served._apply_pipelined([batch])
        per_batch.append(len(decodes))
    assert all(per_batch), per_batch
    jdoc = JDeviceDoc.resolve(JOpLog.from_changes([j_parse_change(base.raw_bytes)[0]]))
    jdoc.apply_batches([[j_parse_change(b)[0] for b in batch] for batch in batches])
    n = served.log.n
    assert n == jdoc.log.n
    for k in DeviceDoc.READ_FETCH:
        cut = served.log.n_objs + 2 if k.startswith("obj_") else n
        np.testing.assert_array_equal(np.asarray(served.res[k])[:cut],
                                      np.asarray(jdoc.res[k])[:cut], err_msg=k)
    assert W.record_counts(served) == expect


@pytest.mark.parametrize("staging", ["expand", "dense"])
def test_served_document_keeps_its_staging(staging):
    base, reps, expect = W.record_store(64, 8, 20)
    doc = DeviceDoc.merge([base.raw_bytes], device="cpu", staging=staging)
    assert doc.staging == staging
    doc.apply_batches(W.record_batches([r.raw_bytes for r in reps], 2))
    assert doc.staging == staging
    assert W.record_counts(doc) == expect


def test_unknown_staging_or_transport_raises():
    cols = _cols("small")
    with pytest.raises(ValueError, match="staging"):
        M.merge_columns(dict(cols), device="cpu", staging="lazy")
    with pytest.raises(ValueError, match="transport"):
        M.merge_columns(dict(cols), device="cpu", transport="tunnel")


def test_subset_columns_pad_like_the_served_path():
    """A served subset's columns (prop ids of the whole log, P small)
    stage run-native and merge to the dense staging's outputs."""
    base, reps, _ = W.record_store(256, 16, 20)
    doc = DeviceDoc.merge([base.raw_bytes] + [r.raw_bytes for r in reps], device="cpu")
    dirty = np.array([1, 5, 9], np.int64)
    cols = pad_columns(doc._subset_cols(doc._subset_rows(dirty), dirty), len(dirty))
    assert int(cols["prop"].max()) > len(cols["action"]) // 4
    outs = [M.prepare_resolution(cols, len(dirty), len(doc.log.props), "cpu", s)()
            for s in M.STAGINGS]
    for k in M.ALL_OUTPUTS:
        for o in outs[1:]:
            assert torch.equal(o[k], outs[0][k]), k
