"""automerge_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card. Marked ``gpu``: they skip where no CUDA device is present.

They import neither JAX nor automerge_tpu, so they also run where only
the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from automerge_tpu_torch import workload as W
from automerge_tpu_torch.convert import columns_from_numpy
from automerge_tpu_torch.kernels import forest as F
from automerge_tpu_torch.kernels import launch_counts, reset_launches
from automerge_tpu_torch.kernels import linearize as L
from automerge_tpu_torch.kernels import linearize_condensed as LC
from automerge_tpu_torch.kernels import scatter_winners as SW
from automerge_tpu_torch.kernels import sort_winners as SO
from automerge_tpu_torch.kernels import succ_vis as SV
from automerge_tpu_torch.ops.device_doc import DeviceDoc
from automerge_tpu_torch.ops.merge import ALL_OUTPUTS, merge_columns
from automerge_tpu_torch.ops.merge import condensed_caps, merge_kernel_condensed
from automerge_tpu_torch.ops.merge import scatter_geom_key, stage_cols_run_native
from automerge_tpu_torch.ops.oplog import OpLog
from automerge_tpu_torch.storage.change import parse_change

pytestmark = pytest.mark.gpu

# (base edits, replicas, edits per replica): P = 4096 and P = 24576, the
# latter a bucket above 8k, so not a power of two
SIZES = [(2000, 16, 100), (20000, 8, 100)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _log(base_edits, replicas, per):
    trace = W.load_trace(base_edits + 1000)
    base = W.build_base(trace, base_edits)
    return OpLog.from_changes(
        base.changes + W.synth_fanin(base, trace, replicas, per, base_edits))


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernels_equal_plain_versions(cuda, size):
    log = _log(*size)
    c = columns_from_numpy(log.padded_columns(), cuda)
    sv_in = (c["action"], c["value_tag"], c["value_i32"], c["covered"],
             c["pred_src"], c["pred_tgt"])
    sv = SV.succ_vis(*sv_in)
    _same(sv, SV.succ_vis_plain(*sv_in))
    n_objs2, n_props = scatter_geom_key(log.n_objs, len(log.props))
    sw_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"], c["prop"],
             c["width"], sv[3], n_objs2, n_props)
    _same(SW.scatter_winners(*sw_in), SW.scatter_winners_plain(*sw_in))
    fo_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
    fo = F.forest(*fo_in)
    _same(fo, F.forest_plain(*fo_in))
    li_in = (fo[2], fo[3], fo[0], c["elem_ref"], c["obj_dense"])
    _same(L.linearize(*li_in), L.linearize_plain(*li_in))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 4096, 24577])
def test_bitonic_sort_any_length(cuda, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)).to(cuda)
    _same(F.bitonic_sort(keys), torch.sort(keys).values)


def test_merge_on_card_equals_cpu_and_counts_launches(cuda):
    log = _log(*SIZES[1])
    kw = dict(n_objs=log.n_objs, n_props=len(log.props))
    reset_launches()
    gpu = merge_columns(log.columns(), device=cuda, **kw)
    P = len(log.padded_columns()["action"])
    sort_stages = (P - 1).bit_length()  # log2 of the padded sort length
    assert launch_counts() == {
        "succ_vis": 3,  # fill, edges, visibility
        "scatter_winners": 5,  # three fills, scatter, gather
        "sort_winners": 0,  # the text fan-in passes the scatter gate
        "forest": 4,  # two fills, links, next_sib
        "bitonic_sort": 1 + sort_stages * (sort_stages + 1) // 2,
        "linearize": 2 * L.rounds(P) + 3,
        "linearize_condensed": 0,  # merge_kernel_condensed's
        # run-native staging: one decode per stack of run tables
        "expand_runs": len(stage_cols_run_native(log.padded_columns(), "cpu")[2]),
        "unpack_flags": 0,  # the packed transport's
        "emit_packed": 0,
    }
    cpu = merge_columns(log.columns(), device="cpu", **kw)
    for k in ALL_OUTPUTS:
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)


# (P, max prop id): a small P whose prop ids exceed it, as a subset
# re-resolve's do, and P above 2^20, where a key that also packed the row
# would overflow int64
WINNER_SIZES = [(1000, (1 << 31) - 1), (24576, 70_000), ((1 << 20) + 12_345, 70_000)]


@pytest.mark.parametrize("size", WINNER_SIZES, ids=lambda s: f"P{s[0]}")
def test_sort_winners_equals_plain_version(cuda, size):
    import chip_smoke

    args = chip_smoke.winner_columns(size[0], 7, cuda, max_prop=size[1])
    reset_launches()
    got = SO.sort_winners(*args)
    M = 1 << (size[0] - 1).bit_length()
    stages = (M - 1).bit_length()
    assert launch_counts()["sort_winners"] == 3 + stages * (stages + 1) // 2
    _same(got, SO.sort_winners_plain(*args))


def _record_store():
    base, reps, expect = W.record_store(1024, 64, 60)
    return base.raw_bytes, [r.raw_bytes for r in reps], expect


def test_record_store_merge_on_card_takes_sort_winners(cuda):
    base, reps, expect = _record_store()
    log = OpLog.from_changes([parse_change(b)[0] for b in [base] + reps])
    kw = dict(n_objs=log.n_objs, n_props=len(log.props))
    reset_launches()
    gpu = merge_columns(log.columns(), device=cuda, **kw)
    counts = launch_counts()
    assert counts["sort_winners"] > 0 and counts["scatter_winners"] == 0
    cpu = merge_columns(log.columns(), device="cpu", **kw)
    for k in ALL_OUTPUTS:
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)


def test_served_record_store_on_card_equals_cpu(cuda):
    """The card's pipelined apply_batches ends where the CPU's sequential
    one does, and where the one-shot merge does."""
    base, reps, expect = _record_store()
    batches = W.record_batches(reps, 8)
    docs = {}
    for dev in (cuda, "cpu"):
        doc = DeviceDoc.merge([base], device=dev)
        assert doc.apply_batches(batches) == len(reps)
        docs[str(dev)] = doc
    merged = DeviceDoc.merge([base] + reps, device=cuda)
    gpu = docs[str(cuda)]
    n = merged.log.n
    for other in (docs["cpu"], merged):
        for k in DeviceDoc.READ_FETCH:
            cut = n if not k.startswith("obj_") else merged.log.n_objs + 2
            np.testing.assert_array_equal(np.asarray(gpu.res[k])[:cut],
                                          np.asarray(other.res[k])[:cut], err_msg=k)
    np.testing.assert_array_equal(gpu.counter_val[:n], merged.counter_val[:n])
    assert W.record_counts(gpu) == expect


# -- run-coded staging and the packed transport (kernels A, B, C) -----------


def _run_stack(rng, K, n, rcap, delta):
    """A random (K, rcap) stack: run ends ascending, the last real run
    ending at n and the padding at n; values and slopes over the whole
    int32 range, so the slope term wraps."""
    W = rng.integers(-(1 << 31), 1 << 31, (K, rcap), dtype=np.int64).astype(np.int32)
    C = np.full((K, rcap), n, np.int32)
    for k in range(K):
        runs = int(rng.integers(1, rcap + 1))
        C[k, : runs - 1] = np.sort(rng.choice(np.arange(1, max(n, 2)), runs - 1))
    S = (rng.integers(-(1 << 31), 1 << 31, K, dtype=np.int64).astype(np.int32)
         if delta else None)
    return W, C, S


@pytest.mark.parametrize("n", [1, 33, 1000, 24_577])
@pytest.mark.parametrize("rcap", [16, 256])
@pytest.mark.parametrize("delta", [False, True], ids=["rle", "delta"])
def test_expand_runs_equals_plain_version(cuda, n, rcap, delta):
    from automerge_tpu_torch.kernels import expand_runs as E

    rng = np.random.default_rng(n + rcap)
    K = 7
    W, C, S = _run_stack(rng, K, n, rcap, delta)
    bools = (False, True, False, False, True, False, True)
    args = [torch.from_numpy(a).to(cuda) if a is not None else None
            for a in (W, C, S)]
    reset_launches()
    got = E.expand_runs(*args, n, bools)
    assert launch_counts()["expand_runs"] == 1
    _same(got, E.expand_runs_plain(*args, n, bools))


@pytest.mark.parametrize("n", [1, 1000, 24_577])
def test_unpack_flags_equals_plain_version(cuda, n):
    from automerge_tpu_torch.kernels import expand_runs as E

    rng = np.random.default_rng(n)
    flags = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)).to(cuda)
    reset_launches()
    got = E.unpack_flags(flags)
    assert launch_counts()["unpack_flags"] == 1
    _same(got, E.unpack_flags_plain(flags))


@pytest.mark.parametrize("P", [16, 48, 4096, 24_592])
def test_emit_packed_equals_plain_version(cuda, P):
    from automerge_tpu_torch.kernels import emit_packed as EP

    rng = np.random.default_rng(P)
    core = {
        "visible": torch.from_numpy(rng.random(P) < 0.5).to(cuda),
        "conflicts": torch.from_numpy(rng.integers(0, 4, P).astype(np.int32)).to(cuda),
        "winner": torch.from_numpy(rng.integers(-1, P, P).astype(np.int32)).to(cuda),
        "is_elem": torch.from_numpy(rng.random(P) < 0.3).to(cuda),
        "next_sib": torch.from_numpy(rng.integers(-1, P, 2 * P + 3).astype(np.int32)).to(cuda),
        "obj_vis_len": torch.from_numpy(rng.integers(0, 9, P + 2).astype(np.int32)).to(cuda),
    }
    fetch = ("visible", "winner", "conflicts", "is_elem", "next_sib", "obj_vis_len")
    reset_launches()
    got = EP.emit_packed(core, fetch, 18)
    assert launch_counts()["emit_packed"] == 1
    _same(got, EP.emit_packed_plain(core, fetch, 18))


@pytest.mark.parametrize("staging", ["run_native", "expand", "dense"])
def test_stagings_and_packed_transport_on_card_equal_cpu(cuda, staging):
    """Every staging on the card equals the CPU on all 13 outputs; the
    packed transport on the card equals the dict path on READ_FETCH
    (conflicts as a flag) and launches kernels A, B and C."""
    log = _log(*SIZES[1])
    kw = dict(n_objs=log.n_objs, n_props=len(log.props))
    reset_launches()
    gpu = merge_columns(log.columns(), device=cuda, staging=staging, **kw)
    assert (launch_counts()["expand_runs"] > 0) == (staging != "dense")
    cpu = merge_columns(log.columns(), device="cpu", staging="dense", **kw)
    for k in ALL_OUTPUTS:
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    reset_launches()
    packed = merge_columns(log.columns(), fetch=DeviceDoc.READ_FETCH, device=cuda,
                           transport="packed", **kw)
    counts = launch_counts()
    assert counts["expand_runs"] and counts["unpack_flags"] and counts["emit_packed"]
    for k in DeviceDoc.READ_FETCH:
        want = cpu[k] > 1 if k == "conflicts" else cpu[k]
        got = packed[k] > 1 if k == "conflicts" else packed[k]
        cut = min(len(got), len(want))  # the stats: obj_cap vs n_objs + 2
        np.testing.assert_array_equal(got[:cut], want[:cut], err_msg=k)


# -- chain-condensed document order (K8) ------------------------------------


def _typing_log(base_edits, replicas, per):
    trace = W.typing_trace(base_edits + 1000, seed=3)
    base = W.build_base(trace, base_edits)
    return OpLog.from_changes(
        base.changes + W.synth_fanin(base, trace, replicas, per, base_edits))


def _condensed_logs():
    """(name, log): a typing log (rcap well under P), the synthetic trace's
    (rcap near P: it barely chains), one whose P (24,576) is no power of
    two, a prepend-only document (every element its own run) and a record
    store (no sequence: an empty actor order, one run)."""
    from automerge_tpu_torch.storage.change import (
        HEAD_STORED, ChangeOp, StoredChange, build_change,
    )
    from automerge_tpu_torch.types import Key, ScalarValue

    ops = [ChangeOp(obj=(0, -1), key=Key.map("t"), insert=False, action=4,
                    value=ScalarValue("null"))]
    for i in range(300):  # each insert at HEAD
        ops.append(ChangeOp(obj=(1, 0), key=Key.seq(HEAD_STORED), insert=True, action=1,
                            value=ScalarValue("str", "p")))
    prepend = build_change(StoredChange(
        dependencies=[], actor=bytes([9]) * 16, other_actors=[], seq=1, start_op=1,
        timestamp=0, message=None, ops=ops))
    base, reps, _ = _record_store()
    return [
        ("typing", _typing_log(2000, 16, 100)),
        ("synthetic", _log(2000, 16, 100)),
        ("P24576", _typing_log(20000, 8, 100)),
        ("prepend", OpLog.from_changes([prepend])),
        ("records", OpLog.from_changes([parse_change(b)[0] for b in [base] + reps])),
    ]


def test_linearize_condensed_equals_plain_version(cuda):
    for name, log in _condensed_logs():
        rcap = condensed_caps(log)
        c = columns_from_numpy(log.padded_columns(include_aorder=True), cuda)
        fo = F.forest(c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
        args = (fo[2], fo[3], fo[0], c["elem_ref"], c["obj_dense"], c["aorder"],
                rcap)
        reset_launches()
        got = LC.linearize_condensed(*args)
        assert launch_counts()["linearize_condensed"] == 8 + 2 * LC.rounds(rcap), name
        _same(got, LC.linearize_condensed_plain(*args))
        li = L.linearize(fo[2], fo[3], fo[0], c["elem_ref"], c["obj_dense"])
        _same(got, li)
        if name == "records":
            assert log.condensed_run_count() == 1
            assert int((c["aorder"] < c["aorder"].numel()).sum()) == 0


def test_linearize_condensed_raises_when_the_runs_exceed_rcap(cuda):
    log = _log(2000, 16, 100)
    runs = log.condensed_run_count()
    c = columns_from_numpy(log.padded_columns(include_aorder=True), cuda)
    fo = F.forest(c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
    args = (fo[2], fo[3], fo[0], c["elem_ref"], c["obj_dense"], c["aorder"])
    with pytest.raises(ValueError, match=f"{runs} chain runs exceed rcap = {runs - 1}"):
        LC.linearize_condensed(*args, runs - 1)
    _same(LC.linearize_condensed(*args, runs), LC.linearize_condensed_plain(*args, runs))


def test_condensed_merge_on_card_equals_cpu_and_counts_launches(cuda):
    log = _typing_log(2000, 16, 100)
    rcap = condensed_caps(log)
    cols = log.padded_columns(include_aorder=True)
    cpu = merge_kernel_condensed(rcap)(columns_from_numpy(cols, "cpu"))
    reset_launches()
    gpu = merge_kernel_condensed(rcap)(columns_from_numpy(cols, cuda))
    counts = launch_counts()
    assert counts["linearize_condensed"] == 8 + 2 * LC.rounds(rcap)
    assert counts["succ_vis"] and counts["sort_winners"] and counts["forest"]
    assert counts["linearize"] == counts["scatter_winners"] == 0
    for k in ALL_OUTPUTS:
        np.testing.assert_array_equal(gpu[k].cpu().numpy(), cpu[k].numpy(), err_msg=k)
    doc = DeviceDoc(log, {k: v.cpu().numpy() for k, v in gpu.items()}, device=cuda)
    ref = DeviceDoc.resolve(log, device="cpu")
    assert doc.text(f"1@{W.BASE_ACTOR.hex()}") == ref.text(f"1@{W.BASE_ACTOR.hex()}")
