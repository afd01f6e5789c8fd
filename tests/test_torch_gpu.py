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
from automerge_tpu_torch.kernels import radix_sort as RS
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


def _forest_columns(kind, P, rng):
    """(action, insert, elem_ref, obj_dense) of a synthetic element forest:
    one chain typed in order ("chain", as deep as the rows), every element
    a head insert ("star", P siblings), or elements inserted after a random
    earlier element of one of P // 64 objects, or at its head, with a few
    rows no elements ("objects")."""
    action = np.ones(P, np.int32)
    insert = np.ones(P, bool)
    obj = np.zeros(P, np.int32)
    if kind == "chain":
        elem_ref = np.arange(-1, P - 1, dtype=np.int32)
    elif kind == "star":
        elem_ref = np.full(P, -1, np.int32)
    else:
        obj = rng.integers(0, max(P // 64, 1), P).astype(np.int32)
        order = np.argsort(obj, kind="stable")
        first = np.searchsorted(obj[order], obj[order])
        pos = np.arange(P) - first
        pick = first + (rng.random(P) * pos).astype(np.int64)
        elem_ref = np.full(P, -1, np.int32)
        after = (pos > 0) & (rng.random(P) < 0.8)
        elem_ref[order[after]] = order[pick[after]]
        insert = rng.random(P) >= 0.02
    return action, insert, elem_ref, obj


# P = 1, not a power of two, and past 2^20
LINEARIZE_SHAPES = [("chain", 1), ("chain", 4099), ("star", 4099), ("objects", 24_577),
                    ("chain", (1 << 20) + 1), ("star", (1 << 20) + 1),
                    ("objects", (1 << 20) + 12_345)]


@pytest.mark.parametrize("kind,P", LINEARIZE_SHAPES, ids=lambda v: str(v))
def test_linearize_equals_plain_version_and_model(cuda, kind, P):
    """Six launches whatever P; equal to the reference's doubling and to
    the CPU model of the Euler tour."""
    cols = [torch.from_numpy(a).to(cuda)
            for a in _forest_columns(kind, P, np.random.default_rng(P))]
    fo = F.forest(*cols)
    args = (fo[2], fo[3], fo[0], cols[2], cols[3])
    reset_launches()
    got = L.linearize(*args)
    assert launch_counts()["linearize"] == L.LAUNCHES
    _same(got, L.linearize_plain(*args))
    model, _ = L.linearize_tour_model(*(a.cpu().numpy() for a in args))
    _same(got.cpu(), model)


def _sort_keys(kind, n, rng):
    """int64 keys: random over -2^62..2^62, one value repeated (every
    digit shared), one value with and without bit 63, or four values."""
    x = int(rng.integers(0, 1 << 62))
    if kind == "random":
        return rng.integers(-(1 << 62), 1 << 62, n)
    if kind == "same":
        return np.full(n, x - (1 << 61), dtype=np.int64)
    if kind == "sign":
        return np.where(rng.random(n) < 0.5, np.int64(x) + np.int64(-(1 << 63)),
                        np.int64(x))
    return rng.integers(0, 4, n) * np.int64(0x0101010101010101)  # "few"


# around tile (4096 keys) and power-of-two boundaries
SORT_LENGTHS = [0, 1, 2, 3, 1000, 4095, 4096, 4097, 24577,
                (1 << 20) - 1, 1 << 20, (1 << 20) + 1]


@pytest.mark.parametrize("kind", ["random", "same", "sign", "few"])
@pytest.mark.parametrize("n", SORT_LENGTHS)
def test_radix_sort_any_length(cuda, n, kind):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(_sort_keys(kind, n, rng)).to(cuda)
    reset_launches()
    got = RS.radix_sort(keys)
    assert launch_counts()["radix_sort"] == (9 if n else 0)
    _same(got, torch.sort(keys).values)


@pytest.mark.parametrize("digits", [(0,), (1, 6), (0, 2, 3, 7)])
@pytest.mark.parametrize("n", [4097, (1 << 20) + 1])
def test_radix_sort_over_some_digits_is_stable(cuda, n, digits):
    """Keys that tie on the sorted digits keep their input order: each
    pass is stable, or the plain version's stable sort would differ."""
    rng = np.random.default_rng(n + len(digits))
    keys = torch.from_numpy(_sort_keys("random", n, rng)).to(cuda)
    reset_launches()
    got = RS.radix_sort(keys, digits)
    assert launch_counts()["radix_sort"] == 1 + len(digits)
    _same(got, RS.radix_sort_plain(keys, digits))


@pytest.mark.parametrize("P", [4097, (1 << 20) + 1])
def test_forest_keeps_many_siblings_in_descending_rows(cuda, P):
    """Every element inserted at the HEAD of one object (a prepend): one
    parent, P siblings, next_sib running down the rows; then a second
    object whose elements alternate between two parents."""
    rng = np.random.default_rng(P)
    action = np.ones(P, np.int32)
    insert = np.ones(P, bool)
    elem_ref = np.full(P, -1, np.int32)
    obj_dense = np.zeros(P, np.int32)
    half = P // 2
    obj_dense[half:] = 1
    elem_ref[half + 2:] = half + (np.arange(P - half - 2) % 2)
    insert[:half] = rng.random(half) >= 0.01  # a few non-elements among them
    cols = [torch.from_numpy(a).to(cuda) for a in (action, insert, elem_ref, obj_dense)]
    reset_launches()
    got = F.forest(*cols)
    counts = launch_counts()
    assert counts["forest"] == 4
    assert counts["radix_sort"] == 1 + len(F.sibling_digits(P))
    _same(got, F.forest_plain(*cols))
    next_sib = got[3][:P].cpu().numpy()
    first = int(got[2][P].item())  # the first object's root
    chain = [first]
    while next_sib[chain[-1]] >= 0:
        chain.append(int(next_sib[chain[-1]]))
    assert chain == [r for r in range(half - 1, -1, -1) if insert[r]]


def test_merge_on_card_equals_cpu_and_counts_launches(cuda):
    log = _log(*SIZES[1])
    kw = dict(n_objs=log.n_objs, n_props=len(log.props))
    reset_launches()
    gpu = merge_columns(log.columns(), device=cuda, **kw)
    P = len(log.padded_columns()["action"])
    assert launch_counts() == {
        "succ_vis": 3,  # fill, edges, visibility
        "scatter_winners": 5,  # three fills, scatter, gather
        "sort_winners": 0,  # the text fan-in passes the scatter gate
        "forest": 4,  # two fills, links, next_sib
        "radix_sort": 1 + len(F.sibling_digits(P)),  # histogram, one pass a digit
        "linearize": L.LAUNCHES,  # the Euler tour: six launches whatever P
        "linearize_condensed": 0,  # merge_kernel_condensed's
        # run-native staging: one decode per stack of run tables
        "expand_runs": len(stage_cols_run_native(log.padded_columns(), "cpu")[2]),
        "unpack_flags": 0,  # the packed transport's
        "emit_packed": 0,
        # the sharded merge's (parallel/sharding.py)
        "succ_partial": 0, "visibility": 0, "winners_partial": 0,
        "winners_gather": 0, "linearize_init": 0, "linearize_thread": 0,
        "linearize_rank_init": 0, "linearize_rank": 0, "linearize_final": 0,
        "cond_init": 0, "cond_succ": 0, "cond_expand": 0, "mesh_reduce": 0,
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
    assert launch_counts()["sort_winners"] == 3  # fill, insert, gather
    _same(got, SO.sort_winners_plain(*args))


def _group_columns(kind, P, rng):
    """Winner inputs with one hot group (every row a put of one key), every
    row its own group, or prop ids and object ids over the whole int32
    range; about a third of the rows invisible."""
    action = np.ones(P, np.int32)
    insert = np.zeros(P, bool)
    elem_ref = np.full(P, -2, np.int32)
    width = rng.integers(1, 4, P).astype(np.int32)
    visible = rng.random(P) < 0.7
    if kind == "hot":
        obj_dense = np.full(P, 3, np.int32)
        prop = np.full(P, 5, np.int32)
    elif kind == "distinct":
        obj_dense = rng.integers(0, 8, P).astype(np.int32)
        prop = rng.permutation(P).astype(np.int32)
    else:
        obj_dense = rng.integers(0, P + 2, P).astype(np.int32)
        prop = rng.integers(0, 1 << 31, P).astype(np.int32)
        prop[::7] = (1 << 31) - 1
        seq = rng.random(P) < 0.3  # sequence rows: elem_ref keys and inserts
        prop[seq] = -1
        insert[seq] = rng.random(int(seq.sum())) < 0.5
        elem_ref[seq] = rng.integers(-3, P, int(seq.sum()))
    return tuple(torch.from_numpy(a) for a in
                 (action, insert, elem_ref, obj_dense, prop, width, visible))


@pytest.mark.parametrize("kind", ["hot", "distinct", "int32_range"])
@pytest.mark.parametrize("P", [1, 24_577, (1 << 20) + 12_345])
def test_sort_winners_group_extremes(cuda, kind, P):
    args = tuple(a.to(cuda) for a in _group_columns(kind, P, np.random.default_rng(P)))
    reset_launches()
    got = SO.sort_winners(*args)
    assert launch_counts()["sort_winners"] == 3
    _same(got, SO.sort_winners_plain(*args))
    if kind == "hot":
        vis = args[6].nonzero()
        assert int(got[0][0]) == (int(vis.max()) if len(vis) else -1)
        assert int(got[1][0]) == len(vis)


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


def _edge_stack(name, rng):
    """(W, C, S, n) of one edge shape of the tiled decode (4096 rows a
    tile): the run ends shared by every column, values and slopes over the
    whole int32 range."""
    T = 4096
    ends, n, rcap, K = {
        "one run": ([5000], 5000, 1, 3),
        "every row a run": (np.arange(1, 4100), 4099, 4099, 2),
        "rcap far above n": (np.arange(3, 101, 3).tolist() + [100], 100, 8192, 2),
        "n not a tile multiple": (np.arange(7, 3 * T + 5, 7).tolist() + [3 * T + 5],
                                  3 * T + 5, 2048, 2),
        "K 32": (np.arange(11, 6000, 11).tolist() + [6000], 6000, 1024, 32),
        "ends on tile boundaries": ([12, 64, T - 1, T, T + 1, 2 * T, 3 * T - 1, 3 * T,
                                     3 * T + 17], 3 * T + 17, 64, 2),
        "repeated ends": (np.sort(rng.integers(1, 9000, 5000)).tolist() + [9000],
                          9000, 6000, 2),
        "text fan-in width": (np.sort(rng.choice(np.arange(1, 516_096), 300_000,
                                                 replace=False)).tolist() + [516_096],
                              516_096, 300_032, 5),
    }[name]
    C = np.full((K, rcap), n, np.int32)
    C[:, : len(ends)] = ends
    W = rng.integers(-(1 << 31), 1 << 31, (K, rcap), dtype=np.int64).astype(np.int32)
    S = rng.integers(-(1 << 31), 1 << 31, K, dtype=np.int64).astype(np.int32)
    return W, C, S, n


EDGE_STACKS = ["one run", "every row a run", "rcap far above n", "n not a tile multiple",
               "K 32", "ends on tile boundaries", "repeated ends", "text fan-in width"]


@pytest.mark.parametrize("name", EDGE_STACKS)
@pytest.mark.parametrize("delta", [False, True], ids=["rle", "delta"])
def test_expand_runs_equals_plain_version_and_model_at_edges(cuda, name, delta):
    from automerge_tpu_torch.kernels import expand_runs as E

    rng = np.random.default_rng(len(name))
    W, C, S, n = _edge_stack(name, rng)
    S = S if delta else None
    bools = tuple(k % 3 == 1 for k in range(W.shape[0]))
    args = [torch.from_numpy(a).to(cuda) if a is not None else None for a in (W, C, S)]
    reset_launches()
    got = E.expand_runs(*args, n, bools)
    assert launch_counts()["expand_runs"] == 1
    _same(got, E.expand_runs_plain(*args, n, bools))
    model = E.expand_runs_tiled_model(W, C, S, n, bools)
    _same(tuple(g.cpu() for g in got), model)
    assert all(g.is_contiguous() for g in got)


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


# -- the sharded merge (K11) -------------------------------------------------


SHARDED = ("succ_partial", "visibility", "mesh_reduce", "forest", "radix_sort")
CONDENSED_ARM = ("cond_init", "linearize_thread", "cond_succ", "linearize_rank",
                 "cond_expand")
ROWS_ARM = ("linearize_init", "linearize_thread", "linearize_rank_init",
            "linearize_rank", "linearize_final")


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 1000), (4, 24_577), (8, 129_031)])
def test_mesh_reduce_equals_plain_version(cuda, op, shape):
    from automerge_tpu_torch.kernels import collectives as CK

    rng = np.random.default_rng(shape[1])
    stack = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64)
                             .astype(np.int32)).to(cuda)
    reset_launches()
    got = CK.mesh_reduce(stack, op)
    assert launch_counts()["mesh_reduce"] == 1
    _same(got, CK.mesh_reduce_plain(stack, op))


def test_kernels_launch_on_their_tensors_card_whatever_is_current(cuda):
    """A wrapper given tensors on one card launches there while another
    card is the current device, as a mesh's shards on distinct cards do."""
    from automerge_tpu_torch.kernels import collectives as CK

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 CUDA devices, found {n}")
    rng = np.random.default_rng(5)
    for d in range(n):
        stack = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (4, 24_577),
                                              dtype=np.int64).astype(np.int32))
        stack = stack.to(f"cuda:{d}")
        with torch.cuda.device((d + 1) % n):
            got = CK.mesh_reduce(stack, "sum")
        assert got.device == stack.device
        _same(got, CK.mesh_reduce_plain(stack, "sum"))


def test_range_kernels_equal_plain_versions(cuda):
    """Each kernel of the sharded merge against its plain version on one
    log, at slices of odd length and offset."""
    from automerge_tpu_torch.kernels import sharded as SH
    from automerge_tpu_torch.parallel import sharding as PS

    log = _log(*SIZES[1])
    cols = log.padded_columns()
    c = columns_from_numpy(cols, cuda)
    P = c["action"].numel()
    Q = c["pred_src"].numel()
    q0, ql = 5, Q - 11
    sp_in = (c["action"], c["value_i32"], c["covered"],
             c["pred_src"][q0:q0 + ql].contiguous(),
             c["pred_tgt"][q0:q0 + ql].contiguous())
    acc = SV.succ_partial(*sp_in)
    _same(acc, SV.succ_partial_plain(*sp_in))
    acc = SV.succ_partial(c["action"], c["value_i32"], c["covered"], c["pred_src"],
                          c["pred_tgt"])
    vis_in = (c["action"], c["value_tag"], c["covered"], acc[0], acc[1])
    visible = SV.visibility(*vis_in)
    _same(visible, SV.visibility_plain(*vis_in))
    n_objs2, n_props = log.n_objs + 2, max(len(log.props), 1)
    for r0, count in ((0, P), (7, P - 13), (P // 3, 1)):
        wp_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"], c["prop"],
                 visible, r0, count, n_objs2, n_props)
        table = SW.winners_partial(*wp_in)
        _same(table, SW.winners_partial_plain(*wp_in))
        wg_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"], c["prop"],
                 c["width"], table[0], table[1], r0, count, n_objs2, n_props)
        _same(SW.winners_gather(*wg_in), SW.winners_gather_plain(*wg_in))

    fo = F.forest(c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
    # the node space padded past the sentinel, with more padding than the
    # sharded merge makes, and slices that do not tile it
    El = P // 3 + 1
    Epad = 3 * El + 5
    li_in = (fo[2], fo[3], fo[0], c["elem_ref"], Epad)
    st = L.linearize_init(*li_in)
    _same(st, L.linearize_init_plain(*li_in))
    for i0, count in ((0, Epad), (El, El), (Epad - 9, 9)):
        _same(L.linearize_thread(*st[:3], i0, count),
              L.linearize_thread_plain(*st[:3], i0, count))
    rk = L.linearize_rank_init(st[3], st[0], P)
    _same(rk, L.linearize_rank_init_plain(st[3], st[0], P))
    for i0, count in ((0, Epad), (El, El), (Epad - 9, 9)):
        _same(L.linearize_rank(*rk, i0, count), L.linearize_rank_plain(*rk, i0, count))
    for r0, count in ((0, P), (11, P - 20)):
        fi_in = (fo[2], fo[0], c["obj_dense"], rk[0], r0, count)
        _same(L.linearize_final(*fi_in), L.linearize_final_plain(*fi_in))

    R2, cond_np = PS.condense_host(cols, n_objs2, 4)
    cond = {k: torch.from_numpy(v).to(cuda) for k, v in cond_np.items()}
    ci = SH.cond_init(cond["centry"], cond["cpar"])
    _same(ci, SH.cond_init_plain(cond["centry"], cond["cpar"]))
    cs_in = (cond["tail_ans"], ci[0], cond["chain_id"], cond["clen"])
    cs = SH.cond_succ(*cs_in)
    _same(cs, SH.cond_succ_plain(*cs_in))
    for r0, count in ((0, P), (3, P - 7)):
        ce_in = (cond["chain_id"], cond["offset"], c["obj_dense"], c["insert"],
                 c["action"], cond["start_chain"], cs[0], r0, count)
        _same(SH.cond_expand(*ce_in), SH.cond_expand_plain(*ce_in))


def _sharded_logs():
    base, reps, _ = _record_store()
    return [("text", _log(*SIZES[1])), ("typing", _typing_log(20000, 8, 100)),
            ("records", OpLog.from_changes([parse_change(b)[0] for b in [base] + reps]))]


@pytest.mark.parametrize("transport", ["dict", "packed"])
@pytest.mark.parametrize("linearize", ["condensed", "rows"])
def test_sharded_merge_on_card_equals_single_device(cuda, linearize, transport):
    """The sharded merge over four shards on the card equals the
    single-device merge on all 13 outputs, and launches the kernels of
    its arm: the row-range winners where the gate passes (text, typing),
    the sort-based ones where it fails (records)."""
    from automerge_tpu_torch.parallel import default_mesh, sharded_merge_columns

    mesh = default_mesh(devices=[cuda] * 4)
    for name, log in _sharded_logs():
        cols = log.padded_columns()
        kw = dict(n_objs=log.n_objs, n_props=len(log.props))
        single = merge_columns(cols, device=cuda, **kw)
        reset_launches()
        got = sharded_merge_columns(cols, mesh, transport=transport,
                                    linearize=linearize, **kw)
        counts = launch_counts()
        arm = CONDENSED_ARM if linearize == "condensed" else ROWS_ARM
        scatter = name != "records"
        winners = ("winners_partial", "winners_gather") if scatter else ("sort_winners",)
        idle = [k for k in SHARDED + arm + winners if counts[k] < 1]
        assert not idle, (name, idle)
        assert counts["succ_vis"] == counts["linearize"] == 0
        assert counts["scatter_winners"] == 0
        assert (counts["sort_winners"] > 0) == (not scatter)
        assert (counts["expand_runs"] > 0) == (transport == "packed")
        for k in ALL_OUTPUTS:
            m = len(single[k])
            np.testing.assert_array_equal(got[k][:m], single[k], err_msg=f"{name} {k}")


def test_sharded_merge_over_distinct_cards(cuda):
    """Four shards on four cards: the collectives copy between them."""
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 CUDA devices, found {torch.cuda.device_count()}")
    from automerge_tpu_torch.parallel import default_mesh, sharded_merge_columns

    mesh = default_mesh(4)
    assert len(mesh.distinct) == 4
    log = _log(*SIZES[1])
    cols = log.padded_columns()
    kw = dict(n_objs=log.n_objs, n_props=len(log.props))
    got = sharded_merge_columns(cols, mesh, **kw)
    single = merge_columns(cols, device=cuda, **kw)
    for k in ALL_OUTPUTS:
        m = len(single[k])
        np.testing.assert_array_equal(got[k][:m], single[k], err_msg=k)


@pytest.mark.parametrize("cards", ["repeated", "distinct"])
def test_mesh_document_on_card_equals_single_device(cuda, cards):
    """A card document whose full re-resolve runs over a mesh of two
    shards on the card (or over every card, the default mesh, where the
    machine has two or more) equals one re-resolved on the card alone."""
    if cards == "distinct" and torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA devices, found {torch.cuda.device_count()}")
    trace = W.load_trace(3000)
    base = W.build_base(trace, 2000)
    reps = W.synth_fanin(base, trace, 9, 40, 2000)
    start = [ch.raw_bytes for ch in base.changes + reps[:-1]]
    doc = DeviceDoc.merge(start, device=cuda)
    single = DeviceDoc.merge(start, device=cuda)
    if cards == "distinct":
        mesh = doc.enable_mesh(min_rows=0)
        assert len(mesh.distinct) == torch.cuda.device_count()
    else:
        doc.enable_mesh(devices=[cuda] * 2, min_rows=0)
    reset_launches()
    doc.apply_changes([reps[-1].raw_bytes])
    counts = launch_counts()
    assert counts["winners_partial"] and counts["cond_expand"] and counts["mesh_reduce"]
    single.apply_changes([reps[-1].raw_bytes])
    n = doc.log.n
    for k in DeviceDoc.READ_FETCH:
        cut = n if not k.startswith("obj_") else doc.log.n_objs + 2
        np.testing.assert_array_equal(np.asarray(doc.res[k])[:cut],
                                      np.asarray(single.res[k])[:cut], err_msg=k)
    assert doc.text(base.text_exid) == single.text(base.text_exid)
