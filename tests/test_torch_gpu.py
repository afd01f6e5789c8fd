"""automerge_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card. Marked ``gpu``: they skip where no CUDA device is present.

They import no JAX (the seeded histories come from the JAX package's
document API, ``automerge_tpu.api``, which imports none), so they also
run where only the port's dependencies are installed:

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
    assert counts["forest"] == 2  # links, finish
    assert counts["radix_sort"] == 1 + len(F.sibling_digits(P))
    _same(got, F.forest_plain(*cols))
    next_sib = got[3][:P].cpu().numpy()
    first = int(got[2][P].item())  # the first object's root
    chain = [first]
    while next_sib[chain[-1]] >= 0:
        chain.append(int(next_sib[chain[-1]]))
    assert chain == [r for r in range(half - 1, -1, -1) if insert[r]]


@pytest.mark.parametrize("P", [1, 4096, 24_577, (1 << 20) + 1])
def test_forest_without_elements_sorts_nothing(cuda, P):
    """A record store's columns: map puts and pad rows, no insert. The
    sort runs over a device-side count of 0 and first_child and next_sib
    stay -1 everywhere."""
    rng = np.random.default_rng(P)
    action = np.where(rng.random(P) < 0.9, 1, 15).astype(np.int32)
    cols = [torch.from_numpy(a).to(cuda) for a in (
        action, np.zeros(P, bool), np.full(P, -2, np.int32),
        rng.integers(0, 9, P).astype(np.int32))]
    reset_launches()
    got = F.forest(*cols)
    assert launch_counts()["forest"] == 2
    _same(got, F.forest_plain(*cols))
    assert int(got[2].max()) == int(got[3].max()) == -1


def test_forest_one_parent_with_2000_children(cuda):
    """Every element at the HEAD of one object, then pad rows: one run of
    2,000 siblings, the object's first child the last row."""
    P = 2048
    action = np.full(P, 15, np.int32)
    action[:2000] = 1
    cols = [torch.from_numpy(a).to(cuda) for a in (
        action, np.ones(P, bool), np.full(P, -1, np.int32), np.zeros(P, np.int32))]
    got = F.forest(*cols)
    _same(got, F.forest_plain(*cols))
    assert int(got[2][P]) == 1999
    assert got[3][:2000].tolist() == list(range(-1, 1999))


@pytest.mark.parametrize("kind", ["random", "few"])
@pytest.mark.parametrize("count", [0, 1, 4095, 4096, 4097, 24_577])
def test_radix_sort_over_a_device_side_count(cuda, count, kind):
    """The first ``count`` keys of a 24,577-key buffer sorted by a length
    the kernels read on the card; launches as for the whole buffer."""
    n = 24_577
    rng = np.random.default_rng(count)
    keys = torch.from_numpy(_sort_keys(kind, n, rng)).to(cuda)
    c = torch.tensor([count], dtype=torch.int32, device=cuda)
    reset_launches()
    got = RS.radix_sort(keys, RS.DIGITS, c)
    assert launch_counts()["radix_sort"] == 9
    _same(got[:count], torch.sort(keys[:count]).values)
    _same(got[:count], RS.radix_sort_plain(keys, RS.DIGITS, c)[:count])


def _scatter_columns(kind, P, rng):
    """Scatter-winner inputs and their group table (n_objs2, n_props): a
    text of one object whose widths make obj_text_width wrap past 2^31
    ("one_object"); elements of three objects interleaved row by row
    ("objects") or in runs of 300 rows ("object_runs"); every visible row
    a put of one map key ("hot"); every row its own group ("distinct").
    About a fifth of the rows invisible."""
    action = np.ones(P, np.int32)
    visible = rng.random(P) < 0.8
    width = rng.integers(1 << 12, 1 << 13, P).astype(np.int32)
    prop = np.full(P, -1, np.int32)
    insert = np.ones(P, bool)
    elem_ref = np.where(rng.random(P) < 0.5, -1,
                        (rng.random(P) * np.arange(P)).astype(np.int64)).astype(np.int32)
    obj = np.zeros(P, np.int32)
    n_objs2, n_props = 4, 8
    if kind == "objects":
        obj = rng.integers(0, 3, P).astype(np.int32)
    elif kind == "object_runs":
        obj = ((np.arange(P) // 300) % 3).astype(np.int32)
    elif kind == "hot":
        insert[:] = False
        obj[:] = 3
        prop[:] = 5
    elif kind == "distinct":
        insert[:] = False
        prop = rng.permutation(P).astype(np.int32)
        n_props = P
    cols = tuple(torch.from_numpy(a) for a in
                 (action, insert, elem_ref, obj, prop, width, visible))
    return cols, n_objs2, n_props


@pytest.mark.parametrize("kind", ["one_object", "objects", "object_runs", "hot",
                                  "distinct"])
@pytest.mark.parametrize("P", [1, 24_577, (1 << 20) + 12_345])
def test_scatter_winners_at_its_extremes(cuda, kind, P):
    cols, n_objs2, n_props = _scatter_columns(kind, P, np.random.default_rng(P))
    args = (*(a.to(cuda) for a in cols), n_objs2, n_props)
    reset_launches()
    got = SW.scatter_winners(*args)
    assert launch_counts()["scatter_winners"] == 2
    _same(got, SW.scatter_winners_plain(*args))
    vis = cols[6].nonzero()
    if kind == "hot":
        assert int(got[0][0]) == (int(vis.max()) if len(vis) else -1)
        assert int(got[1][0]) == len(vis)
    if kind == "one_object" and P > 1 << 20:
        # the widths of ~10^6 visible elements sum past 2^31 and wrap
        total = int(cols[5][got[0].cpu()[cols[1] & (got[0].cpu() >= 0)].long()]
                    .long().sum())
        assert total >= 1 << 31
        assert int(got[3][0]) == (total + (1 << 31)) % (1 << 32) - (1 << 31)


def test_winners_gather_on_a_shards_rows(cuda):
    """Four shards' row ranges scattered apart, their tables combined as
    the collectives do, then each shard's rows gathered: equal to the
    plain versions, one launch each; the shards' stats sum to the
    single-device kernel's."""
    cols, n_objs2, n_props = _scatter_columns("objects", 24_576,
                                              np.random.default_rng(3))
    cols = tuple(a.to(cuda) for a in cols)
    P = cols[0].numel()
    Pl = P // 4
    part = cols[:5] + (cols[6],)
    reset_launches()
    tables = [SW.winners_partial(*part, i * Pl, Pl, n_objs2, n_props) for i in range(4)]
    assert launch_counts()["winners_partial"] == 4
    for i, t in enumerate(tables):
        _same(t, SW.winners_partial_plain(*part, i * Pl, Pl, n_objs2, n_props))
    win = torch.stack([t[0] for t in tables]).amax(0)
    cnt = torch.stack([t[1] for t in tables]).sum(0, dtype=torch.int32)
    stats = torch.zeros(2, P + 2, dtype=torch.int32, device=cuda)
    reset_launches()
    for i in range(4):
        wg_in = (*cols[:6], win, cnt, i * Pl, Pl, n_objs2, n_props)
        got = SW.winners_gather(*wg_in)
        _same(got, SW.winners_gather_plain(*wg_in))
        stats += got[2]
    assert launch_counts()["winners_gather"] == 4
    whole = SW.scatter_winners(*cols, n_objs2, n_props)
    _same((stats[0], stats[1]), (whole[2], whole[3]))


def test_merge_on_card_equals_cpu_and_counts_launches(cuda):
    log = _log(*SIZES[1])
    kw = dict(n_objs=log.n_objs, n_props=len(log.props))
    reset_launches()
    gpu = merge_columns(log.columns(), device=cuda, **kw)
    P = len(log.padded_columns()["action"])
    assert launch_counts() == {
        "succ_vis": 2,  # row pass, edge pass
        "scatter_winners": 2,  # scatter, gather (one memset before)
        "sort_winners": 0,  # the text fan-in passes the scatter gate
        "forest": 2,  # links, finish (one memset before)
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
        "linearize_rank": 0, "linearize_rank_first": 0, "linearize_final": 0,
        "linearize_thread_rounds": 0, "linearize_rank_rounds": 0,
        "linearize_rank_from_thread": 0,
        "cond_init": 0, "cond_succ": 0, "cond_expand": 0, "mesh_reduce": 0,
    }
    cpu = merge_columns(log.columns(), device="cpu", **kw)
    for k in ALL_OUTPUTS:
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)


def _succ_vis_columns(P, Q, seed, device, offset):
    """Synthetic succ_vis inputs on the card: every action, about a fifth
    uncovered, a third of the puts counters, increments of any int32,
    targets in [-1, P] and sources in [0, P], a hot row with 2,000
    in-edges; each column a view at ``offset`` elements into a buffer of
    its own (an odd offset: not 16-byte aligned, the scalar path)."""
    rng = np.random.default_rng(seed)
    cols = (
        rng.choice([0, 1, 1, 1, 2, 3, 4, 5, 5, 7, 15], P).astype(np.int32),
        np.where(rng.random(P) < 0.35, 8, 4).astype(np.int32),
        rng.integers(-(1 << 31), 1 << 31, P, dtype=np.int64).astype(np.int32),
        rng.random(P) < 0.8,
        rng.integers(0, P + 1, Q).astype(np.int32),
        np.where(np.arange(Q) < min(2000, Q // 4), 0,
                 rng.integers(-1, P + 1, Q)).astype(np.int32),
    )
    out = []
    for a in cols:
        buf = torch.empty(len(a) + offset, dtype=torch.from_numpy(a).dtype,
                          device=device)
        buf[offset:] = torch.from_numpy(a).to(device)
        out.append(buf[offset:])
    return tuple(out)


# (P, Q): one row, three, past a multiple of 4, the text fan-in's shape
SUCC_VIS_SIZES = [(1, 3), (3, 0), (4097, 3000), (516_096, 81_920)]


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "odd-offset"])
@pytest.mark.parametrize("size", SUCC_VIS_SIZES, ids=lambda s: f"P{s[0]}-Q{s[1]}")
def test_succ_vis_equals_plain_version(cuda, size, offset):
    """The row pass and the edge pass: equal to the plain version in two
    launches (one without edges), on aligned columns (four rows a thread)
    and on views at an odd offset (the scalar path)."""
    P, Q = size
    sv_in = _succ_vis_columns(P, Q, P, cuda, offset)
    reset_launches()
    got = SV.succ_vis(*sv_in)
    assert launch_counts()["succ_vis"] == (2 if Q else 1)
    _same(got, SV.succ_vis_plain(*sv_in))
    vis_in = (sv_in[0], sv_in[1], sv_in[3], got[0], got[1])
    _same(SV.visibility(*vis_in), SV.visibility_plain(*vis_in))


def test_sharded_halves_equal_succ_vis_on_four_shards(cuda):
    """succ_partial on each of four shards' edges (one launch after a
    memset), mesh_reduce's sum, then visibility: succ_vis's results."""
    from automerge_tpu_torch.kernels import collectives as CK

    action, value_tag, value_i32, covered, pred_src, pred_tgt = _succ_vis_columns(
        24_576, 8_192, 9, cuda, 0)
    reset_launches()
    accs = [SV.succ_partial(action, value_i32, covered, s.contiguous(),
                            t.contiguous())
            for s, t in zip(pred_src.chunk(4), pred_tgt.chunk(4))]
    assert launch_counts()["succ_partial"] == 4
    acc = CK.mesh_reduce(torch.stack([a.reshape(-1) for a in accs]), "sum")
    acc = acc.reshape(3, -1)
    visible = SV.visibility(action, value_tag, covered, acc[0], acc[1])
    _same((acc[0], acc[1], acc[2], visible),
          SV.succ_vis(action, value_tag, value_i32, covered, pred_src, pred_tgt))


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


def _emit_core(P, seed, device, offset=0):
    """Outputs of every kind the packed transport takes, P rows (stats of
    P + 2, next_sib of 2P + 3), on the card ``offset`` elements into
    their buffers (``_on_card_at``)."""
    rng = np.random.default_rng(seed)
    core = {
        "visible": rng.random(P) < 0.5,
        "conflicts": rng.integers(-3, 5, P).astype(np.int32),
        "winner": rng.integers(-1, P, P).astype(np.int32),
        "is_elem": rng.random(P) < 0.3,
        "next_sib": rng.integers(-1, P, 2 * P + 3).astype(np.int32),
        "elem_index": rng.integers(-(1 << 31), 1 << 31, P, dtype=np.int64)
        .astype(np.int32),
        "obj_vis_len": rng.integers(0, 9, P + 2).astype(np.int32),
        "obj_text_width": rng.integers(0, 9, P + 2).astype(np.int32),
    }
    return {k: _on_card_at(v, device, offset) for k, v in core.items()}


EMIT_FETCHES = [
    ("visible", "winner", "conflicts", "is_elem", "next_sib", "obj_vis_len"),
    DeviceDoc.READ_FETCH,
    ("obj_text_width", "is_elem", "conflicts", "visible", "winner"),
    ("visible", "conflicts", "winner", "is_elem") * 4,  # the 16-output limit
]


# P: under a word, not a multiple of 32, the text fan-in's (516,096)
@pytest.mark.parametrize("P", [1, 16, 48, 4096, 24_592, 24_577, 516_096])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_emit_packed_equals_plain_version(cuda, P, offset):
    """Every output kind (bits of a bool, bits of conflicts > 1, int32 and
    bool copies, the stats cut), sources aligned and 1 to 3 elements off
    16-byte alignment (scatter_winners' winner and conflicts may sit 2
    off), every fetch of one launch."""
    from automerge_tpu_torch.kernels import emit_packed as EP

    core = _emit_core(P, P + offset, cuda, offset)
    for fetch in EMIT_FETCHES:
        for obj_cap in (18, P + 2):
            reset_launches()
            got = EP.emit_packed(core, fetch, obj_cap)
            assert launch_counts()["emit_packed"] == 1
            _same(got, EP.emit_packed_plain(core, fetch, obj_cap))


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


def _condensed_args(log, device, rcap):
    c = columns_from_numpy(log.padded_columns(include_aorder=True), device)
    fo = F.forest(c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
    return (fo[2], fo[3], fo[0], c["elem_ref"], c["obj_dense"], c["aorder"], rcap)


def test_linearize_condensed_equals_plain_version(cuda):
    for name, log in _condensed_logs():
        args = _condensed_args(log, cuda, condensed_caps(log))
        reset_launches()
        got = LC.linearize_condensed(*args)
        assert launch_counts()["linearize_condensed"] == LC.LAUNCHES, name
        _same(got, LC.linearize_condensed_plain(*args))
        _same(got, L.linearize(*args[:5]))
        if name == "records":
            aorder = args[5]
            assert log.condensed_run_count() == 1
            assert int((aorder < aorder.numel()).sum()) == 0


@pytest.mark.parametrize("seed", range(6))
def test_linearize_condensed_on_seeded_histories(cuda, seed):
    """Concurrent inserts and deletes in several text objects, lists and
    objects inside lists: at rcap = the run count exactly, at the bucket
    and far above it, the same order as the plain version's in
    ``LAUNCHES`` launches."""
    from .test_torch_histories import _history

    base, rest = _history(seed)
    log = OpLog.from_changes([parse_change(b)[0] for b in base + rest])
    runs = log.condensed_run_count()
    for rcap in (runs, condensed_caps(log), 64 * condensed_caps(log)):
        args = _condensed_args(log, cuda, rcap)
        reset_launches()
        got = LC.linearize_condensed(*args)
        assert launch_counts()["linearize_condensed"] == LC.LAUNCHES
        _same(got, LC.linearize_condensed_plain(*args))


def test_linearize_condensed_on_both_sides_of_the_levels_cut(cuda):
    """Tours whose level-1 rulers the block ranks as they are (under
    4 x LT_R3_TARGET nodes) and tours that levels 2 and 3 shrink first
    (far over it): a typing log (few runs), the synthetic trace's (one run
    an element, nearly), and the same past 2^17 rows."""
    cut = 4 * L.R3_TARGET
    seen = []
    for log in (_typing_log(2000, 16, 100), _log(2000, 16, 100),
                _log(20000, 8, 100), _log(100_000, 32, 100)):
        args = _condensed_args(log, cuda, condensed_caps(log))
        seen.append(sum(LC.tour_size(*args[:4], args[5])))
        reset_launches()
        got = LC.linearize_condensed(*args)
        assert launch_counts()["linearize_condensed"] == LC.LAUNCHES
        _same(got, LC.linearize_condensed_plain(*args))
        _same(got, L.linearize(*args[:5]))
    assert min(seen) < cut < max(seen), seen


def test_linearize_condensed_raises_when_the_runs_exceed_rcap(cuda):
    log = _log(2000, 16, 100)
    runs = log.condensed_run_count()
    args = _condensed_args(log, cuda, runs)[:6]
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
    assert counts["linearize_condensed"] == LC.LAUNCHES
    assert counts["succ_vis"] and counts["sort_winners"] and counts["forest"]
    assert counts["linearize"] == counts["scatter_winners"] == 0
    for k in ALL_OUTPUTS:
        np.testing.assert_array_equal(gpu[k].cpu().numpy(), cpu[k].numpy(), err_msg=k)
    doc = DeviceDoc(log, {k: v.cpu().numpy() for k, v in gpu.items()}, device=cuda)
    ref = DeviceDoc.resolve(log, device="cpu")
    assert doc.text(f"1@{W.BASE_ACTOR.hex()}") == ref.text(f"1@{W.BASE_ACTOR.hex()}")


# -- the sharded merge (K11) -------------------------------------------------


SHARDED = ("succ_partial", "visibility", "mesh_reduce", "forest", "radix_sort")
# on a mesh of one card the doubling loops are the rounds entries, one
# call a loop (the range kernels over distinct cards)
CONDENSED_ARM = ("cond_init", "linearize_thread_rounds", "cond_succ",
                 "linearize_rank_rounds", "cond_expand")
# the row arm's rank loop starts from the thread loop's answers: no init
ROWS_ARM = ("linearize_init", "linearize_thread_rounds", "linearize_rank_from_thread",
            "linearize_final")


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


def _on_card_at(a, device, offset):
    """``a`` on the card as a view ``offset`` elements into a buffer of
    its own (offset 1 of int32: 4 bytes off 16-byte alignment)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=device)
    buf[offset:] = t.to(device)
    return buf[offset:]


def _int32_tables(n, L, seed):
    """n int32 [L] tables of any int32, the first columns the extremes
    and values whose sum wraps (2^31 - 1 beside 1, -2^31 beside -1)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-(1 << 31), 1 << 31, (n, L), dtype=np.int64).astype(np.int32)
    special = np.array([(1 << 31) - 1, 1, -(1 << 31), -1, 0], np.int32)
    for s in range(n):
        k = min(L, len(special))
        a[s, :k] = np.roll(special, s)[:k]
    return a


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "4-byte-offset"])
@pytest.mark.parametrize("L", [1, 3, 4, 5, 1_548_288])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_mesh_reduce_of_parts_equals_plain_version(cuda, n, L, offset):
    """The fold of n tables where they lie, in one launch: equal to the
    plain version and to numpy's wrapping int32 sum and max, with the
    tables 16-byte aligned (four columns a thread) or views 4 bytes off
    (the scalar path); nothing is allocated on the card but the result."""
    from automerge_tpu_torch.kernels import collectives as CK

    a = _int32_tables(n, L, n * 7 + L)
    parts = [_on_card_at(row, cuda, offset) for row in a]
    for op in CK.OPS:
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
        reset_launches()
        got = CK.mesh_reduce(parts, op)
        assert launch_counts()["mesh_reduce"] == 1
        assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] == allocated + 1
        _same(got, CK.mesh_reduce_plain(parts, op))
        want = a.max(0) if op == "max" else a.sum(0, dtype=np.int32)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def _expand_inputs(P, R2, n_objs2, seed, device, offset):
    """cond_expand's inputs on the card, each a view ``offset`` elements
    in: chain ids, offsets and object ids partly out of range or
    negative, insert and pad rows mixed, distances of any int32."""
    rng = np.random.default_rng(seed)
    action = rng.integers(0, 16, P).astype(np.int32)
    action[rng.random(P) < 0.2] = 15
    cols = (rng.integers(-1, R2 + 3, P).astype(np.int32),
            rng.integers(-5, 50, P).astype(np.int32),
            rng.integers(0, n_objs2 + 2, P).astype(np.int32),
            rng.random(P) < 0.7, action,
            rng.integers(-1, R2, n_objs2).astype(np.int32),
            rng.integers(-(1 << 31), 1 << 31, R2, dtype=np.int64).astype(np.int32))
    return tuple(_on_card_at(c, device, offset) for c in cols)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "odd-offset"])
@pytest.mark.parametrize("P", [1, 5, 4097, 516_096])
def test_cond_expand_equals_plain_version(cuda, P, offset):
    """The expansion over the whole row range in one launch, and over
    ranges starting at odd rows and mid-range, into a fresh tensor and
    into an ``out`` view at 0 or 4 bytes off 16-byte alignment: equal to
    the plain version."""
    from automerge_tpu_torch.kernels import sharded as SH

    args = _expand_inputs(P, 1 << 12, 97, P, cuda, offset)
    starts = (0, min(1, P), min(3, P), P // 2)
    for r0, count in {(0, P), (starts[1], P - starts[1]), (starts[2], max(P - 7, 0)),
                      (starts[3], P - starts[3])}:
        want = SH.cond_expand_plain(*args, r0, count)
        reset_launches()
        _same(SH.cond_expand(*args, r0, count), want)
        assert launch_counts()["cond_expand"] == (1 if count else 0)
        out = _on_card_at(np.full(count, -7, np.int32), cuda, 1 - offset)
        assert SH.cond_expand(*args, r0, count, out=out) is out
        _same(out, want)


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
    rk = L.linearize_rank_init_plain(st[3], st[0], P)
    for i0, count in ((0, Epad), (El, El), (Epad - 9, 9)):
        _same(L.linearize_rank(*rk, i0, count), L.linearize_rank_plain(*rk, i0, count))
        _same(L.linearize_rank_first(st[3], st[0], P, i0, count),
              L.linearize_rank_first_plain(st[3], st[0], P, i0, count))
    # the range kernels writing into a next-round buffer at their offset
    buf = tuple(torch.zeros_like(t) for t in st[:3])
    got = L.linearize_thread(*st[:3], El, El, out=tuple(b[El:2 * El] for b in buf))
    _same(got, L.linearize_thread_plain(*st[:3], El, El))
    assert all(b.data_ptr() == g.data_ptr() - El * b.element_size()
               for b, g in zip(buf, got))
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


def _rounds_state(E, seed):
    """A thread state (ans, done, jump) and a rank state (dist, nxt) of E
    nodes: links along a random permutation (chains of every length), a
    few out of range (-1, E, E + 5), distances of any int32."""
    rng = np.random.default_rng(seed)

    def links():
        out = rng.permutation(E).astype(np.int32)
        k = min(E, 3)
        out[rng.choice(E, k, replace=False)] = np.array([-1, E, E + 5], np.int32)[:k]
        return torch.from_numpy(out)

    done = torch.from_numpy(rng.random(E) < 0.3)
    dist = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, E, dtype=np.int64)
                            .astype(np.int32))
    return (links(), done, links()), (dist, links())


# E: small, the text fan-in's row arm (Epad = 4 (P/4 + 1), P = 516,096)
# and its condensed arm's chain slots (R2)
@pytest.mark.parametrize("E", [1, 5, 4097, 516_100, 524_288])
def test_rounds_entries_equal_plain_versions(cuda, E):
    """Each rounds entry against its plain version (the range round
    chained), for one, two and the full rounds, in exactly ``rounds``
    launches, its inputs untouched."""
    thread, rank = _rounds_state(E, E)
    thread = tuple(t.to(cuda) for t in thread)
    rank = tuple(t.to(cuda) for t in rank)
    before = tuple(t.clone() for t in thread + rank)
    for rounds in sorted({1, 2, L.ceil_log2(E) + 1}):
        reset_launches()
        got = L.linearize_thread_rounds(*thread, rounds)
        assert launch_counts()["linearize_thread_rounds"] == rounds
        _same(got, L.linearize_thread_rounds_plain(*thread, rounds))
        reset_launches()
        got = L.linearize_rank_rounds(*rank, rounds)
        assert launch_counts()["linearize_rank_rounds"] == rounds
        _same(got, L.linearize_rank_rounds_plain(*rank, rounds))
    torch.cuda.synchronize()
    _same(thread + rank, before)


# (E, P): the text fan-in's row arm (Epad = 516,100 of P = 516,096), the
# sentinel alone past the rows, padding past it
@pytest.mark.parametrize("E,P", [(1, 0), (6, 5), (4097, 4000), (516_100, 516_096)])
def test_rank_loop_from_thread_equals_init_then_rounds(cuda, E, P):
    """The row arm's rank loop from the thread loop's answers (fc_e with
    -1 where the node takes its answer, answers -1 or out of range) equals
    the reference's init then the chained rounds, in exactly ``rounds``
    launches, nothing allocated but its records and result; its first
    round alone equals the init then one round."""
    rng = np.random.default_rng(E)
    ans = _rounds_state(E, E + 1)[0][0]
    fc_e = _rounds_state(E, E + 2)[0][0]
    fc_e[torch.from_numpy(rng.random(E) < 0.5)] = -1
    fc_e, ans = fc_e.to(cuda), ans.to(cuda)
    before = (fc_e.clone(), ans.clone())
    init = L.linearize_rank_init_plain(fc_e, ans, P)
    for rounds in sorted({1, 2, L.ceil_log2(E) + 1}):
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
        reset_launches()
        got = L.linearize_rank_from_thread(fc_e, ans, P, rounds)
        assert launch_counts()["linearize_rank_from_thread"] == rounds
        assert launch_counts()["linearize_rank_rounds"] == 0
        assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] \
            == allocated + (1 if rounds == 1 else 2)
        _same(got, L.linearize_rank_from_thread_plain(fc_e, ans, P, rounds))
        _same(got, L.linearize_rank_rounds_plain(*init, rounds))
    for i0, count in ((0, E), (E // 2, E - E // 2)):
        reset_launches()
        _same(L.linearize_rank_first(fc_e, ans, P, i0, count),
              L.linearize_rank_plain(*init, i0, count))
        assert launch_counts()["linearize_rank_first"] == 1
    torch.cuda.synchronize()
    _same((fc_e, ans), before)


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
    from automerge_tpu_torch.parallel import sharding as PS

    mesh = default_mesh(devices=[cuda] * 4)
    for name, log in _sharded_logs():
        cols = log.padded_columns()
        kw = dict(n_objs=log.n_objs, n_props=len(log.props))
        single = merge_columns(cols, device=cuda, **kw)
        reset_launches()
        got = sharded_merge_columns(cols, mesh, transport=transport,
                                    linearize=linearize, **kw)
        counts = launch_counts()
        if linearize == "condensed":
            R2, _ = PS.condense_host(cols, log.n_objs + 2, 4)
            rounds = L.ceil_log2(R2) + 1
        else:
            rounds = L.rounds(len(cols["action"]))
        rank = "linearize_rank_rounds" if linearize == "condensed" \
            else "linearize_rank_from_thread"
        assert counts["linearize_thread_rounds"] == counts[rank] == rounds, \
            (name, rounds, counts)
        assert counts["linearize_thread"] == counts["linearize_rank"] == 0
        assert counts["linearize_rank_first"] == 0
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


@pytest.mark.parametrize("linearize", ["condensed", "rows"])
def test_sharded_merge_on_one_card_folds_in_place_and_expands_once(cuda, linearize):
    """On four shards of one card a sharded merge folds each psum and
    pmax in one ``mesh_reduce`` launch, copying nothing (4 launches past
    the scatter gate, the counts' psum alone below it), and the condensed
    arm expands all rows in one ``cond_expand`` launch; its outputs equal
    the single-device merge's."""
    from automerge_tpu_torch.parallel import collectives as C
    from automerge_tpu_torch.parallel import default_mesh, sharded_merge_columns

    mesh = default_mesh(devices=[cuda] * 4)
    base, reps, _ = _record_store()
    for name, log in (("text", _log(*SIZES[0])),
                      ("records", OpLog.from_changes(
                          [parse_change(b)[0] for b in [base] + reps]))):
        cols = log.padded_columns()
        kw = dict(n_objs=log.n_objs, n_props=len(log.props))
        single = merge_columns(cols, device=cuda, **kw)
        C.reset_stats()
        reset_launches()
        got = sharded_merge_columns(cols, mesh, linearize=linearize, **kw)
        counts = launch_counts()
        assert counts["mesh_reduce"] == (4 if name == "text" else 1), (name, counts)
        assert counts["cond_expand"] == (1 if linearize == "condensed" else 0)
        assert C.stats["psum"]["copied"] == C.stats["pmax"]["copied"] == 0
        assert C.stats["psum"]["calls"] == (3 if name == "text" else 1)
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
    single = merge_columns(cols, device=cuda, **kw)
    for linearize in ("condensed", "rows"):
        reset_launches()
        got = sharded_merge_columns(cols, mesh, linearize=linearize, **kw)
        counts = launch_counts()
        # a range launch a card a round, the rounds entries idle; the row
        # arm's first rank round from the thread loop's answers
        first = counts["linearize_rank_first"]
        assert first == (4 if linearize == "rows" else 0)
        assert counts["linearize_thread"] == counts["linearize_rank"] + first > 0
        assert counts["linearize_thread"] % 4 == 0
        assert counts["linearize_thread_rounds"] == counts["linearize_rank_rounds"] \
            == counts["linearize_rank_from_thread"] == 0
        for k in ALL_OUTPUTS:
            m = len(single[k])
            np.testing.assert_array_equal(got[k][:m], single[k],
                                          err_msg=f"{linearize} {k}")


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


# -- historical views on the card, and psum/pmax past 8 shards --------------


@pytest.mark.parametrize("n", [9, 16, 33])
def test_mesh_reduce_past_the_cap_folds_in_passes_on_card(cuda, n):
    """Past ``CAP`` tables the fold runs in ``passes(n)`` launches (groups
    of ``CAP`` into partials, then the partials), equal to the plain
    version and numpy, the tables aligned and 4 bytes off."""
    from automerge_tpu_torch.kernels import collectives as CK

    for offset in (0, 1):
        a = _int32_tables(n, 24_577, n + offset)
        parts = [_on_card_at(row, cuda, offset) for row in a]
        for op in CK.OPS:
            reset_launches()
            got = CK.mesh_reduce(parts, op)
            assert launch_counts()["mesh_reduce"] == CK.passes(n)
            _same(got, CK.mesh_reduce_plain(parts, op))
            want = a.max(0) if op == "max" else a.sum(0, dtype=np.int32)
            np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("linearize", ["condensed", "rows"])
def test_sixteen_shards_on_one_card_equal_the_single_device_merge(cuda, linearize):
    """A mesh of 16 shards on the card, past the one-launch fold: all 13
    outputs equal the single-device merge's; each psum and pmax folds
    its 16 tables in ``passes(16)`` launches."""
    from automerge_tpu_torch.kernels import collectives as CK
    from automerge_tpu_torch.parallel import default_mesh, sharded_merge_columns
    from automerge_tpu_torch.parallel import collectives as C

    mesh = default_mesh(devices=[cuda] * 16)
    for name, log in _sharded_logs():
        cols = log.padded_columns()
        kw = dict(n_objs=log.n_objs, n_props=len(log.props))
        single = merge_columns(cols, device=cuda, **kw)
        C.reset_stats()
        reset_launches()
        got = sharded_merge_columns(cols, mesh, linearize=linearize, **kw)
        folds = C.stats["psum"]["calls"] + C.stats["pmax"]["calls"]
        assert launch_counts()["mesh_reduce"] == folds * CK.passes(16), name
        assert C.stats["psum"]["copied"] == C.stats["pmax"]["copied"] == 0
        for k in ALL_OUTPUTS:
            m = len(single[k])
            np.testing.assert_array_equal(got[k][:m], single[k], err_msg=f"{name} {k}")


def _heads_of(changes):
    deps = {d for c in changes for d in c.dependencies}
    return sorted(c.hash for c in changes if c.hash not in deps)


def _view_docs():
    """(name, change bytes, [heads], objects to read): a text fan-in cut
    at its base and after half its replicas, the record store likewise,
    and a seeded history at its base."""
    from .test_torch_histories import _history

    trace = W.load_trace(3000)
    base = W.build_base(trace, 2000)
    reps = W.synth_fanin(base, trace, 16, 100, 2000)
    text = [c.raw_bytes for c in base.changes + reps]
    rbase, rreps, _ = _record_store()
    hb, hrest = _history(2)
    hist = hb + [b for b in hrest if b not in hb]
    out = []
    for name, blobs, n_base, half in (("text", text, 1, 8), ("records", [rbase] + rreps, 1, 32),
                                      ("history", hist, len(hb), 0)):
        parsed = [parse_change(b)[0] for b in blobs]
        cuts = [[], _heads_of(parsed[:n_base])]
        if half:
            cuts.append(_heads_of(parsed[:n_base + half]))
        out.append((name, blobs, cuts))
    return out


@pytest.mark.parametrize("name", ["text", "records", "history"])
def test_views_on_card_equal_the_same_views_on_cpu(cuda, name):
    """``at`` on a document resolved on the card runs there (its merge's
    kernels launch: succ_vis with a partly false covered mask) and equals
    the same view of the same document on the CPU: the view's arrays,
    counters and every read, ``diff`` and ``make_patches``."""
    from automerge_tpu_torch.patches import apply_patches
    from automerge_tpu_torch.types import ObjType

    blobs, cuts = next((b, c) for n, b, c in _view_docs() if n == name)
    gpu = DeviceDoc.merge(blobs, device=cuda)
    cpu = DeviceDoc.merge(blobs, device="cpu")
    for heads in cuts:
        reset_launches()
        view = gpu.at(heads)
        counts = launch_counts()
        assert view.device == gpu.device
        assert counts["succ_vis"] == 2 and counts["linearize"] == L.LAUNCHES
        want = cpu.at(heads)
        np.testing.assert_array_equal(view.covered, want.covered)
        for k in DeviceDoc.VIEW_FETCH:
            cut = gpu.log.n_objs + 2 if k.startswith("obj_") else gpu.log.n
            np.testing.assert_array_equal(np.asarray(view.res[k])[:cut],
                                          np.asarray(want.res[k])[:cut], err_msg=k)
        np.testing.assert_array_equal(view.counter_val, want.counter_val)
        for k in gpu._obj_type:
            obj = gpu.log.export_id(k)
            t = gpu.object_type(obj)
            reads = (lambda d: (d.values(obj, heads=heads), d.length(obj, heads=heads),
                                d.parents(obj, heads=heads),
                                d.map_entries(obj, heads=heads)
                                if t in (ObjType.MAP, ObjType.TABLE) else
                                (d.list_items(obj, heads=heads),
                                 [(m.start, m.end, m.name, m.value)
                                  for m in d.marks(obj, heads=heads)])))
            assert reads(gpu) == reads(cpu), (heads, obj)
        assert gpu.hydrate(heads=heads) == cpu.hydrate(heads=heads)
        patches = gpu.diff(heads)
        assert [(p.obj, p.path, p.action) for p in patches] == \
            [(p.obj, p.path, p.action) for p in cpu.diff(heads)]
        assert apply_patches(gpu.hydrate(heads=heads), patches) == gpu.hydrate()
    assert gpu.hydrate(heads=[]) == {}
    assert apply_patches({}, gpu.make_patches()) == cpu.hydrate()


def test_view_columns_decode_and_resolve_as_the_plain_versions(cuda):
    """At a view's columns (a covered mask true for the base and half the
    replicas, interleaved in Lamport order): succ_vis, expand_runs at
    every run-native stack and unpack_flags of the packed transport's
    flags column equal their plain versions."""
    from automerge_tpu_torch.kernels import expand_runs as E
    from automerge_tpu_torch.ops.merge import (
        _flags_column, _unpack_transport, encode_transport,
    )

    blobs, cuts = next((b, c) for n, b, c in _view_docs() if n == "text")
    doc = DeviceDoc.merge(blobs, device="cpu")
    covered = doc.at(cuts[-1]).covered
    assert covered.any() and not covered.all()
    cols = doc.log.padded_columns(covered=covered)
    _, stacks, plan = stage_cols_run_native(cols, cuda)
    assert plan
    for (n, rcap, cls, names, bools), arrs in zip(plan, stacks):
        args = (arrs[0], arrs[1], arrs[2] if cls == "delta" else None, n, bools)
        _same(E.expand_runs(*args), E.expand_runs_plain(*args))
    c = columns_from_numpy(cols, cuda)
    sv_in = (c["action"], c["value_tag"], c["value_i32"], c["covered"],
             c["pred_src"], c["pred_tgt"])
    _same(SV.succ_vis(*sv_in), SV.succ_vis_plain(*sv_in))
    key, arrays = encode_transport(cols)
    a = {k: torch.from_numpy(v).to(cuda) for k, v in arrays.items()}
    P, Q = len(cols["action"]), len(cols["pred_src"])
    decoded = _unpack_transport(key, a, P, Q)
    assert torch.equal(decoded["covered"].cpu(), torch.from_numpy(cols["covered"]))
    flags = torch.from_numpy(_flags_column(cols)).to(cuda)
    _same(E.unpack_flags(flags), E.unpack_flags_plain(flags))


def _serve_trio(cuda, n_docs, cycles, ops, ballast, burst=None):
    base, deltas, texts = W.serve_workload(n_docs, cycles, ops, ballast, burst=burst)
    docs = {k: [DeviceDoc.merge([base], device=d) for _ in range(n_docs)]
            for k, d in (("packed", cuda), ("card", cuda), ("cpu", "cpu"))}
    return deltas, texts, docs


def _equal_docs(a, b, where):
    n = a.log.n
    assert (n, a.log.n_objs) == (b.log.n, b.log.n_objs), where
    for k in DeviceDoc.READ_FETCH:
        cut = a.log.n_objs + 2 if k.startswith("obj_") else n
        np.testing.assert_array_equal(np.asarray(a.res[k])[:cut],
                                      np.asarray(b.res[k])[:cut], err_msg=f"{where} {k}")


def test_cross_doc_on_card_equals_each_documents_own_apply(cuda):
    """Serve-shaped documents drained through ``apply_cross_doc`` on the
    card, two packed launches a cycle (chunks of four, pipelined), a
    burst's document peeled as a whale from its cycle on: equal, after
    every cycle, to each document's own ``apply_batches`` on the card and
    on the CPU; every launch of the path is one of the packed merges or
    the whale's."""
    from automerge_tpu_torch.ops import batched as B

    n, cycles = 8, 3
    deltas, texts, docs = _serve_trio(cuda, n, cycles, 12, 300, burst={(0, 1): 200})
    for c in range(cycles):
        B.reset_stats()
        reset_launches()
        out = B.apply_cross_doc([(d, [[deltas[i][c]]]) for i, d in enumerate(docs["packed"])],
                                device=cuda, max_docs_per_launch=4)
        counts, s = launch_counts(), B.stats()
        merges = s["launches"] + s["batched_fallback"]
        assert s["launches"] == 2 and s["batched_error"] == 0 and s["scalar_docs"] == 0, s
        assert s["batched_fallback"] == (0 if c == 0 else 1), s  # the burst on
        assert out["applied"] == n and out["fallback"] == s["batched_fallback"]
        assert counts["linearize"] == L.LAUNCHES * merges
        assert counts["succ_vis"] == 2 * merges and counts["forest"] == 2 * merges
        assert counts["scatter_winners"] // 2 + counts["sort_winners"] // 3 == merges
        for i in range(n):
            docs["card"][i].apply_batches([[deltas[i][c]]])
            docs["cpu"][i].apply_changes([deltas[i][c]])
            _equal_docs(docs["packed"][i], docs["card"][i], (c, i, "card"))
            _equal_docs(docs["packed"][i], docs["cpu"][i], (c, i, "cpu"))
    assert [d.text(W.SERVE_LIVE) for d in docs["packed"]] == texts


def test_cross_doc_batch_past_the_scatter_gate_on_card(cuda):
    """Two documents whose subsets each pass the scatter gate pack into a
    batch past it: the packed launch on the card runs ``sort_winners``,
    and equals each document's own launch on the card and on the CPU."""
    from automerge_tpu.api import AutoDoc
    from automerge_tpu.types import ActorId, ObjType

    from automerge_tpu_torch.ops import batched as B
    from automerge_tpu_torch.ops.merge import scatter_geometry_ok
    from automerge_tpu_torch.ops.oplog import pad_columns

    def many_objects(i):
        base = AutoDoc(actor=ActorId(bytes([1]) * 16))
        for k in range(900):
            base.put("_root", f"{'kz'[i]}{k}", k)
        kids = [base.put_object("_root", f"m{j}", ObjType.MAP) for j in range(60)]
        for j, m in enumerate(kids):
            base.put(m, f"{'kz'[i]}{j}", j)
        base.commit()
        chs = [a.stored.raw_bytes for a in base.doc.history]
        f = base.fork(actor=ActorId(bytes([30 + i]) * 16))
        for j, m in enumerate(kids):
            f.put(m, f"{'kz'[i]}{j}", -j)
        f.commit()
        return chs, [a.stored.raw_bytes for a in f.doc.history if a.stored.raw_bytes not in chs]

    made = [many_objects(i) for i in range(2)]
    packed = [DeviceDoc.merge(chs, device=cuda) for chs, _ in made]
    stages = [d.stage_batches([delta])[1] for d, (_, delta) in zip(packed, made)]
    cols, _, _, objs = B._pack(stages)
    n_props = max(len(s.doc.log.props) for s in stages)
    assert not scatter_geometry_ok(len(pad_columns(cols, objs)["action"]), objs, n_props)
    reset_launches()
    B.resolve_stages(stages, device=cuda)
    counts = launch_counts()
    assert counts["sort_winners"] == 3 and counts["scatter_winners"] == 0
    for d, (chs, delta) in zip(packed, made):
        alone = DeviceDoc.merge(chs, device=cuda)
        _, st = alone.stage_batches([delta])
        reset_launches()
        B.resolve_stages([st], device=cuda)
        assert launch_counts()["scatter_winners"] == 2
        cpu = DeviceDoc.merge(chs, device="cpu")
        cpu.apply_changes(delta)
        _equal_docs(d, alone, "alone on the card")
        _equal_docs(d, cpu, "cpu")


def _image_of(doc):
    from automerge_tpu_torch.storage import runsnap as R

    return R.parse(R.encode_snapshot(doc.log, doc.current_heads()))


@pytest.mark.parametrize("name", ["text", "records"])
def test_document_opened_from_an_image_on_card_equals_the_change_built(cuda, name):
    """A fan-in written as an ARSN image and opened cold on the card
    (``to_oplog``, then ``DeviceDoc.resolve``) equals the document merged
    from its changes, launch for launch, and the one opened on the CPU."""
    blobs = next(b for n, b, _ in _view_docs() if n == name)
    reset_launches()
    built = DeviceDoc.merge(blobs, device=cuda)
    want = launch_counts()
    log = _image_of(built).to_oplog()
    assert log._comp is not None
    reset_launches()
    cold = DeviceDoc.resolve(log, device=cuda)
    assert launch_counts() == want
    assert want["linearize"] == L.LAUNCHES and want["expand_runs"] >= 1
    _equal_docs(cold, built, name)
    _equal_docs(cold, DeviceDoc.resolve(_image_of(built).to_oplog(), device="cpu"),
                (name, "cpu"))
    assert cold.audit_columns() == [] and cold.hydrate() == built.hydrate()


def test_cross_doc_drain_of_documents_opened_from_images_on_card(cuda):
    """Serve-shaped documents opened from images on the card and drained
    by ``apply_cross_doc``: equal after every cycle to each change-built
    document's own ``apply_batches`` on the card, with the staged splice
    joining over the id runs (``compressed.stats()["ovc_join"]``)."""
    from automerge_tpu_torch.ops import batched as B
    from automerge_tpu_torch.ops import compressed as C

    n, cycles = 8, 3
    deltas, texts, docs = _serve_trio(cuda, n, cycles, 12, 300)
    cold = [DeviceDoc.resolve(_image_of(d).to_oplog(), device=cuda) for d in docs["card"]]
    ovc = 0
    for c in range(cycles):
        C.reset_stats()
        B.reset_stats()
        B.apply_cross_doc([(d, [[deltas[i][c]]]) for i, d in enumerate(cold)],
                          device=cuda, max_docs_per_launch=4)
        s = B.stats()
        assert s["launches"] == 2 and s["batched_error"] == 0 and s["scalar_docs"] == 0, s
        ovc += C.stats()["ovc_join"]
        for i in range(n):
            docs["card"][i].apply_batches([[deltas[i][c]]])
            _equal_docs(cold[i], docs["card"][i], (c, i))
    assert ovc > 0
    assert [d.text(W.SERVE_LIVE) for d in cold] == texts
    assert all(d.audit_columns() == [] for d in cold)


# the merge kernels a document's stale read, rebuild and save run
DOC_MERGE_KERNELS = ("expand_runs", "succ_vis", "forest", "radix_sort", "linearize")


def _doc_merge_launched(counts):
    return (all(counts[k] >= 1 for k in DOC_MERGE_KERNELS)
            and counts["scatter_winners"] + counts["sort_winners"] >= 1)


@pytest.mark.parametrize("name", ["text", "records", "history"])
def test_document_catch_up_on_card_equals_cpu(cuda, name, monkeypatch):
    """A bulk catch-up into an ``AutoDoc`` on the card: its stale text
    reads, the op-store rebuild a read then makes, a local edit and the
    save equal the same catch-up on the CPU. The stale reads run the merge
    kernels on the card; the rebuild at the same history length reuses
    their merge (``Document._history_merge``) and launches nothing, or
    runs the kernels itself where no text was read; the save after the
    edit runs them again. The save made on the card loads on the CPU."""
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.core.document import Document
    from automerge_tpu_torch.types import ActorId

    monkeypatch.setattr(Document, "BULK_MIN_OPS", 1)
    blobs = next(b for n, b, _ in _view_docs() if n == name)
    parsed = [parse_change(b)[0] for b in blobs]
    log = OpLog.from_changes(parsed)
    texts = [log.export_id(int(k)) for k in log.id_key[log.action == 4]]
    card, cpu = (AutoDoc(ActorId(bytes([0x77]) * 16), device=dev)
                 for dev in (cuda, "cpu"))
    for d in (card, cpu):
        d.apply_changes(parsed)
        assert d.doc._ops_stale
    reset_launches()
    assert [card.text(t) for t in texts] == [cpu.text(t) for t in texts]
    assert card.doc._ops_stale
    if texts:
        assert _doc_merge_launched(launch_counts())
    reset_launches()
    assert card.hydrate() == cpu.hydrate()
    if texts:
        assert not any(launch_counts().values())
    else:
        assert _doc_merge_launched(launch_counts())
    for d in (card, cpu):
        d.put("_root", "caught up", True)
        d.commit(timestamp=1)
    assert card.get_heads() == cpu.get_heads()
    reset_launches()
    data = card.save()
    assert _doc_merge_launched(launch_counts())
    assert data == cpu.save()
    loaded = AutoDoc.load(data, device="cpu")
    assert loaded.get_heads() == card.get_heads()
    assert loaded.hydrate() == card.hydrate()
    assert AutoDoc.load(cpu.save(), device=cuda).save() == data


def _sync_catch_up(device, base, deltas, seed):
    """A replica holding ``base`` catches up with a peer holding ``base``
    and ``deltas`` through sessions over seeded lossy channels, its
    resident ``DeviceDoc`` on ``device`` fed by ``receive_many``. Returns
    (the replica, its resident document, the peer)."""
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.sync import FaultyChannel, SyncSession
    from automerge_tpu_torch.types import ActorId

    a = AutoDoc(ActorId(bytes([0x61]) * 16), device=device)
    b = AutoDoc(ActorId(bytes([0x62]) * 16), device=device)
    a.apply_changes([parse_change(x)[0] for x in [base] + deltas])
    b.apply_changes([parse_change(base)[0]])
    dev = DeviceDoc.merge([base], device=device)
    sa, sb = SyncSession(a, epoch=1), SyncSession(b, epoch=2, device_doc=dev)
    ab = FaultyChannel(seed=seed, drop=0.2, dup=0.2, reorder=0.2, bitflip=0.1)
    ba = FaultyChannel(seed=seed + 1, drop=0.2, dup=0.2, reorder=0.2, bitflip=0.1)
    for tick in range(1, 3000):
        out = sa.poll(tick)
        if out is not None:
            ab.send(out, tick)
        out = sb.poll(tick)
        if out is not None:
            ba.send(out, tick)
        sb.receive_many(ab.drain(tick), tick)
        for data in ba.drain(tick):
            sa.receive(data, tick)
        if a.get_heads() == b.get_heads() and sa.converged() and sb.converged() \
                and not ab.pending and not ba.pending:
            return b, dev, a
    raise AssertionError("no convergence")


def test_sync_catch_up_feeds_a_device_doc_on_card_equal_to_cpu(cuda, monkeypatch):
    """A session catch-up with the replica's resident ``DeviceDoc`` on the
    card equals the same run on the CPU (the same frames arrive: the
    channels are seeded), and a fresh merge of the replica's history; the
    feed ran the merge kernels on the card. The replica takes the bulk
    path: its stale read merges on the card, the edit's rebuild reuses
    that merge and launches nothing."""
    from automerge_tpu_torch.core.document import Document

    monkeypatch.setattr(Document, "BULK_MIN_OPS", 1)
    trace = W.load_trace(3000)
    base = W.build_base(trace, 2000)
    reps = W.synth_fanin(base, trace, 12, 40, 2000)
    blob = [c.raw_bytes for c in base.changes]
    assert len(blob) == 1
    deltas = [c.raw_bytes for c in reps]
    reset_launches()
    card, card_dev, _ = _sync_catch_up(cuda, blob[0], deltas, 5)
    assert _doc_merge_launched(launch_counts())
    cpu, cpu_dev, peer = _sync_catch_up("cpu", blob[0], deltas, 5)
    _equal_docs(card_dev, cpu_dev, "card against cpu")
    fresh = DeviceDoc.merge([card], device=cuda)
    _equal_docs(card_dev, fresh, "card against a fresh merge")
    t = base.text_exid
    assert card.doc._ops_stale
    reset_launches()
    assert card.text(t) == cpu.text(t) == peer.text(t) == card_dev.text(t)
    assert _doc_merge_launched(launch_counts()) and card.doc._ops_stale
    reset_launches()
    for d in (card, cpu):
        d.splice_text(t, 3, 0, "<edit>")
        d.commit(timestamp=1)
    assert not any(launch_counts().values()) and not card.doc._ops_stale
    assert card.text(t) == cpu.text(t) and card.save() == cpu.save()


def test_receive_many_feeds_the_cross_doc_batcher_on_card(cuda):
    """Serve-shaped server sessions drained by ``receive_many`` with
    ``device_feed`` into a ``CrossDocBatcher`` on the card, one thread a
    document: packed launches on the card, each resident document equal to
    its own ``apply_batches`` on the CPU after every cycle."""
    import threading

    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.ops import batched as B
    from automerge_tpu_torch.sync import SyncSession
    from automerge_tpu_torch.types import ActorId

    n, cycles = 8, 3
    base, deltas, texts = W.serve_workload(n, cycles, 12, 300)
    servers = [AutoDoc(ActorId(bytes([100 + i]) * 16), device=cuda) for i in range(n)]
    clients = [AutoDoc(ActorId(bytes([150 + i]) * 16), device=cuda) for i in range(n)]
    for d in servers + clients:
        d.apply_changes([parse_change(base)[0]])
    devs = [DeviceDoc.merge([base], device=cuda) for _ in range(n)]
    twins = [DeviceDoc.merge([base], device="cpu") for _ in range(n)]
    ss = [SyncSession(s, epoch=1, device_doc=d) for s, d in zip(servers, devs)]
    cs = [SyncSession(c, epoch=2) for c in clients]
    batcher = B.CrossDocBatcher(mode="1", window_ms=2000.0, max_docs=4, device=cuda)

    def converse(i, now, feed):
        for k in range(20):
            frame = cs[i].poll(now + k)
            ss[i].receive_many([frame] if frame is not None else [], now + k,
                               device_feed=feed)
            reply = ss[i].poll(now + k)
            if reply is not None:
                cs[i].receive(reply, now + k)
            if cs[i].converged() and ss[i].converged():
                return
        raise AssertionError("no convergence")

    for i in range(n):
        converse(i, 0, None)
    for c in range(cycles):
        fed = [[] for _ in range(n)]
        errs = []
        for i in range(n):
            clients[i].apply_changes([parse_change(deltas[i][c])[0]])

        def worker(i):
            def feed(batches):
                fed[i].extend(list(b) for b in batches)
                return batcher.apply(devs[i], batches)
            try:
                converse(i, 100 * (c + 1), feed)
            except BaseException as e:  # noqa: BLE001 - raised below
                errs.append(e)

        B.reset_stats()
        reset_launches()
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, errs
        s, counts = B.stats(), launch_counts()
        assert s["launches"] >= 2 and s["batched_error"] == 0, s
        assert counts["linearize"] == L.LAUNCHES * (s["launches"] + s["batched_fallback"])
        for i in range(n):
            twins[i].apply_batches(fed[i])
            _equal_docs(devs[i], twins[i], (c, i))
            assert servers[i].get_heads() == clients[i].get_heads()
    assert [d.text(W.SERVE_LIVE) for d in devs] == texts


# -- observability on the card (obs/prof.py) ----------------------------------


def test_capture_finds_the_ranges_and_their_kernels(cuda, tmp_path):
    """A ``torch.profiler`` capture around one small merge: the
    ``amtpu.resolve`` range holds the merge's CUDA kernels, and the
    window's busy share is a fraction of its wall."""
    from automerge_tpu_torch.obs import prof

    base, deltas, _ = W.serve_workload(4, 2, 8, 400)
    blobs = [base] + [d for ds in deltas for d in ds]
    DeviceDoc.merge(blobs, device=cuda)  # built and warm
    start = prof.torch_profile_start(str(tmp_path / "cap"))
    assert start["ok"], start
    try:
        with torch.profiler.record_function("test.window"):
            doc = DeviceDoc.merge(blobs, device=cuda)
            torch.cuda.synchronize()
    finally:
        stop = prof.torch_profile_stop()
    assert stop["ok"], stop
    cap = prof.read_capture(stop["trace"], "test.window")
    r = cap["ranges"]["amtpu.resolve"]
    assert r["count"] == 1 and r["kernels"] >= L.LAUNCHES, cap
    assert cap["kernels"] >= r["kernels"] and 0 < cap["busy_share"] < 1, cap
    assert doc.text(W.SERVE_LIVE) == DeviceDoc.merge(blobs, device="cpu").text(
        W.SERVE_LIVE)


def test_cycle_over_a_served_batch_notes_the_wrappers_launches(cuda):
    """``prof.cycle`` over one served batch on the card: its ``launches``
    note is the merges the kernels' counts show (``linearize`` runs
    LAUNCHES a merge, ``expand_runs`` once), and its device stages are
    there."""
    from automerge_tpu_torch import obs
    from automerge_tpu_torch.obs import prof

    base, reps, _ = _record_store()
    batches = W.record_batches(reps, 8)
    doc = DeviceDoc.merge([base], device=cuda)
    doc.apply_batches(batches[:1])
    obs.reset_all()
    reset_launches()
    with prof.cycle(kind="serve", docs=1) as c:
        doc.apply_batches(batches[1:3])
    r, counts = c.report, launch_counts()
    assert r["launches"] == 2 and counts["linearize"] == L.LAUNCHES * r["launches"]
    assert counts["expand_runs"] == r["launches"]
    assert obs.counter_values("device.kernel_launches", "path") == {
        "per_doc": 2, "run_native": 2}
    for stage in ("dedup", "splice", "materialize", "h2d", "kernel", "readback",
                  "scatter"):
        assert stage in r["stages"], r["stages"]
    assert 0 < r["attributed_frac"] <= 1 and r["device_s"] > 0


def _durable_dir(root, blobs, device, tail=8):
    """A durable directory holding ``blobs``: all but the last ``tail``
    compacted into the run image (written from the mirror's log), those
    left in the journal."""
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.storage.change import parse_change as pc

    parsed = [pc(b)[0] for b in blobs]
    dd = AutoDoc.open(str(root), mirror=True, device=device, fsync="never")
    dd.apply_changes(parsed[:-tail])
    dd.drop_device_mirror()
    dd.build_device_mirror()
    assert dd.compact()
    dd.apply_changes(parsed[-tail:])
    dd.close()
    return str(root)


@pytest.mark.parametrize("name", ["text", "records"])
def test_durable_open_with_a_mirror_on_card_equals_cpu(cuda, tmp_path, name):
    """``open(mirror=True)`` on the card (the image's resolve, then the
    journal's replay through the served kernels) equals the same open with
    ``device="cpu"`` array for array; so does a ``build_device_mirror``
    after ``drop_device_mirror``, which decodes the retained image."""
    import shutil

    from automerge_tpu_torch import obs
    from automerge_tpu_torch.api import AutoDoc

    blobs = next(b for n, b, _ in _view_docs() if n == name)
    d = _durable_dir(tmp_path / "d", blobs, "cpu")
    shutil.copytree(d, str(tmp_path / "c"))
    obs.reset_all()
    reset_launches()
    card = AutoDoc.open(d, mirror=True, device=cuda)
    counts = launch_counts()
    assert counts["linearize"] >= L.LAUNCHES and counts["succ_vis"] >= 1, counts
    assert obs.counter_values("oplog.hydrate_reencode", "") == {}
    cpu = AutoDoc.open(str(tmp_path / "c"), mirror=True, device="cpu")
    assert card.device_doc.device.type == cuda.type
    _equal_docs(card.device_doc, cpu.device_doc, (name, "open"))
    assert card.device_doc.hydrate() == cpu.device_doc.hydrate() == cpu.hydrate()
    assert card.doc_digest() == cpu.doc_digest()
    for dd in (card, cpu):
        dd.drop_device_mirror()
    reset_launches()
    dev = card.build_device_mirror()
    assert launch_counts()["linearize"] == L.LAUNCHES
    _equal_docs(dev, cpu.build_device_mirror(), (name, "promote"))
    assert dev.audit_columns() == []
    card.close()
    cpu.close()


def test_replicated_apply_feeds_the_batcher_on_card(cuda, tmp_path):
    """A follower on the card takes the leader's image, then its journal
    tail through ``apply_replicated(..., device_feed=)`` into a
    ``CrossDocBatcher``: its mirror equals the leader's, on the card and
    against the CPU."""
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.ops.batched import CrossDocBatcher
    from automerge_tpu_torch.storage.durable import JOURNAL_NAME
    from automerge_tpu_torch.storage.journal import scan_records

    blobs = next(b for n, b, _ in _view_docs() if n == "text")
    lead_dir = _durable_dir(tmp_path / "lead", blobs, cuda)
    leader = AutoDoc.open(lead_dir, mirror=True, device=cuda)
    with open(f"{lead_dir}/{JOURNAL_NAME}", "rb") as f:
        records = [(r.rec_type, r.payload) for r in scan_records(f.read())[0]]
    image_log_changes = len(leader.device_doc.log.changes) - len(records)
    assert image_log_changes > 0
    followers = {}
    for key, dev in (("card", cuda), ("cpu", "cpu")):
        fol = AutoDoc.open(str(tmp_path / f"fol-{key}"), mirror=True, device=dev)
        snap = AutoDoc.open(str(tmp_path / f"img-{key}"), device="cpu")
        snap.apply_changes([c for c in leader.device_doc.log.changes[:image_log_changes]])
        fol.apply_replicated_snapshot(snap.snapshot_bytes(), b"c1")
        snap.close()
        fol.drop_device_mirror()
        fol.build_device_mirror()
        batcher = CrossDocBatcher(mode="1", device=dev)
        fed = []
        reset_launches()
        fol.apply_replicated(records, b"c2", device_feed=lambda doc, m, chs:
                             fed.append(batcher.apply(m, [chs])))
        assert fed == [len(records)]
        if key == "card":  # the feed resolved through the kernels
            assert launch_counts()["linearize"] == L.LAUNCHES
        followers[key] = fol
    _equal_docs(followers["card"].device_doc, leader.device_doc, "follower on card")
    _equal_docs(followers["card"].device_doc, followers["cpu"].device_doc, "card vs cpu")
    for d in (leader, *followers.values()):
        d.close()


def _rpc_feed(call, d, n_peers=3, rounds=3, archive=600):
    """Peers with fixed actors sync into durable document ``d`` through
    ``call(method, **params)``: each writes an archive text first, then
    types into a small live text, round by round."""
    peers = []
    for i in range(n_peers):
        p = call("create", actor=f"{0x30 + i:02x}" * 16)["doc"]
        arch = call("putObject", doc=p, obj="_root", prop="archive", type="text")["$obj"]
        call("spliceText", doc=p, obj=arch, pos=0, text=f"{i}" * archive)
        live = call("putObject", doc=p, obj="_root", prop="live", type="text")["$obj"]
        call("commit", doc=p)
        peers.append((p, live, call("syncStateNew")["sync"], call("syncStateNew")["sync"]))
    for r in range(rounds + 1):
        for p, live, _, _ in peers:
            if r:
                call("spliceText", doc=p, obj=live, pos=0, text=f"r{r} ")
                call("commit", doc=p)
        for _ in range(12):
            moved = False
            for p, _, sp, sd in peers:
                m = call("generateSyncMessage", doc=p, sync=sp)
                if m is not None:
                    moved = True
                    call("receiveSyncMessage", doc=d, sync=sd, data=m)
                b = call("generateSyncMessage", doc=d, sync=sd)
                if b is not None:
                    moved = True
                    call("receiveSyncMessage", doc=p, sync=sp, data=b)
            if not moved:
                break


def test_rpc_server_on_card_equals_cpu(cuda, tmp_path):
    """``RpcServer()`` serves the card: a mirrored durable document fed by
    sync peers, compacted, demoted to warm and cold and promoted by a
    request holds a mirror equal, array for array, to the same sequence
    on ``RpcServer(device="cpu")``; the card's feeds launched the
    kernels."""
    from automerge_tpu_torch.rpc import RpcServer

    mirrors = {}
    for key, dev in (("card", None), ("cpu", "cpu")):
        srv = RpcServer(durable_dir=str(tmp_path / key), device=dev)

        def call(method, **params):
            resp = srv.handle({"id": 1, "method": method, "params": params})
            assert "error" not in resp, (method, resp)
            return resp["result"]

        reset_launches()
        d = call("openDurable", name="doc", device=True)["doc"]
        _rpc_feed(call, d)
        fed = launch_counts()
        call("durableCompact", doc=d)
        assert call("storeDemote", name="doc", to="warm")["tier"] == "warm"
        assert call("storeDemote", name="doc", to="cold")["tier"] == "cold"
        reset_launches()
        text = call("materialize", doc=d)
        assert srv.store.tier("doc") == "hot"
        promoted = launch_counts()
        dd = srv._docs[d]
        assert dd.device_doc.hydrate() == text == dd.hydrate()
        if key == "card":
            assert dd.device_doc.device.type == "cuda"
            assert fed["linearize"] > 0 and promoted["linearize"] == L.LAUNCHES, (
                fed, promoted)
        mirrors[key] = (srv, dd.device_doc)
    _equal_docs(mirrors["card"][1], mirrors["cpu"][1], "rpc server card vs cpu")
    for srv, _ in mirrors.values():
        srv.close_durables()


def test_socket_server_on_card_batches_concurrent_peers(cuda, tmp_path):
    """``SocketRpcServer()`` on the card with eight concurrent peers, each
    over its own connection: their feeds ride the cross-document batcher
    (packed launches), and every mirror equals a fresh resolve of its
    document on the card."""
    import json
    import socket
    import threading

    from automerge_tpu_torch.ops import batched as B
    from automerge_tpu_torch.serve import SocketRpcServer

    srv = SocketRpcServer(host="127.0.0.1", port=0, durable_dir=str(tmp_path),
                          workers=8)
    srv.start()
    try:
        assert srv.batcher.device.type == "cuda"

        def client():
            sock = socket.create_connection(srv.address, timeout=120)
            f = sock.makefile("r")

            def call(method, **params):
                sock.sendall((json.dumps({"id": 1, "method": method,
                                          "params": params}) + "\n").encode())
                resp = json.loads(f.readline())
                assert "error" not in resp, (method, resp)
                return resp["result"]

            return sock, call

        sock, call = client()
        docs = [call("openDurable", name=f"m{i}", device=True)["doc"] for i in range(8)]
        sock.close()
        B.reset_stats()
        errs = []

        def peer(i):
            try:
                s, c = client()
                _rpc_feed(c, docs[i], n_peers=1, rounds=4)
                s.close()
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(f"{i}: {e!r}")

        ts = [threading.Thread(target=peer, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)
        assert not any(t.is_alive() for t in ts) and not errs, errs
        assert B.stats()["launches"] > 0, B.stats()
        for h in docs:
            dd = srv.rpc._docs[h]
            assert dd.device_doc.device.type == "cuda"
            _equal_docs(dd.device_doc, DeviceDoc.merge([dd.doc], device=cuda),
                        f"doc {h}")
    finally:
        srv.stop()


class _LineClient:
    """A JSON-line client with a read timeout, for the cluster nodes."""

    def __init__(self, address):
        import json
        import socket

        self.json = json
        self.sock = socket.create_connection(tuple(address), timeout=120)
        self.f = self.sock.makefile("r")

    def call(self, method, **params):
        self.sock.sendall((self.json.dumps({"id": 1, "method": method,
                                            "params": params}) + "\n").encode())
        resp = self.json.loads(self.f.readline())
        assert "error" not in resp, (method, resp)
        return resp.get("result")

    def close(self):
        self.sock.close()


def _node(root, name, device, **kw):
    from automerge_tpu_torch.cluster import ClusterNode

    node = ClusterNode(node_id=name, host="127.0.0.1", port=0,
                       durable_dir=str(root / name), device=device, **kw)
    node.start()
    return node


def _addr(node):
    return "%s:%d" % tuple(node.address)


def _until(pred, what, timeout=120.0):
    import time

    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _replica(node, name):
    return node.rpc._docs[node.rpc._durable_names[name]]


def test_mirrored_follower_on_card_equals_a_cpu_follower(cuda, tmp_path):
    """A port leader (on the CPU) ships to two mirrored followers, one on
    the card and one on the CPU (``ack_replicas=2``): after every acked
    commit the card follower's mirror equals the CPU follower's on every
    READ_FETCH array, and its batched drains launched the served kernels
    on the card."""
    fols = {"card": _node(tmp_path, "fc", None, role="follower"),
            "cpu": _node(tmp_path, "fp", "cpu", role="follower")}
    led = None
    try:
        assert fols["card"].rpc.device.type == "cuda"
        assert fols["card"].batcher.device.type == "cuda"
        names = ("ga", "gb")
        for f in fols.values():
            fc = _LineClient(f.address)
            for name in names:
                fc.call("openDurable", name=name, device=True)
            fc.close()
        led = _node(tmp_path, "l", "cpu", role="leader",
                    replicate_to=[_addr(f) for f in fols.values()], ack_replicas=2)
        c = _LineClient(led.address)
        handles = {n: c.call("openDurable", name=n)["doc"] for n in names}
        for name in names:
            for f in fols.values():
                _until(lambda: _replica(f, name).replication_cursor is not None,
                       f"{name}'s snapshot")
        texts = {n: c.call("putObject", doc=h, obj="_root", prop="t", type="text")["$obj"]
                 for n, h in handles.items()}
        reset_launches()
        for step in range(8):
            for name, h in handles.items():
                c.call("spliceText", doc=h, obj=texts[name], pos=0, text=f"{step}-{name} ")
                c.call("put", doc=h, obj="_root", prop=f"k{step % 3}", value=step)
                c.call("commit", doc=h)
                card = _replica(fols["card"], name)
                cpu = _replica(fols["cpu"], name)
                with card.lock, cpu.lock:
                    assert card.device_doc.device.type == "cuda"
                    _equal_docs(card.device_doc, cpu.device_doc, f"{name} step {step}")
                    assert card.device_doc.hydrate() == cpu.device_doc.hydrate()
        fed = launch_counts()
        assert fed["expand_runs"] > 0 and fed["linearize"] > 0, fed
        c.close()
    finally:
        if led is not None:
            led.stop()
        for f in fols.values():
            f.stop()


def test_follower_snapshot_resync_rebuilds_its_mirror_on_card(cuda, tmp_path):
    """A mirrored replica on the card caught up by a snapshot that holds
    changes: its mirror is rebuilt from the grown history through the
    kernels and equals a fresh resolve on the card; the next tail feeds
    the rebuilt mirror."""
    fol = _node(tmp_path, "f", None, role="follower")
    led = _node(tmp_path, "l", "cpu", role="leader")
    try:
        fc = _LineClient(fol.address)
        fc.call("openDurable", name="rs", device=True)
        c = _LineClient(led.address)
        d = c.call("openDurable", name="rs")["doc"]
        for i in range(4):
            c.call("put", doc=d, obj="_root", prop=f"k{i}", value=i)
            c.call("commit", doc=d)
        reset_launches()
        c.call("clusterReplicateTo", addr=_addr(fol))
        doc = _replica(fol, "rs")
        _until(lambda: doc.replication_cursor is not None, "the snapshot")
        _until(lambda: doc.device_doc is not None
               and doc.device_doc.hydrate().get("k3") == 3, "the rebuilt mirror")
        assert launch_counts()["linearize"] == L.LAUNCHES
        with doc.lock:
            assert doc.device_doc.device.type == "cuda"
            _equal_docs(doc.device_doc, DeviceDoc.merge([doc.doc], device=cuda), "resync")
        c.call("put", doc=d, obj="_root", prop="k4", value=4)
        c.call("commit", doc=d)
        _until(lambda: doc.device_doc.hydrate().get("k4") == 4, "the fed tail")
        with doc.lock:
            _equal_docs(doc.device_doc, DeviceDoc.merge([doc.doc], device=cuda), "tail")
        c.close()
        fc.close()
    finally:
        led.stop()
        fol.stop()


def test_cluster_node_raises_without_a_gpu(monkeypatch, tmp_path):
    """``ClusterNode()`` serves the card: without a GPU it raises before
    any socket or thread exists, as leader and as follower."""
    from automerge_tpu_torch.cluster import ClusterNode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for role in ("leader", "follower"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ClusterNode(node_id="n", host="127.0.0.1", port=0,
                        durable_dir=str(tmp_path / role), role=role)


def _typed(device, edits, every):
    """``edits`` typed one ``splice_text`` at a time through the native
    sessions into an ``AutoDoc`` on ``device``, committing every
    ``every``; returns (document, text object)."""
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.types import ActorId, ObjType

    d = AutoDoc(ActorId(bytes([0x5A]) * 16), device=device)
    t = d.put_object("_root", "text", ObjType.TEXT)
    d.commit(timestamp=1)
    for i, (pos, ndel, *chars) in enumerate(edits):
        d.splice_text(t, pos, ndel, "".join(chars))
        if i % every == every - 1:
            d.commit(timestamp=2)
    d.commit(timestamp=2)
    return d, t


def test_session_typed_document_rebuilds_on_card_equal_to_cpu(cuda):
    """A trace typed through the native sessions on the card: each large
    session commit leaves the op store stale and keeps its session, so the
    typing launches nothing, and the first read runs the merge kernels on
    the card; text, save and hydrate equal the same typing on the CPU."""
    from automerge_tpu_torch.core.transaction import Transaction

    edits = W.load_trace(3000)
    every = Transaction.SMALL_TAIL_OPS * 4
    reset_launches()
    card, tc = _typed(cuda, edits, every)
    # each commit kept its session for the next transaction: no rebuild ran
    assert not any(launch_counts().values())
    cpu, tp = _typed("cpu", edits, every)
    assert card.doc._ops_stale
    reset_launches()
    assert card.text(tc) == cpu.text(tp)
    assert _doc_merge_launched(launch_counts())
    assert card.save() == cpu.save()
    assert card.hydrate() == cpu.hydrate()


def test_cli_merge_on_card_equals_cpu(cuda, tmp_path, monkeypatch):
    """``cli.main(["--device", "cuda", "merge", ...])``: the bulk catch-up
    of the merged files runs the merge kernels on the card, and its output
    equals the same merge on the CPU."""
    from automerge_tpu_torch import cli
    from automerge_tpu_torch.core.document import Document

    monkeypatch.setattr(Document, "BULK_MIN_OPS", 1)
    trace = W.load_trace(3000)
    base = W.build_base(trace, 2000)
    reps = W.synth_fanin(base, trace, 8, 50, 2000)
    files = []
    for i, chunk in enumerate([base.changes] + [reps[k::4] for k in range(4)]):
        p = tmp_path / f"in{i}.automerge"
        p.write_bytes(b"".join(c.raw_bytes for c in chunk))
        files.append(str(p))
    out = {}
    for dev in (str(cuda), "cpu"):
        reset_launches()
        assert cli.main(["--device", dev, "merge", *files, "-o",
                         str(tmp_path / f"{dev}.automerge")]) == 0
        if dev == "cuda":
            assert _doc_merge_launched(launch_counts())
        out[dev] = (tmp_path / f"{dev}.automerge").read_bytes()
        assert cli.main(["--device", dev, "export", str(tmp_path / f"{dev}.automerge"),
                         "-o", str(tmp_path / f"{dev}.json")]) == 0
    assert out[str(cuda)] == out["cpu"]
    assert (tmp_path / f"{cuda}.json").read_bytes() == (tmp_path / "cpu.json").read_bytes()


# -- the C ABI on the card -------------------------------------------------------


def _c_env():
    """A C program's environment: the port's documents on the card (no
    device setting) and this interpreter's import path."""
    import os

    from automerge_tpu_torch import capi

    env = dict(os.environ, PYTHONPATH=capi.python_path())
    env.pop("AUTOMERGE_TPU_TORCH_DEVICE", None)
    return env


@pytest.mark.parametrize("source", ["test_am.c", "test_basic.c", "test_sync.c",
                                    "test_ported2.c", "test_ported3.c"])
def test_c_suite_on_card(cuda, tmp_path, source):
    """The reference's C suites, unchanged, against the port's library
    with the device left unset: every document they make is on the card."""
    import subprocess

    from automerge_tpu_torch import capi

    assert source in capi.TEST_SOURCES
    exe = capi.build_test(capi.build(), str(tmp_path), source=source)
    r = subprocess.run([exe], capture_output=True, text=True, timeout=600,
                       env=_c_env())
    assert r.returncode == 0, f"stdout: {r.stdout}\nstderr: {r.stderr}"
    assert "all assertions passed" in r.stdout


def test_typist_on_card_equals_the_session_path(cuda, tmp_path):
    """``type_edits.c`` types a trace through the C hot-call cache on the
    card, a commit every 1,000 edits; its save equals the same edits typed
    through ``AutoDoc.splice_text``'s sessions on the card, and its text
    the trace's."""
    import subprocess

    from automerge_tpu_torch import capi
    from automerge_tpu_torch.api import AutoDoc
    from automerge_tpu_torch.capi import edits as E
    from automerge_tpu_torch.types import ActorId

    trace = W.load_trace(6000)
    records = E.from_trace(trace)
    path = tmp_path / "edits.bin"
    path.write_bytes(E.encode(records))
    exe = capi.build_test(capi.build(), str(tmp_path), source="type_edits.c")
    out = tmp_path / "typed.automerge"
    actor = bytes([0x5B]) * 16
    r = subprocess.run([exe, str(path), "1000", str(out), actor.hex()],
                       capture_output=True, text=True, timeout=600, env=_c_env())
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"typed {len(records)} records" in r.stdout and "record " not in r.stdout
    doc = AutoDoc(ActorId(actor), device=cuda)
    assert E.type_records(doc, records, 1000) == []
    assert out.read_bytes() == doc.save()
    text = []
    for pos, ndel, *chars in trace:
        del text[pos:pos + ndel]
        text[pos:pos] = chars
    back = AutoDoc.load(out.read_bytes(), device=cuda)
    assert back.text(back.get("_root", "text")[0][2]) == "".join(text)


# -- the integration corpus on the card --------------------------------------------

CORPUS = __import__("pathlib").Path(__file__).with_name("test_ported.py")


def _corpus_scenarios():
    import ast

    tree = ast.parse(CORPUS.read_text())
    return sorted(n.name for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name.startswith("test_"))


def _compress_chunk(chunk_bytes):
    """A change chunk deflated into a compressed chunk (type 2), its
    checksum the uncompressed one's: the input of the corpus's compressed
    change scenario, which the port reads but does not write."""
    import zlib

    from automerge_tpu_torch.storage.chunk import MAGIC_BYTES, parse_chunk
    from automerge_tpu_torch.utils.leb128 import encode_uleb

    chunk, _ = parse_chunk(chunk_bytes)
    co = zlib.compressobj(level=6, wbits=-15)
    deflated = co.compress(chunk.data) + co.flush()
    out = bytearray(MAGIC_BYTES)
    out += chunk.checksum
    out.append(2)
    encode_uleb(len(deflated), out)
    return bytes(out + deflated)


def _corpus_names(device):
    """What ``tests/test_ported.py`` imports from the JAX package, bound to
    the port's names with its documents and merges on ``device``."""
    import types

    import automerge_tpu_torch.patches.patch as ppatch
    import automerge_tpu_torch.storage.change as pchange
    import automerge_tpu_torch.testing as PTS
    from automerge_tpu_torch import expanded
    from automerge_tpu_torch.api import AutoDoc as _AutoDoc
    from automerge_tpu_torch.core.document import Document as _Document
    from automerge_tpu_torch.errors import AutomergeError
    from automerge_tpu_torch.types import ActorId, ObjType, ScalarValue

    class AutoDoc(_AutoDoc):
        def __init__(self, actor=None, document=None, text_encoding=None,
                     device=device):
            super().__init__(actor, document, text_encoding, device=device)

        @classmethod
        def load(cls, data, *a, **kw):
            kw.setdefault("device", device)
            return super().load(data, *a, **kw)

    class Document(_Document):
        def __init__(self, actor=None, text_encoding=None, device=device):
            super().__init__(actor, text_encoding, device=device)

        @classmethod
        def load(cls, data, *a, **kw):
            kw.setdefault("device", device)
            return super().load(data, *a, **kw)

    class CorpusDeviceDoc(DeviceDoc):
        @classmethod
        def merge(cls, changes, device=device, **kw):
            return super().merge(changes, device=device, **kw)

    def module(name, **names):
        m = types.ModuleType(name)
        m.__dict__.update(names)
        return m

    dsl = {k: getattr(PTS, k) for k in ("assert_doc", "assert_obj", "list_", "map_",
                                        "realize", "sorted_actors", "text_")}
    return {
        "automerge_tpu": module("automerge_tpu"),
        "automerge_tpu.api": module("automerge_tpu.api", AutoDoc=AutoDoc),
        "automerge_tpu.core": module("automerge_tpu.core"),
        "automerge_tpu.core.document": module("automerge_tpu.core.document",
                                              Document=Document),
        "automerge_tpu.errors": module("automerge_tpu.errors",
                                       AutomergeError=AutomergeError),
        "automerge_tpu.expanded": module("automerge_tpu.expanded",
                                         collapse_change=expanded.collapse_change,
                                         expand_change=expanded.expand_change),
        "automerge_tpu.ops": module("automerge_tpu.ops", DeviceDoc=CorpusDeviceDoc),
        "automerge_tpu.testing": module(
            "automerge_tpu.testing", **dsl,
            new_doc=lambda seed=None: PTS.new_doc(seed, device=device)),
        "automerge_tpu.types": module("automerge_tpu.types", ActorId=ActorId,
                                      ObjType=ObjType, ScalarValue=ScalarValue),
        "automerge_tpu.storage": module("automerge_tpu.storage"),
        "automerge_tpu.storage.chunk": module("automerge_tpu.storage.chunk",
                                              compress_chunk=_compress_chunk),
        "automerge_tpu.storage.change": pchange,
        "automerge_tpu.patches": module("automerge_tpu.patches"),
        "automerge_tpu.patches.patch": ppatch,
    }


def _corpus_run(device, name, monkeypatch, tmp_path):
    """Scenario ``name`` of the corpus on the port on ``device``: its own
    assertions, and every document it realizes, in order."""
    import importlib.util
    import inspect
    import os
    import random
    import sys
    import zlib

    import automerge_tpu_torch.testing as PTS

    seen = []
    with monkeypatch.context() as m:
        for k, v in _corpus_names(device).items():
            m.setitem(sys.modules, k, v)
        spec = importlib.util.spec_from_file_location(f"corpus_{device.type}", CORPUS)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        rng = random.Random(zlib.crc32(name.encode()))
        m.setattr(os, "urandom", lambda n: rng.randbytes(n))
        realize, assert_doc, assert_obj = mod.realize, mod.assert_doc, mod.assert_obj

        def rec_realize(doc, heads=None):
            out = realize(doc, heads=heads)
            seen.append(("realize", out))
            return out

        def rec_assert_doc(doc, expected, heads=None):
            seen.append(("doc", realize(doc, heads=heads)))
            return assert_doc(doc, expected, heads=heads)

        def rec_assert_obj(doc, obj, expected, heads=None):
            seen.append(("obj", obj, PTS.realize_obj(doc, obj, heads=heads)))
            return assert_obj(doc, obj, expected, heads=heads)

        mod.realize, mod.assert_doc, mod.assert_obj = (
            rec_realize, rec_assert_doc, rec_assert_obj)
        fn = getattr(mod, name)
        kwargs = {}
        if "tmp_path" in inspect.signature(fn).parameters:
            kwargs["tmp_path"] = tmp_path / device.type
            kwargs["tmp_path"].mkdir()
        fn(**kwargs)
    return seen


def test_corpus_on_card_is_the_whole_corpus():
    assert len(_corpus_scenarios()) == 63


@pytest.mark.parametrize("name", _corpus_scenarios())
def test_corpus_scenario_on_card_equals_cpu(cuda, name, monkeypatch, tmp_path):
    """A scenario of the reference's integration corpus on the port with
    its documents and device merges on the card: its own assertions pass,
    and every document it realizes equals the port's realization on the
    CPU at the same point (actor ids from one seeded stream)."""
    got = _corpus_run(cuda, name, monkeypatch, tmp_path)
    want = _corpus_run(torch.device("cpu"), name, monkeypatch, tmp_path)
    assert got == want
