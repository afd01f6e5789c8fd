"""automerge_tpu_torch kernels (plain PyTorch versions) vs the JAX reference.

Each kernel of the port's merge path is held against the JAX function it
replaces on the same padded op columns, built by the JAX package from
fuzzed multi-replica documents (text splices, map puts and conflicts,
counters, nested objects, concurrent same-position inserts, a partial
``covered`` mask). JAX runs on its CPU backend; the port's wrappers take
their plain versions for CPU tensors. Equality is exact throughout: all
of it is int32/bool arithmetic, and int32 adds commute and wrap alike.
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.api import AutoDoc
from automerge_tpu.ops import OpLog
from automerge_tpu.ops import merge as J
from automerge_tpu.types import ActorId, ObjType, ScalarValue
from automerge_tpu_torch.convert import columns_from_numpy
from automerge_tpu_torch.kernels import forest as F
from automerge_tpu_torch.kernels import launch_counts, reset_launches
from automerge_tpu_torch.kernels import linearize as L
from automerge_tpu_torch.kernels import radix_sort as RS
from automerge_tpu_torch.kernels import scatter_winners as SW
from automerge_tpu_torch.kernels import sort_winners as SO
from automerge_tpu_torch.kernels import succ_vis as SV
from automerge_tpu_torch.ops import merge as M


def _actor(i):
    return ActorId(bytes([i]) * 16)


def _text_fuzz(n_forks, n_edits, seed):
    rng = random.Random(seed)
    base = AutoDoc(actor=_actor(1))
    t = base.put_object("_root", "t", ObjType.TEXT)
    base.splice_text(t, 0, 0, "the quick brown fox jumps over the lazy dog")
    base.commit()
    forks = [base.fork(actor=_actor(50 + i)) for i in range(n_forks)]
    for f in forks:
        for _ in range(n_edits):
            ln = f.length(t)
            if rng.random() < 0.6 or ln == 0:
                f.splice_text(t, rng.randrange(ln + 1), 0, rng.choice("abcxyz"))
            else:
                f.splice_text(t, rng.randrange(ln), 1, "")
        f.commit()
    return forks


def _mixed_fuzz(seed):
    rng = random.Random(seed)
    base = AutoDoc(actor=_actor(1))
    lst = base.put_object("_root", "list", ObjType.LIST)
    base.put("_root", "n", ScalarValue("counter", 0))
    base.put("_root", "big", ScalarValue("counter", 2_000_000_000))
    for i in range(3):
        base.insert(lst, i, i)
    base.commit()
    forks = [base.fork(actor=_actor(60 + i)) for i in range(5)]
    keys = ["a", "b", "c"]
    for f in forks:
        for _ in range(15):
            r = rng.random()
            if r < 0.3:
                f.put("_root", rng.choice(keys), rng.randrange(100))
            elif r < 0.5:
                f.increment("_root", "n", rng.randrange(1, 5))
            elif r < 0.75:
                f.insert(lst, rng.randrange(f.length(lst) + 1), rng.randrange(100))
            else:
                ln = f.length(lst)
                if ln:
                    f.delete(lst, rng.randrange(ln))
        # int32 wraparound of the device counter payloads
        f.increment("_root", "big", 2_000_000_000)
        f.commit()
    return forks


def _same_position_inserts():
    base = AutoDoc(actor=_actor(1))
    t = base.put_object("_root", "t", ObjType.TEXT)
    base.splice_text(t, 0, 0, "ab")
    base.commit()
    forks = [base.fork(actor=_actor(2 + i)) for i in range(4)]
    for i, f in enumerate(forks):
        f.splice_text(t, 1, 0, f"<{i}>")
        f.splice_text(t, 0, 0, f"{i}")
        f.commit()
    return forks


def _nested_objects():
    base = AutoDoc(actor=_actor(1))
    m = base.put_object("_root", "cfg", ObjType.MAP)
    items = base.put_object("_root", "items", ObjType.LIST)
    base.put(m, "title", "x")
    base.commit()
    forks = [base.fork(actor=_actor(20 + i)) for i in range(3)]
    for i, f in enumerate(forks):
        f.put(m, "title", f"t{i}")  # conflict on one key
        f.put(m, f"k{i}", i)
        sub = f.insert_object(items, 0, ObjType.MAP)
        f.put(sub, "v", i)
        txt = f.put_object(sub, "note", ObjType.TEXT)
        f.splice_text(txt, 0, 0, f"note {i}")
        f.put("_root", "k", ScalarValue("counter", i))
        f.increment("_root", "k", 10 * i)
        f.commit()
    return forks


_BUILDERS = {
    "text_4x20": lambda: _text_fuzz(4, 20, 0),
    "text_8x40": lambda: _text_fuzz(8, 40, 1),
    "mixed_0": lambda: _mixed_fuzz(0),
    "mixed_7": lambda: _mixed_fuzz(7),
    "same_position": _same_position_inserts,
    "nested": _nested_objects,
}
# (builder, covered mask): "partial" drops a seeded third of the ops from
# the read clock, gating their pred edges and visibility
CASES = [(name, "all") for name in _BUILDERS] + [
    ("mixed_0", "partial"), ("text_8x40", "partial"),
]
CASE_IDS = [f"{b}-{cov}" for b, cov in CASES]


@functools.lru_cache(maxsize=None)
def _case(builder, covered):
    log = OpLog.from_documents(_BUILDERS[builder]())
    cov = None
    if covered == "partial":
        cov = np.random.default_rng(3).random(log.n) > 0.33
    cols = log.padded_columns(covered=cov)
    return log.n_objs, len(log.props), cols


def _jax_cols(cols):
    return {k: jnp.asarray(v) for k, v in cols.items()}


def _eq(jax_value, torch_value):
    a = np.asarray(jax_value)
    b = torch_value.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(params=CASES, ids=CASE_IDS)
def case(request):
    n_objs, n_props, cols = _case(*request.param)
    return n_objs, n_props, cols, columns_from_numpy(cols, "cpu")


def test_succ_resolution_and_visibility(case):
    _, _, cols, c = case
    jc = _jax_cols(cols)
    js, ji, jcinc = J.succ_resolution(jc)
    jvis = J.visibility(jc, js, ji)
    ts, ti, tcinc, tvis = SV.succ_vis(
        c["action"], c["value_tag"], c["value_i32"], c["covered"],
        c["pred_src"], c["pred_tgt"],
    )
    for a, b in ((js, ts), (ji, ti), (jcinc, tcinc), (jvis, tvis)):
        _eq(a, b)
    _eq(J.visibility(jc, js, ji), SV.visibility_plain(
        c["action"], c["value_tag"], c["covered"], ts, ti))


def _succ(c):
    return SV.succ_vis(c["action"], c["value_tag"], c["value_i32"],
                       c["covered"], c["pred_src"], c["pred_tgt"])


def test_resolve_state_scatter(case):
    n_objs, n_props, cols, c = case
    n_objs2, np_eff = M.scatter_geom_key(n_objs, n_props)
    assert (n_objs2, np_eff) == J.scatter_geom_key(n_objs, n_props)
    P = cols["action"].shape[0]
    assert M.scatter_geometry_ok(P, n_objs, n_props) == J.scatter_geometry_ok(
        P, n_objs, n_props)
    jc = _jax_cols(cols)
    ref = J.resolve_state_scatter(jc, *J.succ_resolution(jc), n_objs2, np_eff)
    visible = _succ(c)[3]
    got = SW.scatter_winners(c["action"], c["insert"], c["elem_ref"],
                             c["obj_dense"], c["prop"], c["width"], visible,
                             n_objs2, np_eff)
    names = ("winner", "conflicts", "obj_vis_len", "obj_text_width")
    for name, t in zip(names, got):
        _eq(ref[name], t)


def test_resolve_state_sorted(case):
    """The sort-based winners (the merge beyond the scatter gate)."""
    _, _, cols, c = case
    jc = _jax_cols(cols)
    ref = J.resolve_state(jc, *J.succ_resolution(jc))
    got = SO.sort_winners(c["action"], c["insert"], c["elem_ref"],
                          c["obj_dense"], c["prop"], c["width"], _succ(c)[3])
    names = ("winner", "conflicts", "obj_vis_len", "obj_text_width")
    for name, t in zip(names, got):
        _eq(ref[name], t)


def test_forest(case):
    _, _, cols, c = case
    ref = J.forest(_jax_cols(cols))
    got = F.forest(c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
    for a, b in zip(ref, got):
        _eq(a, b)
    N = 2 * cols["action"].shape[0] + 3
    assert got[2].shape == (N,) and got[3].shape == (N,)
    assert int(got[3][N - 1]) == -1  # sentinel never links


def test_device_linearize(case):
    _, _, cols, c = case
    jc = _jax_cols(cols)
    core = J.resolve_state(jc, *J.succ_resolution(jc))
    ref = J.device_linearize(jc, core)
    is_elem, _, first_child, next_sib = F.forest(
        c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
    got = L.linearize(first_child, next_sib, is_elem, c["elem_ref"], c["obj_dense"])
    _eq(ref, got)


def test_merge_kernel_matches_reference(case):
    n_objs, n_props, cols, c = case
    ref = J.merge_kernel(_jax_cols(cols))
    got = M.merge_kernel(c, n_objs, n_props)
    assert set(got) == set(M.ALL_OUTPUTS) == set(J.ALL_OUTPUTS)
    for k in M.ALL_OUTPUTS:
        _eq(ref[k], got[k])


def test_merge_kernel_beyond_scatter_gate_uses_sorted_winners(case):
    """A group table too large for the scatter gate routes the CPU path
    to the sort-based winners; the outputs stay the reference's."""
    n_objs, n_props, cols, c = case
    P = cols["action"].shape[0]
    huge = 1 << 20
    assert not M.scatter_geometry_ok(P, n_objs, huge)
    ref = J.merge_kernel(_jax_cols(cols))
    got = M.merge_kernel(c, n_objs, huge)
    for k in M.ALL_OUTPUTS:
        _eq(ref[k], got[k])


def _digit_order(keys, digits):
    """Python's stable sort by the named 8-bit digits of each key with bit
    63 flipped, most significant digit first."""
    def key(k):
        u = (k % (1 << 64)) ^ (1 << 63)
        return tuple((u >> (8 * d)) & 0xFF for d in reversed(digits))
    return sorted(keys, key=key)


@pytest.mark.parametrize("digits", [RS.DIGITS, (0,), (2, 5), (0, 1, 2, 4, 5, 6), (7,)])
def test_radix_sort_plain_on_cpu(digits):
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, 1000))
    keys[::7] = keys[3]
    got = RS.radix_sort(keys, digits)
    assert got.tolist() == _digit_order(keys.tolist(), digits)
    if digits == RS.DIGITS:
        assert torch.equal(got, torch.sort(keys).values)


def test_radix_sort_plain_equals_torch_sort_where_other_digits_are_constant():
    """The forest's contract: digits left out hold one value in every key."""
    rng = np.random.default_rng(6)
    for P in (1, 2, 300, 70_000):
        is_elem = torch.from_numpy(rng.random(P) < 0.6)
        parent = torch.from_numpy(rng.integers(0, 2 * P + 3, P).astype(np.int32))
        keys = F.sibling_keys(is_elem, parent)
        assert torch.equal(RS.radix_sort(keys, F.sibling_digits(P)),
                           torch.sort(keys).values)


def test_radix_sort_rejects_bad_digits():
    keys = torch.arange(5, dtype=torch.int64)
    for digits in ((), (3, 1), (1, 1), (8,), (-1,)):
        with pytest.raises(ValueError, match="digits"):
            RS.radix_sort(keys, digits)


def test_sibling_key_order_is_parent_then_descending_row():
    is_elem = torch.tensor([True, True, False, True])
    parent = torch.tensor([5, 5, 11, 4], dtype=torch.int32)
    order = RS.radix_sort(F.sibling_keys(is_elem, parent), F.sibling_digits(4))
    rows = (4 - 1 - (order & 0xFFFFFFFF)).tolist()
    assert rows == [3, 1, 0, 2]  # parent 4; parent 5 rows 1, 0; non-element last


def _varying_digits(P):
    """The digits in which two possible sibling keys of a P-row merge
    differ: every low word P-1-row in [0, P) and every parent in [0, N]."""
    N = 2 * P + 3
    lows, highs = range(P), range(N + 1)
    out = []
    for d in range(8):
        if d < 4:
            vals = {(v >> (8 * d)) & 0xFF for v in lows}
        else:
            vals = {(((v << 32) ^ (1 << 63)) >> (8 * d)) & 0xFF for v in highs}
        if len(vals) > 1:
            out.append(d)
    return tuple(out)


@pytest.mark.parametrize("P", [1, 2, 3, 126, 127, 128, 129, 255, 256, 257, 700])
def test_sibling_digits_are_the_digits_that_vary(P):
    assert F.sibling_digits(P) == _varying_digits(P)


def test_sibling_digits_at_large_p():
    """Past a brute force: the top sorted digit of each word holds that
    word's largest value's top bits, the next one up holds nothing."""
    for P in (516_096, 851_968, (1 << 20) + 12_345, (1 << 23) + 1, (1 << 29) - 1):
        digits = F.sibling_digits(P)
        low = [d for d in digits if d < 4]
        high = [d - 4 for d in digits if d >= 4]
        for top, word in ((low, P - 1), (high, 2 * P + 3)):
            assert top == list(range(len(top)))
            assert word >> (8 * len(top)) == 0 and word >> (8 * (len(top) - 1)) > 0
    assert F.sibling_digits(516_096) == F.sibling_digits(851_968) == (0, 1, 2, 4, 5, 6)


@pytest.mark.parametrize("P", [0, 1, 2, 3, 1000, 4096, 851_968, 1_060_921, (1 << 29) - 1])
def test_table_capacity_is_the_least_power_of_two_at_twice_the_rows(P):
    C = SO.table_capacity(P)
    assert C & (C - 1) == 0
    assert 2 * max(P, 1) <= C < 4 * max(P, 1)


def test_scratch_words_hold_counts_counters_and_look_back():
    for n in (0, 1, 4095, 4096, 4097, 516_096):
        for digits in (RS.DIGITS, (0, 1, 2, 4, 5, 6), (3,)):
            tiles = -(-n // RS.TILE)
            assert RS.scratch_words(n, digits) == 8 * 256 + 8 + len(digits) * tiles * 256
    assert RS.digit_mask(RS.DIGITS) == 0xFF
    assert RS.digit_mask((0, 1, 2, 4, 5, 6)) == 0b0111_0111


def test_smoke_bound_counts_only_the_bytes_the_function_reads(case):
    """chip_smoke's bound reads each per-row column in full and a gathered
    input only at the distinct indices these inputs reach."""
    import chip_smoke

    _, _, _, c = case
    P, Q = c["action"].numel(), c["pred_src"].numel()
    sv_in = (c["action"], c["value_tag"], c["value_i32"], c["covered"],
             c["pred_src"], c["pred_tgt"])
    src = c["pred_src"].long()
    tgt = c["pred_tgt"].long()
    inc = (tgt >= 0) & (tgt < P) & c["covered"][src] & (c["action"][src] == 5)
    n_inc_src = len(set(src[inc].tolist()))
    n_inc_tgt = len(set(tgt[inc].tolist()))
    moved, _ = chip_smoke.work("succ_vis", sv_in, SV.succ_vis(*sv_in))
    # value_i32 at the increments' sources, value_tag at their targets
    assert moved == 8 * Q + 5 * P + 4 * (n_inc_src + n_inc_tgt) + 13 * P

    is_elem, _, first_child, next_sib = F.forest(
        c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
    li_in = (first_child, next_sib, is_elem, c["elem_ref"], c["obj_dense"])
    n_roots = len(set(c["obj_dense"][is_elem].tolist()))
    moved, _ = chip_smoke.work("linearize", li_in, (L.linearize(*li_in),))
    assert moved == 17 * P + 4 * n_roots + 4 * P


def test_smoke_bound_of_sort_winners_reads_width_only_at_winners(case):
    """The winner kernels read their six per-row columns in full, width
    only at the distinct winners of visible elements, and write winner,
    conflicts and the two per-object stats once."""
    import chip_smoke

    _, _, _, c = case
    P = c["action"].numel()
    args = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"], c["prop"],
            c["width"], _succ(c)[3])
    out = SO.sort_winners(*args)
    elem_vis = c["insert"] & (c["action"] != 15) & (out[0] >= 0)
    n_winners = len(set(out[0][elem_vis].tolist()))
    moved, ops = chip_smoke.work("sort_winners", args, out)
    assert moved == 18 * P + 4 * n_winners + 8 * P + 8 * (P + 2)
    assert ops == 10 * P


def test_cpu_wrappers_take_plain_path_and_count_no_launch(case):
    n_objs, n_props, _, c = case
    reset_launches()
    M.merge_kernel(c, n_objs, n_props)
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)


@pytest.mark.parametrize(
    "mutate, error",
    [
        (lambda c: {**c, "action": c["action"].long()}, TypeError),
        (lambda c: {**c, "covered": c["covered"].int()}, TypeError),
        (lambda c: {**c, "value_tag": c["value_tag"][:-1]}, ValueError),
        (lambda c: {**c, "pred_tgt": c["pred_tgt"][:-1]}, ValueError),
        (lambda c: {**c, "value_i32": torch.stack(
            [c["value_i32"], c["value_i32"]], 1)[:, 0]}, ValueError),
        (lambda c: {**c, "action": c["action"].numpy()}, TypeError),
    ],
    ids=["dtype", "bool-dtype", "shape", "edge-shape", "strided", "not-tensor"],
)
def test_wrapper_rejects_bad_arguments(mutate, error):
    _, _, cols = _case("mixed_0", "all")
    c = mutate(columns_from_numpy(cols, "cpu"))
    with pytest.raises(error):
        SV.succ_vis(c["action"], c["value_tag"], c["value_i32"], c["covered"],
                    c["pred_src"], c["pred_tgt"])


def test_wrapper_rejects_mixed_devices():
    _, _, cols = _case("mixed_0", "all")
    c = columns_from_numpy(cols, "cpu")
    with pytest.raises(ValueError, match="different devices"):
        F.forest(c["action"], c["insert"].to("meta"), c["elem_ref"], c["obj_dense"])
