"""emit_packed's plan and its CUDA design on the CPU.

The plan (``emit_packed.plan``: kinds, offsets, block starts, flat
length) against the arithmetic of the flat vector's layout
(``_emit``'s concatenation: ceil(n/32) words a bit output, n values any
other, the stats cut to obj_cap), the wrapper's checks, and a model of the kernel's
work split (``csrc/emit_packed.cu``: a block's segment from the block
starts, a word a thread of a bit output, a head and 16-byte chunks of a
copied one at every alignment of the flat vector and the sources)
against ``emit_packed_plain``: every value written once, and equal."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from automerge_tpu_torch.kernels import emit_packed as EP

THREADS = EP.THREADS


def _core(P, seed, n_stats=None):
    rng = np.random.default_rng(seed)
    n_stats = P + 2 if n_stats is None else n_stats
    return {
        "visible": torch.from_numpy(rng.random(P) < 0.5),
        "conflicts": torch.from_numpy(rng.integers(-2, 4, P).astype(np.int32)),
        "winner": torch.from_numpy(rng.integers(-1, P, P).astype(np.int32)),
        "is_elem": torch.from_numpy(rng.random(P) < 0.3),
        "next_sib": torch.from_numpy(rng.integers(-1, P, 2 * P + 3).astype(np.int32)),
        "elem_index": torch.from_numpy(rng.integers(-1, P, P).astype(np.int32)),
        "obj_vis_len": torch.from_numpy(rng.integers(0, 9, n_stats).astype(np.int32)),
        "obj_text_width": torch.from_numpy(rng.integers(0, 9, n_stats).astype(np.int32)),
    }


def _srcs(core, fetch):
    return [core[k] for k in fetch]


def _fields(p):
    """The plan's segments (kind, threshold, rows, offset in the vector,
    first block, five ints each in ``meta``) and the grid's blocks."""
    m = list(p.meta)
    return SimpleNamespace(kinds=m[0:-1:5], threshs=m[1:-1:5], rows=m[2:-1:5],
                           offsets=m[3:-1:5], block_starts=m[4:-1:5], blocks=m[-1])


def _threads(kind, n):
    """A thread's work in ``emit_threads`` (csrc/emit_packed.cu): a word
    of a bit output; four values of a copied one, one more thread for
    the values before its first aligned word."""
    if kind < 2:
        return (n + 31) // 32
    return 0 if n == 0 else (n + 3) // 4 + 1


def _layout(core, fetch, obj_cap):
    """Each segment's length in the flat vector and the vector's length,
    as the concatenation of ``_emit`` lays them out."""
    lens = []
    for k in fetch:
        n = core[k].numel()
        if k in EP.OBJ_STATS:
            n = min(n, obj_cap)
        lens.append((n + 31) // 32 if k in EP.BIT_OUTPUTS else n)
    return lens, sum(lens)


FETCHES = [
    ("visible", "winner", "conflicts", "elem_index", "obj_vis_len", "obj_text_width"),
    ("visible", "winner", "conflicts", "is_elem", "next_sib", "obj_vis_len"),
    ("obj_text_width", "conflicts"),
    ("is_elem",),
    ("visible", "conflicts") * 8,  # the 16-output limit
]


@pytest.mark.parametrize("fetch", FETCHES)
@pytest.mark.parametrize("P,obj_cap", [(1, 3), (31, 18), (33, 7), (1000, 1024),
                                       (4096, 5000), (24_577, 40)])
def test_plan_matches_the_flat_layout(fetch, P, obj_cap):
    core = _core(P, P)
    p = EP.plan(fetch, obj_cap, _srcs(core, fetch))
    lens, flat = _layout(core, fetch, obj_cap)
    assert p.flat_length == flat == EP.emit_packed_plain(core, fetch, obj_cap).numel()
    f = _fields(p)
    assert len(p.meta) == 5 * len(fetch) + 1
    assert f.offsets == [sum(lens[:i]) for i in range(len(lens))]
    assert f.threshs == [1 if k == "conflicts" else 0 for k in fetch]
    # each segment its own blocks, enough for a word or a chunk a thread
    starts = f.block_starts + [f.blocks]
    for i, (kind, n) in enumerate(zip(f.kinds, f.rows)):
        blocks = starts[i + 1] - starts[i]
        assert blocks == -(-_threads(kind, n) // THREADS)
        assert blocks * THREADS >= ((n + 31) // 32 if kind < 2 else (n + 3) // 4 + 1)


def test_emit_packed_checks_each_output():
    """The wrapper refuses on the CPU what the kernel's plan would: a
    strided output, a wrong type, no outputs or more than 16; the plan
    refuses the same types and counts."""
    core = _core(64, 2)
    fetch = FETCHES[0]
    assert torch.equal(EP.emit_packed(core, fetch, 18),
                       EP.emit_packed_plain(core, fetch, 18))
    strided = dict(core, winner=torch.zeros(128, dtype=torch.int32)[::2])
    with pytest.raises(ValueError):
        EP.emit_packed(strided, fetch, 18)
    bools = dict(core, conflicts=core["conflicts"] > 1)
    for bad in (dict(core, visible=core["visible"].int()), bools):
        with pytest.raises(TypeError):
            EP.emit_packed(bad, fetch, 18)
        with pytest.raises(TypeError):
            EP.plan(fetch, 18, _srcs(bad, fetch))
    for count in (0, 17):
        with pytest.raises(ValueError):
            EP.emit_packed(core, ("visible",) * count, 18)
        with pytest.raises(ValueError):
            EP.plan(("visible",) * count, 18, _srcs(core, ("visible",) * count))


def _chunks_hold_own_rows(first, count, src_words):
    """The aligned 16-byte chunks ``emit_ints`` reads for ``count`` int32
    rows from ``first`` of a source ``src_words`` int32s past a 16-byte
    boundary each hold one of those rows (so they lie in the source's
    allocation)."""
    M = (src_words + first) % 4
    for k in range((M + count + 3) // 4):
        lo = first - M + 4 * k
        assert lo < first + count and lo + 4 > first, (first, count, M, k)


def _model(core, fetch, obj_cap, out_words, src_bytes):
    """The kernel's work split run thread by thread: the flat vector
    starting ``out_words`` int32s past a 16-byte boundary, each source
    ``src_bytes`` bytes past one (an int32 source at the multiple of 4
    below), as ``amt_emit_packed`` reads the alignment off the pointers.
    Returns the vector and each value's writes."""
    p = EP.plan(fetch, obj_cap, _srcs(core, fetch))
    out = np.zeros(p.flat_length, np.int64)
    writes = np.zeros(p.flat_length, np.int64)
    f = _fields(p)
    srcs = [core[k].reshape(-1)[:n].numpy() for k, n in zip(fetch, f.rows)]
    starts = f.block_starts
    for b in range(f.blocks):
        s = sum(1 for k in range(1, len(fetch)) if b >= starts[k])
        kind, thresh, n, out0 = f.kinds[s], f.threshs[s], f.rows[s], f.offsets[s]
        src = srcs[s].astype(np.int64)
        bits = src if kind == 0 else (src > thresh)
        for t in range((b - starts[s]) * THREADS, (b - starts[s] + 1) * THREADS):
            if kind <= 1:  # a word of 32 rows
                if t >= (n + 31) // 32:
                    continue
                if kind == 1 and 32 * t + 32 <= n:
                    _chunks_hold_own_rows(32 * t, 32, src_bytes // 4)
                rows = bits[32 * t:32 * t + 32].astype(np.int64)
                out[out0 + t] = int((rows << np.arange(len(rows))).sum())
                writes[out0 + t] += 1
                continue
            head = min(n, (-(out_words + out0)) % 4)
            if n == 0 or t > (n - head + 3) // 4:
                continue
            w0 = 0 if t == 0 else head + 4 * (t - 1)
            w1 = head if t == 0 else min(w0 + 4, n)
            if t > 0 and w1 - w0 == 4:
                # the 16-byte store lands on an aligned word of the vector
                assert (out_words + out0 + w0) % 4 == 0
                if kind == 2:
                    _chunks_hold_own_rows(w0, 4, src_bytes // 4)
            out[out0 + w0:out0 + w1] = src[w0:w1]
            writes[out0 + w0:out0 + w1] += 1
    words = out.astype(np.uint32).view(np.int32) if len(out) else out.astype(np.int32)
    return torch.from_numpy(words.astype(np.int32)), writes


@pytest.mark.parametrize("fetch", FETCHES[:2] + FETCHES[3:4])
@pytest.mark.parametrize("P", [1, 5, 31, 33, 1000, 1027])
@pytest.mark.parametrize("out_words,src_bytes", [(0, 0), (1, 4), (2, 8), (3, 12), (2, 1)])
def test_kernel_model_writes_each_value_once(fetch, P, out_words, src_bytes):
    core = _core(P, 7 * P + out_words, n_stats=P + 2 if P != 31 else 5)
    obj_cap = 18
    got, writes = _model(core, fetch, obj_cap, out_words, src_bytes)
    assert (writes == 1).all()
    assert torch.equal(got, EP.emit_packed_plain(core, fetch, obj_cap))
