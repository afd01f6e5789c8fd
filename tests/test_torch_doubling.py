"""The sharded merge's doubling loops (K11's ``_thread`` / ``_rank``,
``automerge_tpu/parallel/sharding.py:218,238``) on the CPU: the rounds
entries ``linearize_thread_rounds`` / ``linearize_rank_rounds`` (a whole
loop in one call, where every shard sits on one device) and the
per-round exchange over distinct devices (``sharding._exchange``, here
on a mesh of distinct CPU devices) against the reference's loop body
chained round by round (``linearize_thread_plain`` /
``linearize_rank_plain`` over [0, E)), bit for bit on every output, with
links out of range; and the row arm's rank loop started from the thread
loop's answers (``linearize_rank_from_thread``, its first round
``linearize_rank_first``, ``sharding.rank_from_thread``) against the
reference's rank init (``linearize_rank_init_plain``) then the chained
rounds."""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.kernels import linearize as L
from automerge_tpu_torch.parallel import Mesh
from automerge_tpu_torch.parallel import collectives as C
from automerge_tpu_torch.parallel import sharding as PS

SIZES = [1, 2, 5, 4097]


def _rounds(E):
    return sorted({1, 2, L.ceil_log2(E) + 1})


def _links(rng, E):
    """Links in [-1, E + 5]: every out-of-range value the loops clamp
    (-1, E, E + 5) among in-range ones."""
    out = rng.integers(-1, E + 6, E).astype(np.int32)
    special = np.array([-1, E, E + 5], np.int32)
    k = min(E, 3)
    out[rng.choice(E, k, replace=False)] = special[:k]
    return torch.from_numpy(out)


def _thread_state(E, seed):
    rng = np.random.default_rng(seed)
    ans = _links(rng, E)
    done = torch.from_numpy(rng.random(E) < 0.4)
    return ans, done, _links(rng, E)


def _rank_state(E, seed):
    rng = np.random.default_rng(seed)
    dist = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, E, dtype=np.int64)
                            .astype(np.int32))
    return dist, _links(rng, E)


def _chained(plain, state, rounds):
    E = state[0].shape[0]
    for _ in range(rounds):
        state = plain(*state, 0, E)
    return state


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


LOOPS = {
    "thread": (_thread_state, L.linearize_thread_rounds, L.linearize_thread_plain,
               PS.THREAD),
    "rank": (_rank_state, L.linearize_rank_rounds, L.linearize_rank_plain, PS.RANK),
}


@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("E", SIZES)
def test_rounds_entry_equals_the_chained_rounds(loop, E):
    make, rounds_fn, plain, _ = LOOPS[loop]
    state = make(E, E)
    before = tuple(t.clone() for t in state)
    for rounds in _rounds(E):
        _same(rounds_fn(*state, rounds), _chained(plain, state, rounds))
        _same(state, before)  # the inputs are never written


def test_rounds_entries_refuse_no_rounds_and_too_many_nodes():
    ans, done, jump = _thread_state(5, 0)
    with pytest.raises(ValueError):
        L.linearize_thread_rounds(ans, done, jump, 0)
    with pytest.raises(ValueError):
        L.linearize_rank_rounds(ans, jump, -1)
    with pytest.raises(ValueError):
        L._check_rounds(L.MAX_ROUNDS_NODES, 3)
    L._check_rounds(L.MAX_ROUNDS_NODES - 1, 3)


@pytest.mark.parametrize("rounds,words", [(1, 0), (2, 4 * 7), (3, 8 * 7), (20, 8 * 7)])
def test_record_words_hold_the_ping_pong_pair(rounds, words):
    assert L.record_words(4, 7, rounds) == words
    assert L.record_words(2, 7, rounds) == words // 2


def _mesh(E):
    """A mesh whose size divides E, over distinct CPU devices: runs of
    consecutive shards on one device and devices that come back."""
    n = {1: 1, 2: 2, 5: 5, 4097: 17}[E]
    pattern = ["cpu:0", "cpu:1", "cpu:1", "cpu:0", "cpu:2"]
    return Mesh([pattern[i % len(pattern)] for i in range(n)]), E // n


@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("E", SIZES)
def test_exchange_over_distinct_devices_equals_the_chained_rounds(loop, E):
    make, _, plain, pair = LOOPS[loop]
    mesh, length = _mesh(E)
    state = make(E, E + 1)
    before = tuple(t.clone() for t in state)
    for rounds in _rounds(E):
        rep = tuple({d: t.clone() for d in mesh.distinct} for t in state)
        C.reset_stats()
        got = PS._exchange(mesh, pair[0], rep, length, rounds)
        want = _chained(plain, state, rounds)
        for d in mesh.distinct:
            _same(tuple(g[d] for g in got), want)
        _same(state, before)
        # one all_gather per array per round, in the reference's terms;
        # each device copies in only the slices of the other devices
        sizes = [t.element_size() for t in state]
        n_dev = len(mesh.distinct)
        assert C.gathers == [(length, n_dev * mesh.size * length * s)
                             for _ in range(rounds) for s in sizes]
        copied = rounds * sum(sizes) * length * (n_dev - 1) * mesh.size
        assert C.stats["all_gather"]["copied"] == copied


def test_exchange_on_one_device_launches_a_run_a_round_and_copies_nothing():
    mesh = Mesh(["cpu"] * 4)
    assert mesh.runs == ((torch.device("cpu"), 0, 4),)
    state = _rank_state(40, 2)
    calls = []

    def step(*args, out):
        calls.append(args[-2:])
        return L.linearize_rank(*args, out=out)

    C.reset_stats()
    got = PS._exchange(mesh, step, tuple({mesh.distinct[0]: t} for t in state), 10, 3)
    _same(tuple(g[mesh.distinct[0]] for g in got),
          _chained(L.linearize_rank_plain, state, 3))
    assert calls == [(0, 40)] * 3
    assert C.stats["all_gather"] == {"calls": 6, "bytes": 6 * 40 * 4, "copied": 0}


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_doubling_takes_the_rounds_entry_on_one_device(loop):
    """``_doubling`` runs a loop through its rounds entry, once, where
    every shard sits on one device, and through the exchange over
    distinct devices; the gathers it records are the same."""
    make, rounds_fn, plain, pair = LOOPS[loop]
    state = make(24, 7)
    calls = []

    def spy(*args):
        calls.append(args[-1])
        return rounds_fn(*args)

    gathers = {}
    for devices in (["cpu"] * 4, ["cpu:0", "cpu:1", "cpu:0", "cpu:1"]):
        mesh = Mesh(devices)
        rep = tuple({d: t for d in mesh.distinct} for t in state)
        C.reset_stats()
        got = PS._doubling(mesh, (pair[0], spy), rep, 6, 5)
        for d in mesh.distinct:
            _same(tuple(g[d] for g in got), _chained(plain, state, 5))
        gathers[len(mesh.distinct)] = [n for n, _ in C.gathers]
    assert calls == [5]
    assert gathers[1] == gathers[2] == [6] * 5 * len(state)


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_range_kernel_writes_into_out(loop):
    make, _, plain, pair = LOOPS[loop]
    state = make(30, 3)
    buf = tuple(torch.full_like(t, 7) for t in state)
    fill = tuple(b.clone() for b in buf)
    got = pair[0](*state, 10, 12, out=tuple(b[10:22] for b in buf))
    want = plain(*state, 10, 12)
    _same(got, want)
    for b, f, w in zip(buf, fill, want):
        assert torch.equal(b[10:22], w)
        assert torch.equal(b[:10], f[:10]) and torch.equal(b[22:], f[22:])
    with pytest.raises(ValueError):
        pair[0](*state, 10, 12, out=tuple(b[10:21] for b in buf))


# -- the row arm's rank loop started from the thread loop's answers ----------


def _answers(E, P, seed):
    """The thread loop's (fc_e, ans) over E nodes of P rows: about half
    the first children -1 (the node takes its answer), -1 answers, links
    out of range, and the nodes past P (the sentinel, padding) holding
    values as well, which the rank state ignores."""
    rng = np.random.default_rng(seed)
    fc_e = _links(rng, E)
    fc_e[torch.from_numpy(rng.random(E) < 0.5)] = -1
    return fc_e, _links(rng, E)


# (E, P): the sentinel alone past the rows, padding nodes past it, no rows
STARTS = [(1, 0), (2, 1), (5, 2), (9, 8), (4097, 4000), (4097, 1)]


@pytest.mark.parametrize("E,P", STARTS)
def test_rank_from_thread_equals_init_then_chained_rounds(E, P):
    fc_e, ans = _answers(E, P, E + P)
    before = (fc_e.clone(), ans.clone())
    init = L.linearize_rank_init_plain(fc_e, ans, P)
    for rounds in _rounds(E):
        _same(L.linearize_rank_from_thread(fc_e, ans, P, rounds),
              _chained(L.linearize_rank_plain, init, rounds))
        _same((fc_e, ans), before)  # the answers are never written


@pytest.mark.parametrize("E,P", STARTS)
def test_rank_first_round_equals_init_then_one_round(E, P):
    fc_e, ans = _answers(E, P, 3 * E + P)
    init = L.linearize_rank_init_plain(fc_e, ans, P)
    for i0, count in ((0, E), (E // 3, E - E // 3), (E - 1, 1), (E // 2, 0)):
        _same(L.linearize_rank_first(fc_e, ans, P, i0, count),
              L.linearize_rank_plain(*init, i0, count))
    buf = tuple(torch.full((E,), 7, dtype=torch.int32) for _ in range(2))
    i0, count = E // 3, E - E // 3
    got = L.linearize_rank_first(fc_e, ans, P, i0, count,
                                 out=tuple(b[i0:] for b in buf))
    for b, g, w in zip(buf, got, L.linearize_rank_plain(*init, i0, count)):
        assert torch.equal(g, w) and torch.equal(b[i0:], w)
        assert torch.equal(b[:i0], torch.full((i0,), 7, dtype=torch.int32))


def test_rank_from_thread_refuses_too_few_nodes():
    fc_e, ans = _answers(5, 4, 0)
    for P in (5, 6, -1):
        with pytest.raises(ValueError):
            L.linearize_rank_from_thread(fc_e, ans, P, 3)
        with pytest.raises(ValueError):
            L.linearize_rank_first(fc_e, ans, P, 0, 5)
    with pytest.raises(ValueError):
        L.linearize_rank_from_thread(fc_e, ans, 4, 0)
    with pytest.raises(TypeError):
        L.linearize_rank_from_thread(fc_e.long(), ans, 4, 3)


@pytest.mark.parametrize("devices", [["cpu:0", "cpu:1"], ["cpu"] * 2,
                                     ["cpu:0", "cpu:1", "cpu:1", "cpu:0"]])
@pytest.mark.parametrize("E,P", [(8, 5), (4100, 4000)])
def test_rank_loop_from_thread_over_a_mesh_equals_init_then_chained_rounds(
        devices, E, P):
    """``_doubling`` with ``rank_from_thread``: over distinct devices the
    exchange's first round reads the answers, the later rounds the state;
    over one device repeated, the rounds entry. Both equal the reference's
    init and chained rounds, and record the rank loop's gathers."""
    mesh = Mesh(devices)
    length = E // mesh.size
    fc_e, ans = _answers(E, P, E)
    want = _chained(L.linearize_rank_plain, L.linearize_rank_init_plain(fc_e, ans, P),
                    L.ceil_log2(E) + 1)
    rep = tuple({d: t.clone() for d in mesh.distinct} for t in (fc_e, ans))
    C.reset_stats()
    reset = {k: getattr(L, k).launches for k in ("linearize_rank_first",
                                                   "linearize_rank_from_thread")}
    rounds = L.ceil_log2(E) + 1
    got = PS._doubling(mesh, PS.rank_from_thread(P), rep, length, rounds)
    for d in mesh.distinct:
        _same(tuple(g[d] for g in got), want)
        _same((rep[0][d], rep[1][d]), (fc_e, ans))
    assert [n for n, _ in C.gathers] == [length] * 2 * rounds
    assert reset == {k: getattr(L, k).launches for k in reset}  # CPU: no launch
