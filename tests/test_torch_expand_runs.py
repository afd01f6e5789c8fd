"""The run decode's tiled design (``kernels/expand_runs.py``
``expand_runs_tiled_model``: per tile of rows, a 32-way warp search for
its first and last runs, the runs staged, a search and a forward walk per
thread of consecutive rows) against the JAX package's ``_expander``,
exactly, on the CPU.

The stacks are those of ``test_torch_staging.py``, synthetic edge shapes
(one run covering every row, every row its own run, rcap far above n, n
not a multiple of the tile, K = 32, run ends on tile boundaries, repeated
run ends) and the run-native and eager stagings' stacks of the seeded
random documents of ``test_torch_random_docs.py``. Each is decoded with
the kernel's tiling and with small tiles, so that small stacks span
many.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from automerge_tpu.ops import OpLog as JOpLog
from automerge_tpu.ops import merge as J
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu_torch.kernels import expand_runs as E
from automerge_tpu_torch.ops.merge import _encode_columns, _stack

from .test_torch_random_docs import _history
from .test_torch_staging import _stack as _random_stack

# (rows a tile, rows a thread): the kernel's (``tile_rows``), the largest
# and smallest it picks, then small
TILINGS = [(None, E.ROWS), (4096, E.ROWS), (1024, E.ROWS), (64, 16), (12, 4)]


def _check(W, C, S, n, bools, tilings=TILINGS):
    K, rcap = W.shape
    want = J._expander(n, rcap, tuple(bools))(
        jnp.asarray(W), jnp.asarray(C),
        jnp.asarray(S) if S is not None else jnp.zeros(K, jnp.int32))
    for tile, rows in tilings:
        got = E.expand_runs_tiled_model(W, C, S, n, bools, tile, rows)
        assert len(got) == K
        for k, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{tile} {k}")


@pytest.mark.parametrize("n,rcap,wrap", [
    (32, 16, False), (1000, 16, True), (4096, 64, True), (4099, 256, False),
], ids=["n32", "n1000_wrap", "n4096_wrap", "n4099"])
@pytest.mark.parametrize("delta", [True, False], ids=["delta", "rle"])
def test_staging_test_stacks(n, rcap, wrap, delta):
    W, C, S = _random_stack(np.random.default_rng(n), 6, n, rcap, wrap)
    _check(W, C, S if delta else None, n, (False, True, False, True, False, False))


def _table(ends, n, rcap, K=1, seed=0):
    """K columns sharing the run ends ``ends`` (the last real one n),
    padded with n to rcap; values and slopes over the whole int32 range."""
    rng = np.random.default_rng(seed)
    C = np.full((K, rcap), n, np.int32)
    C[:, : len(ends)] = ends
    W = rng.integers(-(1 << 31), 1 << 31, (K, rcap), dtype=np.int64).astype(np.int32)
    S = rng.integers(-(1 << 31), 1 << 31, K, dtype=np.int64).astype(np.int32)
    return W, C, S


def _shape(name):
    """(ends, n, rcap, K) of one edge shape."""
    T = 4096
    if name == "one run, rcap 1":
        return [5000], 5000, 1, 3
    if name == "one run, padded":
        return [5000], 5000, 16, 3
    if name == "every row a run":
        return np.arange(1, 4100), 4099, 4099, 2
    if name == "rcap far above n":
        return np.arange(3, 101, 3).tolist() + [100], 100, 8192, 2
    if name == "n one":
        return [1], 1, 16, 2
    if name == "n not a tile multiple":
        return np.arange(7, 3 * T + 5, 7).tolist() + [3 * T + 5], 3 * T + 5, 2048, 2
    if name == "K 32":
        return np.arange(11, 6000, 11).tolist() + [6000], 6000, 1024, 32
    if name == "ends on tile boundaries":
        ends = [T - 1, T, T + 1, 2 * T, 3 * T - 1, 3 * T, 64, 128, 192, 12, 24, 36]
        return sorted(set(ends)) + [3 * T + 17], 3 * T + 17, 64, 2
    raise KeyError(name)


SHAPES = ["one run, rcap 1", "one run, padded", "every row a run", "rcap far above n",
          "n one", "n not a tile multiple", "K 32", "ends on tile boundaries"]


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("delta", [True, False], ids=["delta", "rle"])
def test_edge_shapes(name, delta):
    ends, n, rcap, K = _shape(name)
    W, C, S = _table(ends, n, rcap, K, seed=len(name))
    bools = tuple(k % 3 == 1 for k in range(K))
    _check(W, C, S if delta else None, n, bools)


def test_tile_rows_fill_the_card():
    """4,096 rows a tile while the grid has two blocks an SM, halving to
    1,024 below that."""
    assert E.tile_rows(516_096, 5) == 4096
    assert E.tile_rows(851_968, 3) == 4096
    assert E.tile_rows(851_968, 1) == 2048
    assert E.tile_rows(229_376, 1) == 1024
    assert E.tile_rows(100, 2) == 1024


def test_repeated_run_ends():
    """Zero-length runs (an end repeated, as the GPU test's random stacks
    have): a row past a repeated end skips all of its copies."""
    rng = np.random.default_rng(5)
    n, rcap = 9000, 6000
    C = np.full((2, rcap), n, np.int32)
    for k in range(2):
        C[k, :5000] = np.sort(rng.integers(1, n, 5000))
    W = rng.integers(-100, 100, (2, rcap)).astype(np.int32)
    _check(W, C, None, n, (False, True))


def _staged_stacks(cols):
    """The run-native staging's stacks (rle and delta, by length) and the
    eager staging's (delta, by length, bool columns among them) of one
    log's padded columns, as (W, C, S or None, n, bools)."""
    out = []
    for run_native in (True, False):
        _, groups = _encode_columns(cols, run_native)
        for key, group in groups.items():
            n = key[0] if run_native else key
            _, W, C, S = _stack(n, group)
            rle = run_native and key[1] == "rle"
            out.append((W, C, None if rle else S, n, tuple(b for _, _, b in group)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_seeded_random_documents(seed):
    base, rest = _history(seed)
    log = JOpLog.from_changes([j_parse_change(b)[0] for b in base + rest])
    stacks = _staged_stacks({k: np.asarray(v) for k, v in log.padded_columns().items()})
    assert stacks
    for W, C, S, n, bools in stacks:
        _check(W, C, S, n, bools)
