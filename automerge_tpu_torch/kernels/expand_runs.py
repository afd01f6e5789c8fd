"""expand_runs: slope-RLE run tables decoded into dense columns, and
unpack_flags: the packed transport's flags column split into four.

``expand_runs`` replaces ``automerge_tpu/ops/merge.py`` ``_expander``
(:849, K9), the run gather inside ``run_native_kernel`` (:1015-1034, K1)
and the packed transport's ``_expand`` (:1135, K10); ``unpack_flags`` the
flags split of ``_unpack_transport`` (:1157-1162). The CUDA kernels are in
``csrc/expand_runs.cu``: an interval expand, one block per tile of
``tile_rows(n, K)`` rows of one column (a 32-way warp search for the
tile's first and last runs, the runs between staged in shared memory,
``ROWS`` consecutive rows a thread walked forward from one search,
16-byte stores), uint32 arithmetic for the slope term (XLA's int32
wraps); one thread per row for the flags. Both are bound by bytes: the
dense columns written.
``expand_runs_tiled_model`` is the tiled design step by step in numpy,
for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from ._args import expect, on_cuda, ptr, stream

_P, _I = _build.P_, _build.I_
_EXPAND_SIG = [_P, _P, _P, _I, _I, _I, ctypes.c_uint, _I, _P, _P, _P]
_FLAGS_SIG = [_P, _I, _P, _P, _P, _P, _P]

# the decode kernel's tiling
ROWS = 16  # rows a thread (csrc/expand_runs.cu ER_ROWS)
BLOCKS_WANTED = 264  # two blocks an SM, or the tiles shrink


def tile_rows(n: int, K: int) -> int:
    """Rows of the kernel's tile: 4,096 (256 threads), halved down to
    1,024 while the grid would have fewer than BLOCKS_WANTED blocks."""
    threads = 256
    while threads > 64 and -(-n // (threads * ROWS)) * K < BLOCKS_WANTED:
        threads //= 2
    return threads * ROWS


# the flags column of the packed transport (ops/merge.py _flags_column)
F_ACTION = 15
F_INSERT = 1 << 4
F_TAG_SHIFT = 5
F_COVERED = 1 << 9


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32, as XLA's int32 arithmetic wraps."""
    return ((v + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def expand_runs_plain(W, C, S, n: int, bools):
    """Plain PyTorch version: row i of column k is W[k, j] (+ S[k] * i),
    j = searchsorted(C[k], i, right) clamped to rcap - 1; the columns
    marked in ``bools`` as value != 0."""
    K, rcap = W.shape
    i = torch.arange(n, dtype=torch.int32, device=W.device)
    j = torch.searchsorted(C, i.expand(K, n).contiguous(), right=True)
    v = torch.gather(W, 1, j.clamp(0, rcap - 1)).long()
    if S is not None:
        v = v + S.long()[:, None] * i.long()
    v = _wrap_int32(v)
    return tuple(v[k] != 0 if b else v[k] for k, b in enumerate(bools))


def _warp_upper_bound(c, x: int) -> int:
    """The kernel's 32-way warp search: the first j with c[j] > x, or
    len(c)."""
    lo, hi = 0, len(c)
    while hi - lo > 32:
        span = hi - lo
        p = [lo + span * (lane + 1) // 32 - 1 for lane in range(32)]
        below = sum(int(c[q] <= x) for q in p)
        if below > 0:
            lo = p[below - 1] + 1
        if below < 32:
            hi = p[below]
    return lo + int(np.count_nonzero(c[lo:hi] <= x))


def expand_runs_tiled_model(W, C, S, n: int, bools, tile: int = None,
                            rows: int = ROWS):
    """The CUDA kernel's design step by step in numpy, for the tests: per
    column and tile of ``tile`` rows (by default the kernel's,
    ``tile_rows``), the warp searches for the first and
    last runs, the runs between them staged, and per thread of ``rows``
    consecutive rows a search for its first run and a walk forward.
    Returns what ``expand_runs_plain`` does."""
    W = np.asarray(W, np.int64)
    C = np.asarray(C, np.int64)
    K, rcap = W.shape
    tile = tile_rows(n, K) if tile is None else tile
    span = -(-n // rows) * rows  # the last thread's rows past n are cut
    out = np.zeros((K, span), np.int64)
    slope = np.zeros(K, np.int64) if S is None else np.asarray(S, np.int64)
    for k in range(K):
        for a in range(0, n, tile):
            last = min(a + tile, n) - 1
            j0 = min(_warp_upper_bound(C[k], a), rcap - 1)
            j1 = min(_warp_upper_bound(C[k], last), rcap - 1)
            cs, ws = C[k, j0:j1 + 1], W[k, j0:j1 + 1]
            m = j1 - j0 + 1
            r0 = np.arange(a, min(a + tile, span), rows)
            r0 = r0[r0 < n]
            j = np.searchsorted(cs[:m - 1], r0, side="right")
            for q in range(rows):
                i = r0 + q
                while True:
                    step = (j < m - 1) & (cs[np.minimum(j, m - 1)] <= i)
                    if not step.any():
                        break
                    j += step
                out[k, i] = ws[j] + slope[k] * i
    v = _wrap_int32(torch.from_numpy(out[:, :n]))
    return tuple(v[k] != 0 if b else v[k] for k, b in enumerate(bools))


@functools.lru_cache(maxsize=None)
def _layout(bools):
    """(bit mask of the bool columns, their count, each column's index
    into the int32 views followed by the bool views)."""
    nb = sum(bools)
    ints, flags = iter(range(len(bools) - nb)), iter(range(len(bools) - nb, len(bools)))
    order = tuple(next(flags) if b else next(ints) for b in bools)
    return sum(1 << k for k, b in enumerate(bools) if b), nb, order


def _check(W, C, S, n: int, bools) -> tuple:
    """(K, rcap, bools as a tuple of bool) of valid arguments; raises
    on any other, and for a mix of devices."""
    K, rcap = (W.shape if isinstance(W, torch.Tensor) and W.dim() == 2
               else (-1, -1))
    expect(W, "W", torch.int32, (K, rcap))
    expect(C, "C", torch.int32, (K, rcap))
    if S is not None:
        expect(S, "S", torch.int32, (K,))
    bools = tuple(bool(b) for b in bools)
    if len(bools) != K:
        raise ValueError(f"expand_runs: {len(bools)} bool marks for {K} columns")
    if K > 32 or rcap < 1 or n < 0:
        raise ValueError(f"expand_runs: K={K} (at most 32), rcap={rcap}, n={n}")
    return K, rcap, bools


def _outputs(K: int, nb: int, n: int, dev):
    """The int32 [K - nb, n] and bool [nb, n] outputs, None where empty."""
    return (torch.empty(K - nb, n, dtype=torch.int32, device=dev) if nb < K else None,
            torch.empty(nb, n, dtype=torch.bool, device=dev) if nb else None)


def _launch(W, C, S, n: int, bits: int, ints, flags, st) -> int:
    """The kernel on the stream ``st``, at ``tile_rows``' tiling: its
    launch count."""
    K, rcap = W.shape
    return _build.launch(
        "amt_expand_runs", _EXPAND_SIG, ptr(W), ptr(C),
        ptr(S) if S is not None else None, K, rcap, n, bits,
        tile_rows(n, K) // ROWS, ptr(ints) if ints is not None else None,
        ptr(flags) if flags is not None else None, st)


def _columns(ints, flags, order):
    """The K columns in order, rows of the two outputs."""
    if flags is None:
        return ints.unbind(0)
    if ints is None:
        return flags.unbind(0)
    views = ints.unbind(0) + flags.unbind(0)
    return tuple(views[i] for i in order)


def expand_runs(W, C, S, n: int, bools):
    """The K dense columns, int32 [n] (bool [n] where ``bools[k]``), of a
    stack of run tables: W (run values) and C (run ends, ascending, padded
    with n), int32 [K, rcap]; S, int32 [K], the slopes of a delta stack,
    or None for a run-length stack. CPU tensors take the plain version;
    CUDA tensors launch the kernel. On the card the columns are the rows
    of one [K - nb, n] int32 and one [nb, n] bool tensor."""
    K, _, bools = _check(W, C, S, n, bools)
    if not (on_cuda(W=W, C=C) if S is None else on_cuda(W=W, C=C, S=S)):
        return expand_runs_plain(W, C, S, n, bools)
    bits, nb, order = _layout(bools)
    ints, flags = _outputs(K, nb, n, W.device)
    expand_runs.launches += _launch(W, C, S, n, bits, ints, flags, stream(W))
    return _columns(ints, flags, order)


expand_runs.launches = 0


def unpack_flags_plain(flags):
    """Plain PyTorch version: (action, insert, value_tag, covered)."""
    return (flags & F_ACTION, (flags & F_INSERT) != 0,
            (flags >> F_TAG_SHIFT) & 15, (flags & F_COVERED) != 0)


def unpack_flags(flags):
    """(action int32, insert bool, value_tag int32, covered bool) [n] of
    an int32 [n] flags column. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    n = flags.shape[0] if isinstance(flags, torch.Tensor) else -1
    expect(flags, "flags", torch.int32, (n,))
    if not on_cuda(flags=flags):
        return unpack_flags_plain(flags)
    dev = flags.device
    ints = torch.empty(2, n, dtype=torch.int32, device=dev)
    bits = torch.empty(2, n, dtype=torch.bool, device=dev)
    unpack_flags.launches += _build.launch(
        "amt_unpack_flags", _FLAGS_SIG, ptr(flags), n, ptr(ints[0]),
        ptr(bits[0]), ptr(ints[1]), ptr(bits[1]), stream(flags))
    return ints[0], bits[0], ints[1], bits[1]


unpack_flags.launches = 0
