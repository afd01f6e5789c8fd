"""expand_runs: slope-RLE run tables decoded into dense columns, and
unpack_flags: the packed transport's flags column split into four.

``expand_runs`` replaces ``automerge_tpu/ops/merge.py`` ``_expander``
(:849, K9), the run gather inside ``run_native_kernel`` (:1015-1034, K1)
and the packed transport's ``_expand`` (:1135, K10); ``unpack_flags`` the
flags split of ``_unpack_transport`` (:1157-1162). The CUDA kernels are in
``csrc/expand_runs.cu``: one thread per (row, column) with a binary
search over the column's run ends, uint32 arithmetic for the slope term
(XLA's int32 wraps); one thread per row for the flags. Both are bound by
bytes: the dense columns written.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._args import expect, on_cuda, ptr, stream

_P, _I = _build.P_, _build.I_
_EXPAND_SIG = [_P, _P, _P, _I, _I, _I, ctypes.c_uint, _P, _P, _P]
_FLAGS_SIG = [_P, _I, _P, _P, _P, _P, _P]

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


def expand_runs(W, C, S, n: int, bools):
    """The K dense columns, int32 [n] (bool [n] where ``bools[k]``), of a
    stack of run tables: W (run values) and C (run ends, ascending, padded
    with n), int32 [K, rcap]; S, int32 [K], the slopes of a delta stack,
    or None for a run-length stack. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    K, rcap = (W.shape if isinstance(W, torch.Tensor) and W.dim() == 2
                else (-1, -1))
    expect(W, "W", torch.int32, (K, rcap))
    expect(C, "C", torch.int32, (K, rcap))
    tensors = {"W": W, "C": C}
    if S is not None:
        expect(S, "S", torch.int32, (K,))
        tensors["S"] = S
    bools = tuple(bool(b) for b in bools)
    if len(bools) != K:
        raise ValueError(f"expand_runs: {len(bools)} bool marks for {K} columns")
    if K > 32 or rcap < 1 or n < 0:
        raise ValueError(f"expand_runs: K={K} (at most 32), rcap={rcap}, n={n}")
    if not on_cuda(**tensors):
        return expand_runs_plain(W, C, S, n, bools)
    nb = sum(bools)
    dev = W.device
    out_i = torch.empty(K - nb, n, dtype=torch.int32, device=dev)
    out_b = torch.empty(nb, n, dtype=torch.bool, device=dev)
    bits = sum(1 << k for k, b in enumerate(bools) if b)
    expand_runs.launches += _build.launch(
        "amt_expand_runs", _EXPAND_SIG, ptr(W), ptr(C),
        ptr(S) if S is not None else None, K, rcap, n, bits, ptr(out_i),
        ptr(out_b), stream(W))
    ints, flags = iter(out_i), iter(out_b)
    return tuple(next(flags) if b else next(ints) for b in bools)


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
