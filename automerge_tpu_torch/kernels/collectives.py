"""mesh_reduce: the reduction of the sharded merge's psum and pmax.

Replaces the arithmetic of ``jax.lax.psum`` / ``jax.lax.pmax`` in
``automerge_tpu/parallel/sharding.py`` (:138-139, :154-162, :341-342);
the CUDA kernel is ``csrc/collectives.cu``. It folds the shards' tables
where they lie: the n pointers are passed by value (no stack is built),
four columns a thread with 16-byte evict-first loads, the n values
folded as uint32 adds (so the sum wraps as int32) or a signed max.
Up to ``CAP`` tables fold in one launch; more fold in passes, groups of
``CAP`` into partials, then the partials, until one table is left (both
folds are exact in any order). ``parallel/collectives.py`` calls
``fold`` once per distinct device. Bound by bytes: the n tables read
once, the result written once (and each pass's partials once more).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Union

import torch

from . import _build
from ._args import expect, on_cuda, sm_count, stream

_SIG = [ctypes.POINTER(ctypes.c_longlong), _build.I_, _build.LL_, _build.I_,
        _build.P_, _build.I_, _build.P_]
OPS = ("sum", "max")
# the most tables one launch folds: the kernel's parameter holds their
# pointers and its threads keep one load of each in flight
CAP = 8

Parts = Union[torch.Tensor, Sequence[torch.Tensor]]


def _parts(parts: Parts, op: str) -> List[torch.Tensor]:
    """The tables of ``parts``: a sequence of contiguous int32 tensors of
    one shape on one device, or the rows of an int32 [n, L] tensor."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, not {op!r}")
    if isinstance(parts, torch.Tensor):
        shape = tuple(parts.shape)
        if len(shape) != 2 or shape[0] < 1:
            raise ValueError(f"stack: expected shape [n >= 1, L], got {shape}")
        expect(parts, "stack", torch.int32, shape)
        tables = list(parts.unbind(0))
    else:
        tables = list(parts)
        if not tables:
            raise ValueError("mesh_reduce needs at least one table")
        shape = tuple(tables[0].shape) if isinstance(tables[0], torch.Tensor) else ()
        for i, t in enumerate(tables):
            expect(t, f"parts[{i}]", torch.int32, shape)
        on_cuda(**{f"parts[{i}]": t for i, t in enumerate(tables)})
    return tables


def _fold_plain(tables: List[torch.Tensor], op: str) -> torch.Tensor:
    stack = torch.stack(tables)
    if op == "max":
        return stack.amax(0)
    total = stack.long().sum(0) & 0xFFFFFFFF
    return torch.where(total >= 1 << 31, total - (1 << 32), total).to(torch.int32)


def mesh_reduce_plain(parts: Parts, op: str) -> torch.Tensor:
    """Plain PyTorch version: the int32 tables ``parts`` (a sequence, or
    the rows of an [n, L] tensor) summed with int32 wraparound, or their
    max; the shape of one table."""
    return _fold_plain(_parts(parts, op), op)


def mesh_reduce(parts: Parts, op: str) -> torch.Tensor:
    """The int32 tables ``parts`` (n >= 1 contiguous tensors of one shape
    on one device, or the rows of an int32 [n, L] tensor) folded by ``op``
    ("sum", wrapping as int32, or "max"), in the shape of one table. CPU
    tensors take the plain version; CUDA tensors launch the kernel: one
    launch for n <= ``CAP``, nothing allocated but the result; past it,
    ``passes(n)`` launches."""
    return fold(_parts(parts, op), op)


def passes(n: int) -> int:
    """The launches ``fold`` makes for n tables on the card: one a group
    of ``CAP`` (or fewer) in each pass; a group of one passes through."""
    count = 0
    while n > 1:
        groups, lone = divmod(n, CAP)
        count += groups + (lone > 1)
        n = groups + (lone > 0)
    return max(count, 1)


def fold(tables: List[torch.Tensor], op: str) -> torch.Tensor:
    """``mesh_reduce`` of tables its caller has checked: one or more
    contiguous int32 tensors of one shape on one device, ``op`` in
    ``OPS``. Each table's pointer goes straight to the C entry; past
    ``CAP`` tables each pass folds groups of ``CAP`` into partials (a
    group of one is carried over as it is), until one table is left."""
    if tables[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tables[0].device}")
    while len(tables) > CAP:
        tables = [_launch(tables[i:i + CAP], op) if len(tables) - i > 1
                  else tables[i] for i in range(0, len(tables), CAP)]
    return _launch(tables, op)


def _launch(tables: List[torch.Tensor], op: str) -> torch.Tensor:
    """One fold of 1 to ``CAP`` tables: a launch of the kernel, or on the
    CPU its plain version."""
    t0 = tables[0]
    if not t0.is_cuda:
        return _fold_plain(tables, op)
    out = torch.empty_like(t0)
    ptrs = (ctypes.c_longlong * len(tables))(*[t.data_ptr() for t in tables])
    mesh_reduce.launches += _build.launch(
        "amt_mesh_reduce", _SIG, ptrs, len(tables), out.numel(), OPS.index(op),
        out.data_ptr(), sm_count(out), stream(out))
    return out


mesh_reduce.launches = 0
