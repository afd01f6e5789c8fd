"""mesh_reduce: the reduction of the sharded merge's psum and pmax.

Replaces the arithmetic of ``jax.lax.psum`` / ``jax.lax.pmax`` in
``automerge_tpu/parallel/sharding.py`` (:138-139, :154-162, :341-342);
the CUDA kernel is ``csrc/collectives.cu`` (one thread per column, the n
shards' values folded in order: uint32 adds, so the sum wraps as int32,
or a max). ``parallel/collectives.py`` stacks the shards' partial tables
on each device and calls it. Bound by bytes: the [n, L] stack read once,
the [L] row written once.
"""

from __future__ import annotations

import torch

from . import _build
from ._args import expect, on_cuda, ptr, stream

_P, _I = _build.P_, _build.I_
_SIG = [_P, _I, _build.LL_, _I, _P, _P]
OPS = ("sum", "max")


def mesh_reduce_plain(stack, op: str):
    """Plain PyTorch version: the rows of int32 ``stack`` [n, L] summed
    with int32 wraparound, or their max."""
    if op == "max":
        return stack.amax(0)
    total = stack.long().sum(0) & 0xFFFFFFFF
    return torch.where(total >= 1 << 31, total - (1 << 32), total).to(torch.int32)


def mesh_reduce(stack, op: str):
    """int32 [L]: the n rows of int32 ``stack`` [n, L] folded by ``op``
    ("sum", wrapping as int32, or "max"). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, not {op!r}")
    shape = tuple(stack.shape) if isinstance(stack, torch.Tensor) else ()
    if len(shape) != 2 or shape[0] < 1:
        raise ValueError(f"stack: expected shape [n >= 1, L], got {shape}")
    expect(stack, "stack", torch.int32, shape)
    if not on_cuda(stack=stack):
        return mesh_reduce_plain(stack, op)
    n, L = shape
    out = torch.empty(L, dtype=torch.int32, device=stack.device)
    mesh_reduce.launches += _build.launch(
        "amt_mesh_reduce", _SIG, ptr(stack), n, L, OPS.index(op), ptr(out),
        stream(stack))
    return out


mesh_reduce.launches = 0
