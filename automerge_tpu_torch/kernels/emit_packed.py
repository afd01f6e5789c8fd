"""emit_packed: the packed transport's outputs in one flat int32 vector.

Replaces ``automerge_tpu/ops/merge.py`` ``_emit`` (:1181) with
``_bitpack`` (:1165): the requested outputs, in ``fetch`` order, one
after another; ``visible`` and ``conflicts > 1`` bit-packed 32 rows to a
word (bit b of word w is row 32w + b), every other output as int32, the
per-object stats cut to ``obj_cap``. The CUDA kernel is
``csrc/emit_packed.cu``: one launch for all outputs, each segment its own
range of blocks, a thread forming a whole word of a bit output or
storing 16 bytes of a copied one. A call checks its outputs and lays
out their plan (segment kinds, thresholds, lengths, offsets, block
starts, flat length) in one loop over at most 16 outputs, then makes
one C call. Bound by bytes: each output read once, the flat vector
written once.
"""

from __future__ import annotations

import array
from typing import NamedTuple

import torch

from . import _build
from ._args import stream

# name -> the bit is "value > threshold" (None: the bool value itself)
BIT_OUTPUTS = {"visible": None, "conflicts": 1}
OBJ_STATS = ("obj_vis_len", "obj_text_width")
MAX_OUTPUTS = 16  # csrc/emit_packed.cu AMT_EMIT_MAX

_BITS_BOOL, _BITS_GT, _COPY_I32, _COPY_BOOL = range(4)
THREADS = 256  # a block's threads (csrc/common.cuh AMT_THREADS)
_SIG = [_build.P_, _build.P_, _build.I_, _build.LL_, _build.P_, _build.P_]


def _bitpack_plain(v):
    """(P,) bool -> (ceil(P/32),) int32 words, as ``_bitpack`` does."""
    P = v.shape[0]
    b = torch.zeros(P + (-P) % 32, dtype=torch.int64, device=v.device)
    b[:P] = v.long()
    shifts = torch.arange(32, dtype=torch.int64, device=v.device)
    words = (b.reshape(-1, 32) << shifts).sum(dim=1)
    return (words - (words >= (1 << 31)).long() * (1 << 32)).to(torch.int32)


def _segments(core, fetch, obj_cap):
    """[(name, tensor)] in fetch order, the per-object stats cut."""
    out = []
    for k in fetch:
        v = core[k]
        if k in OBJ_STATS:
            v = v[:obj_cap]
        out.append((k, v.reshape(-1)))
    return out


def emit_packed_plain(core, fetch, obj_cap: int):
    """Plain PyTorch version, step by step as ``_emit``."""
    outs = []
    for k, v in _segments(core, fetch, obj_cap):
        if k in BIT_OUTPUTS:
            thresh = BIT_OUTPUTS[k]
            outs.append(_bitpack_plain(v if thresh is None else v > thresh))
        else:
            outs.append(v.to(torch.int32))
    return torch.cat(outs)


class Plan(NamedTuple):
    """The layout of one flat vector. ``meta`` holds, per segment, its
    kind, threshold, rows, offset in the vector and first block, then
    the grid's blocks, as the C entry reads them."""
    meta: array.array
    flat_length: int


# a bit output's (dtype, kind, threshold); any other's kind by its dtype
_BIT_KINDS = {"visible": (torch.bool, _BITS_BOOL, 0),
              "conflicts": (torch.int32, _BITS_GT, BIT_OUTPUTS["conflicts"])}
_COPY_KINDS = {torch.int32: _COPY_I32, torch.bool: _COPY_BOOL}


def _kind(k: str, dtype: torch.dtype) -> tuple:
    """(kind, threshold) of the output ``k`` of ``dtype``."""
    bit = _BIT_KINDS.get(k)
    if bit is None:
        kind = _COPY_KINDS.get(dtype)
        if kind is None:
            raise TypeError(f"emit_packed: {k} is {dtype}, expected int32 or bool")
        return kind, 0
    if dtype != bit[0]:
        raise TypeError(f"emit_packed: {k} is {dtype}, expected {bit[0]}")
    return bit[1:]


def plan(fetch, obj_cap: int, srcs) -> Plan:
    """The plan of the outputs ``fetch`` names, ``srcs`` (in fetch
    order, the stats cut to ``obj_cap``), each checked: int32 or bool as
    its kind wants, contiguous, on the first one's device."""
    if not 0 < len(fetch) <= MAX_OUTPUTS:
        raise ValueError(f"emit_packed: {len(fetch)} outputs, 1 to {MAX_OUTPUTS}")
    meta = array.array("i")
    off = blocks = 0
    dev = srcs[0].device
    for k, v in zip(fetch, srcs):
        kind, thresh = _kind(k, v.dtype)
        if v.device != dev:
            raise ValueError(f"emit_packed: {k} on {v.device}, {fetch[0]} on {dev}")
        if not v.is_contiguous():
            raise ValueError(f"emit_packed: {k} is not contiguous")
        n = v.numel()
        if k in OBJ_STATS and n > obj_cap:
            n = obj_cap
        meta.extend((kind, thresh, n, off, blocks))
        # a word a thread of a bit output; four values a thread of a
        # copied one, one more for those before its first aligned word
        if kind <= _BITS_GT:
            words = threads = (n + 31) >> 5
        else:
            words, threads = n, (n + 3 >> 2) + 1 if n else 0
        off += words
        blocks += (threads + THREADS - 1) // THREADS
    if off >= 1 << 31:
        raise ValueError(f"emit_packed: {off} values exceed the int32 offsets")
    meta.append(blocks)
    return Plan(meta, off)


def emit_packed(core, fetch, obj_cap: int):
    """The flat int32 vector of the outputs ``fetch`` names in ``core``
    (a dict of contiguous int32/bool tensors; ``visible`` bool,
    ``conflicts`` int32). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    srcs = [core[k] for k in fetch]
    p = plan(fetch, obj_cap, srcs)
    dev = srcs[0].device
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return emit_packed_plain(core, fetch, obj_cap)
    out = torch.empty(p.flat_length, dtype=torch.int32, device=dev)
    ptrs = array.array("Q", [v.data_ptr() for v in srcs])
    emit_packed.launches += _build.launch(
        "amt_emit_packed", _SIG, ptrs.buffer_info()[0], p.meta.buffer_info()[0],
        len(srcs), p.flat_length, out.data_ptr(), stream(out))
    return out


emit_packed.launches = 0
