"""emit_packed: the packed transport's outputs in one flat int32 vector.

Replaces ``automerge_tpu/ops/merge.py`` ``_emit`` (:1181) with
``_bitpack`` (:1165): the requested outputs, in ``fetch`` order, one
after another; ``visible`` and ``conflicts > 1`` bit-packed 32 rows to a
word (bit b of word w is row 32w + b), every other output as int32, the
per-object stats cut to ``obj_cap``. The CUDA kernel is
``csrc/emit_packed.cu``: one launch for all outputs, one thread per row,
a warp's ``__ballot_sync`` forming each word. Bound by bytes: each output
read once, the flat vector written once.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._args import on_cuda, stream

# name -> the bit is "value > threshold" (None: the bool value itself)
BIT_OUTPUTS = {"visible": None, "conflicts": 1}
OBJ_STATS = ("obj_vis_len", "obj_text_width")
MAX_OUTPUTS = 16  # csrc/emit_packed.cu AMT_EMIT_MAX

_BITS_BOOL, _BITS_GT, _COPY_I32, _COPY_BOOL = range(4)
_INTS = ctypes.POINTER(ctypes.c_int)
_SIG = [ctypes.POINTER(ctypes.c_void_p), _INTS, _INTS, _INTS, _build.I_,
        _build.P_, _build.P_]


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


def _flat_length(core, fetch, obj_cap: int) -> int:
    """Length of the flat vector: ceil(n/32) words per bit output, n
    values per other output."""
    return sum((v.numel() + 31) // 32 if k in BIT_OUTPUTS else v.numel()
               for k, v in _segments(core, fetch, obj_cap))


def emit_packed(core, fetch, obj_cap: int):
    """The flat int32 vector of the outputs ``fetch`` names in ``core``
    (a dict of int32/bool tensors; ``visible`` bool, ``conflicts`` int32).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    segs = _segments(core, tuple(fetch), obj_cap)
    if not 0 < len(segs) <= MAX_OUTPUTS:
        raise ValueError(f"emit_packed: {len(segs)} outputs, 1 to {MAX_OUTPUTS}")
    kinds = []
    for k, v in segs:
        if v.dtype not in (torch.int32, torch.bool):
            raise TypeError(f"emit_packed: {k} is {v.dtype}, expected int32 or bool")
        if k in BIT_OUTPUTS:
            want = torch.bool if BIT_OUTPUTS[k] is None else torch.int32
            if v.dtype != want:
                raise TypeError(f"emit_packed: {k} is {v.dtype}, expected {want}")
            kinds.append(_BITS_BOOL if BIT_OUTPUTS[k] is None else _BITS_GT)
        else:
            kinds.append(_COPY_BOOL if v.dtype == torch.bool else _COPY_I32)
        if not v.is_contiguous():
            raise ValueError(f"emit_packed: {k} is not contiguous")
    if not on_cuda(**dict(segs)):
        return emit_packed_plain(core, fetch, obj_cap)
    dev = segs[0][1].device
    out = torch.empty(_flat_length(core, fetch, obj_cap), dtype=torch.int32,
                      device=dev)
    n = len(segs)
    srcs = (ctypes.c_void_p * n)(*[v.data_ptr() for _, v in segs])
    threshs = [BIT_OUTPUTS.get(k) or 0 for k, _ in segs]
    emit_packed.launches += _build.launch(
        "amt_emit_packed", _SIG, srcs, (ctypes.c_int * n)(*kinds),
        (ctypes.c_int * n)(*threshs),
        (ctypes.c_int * n)(*[v.numel() for _, v in segs]), n,
        out.data_ptr(), stream(out))
    return out


emit_packed.launches = 0
