"""radix_sort: a stable ascending LSD radix sort of int64 keys.

Replaces the sort in ``automerge_tpu/ops/merge.py`` ``forest`` (:582),
``jax.lax.sort((sib_parent, -rows), num_keys=2, is_stable=True)``, on the
packed sibling keys of ``forest``. The CUDA kernels are
``csrc/radix_sort.cu``: one histogram pass over every sorted 8-bit digit,
then one onesweep scatter pass per digit (tiles ranked stably by warp
multi-split, global offsets by decoupled look-back), ping-ponging between
two buffers. The caller names the digits to sort; the ones it leaves out
must be constant over the keys, which it knows from their layout. With
``count`` (an int32 [1] tensor on the keys' card) only the first
``count`` keys are sorted, a length the kernels read on the card: the
forest sorts its element rows without the host waiting for their number.
Bound by bytes: 8n read, 8n written.
"""

from __future__ import annotations

import torch

from . import _build
from ._args import expect, on_cuda, ptr, stream

DIGITS = tuple(range(8))
TILE = 4096  # keys per onesweep tile (csrc/radix_sort.cu RS_TILE)
RADIX = 256
_SIGN = -(1 << 63)

_P, _I, _LL = _build.P_, _build.I_, _build.LL_
_SIG = [_P, _P, _P, _I, _I, _P, _LL, _P, _P]


def digit_mask(digits) -> int:
    """Bit d set for each digit d (key bits [8d, 8d + 8) with bit 63
    flipped); raises unless ``digits`` is a non-empty ascending tuple of
    distinct digits in 0..7."""
    digits = tuple(digits)
    if not digits or list(digits) != sorted(set(digits)) or not set(digits) <= set(DIGITS):
        raise ValueError(f"radix_sort: digits must be ascending, distinct, in 0..7: {digits}")
    return sum(1 << d for d in digits)


def scratch_words(n: int, digits) -> int:
    """uint32 words of the kernels' scratch: the [8, 256] digit counts, 8
    tile counters, and each pass's [tiles, 256] look-back words."""
    tiles = -(-n // TILE)
    return 8 * RADIX + 8 + len(tuple(digits)) * tiles * RADIX


def radix_sort_plain(keys, digits=DIGITS, count=None):
    """Plain PyTorch version: the keys stably sorted by their ``digits``
    alone (bit 63 flipped, so signed keys order as themselves). Where the
    other digits are constant, as the caller guarantees, that is
    ``torch.sort(keys, stable=True)``. With ``count``, the first
    ``count`` keys (clamped to [0, n]) sorted and the rest as they were."""
    if count is not None:
        c = min(max(int(count[0]), 0), keys.shape[0])
        return torch.cat([radix_sort_plain(keys[:c], digits), keys[c:]])
    if digit_mask(digits) == 0xFF:
        return torch.sort(keys, stable=True).values
    bits = sum(0xFF << (8 * d) for d in digits)
    bits = bits - (1 << 64) if bits >= 1 << 63 else bits
    order = ((keys ^ _SIGN) & bits) ^ _SIGN  # signed order = the digits' unsigned order
    return keys[torch.sort(order, stable=True).indices]


def radix_sort(keys, digits=DIGITS, count=None):
    """Stable ascending sort of a 1-D int64 tensor by ``digits`` (default:
    all 8); with ``count``, an int32 [1] tensor, of its first ``count``
    keys (clamped to [0, n]), the rest of the result unspecified. CPU
    tensors take the plain version; CUDA tensors launch the histogram and
    one scatter pass per digit."""
    n = keys.shape[0] if isinstance(keys, torch.Tensor) and keys.dim() == 1 else -1
    expect(keys, "keys", torch.int64, (n,))
    mask = digit_mask(digits)
    on = {"keys": keys}
    if count is not None:
        expect(count, "count", torch.int32, (1,))
        on["count"] = count
    if not on_cuda(**on):
        return radix_sort_plain(keys, digits, count)
    if n >= 1 << 30:
        raise ValueError(f"radix_sort: {n} keys exceed the int32 index range")
    dev = keys.device
    bufs = torch.empty(2, n, dtype=torch.int64, device=dev)
    words = scratch_words(n, digits)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    radix_sort.launches += _build.launch(
        "amt_radix_sort", _SIG, ptr(keys), ptr(bufs[0]), ptr(bufs[1]), n, mask,
        ptr(scratch), words, None if count is None else ptr(count), stream(keys))
    return bufs[(len(tuple(digits)) - 1) % 2]


radix_sort.launches = 0
