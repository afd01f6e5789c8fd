"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

from typing import NamedTuple

import torch


def expect(t, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def on_cuda(**tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when every
    one lies on the CPU; raises for any other mix."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        listing = ", ".join(f"{k}={t.device}" for k, t in tensors.items())
        raise ValueError(f"tensors on different devices: {listing}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


class Stream(NamedTuple):
    """A CUDA stream handle and its card, as ``launch`` takes them."""
    handle: int
    device: torch.device


# the raw handle of a card's current stream, without building a
# torch.cuda.Stream object (CUDA builds of PyTorch have it)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(t: torch.Tensor) -> Stream:
    """The current stream of ``t``'s card: ``launch`` makes that card the
    current device while the entry point runs."""
    dev = t.device
    if _raw_stream is not None:
        return Stream(_raw_stream(dev.index), dev)
    return Stream(torch.cuda.current_stream(dev).cuda_stream, dev)
