"""A mesh of shards driven from one process, and its collectives.

The counterpart of the ``jax.sharding.Mesh`` that
``automerge_tpu/parallel/sharding.py`` runs its ``shard_map`` over. That
is single-controller SPMD: one process drives every device of the mesh.
Here a ``Mesh`` is an ordered tuple of torch devices, one per shard, and
a device may appear more than once: ``Mesh(["cuda:0"] * 4)`` runs four
shards on one card, as the JAX package's tests run eight on one CPU
(``--xla_force_host_platform_device_count``). On a host with several
cards the shards go to distinct cards and the copies below become
peer-to-peer copies.

A value is either *sharded*, a list of one tensor per shard on that
shard's device, or *replicated*, a dict of one tensor per distinct
device of the mesh (every shard reads its device's copy). The
collectives turn the first into the second:

- ``all_gather`` (``jax.lax.all_gather(x, tiled=True)``): the shards'
  slices copied, in shard order, into one full-size tensor on each
  distinct device;
- ``psum`` / ``pmax`` (``jax.lax.psum`` / ``pmax``): the shards' tables
  copied into one [n, L] stack on each distinct device and folded there
  by the ``mesh_reduce`` kernel (int32 sums wrap).

``stats`` counts each collective's calls and the bytes it copied into
its buffers, by kind; ``gathers`` lists every ``all_gather`` in call
order as (per-shard length, bytes copied). ``reset_stats()`` zeroes both.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..kernels.collectives import mesh_reduce

KINDS = ("all_gather", "psum", "pmax")

stats: Dict[str, Dict[str, int]] = {}
gathers: List[Tuple[int, int]] = []


def reset_stats() -> None:
    stats.clear()
    stats.update({k: {"calls": 0, "bytes": 0} for k in KINDS})
    gathers.clear()


reset_stats()


def _note(kind: str, nbytes: int) -> None:
    stats[kind]["calls"] += 1
    stats[kind]["bytes"] += nbytes


def _normal(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An ordered tuple of devices, one per shard (a device may repeat)."""

    def __init__(self, devices: Sequence):
        devs = tuple(_normal(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs
        self.size = len(devs)
        self.distinct = tuple(dict.fromkeys(devs))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def default_mesh(n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (the first ``n_devices`` of them when
    given), else over the first ``n_devices`` CUDA cards (all of them
    when None). Raises when there are fewer than asked for: a mesh of
    one card repeated is built only from ``devices`` the caller names."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(count)]
        if not devs:
            raise RuntimeError(
                "default_mesh: no CUDA device; name the devices "
                "(e.g. devices=['cpu'] * 4) for a mesh on the CPU")
    else:
        devs = list(devices)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(devs)


def replicate(mesh: Mesh, make) -> Dict[torch.device, torch.Tensor]:
    """``make(device)`` once per distinct device of the mesh."""
    return {d: make(d) for d in mesh.distinct}


def per_shard(mesh: Mesh, make) -> List:
    """``make(shard index, device)`` once per shard."""
    return [make(i, d) for i, d in enumerate(mesh.devices)]


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor]):
    """The shards' equal-length 1-D slices, concatenated in shard order,
    on each distinct device (tiled all_gather)."""
    L = parts[0].shape[0]
    out = {}
    for d in mesh.distinct:
        full = torch.empty(mesh.size * L, dtype=parts[0].dtype, device=d)
        for i, p in enumerate(parts):
            full[i * L:(i + 1) * L].copy_(p)
        out[d] = full
    nbytes = len(mesh.distinct) * mesh.size * L * parts[0].element_size()
    gathers.append((L, nbytes))
    _note("all_gather", nbytes)
    return out


def _reduce(kind: str, op: str, mesh: Mesh, parts: Sequence[torch.Tensor]):
    shape = parts[0].shape
    L = parts[0].numel()
    out = {}
    for d in mesh.distinct:
        stack = torch.empty(mesh.size, L, dtype=torch.int32, device=d)
        for i, p in enumerate(parts):
            stack[i].copy_(p.reshape(L))
        out[d] = mesh_reduce(stack, op).reshape(shape)
    _note(kind, len(mesh.distinct) * mesh.size * L * 4)
    return out


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]):
    """The shards' int32 tables summed (int32 wraparound), on each
    distinct device."""
    return _reduce("psum", "sum", mesh, parts)


def pmax(mesh: Mesh, parts: Sequence[torch.Tensor]):
    """The shards' int32 tables' elementwise max, on each distinct device."""
    return _reduce("pmax", "max", mesh, parts)
