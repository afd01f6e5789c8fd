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
- ``psum`` / ``pmax`` (``jax.lax.psum`` / ``pmax``, any mesh size): the
  shards' tables folded on each distinct device by ``mesh_reduce`` (one
  launch up to ``CAP`` shards, a pass a group of ``CAP`` past it; int32
  sums wrap), the tables on that device read where they lie and only the
  other devices' copied in first (on a mesh of one device, nothing).

A doubling loop of the sharded merge gathers its state every round
without ``all_gather``'s allocation: ``all_gather_into`` copies in only
the slices other devices wrote into their own full-size buffers, and on
a mesh of one device, where a kernel writes the whole state, nothing is
copied at all (``note_gather``).

``stats`` counts each collective's calls, the bytes it delivered into
the gathered buffers or the fold (``bytes``, the reference's volume,
whoever wrote them) and the bytes ``copy_`` actually moved (``copied``),
by kind; ``gathers`` lists every all_gather in call order as (per-shard
length, bytes delivered). ``reset_stats()`` zeroes both.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..kernels.collectives import fold

KINDS = ("all_gather", "psum", "pmax")

stats: Dict[str, Dict[str, int]] = {}
gathers: List[Tuple[int, int]] = []


def reset_stats() -> None:
    stats.clear()
    stats.update({k: {"calls": 0, "bytes": 0, "copied": 0} for k in KINDS})
    gathers.clear()


reset_stats()


def _note(kind: str, nbytes: int, copied: int) -> None:
    stats[kind]["calls"] += 1
    stats[kind]["bytes"] += nbytes
    stats[kind]["copied"] += copied


def note_gather(mesh: "Mesh", length: int, itemsize: int, copied: int = 0) -> None:
    """One tiled all_gather of ``length`` values of ``itemsize`` bytes a
    shard, in the reference's terms: every distinct device receives all
    ``size`` slices; ``copied`` of those bytes were moved by a copy."""
    nbytes = len(mesh.distinct) * mesh.size * length * itemsize
    gathers.append((length, nbytes))
    _note("all_gather", nbytes, copied)


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
        # (device, first shard, shard count): the maximal runs of
        # consecutive shards on one device, in shard order
        runs = []
        for i, d in enumerate(devs):
            if runs and runs[-1][0] == d:
                runs[-1][2] += 1
            else:
                runs.append([d, i, 1])
        self.runs = tuple(map(tuple, runs))

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
    note_gather(mesh, L, parts[0].element_size(), nbytes)
    return out


def all_gather_into(mesh: Mesh, full: Dict[torch.device, torch.Tensor],
                    length: int) -> None:
    """A tiled all_gather in place: ``full`` holds one buffer of
    ``size * length`` values per distinct device, in which each device
    has written the slices of its own shards; each buffer gets the other
    devices' slices copied in, and its own are not copied."""
    copied = 0
    for d, buf in full.items():
        for src, first, count in mesh.runs:
            if src != d:
                sl = slice(first * length, (first + count) * length)
                buf[sl].copy_(full[src][sl])
                copied += count * length * buf.element_size()
    itemsize = next(iter(full.values())).element_size()
    note_gather(mesh, length, itemsize, copied)


def _reduce(kind: str, op: str, mesh: Mesh, parts: Sequence[torch.Tensor]):
    """One ``fold`` a distinct device over the shards' tables, in shard
    order: the tables of the shards on that device as they are, the
    others' copied into one [m, ...] staging buffer there first. The
    tables are checked here, once, not again by the fold."""
    shape = parts[0].shape
    if len(parts) != mesh.size or any(
            p.dtype != torch.int32 or p.shape != shape or not p.is_contiguous()
            for p in parts):
        raise ValueError(f"{kind}: expected {mesh.size} contiguous int32 tables "
                         "of one shape, one a shard")
    nbytes = parts[0].numel() * 4
    out, copied = {}, 0
    for d in mesh.distinct:
        remote = [i for i, dev in enumerate(mesh.devices) if dev != d]
        tables = list(parts)
        if remote:
            stage = torch.empty((len(remote),) + shape, dtype=torch.int32, device=d)
            for row, i in zip(stage, remote):
                tables[i] = row.copy_(parts[i])
            copied += len(remote) * nbytes
        out[d] = fold(tables, op)
    _note(kind, len(mesh.distinct) * mesh.size * nbytes, copied)
    return out


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]):
    """The shards' int32 tables summed (int32 wraparound), on each
    distinct device."""
    return _reduce("psum", "sum", mesh, parts)


def pmax(mesh: Mesh, parts: Sequence[torch.Tensor]):
    """The shards' int32 tables' elementwise max, on each distinct device."""
    return _reduce("pmax", "max", mesh, parts)
