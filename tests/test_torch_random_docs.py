"""Seeded random documents: the port's ``DeviceDoc`` on the CPU against
the JAX package's, on the same change bytes.

The JAX package's document API writes the histories: a base document
forked five or six ways, two or three rounds of random edits on every
fork with cross-merges between rounds (nested maps, lists and text,
objects inside lists, map and list deletes, conflicting puts of shared
keys, counters and increments, text marks). Both packages then merge the
changes in one fan-in and must answer every read over every object alike;
and both serve the same changes batch by batch (``apply_changes``,
``apply_batches``, and the card's pipelined apply run on the plain
kernels), equal after every batch on the ``READ_FETCH`` arrays, the
counters and the reads. The winners and the sibling order these reads
rest on are what the ``sort_winners`` and ``radix_sort`` kernels compute
on the card.
"""

import random

import numpy as np
import pytest

from automerge_tpu.ops import extract as JX
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu.types import ObjType
from automerge_tpu_torch.ops.device_doc import DeviceDoc

from .test_torch_extract import SpliceOracle
from .test_torch_histories import KEYS, _history  # noqa: F401 (others import it here)


@pytest.fixture(autouse=True)
def cold_jax_change_cache(monkeypatch):
    """Each test starts with the JAX package's per-change-hash extraction
    cache empty, so both packages number map keys alike (ROADMAP §3)."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)


def _j_doc(blobs):
    return JDeviceDoc.resolve(JOpLog.from_changes([j_parse_change(b)[0] for b in blobs]))


def _reads(doc):
    """Every read of every object reachable from the root: map entries,
    keys and each key's values; list items and each index's values; text
    and its items; lengths and types."""
    out = {"pending": doc.pending_changes()}
    stack = ["_root"]
    while stack:
        obj = stack.pop()
        t = doc.object_type(obj)
        if t in (ObjType.MAP, ObjType.TABLE):
            entries = doc.map_entries(obj)
            out[obj] = (t, entries, doc.keys(obj), doc.length(obj),
                        [doc.get_all(obj, k) for k in (*KEYS, "missing")])
            vals = [v for _, v, _ in entries]
        else:
            items = doc.list_items(obj)
            out[obj] = (t, items, doc.length(obj),
                        [doc.get_all(obj, i) for i in range(len(items) + 1)],
                        doc.text(obj) if t == ObjType.TEXT else None)
            vals = [v for v, _ in items]
        stack += [v[2] for v in vals if v[0] == "obj"]
    return out


SEEDS = range(8)


@pytest.mark.parametrize("seed", SEEDS)
def test_fanin_reads_equal_jax(seed):
    base, rest = _history(seed)
    blobs = base + rest
    doc = DeviceDoc.merge(blobs, device="cpu")
    jdoc = _j_doc(blobs)
    assert doc.log.n == jdoc.log.n and doc.log.n > 80
    for k in DeviceDoc.READ_FETCH:
        cut = doc.log.n_objs + 2 if k.startswith("obj_") else doc.log.n
        np.testing.assert_array_equal(np.asarray(doc.res[k])[:cut],
                                      np.asarray(jdoc.res[k])[:cut], err_msg=k)
    reads = _reads(doc)
    assert reads == _reads(jdoc)
    assert len(reads) > 5  # objects inside lists and maps were reached


def _apply(doc, batch, mode):
    if mode == "apply_changes":
        return doc.apply_changes(batch)
    if mode == "apply_batches":
        return doc.apply_batches([batch])
    return doc._apply_pipelined([batch])


@pytest.mark.parametrize("mode", ["apply_changes", "apply_batches", "pipelined"])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_served_batches_equal_jax_after_every_batch(seed, mode):
    """The base resident, then the forks' changes in shuffled batches of
    one to six (a change may come before its dependencies and wait)."""
    base, rest = _history(seed)
    rng = random.Random(1000 + seed)
    rest = [b for b in rest if b not in base]
    rng.shuffle(rest)
    doc = DeviceDoc.merge(base, device="cpu")
    jdoc = _j_doc(base)
    i = 0
    while i < len(rest):
        batch = rest[i:i + rng.randrange(1, 7)]
        i += len(batch)
        got = _apply(doc, batch, mode)
        assert got == jdoc.apply_changes([j_parse_change(b)[0] for b in batch]), i
        n = doc.log.n
        for k in DeviceDoc.READ_FETCH:
            cut = doc.log.n_objs + 2 if k.startswith("obj_") else n
            np.testing.assert_array_equal(np.asarray(doc.res[k])[:cut],
                                          np.asarray(jdoc.res[k])[:cut],
                                          err_msg=f"{i} {k}")
        for k in ("succ_count", "inc_count", "counter_val"):
            np.testing.assert_array_equal(getattr(doc, k)[:n], getattr(jdoc, k)[:n],
                                          err_msg=f"{i} {k}")
        assert _reads(doc) == _reads(jdoc), i
    assert doc.pending_changes() == 0
    assert _reads(doc) == _reads(DeviceDoc.merge(base + rest, device="cpu"))


@pytest.mark.parametrize("mode", ["apply_changes", "apply_batches", "pipelined"])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_served_splice_equals_the_oracle_splice_and_a_rebuild(seed, mode,
                                                             monkeypatch):
    """The served document's log after every shuffled batch: spliced
    through the native delta (``_extract_delta``), it equals the per-op
    oracle's splice of the same changes (``append_changes(fast=False)``)
    and a fresh ``OpLog.from_changes`` of its changes, on every column,
    ``props``, ``mark_names`` and value."""
    base, rest = _history(seed)
    rng = random.Random(3000 + seed)
    rest = [b for b in rest if b not in base]
    rng.shuffle(rest)
    doc = DeviceDoc.merge(base, device="cpu")
    oracle = SpliceOracle(monkeypatch, doc)
    i = 0
    while i < len(rest):
        batch = rest[i:i + rng.randrange(1, 7)]
        i += len(batch)
        _apply(doc, batch, mode)
        oracle.check(doc, f"batch ending {i}")
    assert oracle.deltas > 0 and doc.pending_changes() == 0


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["cpu:0", "cpu:1"]],
                         ids=["repeated", "distinct"])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_served_mesh_document_equals_jax_after_every_batch(seed, devices,
                                                           monkeypatch):
    """The served document with ``enable_mesh(min_rows=0)``: its full
    re-resolutions go through the sharded merge over a mesh of one device
    repeated (the rounds entries) or of two distinct devices (the
    exchange). After every shuffled batch it equals the JAX package's
    single-device document (its mesh document permutes rows wrongly after
    a splice, ROADMAP §3) on the ``READ_FETCH`` arrays and the reads."""
    base, rest = _history(seed)
    rng = random.Random(2000 + seed)
    rest = [b for b in rest if b not in base]
    rng.shuffle(rest)
    doc = DeviceDoc.merge(base, device="cpu")
    mesh = doc.enable_mesh(devices=devices, min_rows=0)
    assert mesh.size == 2 and len(mesh.distinct) == len(set(devices))
    inner, ran = DeviceDoc._mesh_resolve_inner, []

    def spy(self):
        ran.append(self.log.n)
        return inner(self)

    monkeypatch.setattr(DeviceDoc, "_mesh_resolve_inner", spy)
    jdoc = _j_doc(base)
    i = 0
    while i < len(rest):
        batch = rest[i:i + rng.randrange(1, 7)]
        i += len(batch)
        got = doc.apply_changes(batch)
        assert got == jdoc.apply_changes([j_parse_change(b)[0] for b in batch]), i
        n = doc.log.n
        for k in DeviceDoc.READ_FETCH:
            cut = doc.log.n_objs + 2 if k.startswith("obj_") else n
            np.testing.assert_array_equal(np.asarray(doc.res[k])[:cut],
                                          np.asarray(jdoc.res[k])[:cut],
                                          err_msg=f"{i} {k}")
        assert _reads(doc) == _reads(jdoc), i
    assert ran, "no full re-resolve went through the mesh"
    assert doc.pending_changes() == 0
