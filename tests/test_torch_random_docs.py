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

import functools
import random

import numpy as np
import pytest

from automerge_tpu.api import AutoDoc
from automerge_tpu.ops import extract as JX
from automerge_tpu.ops.device_doc import DeviceDoc as JDeviceDoc
from automerge_tpu.ops.oplog import OpLog as JOpLog
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu.types import ActorId, ObjType, ScalarValue
from automerge_tpu_torch.ops.device_doc import DeviceDoc

KEYS = ("a", "b", "c", "title", "n")


@pytest.fixture(autouse=True)
def cold_jax_change_cache(monkeypatch):
    """Each test starts with the JAX package's per-change-hash extraction
    cache empty, so both packages number map keys alike (ROADMAP §3)."""
    monkeypatch.setattr(JX, "_CHANGE_COLS_CACHE", None)


def _objects(doc, obj="_root"):
    """(object id, type) of every object reachable from ``obj`` in an
    AutoDoc, ``obj`` first."""
    t = doc.object_type(obj) if obj != "_root" else ObjType.MAP
    out = [(obj, t)]
    if t in (ObjType.MAP, ObjType.TABLE):
        children = [doc.get(obj, k) for k in doc.keys(obj)]
    elif t == ObjType.LIST:
        children = [doc.get(obj, i) for i in range(doc.length(obj))]
    else:
        children = []
    for v in children:
        if v is not None and v[0] == "obj":
            out += _objects(doc, v[2])
    return out


def _edit(doc, rng, tag):
    """One random edit of ``doc``."""
    objs = _objects(doc)
    obj, t = rng.choice(objs)
    r = rng.random()
    if t == ObjType.TEXT:
        n = doc.length(obj)
        if r < 0.15 and n > 2:
            start = rng.randrange(n - 1)
            doc.mark(obj, start, rng.randrange(start + 1, n + 1), rng.choice(("bold", "em")),
                     ScalarValue("bool", True))
        else:
            pos = rng.randrange(n + 1)
            doc.splice_text(obj, pos, rng.randrange(min(3, n - pos) + 1) if r < 0.5 else 0,
                            "".join(rng.choice("xyz ") for _ in range(rng.randrange(1, 4))))
    elif t == ObjType.LIST:
        n = doc.length(obj)
        if r < 0.25 and n:
            doc.delete(obj, rng.randrange(n))
        elif r < 0.4:
            doc.insert_object(obj, rng.randrange(n + 1), rng.choice((ObjType.MAP, ObjType.LIST)))
        elif r < 0.55 and n:
            doc.put(obj, rng.randrange(n), ScalarValue("str", tag))
        else:
            doc.insert(obj, rng.randrange(n + 1), ScalarValue("int", rng.randrange(100)))
    else:
        key = rng.choice(KEYS)
        cur = doc.get(obj, key)
        if cur is not None and cur[0] == "counter" and r < 0.6:
            doc.increment(obj, key, rng.randrange(1, 5))
        elif r < 0.15 and cur is not None:
            doc.delete(obj, key)
        elif r < 0.25:
            doc.put_object(obj, key, rng.choice((ObjType.MAP, ObjType.LIST, ObjType.TEXT)))
        elif r < 0.35:
            doc.put(obj, key, ScalarValue("counter", rng.randrange(10)))
        else:
            doc.put(obj, key, ScalarValue("str", f"{tag}{rng.randrange(10)}"))


def _blobs(docs):
    seen, out = set(), []
    for d in docs:
        for a in d.doc.history:
            if a.stored.hash not in seen:
                seen.add(a.stored.hash)
                out.append(a.stored.raw_bytes)
    return out


@functools.lru_cache(maxsize=None)
def _history(seed):
    """(base change bytes, every change's bytes in causal order) of one
    seeded random document."""
    rng = random.Random(seed)
    base = AutoDoc(actor=ActorId(bytes([1]) * 16))
    text = base.put_object("_root", "text", ObjType.TEXT)
    base.splice_text(text, 0, 0, "the base text")
    items = base.put_object("_root", "items", ObjType.LIST)
    for i in range(4):
        base.insert(items, i, ScalarValue("int", i))
    inner = base.insert_object(items, 2, ObjType.MAP)
    base.put(inner, "a", ScalarValue("str", "in a list"))
    meta = base.put_object("_root", "meta", ObjType.MAP)
    base.put(meta, "n", ScalarValue("counter", 0))
    base.put("_root", "n", ScalarValue("counter", 5))
    base.commit()
    forks = [base.fork(actor=ActorId(bytes([10 + i]) * 16))
             for i in range(rng.choice((5, 6)))]
    for rnd in range(rng.choice((2, 3))):
        for i, f in enumerate(forks):
            for _ in range(rng.randrange(6, 14)):
                _edit(f, rng, f"{i}.{rnd}:")
            f.commit()
        for f in forks:  # cross-merges: each fork takes one or two others
            for g in rng.sample(forks, rng.choice((1, 2))):
                if g is not f:
                    f.merge(g)
    return _blobs([base]), _blobs(forks)


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
