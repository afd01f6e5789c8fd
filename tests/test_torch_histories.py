"""The seeded random documents of the port's tests, written by the JAX
package's document API (``automerge_tpu.api``, which imports no JAX), so
that the tests run on the card without JAX can use them too.

``_history(seed)`` is (base change bytes, every change's bytes in causal
order) of a base document forked five or six ways, two or three rounds of
random edits on every fork with cross-merges between rounds: nested maps,
lists and text, objects inside lists, map and list deletes, conflicting
puts of shared keys, counters and increments, text marks; concurrent
inserts and deletes in several text objects.
"""

import functools
import random

from automerge_tpu.api import AutoDoc
from automerge_tpu.types import ActorId, ObjType, ScalarValue

KEYS = ("a", "b", "c", "title", "n")


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


def test_a_history_is_the_same_bytes_each_time():
    base, rest = _history.__wrapped__(3)
    assert (base, rest) == _history(3)
    assert len(rest) > len(base) and all(isinstance(b, bytes) for b in rest)
