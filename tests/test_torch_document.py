"""The port's document layer (``automerge_tpu_torch.api.AutoDoc`` over
``core/document.py``, ``core/transaction.py``, ``core/op_store.py``,
``core/marks.py``, ``patches/``) against the JAX package's, on the CPU.

Seeded (numpy) random sessions drive both packages' ``AutoDoc`` with the
same actor ids and timestamps: puts of every scalar type, list inserts
and deletes, counter increments, text splices, marks and unmarks, nested
objects, forks merged back, and manual transactions committed or rolled
back. The reference's ``AutoDoc`` runs with its native edit sessions on
(they write the same change bytes as the port's Python path). After every
commit the two must agree exactly: the change bytes, the heads,
``hydrate``, every text, ``get_all``, marks, cursors, ``diff`` and the
patch log's patches, at the current heads and at earlier ones. Saves are
byte for byte equal and each package loads the other's.
"""

import dataclasses
import enum

import numpy as np
import pytest

import automerge_tpu.api as RA
import automerge_tpu.types as RT
import automerge_tpu_torch.api as PA
import automerge_tpu_torch.types as PT
from automerge_tpu_torch.core.document import Document as PDocument
from automerge_tpu_torch.errors import AutomergeError

CHARS = "abcdefgh xyzé中\U0001f600"


def norm(x):
    """A value of either package as plain, comparable data."""
    if isinstance(x, enum.IntEnum):
        return int(x)  # a decoded action is an int in one package, an enum in the other
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if hasattr(x, "tag") and hasattr(x, "value") and hasattr(x, "to_py"):
        return ("scalar", x.tag, norm(x.value))
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    return x


class Pair:
    """The same calls on the reference's document and the port's."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port

    def both(self, name, *args, **kw):
        """Call ``name`` on both; they must return equal values or raise
        the same kind of error."""
        out = []
        for doc in (self.ref, self.port):
            try:
                out.append(("ok", norm(getattr(doc, name)(*args, **kw))))
            except (AutomergeError, ValueError, IndexError, KeyError) as e:
                out.append(("raised", type(e).__name__))
        assert out[0] == out[1], (name, args, out)
        return out[0][1]


def actor(pkg_types, n: int):
    return pkg_types.ActorId(bytes([n]) * 16)


def scalar(pkg_types, rng):
    kind = int(rng.integers(0, 9))
    if kind == 0:
        return int(rng.integers(-1000, 1000))
    if kind == 1:
        return "".join(rng.choice(list(CHARS), int(rng.integers(0, 6))))
    if kind == 2:
        return float(rng.integers(-50, 50)) / 4
    if kind == 3:
        return bool(rng.integers(0, 2))
    if kind == 4:
        return None
    if kind == 5:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 4))).astype(np.uint8))
    if kind == 6:
        return pkg_types.ScalarValue("uint", int(rng.integers(0, 1 << 40)))
    if kind == 7:
        return pkg_types.ScalarValue("timestamp", int(rng.integers(0, 1 << 40)))
    return pkg_types.ScalarValue("int", int(rng.integers(-5, 5)))


class Session:
    """A seeded random session over a pair of documents."""

    def __init__(self, seed: int, steps: int):
        self.rng = np.random.default_rng(seed)
        self.steps = steps
        self.ts = 0
        self.patches = ([], [])
        self.docs = Pair(RA.AutoDoc(actor(RT, 1)),
                         PA.AutoDoc(actor(PT, 1), device="cpu"))
        for i, doc in enumerate((self.docs.ref, self.docs.port)):
            doc.set_patch_callback(self.patches[i].append)
        self.texts, self.lists, self.maps = [], [], ["_root"]
        self.heads = []  # heads after each commit
        self.forks = 10

    # -- the observations after a commit -----------------------------------

    def check(self) -> None:
        d = self.docs
        heads = d.both("get_heads")
        assert [c.raw_bytes for c in d.ref.get_changes([])] == \
            [c.raw_bytes for c in d.port.get_changes([])]
        assert norm(self.patches[0]) == norm(self.patches[1])
        d.both("hydrate")
        for t in self.texts:
            d.both("text", t)
            d.both("marks", t)
            n = d.both("length", t)
            if n:
                pos = int(self.rng.integers(0, n))
                cur = d.both("get_cursor", t, pos)
                d.both("get_cursor_position", t, cur)
        for lst in self.lists:
            d.both("list_items", lst)
        for m in self.maps:
            for k in d.both("keys", m):
                d.both("get_all", m, k)
            d.both("map_entries", m)
        prev = self.heads[-1] if self.heads else []
        d.both("diff", prev, heads)
        if self.heads:
            old = self.heads[int(self.rng.integers(0, len(self.heads)))]
            d.both("hydrate", heads=old)
            d.both("diff", old, heads)
            for t in self.texts:
                d.both("text", t, heads=old)
                d.both("marks", t, heads=old)
        self.heads.append(heads)

    def commit(self) -> None:
        self.ts += 1
        self.docs.both("commit", timestamp=self.ts)
        self.check()

    # -- the edits -----------------------------------------------------------

    def pick(self, items):
        return items[int(self.rng.integers(0, len(items)))]

    def edit(self, docs: Pair) -> None:
        rng = self.rng
        kind = self.pick(["put", "put", "insert", "delete", "increment", "splice",
                          "splice", "mark", "object"])
        if kind == "put":
            v = scalar(RT, rng)
            pv = (PT.ScalarValue(v.tag, v.value) if isinstance(v, RT.ScalarValue)
                  else v)
            key = self.pick(["a", "b", "c", "né"])
            m = self.pick(self.maps)
            for doc, val in ((docs.ref, v), (docs.port, pv)):
                doc.put(m, key, val)
        elif kind == "insert" and self.lists:
            lst = self.pick(self.lists)
            n = docs.both("length", lst)
            docs.both("insert", lst, int(rng.integers(0, n + 1)),
                      int(rng.integers(0, 100)))
        elif kind == "delete":
            lst = self.pick(self.lists) if self.lists else None
            n = docs.both("length", lst) if lst else 0
            if n:
                docs.both("delete", lst, int(rng.integers(0, n)))
            else:
                docs.both("delete", self.pick(self.maps), self.pick(["a", "b"]))
        elif kind == "increment":
            docs.both("increment", "_root", "counter", int(rng.integers(-3, 10)))
        elif kind == "splice" and self.texts:
            t = self.pick(self.texts)
            n = docs.both("length", t)
            pos = int(rng.integers(0, n + 1))
            ndel = int(rng.integers(0, min(3, n - pos) + 1))
            ins = "".join(rng.choice(list(CHARS), int(rng.integers(0, 5))))
            docs.both("splice_text", t, pos, ndel, ins)
        elif kind == "mark" and self.texts:
            t = self.pick(self.texts)
            n = docs.both("length", t)
            if n >= 2:
                a = int(rng.integers(0, n - 1))
                b = int(rng.integers(a + 1, n + 1))
                name = self.pick(["bold", "link"])
                if rng.random() < 0.3:
                    docs.both("unmark", t, a, b, name)
                else:
                    docs.both("mark", t, a, b, name, self.pick([True, "x", 3]),
                              expand=self.pick(["before", "after", "both", "none"]))
        elif kind == "object":
            ot = self.pick(["MAP", "LIST", "TEXT"])
            if self.lists and rng.random() < 0.3:
                lst = self.pick(self.lists)
                at = int(rng.integers(0, docs.both("length", lst) + 1))
                ids = [d.insert_object(lst, at, getattr(T.ObjType, ot))
                       for d, T in ((docs.ref, RT), (docs.port, PT))]
            else:
                m = self.pick(self.maps)
                key = self.pick(["o1", "o2", "o3"])
                ids = [d.put_object(m, key, getattr(T.ObjType, ot))
                       for d, T in ((docs.ref, RT), (docs.port, PT))]
            assert ids[0] == ids[1]
            {"MAP": self.maps, "LIST": self.lists, "TEXT": self.texts}[ot].append(ids[0])

    def live(self, docs: Pair, objs):
        """The objects of ``objs`` still reachable in ``docs``' state."""
        keep = []
        for o in objs:
            try:
                docs.ref.object_type(o)
            except AutomergeError:
                continue
            keep.append(o)
        return keep

    def run(self) -> None:
        d = self.docs
        ids = [(doc.put_object("_root", "text", T.ObjType.TEXT),
                doc.put_object("_root", "list", T.ObjType.LIST))
               for doc, T in ((d.ref, RT), (d.port, PT))]
        assert ids[0] == ids[1]
        self.texts.append(ids[0][0])
        self.lists.append(ids[0][1])
        d.ref.put("_root", "counter", RT.ScalarValue("counter", 0))
        d.port.put("_root", "counter", PT.ScalarValue("counter", 0))
        d.both("splice_text", self.texts[0], 0, 0, "hello world")
        self.commit()
        for step in range(self.steps):
            r = self.rng.random()
            if r < 0.08:
                self.fork_and_merge()
            elif r < 0.14:
                self.manual_transaction()
            else:
                self.edit(d)
                if self.rng.random() < 0.35:
                    self.commit()
            self.texts = self.live(d, self.texts)
            self.lists = self.live(d, self.lists)
            self.maps = ["_root"] + self.live(d, self.maps[1:])
        self.commit()

    def fork_and_merge(self) -> None:
        """A fork edited concurrently with the document, merged back. Each
        side edits only the objects it knows (what existed at the fork and
        what it made itself)."""
        self.forks += 1
        f = Pair(self.docs.ref.fork(actor(RT, self.forks)),
                 self.docs.port.fork(actor(PT, self.forks)))
        known = (list(self.texts), list(self.lists), list(self.maps))
        for _ in range(int(self.rng.integers(0, 3))):
            self.edit(self.docs)
        after = (self.texts, self.lists, self.maps)
        self.texts, self.lists, self.maps = known
        for _ in range(int(self.rng.integers(1, 4))):
            self.edit(f)
        self.ts += 1
        f.both("commit", timestamp=self.ts)
        self.texts, self.lists, self.maps = (
            a + [o for o in k if o not in a] for a, k in zip(after, known))
        heads = [self.docs.ref.merge(f.ref), self.docs.port.merge(f.port)]
        assert heads[0] == heads[1]
        self.check()

    def manual_transaction(self) -> None:
        d = self.docs
        if d.ref.pending_ops():
            self.commit()
        txs = Pair(d.ref.transaction(timestamp=self.ts + 1),
                   d.port.transaction(timestamp=self.ts + 1))
        key = self.pick(["a", "tx"])
        txs.both("put", "_root", key, int(self.rng.integers(0, 9)))
        if self.texts:
            txs.both("splice_text", self.texts[0], 0, 0, "tx")
            txs.both("text", self.texts[0])
        txs.both("get", "_root", key)
        txs.both("pending_ops")
        if self.rng.random() < 0.5:
            txs.both("rollback")
            d.both("hydrate")
        else:
            self.ts += 1
            txs.both("commit")
            self.check()


@pytest.mark.parametrize("seed", range(6))
def test_seeded_session_equals_the_reference(seed):
    s = Session(seed, 70)
    s.run()
    d = s.docs
    saved = (d.ref.save(), d.port.save())
    assert saved[0] == saved[1]
    assert d.ref.save(deflate=False) == d.port.save(deflate=False)
    port_loaded = PA.AutoDoc.load(saved[0], device="cpu")
    ref_loaded = RA.AutoDoc.load(saved[1])
    assert norm(port_loaded.hydrate()) == norm(d.ref.hydrate())
    assert port_loaded.get_heads() == d.ref.get_heads()
    assert ref_loaded.save() == port_loaded.save() == saved[0]
    # an incremental save after the first heads loads the same state
    inc = [doc.save_incremental_after(s.heads[0]) for doc in (d.ref, d.port)]
    assert inc[0] == inc[1]


def test_text_encodings_and_isolation_equal_the_reference():
    """A utf16 document's widths, and edits isolated at old heads."""
    for enc in ("utf16", "utf8"):
        d = Pair(RA.AutoDoc(actor(RT, 2), text_encoding=enc),
                 PA.AutoDoc(actor(PT, 2), text_encoding=enc, device="cpu"))
        ids = [doc.put_object("_root", "t", T.ObjType.TEXT)
               for doc, T in ((d.ref, RT), (d.port, PT))]
        t = ids[0]
        d.both("splice_text", t, 0, 0, "a\U0001f600béc")
        d.both("commit", timestamp=1)
        h = d.both("get_heads")
        d.both("splice_text", t, 1, 2, "Z")
        d.both("commit", timestamp=2)
        d.both("isolate", list(h))
        d.both("splice_text", t, 0, 0, "iso")
        d.both("text", t)
        d.both("commit", timestamp=3)
        d.both("integrate")
        d.both("text", t)
        d.both("length", t)
        d.both("marks", t)
        assert d.ref.save() == d.port.save()


def test_document_api_equals_the_reference_on_loaded_fixtures():
    """Document-level surface: fork_at, get_missing_deps, the causal queue,
    salvage loads and string migration."""
    d = Pair(RA.AutoDoc(actor(RT, 3)), PA.AutoDoc(actor(PT, 3), device="cpu"))
    d.both("put", "_root", "s", "text as a scalar")
    d.both("commit", timestamp=1)
    h1 = d.both("get_heads")
    d.both("put", "_root", "n", 5)
    d.both("commit", timestamp=2)
    forks = Pair(d.ref.fork_at(list(h1), actor(RT, 4)),
                 d.port.fork_at(list(h1), actor(PT, 4)))
    forks.both("hydrate")
    assert forks.port.doc.device == d.port.doc.device
    changes = [c.raw_bytes for c in d.ref.get_changes([])]
    from automerge_tpu.storage.change import parse_change as rparse
    from automerge_tpu_torch.storage.change import parse_change as pparse

    q = Pair(RA.AutoDoc(actor(RT, 5)), PA.AutoDoc(actor(PT, 5), device="cpu"))
    q.ref.apply_changes([rparse(changes[1])[0]])
    q.port.apply_changes([pparse(changes[1])[0]])
    q.both("get_missing_deps")
    q.ref.apply_changes([rparse(changes[0])[0]])
    q.port.apply_changes([pparse(changes[0])[0]])
    q.both("hydrate")
    data = d.ref.save()
    damaged = data[:-3] + bytes([data[-3] ^ 0xFF]) + data[-2:] + changes[0]
    loads = [pkg.AutoDoc.load(damaged, on_error="salvage", **kw)
             for pkg, kw in ((RA, {}), (PA, {"device": "cpu"}))]
    assert norm(loads[0].hydrate()) == norm(loads[1].hydrate())
    assert loads[0].salvage_report.summary() == loads[1].salvage_report.summary()
    mig = [pkg.AutoDoc.load(data, string_migration="convert_to_text", **kw)
           for pkg, kw in ((RA, {}), (PA, {"device": "cpu"}))]
    assert norm(mig[0].hydrate()) == norm(mig[1].hydrate())


def test_fork_and_load_keep_the_device():
    doc = PA.AutoDoc(actor(PT, 6), device="cpu")
    doc.put("_root", "x", 1)
    assert doc.fork().doc.device.type == "cpu"
    assert doc.fork_at(doc.get_heads()).doc.device.type == "cpu"
    assert PA.AutoDoc.load(doc.save(), device="cpu").doc.device.type == "cpu"
    assert PDocument(device="cpu").fork().device.type == "cpu"
