"""The port's native edit sessions (``native/session.cpp``,
``native/map_session.cpp``, ``native/fastcall.c`` and their wiring in
``core/transaction.py`` and ``api.py``) against the JAX package's.

Every script runs on three documents: the JAX package's ``AutoDoc``
(sessions on), the port's (sessions on) and the port's with the sessions
off (its Python path). After every commit the three hold the same change
bytes, and every call returns the same value or raises the same error.
The cases are those of ``tests/test_edit_session.py``,
``tests/test_fast_splice.py`` and ``tests/test_map_session.py``, and
seeded mixed typing (multi-codepoint text, deletes, the three text
encodings, reads between splices, rollback). A session commit of more
than ``SMALL_TAIL_OPS`` ops leaves the op store stale; its first read
rebuilds it through one merge on the document's device. Without g++ (or
gcc for the fastcall extension) the sessions raise ``NativeUnavailable``.
"""

import random
import shutil

import pytest

import automerge_tpu.api as RA
import automerge_tpu.types as RT
import automerge_tpu_torch.api as PA
import automerge_tpu_torch.types as PT
from automerge_tpu_torch import native as PN
from automerge_tpu_torch.core.transaction import Transaction as PTransaction

from .test_torch_document import norm


class PlainDoc(PA.AutoDoc):
    """The port's AutoDoc with its sessions off: every transaction takes
    the Python path."""

    def _ensure_tx(self):
        tx = super()._ensure_tx()
        tx.enable_sessions = False
        return tx


class RefPlainDoc(RA.AutoDoc):
    """The JAX package's AutoDoc with its sessions off."""

    def _ensure_tx(self):
        tx = super()._ensure_tx()
        tx.enable_sessions = False
        return tx


KINDS = ("ref", "port", "plain")


@pytest.fixture(autouse=True)
def _fresh_reference_cache():
    """The JAX package's per-change column cache keeps the key table of
    whatever batch first decoded a change (ROADMAP §3): start empty."""
    import automerge_tpu.ops.extract as RX

    if RX._CHANGE_COLS_CACHE is not None:
        RX._CHANGE_COLS_CACHE.clear()
    yield


@pytest.fixture
def encoding(request):
    """Set both packages' text encoding for the test, then restore it."""
    enc = getattr(request, "param", "unicode")
    RT.set_text_encoding(enc)
    PT.set_text_encoding(enc)
    yield enc
    RT.set_text_encoding("unicode")
    PT.set_text_encoding("unicode")


def _arg(kind, x):
    """A ScalarValue argument in the package of ``kind``."""
    if isinstance(x, (RT.ScalarValue, PT.ScalarValue)):
        return (RT if kind == "ref" else PT).ScalarValue(x.tag, x.value)
    if isinstance(x, (RT.ObjType, PT.ObjType)):
        return (RT if kind == "ref" else PT).ObjType[x.name]
    return x


def _outcome(fn):
    try:
        return ("ok", norm(fn()))
    except Exception as e:  # noqa: BLE001 — compared across the three
        return ("raised", type(e).__name__, str(e))


def assert_same(outs, what=None):
    """The port's sessions answer as the reference's, word for word; its
    Python path alike, bar an error's wording (the reference's sessions
    and its Python path word an out-of-bounds splice differently too).
    With a ``ref_plain`` entry (the reference's Python path), each path is
    held only to its counterpart in the reference."""
    assert outs["port"] == outs["ref"], (what, outs)
    other = outs.get("ref_plain", outs["ref"])
    assert outs["plain"][:2] == other[:2], (what, outs)
    if other[0] == "ok":
        assert outs["plain"] == other, (what, outs)


class Trio:
    """The same calls on the three documents; equal answers after each."""

    def __init__(self, actor=1, by_path=False):
        a = bytes([actor]) * 16
        self.docs = {
            "ref": RA.AutoDoc(actor=RT.ActorId(a)),
            "port": PA.AutoDoc(actor=PT.ActorId(a), device="cpu"),
            "plain": PlainDoc(actor=PT.ActorId(a), device="cpu"),
        }
        if by_path:
            self.docs["ref_plain"] = RefPlainDoc(actor=RT.ActorId(a))

    @classmethod
    def wrap(cls, docs):
        t = cls.__new__(cls)
        t.docs = docs
        return t

    def __getattr__(self, name):
        def call(*args, **kw):
            outs = {
                k: _outcome(lambda d=d, k=k: getattr(d, name)(
                    *[_arg(k, a) for a in args],
                    **{n: _arg(k, v) for n, v in kw.items()}))
                for k, d in self.docs.items()
            }
            assert_same(outs, (name, args))
            if outs["ref"][0] == "raised":
                raise AssertionError(f"{name}{args} raised in all three: {outs['ref']}")
            return outs["ref"][1]
        return call

    def raises(self, name, *args):
        """``name(*args)`` raises the same error in all three."""
        outs = {k: _outcome(lambda d=d: getattr(d, name)(*args))
                for k, d in self.docs.items()}
        assert outs["ref"][0] == "raised", outs
        assert_same(outs, (name, args))
        return outs["ref"]

    def _same(self, vals):
        assert vals["port"] == vals["ref"]
        assert vals["plain"] == vals.get("ref_plain", vals["ref"])

    def commit(self, **kw):
        kw.setdefault("timestamp", 7)
        hashes = {k: d.commit(**kw) for k, d in self.docs.items()}
        self._same(hashes)
        self.same_changes()
        return hashes["ref"]

    def same_changes(self):
        self._same({k: [c.raw_bytes for c in d.get_changes([])]
                    for k, d in self.docs.items()})

    def same_save(self):
        saves = {k: d.save() for k, d in self.docs.items()}
        self._same(saves)
        return saves["port"]

    def fork(self, actor):
        a = bytes([actor]) * 16
        forks = {k: d.fork(actor=(RT if k.startswith("ref") else PT).ActorId(a))
                 for k, d in self.docs.items()}
        # a fork is a plain AutoDoc: keep the Python path
        forks["plain"].__class__ = PlainDoc
        if "ref_plain" in forks:
            forks["ref_plain"].__class__ = RefPlainDoc
        return Trio.wrap(forks)

    def merge(self, other):
        return norm_equal({k: d.merge(other.docs[k]) for k, d in self.docs.items()})

    def sessions(self, kind="port"):
        tx = self.docs[kind]._tx
        return (0, 0) if tx is None else (len(tx._sessions), len(tx._msessions))


def norm_equal(outs):
    vals = {k: norm(v) for k, v in outs.items()}
    assert vals["port"] == vals["ref"] == vals["plain"], vals
    return vals["ref"]


def text_trio(actor=1, by_path=False):
    t = Trio(actor, by_path)
    obj = t.put_object("_root", "t", PT.ObjType.TEXT)
    return t, obj


# -- tests/test_edit_session.py -----------------------------------------------


def test_session_matches_python_randomized():
    rng = random.Random(7)
    t, o = text_trio()
    ln = 0
    for _ in range(400):
        if ln == 0 or rng.random() < 0.7:
            pos = rng.randint(0, ln)
            txt = chr(rng.randint(97, 122)) * rng.randint(1, 3)
            t.splice_text(o, pos, 0, txt)
            ln += len(txt)
        else:
            pos = rng.randint(0, ln - 1)
            nd = min(rng.randint(1, 3), ln - pos)
            t.splice_text(o, pos, nd, "")
            ln -= nd
    assert t.sessions() == (1, 0) and t.sessions("plain") == (0, 0)
    t.commit()
    t.text(o)
    t.same_save()


def test_mid_transaction_read_drains():
    t, o = text_trio()
    t.splice_text(o, 0, 0, "hello")
    assert t.text(o) == "hello"
    t.splice_text(o, 5, 0, " world")
    t.commit()
    assert t.text(o) == "hello world"


def test_mixed_ops_same_transaction():
    t, o = text_trio()
    t.splice_text(o, 0, 0, "abc")
    t.put("_root", "k", 1)
    t.splice_text(o, 2, 1, "XY")
    t.commit()
    assert t.text(o) == "abXY"
    t.hydrate()


def test_length_fast_path_and_clamping():
    t, o = text_trio()
    t.splice_text(o, 0, 0, "abcdef")
    assert t.length(o) == 6
    t.splice_text(o, 2, 2, "")
    assert t.length(o) == 4
    t.commit()
    assert t.text(o) == "abef"


@pytest.mark.parametrize("encoding", ["utf16"], indirect=True)
def test_unicode_widths_utf16(encoding):
    t, o = text_trio()
    t.splice_text(o, 0, 0, "a\U0001F600b")
    assert t.length(o) == 4
    t.splice_text(o, 1, 2, "X")
    t.commit()
    assert t.text(o) == "aXb"


def test_marked_object_falls_back():
    t, o = text_trio()
    t.splice_text(o, 0, 0, "hello world")
    t.mark(o, 0, 5, "bold", True)
    t.commit()
    t.splice_text(o, 5, 0, "!")
    assert t.sessions() == (0, 0)
    t.commit()
    t.marks(o)


def test_conflicted_element_falls_back():
    t = Trio(1)
    o = t.put_object("_root", "lst", PT.ObjType.TEXT)
    t.splice_text(o, 0, 0, "x")
    t.commit()
    f = t.fork(2)
    t.put(o, 0, "A")
    f.put(o, 0, "B")
    t.commit()
    f.commit()
    t.merge(f)
    assert len(t.get_all(o, 0)) == 2
    t.splice_text(o, 1, 0, "z")
    assert t.sessions() == (0, 0)
    t.commit()
    assert t.length(o) == 2


def test_rollback_discards_session_ops():
    t, o = text_trio()
    t.splice_text(o, 0, 0, "keep")
    t.commit()
    t.splice_text(o, 4, 0, " DISCARD")
    assert t.rollback() == 8
    assert t.text(o) == "keep"
    assert norm_equal({k: d.doc.max_op for k, d in t.docs.items()}) == 5
    t.same_save()


def test_batch_ingest_matches_per_edit():
    rng = random.Random(11)
    edits, ln = [], 0
    for _ in range(500):
        if ln == 0 or rng.random() < 0.8:
            edits.append([rng.randint(0, ln + 2), 0, chr(rng.randint(97, 122))])
            ln += 1
        else:
            edits.append([rng.randint(0, ln), 2])
            ln = max(ln - 2, 0)
    t, o = text_trio()
    t.splice_text_many(o, edits)
    t.commit()
    per_edit, o2 = text_trio()
    for pos, nd, *txt in edits:
        n = per_edit.length(o2)
        pos = min(pos, n)
        per_edit.splice_text(o2, pos, min(nd, n - pos), "".join(txt))
    per_edit.commit()
    assert t.text(o) == per_edit.text(o2)
    assert t.same_save() == per_edit.same_save()


def test_session_change_loads_and_merges():
    t, o = text_trio()
    t.splice_text(o, 0, 0, "the quick fox")
    t.splice_text(o, 4, 5, "slow")
    t.commit()
    data = t.same_save()
    loaded = Trio.wrap({
        "ref": RA.AutoDoc.load(data),
        "port": PA.AutoDoc.load(data, device="cpu"),
        "plain": PlainDoc.load(data, device="cpu"),
    })
    assert loaded.text(o) == "the slow fox"
    c = loaded.fork(3)
    c.splice_text(o, 0, 3, "one")
    c.commit()
    t.merge(c)
    assert t.text(o) == c.text(o)
    t.same_save()


def test_mixed_session_and_ineligible_object_ordering():
    t = Trio(1)
    ta = t.put_object("_root", "a", PT.ObjType.TEXT)
    tb = t.put_object("_root", "b", PT.ObjType.TEXT)
    t.splice_text(tb, 0, 0, "ze")
    t.mark(tb, 0, 1, "bold", True)
    t.commit()
    t.splice_text(ta, 0, 0, "hello")
    t.splice_text(tb, 1, 0, "Q")
    t.splice_text(ta, 5, 0, "!")
    t.commit()
    assert (t.text(ta), t.text(tb)) == ("hello!", "zQe")
    back = PA.AutoDoc.load(t.same_save(), device="cpu")
    assert (back.text(ta), back.text(tb)) == ("hello!", "zQe")


@pytest.mark.parametrize("encoding", ["utf16"], indirect=True)
def test_batch_fallback_width_clamping_utf16(encoding):
    edits = [(0, 0, "\U0001F389" * 3), (6, 0, "end"), (2, 4, ""), (5, 9, "tail")]
    t, o = text_trio()
    t.splice_text_many(o, edits)
    t.commit()
    t.text(o)


def test_session_survives_reads():
    t, o = text_trio()
    for i in range(20):
        t.splice_text(o, i, 0, "x")
        assert t.text(o) == "x" * (i + 1)
    for kind in ("ref", "port"):
        ent = next(iter(t.docs[kind]._tx._sessions.values()))
        assert ent[0].op_count() == 20 and ent[1] == 20
    t.splice_text(o, 0, 5, "Y")
    t.commit()
    assert t.text(o) == "Y" + "x" * 15


# -- tests/test_fast_splice.py ------------------------------------------------


def test_fast_path_interleaved_with_reads():
    t, o = text_trio()
    t.splice_text(o, 0, 0, "hello")
    assert t.text(o) == "hello"
    t.splice_text(o, 5, 0, " world")
    t.splice_text(o, 0, 1, "H")
    assert t.text(o) == "Hello world"
    assert t.docs["port"]._splice_cache is not None
    t.commit()


def test_fast_path_survives_python_mutation_between_splices():
    t, o = text_trio()
    t.splice_text(o, 0, 0, "abc")
    t.put("_root", "k", 1)
    t.splice_text(o, 3, 0, "def")
    assert t.text(o) == "abcdef"
    t.hydrate()
    t.commit()


def test_fast_path_across_commits():
    t, o = text_trio()
    for i in range(5):
        t.splice_text(o, t.length(o), 0, f"x{i}")
        t.commit()
    assert t.text(o) == "x0x1x2x3x4"
    assert PA.AutoDoc.load(t.same_save(), device="cpu").text(o) == "x0x1x2x3x4"


def test_fast_path_non_ascii_widths():
    t, o = text_trio()
    t.splice_text(o, 0, 0, "aé中\U0001f600b")
    t.splice_text(o, 2, 1, "z")
    assert t.text(o) == "aéz\U0001f600b"
    t.commit()


def test_fast_path_out_of_bounds_raises():
    t, o = text_trio()
    t.splice_text(o, 0, 0, "abc")
    assert t.raises("splice_text", o, 99, 0, "x")[1] == "AutomergeError"
    t.splice_text(o, 3, 0, "d")
    assert t.text(o) == "abcd"
    t.commit()


def test_delete_past_the_end_commits_as_the_reference_does():
    """A delete past the end raises after deleting what it could; what the
    transaction then commits differs between the reference's sessions and
    its Python path (ROADMAP §3). Each of the port's paths commits its
    counterpart's bytes."""
    t, o = text_trio(by_path=True)
    t.splice_text(o, 0, 0, "abcd")
    assert t.raises("splice_text", o, 1, 9, "")[1] == "AutomergeError"
    t.splice_text(o, t.length(o), 0, "e")
    assert t.text(o) == "ae"
    t.commit()


def test_fastcall_module_loads_under_its_own_name():
    """The port's extension and the JAX package's load side by side."""
    from automerge_tpu import native as RN

    fc = PN.fastcall()
    assert fc.__name__ == "amt_fastcall" and hasattr(fc, "splice") and hasattr(fc, "map_put")
    rfc = RN.fastcall()
    assert rfc is not None and rfc.__name__ == "am_fastcall" and rfc is not fc
    assert PN.fastcall() is fc


def test_fast_path_differential_vs_batch():
    rng = random.Random(42)
    edits, ln = [], 0
    for _ in range(2000):
        if ln == 0 or rng.random() < 0.7:
            edits.append([rng.randint(0, ln), 0, chr(97 + rng.randint(0, 25))])
            ln += 1
        else:
            edits.append([rng.randint(0, ln - 1), 1])
            ln -= 1
    a, ta = text_trio()
    for e in edits:
        a.splice_text(ta, e[0], e[1], "".join(e[2:]))
    a.commit()
    b, tb = text_trio()
    b.splice_text_many(tb, edits, clamp=False)
    b.commit()
    assert a.text(ta) == b.text(tb)
    assert a.same_save() == b.same_save()


# -- tests/test_map_session.py ------------------------------------------------


SCALARS = [7, -12345, "héllo \U0001f680", 2.5, True, False, None, b"\x00\xff"]


def test_all_scalar_kinds_byte_identical():
    t = Trio(21)
    for i, v in enumerate(SCALARS):
        t.put("_root", f"k{i}", v)
    assert t.sessions() == (0, 1) and t.sessions("plain") == (0, 0)
    t.commit()
    assert t.hydrate()["k1"] == -12345


def test_overwrites_set_pred_chain():
    t = Trio(21)
    for v in (1, 2, "three"):
        t.put("_root", "k", v)
    t.commit()
    assert t.hydrate() == {"k": "three"}
    back = PA.AutoDoc.load(t.same_save(), device="cpu")
    assert norm(back.get_all("_root", "k")) == t.get_all("_root", "k")


def test_preloaded_winners_cross_commit():
    t = Trio(22)
    for i in range(20):
        t.put("_root", f"k{i}", i)
    t.commit()
    for i in range(0, 20, 2):
        t.put("_root", f"k{i}", i * 100)
    t.commit()
    t.hydrate()


def test_nested_map_session():
    t = Trio(23)
    m = t.put_object("_root", "m", PT.ObjType.MAP)
    t.commit()
    for i in range(100):
        t.put(m, f"x{i}", i)
    t.commit()
    assert t.hydrate()["m"]["x42"] == 42


@pytest.mark.filterwarnings("ignore:.*(log assembly|extraction|native save).*:RuntimeWarning")
def test_ineligible_values_fall_back():
    t = Trio(21)
    t.put("_root", "a", 1)
    t.put("_root", "c", PT.ScalarValue("counter", 5))
    t.put("_root", "u", PT.ScalarValue("uint", 3))
    t.put("_root", "b", 2)
    t.commit()
    t.increment("_root", "c", 2)
    t.commit()
    assert t.hydrate()["c"] == 7


def test_empty_key_raises():
    t = Trio(24)
    t.put("_root", "ok", 1)
    assert "empty" in t.raises("put", "_root", "", 2)[2]
    t.commit()


def test_conflicted_key_uses_python_path():
    t = Trio(1)
    t.put("_root", "k", "a")
    t.commit()
    f = t.fork(2)
    f.put("_root", "k", "b")
    f.commit()
    t.put("_root", "k", "a2")
    t.commit()
    t.merge(f)
    assert len(t.get_all("_root", "k")) == 2
    t.put("_root", "k", "resolved")
    t.commit()
    assert len(t.get_all("_root", "k")) == 1


def test_interleaved_map_and_text_sessions():
    t = Trio(25)
    o = t.put_object("_root", "t", PT.ObjType.TEXT)
    t.commit()
    t.splice_text(o, 0, 0, "ab")
    t.put("_root", "k1", 1)
    t.splice_text(o, 2, 0, "cd")
    t.put("_root", "k2", 2)
    t.commit()
    assert t.text(o) == "abcd"
    t.hydrate()


def test_reads_mid_transaction_drain():
    t = Trio(26)
    t.put("_root", "k", 1)
    t.get("_root", "k")
    t.put("_root", "k", 2)
    assert list(t.keys()) == ["k"]
    t.commit()
    assert t.hydrate() == {"k": 2}


def test_map_rollback_discards_session_ops():
    t = Trio(27)
    t.put("_root", "keep", 1)
    t.commit()
    t.put("_root", "drop", 2)
    t.rollback()
    assert t.hydrate() == {"keep": 1}
    t.same_save()


def test_observer_patches_cover_session_ops():
    seen = {k: [] for k in KINDS}
    t = Trio(28)
    for k, d in t.docs.items():
        d.set_patch_callback(lambda ps, k=k: seen[k].extend(ps))
    for i in range(5):
        t.put("_root", f"k{i}", i)
    t.commit()
    assert len(seen["port"]) == 5
    assert norm(seen["port"]) == norm(seen["ref"]) == norm(seen["plain"])


def test_merge_convergence_with_session_changes():
    t = Trio(3)
    for i in range(200):
        t.put("_root", f"k{i:03}", i)
    t.commit()
    b = t.fork(4)
    for i in range(0, 200, 3):
        b.put("_root", f"k{i:03}", -i)
    b.commit()
    for i in range(0, 200, 5):
        t.put("_root", f"k{i:03}", i * 7)
    t.commit()
    c = t.fork(5)
    t.merge(b)
    b.merge(c)
    assert t.hydrate() == b.hydrate()
    t.same_save()


@pytest.mark.filterwarnings("ignore:.*(log assembly|extraction|native save).*:RuntimeWarning")
def test_randomized_map_differential():
    rng = random.Random(99)
    vals = [None, True, False, 0, 1, -1, 2**40, -(2**40), 1.5, "", "x",
            "é\U0001f680", b"", b"\x00", PT.ScalarValue("counter", 1)]
    t = Trio(29)
    for i in range(300):
        t.put("_root", f"k{rng.randrange(40):02}", rng.choice(vals))
        if i % 75 == 74:
            t.commit()
    t.commit()
    t.same_save()


# -- seeded mixed typing --------------------------------------------------------

ALPHABET = "abcdefgh éü中\U0001f600\U0001f389"


def _boundaries(text):
    """The width offsets at which a character of ``text`` starts, and its end."""
    from automerge_tpu_torch.types import str_width

    out, w = [0], 0
    for c in text:
        w += str_width(c)
        out.append(w)
    return out


@pytest.mark.parametrize("encoding", ["unicode", "utf16", "utf8"], indirect=True)
@pytest.mark.parametrize("positions", ["boundary", "any"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_mixed_typing(encoding, positions, seed):
    """Splices of one to four code points of mixed widths, deletes, reads
    between splices, map puts, rollbacks and commits, in width units of
    each encoding: equal change bytes after every commit. At character
    boundaries the three documents agree. A position inside a wide
    character (``any``, utf8 and utf16) is where the reference's sessions
    and its Python path part (ROADMAP §3): there the port's sessions equal
    the reference's and its Python path the reference's Python path."""
    from automerge_tpu_torch.types import str_width

    rng = random.Random(seed)
    t, o = text_trio(seed + 40, by_path=positions == "any")
    for step in range(600):
        n = t.length(o)
        r = rng.random()
        cuts = (list(range(n + 1)) if positions == "any"
                else _boundaries(t.docs["port"].text(o)))
        if r < 0.55 or n == 0:
            txt = "".join(rng.choice(ALPHABET) for _ in range(rng.randint(1, 4)))
            pos = rng.choice(cuts)
            assert_same({k: _outcome(lambda d=d: d.splice_text(o, pos, 0, txt))
                         for k, d in t.docs.items()})
        elif r < 0.8:
            pos = rng.choice(cuts[:-1])
            ends = [c for c in cuts if pos < c <= pos + 4] or [n]
            nd = rng.choice(ends) - pos
            assert_same({k: _outcome(lambda d=d: d.splice_text(o, pos, nd, ""))
                         for k, d in t.docs.items()})
        elif r < 0.88:
            t.text(o)
        elif r < 0.93:
            t.put("_root", f"m{rng.randrange(6)}", rng.randrange(100))
        elif r < 0.95:
            t.rollback()
        else:
            t.commit()
        if step % 97 == 96:
            t.commit()
    t.commit()
    text = t.text(o)
    assert sum(str_width(c) for c in text) == t.length(o)
    t.same_save()


# -- the stale read and rebuild after a large session commit -------------------


def test_large_session_commit_rebuilds_through_one_merge(monkeypatch):
    """A commit of more than SMALL_TAIL_OPS session ops exports from arrays
    and leaves the op store stale; the first read runs one merge on the
    document's device and equals the reference's and the Python path's.
    The next transaction types on the session that commit kept, so the
    store stays stale until a read drains it, and the rebuild then reuses
    that one merge."""
    from automerge_tpu_torch.ops import merge as M

    calls = []
    real = M.merge_columns
    monkeypatch.setattr(M, "merge_columns",
                        lambda *a, **k: calls.append(k.get("device")) or real(*a, **k))
    rng = random.Random(5)
    t, o = text_trio(9)
    t.commit()
    text = ""
    for rnd in range(3):
        for _ in range(PTransaction.SMALL_TAIL_OPS + 50):
            pos = rng.randint(0, len(text))
            ch = rng.choice("abcdef")
            t.splice_text(o, pos, 0, ch)
            text = text[:pos] + ch + text[pos:]
        calls.clear()
        t.commit()
        port = t.docs["port"].doc
        assert port._ops_stale and not t.docs["plain"].doc._ops_stale
        assert t.text(o) == text
        assert len(calls) == 1 and str(calls[0]) == "cpu"
        t.splice_text(o, 0, 0, "!")
        text = "!" + text
        assert len(calls) == 1 and port._ops_stale
        assert t.text(o) == text
        assert len(calls) == 1 and not port._ops_stale
    t.commit()
    t.same_save()


def _kept(t):
    """The text session the port's last commit kept, or None."""
    carry = t.docs["port"].doc._session_carry
    return None if carry is None else carry[1]


def _held(t):
    """The port's live transaction's text sessions, as a list."""
    tx = t.docs["port"]._tx
    return [] if tx is None else [ent[0] for ent in tx._sessions.values()]


@pytest.mark.parametrize("tail", [PTransaction.SMALL_TAIL_OPS + 50, 40])
def test_typing_across_commits_keeps_its_session(monkeypatch, tail):
    """Each commit keeps its text session for the next transaction: typing
    on across commits runs no merge and leaves a stale store stale (a large
    tail) or a live store live (a small one), the change bytes equal after
    every commit, and the first read rebuilds from one merge."""
    from automerge_tpu_torch.ops import merge as M

    calls = []
    real = M.merge_columns
    monkeypatch.setattr(M, "merge_columns",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = random.Random(tail)
    t, o = text_trio(11)
    t.splice_text(o, 0, 0, "x" * 2000)  # a small tail is < 1/4 of the document
    t.commit()
    port = t.docs["port"].doc
    text = "x" * 2000
    stale = port._ops_stale
    for rnd in range(4):
        kept = _kept(t)
        assert kept is not None
        for _ in range(tail):
            pos = rng.randint(0, len(text))
            ch = rng.choice("ab\u00e9\U0001f680")
            t.splice_text(o, pos, 0, ch)
            text = text[:pos] + ch + text[pos:]
            if rng.random() < 0.2 and len(text) > pos + 1:
                t.splice_text(o, pos, 1, "")
                text = text[:pos] + text[pos + 1:]
        assert _held(t) == [kept] and calls == []
        t.commit()
        assert port._ops_stale == (stale or tail > PTransaction.SMALL_TAIL_OPS)
    assert t.text(o) == text
    assert len(calls) == (1 if port._ops_stale or tail > PTransaction.SMALL_TAIL_OPS else 0)
    t.same_save()


def _changed_by_merge(t, o):
    f = t.fork(40)
    f.splice_text(o, 0, 0, "F")
    f.commit()
    t.merge(f)


def _changed_by_actor(t, o):
    for k, d in t.docs.items():
        d.set_actor((RT if k.startswith("ref") else PT).ActorId(bytes([41]) * 16))


def _changed_by_rollback(t, o):
    t.splice_text(o, 0, 0, "gone")
    t.rollback()


def _changed_by_mark(t, o):
    t.mark(o, 0, 2, "bold", True)
    t.commit()


def _changed_by_encoding(t, o):
    RT.set_text_encoding("utf16")
    PT.set_text_encoding("utf16")


@pytest.mark.parametrize("change", [
    _changed_by_merge, _changed_by_actor, _changed_by_rollback,
    _changed_by_mark, _changed_by_encoding,
], ids=lambda f: f.__name__[len("_changed_by_"):])
def test_a_kept_session_goes_when_the_document_changed(encoding, change):
    """A merge, another actor, a rollback of the transaction that took the
    session over, a per-op mutation or another text encoding: the next
    transaction builds its session afresh (or none, past a mark), and the
    change bytes still equal the reference's, path by path."""
    t, o = text_trio(12, by_path=True)
    t.splice_text(o, 0, 0, "h\U0001f680llo wor\u00e9ld")
    t.commit()
    kept = _kept(t)
    assert kept is not None
    change(t, o)
    t.splice_text(o, 3, 1, "Z\U0001f600")
    assert kept not in _held(t)
    t.commit()
    assert t.text(o) == t.docs["ref"].text(o)
    t.same_save()


def test_a_put_after_per_op_rows_takes_the_per_op_path():
    """The record store's pattern (a map made per record, then its fields):
    a put into a new map after per-op rows in the same commit takes the
    per-op path, whose change bytes are the sessions' (the commit would
    drain a session through that path anyway); a put with none does not."""
    t = Trio(13)
    records = t.put_object("_root", "records", PT.ObjType.MAP)
    for r in range(3):
        rec = t.put_object(records, f"r{r}", PT.ObjType.MAP)
        for f in range(4):
            t.put(rec, f"f{f}", r * 10 + f)
        assert t.sessions() == (0, 0)
    t.commit()
    for f in range(4):
        t.put("_root", f"g{f}", f)
    assert t.sessions() == (0, 1)
    t.commit()
    t.same_save()


# -- no native library: no silent Python path ----------------------------------


def test_no_gxx_raises_native_unavailable(monkeypatch, tmp_path):
    """Without g++ and with an empty build directory, the first splice or
    put of an AutoDoc raises ``NativeUnavailable``: no silent Python path."""
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "_fastcall", None)
    monkeypatch.setattr(PN, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)
    d = PA.AutoDoc(actor=PT.ActorId(b"\x01" * 16), device="cpu")
    with pytest.raises(PN.NativeUnavailable, match="g\\+\\+ not found"):
        d.put("_root", "k", 1)
    d.rollback()
    with pytest.raises(PN.NativeUnavailable, match="g\\+\\+ not found"):
        d.splice_text(d.put_object("_root", "t", PT.ObjType.TEXT), 0, 0, "x")
    assert not list(tmp_path.iterdir())


def test_no_gcc_for_fastcall_raises_native_unavailable(monkeypatch, tmp_path):
    """With the library built but no gcc for the fastcall extension, a put
    or a splice through the sessions raises ``NativeUnavailable``."""
    PN.load()
    monkeypatch.setattr(PN, "_fastcall", None)
    monkeypatch.setattr(PN, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)
    d = PA.AutoDoc(actor=PT.ActorId(b"\x01" * 16), device="cpu")
    with pytest.raises(PN.NativeUnavailable, match="gcc not found"):
        d.put("_root", "k", 1)
    d.rollback()
    o = d.put_object("_root", "t", PT.ObjType.TEXT)
    with pytest.raises(PN.NativeUnavailable, match="gcc not found"):
        d.splice_text(o, 0, 0, "x")
