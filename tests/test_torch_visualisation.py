"""The port's dot dumps (``automerge_tpu_torch/visualisation.py``) against
the JAX package's: the same dot text for the same document, built by the
same calls in both packages, including a document whose op store a
large session commit left stale (the port rebuilds it on its device
before the dump)."""

import random

import pytest

import automerge_tpu.api as RA
import automerge_tpu.types as RT
import automerge_tpu.visualisation as RV
import automerge_tpu_torch.api as PA
import automerge_tpu_torch.types as PT
import automerge_tpu_torch.visualisation as PV


def both(script):
    """``script(doc, types)`` on a JAX package document and a port one."""
    out = []
    for api, T in ((RA, RT), (PA, PT)):
        kw = {} if api is RA else {"device": "cpu"}
        d = api.AutoDoc(actor=T.ActorId(bytes([1]) * 16), **kw)
        script(d, T)
        out.append(d)
    return out


def tombstones(d, T):
    t = d.put_object("_root", "t", T.ObjType.TEXT)
    d.splice_text(t, 0, 0, "hi")
    d.splice_text(t, 0, 1, "")
    d.put("_root", "k", 1)
    d.commit(timestamp=1)


def rich(d, T):
    t = d.put_object("_root", "t", T.ObjType.TEXT)
    d.splice_text(t, 0, 0, "hello world")
    d.mark(t, 0, 5, "bold", True)
    lst = d.put_object("_root", "l", T.ObjType.LIST)
    for i, v in enumerate([1, "two", 2.5, None, b"\x01", T.ScalarValue("counter", 3)]):
        d.insert(lst, i, v)
    m = d.insert_object(lst, 0, T.ObjType.MAP)
    d.put(m, "nested", "yes")
    d.put(m, "nested", "overwritten")
    d.delete(lst, 2)
    d.commit(timestamp=2)
    f = d.fork(actor=T.ActorId(bytes([2]) * 16))
    f.put("_root", "k", "theirs")
    f.splice_text(t, 6, 5, "there")
    f.commit(timestamp=3)
    d.put("_root", "k", "ours")
    d.commit(timestamp=4)
    d.merge(f)


def typed(d, T):
    rng = random.Random(3)
    t = d.put_object("_root", "t", T.ObjType.TEXT)
    d.commit(timestamp=0)
    text = 0
    for i in range(700):
        pos = rng.randint(0, text)
        d.splice_text(t, pos, 0, rng.choice("abc"))
        text += 1
        if i % 90 == 89 and text > 3:
            d.splice_text(t, 1, 2, "")
            text -= 2
    d.commit(timestamp=5)


@pytest.mark.parametrize("script", [tombstones, rich, typed], ids=lambda s: s.__name__)
def test_dot_text_equals_the_reference(script):
    ref, port = both(script)
    assert PV.doc_to_dot(port) == RV.doc_to_dot(ref)
    assert PV.doc_to_dot(port.doc) == RV.doc_to_dot(ref.doc)
    assert PV.changes_to_dot(port) == RV.changes_to_dot(ref)


def test_doc_to_dot_renders_objects_and_tombstones():
    _, d = both(tombstones)
    dot = PV.doc_to_dot(d)
    assert dot.startswith("digraph automerge")
    assert "tombstone" in dot and "'i'" in dot and "k = int 1" in dot
    assert dot.count("subgraph") == 2


def test_changes_to_dot_renders_dag():
    def dag(d, T):
        d.put("_root", "a", 1)
        d.commit(timestamp=1)
        f = d.fork(actor=T.ActorId(bytes([2]) * 16))
        d.put("_root", "b", 2)
        d.commit(timestamp=2)
        f.put("_root", "c", 3)
        f.commit(timestamp=3)
        d.merge(f)

    ref, port = both(dag)
    dot = PV.changes_to_dot(port)
    assert dot == RV.changes_to_dot(ref)
    assert dot.count("seq") == 3 and dot.count("->") == 2
    assert dot.count("palegreen") == 2


def test_a_stale_store_is_rebuilt_for_the_dump(monkeypatch):
    """A session commit past SMALL_TAIL_OPS leaves the port's op store
    stale; the dump rebuilds it through one merge on the device."""
    from automerge_tpu_torch.ops import merge as M

    calls = []
    real = M.merge_columns
    monkeypatch.setattr(M, "merge_columns",
                        lambda *a, **k: calls.append(str(k.get("device"))) or real(*a, **k))
    ref, port = both(typed)
    assert port.doc._ops_stale
    calls.clear()
    assert PV.doc_to_dot(port) == RV.doc_to_dot(ref)
    assert calls == ["cpu"]
