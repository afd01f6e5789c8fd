"""The port's functional API (``automerge_tpu_torch.functional``, over
``expanded.py`` and ``sync/``) against the JAX package's, on the CPU.

Each test runs one script of the reference's
``tests/test_functional_parity.py`` on both packages (the port's
documents with ``device="cpu"``) and keeps the reference's own asserts.
Everything the script observes is recorded on each side and must be
equal: ``to_dict``, heads, saves, incremental saves, change bytes,
``decode_change`` / ``encode_change`` and the sync functions' message
and state bytes.
"""

from __future__ import annotations

import functools

import pytest

import automerge_tpu.functional as RF
import automerge_tpu_torch.functional as PF

from .test_torch_document import norm

DEVICE_ARGS = ("init", "from_dict", "load")


class Side:
    """A package's functional module, its constructors given ``device``
    (the port's: the CPU), recording what the script observes."""

    def __init__(self, mod, kw):
        self.mod, self.kw, self.seen = mod, kw, []

    def __getattr__(self, name):
        f = getattr(self.mod, name)
        return functools.partial(f, **self.kw) if name in DEVICE_ARGS and self.kw else f

    def see(self, *values):
        self.seen.append(norm(values))
        return values[0] if len(values) == 1 else values

    def doc(self, d):
        """A document value's observable state."""
        return self.see(self.mod.to_dict(d), self.mod.get_heads(d),
                        self.mod.get_all_changes(d), self.mod.save(self.mod.clone(d)))


def both(script):
    """Run ``script(am)`` on the JAX package and on the port; what each
    observed must be equal."""
    ref, port = Side(RF, {}), Side(PF, {"device": "cpu"})
    script(ref)
    script(port)
    assert ref.seen, "the script observed nothing"
    assert port.seen == ref.seen
    return port


STABLE = ("init", "view", "clone", "free", "from_dict", "change", "change_at",
          "empty_change", "load", "load_incremental", "save_incremental", "save",
          "merge", "get_actor", "get_conflicts", "get_last_local_change",
          "get_object_id", "get_changes", "get_all_changes", "apply_changes",
          "get_history", "diff", "equals", "encode_sync_state", "decode_sync_state",
          "generate_sync_message", "receive_sync_message", "init_sync_state",
          "encode_change", "decode_change", "encode_sync_message",
          "decode_sync_message", "get_missing_deps", "get_heads", "dump", "to_dict",
          "is_automerge", "save_since", "insert_at", "delete_at", "splice",
          "get_cursor", "get_cursor_position", "mark", "unmark", "marks")


def test_export_checklist():
    assert PF.__all__ == RF.__all__
    for name in STABLE:
        assert hasattr(PF, name) and name in PF.__all__
    for name in RF.__all__:
        assert callable(getattr(PF, name)) or isinstance(getattr(PF, name), type)


def _two_docs(am):
    d1 = am.from_dict({"k": 1}, actor=bytes([1]) * 16)
    d2 = am.merge(am.init(actor=bytes([2]) * 16), d1)
    d2 = am.change(d2, lambda d: d.update({"other": "x"}))
    return am.clone(d1, actor=bytes([1]) * 16), d2


def test_view_reads_at_heads_and_rejects_change():
    def script(am):
        d1 = am.from_dict({"n": 1}, actor=bytes([3]) * 16)
        h1 = am.get_heads(d1)
        d2 = am.change(d1, lambda d: d.update({"n": 2}))
        v = am.view(d2, h1)
        assert am.see(v.to_py()) == {"n": 1}
        assert am.see(am.get_heads(v)) == h1
        with pytest.raises(RuntimeError):
            am.change(v, lambda d: d.update({"n": 3}))
        w = am.change(am.clone(v, actor=bytes([4]) * 16), lambda d: d.update({"n": 3}))
        assert am.doc(w)[0] == {"n": 3}
        am.free(v)

    both(script)


def test_is_automerge():
    def script(am):
        assert am.see(am.is_automerge(am.init()))
        assert not am.see(am.is_automerge({"k": 1}))
        assert not am.is_automerge(None)

    both(script)


def test_empty_change_creates_opless_change():
    def script(am):
        d1 = am.from_dict({"k": 1}, actor=bytes([4]) * 16)
        n_before = len(am.get_all_changes(d1))
        d2 = am.empty_change(d1, "acknowledged")
        raw = am.see(am.get_all_changes(d2))
        assert len(raw) == n_before + 1
        last = am.see(am.decode_change(raw[-1]))
        assert last["ops"] == [] and last["message"] == "acknowledged"
        assert am.doc(d2)[0] == {"k": 1}
        d3 = am.empty_change(d2)
        assert len(am.doc(d3)[2]) == n_before + 2

    both(script)


def test_equals_compares_contents_not_history():
    def script(am):
        a = am.from_dict({"x": [1, 2]}, actor=bytes([5]) * 16)
        b = am.from_dict({"x": [1, 2]}, actor=bytes([6]) * 16)
        assert am.see(am.equals(a, b))
        assert am.equals(a, {"x": [1, 2]}) and not am.equals(a, {"x": [1]})
        assert am.equals(1, 1) and not am.equals(1, 2)
        am.doc(a)
        am.doc(b)

    both(script)


def test_get_object_id():
    def script(am):
        d = am.from_dict({"m": {"n": 1}, "l": [1]}, actor=bytes([7]) * 16)
        assert am.get_object_id(d) == "_root"
        assert am.see(am.get_object_id(d["m"])) not in (None, "_root")
        assert am.see(am.get_object_id(d["l"])) not in (None, "_root")
        assert am.get_object_id(42) is None
        am.doc(d)

    both(script)


def test_save_incremental_cursor_travels_with_value():
    def script(am):
        d1 = am.from_dict({"a": 1}, actor=bytes([8]) * 16)
        first = am.see(am.save_incremental(d1))
        assert first and am.save_incremental(d1) == b""
        d2 = am.change(d1, lambda d: d.update({"b": 2}))
        delta = am.see(am.save_incremental(d2))
        assert delta == am.save_since(d2, am.get_heads(d1)) and delta != first
        r = am.load_incremental(am.load_incremental(am.init(), first), delta)
        assert am.doc(r)[0] == {"a": 1, "b": 2}

    both(script)


def test_save_resets_incremental_cursor():
    def script(am):
        d1 = am.from_dict({"a": 1}, actor=bytes([9]) * 16)
        am.see(am.save(d1))
        assert am.save_incremental(d1) == b""

    both(script)


def test_save_since():
    def script(am):
        d1 = am.from_dict({"a": 1}, actor=bytes([10]) * 16)
        h1 = am.get_heads(d1)
        d2 = am.change(d1, lambda d: d.update({"b": 2}))
        delta = am.see(am.save_since(d2, h1))
        assert delta and am.save_since(d2, am.get_heads(d2)) == b""
        base = am.load(am.see(am.save(am.clone(d1, actor=bytes([11]) * 16))))
        assert am.doc(am.load_incremental(base, delta))[0] == {"a": 1, "b": 2}

    both(script)


def test_get_history_lazy_change_and_snapshot():
    def script(am):
        d = am.from_dict({"n": 1}, actor=bytes([11]) * 16)
        d = am.change(d, lambda x: x.update({"n": 2}))
        d = am.change(d, lambda x: x.update({"n": 3}))
        hist = am.get_history(d)
        assert len(hist) == 3
        assert am.see([h.snapshot.to_py()["n"] for h in hist]) == [1, 2, 3]
        assert [c["seq"] for c in am.see([h.change for h in hist])] == [1, 2, 3]
        assert hist[-1].change["hash"] == am.get_heads(d)[0].hex()
        am.see([am.save(h.snapshot) for h in hist])

    both(script)
    d = PF.from_dict({"n": 1}, actor=bytes([11]) * 16, device="cpu")
    assert PF.get_history(d)[0].snapshot._auto.doc.device.type == "cpu"


def test_encode_decode_change_roundtrip():
    def script(am):
        d = am.from_dict({"k": "v", "l": [1], "t": am.Text("héllo"),
                          "c": am.Counter(3), "f": 1.5, "n": None, "b": True},
                         actor=bytes([12]) * 16)
        d = am.change(d, lambda x: (x["l"].append(2), x.increment("c", 2),
                                    am.mark(x, ["t"], (1, 3), "bold", True)))
        for raw in am.get_all_changes(d):
            decoded = am.see(am.decode_change(raw))
            assert decoded["actor"] == (bytes([12]) * 16).hex()
            assert am.see(am.encode_change(decoded)) == raw

    both(script)


def test_get_missing_deps():
    def script(am):
        d1 = am.from_dict({"a": 1}, actor=bytes([13]) * 16)
        d2 = am.change(am.clone(d1, actor=bytes([14]) * 16), lambda x: x.update({"b": 2}))
        raw2 = am.see(am.get_all_changes(d2)[-1])
        assert am.get_missing_deps(d1) == []
        unknown = am.get_heads(d2)
        assert am.see(am.get_missing_deps(d1, unknown)) == unknown
        d1b = am.load_incremental(d1, raw2)
        assert am.get_missing_deps(d1b, am.get_heads(d2)) == []
        am.doc(d1b)

    both(script)


def test_functional_sync_round_trip():
    def script(am):
        a, b = _two_docs(am)
        sa, sb = am.init_sync_state(), am.init_sync_state()
        for _ in range(20):
            sa, msg = am.generate_sync_message(a, sa)
            am.see(msg)
            if msg is not None:
                b, sb = am.receive_sync_message(b, sb, msg)
            sb, msg_b = am.generate_sync_message(b, sb)
            am.see(msg_b)
            if msg_b is not None:
                a, sa = am.receive_sync_message(a, sa, msg_b)
            if msg is None and msg_b is None:
                break
        assert a.to_py() == b.to_py()
        am.see(am.encode_sync_state(sa), am.encode_sync_state(sb))
        am.doc(a)
        am.doc(b)

    both(script)


def test_generate_sync_message_does_not_mutate_input_state():
    def script(am):
        a, _ = _two_docs(am)
        s0 = am.init_sync_state()
        s1, msg = am.generate_sync_message(a, s0)
        assert am.see(msg) is not None
        assert s0.last_sent_heads == [] and not s0.in_flight
        assert am.see(s1.last_sent_heads) == am.get_heads(a)

    both(script)


def test_sync_state_and_message_codecs():
    def script(am):
        a, b = _two_docs(am)
        sa = am.init_sync_state()
        sa, msg = am.generate_sync_message(a, sa)
        decoded = am.decode_sync_message(msg)
        assert am.see(am.encode_sync_message(decoded)) == msg
        restored = am.decode_sync_state(am.see(am.encode_sync_state(sa)))
        assert restored.shared_heads == sa.shared_heads

    both(script)


def test_insert_at_delete_at():
    def script(am):
        d = am.from_dict({"l": [1, 4]}, actor=bytes([14]) * 16)
        d = am.change(d, lambda x: am.insert_at(x["l"], 1, 2, 3))
        assert am.doc(d)[0]["l"] == [1, 2, 3, 4]
        d = am.change(d, lambda x: am.delete_at(x["l"], 1, 2))
        assert am.doc(d)[0]["l"] == [1, 4]

    both(script)


def test_insert_at_negative_index_normalised_once():
    def script(am):
        d = am.from_dict({"l": [1, 2, 3]}, actor=bytes([17]) * 16)
        d = am.change(d, lambda x: am.insert_at(x["l"], -1, "a", "b"))
        assert am.doc(d)[0]["l"] == [1, 2, "a", "b", 3]

    both(script)


def test_delete_at_negative_index_normalised_once():
    def script(am):
        d = am.from_dict({"l": [1, 2, 3, 4], "t": am.Text("abcd")},
                         actor=bytes([20]) * 16)
        d = am.change(d, lambda x: am.delete_at(x["l"], -2, 2))
        assert am.doc(d)[0]["l"] == [1, 2]
        d = am.change(d, lambda x: am.delete_at(x["t"], -2, 2))
        assert am.doc(d)[0]["t"] == "ab"

    both(script)


def test_insert_at_delete_at_on_text():
    def script(am):
        d = am.from_dict({"t": am.Text("ad")}, actor=bytes([18]) * 16)
        d = am.change(d, lambda x: am.insert_at(x["t"], 1, "b", "c"))
        assert am.doc(d)[0]["t"] == "abcd"
        d = am.change(d, lambda x: am.delete_at(x["t"], 1, 2))
        assert am.doc(d)[0]["t"] == "ad"

    both(script)


def test_load_marks_history_saved():
    def script(am):
        d = am.from_dict({"a": 1}, actor=bytes([19]) * 16)
        d2 = am.load(am.see(am.save(d)), actor=bytes([21]) * 16)
        assert am.save_incremental(d2) == b""
        am.doc(d2)

    both(script)


def test_splice_by_path_and_cursor():
    def script(am):
        d = am.from_dict({"note": am.Text("hello world")}, actor=bytes([15]) * 16)
        d = am.change(d, lambda x: am.splice(x, ["note"], 5, 6, "!"))
        assert am.doc(d)[0]["note"] == "hello!"
        cur = am.see(am.get_cursor(d, ["note"], 5))
        d = am.change(d, lambda x: am.splice(x, ["note"], 0, 0, ">> "))
        assert am.see(am.get_cursor_position(d, ["note"], cur)) == 8
        d = am.change(d, lambda x: am.splice(x, ["note"], cur, 1))
        assert am.doc(d)[0]["note"] == ">> hello"

    both(script)


def test_mark_unmark_by_path():
    def script(am):
        d = am.from_dict({"t": am.Text("abcdef")}, actor=bytes([16]) * 16)
        d = am.change(d, lambda x: am.mark(x, ["t"], (1, 4), "bold", True))
        spans = am.see(am.marks(d, "t"))
        assert any(m.name == "bold" for m in spans)
        d = am.change(d, lambda x: am.unmark(x, ["t"], (1, 4), "bold"))
        assert not [m for m in am.see(am.marks(d, "t")) if m.name == "bold" and m.value]
        am.doc(d)

    both(script)


def test_conflicts_diff_and_change_at():
    """The rest of the surface: conflicts through a nested proxy, diff
    between heads, ``change_at`` landing concurrent with later history,
    ``get_changes`` and ``apply_changes``, ``get_last_local_change``."""
    def script(am):
        a = am.from_dict({"pets": [{"name": "rex"}]}, actor=bytes([30]) * 16)
        b = am.clone(a, actor=bytes([31]) * 16)
        h0 = am.get_heads(a)
        a = am.change(a, lambda d: d["pets"][0].update({"name": "fido"}))
        b = am.change(b, lambda d: d["pets"][0].update({"name": "spot"}))
        a = am.merge(a, b)
        conf = am.get_conflicts(a["pets"][0], "name")
        am.see(sorted(conf.items()))
        am.see(am.diff(a, h0, am.get_heads(a)))
        c = am.change_at(a, h0, lambda d: d.update({"at": "h0"}))
        am.see(am.get_changes(c, am.get_heads(a)), am.get_last_local_change(c))
        fresh = am.apply_changes(am.init(actor=bytes([32]) * 16), am.get_all_changes(c))
        assert am.doc(fresh)[0] == am.doc(c)[0]
        assert am.get_actor(c) == bytes([30]) * 16

    both(script)


def test_documents_live_on_their_device(monkeypatch):
    """A functional document is an AutoDoc on the card unless given
    ``device``; every value derived from one stays on its device."""
    import torch

    d = PF.from_dict({"k": 1}, actor=bytes([1]) * 16, device="cpu")
    for v in (d, PF.change(d, lambda x: x.update({"j": 2})), PF.clone(d),
              PF.view(d, PF.get_heads(d)), PF.load(PF.save(d), device="cpu"),
              PF.init(device="cpu")):
        assert v._auto.doc.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (PF.init, lambda: PF.from_dict({"k": 1}),
                 lambda: PF.load(PF.save(d))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
