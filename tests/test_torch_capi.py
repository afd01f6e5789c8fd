"""The port's C ABI (``automerge_tpu_torch/capi``) on the CPU.

The reference's five C suites against the port's library; the JAX
package's shim and the port's on the same seeded call sequences (items and
save bytes equal); the three frontends' saves byte for byte with the
reference's; the patch drain's shim cases; the C hot-call cache, typed by
``type_edits.c`` as a process and in this process through ``ctypes``,
against the port's Python path with its sessions off; and the rule that
nothing falls back: no GPU and no device setting refuses a document, and
an error raised while arming the cache is the call's error.
"""

import collections
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import automerge_tpu.capi.shim as rshim
from automerge_tpu_torch import capi
from automerge_tpu_torch import native
from automerge_tpu_torch.api import AutoDoc
from automerge_tpu_torch.capi import edits as E
from automerge_tpu_torch.capi import shim as pshim
from automerge_tpu_torch.core.document import Document
from automerge_tpu_torch.core.transaction import Transaction
from automerge_tpu_torch.types import ActorId, ObjType, set_text_encoding

from tests import test_cross_frontend as XF

ACTORS = [bytes([0x10 + i]) * 16 for i in range(6)]


@pytest.fixture(scope="module")
def lib():
    return capi.build()


@pytest.fixture(autouse=True)
def shim_on_cpu(monkeypatch):
    monkeypatch.setattr(pshim, "_device", torch.device("cpu"))


def c_env(**kw):
    env = dict(os.environ, PYTHONPATH=capi.python_path(), **kw)
    env.pop("AUTOMERGE_TPU_PYROOT", None)
    return env


# -- 1. the five suites -------------------------------------------------------


@pytest.mark.parametrize("source", capi.TEST_SOURCES)
def test_c_suite_passes_against_the_port_s_library(lib, tmp_path, source):
    exe = capi.build_test(lib, str(tmp_path), source=source)
    r = subprocess.run([exe], capture_output=True, text=True, timeout=300,
                       env=c_env(AUTOMERGE_TPU_TORCH_DEVICE="cpu"))
    assert r.returncode == 0, f"stdout: {r.stdout}\nstderr: {r.stderr}"
    assert "all assertions passed" in r.stdout


def test_library_lives_under_build_and_declares_the_reference_s_abi(lib):
    assert os.path.dirname(lib) == str(capi.OUT_DIR)
    assert os.path.basename(lib).startswith("libautomerge_tpu_torch-")

    def declarations(path):
        with open(path) as f:
            return [ln for ln in f if not ln.startswith(("/*", " *"))]

    ref_header = os.path.join(os.path.dirname(rshim.__file__), "am.h")
    assert declarations(capi.HEADER) == declarations(ref_header)


# -- 2. both shims, call for call ----------------------------------------------


class Caller:
    """One package's ``shim.call`` with handle items renumbered in the order
    they were minted, so two packages' lists compare."""

    def __init__(self, shim):
        self.shim, self.handles, self.log = shim, {}, []

    def __call__(self, fn, *args):
        args = tuple(self.handles[a] if isinstance(a, Handle) else a for a in args)
        items = self.shim.call(fn, *args)
        out = []
        for tag, v in items:
            if tag == self.shim.HANDLE:
                h = Handle(len(self.handles))
                self.handles[h] = v
                v = h
            out.append((tag, v))
        self.log.append((fn, out))
        return out


class Handle(int):
    pass


def _splice_text(call, rng, h, t, n):
    for _ in range(n):
        length = call("length", h, t)[0][1]
        pos = int(rng.integers(0, length + 1))
        ndel = min(int(rng.integers(0, 3)), length - pos)
        text = "".join(rng.choice(list("abcxyz é€"), size=int(rng.integers(1, 5))))
        call("splice_text", h, t, pos, ndel, text)


TAGS = (rshim.INT, rshim.UINT, rshim.F64, rshim.STR, rshim.BYTES, rshim.BOOL,
        rshim.NULL, rshim.COUNTER, rshim.TIMESTAMP)


def _value(rng, tag, i):
    return {rshim.INT: int(rng.integers(-99, 99)), rshim.UINT: int(rng.integers(0, 99)),
            rshim.F64: float(rng.integers(0, 1000)) / 8, rshim.STR: f"s{i}",
            rshim.BYTES: bytes([i % 256, 7]), rshim.BOOL: int(rng.integers(0, 2)),
            rshim.NULL: 0, rshim.COUNTER: int(rng.integers(0, 9)),
            rshim.TIMESTAMP: 1_600_000_000 + i}[tag]


def _edit(call, rng, h, objs, rounds):
    t, lst, m = objs
    for r in range(rounds):
        _splice_text(call, rng, h, t, 6)
        for i in range(4):
            tag = int(rng.choice(TAGS))
            call("put", h, m, f"k{int(rng.integers(0, 6))}", tag, _value(rng, tag, i))
            n = call("length", h, lst)[0][1]
            call("insert", h, lst, int(rng.integers(0, n + 1)), tag, _value(rng, tag, i))
        n = call("length", h, lst)[0][1]
        if n > 2:
            call("list_delete", h, lst, int(rng.integers(0, n)))
            call("list_put", h, lst, 0, rshim.STR, f"p{r}")
        length = call("length", h, t)[0][1]
        if length > 3:
            a = int(rng.integers(0, length - 2))
            call("mark_bool", h, t, a, a + 2, "bold", 1, "after")
            call("mark_str", h, t, 0, 1, "link", f"u{r}", "none")
            if rng.random() < 0.5:
                call("unmark", h, t, a, a + 1, "bold")
        if r == 0:
            call("put", h, "_root", "n", rshim.COUNTER, 1)
        call("increment", h, "_root", "n", int(rng.integers(1, 5)))
        call("commit", h, f"round {r}")


def _reads(call, h, objs, heads=None):
    t, lst, m = objs
    if heads is None:
        for fn, args in (("text", (t,)), ("length", (lst,)), ("keys", (m,)),
                         ("list_items", (lst,)), ("map_entries", (m,)),
                         ("marks", (t,)), ("get", (m, "k1")), ("get_all", (m, "k2")),
                         ("list_get", (lst, 0)), ("object_type", (t,)),
                         ("list_range", (lst, 1, 3)), ("map_range", (m, "k1", "k4")),
                         ("get_heads", ()), ("get_last_local_change", ()),
                         ("pending_ops", ())):
            call(fn, h, *args)
        return
    for fn, args in (("text_at", (t,)), ("length_at", (lst,)), ("keys_at", (m,)),
                     ("marks_at", (t,)), ("get_at", (m, "k1")),
                     ("get_all_at", (m, "k2")), ("list_get_at", (lst, 0))):
        call(fn, h, *args, heads)


def _script(call, seed):
    rng = np.random.default_rng(seed)
    a = call("create", ACTORS[0])[0][1]
    objs = tuple(call("put_object", a, "_root", k, ty)[0][1]
                 for k, ty in (("t", 2), ("l", 1), ("m", 0)))
    _edit(call, rng, a, objs, 3)
    call("pop_patches", a)  # activates the observer log
    heads1 = b"".join(v for _, v in call("get_heads", a))
    _reads(call, a, objs)
    # fork, edit both sides, merge
    c = call("fork", a, ACTORS[1])[0][1]
    _edit(call, rng, c, objs, 2)
    _edit(call, rng, a, objs, 1)
    call("merge", a, c)
    call("pop_patches", a)
    # load the save, fork it at heads1, clone
    saved = call("save", a)[0][1]
    d = call("load", saved)[0][1]
    call("set_actor", d, ACTORS[2])
    _edit(call, rng, d, objs, 1)
    call("apply_change_bytes", a, call("save_incremental", d, heads1)[0][1])
    e = call("fork_at", a, heads1, ACTORS[3])[0][1]
    _reads(call, e, objs)
    call("clone", e)
    heads2 = b"".join(v for _, v in call("get_heads", a))
    call("diff", a, heads1, heads2)
    call("get_changes", a, heads1)
    call("get_changes_added", a, c)
    call("get_missing_deps", a, b"")
    call("get_change_by_hash", a, heads1[:32])
    _reads(call, a, objs, heads1)
    call("get_cursor", a, objs[0], 1)
    # a sync exchange to quiescence with a new peer
    b = call("create", ACTORS[4])[0][1]
    sa, sb = call("sync_state_new")[0][1], call("sync_state_new")[0][1]
    for _ in range(20):
        ma = call("generate_sync_message", a, sa)
        if ma:
            call("receive_sync_message", b, sb, ma[0][1])
        mb = call("generate_sync_message", b, sb)
        if mb:
            call("receive_sync_message", a, sa, mb[0][1])
        if not ma and not mb:
            break
    else:
        raise AssertionError("sync did not quiesce")
    call("sync_state_shared_heads", sa)
    call("sync_state_decode", call("sync_state_encode", sb)[0][1])
    call("equal", a, b)
    call("equal_content", a, b)
    _edit(call, rng, b, objs, 1)
    for h in (a, b, c, d, e):
        call("save", h)
    for h in (a, b, c, d, e):
        call("free", h)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shims_give_equal_items_and_saves(seed):
    ref, port = Caller(rshim), Caller(pshim)
    _script(ref, seed)
    _script(port, seed)
    assert len(port.log) == len(ref.log) > 200
    for (fn, want), (pfn, got) in zip(ref.log, port.log):
        assert (pfn, got) == (fn, want)
    saves = [items[0][1] for fn, items in port.log if fn == "save"]
    assert len(saves) == 6 and all(isinstance(s, bytes) for s in saves)


def test_shim_documents_live_on_the_shim_s_device(monkeypatch):
    h = pshim.call("create", ACTORS[0])[0][1]
    t = pshim.call("put_object", h, "_root", "t", 2)[0][1]
    pshim.call("splice_text", h, t, 0, 0, "device")
    made = [h]
    made.append(pshim.call("load", pshim.call("save", h)[0][1])[0][1])
    made.append(pshim.call("fork", h, ACTORS[1])[0][1])
    made.append(pshim.call("clone", h)[0][1])
    heads = b"".join(v for _, v in pshim.call("get_heads", h))
    made.append(pshim.call("fork_at", h, heads, ACTORS[2])[0][1])
    assert [pshim._docs[x].doc.device for x in made] == [torch.device("cpu")] * 5
    for x in made:
        pshim.call("free", x)
    # the setting is read once, through resolve_device
    monkeypatch.setattr(pshim, "_device", None)
    monkeypatch.setenv("AUTOMERGE_TPU_TORCH_DEVICE", "cpu")
    assert pshim._doc_device() == torch.device("cpu")
    monkeypatch.setenv("AUTOMERGE_TPU_TORCH_DEVICE", "meta")
    assert pshim._doc_device() == torch.device("cpu")


def test_shim_refuses_to_make_documents_without_a_gpu(monkeypatch):
    monkeypatch.setattr(pshim, "_device", None)
    monkeypatch.delenv("AUTOMERGE_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, args in (("create", (ACTORS[0],)), ("load", (b"",))):
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            pshim.call(fn, *args)
    assert pshim._device is None


# -- 3. the three frontends -----------------------------------------------------


def _port_via_python() -> bytes:
    d = AutoDoc(actor=ActorId(XF.ACTOR), device="cpu")
    t = d.put_object("_root", "t", ObjType.TEXT)
    d.splice_text(t, 0, 0, "common script")
    d.put("_root", "n", pshim._scalar(pshim.COUNTER, 3))
    d.increment("_root", "n", 4)
    lst = d.put_object("_root", "l", ObjType.LIST)
    d.insert(lst, 0, 1)
    d.insert(lst, 1, "two")
    d.delete(lst, 0)
    d.put("_root", "flag", True)
    d.delete("_root", "flag")
    d.commit(message="cross")
    d.mark(t, 0, 6, "bold", True)
    d.commit(message="marks")
    return d.save()


def _port_via_rpc() -> bytes:
    import base64

    from automerge_tpu_torch.rpc import RpcServer

    srv = RpcServer(device="cpu")

    def call(method, **params):
        resp = srv.handle({"id": 1, "method": method, "params": params})
        assert "error" not in resp, resp
        return resp["result"]

    d = call("create", actor=XF.ACTOR.hex())["doc"]
    t = call("putObject", doc=d, obj="_root", prop="t", type="text")["$obj"]
    call("spliceText", doc=d, obj=t, pos=0, text="common script")
    call("put", doc=d, obj="_root", prop="n", value={"$counter": 3})
    call("increment", doc=d, obj="_root", prop="n", by=4)
    lst = call("putObject", doc=d, obj="_root", prop="l", type="list")["$obj"]
    call("insert", doc=d, obj=lst, index=0, value=1)
    call("insert", doc=d, obj=lst, index=1, value="two")
    call("delete", doc=d, obj=lst, index=0)
    call("put", doc=d, obj="_root", prop="flag", value=True)
    call("delete", doc=d, obj="_root", prop="flag")
    call("commit", doc=d, message="cross")
    call("mark", doc=d, obj=t, start=0, end=6, name="bold", value=True)
    call("commit", doc=d, message="marks")
    return base64.b64decode(call("save", doc=d))


def test_three_frontends_byte_identical_with_the_reference():
    py, rpc = _port_via_python(), _port_via_rpc()
    # the reference test's shim script, run on the port's shim
    orig = XF.shim
    try:
        XF.shim = pshim
        shim_save = XF._via_capi_shim()
    finally:
        XF.shim = orig
    assert py == rpc == shim_save == XF._via_python()
    doc = AutoDoc.load(py, device="cpu")
    assert doc.get("_root", "n")[0] == ("counter", 7)


# -- 4. the patch drain's shim cases ---------------------------------------------


def _mark_kinds(items):
    return [items[i + 2][1] for i in range(0, len(items), 6)]


def test_mark_patches_through_the_shim():
    h = pshim.call("create", b"\x07" * 16)[0][1]
    doc2 = pshim._docs[h]
    t2 = doc2.put_object("_root", "t", ObjType.TEXT)
    doc2.splice_text(t2, 0, 0, "abc")
    doc2.commit()
    assert pshim.call("pop_patches", h) == []  # activate
    doc2.mark(t2, 0, 2, "em", True)
    doc2.commit()
    items = pshim.call("pop_patches", h)
    kinds = _mark_kinds(items)
    assert "mark" in kinds and "mark_end" in kinds
    assert items == _reference_mark_items()
    pshim.call("free", h)


def _reference_mark_items():
    from automerge_tpu.types import ObjType as RObjType

    h = rshim.call("create", b"\x07" * 16)[0][1]
    doc = rshim._docs[h]
    t = doc.put_object("_root", "t", RObjType.TEXT)
    doc.splice_text(t, 0, 0, "abc")
    doc.commit()
    rshim.call("pop_patches", h)
    doc.mark(t, 0, 2, "em", True)
    doc.commit()
    items = rshim.call("pop_patches", h)
    rshim.call("free", h)
    return items


def test_list_mark_patches_and_clear_records_through_the_shim():
    h = pshim.call("create", b"\x08" * 16)[0][1]
    doc2 = pshim._docs[h]
    t2 = doc2.put_object("_root", "t", ObjType.TEXT)
    doc2.splice_text(t2, 0, 0, "abc")
    doc2.commit()
    pshim.call("pop_patches", h)
    doc2.mark(t2, 0, 2, "em", True)
    doc2.commit()
    items = pshim.call("pop_patches", h)
    assert _mark_kinds(items) == ["mark_clear", "mark", "mark_end"]
    doc2.unmark(t2, 0, 2, "em")
    doc2.commit()
    items = pshim.call("pop_patches", h)
    assert _mark_kinds(items) == ["mark_clear"]
    pshim.call("free", h)


# -- 5. the C hot-call cache ------------------------------------------------------


class PlainDoc(AutoDoc):
    """An ``AutoDoc`` whose transactions never use the native sessions."""

    def _ensure_tx(self):
        tx = super()._ensure_tx()
        tx.enable_sessions = False
        return tx


def _width(c, enc):
    return {"unicode": 1, "utf8": len(c.encode()),
            "utf16": 2 if ord(c) > 0xFFFF else 1}[enc]


def typing_records(seed, n, enc="unicode", puts=0.0, bad=0.0):
    """``n`` seeded records: splices at positions in ``enc``'s units, a
    share ``puts`` of map puts of every scalar type, and a share ``bad`` of
    failing splices (malformed UTF-8, a delete past the end)."""
    rng = np.random.default_rng(seed)
    chars = list("abcdef é€😀")
    text, out = [], []
    for i in range(n):
        r = rng.random()
        if r < puts:
            tag = int(rng.choice(TAGS))
            out.append(("put", f"k{int(rng.integers(0, 12))}", tag, _value(rng, tag, i)))
            continue
        if r < puts + bad / 2:
            out.append(("splice", 0, 0, b"ok\xff\xfe"))
            continue
        if r < puts + bad:
            units = sum(_width(c, enc) for c in text)
            out.append(("splice", units, 3, b""))
            continue
        pos = int(rng.integers(0, len(text) + 1))
        ndel = min(int(rng.integers(0, 3)) if rng.random() < 0.3 else 0, len(text) - pos)
        s = "".join(rng.choice(chars, size=int(rng.integers(0, 4))))
        upos = sum(_width(c, enc) for c in text[:pos])
        udel = sum(_width(c, enc) for c in text[pos:pos + ndel])
        del text[pos:pos + ndel]
        text[pos:pos] = list(s)
        out.append(("splice", upos, udel, s.encode()))
    return out


def _python_typed(records, every, actor=ACTORS[5]):
    d = PlainDoc(ActorId(actor), device="cpu")
    failed = E.type_records(d, records, every)
    return d.save(), failed


def test_typist_saves_the_python_path_s_bytes(lib, tmp_path):
    records = typing_records(11, 3000, puts=0.1, bad=0.04)
    path = tmp_path / "edits.bin"
    path.write_bytes(E.encode(records))
    exe = capi.build_test(lib, str(tmp_path), source="type_edits.c")
    out = tmp_path / "typed.automerge"
    r = subprocess.run([exe, str(path), "100", str(out), ACTORS[5].hex()],
                       capture_output=True, text=True, timeout=300,
                       env=c_env(AUTOMERGE_TPU_TORCH_DEVICE="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr
    want, failed = _python_typed(records, 100)
    assert out.read_bytes() == want
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("record ")]
    assert [int(ln.split()[1].rstrip(":")) for ln in lines] == failed
    errors = collections.Counter(ln.split(": ", 1)[1] for ln in lines)
    assert set(errors) == {"argument marshalling failed",
                           "splice: delete past end of sequence"}
    assert f"typed {len(records)} records" in r.stdout


class Typist:
    """``type_edits.c`` as a shared library in this process."""

    def __init__(self, lib, tmp_path):
        so = capi.build_test(lib, str(tmp_path), source="type_edits.c", shared=True)
        self.drv = ctypes.CDLL(so)
        self.drv.type_edits.restype = ctypes.c_void_p
        self.drv.type_edits.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long)]
        self.am = ctypes.CDLL(lib)
        for name, res, args in (
                ("am_save", ctypes.c_void_p, [ctypes.c_void_p]),
                ("am_item_bytes", ctypes.POINTER(ctypes.c_uint8),
                 [ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]),
                ("am_result_free", None, [ctypes.c_void_p]),
                ("am_doc_free", None, [ctypes.c_void_p])):
            getattr(self.am, name).restype = res
            getattr(self.am, name).argtypes = args
        self.tmp = tmp_path

    def type(self, records, every, actor=ACTORS[5]):
        path = self.tmp / "edits.bin"
        path.write_bytes(E.encode(records))
        errs = self.tmp / "errors.txt"
        obj = ctypes.create_string_buffer(64)
        secs, n = ctypes.c_double(), ctypes.c_long()
        d = self.drv.type_edits(str(path).encode(), every, actor, str(errs).encode(),
                                obj, ctypes.byref(secs), ctypes.byref(n))
        assert d and n.value == len(records)
        r = self.am.am_save(d)
        ln = ctypes.c_size_t()
        data = ctypes.string_at(self.am.am_item_bytes(r, 0, ctypes.byref(ln)), ln.value)
        self.am.am_result_free(r)
        self.am.am_doc_free(d)
        failed = [int(x.split()[1].rstrip(":")) for x in errs.read_text().splitlines()]
        return data, failed


@pytest.fixture
def dispatched(monkeypatch):
    """The shim functions the library dispatched, by name."""
    calls = collections.Counter()
    real = pshim.call

    def counting(fn, *args):
        calls[fn] += 1
        return real(fn, *args)

    monkeypatch.setattr(pshim, "call", counting)
    return calls


@pytest.mark.parametrize("enc", ["unicode", "utf8", "utf16"])
def test_fast_cache_in_process_over_each_text_encoding(lib, tmp_path, monkeypatch,
                                                      dispatched, enc):
    made = []
    real_init = native.EditSession.__init__

    def spy(self, *a, **kw):
        made.append(1)
        real_init(self, *a, **kw)

    monkeypatch.setattr(native.EditSession, "__init__", spy)
    rebuilt = []
    real_rebuild = Document._materialize_ops
    monkeypatch.setattr(Document, "_materialize_ops",
                        lambda self: rebuilt.append(1) or real_rebuild(self))
    typist = Typist(lib, tmp_path)
    records = typing_records(5, 2000, enc)
    # each commit past SMALL_TAIL_OPS leaves the op store stale
    every = Transaction.SMALL_TAIL_OPS + 44
    set_text_encoding(enc)
    try:
        got, failed = typist.type(records, every)
        # every commit kept its session and the next transaction adopted
        # it, arming the cache without rebuilding the stale op store
        assert len(made) == 1 and rebuilt == []
        assert dispatched["splice_text"] == 0
        assert dispatched["commit"] == 2000 // every + 2
        want, want_failed = _python_typed(records, every)
    finally:
        set_text_encoding("unicode")
    assert got == want and failed == want_failed == []


def test_fast_cache_reports_bad_splices_and_keeps_typing(lib, tmp_path, dispatched):
    typist = Typist(lib, tmp_path)
    records = typing_records(7, 1500, puts=0.15, bad=0.06)
    got, failed = typist.type(records, 64)
    want, want_failed = _python_typed(records, 64)
    assert got == want
    assert failed == want_failed and len(failed) > 40
    # the malformed ones reached dispatch, which reported them; the deletes
    # past the end failed in the cache itself
    malformed = sum(1 for r in records if r[0] == "splice" and r[3] == b"ok\xff\xfe")
    assert dispatched["splice_text"] == 0 < malformed
    assert dispatched["put"] < sum(1 for r in records if r[0] == "put")


# -- 6. no quiet fallback ------------------------------------------------------------


_NO_GPU = r"""
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
lib.am_create.restype = lib.am_load.restype = ctypes.c_void_p
assert lib.am_init() == 0
print("create", lib.am_create(b"\x01" * 16, 16))
print("load", lib.am_load(b"", 0))
"""


def test_no_gpu_and_no_setting_refuses_a_document(lib):
    env = c_env(CUDA_VISIBLE_DEVICES="")
    env.pop("AUTOMERGE_TPU_TORCH_DEVICE", None)
    r = subprocess.run([sys.executable, "-c", _NO_GPU, lib], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.split() == ["create", "None", "load", "None"]
    for call in ("am_create", "am_load"):
        assert (f"{call}: RuntimeError: automerge_tpu_torch runs on a CUDA device "
                "by default") in r.stderr


_NO_NATIVE = r"""
import collections, ctypes, sys, tempfile
from pathlib import Path
from automerge_tpu_torch import native
from automerge_tpu_torch.capi import shim
native.BUILD_DIR = Path(tempfile.mkdtemp())
calls = collections.Counter()
real = shim.call
def counting(fn, *args):
    calls[fn] += 1
    return real(fn, *args)
shim.call = counting
lib = ctypes.CDLL(sys.argv[1])
for f in ("am_create", "am_map_put_object", "am_splice_text", "am_map_put_int"):
    getattr(lib, f).restype = ctypes.c_void_p
lib.am_result_error.restype = lib.am_item_str.restype = ctypes.c_char_p
lib.am_map_put_object.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
lib.am_splice_text.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_size_t, ctypes.c_char_p]
lib.am_map_put_int.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_int64]
lib.am_result_status.argtypes = lib.am_result_error.argtypes = [ctypes.c_void_p]
lib.am_item_str.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
assert lib.am_init() == 0
d = lib.am_create(b"\x01" * 16, 16)
r = lib.am_map_put_object(d, b"_root", b"t", 2)
assert lib.am_result_status(r) == 0
t = lib.am_item_str(r, 0)
for name, r in (("splice", lib.am_splice_text(d, t, 0, 0, b"abc")),
                ("put", lib.am_map_put_int(d, b"_root", b"k", 5))):
    print(name, lib.am_result_status(r), lib.am_result_error(r).decode())
print("dispatched", sorted(calls.items()))
"""


def test_an_error_while_arming_the_cache_is_the_call_s_error(lib, tmp_path):
    env = c_env(AUTOMERGE_TPU_TORCH_DEVICE="cpu", PATH=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", _NO_NATIVE, lib], env=env,
                       cwd=capi._REPO_ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    for name, line in zip(("splice", "put"), lines):
        assert line.startswith(f"{name} 1 NativeUnavailable: g++ not found"), line
    dispatched = dict(eval(lines[2].split(" ", 1)[1]))
    assert "splice_text" not in dispatched and "put" not in dispatched
    assert dispatched["fast_addrs"] == 2 and "fast_begin" not in dispatched
