"""The port's native host code: the change parser's column check, the
column decoders, the batch extractor, the log assembler, the sorted id
join and the single-column codecs of the document layer, in C++ with a
plain C interface, loaded with ``ctypes``.

The sources (``native/*.cpp``, ``native/*.h``) compile with ``g++ -O3
-march=native`` at first use, one ``g++`` each in parallel, into
``build/automerge_tpu_torch/libamt_native_<hash>.so`` beside the package:
the hash covers the sources, the flags and the CPU's feature flags (a
``-march=native`` build runs only on CPUs like the one it was built on).
Processes that need the library at once build it once: one holds a lock
on ``build/automerge_tpu_torch/native.lock`` while it compiles (the
others wait on it, then load), and the build goes to a temporary name
that is moved into place, so no process loads a partial file. There is
no fallback: when the build fails, ``NativeUnavailable`` is raised.

Array-level API (numpy in and out):
    join_rows(sorted_keys, queries, missing) -> int32 rows
    change_check(col_data, n_actors) -> op count (raises ValueError)
    rle_encode_array / delta_encode_array / bool_encode_array /
    rle_encode_strtab -> column bytes (``codecs.cpp``)
    rle_decode_array / delta_decode_array / bool_decode_array -> arrays

The native edit sessions (``session.cpp``, ``map_session.cpp``) join the
same library: ``EditSession`` holds one text object's visible elements
inside a transaction and resolves splices in C++, ``MapSession`` one map
object's winners for per-op puts; both export their ops as arrays for
the change encoder at commit. ``fastcall()`` builds and loads
``fastcall.c``, a CPython extension (module ``amt_fastcall``, a name of
its own so the JAX package's ``am_fastcall`` can load in the same
process) whose ``splice`` / ``map_put`` reach the sessions in one
METH_FASTCALL call: ``gcc -O2`` at first use, into
``build/automerge_tpu_torch/_amt_fastcall-<abi>-<hash>.so`` under the
same lock, ``NativeUnavailable`` when it cannot be built.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np


_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[1] / "build" / "automerge_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread")

_lib = None


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


def _sources():
    return sorted(_HERE.glob("*.cpp"))


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    import platform

    return platform.machine().encode()


def _digest() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_flags())
    for p in sorted(_HERE.glob("*.cpp")) + sorted(_HERE.glob("*.h")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libamt_native_{_digest()}.so"


def build() -> float:
    """Compile the library unless an up-to-date build exists; returns the
    seconds spent (0.0 when the cached build was reused). Raises
    ``NativeUnavailable`` when ``g++`` is missing or fails."""
    return _build_once(library_path(), "g++", "the native library", _compile)


def _build_once(out: Path, tool: str, what: str, compile_fn) -> float:
    """``compile_fn(path of tool, out)`` unless ``out`` exists, under
    ``native.lock`` so processes that need it at once build it once."""
    if out.exists():
        return 0.0
    path = shutil.which(tool)
    if path is None:
        raise NativeUnavailable(f"{tool} not found: {what} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # the kernel releases the lock with its holder, even one that was killed
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built by the holder this process waited for
            return 0.0
        return compile_fn(path, out)


def _compile(gxx: str, out: Path) -> float:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [gxx, *GXX_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for cmd, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{log.decode(errors='replace')}")
        if failed:
            raise NativeUnavailable("g++ failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        cmd = [gxx, *GXX_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)]
        r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if r.returncode != 0:
            raise NativeUnavailable(
                f"g++ link failed:\n{' '.join(cmd)}\n"
                + r.stdout.decode(errors="replace"))
        os.replace(tmp_lib, out)
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The native library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    try:
        lib = ctypes.CDLL(str(library_path()))
    except OSError as e:
        raise NativeUnavailable(f"cannot load the native library: {e}") from e
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    sz = ctypes.c_size_t
    for name, argtypes in (
        ("am_rle_decode_batch", [u8p, i64p, i64p, i64p, i64, ctypes.c_int, i64p, u8p]),
        ("am_delta_decode_batch", [u8p, i64p, i64p, i64p, i64, i64p, u8p]),
        ("am_bool_decode_batch", [u8p, i64p, i64p, i64p, i64, u8p]),
        ("am_rle_decode_batch_strtab",
         [u8p, i64p, i64p, i64p, i64, i32p, i64p, i64p, i64, i64]),
        ("am_localize_ids", [i32p, i64p, i64, i64, i32p, i32p, i64p, i64p]),
        ("am_leb_decode_rows", [u8p, i64, i64p, i64p, i32p, i64, i64p]),
        ("am_join_rows_i64", [i64p, i64, i64p, i64, ctypes.c_int32, i32p]),
        ("am_change_check", [ctypes.POINTER(ctypes.c_char_p), i64p, i64]),
        ("am_rle_decode_i64", [u8p, sz, ctypes.c_int, i64p, u8p, sz]),
        ("am_delta_decode_i64", [u8p, sz, i64p, u8p, sz]),
        ("am_bool_decode", [u8p, sz, u8p, sz]),
        ("am_rle_encode_i64", [i64p, u8p, sz, ctypes.c_int, u8p, sz]),
        ("am_delta_encode_i64", [i64p, u8p, sz, u8p, sz, i64p]),
        ("am_bool_encode", [u8p, sz, u8p, sz]),
        ("am_rle_encode_strtab", [i64p, i64, i64p, i64p, u8p, u8p, i64]),
        ("am_assemble_log", [
            # per-change metadata (11 i64 arrays), col_ptrs, n_changes
            i64p, i64p, i64p, i64p, i64p, i64p, i64p, i64p, i64p, i64p, i64p,
            i64p, i64,
            # translation tables + actor_bits + global const-fill directives
            # + per-change const shortcut tables (obj key, key sid)
            i64p, i32p, i32p, ctypes.c_int32, i64p, i64p, i64p, i64p,
            # row outputs
            i64p, i64p, i32p, i32p, u8p, u8p, i32p, i64p, i32p, i32p, i32p,
            i64p, i64p, i32p, i32p, i64,
            # pred outputs
            i32p, i32p, i64,
            # obj table + meta
            i64p, i64p,
        ]),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_longlong
        fn.argtypes = argtypes
    vp = ctypes.c_void_p
    for create, destroy in (("am_edit_create", "am_edit_destroy"),
                            ("am_map_create", "am_map_destroy")):
        getattr(lib, create).restype = vp
        getattr(lib, create).argtypes = [i64]
        getattr(lib, destroy).restype = None
        getattr(lib, destroy).argtypes = [vp]
    for name, argtypes in (
        ("am_edit_init", [vp, i64p, i64p, i32p, i64]),
        ("am_edit_length", [vp]),
        ("am_edit_op_count", [vp]),
        ("am_edit_splice", [vp, i64, i64, i64, i32p, i32p, i64]),
        ("am_edit_splice_batch",
         [vp, i64, i64p, i64p, i64p, i32p, i32p, i64, ctypes.c_uint8]),
        ("am_edit_export", [vp, i64, i64p, i64p, i64p, i32p, i32p, u8p]),
        ("am_edit_order", [vp, i64p, i64]),
        ("am_map_init", [vp, u8p, i64p, i64p, i64]),
        ("am_map_op_count", [vp]),
        ("am_map_put", [vp, i64, ctypes.c_char_p, i64, ctypes.c_int32, i64,
                        ctypes.c_double, u8p, i64]),
        ("am_map_export_sizes", [vp, i64, i64p, i64p]),
        ("am_map_export", [vp, i64, i64p, i64p, i64p, i64p, u8p]),
        ("am_map_keytab_sizes", [vp, i64p, i64p]),
        ("am_map_keytab", [vp, u8p, i64p]),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_longlong
        fn.argtypes = argtypes
    _lib = lib
    return _lib


_fastcall = None


def _fastcall_path() -> Path:
    import sys

    h = hashlib.sha256(b"gcc -O2 -shared -fPIC")
    h.update(_cpu_flags())
    h.update((_HERE / "fastcall.c").read_bytes())
    # the extension reads PyUnicode objects' layout: the interpreter's ABI
    # tag keys the build beside the sources and the CPU's flags
    tag = sys.implementation.cache_tag or "py"
    return BUILD_DIR / f"_amt_fastcall-{tag}-{h.hexdigest()[:16]}.so"


def _compile_fastcall(gcc: str, out: Path) -> float:
    import sysconfig

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = Path(tmp) / out.name
        cmd = [gcc, "-O2", "-shared", "-fPIC", f"-I{sysconfig.get_path('include')}",
               "-o", str(tmp_so), str(_HERE / "fastcall.c")]
        r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if r.returncode != 0:
            raise NativeUnavailable(f"gcc failed:\n{' '.join(cmd)}\n"
                                    + r.stdout.decode(errors="replace"))
        os.replace(tmp_so, out)
    return time.perf_counter() - t0


def fastcall():
    """The CPython fast-call extension (``fastcall.c``), built on first
    use: its ``splice`` / ``map_put`` reach the sessions without ctypes'
    per-call marshalling. Raises ``NativeUnavailable`` when it cannot be
    built or loaded."""
    global _fastcall
    if _fastcall is not None:
        return _fastcall
    lib = load()
    out = _fastcall_path()
    _build_once(out, "gcc", "the fastcall extension", _compile_fastcall)
    import importlib.util

    try:
        spec = importlib.util.spec_from_file_location("amt_fastcall", out)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except ImportError as e:
        raise NativeUnavailable(f"cannot load the fastcall extension: {e}") from e
    mod.setup(ctypes.cast(lib.am_edit_splice, ctypes.c_void_p).value)
    mod.setup_map(ctypes.cast(lib.am_map_put, ctypes.c_void_p).value)
    _fastcall = mod
    return _fastcall


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def join_rows(sorted_keys: np.ndarray, queries: np.ndarray, missing: int) -> np.ndarray:
    """Rows of ``queries`` in the sorted int64 ``sorted_keys`` (``missing``
    where absent)."""
    s = np.ascontiguousarray(sorted_keys, np.int64)
    q = np.ascontiguousarray(queries, np.int64)
    out = np.empty(len(q), np.int32)
    if len(q):
        load().am_join_rows_i64(_i64(s), len(s), _i64(q), len(q), missing, _i32(out))
    return out


# change_check's column order (storage/change.py COL_* specs)
CHECK_SPECS = (1, 2, 17, 19, 21, 52, 66, 86, 87, 112, 113, 115, 148, 165)
_CHECK_ERRORS = {
    -1: "malformed op column",
    -2: "op without an action",
    -3: "half-null object id",
    -4: "neither map key nor elem id present",
    -5: "value metadata column shorter than row count or null",
    -6: "malformed value",
    -7: "truncated pred column",
    -8: "op references a missing actor index",
    -9: "column demands too many values",
}


def change_check(col_data: dict, n_actors: int) -> int:
    """The op count of a change's op columns (normalized spec -> bytes),
    checked as the per-op decoder and the actor bounds check would take
    them; raises ValueError where they would raise."""
    lib = load()
    bufs = [bytes(col_data.get(s, b"")) for s in CHECK_SPECS]
    ptrs = (ctypes.c_char_p * len(bufs))(*bufs)
    lens = np.fromiter(map(len, bufs), np.int64, count=len(bufs))
    n = lib.am_change_check(ptrs, _i64(lens), n_actors)
    if n < 0:
        raise ValueError(f"change op columns: {_CHECK_ERRORS.get(n, n)}")
    return n


def _inbuf(buf: bytes) -> np.ndarray:
    return np.frombuffer(buf, np.uint8) if len(buf) else np.zeros(1, np.uint8)


def rle_decode_array(buf: bytes, signed_vals: bool, capacity: int):
    """(int64 values, bool validity) of at most ``capacity`` rows of an RLE
    column; raises ValueError on malformed bytes."""
    vals = np.empty(capacity, np.int64)
    mask = np.empty(capacity, np.uint8)
    b = _inbuf(buf)
    n = load().am_rle_decode_i64(_u8(b), len(buf), int(signed_vals), _i64(vals),
                                 _u8(mask), capacity)
    if n < 0:
        raise ValueError("malformed RLE column")
    return vals[:n], mask[:n].astype(bool)


def delta_decode_array(buf: bytes, capacity: int):
    """(int64 values, bool validity) of at most ``capacity`` rows of a delta
    column; raises ValueError on malformed bytes."""
    vals = np.empty(capacity, np.int64)
    mask = np.empty(capacity, np.uint8)
    b = _inbuf(buf)
    n = load().am_delta_decode_i64(_u8(b), len(buf), _i64(vals), _u8(mask),
                                   capacity)
    if n < 0:
        raise ValueError("malformed delta column")
    return vals[:n], mask[:n].astype(bool)


def bool_decode_array(buf: bytes, capacity: int) -> np.ndarray:
    """At most ``capacity`` rows of a boolean column; raises ValueError on
    malformed bytes."""
    out = np.empty(capacity, np.uint8)
    b = _inbuf(buf)
    n = load().am_bool_decode(_u8(b), len(buf), _u8(out), capacity)
    if n < 0:
        raise ValueError("malformed boolean column")
    return out[:n].astype(bool)


def rle_encode_array(values: np.ndarray, mask: np.ndarray, signed_vals: bool) -> bytes:
    """RLE column bytes of int64 ``values`` (``mask`` 0 = null)."""
    v = np.ascontiguousarray(values, np.int64)
    m = np.ascontiguousarray(mask, np.uint8)
    out = np.empty(12 * len(v) + 32, np.uint8)
    w = load().am_rle_encode_i64(_i64(v), _u8(m), len(v), int(signed_vals),
                                 _u8(out), len(out))
    if w < 0:
        raise ValueError("rle encode: output overflow")
    return out[:w].tobytes()


def delta_encode_array(values: np.ndarray, mask: np.ndarray) -> bytes:
    """Delta column bytes of int64 ``values`` (``mask`` 0 = null)."""
    v = np.ascontiguousarray(values, np.int64)
    m = np.ascontiguousarray(mask, np.uint8)
    out = np.empty(12 * len(v) + 32, np.uint8)
    scratch = np.empty(max(len(v), 1), np.int64)
    w = load().am_delta_encode_i64(_i64(v), _u8(m), len(v), _u8(out), len(out),
                                   _i64(scratch))
    if w < 0:
        raise ValueError("delta encode: output overflow")
    return out[:w].tobytes()


def bool_encode_array(values: np.ndarray) -> bytes:
    """Boolean column bytes of ``values`` (nonzero = true)."""
    v = np.ascontiguousarray(values, np.uint8)
    out = np.empty(11 * len(v) + 32, np.uint8)
    w = load().am_bool_encode(_u8(v), len(v), _u8(out), len(out))
    if w < 0:
        raise ValueError("bool encode: output overflow")
    return out[:w].tobytes()


def rle_encode_strtab(ids: np.ndarray, table) -> bytes:
    """String RLE column bytes from ids into ``table`` (-1 = null), equal
    to ``RleEncoder("str")`` over the looked-up strings."""
    ids = np.ascontiguousarray(ids, np.int64)
    raws = [s.encode("utf-8") for s in table]
    tab_len = np.asarray([len(r) for r in raws] or [0], np.int64)
    tab_off = np.concatenate([[0], np.cumsum(tab_len)]).astype(np.int64)
    tab_buf = _inbuf(b"".join(raws))
    # every row costs at most a header, a length and its bytes
    total = int(tab_len[ids[ids >= 0]].sum()) if len(raws) else 0
    out = np.empty(20 * len(ids) + total + 32, np.uint8)
    w = load().am_rle_encode_strtab(_i64(ids), len(ids), _i64(tab_off),
                                    _i64(tab_len), _u8(tab_buf), _u8(out), len(out))
    if w < 0:
        raise ValueError("strtab encode: output overflow")
    return out[:w].tobytes()


def _splice_error(code: int):
    """Session splice failures carry the same typed error and wording as
    the Python transaction path (errors.AutomergeError)."""
    from ..errors import AutomergeError

    if code == -2:
        return AutomergeError("splice: delete past end of sequence")
    return AutomergeError("splice: index out of bounds")


def _cp_widths(cps: np.ndarray) -> np.ndarray:
    """Per-codepoint text widths for the configured encoding
    (reference: text_value.rs width-per-encoding)."""
    from ..types import get_text_encoding

    enc = get_text_encoding()
    if enc == "utf16":
        return np.where(cps > 0xFFFF, 2, 1).astype(np.int32)
    if enc == "utf8":
        return (
            1
            + (cps > 0x7F).astype(np.int32)
            + (cps > 0x7FF).astype(np.int32)
            + (cps > 0xFFFF).astype(np.int32)
        ).astype(np.int32)
    return np.ones(len(cps), np.int32)
class EditSession:
    """The native text-edit session (session.cpp): owns one text object's
    visible-element state inside a transaction; splices resolve in C++."""

    __slots__ = ("_lib", "_h", "_splice_fn", "_len_fn", "_one_cp", "_one_w", "_one_cp_p", "_one_w_p")

    def __init__(self, rank: int):
        lib = load()
        self._lib = lib
        # hot-path plumbing: bound function refs + a reusable 1-codepoint
        # buffer with a precomputed ctypes pointer (typing workloads are
        # dominated by single-character splices)
        self._splice_fn = lib.am_edit_splice
        self._len_fn = lib.am_edit_length
        self._one_cp = np.empty(1, np.int32)
        self._one_w = np.ones(1, np.int32)
        self._one_cp_p = _i32(self._one_cp)
        self._one_w_p = _i32(self._one_w)
        self._h = lib.am_edit_create(rank)

    def close(self) -> None:
        if self._h:
            self._lib.am_edit_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def init(self, elem_ids: np.ndarray, winner_ids: np.ndarray, widths: np.ndarray) -> None:
        e = np.ascontiguousarray(elem_ids, np.int64)
        w = np.ascontiguousarray(winner_ids, np.int64)
        wd = np.ascontiguousarray(widths, np.int32)
        self._lib.am_edit_init(self._h, _i64(e), _i64(w), _i32(wd), len(e))

    def length(self) -> int:
        return int(self._len_fn(self._h))

    def op_count(self) -> int:
        return int(self._lib.am_edit_op_count(self._h))

    def splice(self, ctr0: int, pos: int, ndel: int, text: str) -> int:
        """Emit ops for one splice; op ids are ctr0..ctr0+n-1. Returns the
        number of ops emitted; raises on out-of-bounds."""
        nt = len(text)
        if nt == 1:
            cp = ord(text)
            self._one_cp[0] = cp
            if cp > 0x7F:
                from ..types import get_text_encoding

                enc = get_text_encoding()
                self._one_w[0] = (
                    1 + (cp > 0x7F) + (cp > 0x7FF) + (cp > 0xFFFF)
                    if enc == "utf8"
                    else (2 if enc == "utf16" and cp > 0xFFFF else 1)
                )
            else:
                self._one_w[0] = 1
            n = self._splice_fn(self._h, ctr0, pos, ndel, self._one_cp_p, self._one_w_p, 1)
        elif nt == 0:
            n = self._splice_fn(self._h, ctr0, pos, ndel, self._one_cp_p, self._one_w_p, 0)
        else:
            cps = np.frombuffer(text.encode("utf-32-le"), np.uint32).astype(np.int32)
            widths = _cp_widths(cps)
            n = self._splice_fn(self._h, ctr0, pos, ndel, _i32(cps), _i32(widths), nt)
        if n < 0:
            raise _splice_error(int(n))
        return int(n)

    def splice_batch(self, ctr0: int, edits, clamp: bool = True) -> int:
        """Apply many (pos, ndel, text) edits in ONE native call (the
        bulk-ingest path); with ``clamp``, positions and delete counts are
        clamped to the live length per edit. Returns total ops emitted."""
        n = len(edits)
        # vectorized batch prep: the former per-edit python loop cost more
        # than the native splices themselves on full-trace ingests
        pos = np.fromiter((e[0] for e in edits), np.int64, count=n)
        ndel = np.fromiter((e[1] for e in edits), np.int64, count=n)
        texts = [e[2] if len(e) == 3 else ("".join(e[2:]) if len(e) > 3 else "") for e in edits]
        off = np.empty(n + 1, np.int64)
        off[0] = 0
        np.cumsum(
            np.fromiter(map(len, texts), np.int64, count=n), out=off[1:]
        )
        all_text = "".join(texts)
        if all_text:
            cps = np.frombuffer(all_text.encode("utf-32-le"), np.uint32).astype(np.int32)
            widths = _cp_widths(cps)
        else:
            cps = np.zeros(1, np.int32)
            widths = np.ones(1, np.int32)
        r = self._lib.am_edit_splice_batch(
            self._h, ctr0, _i64(pos), _i64(ndel), _i64(off), _i32(cps),
            _i32(widths), n, 1 if clamp else 0,
        )
        if r < 0:
            raise _splice_error(int(r))
        return int(r)

    def export(self, start: int = 0):
        """Emitted ops [start:] in id order: dict of numpy arrays."""
        n = max(self.op_count() - start, 0)
        ids = np.empty(max(n, 1), np.int64)
        refs = np.empty(max(n, 1), np.int64)
        preds = np.empty(max(n, 1), np.int64)
        cps = np.empty(max(n, 1), np.int32)
        widths = np.empty(max(n, 1), np.int32)
        is_del = np.empty(max(n, 1), np.uint8)
        self._lib.am_edit_export(
            self._h, start, _i64(ids), _i64(refs), _i64(preds), _i32(cps),
            _i32(widths), _u8(is_del),
        )
        return {
            "id": ids[:n], "elem_ref": refs[:n], "pred": preds[:n],
            "cp": cps[:n], "width": widths[:n], "is_del": is_del[:n].astype(bool),
        }

    def order(self) -> np.ndarray:
        """Current visible element ids in document order."""
        cap = 1024
        while True:
            out = np.empty(cap, np.int64)
            n = int(self._lib.am_edit_order(self._h, _i64(out), cap))
            if n <= cap:
                return out[:n]
            cap = n


class MapSession:
    """The native map-put session (map_session.cpp): owns one map object's
    visible-winner state inside a transaction; per-op puts resolve pred and
    encode the value payload in C (fastcall map_put entry)."""

    __slots__ = ("_lib", "_h")

    def __init__(self, rank: int):
        lib = load()
        self._lib = lib
        self._h = lib.am_map_create(rank)

    def close(self) -> None:
        if self._h:
            self._lib.am_map_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def init(self, keys, winner_ids: np.ndarray) -> None:
        """Preload existing visible keys (utf-8 strings) with winner ids."""
        raws = [k.encode("utf-8") for k in keys]
        offs = np.zeros(len(raws) + 1, np.int64)
        if raws:
            np.cumsum([len(r) for r in raws], out=offs[1:])
        buf = _inbuf(b"".join(raws))
        w = np.ascontiguousarray(winner_ids, np.int64)
        if len(w) == 0:
            w = np.zeros(1, np.int64)
        self._lib.am_map_init(self._h, _u8(buf), _i64(offs), _i64(w), len(raws))

    def op_count(self) -> int:
        return int(self._lib.am_map_op_count(self._h))

    def put(self, ctr: int, key: str, code: int, ival: int = 0,
            fval: float = 0.0, raw: bytes = b"") -> int:
        """ctypes put (tests / non-fastcall paths); the hot path goes
        through fastcall.map_put instead."""
        kb = key.encode("utf-8")
        rb = _inbuf(raw)
        return int(self._lib.am_map_put(
            self._h, ctr, kb, len(kb), code, ival, fval, _u8(rb), len(raw)
        ))

    def export(self, start: int = 0):
        """Emitted ops [start:] in id order: dict of numpy arrays plus the
        raw value payload blob and the interned key table."""
        n_rows = np.zeros(1, np.int64)
        raw_bytes = np.zeros(1, np.int64)
        self._lib.am_map_export_sizes(self._h, start, _i64(n_rows), _i64(raw_bytes))
        n = int(n_rows[0])
        rb = int(raw_bytes[0])
        ids = np.empty(max(n, 1), np.int64)
        key_idx = np.empty(max(n, 1), np.int64)
        preds = np.empty(max(n, 1), np.int64)
        vmeta = np.empty(max(n, 1), np.int64)
        raw = np.empty(max(rb, 1), np.uint8)
        self._lib.am_map_export(
            self._h, start, _i64(ids), _i64(key_idx), _i64(preds),
            _i64(vmeta), _u8(raw),
        )
        nk = np.zeros(1, np.int64)
        kb = np.zeros(1, np.int64)
        self._lib.am_map_keytab_sizes(self._h, _i64(nk), _i64(kb))
        kbytes = np.empty(max(int(kb[0]), 1), np.uint8)
        koffs = np.empty(int(nk[0]) + 1, np.int64)
        self._lib.am_map_keytab(self._h, _u8(kbytes), _i64(koffs))
        blob = kbytes[: int(kb[0])].tobytes()
        keys = [
            blob[int(koffs[i]):int(koffs[i + 1])].decode("utf-8")
            for i in range(int(nk[0]))
        ]
        return {
            "id": ids[:n], "key_idx": key_idx[:n], "pred": preds[:n],
            "vmeta": vmeta[:n], "raw": raw[:rb].tobytes(), "keys": keys,
        }
