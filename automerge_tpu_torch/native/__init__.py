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
    out = library_path()
    if out.exists():
        return 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeUnavailable("g++ not found: the native library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # the kernel releases the lock with its holder, even one that was killed
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built by the holder this process waited for
            return 0.0
        return _compile(gxx, out)


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
    _lib = lib
    return _lib


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
