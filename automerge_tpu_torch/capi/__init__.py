"""The port's C ABI: ``am.h``, the cdylib ``am_embed.cpp`` that embeds
Python and dispatches every call to ``shim.py``, and the C suites.

``build()`` compiles the cdylib with ``g++`` at first use into
``build/automerge_tpu_torch/capi/libautomerge_tpu_torch-<hash>.so``, the
hash over ``am_embed.cpp``, ``am.h``, ``shim.py``, the compile line and
the interpreter it links, under the native library's lock (``native.lock``),
so processes that need it at once build it once and none loads a partial
file. ``build_test()`` compiles one C program (a suite of
``TEST_SOURCES``, or the typist ``type_edits.c``) against it with
``gcc``. A compiler
that is missing or fails raises ``NativeUnavailable``; there is no
fallback.

A C program links only the library and includes ``am.h``. The library's
embedded interpreter imports ``automerge_tpu_torch`` from the repository
root baked into it (``AUTOMERGE_TPU_TORCH_PYROOT`` overrides it) and
``torch`` and ``numpy`` from ``PYTHONPATH`` (``python_path()`` gives the
running interpreter's). Documents live on the device that
``AUTOMERGE_TPU_TORCH_DEVICE`` names (``shim.py``).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import tempfile
import time
from pathlib import Path
from typing import Optional

from ..native import BUILD_DIR, NativeUnavailable, _build_once

_HERE = Path(__file__).resolve().parent
HEADER = _HERE / "am.h"
_SRC = _HERE / "am_embed.cpp"
_REPO_ROOT = _HERE.parents[1]
OUT_DIR = BUILD_DIR / "capi"

TEST_SOURCES = (
    "test_am.c", "test_basic.c", "test_sync.c", "test_ported2.c",
    "test_ported3.c",
)


def _embed_flags() -> tuple[list, list]:
    inc = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    version = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var(
        "VERSION"
    )
    return [f"-I{inc}"], [f"-L{libdir}", f"-lpython{version}", "-ldl", "-lm"]


def _compile_cmd(out: str) -> list:
    cflags, ldflags = _embed_flags()
    return [
        "-O2", "-shared", "-fPIC", "-std=c++17",
        f'-DAM_PYROOT="{_REPO_ROOT}"',
        *cflags, "-o", out, str(_SRC), *ldflags,
    ]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_compile_cmd("")).encode())
    for p in (_SRC, HEADER, _HERE / "shim.py"):
        h.update(p.read_bytes())
    return OUT_DIR / f"libautomerge_tpu_torch-{h.hexdigest()[:16]}.so"


def _compile(gxx: str, out: Path) -> float:
    t0 = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        tmp_lib = Path(tmp) / out.name
        cmd = [gxx, *_compile_cmd(str(tmp_lib))]
        r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if r.returncode != 0 or not tmp_lib.exists():
            raise NativeUnavailable(
                f"g++ failed to build the C ABI library:\n{' '.join(cmd)}\n"
                + r.stdout.decode(errors="replace"))
        os.replace(tmp_lib, out)
    return time.perf_counter() - t0


def build() -> str:
    """Build (or reuse) the cdylib; returns its path."""
    out = library_path()
    _build_once(out, "g++", "the C ABI library", _compile)
    return str(out)


def build_test(lib_path: str, out_dir: Optional[str] = None,
               source: str = "test_am.c", shared: bool = False) -> str:
    """Compile one C program of this directory against the cdylib; returns
    the executable's path (in ``out_dir``, by default the library's). With
    ``shared`` it is a shared library ``lib<name>.so`` instead, built with
    ``-DAM_TYPE_EDITS_NO_MAIN`` (``type_edits.c``'s entry for a caller in
    the same process, loaded with ``ctypes``)."""
    out_dir = out_dir or os.path.dirname(lib_path)
    stem = os.path.splitext(source)[0]
    exe = os.path.join(out_dir, f"lib{stem}.so" if shared else stem)
    cmd = [
        "gcc", "-O1", "-o", exe, str(_HERE / source),
        *(("-shared", "-fPIC", "-DAM_TYPE_EDITS_NO_MAIN") if shared else ()),
        f"-I{_HERE}", lib_path, f"-Wl,-rpath,{os.path.dirname(lib_path)}",
    ]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeUnavailable(f"gcc cannot build {source}: {e}") from e
    if r.returncode != 0:
        raise NativeUnavailable(
            f"gcc failed to build {source}:\n{' '.join(cmd)}\n"
            + r.stderr.decode(errors="replace"))
    return exe


def python_path() -> str:
    """``PYTHONPATH`` for a C program: the running interpreter's ``sys.path``
    directories, so the embedded one finds ``torch`` and ``numpy`` wherever
    they are installed."""
    return os.pathsep.join(p for p in sys.path if p and os.path.isdir(p))
