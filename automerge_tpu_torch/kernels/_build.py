"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``. The
sources compile in parallel, one ``nvcc`` each, and link into
``build/automerge_tpu_torch/libamt_kernels_<hash>.so`` beside the package,
where the hash covers the sources and the flags: a build is reused until
a source changes. Nothing is built at import time; the first kernel launch
(or ``build()``) builds. Threads and processes that need the library at
once build it once: one holds a lock on
``build/automerge_tpu_torch/kernels.lock`` while ``nvcc`` runs, the others
wait on it and then load what it moved into place.
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

import torch

from ._args import Stream

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "automerge_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_lib = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libamt_kernels_{_digest()}.so"


def build() -> float:
    """Compile the kernels unless an up-to-date library exists; returns
    the seconds spent (0.0 when the cached library was reused)."""
    out = library_path()
    if out.exists():
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one nvcc run at a time, across threads (a server's workers launching
    # at once) and processes; the kernel releases the lock with its holder
    with open(BUILD_DIR / "kernels.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built by the holder this caller waited for
            return 0.0
        return _compile(nvcc, out)


def _compile(nvcc: str, out: Path) -> float:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for cmd, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{log.decode(errors='replace')}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)]
        r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed:\n{' '.join(cmd)}\n"
                + r.stdout.decode(errors="replace"))
        os.replace(tmp_lib, out)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        lib.amt_error_string.argtypes = [ctypes.c_int]
        lib.amt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


P_ = ctypes.c_void_p
I_ = ctypes.c_int
U_ = ctypes.c_uint
LL_ = ctypes.c_longlong

_entries = {}
# the current card's index, read without torch.cuda's lazy-init check
# (CUDA builds of PyTorch have it)
_current_card = getattr(torch._C, "_cuda_getDevice", None)


def _entry(name: str, argtypes):
    """The C entry point ``name``, its argument types set once."""
    fn = getattr(library(), name)
    fn.argtypes = [*argtypes, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    _entries[name] = fn
    return fn


def launch(name: str, argtypes, *args) -> int:
    """Call the C entry point ``name`` with ``args`` (declared as
    ``argtypes``) and return the number of kernels it launched; raise on
    the cudaError_t it returns. Every entry point takes, after ``args``, a
    host int that it raises by one per kernel launch. The last of ``args``
    is a ``Stream``: its handle is passed, and its card is the current
    device for the call (entered only when another card is current): a
    kernel launches on the current device, so a stream of another card
    would be refused."""
    fn = _entries.get(name) or _entry(name, argtypes)
    *raw, st = args
    launched = ctypes.c_int(0)
    if _current_card is not None and _current_card() == st.device.index:
        rc = fn(*raw, st.handle, ctypes.byref(launched))
    else:
        with torch.cuda.device(st.device):
            rc = fn(*raw, st.handle, ctypes.byref(launched))
    if rc != 0:
        msg = library().amt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    return launched.value
