"""Crash-injection filesystem: kill-at-every-write-boundary, torn writes,
and rename reordering for the durable layer.

``SimFS`` implements the same narrow interface as ``journal.OsFS`` but
keeps everything in memory and models *durability* separately from
*visibility*:

* every file tracks the bytes the live process sees (``data``) and the
  bytes known to have reached stable storage (``synced`` — updated only
  by ``fsync``);
* ``replace`` (atomic rename) takes effect immediately for the live
  process but stays on a *pending* list until ``sync_dir`` commits it —
  so a crash can observe a rename that never became durable, or (the
  classic reordering bug) a durable rename pointing at a file whose
  un-fsynced contents were lost.

Every mutating operation (write / fsync / replace / truncate / sync_dir /
create) is a numbered *crash boundary*: constructing the FS with
``crash_at=k`` raises ``CrashPoint`` instead of performing boundary
``k``. A harness first runs its workload with ``crash_at=None`` to count
boundaries, then sweeps ``k`` over all of them.

After a ``CrashPoint``, ``crash_states(rng)`` enumerates plausible
post-crash disk images: the conservative one (only fsynced bytes and
committed renames survive), the optimistic one (everything visible
survives), and seeded intermediates with *torn* files (a prefix of the
un-fsynced tail persisted) and partially-applied rename queues. Each
image reopens via ``SimFS.from_disk`` — a fresh, fault-free FS — and the
property suite asserts the durable layer recovers to a prefix-consistent
document from every one of them.

Modeling limits (documented, deliberate): file *creation* is treated as
immediately durable (only rename and write-content durability are
modeled), and writes are applied straight to the file image (no separate
userspace buffer — torn-tail states subsume it).
"""

from __future__ import annotations

import errno as _errno
import posixpath
import random
import threading
from typing import Dict, List, Optional, Tuple


class CrashPoint(Exception):
    """The scheduled crash boundary was reached; the workload is dead."""


class _Node:
    __slots__ = ("data", "synced")

    def __init__(self, data: bytes = b"", synced: bytes = b""):
        self.data = bytearray(data)
        self.synced = bytes(synced)


class SimFile:
    """A file handle over a SimFS node; mutations tick the crash clock."""

    def __init__(self, fs: "SimFS", node: _Node, pos: int, readable: bool,
                 writable: bool, append: bool = False):
        self._fs = fs
        self._node = node
        self._pos = pos
        self._readable = readable
        self._writable = writable
        self._append = append  # O_APPEND: every write lands at current EOF
        self.closed = False

    def _check(self, write: bool) -> None:
        if self.closed:
            raise ValueError("I/O operation on closed file")
        if write and not self._writable:
            raise ValueError("file not open for writing")
        if not write and not self._readable:
            raise ValueError("file not open for reading")

    def write(self, data: bytes) -> int:
        self._check(write=True)
        self._fs._tick(("write", len(data)))
        d = self._node.data
        pos = len(d) if self._append else self._pos
        end = pos + len(data)
        if pos > len(d):  # sparse seek past EOF: zero-fill like POSIX
            d.extend(b"\x00" * (pos - len(d)))
        d[pos:end] = data
        self._pos = end
        return len(data)

    def read(self, n: int = -1) -> bytes:
        self._check(write=False)
        d = self._node.data
        if n is None or n < 0:
            out = bytes(d[self._pos :])
        else:
            out = bytes(d[self._pos : self._pos + n])
        self._pos += len(out)
        return out

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = pos
        elif whence == 1:
            self._pos += pos
        elif whence == 2:
            self._pos = len(self._node.data) + pos
        else:
            raise ValueError(f"bad whence {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def truncate(self, size: Optional[int] = None) -> int:
        self._check(write=True)
        if size is None:
            size = self._pos
        self._fs._tick(("truncate", size))
        del self._node.data[size:]
        return size

    def flush(self) -> None:
        pass  # no userspace buffer to flush (see module docstring)

    def close(self) -> None:
        self.closed = True

    def fileno(self):  # real os.fsync must never be handed a SimFile
        raise OSError("SimFile has no OS-level file descriptor")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class SimFS:
    """In-memory filesystem with crash-boundary accounting.

    Interface-compatible with ``journal.OsFS``; see the module docstring
    for the durability model.
    """

    def __init__(self, crash_at: Optional[int] = None):
        self.files: Dict[str, _Node] = {}  # visible namespace
        # renames visible to the process but not yet committed to the
        # durable namespace: (dst, node-now-at-dst, node-previously-at-dst)
        self.pending_renames: List[Tuple[str, _Node, Optional[Tuple[str, _Node]]]] = []
        self.ops = 0
        self.crash_at = crash_at
        self.crashed = False
        self.op_trace: List[tuple] = []  # (kind, detail) per boundary

    # -- crash clock ---------------------------------------------------------

    def _tick(self, what: tuple) -> None:
        if self.crashed:
            raise CrashPoint("filesystem already crashed")
        self.ops += 1
        self.op_trace.append(what)
        if self.crash_at is not None and self.ops >= self.crash_at:
            self.crashed = True
            raise CrashPoint(f"crash at boundary {self.ops}: {what}")

    # -- OsFS interface ------------------------------------------------------

    def open(self, path: str, mode: str):
        path = self._norm(path)
        node = self.files.get(path)
        if mode == "rb":
            if node is None:
                raise FileNotFoundError(path)
            return SimFile(self, node, 0, readable=True, writable=False)
        if mode == "wb":
            self._tick(("create", path))
            node = _Node()
            self.files[path] = node
            return SimFile(self, node, 0, readable=False, writable=True)
        if mode == "ab":
            if node is None:
                self._tick(("create", path))
                node = _Node()
                self.files[path] = node
            return SimFile(self, node, len(node.data), readable=False,
                           writable=True, append=True)
        if mode == "r+b":
            if node is None:
                raise FileNotFoundError(path)
            return SimFile(self, node, 0, readable=True, writable=True)
        raise ValueError(f"unsupported mode {mode!r}")

    def fsync(self, f: SimFile) -> None:
        self._tick(("fsync",))
        f._node.synced = bytes(f._node.data)

    def replace(self, src: str, dst: str) -> None:
        src, dst = self._norm(src), self._norm(dst)
        node = self.files.get(src)
        if node is None:
            raise FileNotFoundError(src)
        self._tick(("replace", src, dst))
        prev = self.files.get(dst)
        prev_entry = (dst, prev) if prev is not None else None
        self.files[dst] = node
        del self.files[src]
        self.pending_renames.append((dst, node, prev_entry))

    def sync_dir(self, path: str) -> None:
        p = self._norm(path)
        self._tick(("sync_dir", p))
        # commits only renames into THIS directory — an fsync of the wrong
        # directory must be as ineffective in the sweep as on a real fs
        self.pending_renames = [
            e for e in self.pending_renames
            if posixpath.dirname(self._norm(e[0])) != p
        ]

    def exists(self, path: str) -> bool:
        return self._norm(path) in self.files

    def getsize(self, path: str) -> int:
        return len(self.files[self._norm(path)].data)

    def read_bytes(self, path: str) -> bytes:
        return bytes(self.files[self._norm(path)].data)

    def makedirs(self, path: str) -> None:
        pass  # flat namespace: directories are implicit

    def lock(self, f) -> None:
        pass  # one SimFS instance models one process: no cross-process races

    def remove(self, path: str) -> None:
        path = self._norm(path)
        self._tick(("remove", path))
        self.files.pop(path, None)

    @staticmethod
    def _norm(path: str) -> str:
        return posixpath.normpath(str(path))

    # -- crash-state enumeration ---------------------------------------------

    def _namespace_at(self, renames_applied: int) -> Dict[str, _Node]:
        """The durable namespace with only the first ``renames_applied``
        pending renames committed: later ones are undone in reverse."""
        ns = dict(self.files)
        for dst, node, prev_entry in reversed(
            self.pending_renames[renames_applied:]
        ):
            # undo: dst reverts to its previous occupant (or nothing); the
            # renamed node reappears under a synthetic .tmp-limbo name only
            # if it never became visible elsewhere — recovery must not rely
            # on it, so it is simply dropped from the image.
            if ns.get(dst) is node:
                if prev_entry is not None:
                    ns[dst] = prev_entry[1]
                else:
                    ns.pop(dst, None)
        return ns

    @staticmethod
    def _content_candidates(node: _Node, rng: random.Random, mode: str) -> bytes:
        """One plausible post-crash content for ``node`` under ``mode``:
        'clean' (fsynced bytes only), 'all' (everything), 'torn' (a seeded
        prefix of the un-fsynced delta survives)."""
        data, synced = bytes(node.data), node.synced
        if mode == "all":
            return data
        if data.startswith(synced):
            if mode == "clean":
                return synced
            extra = len(data) - len(synced)
            keep = rng.randrange(extra + 1) if extra else 0
            return data[: len(synced) + keep]
        # data diverged from synced (unsynced truncate/rewrite): the disk
        # may hold the old image, the new one, or a prefix of the new one
        if mode == "clean":
            return synced
        return data[: rng.randrange(len(data) + 1)] if data else b""

    def crash_states(
        self, rng: Optional[random.Random] = None, variants: int = 3
    ) -> List[Dict[str, bytes]]:
        """Plausible disk images after the crash: conservative, optimistic,
        and ``variants`` seeded torn/reordered intermediates."""
        rng = rng or random.Random(0)
        states: List[Dict[str, bytes]] = []
        n_pend = len(self.pending_renames)
        # conservative: nothing un-fsynced survives, no pending rename landed
        states.append(
            {p: n.synced for p, n in self._namespace_at(0).items()}
        )
        # optimistic: everything visible survives
        states.append(
            {p: bytes(n.data) for p, n in self._namespace_at(n_pend).items()}
        )
        for _ in range(variants):
            applied = rng.randint(0, n_pend)
            ns = self._namespace_at(applied)
            mode_for = {
                p: rng.choice(("clean", "torn", "all")) for p in ns
            }
            states.append(
                {
                    p: self._content_candidates(n, rng, mode_for[p])
                    for p, n in ns.items()
                }
            )
        return states

    @classmethod
    def from_disk(cls, state: Dict[str, bytes]) -> "SimFS":
        """A fresh, fault-free FS whose durable content is ``state`` —
        what a process sees when it restarts after the crash."""
        fs = cls(crash_at=None)
        for path, data in state.items():
            fs.files[cls._norm(path)] = _Node(data, data)
        return fs


# -- live disk-fault injection ------------------------------------------------


class _FaultyFile:
    """File handle issued by ``FaultyFS``: write-path calls consult the
    armed faults before delegating; everything else passes through."""

    def __init__(self, fs: "FaultyFS", inner):
        self._fs = fs
        self._inner = inner

    def write(self, data):
        self._fs._maybe_fail("write")
        return self._inner.write(data)

    def truncate(self, size=None):
        self._fs._maybe_fail("truncate")
        return self._inner.truncate(size)

    def __getattr__(self, name):  # read/seek/flush/fileno/close/...
        return getattr(self._inner, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._inner.close()
        return False


class FaultyFS:
    """Live disk-fault injection over a real (or simulated) filesystem.

    Where ``SimFS`` models crash boundaries for offline sweeps, this
    wrapper deals I/O errors to a *running* process: arm ``ENOSPC`` on
    write and the journal's next append raises mid-record; arm ``EIO``
    on fsync and the next group-commit fsync fails — which the journal
    answers by poisoning itself (storage/journal.py). Thread-safe and
    zero-overhead-ish when nothing is armed (one lock-free dict read per
    faultable call).

        fs = FaultyFS()
        dd = AutoDoc.open(path, fs=fs)
        fs.arm("fsync", "EIO")          # every fsync fails until cleared
        fs.arm("write", "ENOSPC", count=1)  # exactly the next write
        fs.clear()                      # all faults off

    Ops: ``write``, ``truncate``, ``fsync``, ``replace``, ``sync_dir``,
    ``read``. Every injected fault counts
    ``chaos.injected{kind=disk_<op>}`` so a chaos soak can assert its
    faults actually fired.

    ``read`` is special: armed with the sentinel err ``"BITFLIP"`` it
    models silent bit rot — ``read_bytes`` returns the file's bytes with
    one bit flipped instead of raising, which is exactly the fault class
    only a checksum (the integrity scrub) can catch. Armed with a real
    errno name it raises like any other op."""

    FAULTABLE = ("write", "truncate", "fsync", "replace", "sync_dir",
                 "read")

    def __init__(self, base=None):
        if base is None:
            from .journal import OS_FS

            base = OS_FS
        self.base = base
        self._lock = threading.Lock()
        self._armed: Dict[str, List] = {}  # op -> [errno_name, remaining]

    # -- arming ---------------------------------------------------------------

    def arm(self, op: str, err: str = "EIO", count: int = -1) -> None:
        """Fail the next ``count`` calls of ``op`` (-1 = until cleared)
        with the named errno (``"EIO"``, ``"ENOSPC"``, ...)."""
        if op not in self.FAULTABLE:
            raise ValueError(f"unknown faultable op {op!r}")
        if err != "BITFLIP" and not hasattr(_errno, err):
            raise ValueError(f"unknown errno name {err!r}")
        if err == "BITFLIP" and op != "read":
            raise ValueError("BITFLIP is only meaningful on read")
        with self._lock:
            self._armed[op] = [err, int(count)]

    def clear(self, op: Optional[str] = None) -> None:
        with self._lock:
            if op is None:
                self._armed.clear()
            else:
                self._armed.pop(op, None)

    def armed(self) -> Dict[str, Tuple[str, int]]:
        with self._lock:
            return {op: (e, n) for op, (e, n) in self._armed.items()}

    def _maybe_fail(self, op: str) -> None:
        if not self._armed:  # unarmed fast path, no lock
            return
        with self._lock:
            entry = self._armed.get(op)
            if entry is None:
                return
            err, remaining = entry
            if remaining == 0:
                self._armed.pop(op, None)
                return
            if remaining > 0:
                entry[1] = remaining - 1
                if entry[1] == 0:
                    self._armed.pop(op, None)
        from .. import obs

        obs.count("chaos.injected", labels={"kind": f"disk_{op}"})
        code = getattr(_errno, err)
        raise OSError(code, f"injected {err} on {op}")

    def _consume(self, op: str):
        """Decrement and return the armed err name for ``op`` (None when
        unarmed) WITHOUT raising — the BITFLIP read path corrupts the
        returned bytes instead of failing the call."""
        with self._lock:
            entry = self._armed.get(op)
            if entry is None:
                return None
            err, remaining = entry
            if remaining == 0:
                self._armed.pop(op, None)
                return None
            if remaining > 0:
                entry[1] = remaining - 1
                if entry[1] == 0:
                    self._armed.pop(op, None)
            return err

    # -- the OsFS interface ---------------------------------------------------

    def open(self, path: str, mode: str):
        f = self.base.open(path, mode)
        return _FaultyFile(self, f)

    def fsync(self, f) -> None:
        self._maybe_fail("fsync")
        self.base.fsync(f._inner if isinstance(f, _FaultyFile) else f)

    def replace(self, src: str, dst: str) -> None:
        self._maybe_fail("replace")
        self.base.replace(src, dst)

    def sync_dir(self, path: str) -> None:
        self._maybe_fail("sync_dir")
        self.base.sync_dir(path)

    def exists(self, path: str) -> bool:
        return self.base.exists(path)

    def getsize(self, path: str) -> int:
        return self.base.getsize(path)

    def read_bytes(self, path: str) -> bytes:
        err = self._consume("read") if self._armed else None
        if err is not None and err != "BITFLIP":
            from .. import obs

            obs.count("chaos.injected", labels={"kind": "disk_read"})
            raise OSError(getattr(_errno, err), f"injected {err} on read")
        data = self.base.read_bytes(path)
        if err == "BITFLIP" and data:
            from .. import obs

            obs.count("chaos.injected", labels={"kind": "disk_read_flip"})
            # flip one mid-file bit: silent rot, not truncation
            i = len(data) // 2
            data = data[:i] + bytes([data[i] ^ 0x40]) + data[i + 1:]
        return data

    def makedirs(self, path: str) -> None:
        self.base.makedirs(path)

    def remove(self, path: str) -> None:
        self.base.remove(path)

    def lock(self, f) -> None:
        self.base.lock(f._inner if isinstance(f, _FaultyFile) else f)
