"""Chaos fabric: a seeded, scriptable TCP fault interposer.

``ChaosProxy`` generalizes the in-process ``FaultyChannel``
(sync/faults.py) to real sockets: it sits between router↔node and
leader↔follower links as a transparent byte pump that can, per
direction,

* **drop** a read chunk (seeded probability — on a line-framed protocol
  this garbles at most the frames the chunk covered; both the router and
  the server tolerate garbled lines, and the retry layer owns the rest),
* **corrupt** a read chunk (seeded probability): one byte of the chunk
  is bit-flipped before forwarding — a payload that still parses as a
  frame carries silently-wrong bytes, the wire analogue of disk bit rot
  (a garbled frame is rejected at the framing layer; a *valid* frame
  with corrupt content is what the integrity digests exist to catch),
* **delay** every chunk by a fixed latency,
* **throttle** to a byte rate,
* **reorder** a chunk behind its successor (seeded probability),
* **black-hole** one direction entirely — the *asymmetric partition*:
  requests still arrive, responses never return (or vice versa), the
  deadlock-shaped failure a symmetric kill can never produce,
* **sever** every live connection (and refuse new ones) until
  ``heal()``.

Everything stochastic draws from one seeded RNG per proxy, so a fault
sequence is reproducible from its seed. Every injected fault counts
``chaos.injected{kind=...}`` — a soak asserts its faults actually fired
instead of vacuously passing.

``ChaosSchedule`` runs a scripted timeline of fault actions on a
background thread::

    p = ChaosProxy(target="127.0.0.1:7001", seed=3); p.start()
    sched = ChaosSchedule()
    sched.at(2.0, "partition", lambda: p.partition("s2c"))
    sched.at(6.0, "heal", lambda: p.heal())
    sched.start(); ...; sched.join()

The schedule itself is plain data (sorted ``(at, label)`` steps), so two
schedules built from the same seed compare equal — the determinism the
``CHAOS_SEED`` replay workflow relies on.

The port of ``automerge_tpu/cluster/chaos.py``, unchanged: one seed
gives both packages the same faults.
"""

from __future__ import annotations

import contextlib
import random
import socket
import threading
import time
from typing import Callable, List, Optional, Tuple

from .. import obs

_CHUNK = 64 << 10

DIRECTIONS = ("c2s", "s2c")


def _count(kind: str) -> None:
    obs.count("chaos.injected", labels={"kind": kind})


class LinkPolicy:
    """Per-direction fault dials for one proxy. Mutable at runtime (the
    schedule flips them live); reads are lock-free snapshots of floats
    and bools, which Python assigns atomically."""

    __slots__ = ("drop", "reorder", "delay_s", "throttle_bps", "blackhole",
                 "corrupt")

    def __init__(self, drop: float = 0.0, reorder: float = 0.0,
                 delay_s: float = 0.0, throttle_bps: float = 0.0,
                 blackhole: bool = False, corrupt: float = 0.0):
        self.drop = drop
        self.reorder = reorder
        self.delay_s = delay_s
        self.throttle_bps = throttle_bps
        self.blackhole = blackhole
        self.corrupt = corrupt


class _Pipe:
    """One direction of one proxied connection."""

    def __init__(self, proxy: "ChaosProxy", direction: str,
                 src: socket.socket, dst: socket.socket, rng: random.Random):
        self.proxy = proxy
        self.direction = direction
        self.src = src
        self.dst = dst
        self.rng = rng
        self._held: Optional[bytes] = None  # chunk waiting to be overtaken

    def run(self) -> None:
        try:
            while True:
                try:
                    chunk = self.src.recv(_CHUNK)
                except OSError:
                    break
                if not chunk:
                    break
                if not self._forward(chunk):
                    break
        finally:
            # flush a held (reordered) chunk rather than silently eat it:
            # reorder means late, not lost
            held, self._held = self._held, None
            if held is not None:
                with contextlib.suppress(OSError):
                    self.dst.sendall(held)
            # half-close so the peer sees EOF on this direction only
            with contextlib.suppress(OSError):
                self.dst.shutdown(socket.SHUT_WR)
            with contextlib.suppress(OSError):
                self.src.shutdown(socket.SHUT_RD)

    def _forward(self, chunk: bytes) -> bool:
        pol = self.proxy.policy(self.direction)
        if pol.blackhole:
            # asymmetric partition: swallow, keep reading (the socket
            # stays up — the far side sees silence, not a reset)
            _count(f"blackhole_{self.direction}")
            return True
        if pol.drop and self.rng.random() < pol.drop:
            _count("drop")
            return True
        if pol.corrupt and self.rng.random() < pol.corrupt:
            _count("corrupt")
            i = self.rng.randrange(len(chunk))
            chunk = chunk[:i] + bytes([chunk[i] ^ 0x40]) + chunk[i + 1:]
        if pol.delay_s:
            _count("delay")
            time.sleep(pol.delay_s)
        if pol.throttle_bps:
            _count("throttle")
            time.sleep(len(chunk) / pol.throttle_bps)
        out = chunk
        if self._held is not None:
            out = chunk + self._held  # the held chunk arrives LATE
            self._held = None
        elif pol.reorder and self.rng.random() < pol.reorder:
            _count("reorder")
            self._held = chunk
            return True
        try:
            self.dst.sendall(out)
        except OSError:
            return False
        return True


class ChaosProxy:
    """A TCP interposer between one upstream and its clients.

    ``target`` is ``"host:port"``; the proxy listens on its own
    ``address`` and pumps bytes both ways through the fault policies.
    All control methods are safe to call from any thread at any time.
    """

    def __init__(self, target: str, *, host: str = "127.0.0.1",
                 port: int = 0, seed: int = 0, name: Optional[str] = None):
        thost, _, tport = target.rpartition(":")
        self.target = (thost or "127.0.0.1", int(tport))
        self.name = name or f"chaos->{target}"
        self._host = host
        self._port = port
        self._rng = random.Random(seed)
        self._policies = {d: LinkPolicy() for d in DIRECTIONS}
        self._severed = False
        self._listener: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._conns: List[Tuple[socket.socket, socket.socket]] = []
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> str:
        assert self._listener is not None, "proxy not started"
        return "%s:%d" % self._listener.getsockname()[:2]

    def start(self) -> "ChaosProxy":
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self._host, self._port))
        ls.listen(64)
        self._listener = ls
        threading.Thread(target=self._accept_loop,
                         name=f"{self.name}-accept", daemon=True).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            with contextlib.suppress(OSError):
                self._listener.close()
        self._close_conns()

    def live_connections(self) -> int:
        """Open proxied connection pairs — the fd-leak assertion surface
        (0 after ``stop()`` means no pump stranded its sockets)."""
        with self._lock:
            return len(self._conns)

    # -- fault controls ------------------------------------------------------

    def policy(self, direction: str) -> LinkPolicy:
        return self._policies[direction]

    def set_policy(self, direction: str, **dials) -> None:
        pol = self._policies[direction]
        for k, v in dials.items():
            if k not in LinkPolicy.__slots__:
                raise ValueError(f"unknown policy dial {k!r}")
            setattr(pol, k, v)

    def partition(self, direction: str = "both") -> None:
        """Black-hole one direction (``"c2s"`` / ``"s2c"``) or both.
        Existing connections stay up; bytes in the partitioned direction
        vanish — the asymmetric partition a FIN can never express."""
        dirs = DIRECTIONS if direction == "both" else (direction,)
        for d in dirs:
            if d not in DIRECTIONS:
                raise ValueError(f"unknown direction {d!r}")
            self._policies[d].blackhole = True
        _count(f"partition_{direction}")
        obs.event("chaos.partition", proxy=self.name, direction=direction)

    def sever(self) -> None:
        """Cut every live connection and refuse new ones until heal() —
        the crashed-switch failure (peers see resets, not silence)."""
        self._severed = True
        _count("sever")
        obs.event("chaos.sever", proxy=self.name)
        self._close_conns()

    def heal(self) -> None:
        """Clear partition + sever: new connections flow clean. (Dial
        faults — drop/delay/throttle/reorder — are policy state and stay
        as set.)"""
        for d in DIRECTIONS:
            self._policies[d].blackhole = False
        self._severed = False
        _count("heal")
        obs.event("chaos.heal", proxy=self.name)

    # -- the pump ------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                csock, _ = self._listener.accept()
            except OSError:
                return
            if self._severed:
                with contextlib.suppress(OSError):
                    csock.close()
                continue
            threading.Thread(target=self._serve_conn, args=(csock,),
                             name=f"{self.name}-conn", daemon=True).start()

    def _serve_conn(self, csock: socket.socket) -> None:
        try:
            ssock = socket.create_connection(self.target, timeout=10)
        except OSError:
            with contextlib.suppress(OSError):
                csock.close()
            return
        for s in (csock, ssock):
            with contextlib.suppress(OSError):
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        pair = (csock, ssock)
        with self._lock:
            self._conns.append(pair)
        obs.count("chaos.proxied_connections")
        # deterministic per-connection RNG streams drawn from the proxy
        # seed: thread interleaving cannot reorder WHICH faults fire on a
        # given connection's byte stream
        seeds = (self._rng.randrange(1 << 30), self._rng.randrange(1 << 30))
        pipes = [
            _Pipe(self, "c2s", csock, ssock, random.Random(seeds[0])),
            _Pipe(self, "s2c", ssock, csock, random.Random(seeds[1])),
        ]
        threads = [
            threading.Thread(target=p.run, name=f"{self.name}-{p.direction}",
                             daemon=True)
            for p in pipes
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for s in pair:
            with contextlib.suppress(OSError):
                s.close()
        with self._lock:
            if pair in self._conns:
                self._conns.remove(pair)

    def _close_conns(self) -> None:
        with self._lock:
            conns = list(self._conns)
        for pair in conns:
            for s in pair:
                with contextlib.suppress(OSError):
                    s.shutdown(socket.SHUT_RDWR)
                with contextlib.suppress(OSError):
                    s.close()


class ChaosSchedule:
    """A scripted fault timeline: ordered ``(at_seconds, label, action)``
    steps executed on a background thread. The step list (times + labels)
    is plain data — print it, compare it, rebuild it from the same seed
    and it is identical; only ``run`` touches the wall clock."""

    def __init__(self):
        self.steps: List[Tuple[float, str, Callable[[], None]]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.executed: List[Tuple[float, str]] = []  # (at, label) as run
        self.errors: List[Tuple[str, str]] = []  # (label, error) of failures

    def at(self, at_s: float, label: str, action: Callable[[], None]
           ) -> "ChaosSchedule":
        self.steps.append((float(at_s), label, action))
        self.steps.sort(key=lambda s: s[0])
        return self

    def plan(self) -> List[Tuple[float, str]]:
        """The timeline as data (the determinism/replay surface)."""
        return [(at, label) for at, label, _ in self.steps]

    def start(self) -> "ChaosSchedule":
        self._thread = threading.Thread(
            target=self._run, name="chaos-schedule", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        t0 = time.monotonic()
        for at, label, action in self.steps:
            delay = at - (time.monotonic() - t0)
            if delay > 0 and self._stop.wait(delay):
                return
            obs.event("chaos.step", at=round(at, 3), step=label)
            try:
                action()
            except Exception as e:  # noqa: BLE001 — a failed step is data
                obs.count("chaos.step_error", step=label, error=str(e)[:200])
                self.errors.append((label, f"{type(e).__name__}: {e}"))
            self.executed.append((at, label))

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the timeline to finish; True when it did."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def cancel(self) -> None:
        self._stop.set()
