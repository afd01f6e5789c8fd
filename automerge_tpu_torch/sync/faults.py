"""Fault-injecting transport harness: deterministic lossy channels and a
driver that runs two peers to convergence over them.

The sync layer is verified against hostile transports the way storage
engines are verified against hostile workloads: a seeded ``FaultyChannel``
drops, duplicates, reorders, truncates, and bit-flips frames per a
configurable schedule, and ``SyncDriver`` ticks two ``SyncSession`` peers
(sync/session.py) through it until their documents converge or a tick
budget runs out. Everything is deterministic per seed, so a failing
schedule is a reproducible test case.

    ch_ab = FaultyChannel(seed=7, drop=0.2, dup=0.1, reorder=0.2)
    ch_ba = FaultyChannel(seed=8, drop=0.2, dup=0.1, reorder=0.2)
    stats = SyncDriver(doc_a, doc_b, ch_ab, ch_ba).run()
    assert stats.converged

Channels are tick-clocked: ``send`` stamps each delivery with an arrival
tick (reordering = a random extra delay), ``drain(now)`` returns — in
stamped order — everything due by ``now``.
"""

from __future__ import annotations

import random
from typing import Iterable, List, Optional

from .session import SessionConfig, SyncSession

# explicit per-message schedule entries (fall back to rates when exhausted)
FAULT_KINDS = ("ok", "drop", "dup", "reorder", "truncate", "bitflip")


class ChannelStats:
    __slots__ = ("sent", "delivered", "dropped", "duplicated", "reordered",
                 "truncated", "bitflipped")

    def __init__(self):
        self.sent = 0
        self.delivered = 0
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.truncated = 0
        self.bitflipped = 0

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class Channel:
    """A reliable in-order transport: what protocol.py silently assumes."""

    def __init__(self):
        self._queue: List[tuple[int, int, bytes]] = []  # (due, seq, data)
        self._seq = 0
        self.stats = ChannelStats()

    def send(self, data: bytes, now: int = 0) -> None:
        self.stats.sent += 1
        self._enqueue(data, now)

    def drain(self, now: int) -> List[bytes]:
        """All messages due by ``now``, in (arrival, send-order) order."""
        due = [m for m in self._queue if m[0] <= now]
        self._queue = [m for m in self._queue if m[0] > now]
        due.sort(key=lambda m: (m[0], m[1]))
        self.stats.delivered += len(due)
        return [m[2] for m in due]

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _enqueue(self, data: bytes, now: int, delay: int = 0) -> None:
        self._queue.append((now + delay, self._seq, data))
        self._seq += 1


class FaultyChannel(Channel):
    """A seeded, deterministic lossy transport.

    ``drop``/``dup``/``reorder``/``truncate``/``bitflip`` are independent
    per-message probabilities; ``reorder`` holds a message back 1..
    ``max_delay`` ticks so later sends overtake it. An explicit
    ``schedule`` (sequence of FAULT_KINDS entries, applied by send index)
    overrides the dice for the messages it covers — handy for scripting
    exact adversarial scenarios.
    """

    def __init__(
        self,
        seed: int = 0,
        drop: float = 0.0,
        dup: float = 0.0,
        reorder: float = 0.0,
        truncate: float = 0.0,
        bitflip: float = 0.0,
        max_delay: int = 3,
        schedule: Optional[Iterable[str]] = None,
    ):
        super().__init__()
        self.rng = random.Random(seed)
        self.drop = drop
        self.dup = dup
        self.reorder = reorder
        self.truncate = truncate
        self.bitflip = bitflip
        self.max_delay = max(1, max_delay)
        self.schedule = list(schedule) if schedule is not None else []
        self._sent_index = 0

    def send(self, data: bytes, now: int = 0) -> None:
        self.stats.sent += 1
        idx = self._sent_index
        self._sent_index += 1

        if idx < len(self.schedule):
            kind = self.schedule[idx]
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            self._apply(kind, data, now)
            return

        # independent dice per fault class, in severity order
        if self.rng.random() < self.drop:
            self._apply("drop", data, now)
            return
        if self.truncate and self.rng.random() < self.truncate:
            data = self._truncated(data)
        if self.bitflip and self.rng.random() < self.bitflip:
            data = self._bitflipped(data)
        delay = 0
        if self.rng.random() < self.reorder:
            delay = self.rng.randint(1, self.max_delay)
            self.stats.reordered += 1
        self._enqueue(data, now, delay)
        if self.rng.random() < self.dup:
            self.stats.duplicated += 1
            self._enqueue(data, now, self.rng.randint(0, self.max_delay))

    def _apply(self, kind: str, data: bytes, now: int) -> None:
        if kind == "drop":
            self.stats.dropped += 1
            return
        if kind == "dup":
            self.stats.duplicated += 1
            self._enqueue(data, now)
            self._enqueue(data, now)
            return
        if kind == "reorder":
            self.stats.reordered += 1
            self._enqueue(data, now, self.rng.randint(1, self.max_delay))
            return
        if kind == "truncate":
            self._enqueue(self._truncated(data), now)
            return
        if kind == "bitflip":
            self._enqueue(self._bitflipped(data), now)
            return
        self._enqueue(data, now)  # "ok"

    def _truncated(self, data: bytes) -> bytes:
        self.stats.truncated += 1
        if len(data) <= 1:
            return b""
        return data[: self.rng.randrange(1, len(data))]

    def _bitflipped(self, data: bytes) -> bytes:
        self.stats.bitflipped += 1
        if not data:
            return data
        i = self.rng.randrange(len(data))
        out = bytearray(data)
        out[i] ^= 1 << self.rng.randrange(8)
        return bytes(out)


class DriverStats:
    __slots__ = ("converged", "ticks", "a", "b", "channel_ab", "channel_ba")

    def __init__(self, converged, ticks, a, b, channel_ab, channel_ba):
        self.converged = converged
        self.ticks = ticks
        self.a = a  # session_a.stats
        self.b = b
        self.channel_ab = channel_ab
        self.channel_ba = channel_ba

    def __repr__(self):
        return (
            f"DriverStats(converged={self.converged}, ticks={self.ticks}, "
            f"a={self.a}, b={self.b})"
        )


class SyncDriver:
    """Tick two peers over a channel pair until their heads agree.

    Each tick: both sessions poll (possibly emitting a frame), then both
    drain their inbound channel. Convergence = identical heads, both
    sessions idle, both channels empty. Works with any ``Channel``
    subclass; with two plain ``Channel``s it reduces to protocol.sync().
    """

    def __init__(
        self,
        doc_a,
        doc_b,
        channel_ab: Optional[Channel] = None,
        channel_ba: Optional[Channel] = None,
        session_a: Optional[SyncSession] = None,
        session_b: Optional[SyncSession] = None,
        config: Optional[SessionConfig] = None,
    ):
        self.channel_ab = channel_ab if channel_ab is not None else Channel()
        self.channel_ba = channel_ba if channel_ba is not None else Channel()
        cfg = config or SessionConfig()
        self.session_a = session_a or SyncSession(doc_a, config=cfg, epoch=1)
        self.session_b = session_b or SyncSession(doc_b, config=cfg, epoch=2)

    def run(self, max_ticks: int = 2000) -> DriverStats:
        a, b = self.session_a, self.session_b
        ab, ba = self.channel_ab, self.channel_ba
        tick = 0
        for tick in range(1, max_ticks + 1):
            out_a = a.poll(tick)
            if out_a is not None:
                ab.send(out_a, tick)
            out_b = b.poll(tick)
            if out_b is not None:
                ba.send(out_b, tick)
            for data in ab.drain(tick):
                b.receive(data, tick)
            for data in ba.drain(tick):
                a.receive(data, tick)
            if self._settled():
                break
        return DriverStats(
            converged=self._settled(),
            ticks=tick,
            a=a.stats,
            b=b.stats,
            channel_ab=ab.stats,
            channel_ba=ba.stats,
        )

    def _settled(self) -> bool:
        a, b = self.session_a, self.session_b
        return (
            a._doc.get_heads() == b._doc.get_heads()
            and a.converged()
            and b.converged()
            and self.channel_ab.pending == 0
            and self.channel_ba.pending == 0
        )
