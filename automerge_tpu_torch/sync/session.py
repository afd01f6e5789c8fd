"""Resilient sync sessions: the Bloom protocol hardened for lossy transports.

``SyncState``/``generate_sync_message``/``receive_sync_message`` (protocol.py)
assume a perfectly reliable, in-order channel — a single dropped message
deadlocks both peers, a duplicated one wastes a round, and a peer that
loses its state mid-sync (only ``shared_heads`` is persisted, reference:
sync/state.rs) silently stalls. ``SyncSession`` wraps the protocol with the
classic ARQ toolbox:

* **Framing with integrity**: every message travels in a session frame
  ``0x45 | crc32 | flags | ULEB(epoch) | inner`` so arbitrary corruption
  (truncation, bit-flips) is detected at the frame layer and treated as
  loss, never as protocol input.
* **Idempotent receive**: duplicate frames are recognised by digest and
  answered with a retransmission of our own last frame (the duplicate
  usually means our reply was lost).
* **Retry with capped exponential backoff + jitter**: an unanswered frame
  is retransmitted after a timeout that doubles per retry up to a cap,
  with deterministic seeded jitter to avoid lock-step peers.
* **Epoch/reset handshake**: each session instance carries an epoch; a
  frame with an unexpected epoch means the peer restarted (rebuilt its
  state from the persisted ``shared_heads``-only encoding) — we drop our
  per-peer bookkeeping and renegotiate. A RESET flag forces the same from
  the other side.
* **Divergence detector**: when ``stall_rounds`` consecutive received
  messages produce no progress while heads differ (Bloom false positives,
  or a peer whose ``sent_hashes`` suppress resending a change the
  transport destroyed), the session clears
  ``shared_heads``/``sent_hashes`` and forces a full resync on both ends.

Every recovery path is counted in ``SyncSession.stats`` (``retries``,
``resets``, ``resyncs``, ``dups``, ``malformed``, ``rejected``,
``persist_errors``), as are the resident-device feed's calls
(``coalesced_batches``: the batches ``receive_many`` collected;
``device_feeds``: the calls by kind, ``apply_changes``, ``apply_batches``
and ``device_feed``). The reference's ``obs`` spans and labeled counters
are recorded beside them (``sync.generate``, ``sync.receive`` and
``sync.apply`` spans; ``sync.retry``, ``sync.reset{source}``,
``sync.resync``, ``sync.dup``, ``sync.malformed{stage}``,
``sync.rejected``, ``sync.persist_error``, ``sync.coalesced_batches``,
``sync.device_feed_error``).

A session may carry a resident ``DeviceDoc`` (``device_doc=``): changes
received off the wire feed its incremental append/re-resolve path
(ops/device_doc.apply_changes, its kernels on the document's device), so
a device-resident replica tracks the host document at O(delta) per round
instead of rebuilding from the full change history. Unlike the
reference, which counts a failed feed (``sync.device_feed_error``) and
carries on, the port counts it the same way and then lets the failure
of the feed (the kernels, the native library, the cross-document batcher)
propagate out of ``receive`` / ``receive_many``. By then the host document holds the message's changes
and the frame has been accepted and counted; the resident document is
behind the host one and it is the caller's to rebuild or drop it. For
the same reason only the document's own refusal of a message's changes
(an ``AutomergeError``) counts as a rejected frame, and only malformed
bytes (``SyncError``) as a malformed one: anything else propagates.

The session is transport- and clock-agnostic: ``poll(now)`` may return
frame bytes to put on the wire, ``receive(data)`` feeds bytes taken off
it. ``now`` is any monotonic number — integer ticks in the fault harness
(sync/faults.py), ``time.monotonic()`` seconds in a serving frontend.
"""

from __future__ import annotations

import contextlib
import hashlib
import random
import zlib
from collections import OrderedDict
from typing import Optional

from .. import obs
from ..errors import AutomergeError
from ..utils.leb128 import decode_uleb, encode_uleb
from .protocol import (
    Message,
    SyncError,
    SyncState,
    generate_sync_message,
    receive_sync_message,
)

SESSION_FRAME_TYPE = 0x45
FLAG_RESET = 0x01

_SEEN_LIMIT = 256  # digests remembered for duplicate detection


class SessionConfig:
    """Tuning knobs for one session; all time values are in ``now`` units."""

    __slots__ = (
        "timeout", "backoff_factor", "max_timeout", "jitter",
        "stall_rounds", "seed",
    )

    def __init__(
        self,
        timeout: float = 4.0,
        backoff_factor: float = 2.0,
        max_timeout: float = 64.0,
        jitter: float = 0.25,
        stall_rounds: int = 12,
        seed: int = 0,
    ):
        self.timeout = timeout
        self.backoff_factor = backoff_factor
        self.max_timeout = max_timeout
        self.jitter = jitter
        self.stall_rounds = stall_rounds
        self.seed = seed


def encode_frame(epoch: int, inner: bytes, flags: int = 0, seq: int = 0) -> bytes:
    """``0x45 | crc32(payload) | payload``, payload = flags|epoch|seq|inner.

    ``seq`` is a per-session send counter: it makes every freshly
    generated frame byte-unique, so the receiver's duplicate detector
    only ever fires on true transport duplicates and retransmissions.
    """
    payload = bytearray([flags & 0xFF])
    encode_uleb(epoch, payload)
    encode_uleb(seq, payload)
    payload += inner
    crc = zlib.crc32(bytes(payload)) & 0xFFFFFFFF
    return bytes([SESSION_FRAME_TYPE]) + crc.to_bytes(4, "big") + bytes(payload)


def decode_frame(data: bytes) -> tuple[int, int, int, bytes]:
    """Return (epoch, flags, seq, inner); raise SyncError on any corruption."""
    if not data or data[0] != SESSION_FRAME_TYPE:
        raise SyncError(
            f"expected session frame type 0x45, got {data[:1].hex() or 'EOF'}"
        )
    if len(data) < 6:
        raise SyncError("truncated session frame header")
    crc = int.from_bytes(data[1:5], "big")
    payload = data[5:]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise SyncError("session frame CRC mismatch")
    flags = payload[0]
    try:
        epoch, pos = decode_uleb(payload, 1)
        seq, pos = decode_uleb(payload, pos)
    except ValueError as e:  # LEBDecodeError
        raise SyncError(f"truncated session frame header fields: {e}") from e
    return epoch, flags, seq, bytes(payload[pos:])


class SyncSession:
    """One resilient sync conversation with one peer over a lossy channel."""

    def __init__(
        self,
        doc,
        state: Optional[SyncState] = None,
        *,
        config: Optional[SessionConfig] = None,
        epoch: int = 1,
        device_doc=None,
        persist=None,
    ):
        # accept an AutoDoc (auto-commits) or a core Document; the outer
        # object is kept as-is so a durable wrapper's ack_scope (batched
        # journal fsync per received message) is reachable
        self._outer = doc
        self._autodoc = doc if hasattr(doc, "doc") else None
        self._doc = doc.doc if self._autodoc is not None else doc
        # optional resident DeviceDoc: received changes feed its
        # incremental append/re-resolve path directly (O(delta) instead of
        # a from-scratch device rebuild per sync round)
        self.device_doc = device_doc
        self.state = state or SyncState()
        self.config = config or SessionConfig()
        self.epoch = epoch
        self.peer_epoch: Optional[int] = None
        self.stats = {
            "sent": 0, "received": 0, "retries": 0, "resets": 0,
            "resyncs": 0, "dups": 0, "malformed": 0, "rejected": 0,
            "persist_errors": 0, "coalesced_batches": 0,
            "device_feeds": {
                "apply_changes": 0, "apply_batches": 0, "device_feed": 0,
            },
        }
        self._rng = random.Random(self.config.seed ^ (epoch * 0x9E3779B1))
        self._last_frame: Optional[bytes] = None
        self._last_sent_at: Optional[float] = None
        self._cur_timeout = self.config.timeout
        self._retries = 0
        self._want_retransmit = False
        self._awaiting = False
        self._send_reset = False
        self._noprogress = 0
        self._seq = 0
        self._seen: OrderedDict = OrderedDict()
        # optional persistence hook: called with self.encode() whenever
        # shared_heads change, so a durable peer (storage/durable.py
        # attach_sync_session) survives a restart with its sync progress.
        # Persistence failure must never break the live session (it is
        # counted in stats["persist_errors"] and retried).
        self.persist = persist
        self._persisted_shared: Optional[tuple] = None
        # non-None while receive_many() is draining a run of frames: the
        # per-message device feed is deferred into this list and flushed
        # as ONE DeviceDoc.apply_batches call at the end of the run
        self._device_batches: Optional[list] = None

    # -- public surface -----------------------------------------------------

    def poll(self, now: float = 0.0) -> Optional[bytes]:
        """Advance the session clock; return frame bytes to send, or None.

        Call repeatedly — on a timer, after every ``receive``, or once per
        tick of a driving loop. A fresh protocol message always wins;
        otherwise an unanswered frame is retransmitted once its (backed
        off, jittered) timeout expires; a detected stall forces a resync.
        """
        if self._autodoc is not None:
            self._autodoc.commit()
        # progress-free chatter (e.g. our changes frame was lost but our
        # sent_hashes still suppress a resend, so we answer requests with
        # empty change lists forever) → renegotiate from scratch
        if self._noprogress >= self.config.stall_rounds and not self.converged():
            return self._force_resync(now)
        with obs.span("sync.generate"):
            msg = generate_sync_message(self._doc, self.state)
        if msg is not None:
            return self._send(msg, now)

        if self.converged():
            if self._want_retransmit:
                # the peer keeps talking although we are done: its view of
                # our heads is stale — answer with a fresh announcement
                self._want_retransmit = False
                return self._send_ack(now)
            return None

        # not converged and nothing new to generate: we are necessarily
        # awaiting a reply (generate only returns None mid-flight here),
        # so the ARQ timers drive recovery
        if self._awaiting and self._last_frame is not None:
            # duplicate seen → our reply was probably lost: retransmit now
            if self._want_retransmit:
                self._want_retransmit = False
                return self._retransmit(now)
            # unanswered frame past its deadline → retransmit with backoff
            if (
                self._last_sent_at is not None
                and now - self._last_sent_at >= self._cur_timeout
            ):
                return self._retransmit(now)
        return None

    def receive(self, data: bytes, now: float = 0.0) -> bool:
        """Feed bytes off the wire. Returns True if they advanced the
        session, False if they were dropped (corrupt or duplicate).
        Never raises on untrusted input; a failure of the resident
        document's feed, or of the document's own machinery, propagates
        (see the module docstring)."""
        with obs.span("sync.receive", bytes=len(data)):
            return self._receive(data, now)

    def receive_many(self, frames, now: float = 0.0, device_feed=None) -> list:
        """Drain a run of pending wire frames in arrival order, coalescing
        the resident-device feed: instead of one ``DeviceDoc.apply_changes``
        per message, every message's changes collect into a single
        ``apply_batches`` call at the end — on accelerator backends that
        pipelines the kernel launches (h2d staging of batch k+1 overlaps
        batch k's kernel), amortizing per-launch cost across the run.

        ``device_feed`` (a callable taking the collected batches)
        replaces the direct ``apply_batches`` call — the serving layer
        passes its cross-document batcher here so concurrently-draining
        sessions share ONE kernel launch (ops/batched.py).

        Host-document semantics are identical to calling ``receive`` per
        frame; returns the per-frame accepted flags. A failure of the feed
        propagates once every frame has been received (the host document
        holds all their changes)."""
        accepted = []
        # a single frame keeps the plain per-message path — unless an
        # external device_feed is attached (the cross-doc batcher): then
        # even one frame's changes defer so they can join other docs'
        # concurrently-draining feeds in a shared launch
        if self.device_doc is None or (len(frames) <= 1 and device_feed is None):
            for data in frames:
                accepted.append(self.receive(data, now))
            return accepted
        self._device_batches = batches = []
        try:
            for data in frames:
                accepted.append(self.receive(data, now))
        finally:
            self._device_batches = None
        if batches:
            self.stats["coalesced_batches"] += len(batches)
            obs.count("sync.coalesced_batches", n=len(batches))
            try:
                if device_feed is not None:
                    self.stats["device_feeds"]["device_feed"] += 1
                    device_feed(batches)
                else:
                    self.stats["device_feeds"]["apply_batches"] += 1
                    self.device_doc.apply_batches(batches)
            except Exception as e:
                # counted as the reference counts it, then propagated
                obs.count("sync.device_feed_error", error=str(e)[:200])
                raise
        return accepted

    def _receive(self, data: bytes, now: float) -> bool:
        try:
            epoch, flags, _seq, inner = decode_frame(data)
        except SyncError as e:
            # tolerate a bare protocol message for interop with plain
            # SyncState peers (no envelope, no resilience semantics)
            try:
                msg = Message.decode(data)
            except SyncError:
                self.stats["malformed"] += 1
                obs.count("sync.malformed", labels={"stage": "frame"},
                          error=str(e))
                return False
            return self._apply(msg, now)

        digest = hashlib.sha256(data).digest()[:16]
        if digest in self._seen:
            self.stats["dups"] += 1
            obs.count("sync.dup")
            self._want_retransmit = True
            return False
        self._seen[digest] = None
        while len(self._seen) > _SEEN_LIMIT:
            self._seen.popitem(last=False)

        if self.peer_epoch is None:
            self.peer_epoch = epoch
        elif epoch != self.peer_epoch:
            # peer restarted: its state is rebuilt from shared_heads only
            self._on_peer_reset(epoch)
        if flags & FLAG_RESET:
            self._hard_reset(keep_shared=False)
            self.stats["resets"] += 1
            obs.count("sync.reset", labels={"source": "peer"})

        if not inner:
            return True  # pure control frame (reset/ack)
        try:
            msg = Message.decode(inner)
        except SyncError as e:
            self.stats["malformed"] += 1
            obs.count("sync.malformed", labels={"stage": "message"},
                      error=str(e))
            return False
        return self._apply(msg, now)

    def converged(self) -> bool:
        """True once the peer's last reported heads equal ours."""
        their = self.state.their_heads
        return their is not None and set(their) == set(self._doc.get_heads())

    def encode(self) -> bytes:
        """Persist across restarts (shared_heads only, like SyncState)."""
        return self.state.encode()

    @classmethod
    def restore(cls, doc, data: bytes, *, epoch: int, config=None) -> "SyncSession":
        """Rebuild a session after a restart. ``epoch`` MUST differ from
        the pre-restart session's epoch so the peer notices and drops its
        stale bookkeeping."""
        return cls(doc, SyncState.decode(data), config=config, epoch=epoch)

    # -- internals ----------------------------------------------------------

    def _send(self, msg: Message, now: float) -> bytes:
        flags = FLAG_RESET if self._send_reset else 0
        self._send_reset = False
        frame = encode_frame(self.epoch, msg.encode(), flags, self._next_seq())
        self._last_frame = frame
        self._last_sent_at = now
        self._cur_timeout = self._with_jitter(self.config.timeout)
        self._retries = 0
        self._awaiting = True
        self.stats["sent"] += 1
        return frame

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _send_ack(self, now: float) -> bytes:
        """A fresh heads announcement for a peer whose view of us is stale.
        Not part of the ARQ window: we expect no reply to it."""
        msg = Message(
            heads=self._doc.get_heads(), need=[], have=[], changes=[]
        )
        self.stats["sent"] += 1
        return encode_frame(self.epoch, msg.encode(), 0, self._next_seq())

    def _retransmit(self, now: float) -> bytes:
        self._last_sent_at = now
        self._retries += 1
        self.stats["retries"] += 1
        self._cur_timeout = self._with_jitter(
            min(
                self.config.timeout * self.config.backoff_factor ** self._retries,
                self.config.max_timeout,
            )
        )
        obs.count("sync.retry", attempt=self._retries)
        return self._last_frame

    def _with_jitter(self, timeout: float) -> float:
        return timeout * (1.0 + self.config.jitter * self._rng.random())

    def _apply(self, msg: Message, now: float) -> bool:
        with obs.span("sync.apply", changes=len(msg.changes)):
            return self._apply_inner(msg, now)

    def _apply_inner(self, msg: Message, now: float) -> bool:
        if self._autodoc is not None:
            self._autodoc.commit()
        before = self._doc.get_heads()
        # a durable document batches this message's journal fsyncs into
        # one at the scope exit; the except below stays narrowly around
        # the PROTOCOL apply so observer/journal failures propagate
        # instead of being miscounted as rejected frames
        scope = getattr(self._outer, "ack_scope", None)
        with scope() if scope is not None else contextlib.nullcontext():
            try:
                receive_sync_message(self._doc, self.state, msg)
            except AutomergeError as e:
                # a well-framed message whose changes the document rejects
                # (e.g. duplicate (actor, seq) from a peer that lost its
                # doc and re-created divergent history): absorb, count,
                # keep going. Nothing else is a rejected frame: a durable
                # write-path failure (an OSError, a journal error, from a
                # change listener inside apply_changes) puts the ack
                # guarantee at stake, and a failure of the kernels or the
                # native library is not the message's fault; both
                # propagate (neither is an AutomergeError).
                self.stats["rejected"] += 1
                obs.count("sync.rejected", error=str(e))
                return False
            # persist inside the scope: the meta record rides the same
            # single boundary fsync as the message's change records
            self._maybe_persist()
        if self._autodoc is not None:
            self._autodoc._notify_patches()
        self.stats["received"] += 1
        self._awaiting = False
        self._retries = 0
        self._cur_timeout = self._with_jitter(self.config.timeout)
        progressed = (
            self._doc.get_heads() != before
            or self.converged()
        )
        if progressed:
            self._noprogress = 0
        else:
            self._noprogress += 1
        if self.device_doc is not None and msg.changes:
            if self._device_batches is not None:
                # inside receive_many: defer into one apply_batches call
                self._device_batches.append(list(msg.changes))
            else:
                # feed the resident device document incrementally, once
                # the frame is accepted and counted: a failure propagates
                self.stats["device_feeds"]["apply_changes"] += 1
                try:
                    self.device_doc.apply_changes(msg.changes)
                except Exception as e:
                    obs.count("sync.device_feed_error", error=str(e)[:200])
                    raise
        return True

    def _maybe_persist(self) -> None:
        if self.persist is None:
            return
        cur = tuple(self.state.shared_heads)
        if cur == self._persisted_shared:
            return
        try:
            self.persist(self.encode())
        except Exception as e:  # noqa: BLE001 — persistence is best-effort
            # NOT marked persisted: a transient failure retries on the
            # next call even if shared_heads never change again
            self.stats["persist_errors"] += 1
            obs.count("sync.persist_error", error=str(e)[:200])
        else:
            self._persisted_shared = cur

    def _on_peer_reset(self, new_epoch: int) -> None:
        self.peer_epoch = new_epoch
        self._hard_reset(keep_shared=True)
        self.stats["resets"] += 1
        obs.count("sync.reset", labels={"source": "epoch"})

    def _hard_reset(self, keep_shared: bool) -> None:
        shared = list(self.state.shared_heads) if keep_shared else []
        st = SyncState()
        st.shared_heads = shared
        self.state = st
        self._last_frame = None
        self._last_sent_at = None
        self._retries = 0
        self._awaiting = False
        self._cur_timeout = self.config.timeout
        self._noprogress = 0
        # a reset that cleared shared_heads must persist that too, or a
        # restart would resurrect heads the resync just disowned
        self._maybe_persist()

    def _force_resync(self, now: float) -> Optional[bytes]:
        """Divergence detected: renegotiate from nothing and tell the peer
        (RESET flag) to drop its suppressing sent_hashes too."""
        self.stats["resyncs"] += 1
        obs.count("sync.resync")
        self._hard_reset(keep_shared=False)
        self._send_reset = True
        msg = generate_sync_message(self._doc, self.state)
        if msg is None:  # nothing to say yet: send a pure control frame
            frame = encode_frame(self.epoch, b"", FLAG_RESET, self._next_seq())
            self._send_reset = False
            self._last_frame = frame
            self._last_sent_at = now
            self._awaiting = True
            self.stats["sent"] += 1
            return frame
        return self._send(msg, now)
