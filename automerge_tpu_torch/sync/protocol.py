"""Peer-to-peer sync protocol: Bloom-filter delta discovery over any
reliable in-order transport.

Wire- and semantics-compatible with the reference (reference:
rust/automerge/src/sync.rs, algorithm from arXiv:2012.00472): each peer
repeatedly sends ``Message {heads, need, have: [{last_sync, bloom}],
changes}``; rounds continue until both sides return None. The sync state
persists per peer; only ``shared_heads`` survives re-encoding across
sessions (reference: sync/state.rs).

Message type byte 0x42, state type byte 0x43 (reference: sync.rs:131,
sync/state.rs:7).
"""

from __future__ import annotations

from typing import List, Optional, Set

from ..errors import AutomergeError
from ..native import NativeUnavailable
from ..storage.change import StoredChange, parse_change
from ..utils.leb128 import decode_uleb, encode_uleb
from .bloom import BloomFilter

MESSAGE_TYPE_SYNC = 0x42
SYNC_STATE_TYPE = 0x43
HASH_SIZE = 32


class SyncError(AutomergeError):
    pass


class Have:
    """A summary of changes the sender already has (an implicit request for
    everything it does not)."""

    __slots__ = ("last_sync", "bloom")

    def __init__(
        self,
        last_sync: Optional[List[bytes]] = None,
        bloom: Optional[BloomFilter] = None,
    ):
        self.last_sync = last_sync or []
        self.bloom = bloom or BloomFilter()

    def __eq__(self, other):
        return (
            isinstance(other, Have)
            and self.last_sync == other.last_sync
            and self.bloom == other.bloom
        )


class Message:
    __slots__ = ("heads", "need", "have", "changes")

    def __init__(
        self,
        heads: List[bytes],
        need: List[bytes],
        have: List[Have],
        changes: List[StoredChange],
    ):
        self.heads = heads
        self.need = need
        self.have = have
        self.changes = changes

    def encode(self) -> bytes:
        out = bytearray([MESSAGE_TYPE_SYNC])
        _encode_hashes(out, self.heads)
        _encode_hashes(out, self.need)
        encode_uleb(len(self.have), out)
        for h in self.have:
            _encode_hashes(out, h.last_sync)
            bloom = h.bloom.to_bytes()
            encode_uleb(len(bloom), out)
            out += bloom
        encode_uleb(len(self.changes), out)
        for c in self.changes:
            raw = c.raw_bytes
            if raw is None:
                raise SyncError("change missing raw bytes")
            encode_uleb(len(raw), out)
            out += raw
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "Message":
        """Decode untrusted bytes; every malformed input raises SyncError.
        A native library that cannot be built or loaded (the change
        parser's column check) is not malformed input: it propagates."""
        if not data or data[0] != MESSAGE_TYPE_SYNC:
            raise SyncError(
                f"expected sync message type 0x42, got {data[:1].hex() or 'EOF'}"
            )
        try:
            return cls._decode_body(data)
        except (SyncError, NativeUnavailable):
            raise
        except Exception as e:
            raise SyncError(f"malformed sync message: {e}") from e

    @classmethod
    def _decode_body(cls, data: bytes) -> "Message":
        pos = 1
        heads, pos = _decode_hashes(data, pos)
        need, pos = _decode_hashes(data, pos)
        n, pos = decode_uleb(data, pos)
        have = []
        for _ in range(n):
            last_sync, pos = _decode_hashes(data, pos)
            blen, pos = decode_uleb(data, pos)
            if pos + blen > len(data):
                raise SyncError("bloom filter length overruns message")
            bloom = BloomFilter.from_bytes(data[pos : pos + blen])
            pos += blen
            have.append(Have(last_sync, bloom))
        n, pos = decode_uleb(data, pos)
        changes = []
        for _ in range(n):
            clen, pos = decode_uleb(data, pos)
            if pos + clen > len(data):
                raise SyncError("change length overruns message")
            change, _ = parse_change(data[pos : pos + clen], 0)
            pos += clen
            changes.append(change)
        return cls(heads, need, have, changes)


class SyncState:
    """Per-peer synchronisation state (reference: sync/state.rs State)."""

    def __init__(self):
        self.shared_heads: List[bytes] = []
        self.last_sent_heads: List[bytes] = []
        self.their_heads: Optional[List[bytes]] = None
        self.their_need: Optional[List[bytes]] = None
        self.their_have: Optional[List[Have]] = None
        self.sent_hashes: Set[bytes] = set()
        self.in_flight = False

    def encode(self) -> bytes:
        """Persist across sessions: only shared_heads is reusable."""
        out = bytearray([SYNC_STATE_TYPE])
        _encode_hashes(out, self.shared_heads)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "SyncState":
        if not data or data[0] != SYNC_STATE_TYPE:
            raise SyncError(
                f"expected sync state type 0x43, got {data[:1].hex() or 'EOF'}"
            )
        heads, _ = _decode_hashes(data, 1)
        st = cls()
        st.shared_heads = heads
        st.their_have = []
        return st


def _encode_hashes(out: bytearray, hashes: List[bytes]) -> None:
    hashes = sorted(hashes)
    encode_uleb(len(hashes), out)
    for h in hashes:
        out += h


def _decode_hashes(data: bytes, pos: int):
    n, pos = decode_uleb(data, pos)
    out = []
    for _ in range(n):
        if pos + HASH_SIZE > len(data):
            raise SyncError("truncated hash list")
        out.append(bytes(data[pos : pos + HASH_SIZE]))
        pos += HASH_SIZE
    return out, pos


# ---------------------------------------------------------------------------
# protocol driver (reference: sync.rs:134-383)


def generate_sync_message(doc, state: SyncState) -> Optional[Message]:
    """Produce the next message for the peer, or None if nothing to send.

    ``doc`` is a core Document (AutoDoc wraps this with an auto-commit).
    """
    our_heads = doc.get_heads()
    our_need = doc.get_missing_deps(state.their_heads or [])
    their_heads_set = set(state.their_heads or [])

    if all(h in their_heads_set for h in our_need):
        our_have = [_make_bloom(doc, list(state.shared_heads))]
    else:
        our_have = []

    # peer references a last_sync point we do not know: tell it to reset
    if state.their_have:
        first = state.their_have[0]
        if not all(doc.get_change_by_hash(h) is not None for h in first.last_sync):
            return Message(heads=our_heads, need=[], have=[Have()], changes=[])

    if state.their_have is not None and state.their_need is not None:
        changes_to_send = _changes_to_send(doc, state.their_have, state.their_need)
    else:
        changes_to_send = []

    heads_unchanged = state.last_sent_heads == our_heads
    heads_equal = state.their_heads == our_heads
    changes_to_send = [
        c for c in changes_to_send if c.hash not in state.sent_hashes
    ]

    if heads_unchanged:
        if heads_equal and not changes_to_send:
            return None
        if state.in_flight:
            return None

    state.last_sent_heads = list(our_heads)
    state.sent_hashes.update(c.hash for c in changes_to_send)
    state.in_flight = True
    return Message(
        heads=our_heads, need=our_need, have=our_have, changes=changes_to_send
    )


def receive_sync_message(doc, state: SyncState, message: Message) -> None:
    """Apply a received message: absorb changes, advance shared heads."""
    state.in_flight = False
    before_heads = doc.get_heads()

    if message.changes:
        doc.apply_changes(message.changes)
        state.shared_heads = _advance_heads(
            set(before_heads), set(doc.get_heads()), state.shared_heads
        )

    # trim sent hashes to those the peer has definitely not seen
    known_msg_heads = [
        h for h in message.heads if doc.get_change_by_hash(h) is not None
    ]
    doc.change_graph.remove_ancestors(state.sent_hashes, known_msg_heads)

    if not message.changes and message.heads == before_heads:
        state.last_sent_heads = list(message.heads)

    if len(known_msg_heads) == len(message.heads):
        state.shared_heads = list(message.heads)
        # peer lost all its data: reset for a full resync
        if not message.heads:
            state.last_sent_heads = []
            state.sent_hashes = set()
    else:
        state.shared_heads = sorted(
            set(state.shared_heads) | set(known_msg_heads)
        )

    state.their_have = message.have
    state.their_heads = message.heads
    state.their_need = message.need


def sync(doc_a, doc_b, state_a=None, state_b=None, max_rounds: int = 100):
    """Drive two in-process documents to convergence (test/CLI helper)."""
    state_a = state_a or SyncState()
    state_b = state_b or SyncState()
    for _ in range(max_rounds):
        msg_a = generate_sync_message(doc_a, state_a)
        if msg_a is not None:
            receive_sync_message(doc_b, state_b, Message.decode(msg_a.encode()))
        msg_b = generate_sync_message(doc_b, state_b)
        if msg_b is not None:
            receive_sync_message(doc_a, state_a, Message.decode(msg_b.encode()))
        if msg_a is None and msg_b is None:
            return state_a, state_b
    raise SyncError(f"no convergence after {max_rounds} rounds")


def _make_bloom(doc, last_sync: List[bytes]) -> Have:
    new_changes = doc.get_changes(last_sync)
    return Have(
        last_sync=last_sync,
        bloom=BloomFilter.from_hashes(c.hash for c in new_changes),
    )


def _changes_to_send(doc, have: List[Have], need: List[bytes]) -> List[StoredChange]:
    if not have:
        out = []
        for h in need:
            c = doc.get_change_by_hash(h)
            if c is not None:
                out.append(c)
        return out

    last_sync_hashes: Set[bytes] = set()
    blooms = []
    for h in have:
        last_sync_hashes.update(h.last_sync)
        blooms.append(h.bloom)

    changes = doc.get_changes(sorted(last_sync_hashes))

    dependents = {}
    to_send: Set[bytes] = set()
    for c in changes:
        for dep in c.dependencies:
            dependents.setdefault(dep, []).append(c.hash)
        if all(not b.contains(c.hash) for b in blooms):
            to_send.add(c.hash)

    # everything that transitively depends on a bloom-negative change must
    # also be sent (its deps would otherwise be unresolvable)
    stack = list(to_send)
    while stack:
        h = stack.pop()
        for dep in dependents.get(h, ()):
            if dep not in to_send:
                to_send.add(dep)
                stack.append(dep)

    out = []
    for h in need:
        if h not in to_send:
            c = doc.get_change_by_hash(h)
            if c is not None:
                out.append(c)
    for c in changes:
        if c.hash in to_send:
            out.append(c)
    return out


def _advance_heads(
    old_heads: Set[bytes], new_heads: Set[bytes], old_shared: List[bytes]
) -> List[bytes]:
    advanced = {h for h in new_heads if h not in old_heads}
    advanced.update(h for h in old_shared if h in new_heads)
    return sorted(advanced)
