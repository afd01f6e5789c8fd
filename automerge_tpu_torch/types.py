"""Core CRDT types: actor ids, op ids, object types, actions, scalar values.

Semantics mirror the reference's type layer (reference:
rust/automerge/src/types.rs) — Lamport-ordered OpIds, action indices 0-7 with
stable storage encoding, SHA-256 change hashes — but the representation is
designed for columnar/device use: OpIds are plain (counter, actor-index) int
pairs so whole op logs pack into int32/int64 device arrays.
"""

from __future__ import annotations

import uuid
from enum import IntEnum
from typing import NamedTuple, Optional, Tuple

# ---------------------------------------------------------------------------
# Actor ids


class ActorId:
    """An actor identity: arbitrary bytes, 16-byte uuid4 by default.

    Reference: types.rs ActorId (random uuid default, hex display).
    """

    __slots__ = ("bytes",)

    def __init__(self, raw: bytes | None = None):
        if raw is None:
            raw = uuid.uuid4().bytes
        if not isinstance(raw, (bytes, bytearray)):
            raise TypeError("ActorId expects bytes")
        self.bytes = bytes(raw)

    @classmethod
    def from_hex(cls, s: str) -> "ActorId":
        return cls(bytes.fromhex(s))

    def to_hex(self) -> str:
        return self.bytes.hex()

    def with_concurrency_suffix(self, level: int) -> "ActorId":
        """Derive the actor id used for isolated (scoped) transactions.

        Mirrors the reference's actor suffixing that avoids opid collisions
        when editing at historical heads (types.rs CONCURRENCY_MAGIC_BYTES).
        """
        suffix = bytearray(_CONCURRENCY_MAGIC)
        n = level
        while True:
            suffix.append(n & 0xFF)
            n >>= 8
            if not n:
                break
        return ActorId(self.bytes + bytes(suffix))

    def __eq__(self, other):
        return isinstance(other, ActorId) and self.bytes == other.bytes

    def __lt__(self, other):
        return self.bytes < other.bytes

    def __le__(self, other):
        return self.bytes <= other.bytes

    def __hash__(self):
        return hash(self.bytes)

    def __repr__(self):
        return f"ActorId({self.bytes.hex()})"


_CONCURRENCY_MAGIC = bytes([0x12, 0x36, 0x34, 0x42])


# ---------------------------------------------------------------------------
# Op ids

# An OpId is (counter, actor_index). actor_index points into a document's
# interned actor table; Lamport order compares (counter, actor-bytes), so
# comparisons that cross actors must go through the actor rank table.
OpId = Tuple[int, int]

ROOT: OpId = (0, 0)  # the root object id sentinel

# Packed op-id layout of the device log (ops/oplog.py):
# id = counter << ACTOR_BITS | actor rank. Counters < 2^43.
ACTOR_BITS = 20

HEAD: OpId = (0, 0)  # list HEAD element sentinel (counter 0 never collides)


def is_root(obj: OpId) -> bool:
    return obj[0] == 0


def is_head(elem: OpId) -> bool:
    return elem[0] == 0


# ---------------------------------------------------------------------------
# Object types and actions


class ObjType(IntEnum):
    MAP = 0
    LIST = 1
    TEXT = 2
    TABLE = 3

    @property
    def is_sequence(self) -> bool:
        return self in (ObjType.LIST, ObjType.TEXT)


class Action(IntEnum):
    """Stable storage action indices (reference: types.rs action_index)."""

    MAKE_MAP = 0
    PUT = 1
    MAKE_LIST = 2
    DELETE = 3
    MAKE_TEXT = 4
    INCREMENT = 5
    MAKE_TABLE = 6
    MARK = 7  # both mark-begin and mark-end


_MAKE_ACTIONS = {
    Action.MAKE_MAP: ObjType.MAP,
    Action.MAKE_LIST: ObjType.LIST,
    Action.MAKE_TEXT: ObjType.TEXT,
    Action.MAKE_TABLE: ObjType.TABLE,
}

def objtype_for_action(a: int) -> Optional[ObjType]:
    return _MAKE_ACTIONS.get(Action(a)) if a in (0, 2, 4, 6) else None


_OBJ_ACTIONS = {v: k for k, v in _MAKE_ACTIONS.items()}


def action_for_objtype(t: ObjType) -> Action:
    return _OBJ_ACTIONS[t]


def is_make_action(a: int) -> bool:
    return a in (0, 2, 4, 6)


# ---------------------------------------------------------------------------
# Text width encoding
#
# The unit a text index counts in: "unicode" code points (the default),
# "utf8" bytes or "utf16" code units (reference: text_value.rs:5-15,
# types.rs:701-706 Op::width). The process default can be overridden for
# the dynamic extent of an operation with ``using_text_encoding``; the
# width column of an op log follows the encoding active while it is built.

import contextvars as _contextvars

TEXT_ENCODINGS = ("unicode", "utf8", "utf16")
_text_encoding = "unicode"
# innermost active encoding; a ContextVar so threads and async tasks
# cannot corrupt each other's width math
_active_enc: _contextvars.ContextVar = _contextvars.ContextVar(
    "automerge_tpu_torch_text_encoding", default=None
)


def set_text_encoding(encoding: str) -> None:
    """Select the process-default text index unit: "unicode" code points
    (default), "utf8" bytes, or "utf16" code units."""
    global _text_encoding
    if encoding not in TEXT_ENCODINGS:
        raise ValueError(f"unknown text encoding {encoding!r}")
    _text_encoding = encoding


def get_text_encoding() -> str:
    """The ACTIVE text index unit: the innermost context if one is
    active, else the process default."""
    return _active_enc.get() or _text_encoding


class using_text_encoding:
    """Context manager activating ``encoding`` for the dynamic extent of an
    operation; ``None`` is a no-op (follow the process default)."""

    __slots__ = ("_enc", "_token")

    def __init__(self, encoding):
        if encoding is not None and encoding not in TEXT_ENCODINGS:
            raise ValueError(f"unknown text encoding {encoding!r}")
        self._enc = encoding
        self._token = None

    def __enter__(self):
        if self._enc is not None:
            self._token = _active_enc.set(self._enc)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _active_enc.reset(self._token)
            self._token = None
        return False


def str_width(s: str) -> int:
    """Width of ``s`` in the active text index unit."""
    enc = _active_enc.get() or _text_encoding
    if enc == "unicode":
        return len(s)
    if enc == "utf8":
        return len(s.encode("utf-8"))
    return sum(2 if ord(c) > 0xFFFF else 1 for c in s)


# ---------------------------------------------------------------------------
# Scalar values


class ScalarValue(NamedTuple):
    """A tagged scalar. ``tag`` selects the storage value-metadata type code.

    Tags: null, bool, uint, int, f64, str, bytes, counter, timestamp, unknown.
    For ``counter`` the payload is the start value; accumulated increments are
    op-store state, not part of the encoded value. For ``unknown`` the payload
    is (type_code, bytes) — unknown-typed values roundtrip losslessly
    (reference: value.rs ScalarValue::Unknown).
    """

    tag: str
    value: object = None

    @classmethod
    def null(cls):
        return cls("null")

    @classmethod
    def from_py(cls, v) -> "ScalarValue":
        """Best-effort conversion from a plain Python value."""
        if v is None:
            return cls("null")
        if isinstance(v, ScalarValue):
            return v
        if isinstance(v, bool):
            return cls("bool", v)
        if isinstance(v, int):
            return cls("int", v)
        if isinstance(v, float):
            return cls("f64", v)
        if isinstance(v, str):
            return cls("str", v)
        if isinstance(v, (bytes, bytearray)):
            return cls("bytes", bytes(v))
        raise TypeError(f"cannot convert {type(v).__name__} to ScalarValue")

    def to_py(self):
        """The plain Python value (None for null), as ``hydrate`` and
        patches carry it."""
        return None if self.tag == "null" else self.value


# Value metadata type codes (reference: value.rs ValueType)
VALUE_TYPE_NULL = 0
VALUE_TYPE_FALSE = 1
VALUE_TYPE_TRUE = 2
VALUE_TYPE_ULEB = 3
VALUE_TYPE_LEB = 4
VALUE_TYPE_FLOAT = 5
VALUE_TYPE_STRING = 6
VALUE_TYPE_BYTES = 7
VALUE_TYPE_COUNTER = 8
VALUE_TYPE_TIMESTAMP = 9


# ---------------------------------------------------------------------------
# Change hashes

ChangeHash = bytes  # 32-byte SHA-256 digest


def hash_hex(h: ChangeHash) -> str:
    return h.hex()


# ---------------------------------------------------------------------------
# Keys

# A key is either a map property or a list element id (reference: types.rs
# Key).


class Key(NamedTuple):
    """Storage-level key: exactly one of ``prop`` / ``elem`` is set."""

    prop: Optional[str] = None
    elem: Optional[OpId] = None

    @classmethod
    def map(cls, prop: str) -> "Key":
        return cls(prop=prop)

    @classmethod
    def seq(cls, elem: OpId) -> "Key":
        return cls(elem=elem)

    @classmethod
    def head(cls) -> "Key":
        return cls(elem=HEAD)
