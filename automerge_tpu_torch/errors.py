"""Typed error hierarchy (the analogue of reference error.rs:1-134).

Every framework error derives from ``AutomergeError`` (itself a
``ValueError`` so existing broad handlers keep working). The typed
subclasses mirror the reference's ``AutomergeError`` enum variants that
carry semantic meaning callers dispatch on; parse-layer errors
(ChunkParseError, LEBDecodeError, ...) live with their codecs and are
re-exported here.
"""

from __future__ import annotations


class AutomergeError(ValueError):
    """Base class for all framework errors (reference: error.rs)."""


class MissingCounter(AutomergeError):
    """Increment of a property that holds no counter
    (reference: error.rs AutomergeError::MissingCounter)."""

    def __init__(self, msg="increment of a non-counter value"):
        super().__init__(msg)


class InvalidOp(AutomergeError):
    """Operation not valid for the target object's type
    (reference: error.rs AutomergeError::InvalidOp(ObjType))."""

    def __init__(self, obj_type=None, msg=None):
        self.obj_type = obj_type
        super().__init__(msg or f"invalid op for object type {obj_type}")


class DuplicateSeqNumber(AutomergeError):
    """A change re-used a (actor, seq) slot
    (reference: error.rs DuplicateSeqNumber)."""

    def __init__(self, seq=None, actor=None):
        self.seq = seq
        self.actor = actor
        super().__init__(f"duplicate seq {seq} for actor {actor}")


class MissingDeps(AutomergeError):
    """Changes could not be applied for want of their dependencies
    (reference: error.rs MissingDeps)."""


class InvalidHash(AutomergeError):
    """A change hash failed verification or was malformed
    (reference: error.rs InvalidHash)."""


class MissingHash(AutomergeError):
    """A requested change hash is not in this document's history
    (reference: error.rs MissingHash)."""


class InvalidObjId(AutomergeError):
    """An object/op id string failed to resolve
    (reference: error.rs InvalidObjId / InvalidObjIdFormat)."""


class InvalidActorId(AutomergeError):
    """An actor id string failed to parse
    (reference: error.rs InvalidActorId)."""


class InvalidIndex(AutomergeError):
    """A sequence index is out of bounds
    (reference: error.rs InvalidIndex)."""


class IntegrityError(AutomergeError):
    """Stored or replicated state failed integrity verification — a
    digest mismatch, a corrupt snapshot chunk, or a journal record whose
    checksum no longer matches its bytes. Never retriable: retrying the
    same read returns the same corrupt bytes; repair (scrub self-heal,
    peer re-fetch, or salvage) has to happen first."""

    retriable = False


# parse-layer errors are defined with their codecs and resolved lazily so
# importing this module never pulls the whole package; the static name map
# keeps __getattr__ inert for every other lookup (dunder probes during
# import would otherwise recurse into half-initialized modules)
_LAZY = {
    "ChangeGraphError": ".core.change_graph",
    "ChunkParseError": ".storage.chunk",
    "ColumnLayoutError": ".storage.columns",
    "ExtractError": ".ops.extract",
    "LEBDecodeError": ".utils.leb128",
    "OpStoreError": ".core.op_store",
    "SyncError": ".sync.protocol",
}


def __getattr__(name):
    mod_name = _LAZY.get(name)
    if mod_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(mod_name, __package__)
    return getattr(mod, name)


__all__ = [
    "AutomergeError",
    "ChangeGraphError",
    "ChunkParseError",
    "ColumnLayoutError",
    "DuplicateSeqNumber",
    "ExtractError",
    "IntegrityError",
    "InvalidActorId",
    "InvalidHash",
    "InvalidIndex",
    "InvalidObjId",
    "InvalidOp",
    "LEBDecodeError",
    "MissingCounter",
    "MissingDeps",
    "MissingHash",
    "OpStoreError",
    "SyncError",
]
