"""Patch types: path-qualified descriptions of document mutations.

Mirrors the reference's patch surface (reference:
rust/automerge/src/patches/patch.rs): a ``Patch`` names the object it
touches, the path from the root to that object, and a ``PatchAction``.
Applying a diff's patches in order to the materialized ``before`` state
yields the ``after`` state (tests/test_patches.py holds this invariant).

Design note: patch values for newly-visible objects are fully hydrated
subtrees rather than the reference's create-empty-then-fill event stream —
one patch per structural change keeps consumers (and the device differ,
``ops/device_doc.py``) simpler; the applied result is identical.

A copy of ``automerge_tpu/patches/patch.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

# path element: (object exid, key-or-index within it)
PathElem = Tuple[str, Union[str, int]]


@dataclass
class PutMap:
    key: str
    value: object
    conflict: bool = False


@dataclass
class PutSeq:
    index: int
    value: object
    conflict: bool = False


@dataclass
class Insert:
    index: int
    values: List[object] = field(default_factory=list)


@dataclass
class SpliceText:
    index: int
    value: str = ""


@dataclass
class DeleteMap:
    key: str


@dataclass
class DeleteSeq:
    index: int
    length: int = 1


@dataclass
class IncrementPatch:
    prop: Union[str, int]
    value: int


@dataclass
class MarkPatch:
    marks: List[object] = field(default_factory=list)


@dataclass
class FlagConflict:
    prop: Union[str, int]


PatchAction = Union[
    PutMap, PutSeq, Insert, SpliceText, DeleteMap, DeleteSeq,
    IncrementPatch, MarkPatch, FlagConflict,
]


@dataclass
class Patch:
    obj: str
    path: List[PathElem]
    action: PatchAction


def apply_patches(root, patches: List[Patch]):
    """Apply ``patches`` to a materialized tree (dicts / lists / strings).

    The reference's hydrate::Value::apply_patches equivalent
    (reference: rust/automerge/src/hydrate.rs:18-50). Returns the updated
    tree (strings are immutable, so text containers are rebuilt in place
    within their parent; pass and reassign the root).
    """
    for p in patches:
        root = _apply_one(root, p)
    return root


def _apply_one(root, p: Patch):
    # navigate to the target container, tracking the parent of a text leaf
    if not p.path:
        res = _apply_action(root, p.action, _Setter(None, None, lambda v: v))
        return res if res is not None else root

    node = root
    trail = []  # (container, key) pairs
    for _, key in p.path:
        trail.append((node, key))
        node = node[key]

    parent, last_key = trail[-1]

    def replace(v):
        parent[last_key] = v
        return root

    return _apply_action(node, p.action, _Setter(parent, last_key, replace)) or root


class _Setter:
    """How to write back a rebuilt (immutable) container, e.g. a str."""

    def __init__(self, parent, key, replace):
        self.parent = parent
        self.key = key
        self.replace = replace


def _apply_action(node, action, setter):
    if isinstance(action, PutMap):
        node[action.key] = action.value
    elif isinstance(action, DeleteMap):
        node.pop(action.key, None)
    elif isinstance(action, PutSeq):
        node[action.index] = action.value
    elif isinstance(action, Insert):
        node[action.index : action.index] = list(action.values)
    elif isinstance(action, DeleteSeq):
        if isinstance(node, str):
            return setter.replace(
                node[: action.index] + node[action.index + action.length :]
            )
        del node[action.index : action.index + action.length]
    elif isinstance(action, SpliceText):
        if isinstance(node, str):
            return setter.replace(
                node[: action.index] + action.value + node[action.index :]
            )
        node[action.index : action.index] = list(action.value)
    elif isinstance(action, IncrementPatch):
        node[action.prop] = node[action.prop] + action.value
    elif isinstance(action, (MarkPatch, FlagConflict)):
        pass  # no structural effect on plain materialized values
    else:
        raise TypeError(f"unknown patch action {action!r}")
    return None
