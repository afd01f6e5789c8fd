"""Test DSL: conflict-aware document realization and assertions.

The analogue of the reference's ``automerge-test`` crate
(reference: rust/automerge-test/src/lib.rs:90-204,336-392): ``realize``
fully hydrates a document INCLUDING all conflicting values per slot, and
``map_``/``list_``/``val`` build the expected shape. Every map key and
sequence index maps to a *set* of realized values, because any property in
a CRDT document can hold concurrent conflicting writes.

Works against anything exposing the ReadDoc surface (keys/length/
object_type/get_all): the host ``Document``/``AutoDoc`` and the device
``DeviceDoc`` alike — which is exactly how the ported integration corpus
(tests/test_ported.py) asserts host/device parity.

The port of ``automerge_tpu/testing.py``; ``new_doc`` takes the
document's ``device``.

Realized encoding (hashable, order-canonical):
  value     -> ("value", tag, payload)
  counter   -> ("value", "counter", current total)
  map/table -> ("map", ((key, frozenset(values)), ... sorted by key))
  list/text -> ("list", (frozenset(values) per index, ...))
"""

from __future__ import annotations

import os
import pprint
from typing import Iterable, Mapping

from .api import AutoDoc
from .types import ActorId, ObjType, ScalarValue

__all__ = [
    "assert_doc",
    "assert_obj",
    "list_",
    "map_",
    "new_doc",
    "pretty",
    "realize",
    "realize_obj",
    "sorted_actors",
    "text_",
    "val",
]


def new_doc(seed: int = None, device=None) -> AutoDoc:
    """A fresh AutoDoc with a random (or seeded) actor id, its merges on
    ``device`` (None: the card)."""
    raw = os.urandom(16) if seed is None else (seed % (1 << 128)).to_bytes(16, "little")
    return AutoDoc(actor=ActorId(raw), device=device)


def sorted_actors():
    """Two random actor ids, the first ordered before the second."""
    a, b = os.urandom(16), os.urandom(16)
    while a == b:
        b = os.urandom(16)
    a, b = sorted((a, b))
    return ActorId(a), ActorId(b)


# -- realization --------------------------------------------------------------


def realize(doc, heads=None):
    """Fully hydrate ``doc`` from the root, conflicts included."""
    return realize_obj(doc, "_root", ObjType.MAP, heads=heads)


def realize_obj(doc, obj: str, objtype: ObjType = None, heads=None):
    if objtype is None:
        objtype = doc.object_type(obj)
    if objtype in (ObjType.MAP, ObjType.TABLE):
        entries = []
        for key in doc.keys(obj, heads=heads):
            entries.append((key, _realize_values(doc, obj, key, heads)))
        return ("map", tuple(sorted(entries)))
    length = doc.length(obj, heads=heads)
    slots = []
    i = 0
    while i < length:
        vals = _realize_values(doc, obj, i, heads)
        if not vals:
            break
        slots.append(vals)
        # TEXT indexes by character position: advance by the winner's width
        if objtype == ObjType.TEXT:
            i += _slot_width(doc, obj, i, heads)
        else:
            i += 1
    return ("list", tuple(slots))


def _slot_width(doc, obj, i, heads) -> int:
    got = doc.get_all(obj, i, heads=heads)
    if not got:
        return 1
    rendered = got[-1][0]
    if rendered[0] == "scalar" and rendered[1].tag == "str":
        return max(len(rendered[1].value), 1)
    return 1


def _realize_values(doc, obj, prop, heads) -> frozenset:
    out = []
    for rendered, exid in doc.get_all(obj, prop, heads=heads):
        kind = rendered[0]
        if kind == "obj":
            out.append(realize_obj(doc, exid, rendered[1], heads=heads))
        elif kind == "counter":
            out.append(("value", "counter", rendered[1]))
        else:
            sv = rendered[1]
            out.append(("value", sv.tag, sv.value))
    return frozenset(out)


# -- expected-shape constructors ----------------------------------------------


def val(x):
    """Lift a python scalar / ScalarValue / realized node to realized form."""
    if isinstance(x, tuple) and x and x[0] in ("map", "list", "value"):
        return x
    if isinstance(x, ScalarValue):
        if x.tag == "counter":
            return ("value", "counter", x.value)
        return ("value", x.tag, x.value)
    if x is None:
        return ("value", "null", None)
    if isinstance(x, bool):
        return ("value", "bool", x)
    if isinstance(x, int):
        return ("value", "int", x)
    if isinstance(x, float):
        return ("value", "f64", x)
    if isinstance(x, str):
        return ("value", "str", x)
    if isinstance(x, bytes):
        return ("value", "bytes", x)
    raise TypeError(f"cannot realize expected value {x!r}")


def _value_set(v) -> frozenset:
    """One slot's expected value(s): a set/frozenset means conflicts."""
    if isinstance(v, (set, frozenset)):
        return frozenset(val(x) for x in v)
    return frozenset([val(v)])


def map_(entries: Mapping) -> tuple:
    """Expected map: ``map_({"k": 1, "c": {1, 2}})`` (sets = conflicts)."""
    return ("map", tuple(sorted((k, _value_set(v)) for k, v in entries.items())))


def list_(items: Iterable) -> tuple:
    """Expected sequence: ``list_([1, {2, 3}])`` (sets = conflicts)."""
    return ("list", tuple(_value_set(v) for v in items))


def text_(s: str) -> tuple:
    """Expected text object: one single-char slot per character."""
    return ("list", tuple(frozenset([("value", "str", ch)]) for ch in s))


# -- assertions ----------------------------------------------------------------


def _pretty(node, indent=0):
    pad = "  " * indent
    kind = node[0]
    if kind == "value":
        return f"{pad}{node[1]}:{node[2]!r}"
    if kind == "map":
        lines = [f"{pad}map{{"]
        for k, vals in node[1]:
            body = " | ".join(sorted(_pretty(v).strip() for v in vals))
            lines.append(f"{pad}  {k!r} => {{{body}}}")
        lines.append(pad + "}")
        return "\n".join(lines)
    lines = [f"{pad}list["]
    for vals in node[1]:
        body = " | ".join(sorted(_pretty(v).strip() for v in vals))
        lines.append(f"{pad}  {{{body}}}")
    lines.append(pad + "]")
    return "\n".join(lines)


def assert_doc(doc, expected, heads=None):
    """Assert the whole document realizes to ``expected`` (map_/list_)."""
    got = realize(doc, heads=heads)
    if got != expected:
        raise AssertionError(
            "document mismatch\n-- expected --\n%s\n-- got --\n%s"
            % (_pretty(expected), _pretty(got))
        )


def assert_obj(doc, obj: str, expected, heads=None):
    """Assert one object (by exid) realizes to ``expected``."""
    got = realize_obj(doc, obj, heads=heads)
    if got != expected:
        raise AssertionError(
            "object %s mismatch\n-- expected --\n%s\n-- got --\n%s"
            % (obj, _pretty(expected), _pretty(got))
        )


def pretty(node) -> str:
    """Render a realized node for debugging."""
    try:
        return _pretty(node)
    except Exception:
        return pprint.pformat(node)
