"""ExpandedChange: a JSON-able view of a change chunk.

The analogue of the reference's legacy ExpandedChange form used by
``decodeChange`` and the CLI's examine output (reference:
rust/automerge/src/legacy/, rust/automerge/src/change.rs:283-338): op ids
become "<ctr>@<actorhex>" strings, values carry explicit datatypes where
the JSON type is ambiguous.
"""

from __future__ import annotations

from typing import List

from .storage.change import ChangeOp, StoredChange
from .types import Action, Key, ScalarValue

_ACTION_NAMES = {
    Action.MAKE_MAP: "makeMap",
    Action.PUT: "set",
    Action.MAKE_LIST: "makeList",
    Action.DELETE: "del",
    Action.MAKE_TEXT: "makeText",
    Action.INCREMENT: "inc",
    Action.MAKE_TABLE: "makeTable",
    Action.MARK: "mark",
}


def _opid_str(opid, actors: List[bytes]) -> str:
    return f"{opid[0]}@{actors[opid[1]].hex()}"


def _value_json(v: ScalarValue):
    if v.tag == "counter":
        return {"value": v.value, "datatype": "counter"}
    if v.tag == "timestamp":
        return {"value": v.value, "datatype": "timestamp"}
    if v.tag == "uint":
        return {"value": v.value, "datatype": "uint"}
    if v.tag == "f64":
        return {"value": v.value, "datatype": "float64"}
    if v.tag == "bytes":
        return {"value": v.value.hex(), "datatype": "bytes"}
    if v.tag == "unknown":
        code, raw = v.value
        return {"value": raw.hex(), "datatype": f"unknown{code}"}
    return v.to_py()


def expand_change(change: StoredChange) -> dict:
    actors = list(change.actors)
    ops = []
    for i, cop in enumerate(change.ops):
        op: dict = {
            "action": _ACTION_NAMES.get(Action(cop.action), str(cop.action)),
            "obj": "_root" if cop.obj[0] == 0 else _opid_str(cop.obj, actors),
            "insert": bool(cop.insert),
            "pred": [_opid_str(p, actors) for p in cop.pred],
        }
        if cop.key.prop is not None:
            op["key"] = cop.key.prop
        else:
            e = cop.key.elem
            op["elemId"] = "_head" if e[0] == 0 else _opid_str(e, actors)
        if cop.action in (Action.PUT, Action.INCREMENT, Action.MARK):
            op["value"] = _value_json(cop.value)
        if cop.mark_name is not None:
            op["name"] = cop.mark_name
        if cop.expand:
            op["expand"] = True
        ops.append(op)
    return {
        "actor": change.actor.hex(),
        "seq": change.seq,
        "startOp": change.start_op,
        "time": change.timestamp,
        "message": change.message,
        "deps": [d.hex() for d in sorted(change.dependencies)],
        "hash": change.hash.hex() if change.hash else None,
        "ops": ops,
        "extraBytes": change.extra_bytes.hex() if change.extra_bytes else None,
    }


_ACTION_FOR = {name: act for act, name in _ACTION_NAMES.items()}


def _value_from_json(v) -> ScalarValue:
    if isinstance(v, dict):
        dt = v.get("datatype")
        raw = v.get("value")
        if dt == "counter":
            return ScalarValue("counter", int(raw))
        if dt == "timestamp":
            return ScalarValue("timestamp", int(raw))
        if dt == "uint":
            return ScalarValue("uint", int(raw))
        if dt == "float64":
            return ScalarValue("f64", float(raw))
        if dt == "bytes":
            return ScalarValue("bytes", bytes.fromhex(raw))
        if isinstance(dt, str) and dt.startswith("unknown"):
            return ScalarValue("unknown", (int(dt[7:]), bytes.fromhex(raw)))
        raise ValueError(f"unknown datatype {dt!r}")
    if v is None:
        return ScalarValue("null")
    if isinstance(v, bool):
        return ScalarValue("bool", v)
    if isinstance(v, int):
        return ScalarValue("int", v)
    if isinstance(v, float):
        return ScalarValue("f64", v)
    if isinstance(v, str):
        return ScalarValue("str", v)
    raise ValueError(f"cannot collapse value {v!r}")


def collapse_change(expanded: dict) -> StoredChange:
    """The inverse of ``expand_change``: JSON form -> built StoredChange.

    The analogue of the reference's ``ExpandedChange -> Change`` conversion
    (reference: rust/automerge/src/change.rs:283-338 via legacy/). The
    returned change is fully built (hash + raw bytes), so an
    expand/collapse roundtrip preserves the change hash.
    """
    from .storage.change import HEAD_STORED, ROOT_STORED, build_change

    author = bytes.fromhex(expanded["actor"])
    others = sorted(
        {
            bytes.fromhex(s.split("@", 1)[1])
            for op in expanded["ops"]
            for s in [op["obj"], op.get("elemId", "_head"), *op["pred"]]
            if s not in ("_root", "_head")
        }
        - {author}
    )
    actors = [author, *others]
    idx_of = {a: i for i, a in enumerate(actors)}

    def opid(s: str) -> tuple:
        ctr_s, actor_hex = s.split("@", 1)
        return (int(ctr_s), idx_of[bytes.fromhex(actor_hex)])

    ops = []
    for op in expanded["ops"]:
        action = _ACTION_FOR.get(op["action"])
        if action is None:
            raise ValueError(f"unknown action {op['action']!r}")
        if "key" in op:
            key = Key.map(op["key"])
        else:
            e = op.get("elemId", "_head")
            key = Key.seq(HEAD_STORED if e == "_head" else opid(e))
        ops.append(
            ChangeOp(
                obj=ROOT_STORED if op["obj"] == "_root" else opid(op["obj"]),
                key=key,
                insert=bool(op.get("insert")),
                action=int(action),
                value=_value_from_json(op.get("value")),
                # preserve the stored pred order (Lamport by actor BYTES —
                # re-sorting by chunk-local index would change the bytes
                # and the hash)
                pred=[opid(p) for p in op["pred"]],
                expand=bool(op.get("expand")),
                mark_name=op.get("name"),
            )
        )
    return build_change(
        StoredChange(
            dependencies=sorted(bytes.fromhex(d) for d in expanded["deps"]),
            actor=author,
            other_actors=others,
            seq=int(expanded["seq"]),
            start_op=int(expanded["startOp"]),
            timestamp=int(expanded.get("time") or 0),
            message=expanded.get("message"),
            ops=ops,
            extra_bytes=bytes.fromhex(expanded["extraBytes"])
            if expanded.get("extraBytes")
            else b"",
        )
    )
