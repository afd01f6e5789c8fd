"""Graphviz dot dumps of document structure.

The reference renders its per-object op trees to dot behind the
``optree-visualisation`` feature (reference:
rust/automerge/src/visualisation.rs, op_set.rs:265-285 visualise,
automerge.rs:1241-1256 visualise_optree). There is no B-tree here, so the
faithful analogue renders what this design actually is: one cluster per
object, element/op nodes in document order with the RGA insert-parent
edges, winners highlighted, tombstones greyed — plus a change-graph view
(the causal DAG, change_graph.rs's structure).

Usage::

    from automerge_tpu_torch.visualisation import doc_to_dot, changes_to_dot
    open("doc.dot", "w").write(doc_to_dot(doc))   # dot -Tsvg doc.dot

The port of ``automerge_tpu/visualisation.py`` over the port's op store:
the same dot text for the same document. A document whose op store is
stale (a bulk load, a large session commit) rebuilds it on its device
first, as any read does.
"""

from __future__ import annotations

from typing import List

from .core.op_store import MapObject


def _esc(s: str) -> str:
    return str(s).replace("\\", "\\\\").replace('"', '\\"')


def _value_label(op) -> str:
    from .types import is_make_action, objtype_for_action

    if is_make_action(op.action):
        return f"make {objtype_for_action(op.action).name.lower()}"
    v = op.value
    if v.tag == "str":
        return repr(v.value)
    return f"{v.tag} {v.value!r}"


def doc_to_dot(doc) -> str:
    """The document's objects/ops as a dot graph (current materialized
    state; accepts Document or AutoDoc)."""
    d = getattr(doc, "doc", doc)
    lines: List[str] = [
        "digraph automerge {",
        "  rankdir=LR; node [shape=box, fontsize=9, fontname=monospace];",
    ]
    store = d.ops
    for n, obj_id in enumerate(store.objects):
        info = store.get_obj(obj_id)
        exid = d.export_id(obj_id)
        lines.append(f'  subgraph cluster_{n} {{ label="{_esc(exid)}";')
        if isinstance(info.data, MapObject):
            for key_idx in sorted(info.data.props):
                key = d.props.get(key_idx)
                for op in info.data.props[key_idx]:
                    oid = d.export_id(op.id)
                    vis = op.visible_at(None)
                    style = "filled" if vis else "dashed"
                    fill = ', fillcolor="lightblue"' if vis else ""
                    lines.append(
                        f'    "{_esc(oid)}" [label="{_esc(key)} = '
                        f'{_esc(_value_label(op))}\\n{_esc(oid)}", '
                        f'style="{style}"{fill}];'
                    )
        else:
            from .types import Action

            prev = None
            for el in info.data.elements():
                eid = d.export_id(el.elem_id)
                w = el.winner()
                if w is not None:
                    label, style, fill = (
                        _value_label(w), "filled", ', fillcolor="lightyellow"'
                    )
                elif el.op is not None and el.op.action == Action.MARK:
                    name = el.op.mark_name or "(end)"
                    label, style, fill = (
                        f"mark {name}", "dotted", ', fillcolor="mistyrose"'
                    )
                else:
                    label, style, fill = "(tombstone)", "dashed", ""
                lines.append(
                    f'    "{_esc(eid)}" [label="{_esc(label)}\\n{_esc(eid)}", '
                    f'style="{style}"{fill}];'
                )
                if prev is not None:
                    lines.append(f'    "{_esc(prev)}" -> "{_esc(eid)}";')
                prev = eid
        lines.append("  }")
    lines.append("}")
    return "\n".join(lines)


def changes_to_dot(doc) -> str:
    """The causal change DAG as dot: one node per change (short hash,
    actor, seq, op count), edges to dependencies."""
    d = getattr(doc, "doc", doc)
    lines = [
        "digraph changes {",
        "  rankdir=BT; node [shape=box, fontsize=9, fontname=monospace];",
    ]
    heads = set(d.get_heads())
    for a in d.history:
        st = a.stored
        h = st.hash.hex()[:8]
        actor_hex = bytes(st.actor).hex()[:8]
        fill = ', style="filled", fillcolor="palegreen"' if st.hash in heads else ""
        lines.append(
            f'  "{h}" [label="{h}\\n{actor_hex} seq {st.seq}\\n'
            f'{len(st.ops)} ops"{fill}];'
        )
        for dep in st.dependencies:
            lines.append(f'  "{h}" -> "{dep.hex()[:8]}";')
    lines.append("}")
    return "\n".join(lines)
