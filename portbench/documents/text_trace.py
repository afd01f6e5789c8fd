"""The edit-trace text document: its generator, its timed read, and the
glue between what the program read and the plain reference.

The generator is a frozen, seeded copy of the port's ``workload.py``
(``typing_trace``, ``base_change``, ``seq_change``, ``fanin_changes``): the
base is ONE change that replays a typing-shaped trace into the text object
``_root.text``; each replica is one change of its own actor, with deps on
the base, that replays a slice of the late trace re-anchored onto the
base's elements. The trace is the configuration's (``trace_seed``), so
every seed merges the same edits: the seed deals the replicas' slices to
their actors in another order (seed 0 in the port's own order, and so the
port's bytes), which reorders the concurrent inserts at every shared
anchor. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

from .. import codec
from ..reference import text_trace as reference

BASE_ACTOR = bytes([1]) * 16
_MAKE_TEXT, _PUT, _DELETE = 4, 1, 3


def replica_actor(i: int) -> bytes:
    return b"\x03" + i.to_bytes(3, "big") + bytes(12)


def replica_rng(seed: int, salt: int) -> np.random.Generator:
    """The generator of replica-level choices: seed 0 gives the port's
    ``default_rng(salt)``."""
    return np.random.default_rng((seed << 32) | salt)


def dealt(seed: int, n: int) -> np.ndarray:
    """Which actor each of ``n`` replica slots gets: in order at seed 0, a
    seeded permutation otherwise."""
    return np.random.default_rng(seed).permutation(n) if seed else np.arange(n)


def typing_trace(n: int, seed: int, insert_share: float, cycle: int) -> list:
    """``n`` edits [pos, ndel, *chars] shaped like typing: a stretch typed
    at the cursor, then a jump and a stretch deleted backwards, and so on,
    with geometric stretch lengths (the port's ``workload.typing_trace``)."""
    rng = np.random.default_rng(seed)
    end_typing = 1 / (cycle * insert_share)
    end_deleting = 1 / (cycle * (1 - insert_share))
    u = rng.random(n)
    where = rng.random(n)
    chars = rng.integers(0, 26, n)
    edits, length, cursor, typing = [], 0, 0, True
    for i in range(n):
        if typing and u[i] < end_typing:
            typing = False
            cursor = int(where[i] * (length + 1))
        elif not typing and u[i] < end_deleting:
            typing = True
        if typing or cursor == 0:
            edits.append([cursor, 0, chr(ord("a") + int(chars[i]))])
            cursor += 1
            length += 1
        else:
            edits.append([cursor - 1, 1])
            cursor -= 1
            length -= 1
    return edits


class _Ref:
    """The ops in the reference's global form, as the generator emits them."""

    def __init__(self):
        self.ins = []  # (ctr, actor, anchor ctr, anchor actor, char, change)
        self.dels = []  # (ctr, actor, change)

    def arrays(self, actors) -> dict:
        ins = np.array(self.ins, np.int64).reshape(-1, 6)
        dels = np.array(self.dels, np.int64).reshape(-1, 3)
        return {
            "actors": np.frombuffer(b"".join(actors), np.uint8).reshape(len(actors), -1),
            "ins_ctr": ins[:, 0], "ins_actor": ins[:, 1].astype(np.int32),
            "anc_ctr": ins[:, 2], "anc_actor": ins[:, 3].astype(np.int32),
            "ins_char": ins[:, 4].astype(np.uint8), "ins_change": ins[:, 5].astype(np.int32),
            "del_ctr": dels[:, 0], "del_actor": dels[:, 1].astype(np.int32),
            "del_change": dels[:, 2].astype(np.int32),
        }


def _base(trace, n_edits: int, ref: _Ref):
    """(ops, visible element counters in document order) of the base:
    op 1 makes ``_root.text``; each edit deletes (each delete preds the
    element's insert) then inserts characters chained off one another."""
    ops = [(None, "text", None, False, _MAKE_TEXT, ("null", None), [])]
    ctr = 1
    elems: list = []
    for e in trace[:n_edits]:
        pos = min(int(e[0]), len(elems))
        ndel = min(int(e[1]), len(elems) - pos)
        for el in elems[pos:pos + ndel]:
            ctr += 1
            ops.append(((1, 0), None, (el, 0), False, _DELETE, ("null", None), [(el, 0)]))
            ref.dels.append((el, 0, 0))
        del elems[pos:pos + ndel]
        anchor = (elems[pos - 1], 0) if pos else codec.HEAD
        new = []
        for ch in "".join(e[2:]):
            ctr += 1
            ops.append(((1, 0), None, anchor, True, _PUT, ("str", ch), []))
            ref.ins.append((ctr, 0, anchor[0], anchor[1], ord(ch), 0))
            anchor = (ctr, 0)
            new.append(ctr)
        elems[pos:pos] = new
    return ops, elems


def _replica(elems, max_op: int, edits, rng, change: int, ref: _Ref):
    """One replica's ops against the base (the port's ``seq_change``): the
    base's actor is local index 1 and global actor 0, the author local 0
    and global ``change``."""
    n_base = len(elems)
    ops = []
    ctr = max_op
    deleted: set = set()
    last_insert = None
    last_insert_pos = -2
    for e in edits:
        pos = min(int(e[0]), max(n_base - 1, 0))
        text = "".join(e[2:])
        if e[1] and n_base:
            k = pos
            for _ in range(8):
                if k not in deleted and k < n_base:
                    break
                k = int(rng.integers(0, n_base))
            if k in deleted or k >= n_base:
                continue
            deleted.add(k)
            elem = (elems[k], 1)
            ctr += 1
            ops.append(((1, 1), None, elem, False, _DELETE, ("null", None), [elem]))
            ref.dels.append((elems[k], 0, change))
        for ch in text:
            if last_insert is not None and pos == last_insert_pos + 1:
                elem, anc = last_insert, (last_insert[0], change)
            elif pos == 0 or n_base == 0:
                elem, anc = codec.HEAD, codec.HEAD
            else:
                elem = (elems[min(pos - 1, n_base - 1)], 1)
                anc = (elem[0], 0)
            ctr += 1
            ops.append(((1, 1), None, elem, True, _PUT, ("str", ch), []))
            ref.ins.append((ctr, change, anc[0], anc[1], ord(ch), change))
            last_insert = (ctr, 0)
            last_insert_pos = pos
            pos += 1
    return ops


def generate(cfg: dict, seed: int) -> dict:
    """The change chunks (base first), each change's op count, the
    reference's inputs and the merge's sizes."""
    n_edits = cfg["base_edits"]
    trace = typing_trace(cfg["trace_edits"], cfg["trace_seed"],
                         cfg["trace_inserts"] / (cfg["trace_inserts"] + cfg["trace_deletes"]),
                         cfg["typing_cycle"])
    ref = _Ref()
    base_ops, elems = _base(trace, n_edits, ref)
    base_bytes, base_hash = codec.build_change([], BASE_ACTOR, [], 1, 1, base_ops)
    chunks, n_ops = [base_bytes], [len(base_ops)]
    max_op = len(base_ops)
    per = cfg["per_replica"]
    # the late trace: slices wrap within [offset/2, end)
    lo0 = min(n_edits // 2, max(len(trace) - per - 1, 0))
    span = max(len(trace) - lo0 - per, 1)
    actors = [BASE_ACTOR]
    actor_of = dealt(seed, cfg["replicas"])
    for i in range(cfg["replicas"]):
        lo = lo0 + (n_edits // 2 + i * per) % span
        ops = _replica(elems, max_op, trace[lo:lo + per], replica_rng(0, 1000 + i),
                       i + 1, ref)
        actor = replica_actor(int(actor_of[i]))
        actors.append(actor)
        chunks.append(codec.build_change([base_hash], actor, [BASE_ACTOR], 1,
                                         max_op + 1, ops)[0])
        n_ops.append(len(ops))
    arrays = ref.arrays(actors)
    return {
        "chunks": chunks,
        "n_ops": n_ops,
        "ref": arrays,
        "work": {"ops": int(sum(n_ops)), "pred_edges": int(len(arrays["del_ctr"])),
                 "objects": 2},
        "obj": f"1@{BASE_ACTOR.hex()}",
    }


# -- the timed read, and the comparison ----------------------------------------


def read(doc, inputs: dict):
    """The read a fan-in iteration makes: the whole text."""
    return doc.text(inputs["obj"])


def want(inputs: dict, n_changes: int, control: bool = False) -> str:
    """The reference's text after the first ``n_changes`` changes (with
    ``control``, the reference with its guarantee broken)."""
    return reference.text(inputs["ref"], n_changes,
                          sibling_order="arrival" if control else "opid")


def after_window(doc, inputs: dict, expect: str, rng) -> dict:
    """Reads of the last document that the comparison needs beyond the
    timed reads: none for text."""
    return {}


def compare(got: str, expect: str, extra: dict = None) -> dict:
    """Numbers compared: characters that differ (positions, plus the
    difference in length)."""
    a = np.frombuffer(got.encode("utf-32-le"), np.uint32)
    b = np.frombuffer(expect.encode("utf-32-le"), np.uint32)
    n = min(len(a), len(b))
    return {"text_mismatch": int(np.count_nonzero(a[:n] != b[:n]) + abs(len(a) - len(b)))}


LIMITS = {"text_mismatch": 0}


class StateDoc:
    """A reference state behind the read API the timed read uses: what puts
    the reference (or the control) in the program's place."""

    def __init__(self, state: str):
        self.state = state

    def text(self, obj: str) -> str:
        return self.state
