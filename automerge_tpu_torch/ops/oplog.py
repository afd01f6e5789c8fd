"""Columnar op-log: the device representation of a document's op set.

The reference's *storage* format (rust/automerge/src/storage/document/
doc_op_columns.rs — obj/key/id/insert/action/val/succ columns) is the
blueprint for this layout: ops live as a struct-of-arrays so an entire
multi-replica merge is a handful of scatters, sorts and gathers on device
(see ops/merge.py).

Lamport order (reference: types.rs:517-521) compares (counter, actor-bytes).
The host flattens changes, ranks actors by byte order, packs every OpId into
an int64 ``counter << ACTOR_BITS | actor_rank`` key, and **sorts the whole
log by that key once** — after which the row index itself is a dense int32
Lamport rank. All cross-op references (pred targets, RGA reference elements,
containing objects) are resolved to row indices host-side with vectorized
searchsorted, so the device kernels are pure int32: comparisons are plain
row-index comparisons.

``from_changes`` builds the columns with the native assembler
(ops/assemble.py) from each change's decoded column bytes, and the
incremental append (``append_changes``: new changes spliced into the
resident columns by position arithmetic, with an ``AppendInfo`` saying
what moved) extracts only the delta the same way; no op is visited in
Python. ``fast=False`` on both takes the per-op path of
``automerge_tpu.ops.oplog`` (its ``_collect_slow``) instead: the explicit
oracle the tests hold the native path to, never a fallback.

Beside the dense columns a log keeps a compressed image of them
(``compressed``, ops/compressed.py): it gives the residency figures and
the ARSN snapshot (storage/runsnap.py), and on a tail append by known
actors its id runs answer the reference joins (the offset-value-coded
join) instead of ``join_rows``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .. import native, obs
from ..storage.change import StoredChange
from ..types import ACTOR_BITS, ActorId, ScalarValue, str_width
from . import compressed as C

# Up to 2^20 distinct actors per merged log; counters up to 2^43.
ACTOR_MASK = (1 << ACTOR_BITS) - 1
PAD_ACTION = 15
# the make actions (object-creating ops; reference: types.rs action
# indices 0/2/4/6)
MAKE_ACTIONS = (0, 2, 4, 6)

# elem_ref sentinels (column is an int32 row index otherwise)
ELEM_HEAD = -1  # insert at list HEAD
ELEM_MAP = -2  # a map op (no element reference)
ELEM_MISSING = -3  # reference element not in this log

# value_tag codes (aligned with storage value-metadata type codes where
# they exist; reference: value.rs ValueType)
TAG_NULL = 0
TAG_FALSE = 1
TAG_TRUE = 2
TAG_UINT = 3
TAG_INT = 4
TAG_F64 = 5
TAG_STR = 6
TAG_BYTES = 7
TAG_COUNTER = 8
TAG_TIMESTAMP = 9
TAG_UNKNOWN = 10

_TAG_FOR = {
    "null": TAG_NULL,
    "uint": TAG_UINT,
    "int": TAG_INT,
    "f64": TAG_F64,
    "str": TAG_STR,
    "bytes": TAG_BYTES,
    "counter": TAG_COUNTER,
    "timestamp": TAG_TIMESTAMP,
    "unknown": TAG_UNKNOWN,
}


def join_rows(sorted_keys: np.ndarray, keys, missing: int) -> np.ndarray:
    """Row indices of ``keys`` in the sorted packed-id column
    ``sorted_keys`` (``missing`` for absent keys), by the native join."""
    return native.join_rows(sorted_keys, np.asarray(keys, np.int64), missing)


def pack_id(ctr: int, rank: int) -> int:
    return (int(ctr) << ACTOR_BITS) | int(rank)


def unpack_id(key: int) -> Tuple[int, int]:
    return int(key) >> ACTOR_BITS, int(key) & ACTOR_MASK


class OpLog:
    """A merged, deduplicated change set flattened into Lamport-ordered
    op columns.

    Host-side (int64/object) state: ``id_key`` packed op ids, ``obj_key``
    packed object ids, the ``values`` (an ``extract.LazyValues`` heap, a
    list on the per-op path), actor/prop tables. Device-facing
    int32 columns: action/insert/prop/value_tag/value_i32/width plus
    resolved references ``elem_ref``, ``obj_dense``, ``pred_src``/
    ``pred_tgt`` (see padded_columns).
    """

    __slots__ = (
        "actors",
        "props",
        "values",
        "changes",
        "mark_names",
        "n",
        "n_objs",
        "id_key",
        "obj_key",
        "obj_table",
        "obj_dense",
        "prop",
        "elem_ref",
        "action",
        "insert",
        "value_tag",
        "value_int",
        "width",
        "pred_src",
        "pred_tgt",
        "expand",
        "mark_name_idx",
        "elem_key",
        "pred_key",
        "n_miss_elem",
        "n_miss_pred",
        "_hash_set",
        "_bufs",
        "_actor_order",
        "_comp",
    )

    def __init__(self):
        self.actors: List[ActorId] = []
        self.props: List[str] = []
        self.values: List[ScalarValue] = []
        self.changes: List[StoredChange] = []
        self.mark_names: List[str] = []
        self.n = 0
        self.n_objs = 1
        # packed reference keys (elem per row: -1 map op, 0 HEAD; pred per
        # edge), kept by _finalize for the append path's re-resolution
        # (an assembled log rebuilds them on its first append)
        self.elem_key = None
        self.pred_key = None
        # unresolved references (elem_ref == ELEM_MISSING rows, pred_tgt < 0
        # edges), kept current across appends: the cross-document staging
        # (ops/host_batch.py) takes its tail splice only when both are 0,
        # and must not scan the whole log per drain to find out
        self.n_miss_elem = 0
        self.n_miss_pred = 0
        self._hash_set = None
        self._bufs = None  # capacity-bucketed backing buffers of the splice
        self._actor_order = None
        # the compressed image of the columns (ops/compressed.py), built on
        # first use and dropped by anything that rewrites the prefix
        self._comp = None

    # -- construction --------------------------------------------------

    @classmethod
    def from_changes(cls, changes: Iterable[StoredChange],
                     fast: bool = True) -> "OpLog":
        """Flatten changes (deduped by hash) into Lamport-ordered columns.

        Order-independent: visibility and RGA order depend only on op ids
        and pred links, never on application order — which is what makes the
        N-way fan-in merge a single batched pass instead of the reference's
        per-op seek/insert loop (automerge.rs:1258-1280).

        ``fast`` (the default) assembles the log natively from the
        changes' column bytes (``assemble.assemble_log``); a change set
        with a negative key or pred counter, which the assembler does not
        place, goes to the batch extraction (``_collect_fast``, native
        too), decided by ``assemble.route`` before either runs. A counter
        past the packed ids' range (2^43) raises ``AssembleError``, as the
        per-op path overflows there. ``fast=False`` is the per-op oracle.
        """
        log, deduped, rank_of = cls._start(changes)
        if not fast:
            with obs.span("device.extract", changes=len(deduped)):
                return cls._collect(log, deduped, rank_of)
        from . import assemble as A

        way = A.route(deduped)
        if way == A.ROUTE_OVERFLOW:
            raise A.AssembleError("counter outside packed range")
        if way == A.ROUTE_BATCH:
            with obs.span("device.extract", changes=len(deduped)):
                return cls._collect_fast(log, deduped, rank_of)
        with obs.span("device.extract", changes=len(deduped)):
            return A.assemble_log(log, deduped, rank_of)

    @classmethod
    def from_documents(cls, docs: Sequence) -> "OpLog":
        """Union of several documents' histories (the N-way fan-in input).

        AutoDocs are committed first — the device log is built from change
        history, so pending transaction ops would otherwise be silently
        absent (the reference's AutoCommit likewise commits at every
        save/merge/sync boundary, autocommit.rs:582)."""
        from ..types import get_text_encoding, using_text_encoding

        changes: List[StoredChange] = []
        encoding = None
        for d in docs:
            commit = getattr(d, "commit", None)
            if commit is not None:
                commit()
            doc = getattr(d, "doc", d)  # AutoDoc or Document
            if getattr(doc, "open_transactions", None):
                raise ValueError(
                    "document has an open manual transaction; commit or "
                    "roll it back before building a device log"
                )
            # None means "follow the process default": resolve it before
            # comparing, else a default-encoding doc mixed with an
            # explicit-encoding doc slips past the check
            d_enc = getattr(doc, "text_encoding", None) or get_text_encoding()
            if encoding is None:
                encoding = d_enc
            elif d_enc != encoding:
                raise ValueError(
                    f"documents carry conflicting text encodings "
                    f"({encoding!r} vs {d_enc!r}); width columns would "
                    "silently disagree — re-encode one side first"
                )
            changes.extend(a.stored for a in doc.history)
        # width columns follow the documents' (verified-uniform) text
        # encoding; in the reference the unit is fixed per build
        with using_text_encoding(encoding):
            return cls.from_changes(changes)

    @classmethod
    def _start(cls, changes: Iterable[StoredChange]):
        """(an empty log holding the deduped changes and their actors in
        rank order, the deduped changes, actor bytes -> rank)."""
        log = cls()
        seen = set()
        deduped: List[StoredChange] = []
        actor_bytes = set()
        for ch in changes:
            if ch.hash in seen:
                continue
            seen.add(ch.hash)
            deduped.append(ch)
            for a in ch.actors:
                actor_bytes.add(bytes(a))
        log.changes = deduped
        ranked = sorted(actor_bytes)
        rank_of = {a: i for i, a in enumerate(ranked)}
        log.actors = [ActorId(a) for a in ranked]
        if len(ranked) >= (1 << ACTOR_BITS):
            raise ValueError("too many actors for packed id encoding")
        return log, deduped, rank_of

    @classmethod
    def _collect(cls, log, deduped, rank_of) -> "OpLog":
        """The per-op oracle: every op visited in Python (``_flatten``)."""
        f = _flatten(deduped, rank_of)
        log.props = f["key_table"]
        log.mark_names = f["mark_table"]
        return cls._finalize(
            log, f["id_key"], f["obj"], f["prop_ids"], f["elem"], f["action"],
            f["insert"], f["vtag"], f["value_int"], f["width"], f["expand"],
            f["mark_ids"], f["pred_src"], f["pred_key"], f["values"],
        )

    @classmethod
    def _collect_fast(cls, log, deduped, rank_of) -> "OpLog":
        """The batch extraction: the changes' cached columns
        (``assemble.ranked_from_caches``, decoded natively once a change)
        rank-translated and concatenated, then the shared Lamport sort and
        reference joins (``_finalize``). Places what the assembler does
        not: a negative key or pred counter, as a missing reference."""
        from .assemble import ranked_from_caches

        r = ranked_from_caches(deduped, rank_of)
        a = r["a"]
        N = a["n"]
        mark_idx = (
            a["mark_ids"] if a["mark_ids"] is not None else np.full(N, -1, np.int32)
        )
        log.props = list(a["key_table"])
        log.mark_names = list(a["mark_table"])
        return cls._finalize(
            log,
            r["id_key"],
            r["obj"],
            r["prop_ids"].astype(np.int32),
            r["elem"],
            a["action"],
            a["insert"],
            np.minimum(a["vcode"], TAG_UNKNOWN).astype(np.int32),
            a["value_int"],
            a["width"],
            a["expand"],
            mark_idx.astype(np.int32),
            r["pred_src"],
            r["pred_key"],
            (a["vcode"], a["voff"], a["vlen"], a["vraw"]),
        )

    @classmethod
    def _finalize(
        cls,
        log,
        id_key,
        obj,
        prop,
        elem,
        action,
        insert,
        vtag,
        vint,
        width,
        expand,
        mark_idx,
        pred_src,
        pred_key,
        values,
    ) -> "OpLog":
        """Sort everything into Lamport order and resolve references."""
        n = len(id_key)
        log.n = n

        # one argsort makes row index == dense Lamport rank
        order = np.argsort(id_key, kind="stable")
        log.id_key = id_key[order]
        obj = obj[order]
        log.obj_key = obj
        log.prop = prop[order]
        elem = elem[order]
        log.action = action[order]
        log.insert = insert[order]
        log.value_tag = vtag[order]
        log.value_int = vint[order]
        log.width = width[order]
        log.expand = expand[order]
        log.mark_name_idx = mark_idx[order]
        if isinstance(values, tuple):  # lazy heap: (code, off, len, raw)
            from .extract import LazyValues

            code, off, ln, raw = values
            log.values = LazyValues(code[order], off[order], ln[order], raw)
        else:
            log.values = [values[i] for i in order]

        inv = np.empty(n, np.int32)  # old row -> new row
        inv[order] = np.arange(n, dtype=np.int32)

        # element references: HEAD=-1, map op=-2, missing=-3
        log.elem_ref = np.where(
            log.prop >= 0,
            np.int32(ELEM_MAP),
            np.where(
                elem == 0,
                np.int32(ELEM_HEAD),
                join_rows(log.id_key, elem, ELEM_MISSING),
            ),
        ).astype(np.int32)

        # dense object ids: 0 = root, then by packed object id order.
        # Candidate ids come from the make ops (every object IS a make
        # op's id); a log whose ops reference objects with no make op in
        # it (partial histories) falls back to the exact unique.
        make_rows = np.flatnonzero(np.isin(log.action, MAKE_ACTIONS))
        cand = np.unique(np.concatenate([[0], log.id_key[make_rows]]))
        pos = np.searchsorted(cand, obj)
        posc = np.clip(pos, 0, len(cand) - 1)
        if np.all(cand[posc] == obj):
            log.obj_table = cand
            log.obj_dense = posc.astype(np.int32)
        else:
            log.obj_table = np.unique(np.concatenate([cand, obj]))
            log.obj_dense = np.searchsorted(log.obj_table, obj).astype(np.int32)
        log.n_objs = len(log.obj_table)

        # pred references -> (src row, tgt row) pairs
        log.pred_src = inv[pred_src] if len(pred_src) else np.empty(0, np.int32)
        tgt = (
            join_rows(log.id_key, pred_key, -1)
            if len(pred_key)
            else np.empty(0, np.int32)
        )
        log.pred_tgt = tgt.astype(np.int32)
        log.elem_key = elem
        log.pred_key = np.asarray(pred_key, np.int64)
        log.count_missing()
        return log

    # -- device prep -----------------------------------------------------

    def columns(self, covered: np.ndarray = None, include_aorder: bool = False):
        """The device-facing column dict WITHOUT capacity padding.

        ``include_aorder`` attaches the actor-order layout (``actor_order``)
        that the condensed linearization reads."""
        if covered is None:
            covered = np.ones(self.n, np.bool_)
        return {
            "action": self.action,
            "insert": np.asarray(self.insert, np.bool_),
            "prop": self.prop,
            "elem_ref": self.elem_ref,
            "obj_dense": self.obj_dense,
            "value_tag": self.value_tag,
            "value_i32": self.value_int.astype(np.int32),
            "width": self.width,
            "covered": np.asarray(covered, np.bool_),
            "pred_src": self.pred_src,
            "pred_tgt": self.pred_tgt,
            **({"aorder": self.actor_order()} if include_aorder else {}),
        }

    def padded_columns(self, min_capacity: int = 16, covered: np.ndarray = None,
                       include_aorder: bool = False):
        """Pad to bucketed capacities (see ``_capacity``).

        Everything is int32/bool. Counter payloads are truncated to int32
        on device (exact int64 totals are recovered host-side from
        ``value_int``, see DeviceDoc._recompute_counters).
        """
        return pad_columns(
            self.columns(covered=covered, include_aorder=include_aorder),
            self.n_objs, min_capacity,
        )

    def actor_order(self) -> np.ndarray:
        """The INSERT rows in ACTOR-CONCATENATED order: each actor's element
        ops consecutive, counters ascending. In this order a typing chain
        is a contiguous stretch (each op's RGA reference is the author's
        previous op), which lets the condensed linearization find chains
        with scans instead of pointer chasing
        (kernels/linearize_condensed.py). Cached until the log changes."""
        ao = self._actor_order
        if ao is None:
            rank = (self.id_key & ACTOR_MASK).astype(np.int64)
            perm = np.argsort(rank, kind="stable").astype(np.int32)
            ao = perm[np.asarray(self.insert, bool)[perm]]
            self._actor_order = ao
        return ao

    def condensed_run_count(self) -> int:
        """The exact number of chain runs the condensed linearization
        finds in ``actor_order`` (at least 1), by vector passes: a slot
        continues its run when its row is its parent's first child and
        its parent is the previous slot's row."""
        n = self.n
        if n == 0:
            return 1
        ins = np.asarray(self.insert, bool)
        er = self.elem_ref
        rows = np.arange(n, dtype=np.int64)
        # first_child[p] = the LAST insert row referencing p (later rows
        # shadow earlier ones: fancy assignment keeps the last write)
        fc = np.full(n, -1, np.int64)
        em = ins & (er >= 0)
        fc[er[em]] = rows[em]
        erc = np.clip(er, 0, n - 1)
        is_cont = em & (fc[erc] == rows)
        vs = self.actor_order()
        prev = np.concatenate([[-9], vs[:-1]])
        cont = is_cont[vs] & (er[vs] == prev)
        return max(int((~cont).sum()), 1)

    def covered_mask(self, clock_max_op: np.ndarray) -> np.ndarray:
        """Vectorized ``Clock::covers`` (reference: clock.rs:71-77): row i is
        covered iff its counter <= clock_max_op[actor rank]. ``clock_max_op``
        is the dense per-rank max-op vector (0 = actor not in clock)."""
        ctr = self.id_key >> ACTOR_BITS
        rank = (self.id_key & ACTOR_MASK).astype(np.int64)
        return ctr <= np.asarray(clock_max_op, np.int64)[rank]

    def count_missing(self) -> None:
        """Sets ``n_miss_elem`` / ``n_miss_pred`` from the columns."""
        self.n_miss_elem = int(np.count_nonzero(self.elem_ref == ELEM_MISSING))
        self.n_miss_pred = int(np.count_nonzero(self.pred_tgt < 0))

    # -- compressed residency (ops/compressed.py) ---------------------------

    def compressed(self, sync: bool = True):
        """The compressed image of the columns, or None when compressed
        residency is off (``compressed.ENABLED``). Kept incrementally:
        tail appends extend the last runs; a rewrite of the prefix drops
        the image and the next call encodes it again."""
        if not C.enabled():
            return None
        if self._comp is None:
            self._comp = C.CompressedOpColumns()
        if sync:
            self._comp.sync(self)
        return self._comp

    def dense_column_nbytes(self) -> int:
        """The dense bytes of the column set. A column not materialized
        (``elem_key`` / ``pred_key`` of an assembled log) counts zero, as
        it does in ``resident_column_nbytes``: bytes on one side only
        would inflate ``compress_ratio``."""
        q = len(self.pred_src)
        return sum(
            self.n * item
            for name, _, item in C.ROW_SPEC
            if getattr(self, name) is not None
        ) + sum(
            q * item
            for name, _, item in C.EDGE_SPEC
            if getattr(self, name) is not None
        )

    def resident_column_nbytes(self) -> int:
        """The bytes of the column set under the active mode: runs where
        the gate admits them, dense elsewhere. Syncs the image."""
        comp = self.compressed()
        if comp is None:
            return self.dense_column_nbytes()
        return comp.nbytes(self)

    def compress_ratio(self) -> float:
        comp = self.compressed()
        if comp is None:
            return 1.0
        return comp.ratio(self)

    # -- host-side id helpers ---------------------------------------------

    def export_id(self, key: int) -> str:
        if key == 0:
            return "_root"
        ctr, rank = unpack_id(key)
        return f"{ctr}@{self.actors[rank].to_hex()}"

    def import_id(self, exid: str) -> int:
        if exid == "_root":
            return 0
        ctr_s, actor_hex = exid.split("@", 1)
        target = bytes.fromhex(actor_hex)
        for rank, a in enumerate(self.actors):
            if a.bytes == target:
                return pack_id(int(ctr_s), rank)
        raise KeyError(f"unknown actor in id {exid!r}")

    def row_of_id(self, key: int) -> int:
        """The row of the op with packed id ``key`` (rows are sorted by
        ``id_key``)."""
        pos = int(np.searchsorted(self.id_key, key))
        if pos < self.n and self.id_key[pos] == key:
            return pos
        raise KeyError(f"no op with id {self.export_id(key)}")

    # -- incremental append -------------------------------------------------

    def hashes(self) -> set:
        hs = self._hash_set
        if hs is None:
            hs = self._hash_set = {ch.hash for ch in self.changes}
        return hs

    def _splice_col(self, name, old, new_vals, row_map, new_rows, tail, m):
        """One column's splice into a capacity-bucketed backing buffer.

        Tail appends into a still-roomy buffer write only the k new slots;
        everything else allocates at the bucket capacity and scatters both
        sides through the position maps (one vectorized pass per column)."""
        old = np.asarray(old)
        new_vals = np.asarray(new_vals).astype(old.dtype, copy=False)
        n = len(old)
        buf = self._bufs.get(name)
        if tail and buf is not None and old.base is buf and len(buf) >= m:
            buf[n:m] = new_vals
            return buf[:m]
        nbuf = np.empty(_capacity(m), old.dtype)
        out = nbuf[:m]
        if tail:
            out[:n] = old
            out[n:] = new_vals
        else:
            out[row_map] = old
            out[new_rows] = new_vals
        self._bufs[name] = nbuf
        return out

    def _ensure_ref_keys(self) -> bool:
        """Materialize the packed reference-key columns (``elem_key`` per
        row, ``pred_key`` per edge) the append path splices and
        re-resolves. Logs built by ``_finalize`` carry them; assembled
        logs rebuild them from the resolved row refs, which is impossible
        only when a ref is MISSING (a partial history): then False."""
        if self.elem_key is None:
            er = self.elem_ref
            if self.n and np.any(er == ELEM_MISSING):
                return False
            safe = np.clip(er, 0, max(self.n - 1, 0))
            self.elem_key = np.where(
                er == ELEM_MAP,
                np.int64(-1),
                np.where(er == ELEM_HEAD, np.int64(0), self.id_key[safe]),
            ).astype(np.int64)
        if self.pred_key is None:
            if len(self.pred_tgt) and np.any(self.pred_tgt < 0):
                return False
            self.pred_key = (
                self.id_key[self.pred_tgt].astype(np.int64)
                if len(self.pred_tgt)
                else np.empty(0, np.int64)
            )
        return True

    def append_changes(self, changes: Iterable[StoredChange], fast: bool = True):
        """Splice new changes into the existing columns WITHOUT re-collecting
        prior replicas: extract only the fresh changes (``_extract_delta``:
        natively, from their column caches), merge their rows into the
        Lamport order with searchsorted position arithmetic, re-resolve
        references that touch the delta, and report the dirty object set.
        ``fast=False`` flattens the fresh changes op by op instead (the
        per-op oracle).

        Returns an ``AppendInfo`` on success, or ``None`` when the log
        cannot be updated in place (packed-id collisions, too many actors,
        an assembled partial history whose MISSING refs have no key to
        re-resolve): the caller then rebuilds via ``from_changes``. New
        actors are handled in place: actor ranks are byte-ordered, so
        inserting actors remaps every packed key through a MONOTONE rank
        map, which preserves the existing sort order.
        """
        known = self.hashes()
        fresh: List[StoredChange] = []
        batch_seen = set()
        for ch in changes:
            if ch.hash is None or ch.hash in known or ch.hash in batch_seen:
                continue
            batch_seen.add(ch.hash)
            fresh.append(ch)
        if not fresh:
            return AppendInfo(self.n, 0, np.empty(0, np.int64), None, True,
                              np.empty(0, np.int64), None, False)
        if not self._ensure_ref_keys():
            obs.count("oplog.append_fallback", labels={"reason": "missing_refs"})
            return None

        # -- actor universe (monotone rank remap keeps old order sorted) --
        old_bytes = [a.bytes for a in self.actors]
        old_bytes_set = set(old_bytes)
        delta_bytes = {bytes(a) for ch in fresh for a in ch.actors}
        actors_changed = not delta_bytes.issubset(old_bytes_set)
        if actors_changed:
            all_bytes = sorted(old_bytes_set | delta_bytes)
            if len(all_bytes) >= (1 << ACTOR_BITS):
                obs.count("oplog.append_fallback", labels={"reason": "too_many_actors"})
                return None
        else:
            all_bytes = old_bytes
        rank_of = {b: i for i, b in enumerate(all_bytes)}
        if actors_changed:
            rank_map = np.fromiter(
                (rank_of[b] for b in old_bytes), np.int64, count=len(old_bytes)
            )

            def remap_packed(key):
                key = np.asarray(key, np.int64)
                idx = np.where(key > 0, key, 0) & ACTOR_MASK
                return np.where(
                    key > 0,
                    ((key >> ACTOR_BITS) << ACTOR_BITS) | rank_map[idx],
                    key,
                )
        else:
            def remap_packed(key):
                return np.asarray(key, np.int64)

        # -- extract ONLY the fresh changes -------------------------------
        with obs.span("device.extract", changes=len(fresh)):
            r = (self._extract_delta(fresh, rank_of) if fast
                 else _flatten(fresh, rank_of))
        k = len(r["id_key"])

        n = self.n
        old_id = remap_packed(self.id_key) if n else np.empty(0, np.int64)

        if k == 0:
            # dependency-only changes: commit bookkeeping, no rows
            self._commit_actors(all_bytes, actors_changed, remap_packed, old_id)
            self.changes.extend(fresh)
            known.update(batch_seen)
            return AppendInfo(n, 0, np.empty(0, np.int64), None, True,
                              np.empty(0, np.int64), None, actors_changed)

        order = np.argsort(r["id_key"], kind="stable")
        d_id = r["id_key"][order]
        if np.any(d_id[1:] == d_id[:-1]):
            obs.count("oplog.append_fallback", labels={"reason": "dup_op_id"})
            return None  # duplicate op ids within the delta
        pos = np.searchsorted(old_id, d_id)
        if n:
            posc = np.clip(pos, 0, n - 1)
            if np.any(old_id[posc] == d_id):
                obs.count("oplog.append_fallback", labels={"reason": "id_collision"})
                return None  # an op id the log already holds
        tail = n == 0 or pos[0] == n
        m = n + k
        # the offset-value-coded id join: the compressed id_key runs,
        # extended with the delta now, answer every reference join below
        # over R run heads and stride arithmetic instead of a searchsorted
        # over all N keys (compressed.StrideRuns.join)
        idruns = None
        if tail and not actors_changed and n and C.enabled():
            comp = self._comp
            if comp is None:
                comp = self._comp = C.CompressedOpColumns()
            comp._sync_col("id_key", "delta", self.id_key, n)
            idruns = comp.extend_id(d_id)
        new_rows = pos + np.arange(k, dtype=np.int64)
        if tail:
            row_map = None
        else:
            cnt = np.bincount(pos, minlength=n + 1)
            row_map = np.arange(n, dtype=np.int64) + np.cumsum(cnt[:n])
        if self._bufs is None:
            self._bufs = {}

        # -- string tables (old ids stable; new names appended) ------------
        props, d_prop = _merge_table(self.props, r["key_table"],
                                     r["prop_ids"], order)
        mark_names, d_mark = _merge_table(self.mark_names, r["mark_table"],
                                          r["mark_ids"], order)

        # -- splice the plain per-row columns ------------------------------
        sp = lambda name, old, new: self._splice_col(  # noqa: E731
            name, old, new, row_map, new_rows, tail, m
        )
        id_new = sp("id_key", old_id, d_id)
        obj_new = sp("obj_key", remap_packed(self.obj_key), r["obj"][order])
        ek_new = sp("elem_key", remap_packed(self.elem_key), r["elem"][order])
        action_new = sp("action", self.action, r["action"][order])
        prop_new = sp("prop", self.prop, d_prop)
        insert_new = sp("insert", np.asarray(self.insert, np.bool_),
                        r["insert"][order])
        vtag_new = sp("value_tag", self.value_tag, r["vtag"][order])
        vint_new = sp("value_int", self.value_int, r["value_int"][order])
        width_new = sp("width", self.width, r["width"][order])
        expand_new = sp("expand", np.asarray(self.expand, np.bool_),
                        r["expand"][order])
        mark_new = sp("mark_name_idx", self.mark_name_idx, d_mark)

        def rows_of(keys):
            if idruns is not None:
                obs.count("oplog.ovc_join", n=len(keys))
                return idruns.join(keys, ELEM_MISSING)
            return join_rows(id_new, keys, ELEM_MISSING)

        # -- element references --------------------------------------------
        old_er = self.elem_ref
        if not tail:
            old_er = np.where(
                old_er >= 0, row_map[np.clip(old_er, 0, max(n - 1, 0))], old_er
            )
        d_ek = r["elem"][order]
        d_er = np.where(
            d_ek == -1,
            np.int32(ELEM_MAP),
            np.where(d_ek == 0, np.int32(ELEM_HEAD), rows_of(d_ek)),
        ).astype(np.int32)
        er_new = sp("elem_ref", old_er.astype(np.int32, copy=False), d_er)
        # previously-MISSING refs may now resolve (their target arrived)
        rere_rows = np.empty(0, np.int64)
        n_miss_elem = 0
        miss = np.flatnonzero(er_new == ELEM_MISSING)
        if len(miss):
            res = rows_of(ek_new[miss])
            got = res != ELEM_MISSING
            n_miss_elem = int(len(miss) - np.count_nonzero(got))
            if np.any(got):
                er_new[miss[got]] = res[got]
                rere_rows = miss[got]

        # -- pred edges (appended at the end; order is irrelevant) ---------
        q = len(self.pred_src)
        old_ps = self.pred_src
        old_pt = self.pred_tgt
        if not tail and q:
            safe_n = max(n - 1, 0)
            old_ps = row_map[np.clip(old_ps, 0, safe_n)].astype(np.int32)
            old_pt = np.where(
                old_pt >= 0, row_map[np.clip(old_pt, 0, safe_n)], old_pt
            ).astype(np.int32)
        inv = np.empty(k, np.int64)
        inv[order] = np.arange(k)
        d_ps = new_rows[inv[r["pred_src"]]].astype(np.int32) \
            if len(r["pred_src"]) else np.empty(0, np.int32)
        d_pk = r["pred_key"]
        d_pt = rows_of(d_pk).astype(np.int32) if len(d_pk) \
            else np.empty(0, np.int32)
        d_pt = np.where(d_pt == ELEM_MISSING, np.int32(-1), d_pt)
        qm = q + len(d_ps)
        cat = lambda name, old, new: self._splice_col(  # noqa: E731
            name, np.asarray(old), new, None, None, True, qm
        )
        ps_new = cat("pred_src", old_ps, d_ps)
        pt_new = cat("pred_tgt", old_pt, d_pt)
        pk_new = cat("pred_key", remap_packed(self.pred_key), d_pk)
        # previously-unresolved pred targets may now resolve
        rere_pred = np.empty(0, np.int64)
        n_miss_pred = 0
        pmiss = np.flatnonzero(pt_new == -1)
        if len(pmiss):
            res = rows_of(pk_new[pmiss])
            got = res != ELEM_MISSING
            n_miss_pred = int(len(pmiss) - np.count_nonzero(got))
            if np.any(got):
                pt_new[pmiss[got]] = res[got]
                rere_pred = pmiss[got]

        # -- object table / dense ids --------------------------------------
        old_table = remap_packed(self.obj_table)
        make_new = d_id[np.isin(r["action"][order], MAKE_ACTIONS)]
        add = np.concatenate([make_new, r["obj"][order]])
        new_table = np.union1d(old_table, add)
        if len(new_table) == len(old_table):
            obj_remap = None
            od_old = self.obj_dense
        else:
            obj_remap = np.searchsorted(new_table, old_table).astype(np.int32)
            od_old = obj_remap[self.obj_dense]
        self.obj_table = new_table
        od_new = np.searchsorted(new_table, r["obj"][order]).astype(np.int32)
        od_all = sp("obj_dense", od_old.astype(np.int32, copy=False), od_new)

        # -- values heap ----------------------------------------------------
        values = self._splice_values(r["values"], order, row_map, new_rows,
                                     tail, m)

        # -- dirty objects (NEW dense numbering) ---------------------------
        parts = [od_new, np.searchsorted(new_table, make_new)]
        if len(rere_rows):
            parts.append(od_all[rere_rows])
        if len(rere_pred):
            src = ps_new[rere_pred]
            tgt = pt_new[rere_pred]
            parts.append(od_all[src])
            parts.append(od_all[np.clip(tgt, 0, m - 1)])
        if len(d_pt):
            hit = d_pt >= 0
            if np.any(hit):
                parts.append(od_all[d_pt[hit]])
        dirty = np.unique(np.concatenate(parts)).astype(np.int64)

        # -- commit ---------------------------------------------------------
        self.id_key = id_new
        self.obj_key = obj_new
        self.elem_key = ek_new
        self.action = action_new
        self.prop = prop_new
        self.insert = insert_new
        self.value_tag = vtag_new
        self.value_int = vint_new
        self.width = width_new
        self.expand = expand_new
        self.mark_name_idx = mark_new
        self.elem_ref = er_new
        self.obj_dense = od_all
        self.pred_src = ps_new
        self.pred_tgt = pt_new
        self.pred_key = pk_new
        self.values = values
        self.props = props
        self.mark_names = mark_names
        self.n = m
        self.n_objs = len(new_table)
        self.n_miss_elem = n_miss_elem
        self.n_miss_pred = n_miss_pred
        self.actors = [ActorId(b) for b in all_bytes]
        self._actor_order = None
        # the compressed image survives only a pure tail append: an actor
        # remap rewrites every packed key, a non-tail splice moves the
        # prefix, re-resolved MISSING references rewrite elem_ref /
        # pred_tgt rows; the next consumer encodes again
        if not tail or actors_changed or len(rere_rows) or len(rere_pred):
            self._comp = None
        self.changes.extend(fresh)
        known.update(batch_seen)
        obs.count("oplog.append_rows", n=k)
        obs.event(
            "oplog.append", rows=k, total=m, tail=int(tail),
            dirty_objs=len(dirty), actors_changed=int(actors_changed),
        )
        return AppendInfo(n, k, new_rows, row_map, tail, dirty, obj_remap,
                          actors_changed, n_pred_old=q,
                          rere_elem_rows=rere_rows, rere_pred_edges=rere_pred)

    def _extract_delta(self, fresh, rank_of) -> dict:
        """The fresh changes' columns in ``_flatten``'s shape, extracted
        natively from their column caches (``assemble.ranked_from_caches``);
        ``values`` is the lazy heap (code, off, len, raw). A counter past
        the packed ids' range raises, as in ``from_changes``."""
        from . import assemble as A

        if A.route(fresh) == A.ROUTE_OVERFLOW:
            raise A.AssembleError("counter outside packed range")
        r = A.ranked_from_caches(fresh, rank_of)
        a = r["a"]
        k = a["n"]
        return {
            "id_key": r["id_key"],
            "obj": r["obj"],
            "prop_ids": r["prop_ids"],
            "elem": r["elem"],
            "action": a["action"],
            "insert": a["insert"],
            "vtag": np.minimum(a["vcode"], TAG_UNKNOWN).astype(np.int32),
            "value_int": a["value_int"],
            "width": a["width"],
            "expand": a["expand"],
            "mark_ids": (a["mark_ids"] if a["mark_ids"] is not None
                         else np.full(k, -1, np.int32)),
            "pred_src": r["pred_src"],
            "pred_key": r["pred_key"],
            "values": (a["vcode"], a["voff"], a["vlen"], a["vraw"]),
            "key_table": a["key_table"],
            "mark_table": a["mark_table"],
        }

    def _splice_values(self, delta, order, row_map, new_rows, tail, m):
        """The values spliced like the columns. A lazy heap and a lazy
        delta ((code, off, len, raw)) splice as index columns plus an
        append-only raw heap; any other pair (the per-op oracle's lists)
        as an object list."""
        from .extract import LazyValues

        vals = self.values
        if isinstance(vals, LazyValues) and isinstance(delta, tuple):
            d_code, d_off, d_ln, d_raw = delta
            base = len(vals.raw)
            code = self._splice_col("vcode", vals.code, d_code[order],
                                    row_map, new_rows, tail, m)
            off = self._splice_col("voff", vals.off, d_off[order] + base,
                                   row_map, new_rows, tail, m)
            ln = self._splice_col("vlen", vals.ln, d_ln[order],
                                  row_map, new_rows, tail, m)
            # append-only raw heap: a bytearray grows geometrically, so a
            # delta stream costs O(delta) amortized instead of re-copying
            # the resident bytes each append (offsets of old rows never
            # move, so sharing the buffer with earlier LazyValues is safe)
            raw = vals.raw
            if not isinstance(raw, bytearray):
                raw = bytearray(raw)
            raw += d_raw
            return LazyValues(code, off, ln, raw, cap=vals.cap)
        if isinstance(delta, tuple):
            delta = LazyValues(*delta)
        k = len(order)
        new_vals = [delta[int(i)] for i in order]
        old = vals if isinstance(vals, list) else [vals[i] for i in range(len(vals))]
        if tail:
            return old + new_vals
        # fromiter keeps each ScalarValue, a tuple, one object
        arr = np.empty(m, object)
        arr[row_map] = np.fromiter(old, object, count=len(old))
        arr[new_rows] = np.fromiter(new_vals, object, count=k)
        return arr.tolist()

    def _commit_actors(self, all_bytes, actors_changed, remap_packed, old_id):
        if not actors_changed:
            return
        self.id_key = old_id
        self.obj_key = remap_packed(self.obj_key)
        self.elem_key = remap_packed(self.elem_key)
        self.pred_key = remap_packed(self.pred_key)
        self.obj_table = remap_packed(self.obj_table)
        self.actors = [ActorId(b) for b in all_bytes]
        self._actor_order = None  # every actor rank was remapped
        self._comp = None  # and every packed key
        # remapped arrays no longer alias the backing buffers
        self._bufs = {}


class AppendInfo:
    """What an in-place ``OpLog.append_changes`` did: everything a resident
    consumer (DeviceDoc) needs to splice its own row-indexed state.

    ``row_map`` maps old row index -> new row index (None = identity, the
    tail-append fast path); ``new_rows`` are the spliced rows' positions;
    ``dirty_objs`` are the dense object ids (NEW numbering) whose resolution
    is stale; ``obj_remap`` maps old dense ids -> new (None = identity)."""

    __slots__ = (
        "n_old", "n_new", "new_rows", "row_map", "tail", "dirty_objs",
        "obj_remap", "actors_changed", "n_pred_old",
        "rere_elem_rows", "rere_pred_edges",
    )

    def __init__(self, n_old, n_new, new_rows, row_map, tail, dirty_objs,
                 obj_remap, actors_changed, n_pred_old=0,
                 rere_elem_rows=None, rere_pred_edges=None):
        self.n_old = n_old
        self.n_new = n_new
        self.new_rows = new_rows
        self.row_map = row_map
        self.tail = tail
        self.dirty_objs = dirty_objs
        self.obj_remap = obj_remap
        self.actors_changed = actors_changed
        # edge bookkeeping for host-side delta resolution: edges before
        # index n_pred_old are carried; rere_* name previously-MISSING
        # references that resolved when their target arrived in this append
        self.n_pred_old = n_pred_old
        self.rere_elem_rows = (
            rere_elem_rows if rere_elem_rows is not None
            else np.empty(0, np.int64)
        )
        self.rere_pred_edges = (
            rere_pred_edges if rere_pred_edges is not None
            else np.empty(0, np.int64)
        )


def _merge_table(old: List[str], delta_table, ids, order) -> Tuple[List[str], np.ndarray]:
    """Union a delta's string table into the resident one (old ids stable,
    new names appended) and translate the delta's per-row ids."""
    merged = list(old)
    k = len(order)
    if not delta_table:
        return merged, np.full(k, -1, np.int32)
    pos_of = {s: i for i, s in enumerate(merged)}
    remap = np.empty(len(delta_table), np.int32)
    for j, s in enumerate(delta_table):
        gi = pos_of.get(s)
        if gi is None:
            gi = len(merged)
            merged.append(s)
            pos_of[s] = gi
        remap[j] = gi
    ids = np.asarray(ids)
    out = np.where(
        ids >= 0, remap[np.clip(ids, 0, len(delta_table) - 1)], np.int32(-1)
    ).astype(np.int32)
    return merged, out[order]


def _flatten(changes: Sequence[StoredChange], rank_of) -> dict:
    """The changes' ops as unsorted columns, in change order: packed
    ``id_key``/``obj`` (0 = root)/``elem`` (-1 = map op, 0 = HEAD) and
    ``pred_key`` per edge with its delta-local ``pred_src`` row; map keys
    and mark names as ids into the ``key_table``/``mark_table`` of first
    appearance; the ``values`` list."""
    prop_of: Dict[str, int] = {}
    mark_of: Dict[str, int] = {}
    id_key, obj, prop, elem = [], [], [], []
    action, insert, vtag, vint, width = [], [], [], [], []
    pred_src, pred_key = [], []
    expand, mark_idx = [], []
    values: List[ScalarValue] = []

    for ch in changes:
        ranks = [rank_of[bytes(a)] for a in ch.actors]
        author = ranks[0]
        for i, cop in enumerate(ch.ops):
            row = len(id_key)
            id_key.append(pack_id(ch.start_op + i, author))
            if cop.obj[0] == 0:
                obj.append(0)
            else:
                obj.append(pack_id(cop.obj[0], ranks[cop.obj[1]]))
            if cop.key.prop is not None:
                prop.append(prop_of.setdefault(cop.key.prop, len(prop_of)))
                elem.append(-1)
            else:
                e = cop.key.elem
                prop.append(-1)
                elem.append(0 if e[0] == 0 else pack_id(e[0], ranks[e[1]]))
            action.append(int(cop.action))
            insert.append(bool(cop.insert))
            v = cop.value
            vtag.append(_value_tag(v))
            vint.append(_int_payload(v))
            values.append(v)
            width.append(str_width(v.value) if v.tag == "str" else 1)
            for pc, pa in cop.pred:
                pred_src.append(row)
                pred_key.append(pack_id(pc, ranks[pa]))
            expand.append(bool(cop.expand))
            if cop.mark_name is not None:
                mark_idx.append(mark_of.setdefault(cop.mark_name, len(mark_of)))
            else:
                mark_idx.append(-1)

    return {
        "id_key": np.asarray(id_key, np.int64),
        "obj": np.asarray(obj, np.int64),
        "prop_ids": np.asarray(prop, np.int32),
        "elem": np.asarray(elem, np.int64),
        "action": np.asarray(action, np.int32),
        "insert": np.asarray(insert, np.bool_),
        "vtag": np.asarray(vtag, np.int32),
        "value_int": np.asarray(vint, np.int64),
        "width": np.asarray(width, np.int32),
        "expand": np.asarray(expand, np.bool_),
        "mark_ids": np.asarray(mark_idx, np.int32),
        "pred_src": np.asarray(pred_src, np.int64),
        "pred_key": np.asarray(pred_key, np.int64),
        "values": values,
        "key_table": list(prop_of),
        "mark_table": list(mark_of),
    }


def _value_tag(v: ScalarValue) -> int:
    if v.tag == "bool":
        return TAG_TRUE if v.value else TAG_FALSE
    return _TAG_FOR.get(v.tag, TAG_UNKNOWN)


def _int_payload(v: ScalarValue) -> int:
    if v.tag in ("int", "uint", "counter", "timestamp"):
        return int(v.value)
    if v.tag == "bool":
        return int(v.value)
    return 0


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _capacity(n: int, minimum: int = 16) -> int:
    """Bucket capacity: powers of two up to 8k, then multiples of 8k —
    snug enough that padded work stays within ~12% of the real row count
    (so above 8k a capacity is in general NOT a power of two)."""
    n = max(n, minimum)
    if n <= 8192:
        return _next_pow2(n)
    return ((n + 8191) // 8192) * 8192


def _pad(a: np.ndarray, size: int, fill) -> np.ndarray:
    if len(a) == size:
        return a
    out = np.full(size, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def pad_columns(cols, n_objs: int, min_capacity: int = 16):
    """Pad a columns() dict to bucket capacities (idempotent: already
    bucket-sized arrays pass through untouched). Padding rows are
    PAD_ACTION map ops of the one-past-last object; padding pred edges
    target -1 and are dropped by the kernels."""
    p = _capacity(len(cols["action"]), min_capacity)
    q = _capacity(len(cols["pred_src"]), min_capacity)
    fills = {
        "action": PAD_ACTION,
        "insert": False,
        "prop": -1,
        "elem_ref": ELEM_MAP,
        "obj_dense": np.int32(n_objs),
        "value_tag": TAG_NULL,
        "value_i32": 0,
        "width": 0,
        "covered": False,
        "pred_src": 0,
        "pred_tgt": -1,
        # actor-order slots: pad slots carry the out-of-range sentinel p
        # (the condensed linearization tests "slot < P" for validity)
        "aorder": p,
    }
    return {
        k: _pad(
            np.asarray(v),
            q if k.startswith("pred_") else p,
            fills.get(k, 0),
        )
        for k, v in cols.items()
    }


def host_forest(cols_np):
    """Sibling forest (is_elem, parent_row, first_child, next_sib) from
    numpy columns, on the host (``automerge_tpu/ops/oplog.py``
    ``host_forest``, :1217): the host mirror of the ``forest`` kernel.
    Children order is descending row (= descending Lamport,
    query/insert.rs), built with one lexsort."""
    action = np.asarray(cols_np["action"])
    P = len(action)
    insert = np.asarray(cols_np["insert"]).astype(bool) & (action != PAD_ACTION)
    elem_ref = np.asarray(cols_np["elem_ref"])
    obj_dense = np.asarray(cols_np["obj_dense"])
    N = 2 * P + 3
    S = N - 1
    parent_row = np.where(
        insert,
        np.where(
            elem_ref == ELEM_HEAD,
            P + obj_dense,
            np.where(elem_ref >= 0, elem_ref, S),
        ),
        S,
    ).astype(np.int32)
    er = np.flatnonzero(insert).astype(np.int32)
    order = np.lexsort((-er, parent_row[er]))
    sp = parent_row[er][order]
    sr = er[order]
    first_child = np.full(N, -1, np.int32)
    next_sib = np.full(N, -1, np.int32)
    if len(sr):
        first = np.concatenate([[True], sp[1:] != sp[:-1]])
        first_child[sp[first]] = sr[first]
        same = np.concatenate([sp[1:] == sp[:-1], [False]])
        nxt = np.concatenate([sr[1:], np.array([-1], np.int32)])
        next_sib[sr] = np.where(same, nxt, -1)
    return insert, parent_row, first_child, next_sib
