"""DeviceDoc: read API over a kernel-resolved op log, kept resident.

The batched alternative to a host op store for N-way merges: build an
OpLog from many replicas' changes, run ops/merge.py once on the card, then
answer reads from the resolved columns. Mirrors the current-state half of
the reference ReadDoc surface (reference: rust/automerge/src/read.rs:32-236)
as ``automerge_tpu.ops.device_doc.DeviceDoc`` serves it, and its serving
path: ``apply_changes`` / ``apply_batches`` splice new changes into the
resident log and re-resolve only what they touch, on the device the
document was resolved on; with ``enable_mesh``, a re-resolve of the whole
log runs as the sharded merge over a mesh of shards instead
(``parallel/sharding.py``). Historical views and patches are not part of
this package.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from ..storage.change import StoredChange, parse_change
from ..types import (
    ACTOR_BITS, Action, ObjType, is_make_action, objtype_for_action,
)
from .merge import merge_columns, prepare_resolution
from .oplog import (
    ELEM_HEAD, ELEM_MISSING, MAKE_ACTIONS, OpLog, TAG_COUNTER, _capacity,
    pad_columns,
)

_OBJ_REPLACEMENT = "￼"
# Above this share of the log's rows in the dirty objects, a re-resolve
# runs over the whole log instead of the subset (the bookkeeping no longer
# pays).
DIRTY_FRACTION_LIMIT = 0.5
# Below this many rows a full re-resolve stays on the document's device
# even with a mesh enabled.
MESH_MIN_ROWS = 4096


def _parsed(changes) -> List[StoredChange]:
    return [c if isinstance(c, StoredChange) else parse_change(c)[0]
            for c in changes]


def order_elem_rows(log: OpLog, elem_index: np.ndarray,
                    obj_rows: np.ndarray) -> np.ndarray:
    """Element rows of one sequence object in DOCUMENT order: the insert
    rows the linearization ranked, sorted by their rank."""
    obj_rows = np.asarray(obj_rows, np.int64)
    erows = obj_rows[
        np.asarray(log.insert)[obj_rows] & (elem_index[obj_rows] >= 0)
    ]
    return erows[np.argsort(elem_index[erows], kind="stable")]


def _resolve_log(log: OpLog, device, phases=None, staging="run_native",
                 transport="dict") -> Dict[str, np.ndarray]:
    """The read outputs of one merge of the whole log on ``device``."""
    return merge_columns(
        log.columns(), fetch=DeviceDoc.READ_FETCH, n_objs=log.n_objs,
        n_props=len(log.props), device=device, phases=phases,
        staging=staging, transport=transport,
    )


@contextlib.contextmanager
def _stage(phases, name: str):
    """Adds the wall seconds of the block to ``phases[name]`` (a dict, or
    None for no timing). The device is not synchronised for it."""
    if phases is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0


class DeviceDoc:
    # the outputs the read API consumes; everything else stays on device
    READ_FETCH = (
        "visible", "winner", "conflicts", "elem_index",
        "obj_vis_len", "obj_text_width",
    )

    def __init__(self, log: OpLog, res: Dict[str, np.ndarray], device=None,
                 staging: str = "run_native"):
        self.log = log
        self.res = res
        # every re-resolve of this document runs where it was resolved,
        # its columns staged as they were (ops/merge.py prepare_resolution)
        self.device = resolve_device(device)
        self.staging = staging
        # mesh residency (enable_mesh): off until asked for
        self._mesh = None
        self._mesh_min_rows = MESH_MIN_ROWS
        n = log.n
        self.visible = res["visible"][:n]
        self.winner = res["winner"][:n]
        self.conflicts = res["conflicts"][:n]
        self.elem_index = res["elem_index"][:n]
        # object id -> object type, from make ops (+ root)
        self._obj_type: Dict[int, ObjType] = {0: ObjType.MAP}
        for r in np.flatnonzero(np.isin(log.action[:n], MAKE_ACTIONS)):
            self._obj_type[int(log.id_key[r])] = objtype_for_action(int(log.action[r]))
        # row ranges by object
        order = np.argsort(log.obj_key[:n], kind="stable")
        self._rows_by_obj = order.astype(np.int64)
        self._obj_sorted = log.obj_key[:n][order]
        self._all_elems_cache: Dict[int, List[int]] = {}
        self._hash_index = {ch.hash: ch for ch in log.changes}
        self._rank_of = {a.bytes: i for i, a in enumerate(log.actors)}
        self._pending: Dict[bytes, StoredChange] = {}
        self._res_bufs: Dict[str, np.ndarray] = {}
        # successor bookkeeping, maintained incrementally across appends
        # (the host mirror of the succ_vis kernel's counts): what lets the
        # tail delta recompute visibility without a kernel pass
        self.succ_count = np.zeros(n, np.int32)
        self.inc_count = np.zeros(n, np.int32)
        if len(log.pred_src):
            tgt = np.asarray(log.pred_tgt)
            src = np.asarray(log.pred_src)
            hit = tgt >= 0
            is_inc = np.asarray(log.action)[src] == Action.INCREMENT
            np.add.at(self.succ_count, tgt[hit & ~is_inc], 1)
            np.add.at(self.inc_count, tgt[hit & is_inc], 1)
        self._recompute_counters()

    def _recompute_counters(self) -> None:
        # exact int64 counter totals, host-side (the kernels keep int32
        # counters that wrap; reference counters are i64, value.rs:369)
        log = self.log
        self.counter_val = np.asarray(log.value_int).copy()
        if len(log.pred_src):
            mask = (log.action[log.pred_src] == Action.INCREMENT) & (log.pred_tgt >= 0)
            np.add.at(
                self.counter_val,
                log.pred_tgt[mask],
                log.value_int[log.pred_src[mask]],
            )

    # -- construction -------------------------------------------------------

    @classmethod
    def merge(cls, changes: Sequence, device=None, phases=None,
              staging: str = "run_native", transport: str = "dict") -> "DeviceDoc":
        """N-way fan-in merge of replicas' changes: change chunks (bytes)
        or parsed ``StoredChange``s, in any order, duplicates allowed.
        ``phases`` (a dict) collects the seconds of each phase.
        ``staging`` (kept for every later re-resolve) and ``transport``
        (this resolve only) are ``merge_columns``'."""
        t0 = time.perf_counter()
        parsed = _parsed(changes)
        if phases is not None:
            phases["parse"] = time.perf_counter() - t0
        return cls.from_changes(parsed, device=device, phases=phases,
                                staging=staging, transport=transport)

    @classmethod
    def from_changes(cls, changes: Sequence[StoredChange], device=None,
                     phases=None, staging: str = "run_native",
                     transport: str = "dict") -> "DeviceDoc":
        t0 = time.perf_counter()
        log = OpLog.from_changes(changes)
        if phases is not None:
            phases["oplog"] = time.perf_counter() - t0
        return cls.resolve(log, device=device, phases=phases, staging=staging,
                           transport=transport)

    @classmethod
    def resolve(cls, log: OpLog, device=None, phases=None,
                staging: str = "run_native", transport: str = "dict") -> "DeviceDoc":
        dev = resolve_device(device)
        return cls(log, _resolve_log(log, dev, phases, staging, transport), dev,
                   staging)

    # -- incremental updates ------------------------------------------------
    #
    # The serving path: new changes (from sync or local commits) are
    # spliced into the resident OpLog (``OpLog.append_changes``), and only
    # the objects the delta touches are re-resolved: a tail append on the
    # host (``_delta_resolve``), anything else by a kernel run over the
    # dirty objects' rows, or over the whole log once those rows pass
    # DIRTY_FRACTION_LIMIT. Still no re-extraction: the columns are
    # resident.

    def apply_changes(self, changes: Sequence, *, incremental: bool = True) -> int:
        """Integrate new changes (chunks or ``StoredChange``s) into this
        resident document; returns the number integrated this call.

        Changes whose dependencies are not yet present are buffered and
        integrated when the gap fills (``pending_changes``). Duplicate
        (re-delivered) changes are no-ops. ``incremental=False`` rebuilds
        the log from all its changes instead of splicing."""
        ready = self._take_ready(_parsed(changes))
        if not ready:
            return 0
        # an empty resident log has no actor table to splice into: the
        # rebuild IS the initial build
        info = self.log.append_changes(ready) if incremental and self.log.n else None
        if info is None:
            self._rebuild(list(self.log.changes) + ready)
            return len(ready)
        self._apply_append(info, ready)
        if info.n_new and not self._delta_resolve(info):
            self._reresolve(info.dirty_objs)
        return len(ready)

    def apply_batches(self, batches: Sequence[Sequence], phases=None) -> int:
        """``apply_changes`` over a stream of batches. On the card, batch
        k+1's host splice overlaps batch k's kernels: each batch's subset
        resolution is launched without a sync and read back only after
        the next batch has been spliced and launched. On the CPU the
        batches apply one after another.

        ``phases``, a dict when given, collects the wall seconds of each
        batch's step as a list under ``"batches"`` (on the card: its
        splice and launch and the readback of the batch before it; the
        last step includes its own readback) and, on the card, the
        seconds of each stage of the steps summed over the batches. The
        device is not synchronised for it: a stage that waits for the
        card holds the wait."""
        if phases is not None:
            phases.setdefault("batches", [])
        if self.device.type != "cpu":
            return self._apply_pipelined(batches, phases)
        total = 0
        for chs in batches:
            t0 = time.perf_counter()
            total += self.apply_changes(chs)
            if phases is not None:
                phases["batches"].append(time.perf_counter() - t0)
        return total

    def _apply_pipelined(self, batches: Sequence[Sequence], phases=None) -> int:
        """``apply_batches`` for a document on the card: at most one subset
        resolution in flight while the next batch is spliced. On a CPU
        document, which ``apply_batches`` applies batch by batch instead,
        the same steps run synchronously on the plain versions."""
        total = 0
        inflight = None
        for chs in batches:
            t0 = time.perf_counter()
            applied, inflight = self._pipeline_step(chs, inflight, phases)
            total += applied
            if phases is not None:
                phases.setdefault("batches", []).append(time.perf_counter() - t0)
        if inflight is not None:
            t0 = time.perf_counter()
            self._collect_async(inflight, phases)
            if phases and phases["batches"]:
                phases["batches"][-1] += time.perf_counter() - t0
        return total

    def _pipeline_step(self, chs: Sequence, inflight, phases=None):
        """One batch of the card's pipeline: splice it, launch its subset
        resolution, then read back the one launched before (``inflight``).
        Returns (changes applied, the handle now in flight). ``phases``, a
        dict when given, sums the seconds of each stage."""
        with _stage(phases, "parse"):
            parsed = _parsed(chs)
        with _stage(phases, "order"):
            ready = self._take_ready(parsed)
        if not ready:
            return 0, inflight
        with _stage(phases, "splice"):
            info = self.log.append_changes(ready) if self.log.n else None
        if info is None:
            if inflight is not None:
                self._collect_async(inflight, phases)
            with _stage(phases, "rebuild"):
                self._rebuild(list(self.log.changes) + ready)
            return len(ready), None
        if inflight is not None:
            # the in-flight handle's row/object ids move with the splice
            if info.row_map is not None:
                inflight["rows"] = info.row_map[inflight["rows"]]
            if info.obj_remap is not None:
                inflight["dirty"] = info.obj_remap[inflight["dirty"]]
        with _stage(phases, "materialize"):
            self._apply_append(info, ready)
        if info.n_new:
            handle = self._dispatch_async(info.dirty_objs, phases)
            if handle is not None and handle.get("fallback"):
                # the full re-resolve reads the CURRENT log: anything in
                # flight was computed from an older one and must land first
                if inflight is not None:
                    self._collect_async(inflight, phases)
                    inflight = None
                with _stage(phases, "full"):
                    self._reresolve(info.dirty_objs)
            else:
                if inflight is not None:
                    self._collect_async(inflight, phases)
                inflight = handle
        return len(ready), inflight

    def pending_changes(self) -> int:
        """Changes buffered awaiting missing dependencies."""
        return len(self._pending)

    def _take_ready(self, changes: Sequence) -> list:
        """Dedup + causal-order the incoming batch against what the log
        already holds; buffer changes with missing deps."""
        self._dedup_into_pending(changes)
        return self._drain_ready_pending()

    def _dedup_into_pending(self, changes: Sequence) -> None:
        have = self._hash_index
        pend = self._pending
        for ch in changes:
            h = ch.hash
            if h is None or h in have or h in pend:
                continue
            pend[h] = ch

    def _drain_ready_pending(self) -> list:
        have = self._hash_index
        pend = self._pending
        ready: list = []
        ready_set: set = set()
        progress = True
        while progress and pend:
            progress = False
            for h in list(pend):
                ch = pend[h]
                if all(d in have or d in ready_set for d in ch.dependencies):
                    ready.append(ch)
                    ready_set.add(h)
                    del pend[h]
                    progress = True
        return ready

    def _rebuild(self, changes: list) -> None:
        """Full fallback: re-extract and re-resolve everything in place."""
        pend = self._pending
        mesh = self._mesh, self._mesh_min_rows
        log = OpLog.from_changes(changes)
        self.__init__(log, _resolve_log(log, self.device, staging=self.staging),
                      self.device, self.staging)
        self._pending = pend
        self._mesh, self._mesh_min_rows = mesh

    def _apply_append(self, info, ready: Sequence) -> None:
        """Splice the resolution arrays and host caches through an
        AppendInfo (positions move; values of clean objects are reused)."""
        log = self.log
        m = log.n
        n_old, rm = info.n_old, info.row_map
        for ch in ready:
            self._hash_index[ch.hash] = ch
        if info.actors_changed:
            # the log's packed ids were rank-remapped in place; every host
            # cache keyed by a packed id must follow the same monotone map
            new_rank = {a.bytes: i for i, a in enumerate(log.actors)}
            remap = {old: new_rank[b] for b, old in self._rank_of.items()}
            mask = (1 << ACTOR_BITS) - 1
            self._obj_type = {
                (k if k == 0
                 else ((k >> ACTOR_BITS) << ACTOR_BITS) | remap[k & mask]): v
                for k, v in self._obj_type.items()
            }
            self._rank_of = new_rank
        if info.n_new == 0:
            if info.actors_changed:
                self._all_elems_cache.clear()
            return
        nr = np.asarray(info.new_rows, np.int64)
        mk = nr[np.isin(np.asarray(log.action)[nr], MAKE_ACTIONS)]
        for r in mk:
            self._obj_type[int(log.id_key[r])] = objtype_for_action(int(log.action[r]))

        # resolution arrays: old values carried, positions remapped; the
        # new rows' objects are all dirty and re-resolved next.
        # Capacity-bucketed buffers make the tail append O(delta): only the
        # k new slots are written.
        win_old = self.winner
        if rm is not None:
            safe = max(n_old - 1, 0)
            win_old = np.where(
                self.winner >= 0, rm[np.clip(self.winner, 0, safe)], -1
            ).astype(np.int32)
        vis = self._res_splice("visible", np.asarray(self.visible, np.bool_),
                               m, rm, n_old, False)
        win = self._res_splice("winner", np.asarray(win_old, np.int32),
                               m, rm, n_old, -1)
        con = self._res_splice("conflicts", np.asarray(self.conflicts, np.int32),
                               m, rm, n_old, 0)
        ei = self._res_splice("elem_index", np.asarray(self.elem_index, np.int32),
                              m, rm, n_old, -1)
        orm = info.obj_remap
        n_objs_old = len(orm) if orm is not None else log.n_objs
        ovl = np.zeros(log.n_objs + 2, np.int32)
        otw = np.zeros(log.n_objs + 2, np.int32)
        old_ovl = np.asarray(self.res["obj_vis_len"])
        old_otw = np.asarray(self.res["obj_text_width"])
        take = min(n_objs_old, len(old_ovl))
        if orm is None:
            ovl[:take] = old_ovl[:take]
            otw[:take] = old_otw[:take]
        else:
            ovl[orm[:take]] = old_ovl[:take]
            otw[orm[:take]] = old_otw[:take]
        self.res = {
            "visible": vis, "winner": win, "conflicts": con,
            "elem_index": ei, "obj_vis_len": ovl, "obj_text_width": otw,
        }
        self.visible = vis
        self.winner = win
        self.conflicts = con
        self.elem_index = ei

        # successor bookkeeping and exact counter totals ride the same
        # splice, then absorb the delta's edges (kept fresh whichever
        # resolution path runs)
        self.succ_count = self._res_splice("succ_count", self.succ_count,
                                           m, rm, n_old, 0)
        self.inc_count = self._res_splice("inc_count", self.inc_count,
                                          m, rm, n_old, 0)
        value_int = np.asarray(log.value_int)
        cv = self._res_splice("counter_val", self.counter_val, m, rm, n_old, 0)
        cv[nr] = value_int[nr]
        self.counter_val = cv
        ps = np.asarray(log.pred_src)
        pt = np.asarray(log.pred_tgt)
        eidx = np.concatenate([
            np.arange(info.n_pred_old, len(ps), dtype=np.int64),
            np.asarray(info.rere_pred_edges, np.int64),
        ])
        if len(eidx):
            src = ps[eidx]
            tgt = pt[eidx]
            ok = tgt >= 0
            src, tgt = src[ok], tgt[ok]
            is_inc = np.asarray(log.action)[src] == Action.INCREMENT
            np.add.at(self.succ_count, tgt[~is_inc], 1)
            np.add.at(self.inc_count, tgt[is_inc], 1)
            np.add.at(self.counter_val, tgt[is_inc], value_int[src[is_inc]])

        # object-sorted row index: merge the (already sorted) old order
        # with the delta's rows, no full argsort
        old_rbo = self._rows_by_obj
        if rm is not None:
            old_rbo = rm[old_rbo]
        obj_key = np.asarray(log.obj_key)
        old_keys = obj_key[old_rbo]
        d_keys = obj_key[nr]
        ordx = np.lexsort((nr, d_keys))
        d_rows = nr[ordx]
        d_keys = d_keys[ordx]
        pos = np.searchsorted(old_keys, d_keys, side="right")
        cnt = np.bincount(pos, minlength=n_old + 1)
        rbo = np.empty(m, np.int64)
        keys = np.empty(m, np.int64)
        old_pos = np.arange(n_old, dtype=np.int64) + np.cumsum(cnt[:n_old])
        rbo[old_pos] = old_rbo
        keys[old_pos] = old_keys
        new_pos = pos + np.arange(len(d_rows), dtype=np.int64)
        rbo[new_pos] = d_rows
        keys[new_pos] = d_keys
        self._rows_by_obj = rbo
        self._obj_sorted = keys

        if info.tail and not info.actors_changed:
            for d in np.asarray(info.dirty_objs):
                self._all_elems_cache.pop(int(log.obj_table[d]), None)
        else:
            self._all_elems_cache.clear()

    # host delta resolution ---------------------------------------------------
    #
    # The O(delta) path: visibility/winners recomputed ONLY for the key
    # groups the delta touches (from the incrementally maintained succ/inc
    # counts), and document order spliced by anchor arithmetic: valid
    # because a tail append's ids exceed every resident id, so each new
    # element is its anchor's FIRST child (descending-Lamport sibling
    # order) and a new subtree lands immediately after its anchor. Returns
    # False, for the kernels' object-granularity re-resolve, when its
    # assumptions do not hold (non-tail splice, re-resolved refs, unranked
    # anchors).

    def _delta_resolve(self, info) -> bool:
        log = self.log
        m = log.n
        if not info.tail or len(info.rere_elem_rows):
            return False
        nr = np.asarray(info.new_rows, np.int64)
        action = np.asarray(log.action)
        insert = np.asarray(log.insert, np.bool_)
        er = np.asarray(log.elem_ref)
        prop = np.asarray(log.prop)
        od = np.asarray(log.obj_dense)

        ni = nr[insert[nr]]
        anch = er[ni]
        if len(ni) and np.any(anch == ELEM_MISSING):
            return False  # unresolved anchor: cannot place incrementally
        old_anchor = anch[(anch >= 0) & (anch < info.n_old)]
        if len(old_anchor) and np.any(self.elem_index[old_anchor] < 0):
            return False  # anchor itself unranked

        # touched rows: the delta's own + targets of its (re)resolved edges
        ps = np.asarray(log.pred_src)
        pt = np.asarray(log.pred_tgt)
        eidx = np.concatenate([
            np.arange(info.n_pred_old, len(ps), dtype=np.int64),
            np.asarray(info.rere_pred_edges, np.int64),
        ])
        touched = pt[eidx][pt[eidx] >= 0] if len(eidx) else np.empty(0, np.int64)
        cand = np.unique(np.concatenate([nr, touched])).astype(np.int64)
        c_map = prop[cand] >= 0
        c_seq = cand[~c_map]
        if len(c_seq) and np.any(~insert[c_seq] & (er[c_seq] < 0)):
            return False  # sentinel-keyed update groups: let the kernel decide

        # group membership (two vectorized passes over the columns)
        heads = np.unique(np.where(insert[c_seq], c_seq, er[c_seq]))
        member = np.zeros(m, np.bool_)
        if len(heads):
            head_mask = np.zeros(m, np.bool_)
            head_mask[heads] = True
            member |= head_mask
            member |= (~insert) & (er >= 0) & head_mask[np.clip(er, 0, m - 1)]
        n_props = max(len(log.props), 1)
        if np.any(c_map):
            mkeys = np.unique(
                od[cand[c_map]].astype(np.int64) * n_props + prop[cand[c_map]]
            )
            gid_all = od.astype(np.int64) * n_props + prop
            pos = np.searchsorted(mkeys, gid_all)
            posc = np.clip(pos, 0, len(mkeys) - 1)
            member |= (prop >= 0) & (mkeys[posc] == gid_all)
        rows = np.flatnonzero(member)

        # visibility over the affected rows (the succ_vis rule; the
        # current state covers every op)
        vt = np.asarray(log.value_tag)
        act = action[rows]
        never = ((act == Action.DELETE) | (act == Action.INCREMENT)
                 | (act == Action.MARK))
        is_counter = (act == Action.PUT) & (vt[rows] == TAG_COUNTER)
        sc = self.succ_count[rows]
        ic = self.inc_count[rows]
        vis = ~never & np.where(is_counter, sc == 0, (sc + ic) == 0)
        self.visible[rows] = vis

        # winners/conflicts per affected group (rows ascend = Lamport)
        gkey = np.where(
            prop[rows] >= 0,
            np.int64(m) + od[rows].astype(np.int64) * n_props + prop[rows],
            np.where(insert[rows], rows, er[rows].astype(np.int64)),
        )
        order = np.argsort(gkey, kind="stable")
        gs = gkey[order]
        vs = vis[order]
        rr = rows[order]
        newseg = np.concatenate([[True], gs[1:] != gs[:-1]])
        seg = np.cumsum(newseg) - 1
        nseg = int(seg[-1]) + 1 if len(seg) else 0
        win = np.full(nseg, -1, np.int64)
        np.maximum.at(win, seg, np.where(vs, rr, -1))
        cnt = np.zeros(nseg, np.int64)
        np.add.at(cnt, seg, vs.astype(np.int64))

        # per-object stats adjust by the member elements' before/after
        # contributions: winners only ever change inside member groups
        el_rows = rr[insert[rr]]
        w = np.asarray(log.width)
        wold = self.winner[el_rows]
        old_len = wold >= 0
        old_w = np.where(old_len, w[np.clip(wold, 0, m - 1)], 0)

        self.winner[rr] = win[seg]
        self.conflicts[rr] = cnt[seg]

        wnew = self.winner[el_rows]
        new_len = wnew >= 0
        new_w = np.where(new_len, w[np.clip(wnew, 0, m - 1)], 0)
        o = od[el_rows]
        np.add.at(self.res["obj_vis_len"], o,
                  new_len.astype(np.int32) - old_len.astype(np.int32))
        np.add.at(self.res["obj_text_width"], o, (new_w - old_w).astype(np.int32))

        # document order: splice the new subtrees in by anchor position
        if len(ni):
            self._splice_elem_order(ni)
        return True

    def _splice_elem_order(self, ni: np.ndarray) -> None:
        """elem_index update for a tail append's new insert rows: new
        elements form subtrees hanging off old anchors (or object HEADs);
        each subtree's preorder lands immediately after its anchor, and
        older elements shift by the block sizes inserted before them."""
        log = self.log
        er = np.asarray(log.elem_ref)
        od = np.asarray(log.obj_dense)
        insert = np.asarray(log.insert, np.bool_)
        ei = self.elem_index

        ni_l = ni.tolist()
        er_l = er[ni].tolist()
        od_l = od[ni].tolist()
        loc = {r: j for j, r in enumerate(ni_l)}
        kids: Dict[int, list] = {}
        roots: Dict[tuple, list] = {}  # (obj dense, anchor row | -1=HEAD) -> locals
        for j in range(len(ni_l) - 1, -1, -1):  # descending id = sibling order
            a = er_l[j]
            pj = loc.get(a)
            if pj is not None:
                kids.setdefault(pj, []).append(j)
            elif a == ELEM_HEAD or a >= 0:
                roots.setdefault((od_l[j], a if a >= 0 else -1), []).append(j)
        # per-object anchor blocks in subtree preorder
        by_obj: Dict[int, list] = {}  # obj -> [(anchor_pos, [rows...])]
        for (o, a), starts in roots.items():
            block: list = []
            stack = list(reversed(starts))
            while stack:
                j = stack.pop()
                block.append(ni_l[j])
                stack.extend(reversed(kids.get(j, ())))
            p_a = -1 if a < 0 else int(ei[a])
            by_obj.setdefault(o, []).append((p_a, block))
        for o, blocks in by_obj.items():
            blocks.sort()
            pa = np.asarray([p for p, _ in blocks], np.int64)
            sizes = np.asarray([len(b) for _, b in blocks], np.int64)
            cum = np.concatenate([[0], np.cumsum(sizes)])
            # older elements of this object shift by the blocks before them
            orows = self._obj_rows(int(log.obj_table[o]))
            # the delta's own rows still carry elem_index -1, so the >= 0
            # filter leaves exactly the resident elements
            old_el = orows[insert[orows] & (ei[orows] >= 0)]
            if len(old_el):
                shift = cum[np.searchsorted(pa, ei[old_el], side="left")]
                ei[old_el] += shift.astype(ei.dtype)
            for bi, (p_a, block) in enumerate(blocks):
                start = p_a + cum[bi] + 1
                ei[np.asarray(block, np.int64)] = (
                    start + np.arange(len(block))
                ).astype(ei.dtype)

    # dirty-set re-resolution ------------------------------------------------

    def _subset_rows(self, dirty: np.ndarray) -> np.ndarray:
        if len(dirty) == 1:
            # one dirty object, the dominant serve-delta shape: its rows
            # are one contiguous slice of the object-sorted index; the
            # stable sort keeps the ascending (= Lamport) contract the
            # subset kernel relies on
            key = int(self.log.obj_table[int(dirty[0])])
            lo = np.searchsorted(self._obj_sorted, key, side="left")
            hi = np.searchsorted(self._obj_sorted, key, side="right")
            return np.sort(self._rows_by_obj[lo:hi], kind="stable")
        od = np.asarray(self.log.obj_dense)
        idx = np.searchsorted(dirty, od)
        member = (idx < len(dirty)) & (
            dirty[np.clip(idx, 0, len(dirty) - 1)] == od
        )
        return np.flatnonzero(member)

    def _subset_cols(self, rows: np.ndarray, dirty: np.ndarray):
        """Column dict over the dirty objects' rows only, with references
        renumbered subset-locally (rows stay ascending = Lamport order)."""
        log = self.log
        m = log.n
        S = len(rows)
        full2sub = np.full(m, -1, np.int32)
        full2sub[rows] = np.arange(S, dtype=np.int32)
        er = np.asarray(log.elem_ref)[rows]
        er_sub = np.where(
            er >= 0, full2sub[np.clip(er, 0, m - 1)], er
        ).astype(np.int32)
        # a ref outside the subset would mean a cross-object element ref
        # (malformed); degrade it to MISSING rather than mis-index
        er_sub = np.where((er >= 0) & (er_sub < 0), np.int32(ELEM_MISSING), er_sub)
        ps = np.asarray(log.pred_src)
        pt = np.asarray(log.pred_tgt)
        if len(ps):
            src_sub = full2sub[np.clip(ps, 0, m - 1)]
            emask = src_sub >= 0
            tgt = pt[emask]
            tgt_sub = np.where(
                tgt >= 0, full2sub[np.clip(tgt, 0, m - 1)], -1
            ).astype(np.int32)
            sub_ps = src_sub[emask].astype(np.int32)
        else:
            sub_ps = np.empty(0, np.int32)
            tgt_sub = np.empty(0, np.int32)
        return {
            "action": np.asarray(log.action)[rows],
            "insert": np.asarray(log.insert, np.bool_)[rows],
            "prop": np.asarray(log.prop)[rows],
            "elem_ref": er_sub,
            "obj_dense": np.searchsorted(
                dirty, np.asarray(log.obj_dense)[rows]).astype(np.int32),
            "value_tag": np.asarray(log.value_tag)[rows],
            "value_i32": np.asarray(log.value_int)[rows].astype(np.int32),
            "width": np.asarray(log.width)[rows],
            "covered": np.ones(S, np.bool_),
            "pred_src": sub_ps,
            "pred_tgt": tgt_sub,
        }

    def _scatter_subset(self, rows, dirty, res_sub) -> None:
        S = len(rows)
        D = len(dirty)
        self.visible[rows] = np.asarray(res_sub["visible"])[:S]
        w = np.asarray(res_sub["winner"])[:S]
        self.winner[rows] = np.where(
            w >= 0, rows[np.clip(w, 0, max(S - 1, 0))], -1
        ).astype(np.int32)
        self.conflicts[rows] = np.asarray(res_sub["conflicts"])[:S]
        self.elem_index[rows] = np.asarray(res_sub["elem_index"])[:S]
        self.res["obj_vis_len"][dirty] = np.asarray(res_sub["obj_vis_len"])[:D]
        self.res["obj_text_width"][dirty] = np.asarray(res_sub["obj_text_width"])[:D]

    def _res_splice(self, name, old, m, rm, n_old, fill):
        """Splice one per-row resolution array through a capacity-bucketed
        backing buffer (tail appends write only the new slots)."""
        buf = self._res_bufs.get(name)
        if rm is None and buf is not None and old.base is buf and len(buf) >= m:
            buf[n_old:m] = fill
            return buf[:m]
        nbuf = np.empty(_capacity(m), old.dtype)
        out = nbuf[:m]
        if rm is None:
            out[:n_old] = old
            out[n_old:] = fill
        else:
            out[:] = fill
            out[rm] = old
        self._res_bufs[name] = nbuf
        return out

    def _reresolve(self, dirty) -> None:
        log = self.log
        m = log.n
        dirty = np.asarray(dirty, np.int64)
        if m == 0 or not len(dirty):
            return
        rows = self._subset_rows(dirty)
        if len(rows) / m > DIRTY_FRACTION_LIMIT or len(dirty) >= log.n_objs:
            # re-resolving everything is cheaper than the bookkeeping
            res = self._mesh_resolve()
            if res is None:
                res = _resolve_log(log, self.device, staging=self.staging)
            for k in ("visible", "winner", "conflicts", "elem_index"):
                self.res[k][:] = np.asarray(res[k])[:m]
            for k in ("obj_vis_len", "obj_text_width"):
                v = np.asarray(res[k])
                take = min(len(v), len(self.res[k]))
                self.res[k][:take] = v[:take]
            return
        res_sub = merge_columns(
            self._subset_cols(rows, dirty), fetch=self.READ_FETCH,
            n_objs=len(dirty), n_props=len(log.props), device=self.device,
            staging=self.staging,
        )
        self._scatter_subset(rows, dirty, res_sub)

    # -- mesh residency -------------------------------------------------------
    #
    # A document too large for one device's re-resolve can route its full
    # re-resolutions through the sharded merge
    # (``automerge_tpu/ops/device_doc.py:1039-1179``). The columns go over
    # in row order, unpermuted: the sharded merge's group tables span the
    # whole log and are combined by pmax/psum, so a shard's row slice need
    # not hold whole objects (ROADMAP §3 says why the reference's
    # object-contiguous permutation has no counterpart here).

    def enable_mesh(self, n_devices=None, devices=None,
                    min_rows: int = MESH_MIN_ROWS):
        """Route this document's full re-resolutions through the sharded
        merge over ``default_mesh(n_devices, devices)`` (the CUDA cards
        unless ``devices`` names others, e.g. ``["cuda:0"] * 4``).
        Logs under ``min_rows`` rows stay on the document's device.
        Raises when the cards are fewer than asked for or the mesh has one
        shard. Returns the mesh."""
        from ..parallel import default_mesh

        mesh = default_mesh(n_devices, devices)
        if mesh.size < 2:
            raise ValueError(f"enable_mesh needs two shards or more, got {mesh.size}")
        self._mesh = mesh
        self._mesh_min_rows = int(min_rows)
        return mesh

    def disable_mesh(self) -> None:
        self._mesh = None

    def _mesh_resolve(self):
        """One sharded resolution of the whole log over the mesh, or None
        when mesh residency is off or the log is under ``min_rows``."""
        if self._mesh is None or self.log.n < self._mesh_min_rows:
            return None
        return self._mesh_resolve_inner()

    def _mesh_resolve_inner(self) -> Dict[str, np.ndarray]:
        from ..parallel import sharded_merge_columns

        log = self.log
        return sharded_merge_columns(
            pad_columns(log.columns(), log.n_objs), mesh=self._mesh,
            n_objs=log.n_objs, n_props=len(log.props))

    # staged async subset resolution (apply_batches) --------------------------

    def _dispatch_async(self, dirty, phases=None):
        """Launch one dirty-set resolution on the card WITHOUT reading back:
        the columns are staged as the document's ``staging`` says (by
        default run tables, decoded by ``expand_runs`` on the card), and
        the h2d copies and the kernels (document order included: the
        ``linearize`` kernel) are queued on the current stream. Returns a
        handle for ``_collect_async``, None when there is nothing to
        resolve, or ``{"fallback": True}`` when the dirty fraction demands
        a synchronous full re-resolve (which the caller runs AFTER
        draining any in-flight batch)."""
        log = self.log
        dirty = np.asarray(dirty, np.int64)
        if log.n == 0 or not len(dirty):
            return None
        with _stage(phases, "subset"):
            rows = self._subset_rows(dirty)
        if len(rows) / log.n > DIRTY_FRACTION_LIMIT:
            return {"fallback": True}
        D = len(dirty)
        with _stage(phases, "subset"):
            cols = pad_columns(self._subset_cols(rows, dirty), D)
        with _stage(phases, "launch"):
            out = prepare_resolution(cols, D, len(log.props), self.device,
                                     self.staging)()
        return {"rows": rows, "dirty": dirty,
                "out": {k: out[k] for k in self.READ_FETCH}}

    def _collect_async(self, handle, phases=None) -> None:
        if handle is None:
            return
        with _stage(phases, "readback"):
            res_sub = {k: v.cpu().numpy() for k, v in handle["out"].items()}
        with _stage(phases, "scatter"):
            self._scatter_subset(handle["rows"], handle["dirty"], res_sub)

    # -- row selection ------------------------------------------------------

    def _obj_rows(self, obj_key: int) -> np.ndarray:
        lo = np.searchsorted(self._obj_sorted, obj_key, side="left")
        hi = np.searchsorted(self._obj_sorted, obj_key, side="right")
        return self._rows_by_obj[lo:hi]

    def _check_obj(self, obj_key: int) -> ObjType:
        t = self._obj_type.get(obj_key)
        if t is None:
            raise KeyError(f"no such object {self.log.export_id(obj_key)}")
        return t

    def _all_elems(self, obj_key: int) -> List[int]:
        """ALL element rows of a sequence in document order — including
        invisible and mark elements."""
        cached = self._all_elems_cache.get(obj_key)
        if cached is None:
            cached = order_elem_rows(
                self.log, self.elem_index, self._obj_rows(obj_key)
            ).tolist()
            self._all_elems_cache[obj_key] = cached
        return cached

    def _seq_elems(self, obj_key: int) -> List[Tuple[int, int]]:
        """Visible elements of a sequence: [(elem_row, winner_row)] in order."""
        return [
            (r, int(self.winner[r]))
            for r in self._all_elems(obj_key)
            if self.winner[r] >= 0
        ]

    # -- value rendering ----------------------------------------------------

    def _render(self, row: int):
        a = int(self.log.action[row])
        if is_make_action(a):
            return (
                "obj",
                objtype_for_action(a),
                self.log.export_id(int(self.log.id_key[row])),
            )
        if a == Action.PUT and int(self.log.value_tag[row]) == TAG_COUNTER:
            return ("counter", int(self.counter_val[row]))
        return ("scalar", self.log.values[row])

    # -- reads --------------------------------------------------------------

    def object_type(self, obj: str) -> ObjType:
        return self._check_obj(self.log.import_id(obj))

    def keys(self, obj: str = "_root") -> List[str]:
        ok = self.log.import_id(obj)
        self._check_obj(ok)
        props = {
            int(self.log.prop[r])
            for r in self._obj_rows(ok)
            if self.log.prop[r] >= 0 and self.winner[r] >= 0
        }
        return sorted(self.log.props[p] for p in props)

    def map_entries(self, obj: str = "_root") -> List[Tuple[str, object, str]]:
        ok = self.log.import_id(obj)
        self._check_obj(ok)
        best: Dict[int, int] = {}
        for r in self._obj_rows(ok):
            p = int(self.log.prop[r])
            if p >= 0 and self.winner[r] >= 0:
                best[p] = int(self.winner[r])
        out = [
            (
                self.log.props[p],
                self._render(w),
                self.log.export_id(int(self.log.id_key[w])),
            )
            for p, w in best.items()
        ]
        out.sort(key=lambda kv: kv[0])
        return out

    def list_items(self, obj: str) -> List[Tuple[object, str]]:
        ok = self.log.import_id(obj)
        self._check_obj(ok)
        return [
            (self._render(w), self.log.export_id(int(self.log.id_key[w])))
            for _, w in self._seq_elems(ok)
        ]

    def text(self, obj: str) -> str:
        ok = self.log.import_id(obj)
        self._check_obj(ok)
        parts = []
        for _, w in self._seq_elems(ok):
            v = self.log.values[w]
            parts.append(v.value if v.tag == "str" else _OBJ_REPLACEMENT)
        return "".join(parts)

    def length(self, obj: str = "_root") -> int:
        ok = self.log.import_id(obj)
        t = self._check_obj(ok)
        if t in (ObjType.MAP, ObjType.TABLE):
            return len(self.keys(obj))
        dense = int(np.searchsorted(self.log.obj_table, ok))
        if t == ObjType.TEXT:
            return int(self.res["obj_text_width"][dense])
        return int(self.res["obj_vis_len"][dense])

    def get_all(self, obj: str, prop) -> List[Tuple[object, str]]:
        ok = self.log.import_id(obj)
        t = self._check_obj(ok)
        rows = self._obj_rows(ok)
        log = self.log
        if isinstance(prop, str):
            if t not in (ObjType.MAP, ObjType.TABLE):
                raise ValueError("map lookup requires a map object")
            try:
                p = log.props.index(prop)
            except ValueError:
                return []
            vis = [int(r) for r in rows if int(log.prop[r]) == p and self.visible[r]]
        else:
            elems = self._seq_elems(ok)
            if prop < 0:
                return []
            if t == ObjType.TEXT:
                # integer index is a character position: accumulate winner
                # widths (width-aware, as the host document's nth)
                er = None
                at = 0
                for r, w in elems:
                    at += int(log.width[w])
                    if prop < at:
                        er = r
                        break
                if er is None:
                    return []
            else:
                if not 0 <= prop < len(elems):
                    return []
                er = elems[prop][0]
            vis = [
                int(r)
                for r in rows
                if self.visible[r]
                and (
                    (log.insert[r] and int(r) == er)
                    or (not log.insert[r] and int(log.elem_ref[r]) == er)
                )
            ]
        vis.sort()  # rows are in Lamport order; winner last
        return [
            (self._render(r), log.export_id(int(log.id_key[r])))
            for r in vis
        ]

    def get(self, obj: str, prop):
        vals = self.get_all(obj, prop)
        return vals[-1] if vals else None
