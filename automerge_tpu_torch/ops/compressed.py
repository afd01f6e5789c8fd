"""Compressed resident columns: run-length and stride-run codecs.

The port of ``automerge_tpu/ops/compressed.py``. An ``OpLog``'s columns
are kept, beside their dense arrays, as an incrementally maintained
encoded image:

* **run-length** for the low-cardinality columns (``action``,
  ``value_tag``, ``insert``, ``width``, ``expand``, ``mark_name_idx``,
  ``prop``, ``obj_dense``): runs of one repeated value.
* **stride runs** for the monotone and striding columns (the packed-key
  columns ``id_key`` / ``obj_key`` / ``elem_key``, and ``elem_ref`` /
  ``value_int``, whose typing chains are stride runs): each run is an
  arithmetic sequence ``(start, stride, length)``. The run table of a
  sorted key column is an offset-value coding of the ``(counter, actor)``
  composite: a membership probe is a searchsorted over the ``R`` run
  heads plus stride arithmetic, instead of a searchsorted over all ``N``
  keys (``StrideRuns.join``).
* **dense** for whatever does not compress: a column whose run count
  crosses the ratio gate, or whose runs would not undercut its dense
  bytes, demotes (counted as ``oplog.compress_fallback{column,reason=ratio}``).

Tail appends, the dominant shape (``OpLog.append_changes``,
``host_batch._splice_doc``), extend the last run in place instead of
re-encoding (``StrideRuns.extend_tail``). Anything that rewrites the
resident prefix (a non-tail splice, an actor-rank remap, re-resolved
MISSING references) drops the image, and the next consumer re-encodes.

The image feeds the residency figures (``OpLog.resident_column_nbytes``,
``DeviceDoc.resident_nbytes``), the offset-value-coded id join of the
append paths and the ARSN snapshot (``storage/runsnap.py``). It is host
state only: the run-native staging of ``ops/merge.py`` builds its own
run tables.

``ENABLED`` (default True) and the reference's knob
``AUTOMERGE_TPU_COMPRESSED`` (``0`` turns it off) both gate ``enabled()``:
off, every path stays dense, the oracle the tests compare against.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .. import obs
from ..obs.views import CounterView

# compressed residency on (False: dense everywhere)
ENABLED = True
# a column with more runs than this share of its rows ships dense
GATE_RATIO = 0.5

# what ``stats()`` reads from ``obs``: columns demoted by the gate (by
# column), rows joined over the id runs, snapshots written dense without a
# sync (``storage/runsnap.py``)
_STATS = CounterView({
    "compress_fallback": ("oplog.compress_fallback", {"reason": ("ratio",)},
                          "column"),
    "ovc_join": ("oplog.ovc_join", None, None),
    "dense_shortcut": ("compact.dense_shortcut", None, None),
})


def enabled() -> bool:
    """Whether compressed residency is active: ``ENABLED``, unless the
    environment sets ``AUTOMERGE_TPU_COMPRESSED=0``."""
    return ENABLED and os.environ.get("AUTOMERGE_TPU_COMPRESSED", "1") != "0"


def stats() -> dict:
    """The counts since ``reset_stats()``: ``compress_fallback`` by
    column, ``ovc_join`` rows, ``dense_shortcut`` snapshots (read from
    ``obs``)."""
    return _STATS.read()


def reset_stats() -> None:
    _STATS.reset()


def run_gate(n_runs: int, n_rows: int) -> bool:
    """True when a run table is degenerate enough that its column must
    ship (and compute) dense: the run count crosses ``GATE_RATIO`` of the
    rows, or the (w, cum) pairs would not undercut the dense int32
    image."""
    return n_runs > GATE_RATIO * n_rows or 2 * n_runs >= n_rows


class StrideRuns:
    """One column as arithmetic-sequence runs.

    ``starts`` are row offsets (ascending, ``starts[0] == 0``), ``vals``
    the start value of each run, ``strides`` its step (all int64; a pure
    run-length encode pins every stride to 0). ``n`` is the decoded
    length. ``is_sorted`` marks a strictly increasing column, which
    ``join`` requires.
    """

    __slots__ = ("starts", "vals", "strides", "n", "dtype", "is_sorted",
                 "stride_mode")

    def __init__(self, starts, vals, strides, n, dtype, is_sorted,
                 stride_mode=True):
        self.starts = starts
        self.vals = vals
        self.strides = strides
        self.n = int(n)
        self.dtype = np.dtype(dtype)
        self.is_sorted = bool(is_sorted)
        self.stride_mode = bool(stride_mode)

    # -- construction --------------------------------------------------------

    @classmethod
    def encode(cls, arr, stride: bool = True) -> "StrideRuns":
        """Encode one column. ``stride=False`` gives pure run-length runs
        (each run one repeated value), the low-cardinality mode."""
        arr = np.asarray(arr)
        dtype = arr.dtype
        x = arr.astype(np.int64, copy=False)
        n = len(x)
        if n == 0:
            z = np.empty(0, np.int64)
            return cls(z, z, z, 0, dtype, True, stride)
        if n == 1:
            z = np.zeros(1, np.int64)
            return cls(z, x.copy(), np.zeros(1, np.int64), 1, dtype, True,
                       stride)
        d = np.diff(x)
        if stride:
            # row p >= 2 starts a run when the step into it differs from
            # the step before it; row 1 always rides run 0
            b = np.flatnonzero(d[1:] != d[:-1]) + 2
        else:
            b = np.flatnonzero(d != 0) + 1
        starts = np.concatenate([[0], b]).astype(np.int64)
        lengths = np.diff(np.concatenate([starts, [n]]))
        vals = x[starts]
        if stride:
            safe = np.minimum(starts, n - 2)
            strides = np.where(lengths > 1, d[safe], 0).astype(np.int64)
        else:
            strides = np.zeros(len(starts), np.int64)
        return cls(starts, vals, strides, n, dtype, bool(np.all(d > 0)),
                   stride)

    # -- primitives ----------------------------------------------------------

    @property
    def run_count(self) -> int:
        return len(self.starts)

    @property
    def nbytes(self) -> int:
        """The bytes the encoded form holds."""
        return self.starts.nbytes + self.vals.nbytes + self.strides.nbytes

    def lengths(self) -> np.ndarray:
        return np.diff(np.concatenate([self.starts, [self.n]]))

    def decode(self) -> np.ndarray:
        if self.n == 0:
            return np.empty(0, self.dtype)
        ln = self.lengths()
        off = np.arange(self.n, dtype=np.int64) - np.repeat(self.starts, ln)
        out = np.repeat(self.vals, ln) + np.repeat(self.strides, ln) * off
        return out.astype(self.dtype, copy=False)

    def last_value(self) -> int:
        ln = self.n - 1 - int(self.starts[-1])
        return int(self.vals[-1] + self.strides[-1] * ln)

    def slice(self, lo: int, hi: int) -> "StrideRuns":
        """The encoded form of ``decode()[lo:hi]``, by clipping the runs
        that overlap the range (nothing is decoded)."""
        lo = max(int(lo), 0)
        hi = min(int(hi), self.n)
        if hi <= lo:
            z = np.empty(0, np.int64)
            return StrideRuns(z, z, z, 0, self.dtype, True, self.stride_mode)
        j0 = int(np.searchsorted(self.starts, lo, side="right")) - 1
        j1 = int(np.searchsorted(self.starts, hi, side="left"))
        starts = self.starts[j0:j1].copy()
        vals = self.vals[j0:j1].copy()
        strides = self.strides[j0:j1].copy()
        vals[0] += strides[0] * (lo - starts[0])
        starts[0] = lo
        starts -= lo
        return StrideRuns(starts, vals, strides, hi - lo, self.dtype,
                          self.is_sorted, self.stride_mode)

    def extend_tail(self, tail) -> None:
        """Append ``tail`` in place: the boundary run extends instead of
        the resident prefix being re-encoded. O(len(tail) + new runs).
        The merge rules are the reference's: the tables are the bytes of
        an ARSN image."""
        tail = np.asarray(tail).astype(np.int64, copy=False)
        k = len(tail)
        if k == 0:
            return
        if self.n == 0:
            e = StrideRuns.encode(tail.astype(self.dtype, copy=False),
                                  stride=self.stride_mode)
            self.starts, self.vals, self.strides = e.starts, e.vals, e.strides
            self.n, self.is_sorted = e.n, e.is_sorted
            return
        pure_rle = not self.stride_mode
        e = StrideRuns.encode(tail, stride=not pure_rle)
        last = self.last_value()
        d0 = int(tail[0]) - last
        if d0 <= 0:
            self.is_sorted = False
        if not e.is_sorted:
            self.is_sorted = False
        n0 = self.n
        L = n0 - int(self.starts[-1])  # length of the resident last run
        st = int(self.strides[-1])
        l0 = int(e.lengths()[0])
        st0 = int(e.strides[0])
        merge = False
        new_stride = st
        if pure_rle:
            merge = d0 == 0 and st0 == 0
            new_stride = 0
        elif L >= 2:
            merge = d0 == st and (l0 == 1 or st0 == st)
        else:  # a resident singleton takes whatever stride continues it
            merge = l0 == 1 or st0 == d0
            new_stride = d0
        drop = 1 if merge else 0
        if merge:
            self.strides[-1] = new_stride
        self.starts = np.concatenate([self.starts, e.starts[drop:] + n0])
        self.vals = np.concatenate([self.vals, e.vals[drop:]])
        self.strides = np.concatenate([self.strides, e.strides[drop:]])
        self.n = n0 + k

    def splice(self, pos: int, values) -> "StrideRuns":
        """The encoded form after inserting ``values`` at row ``pos``. At
        ``pos == n`` the runs extend in place (and ``self`` is returned);
        an interior splice re-encodes, the rare path."""
        if pos == self.n:
            self.extend_tail(values)
            return self
        x = self.decode()
        out = np.concatenate([
            x[:pos],
            np.asarray(values).astype(self.dtype, copy=False),
            x[pos:],
        ])
        return StrideRuns.encode(out, stride=self.stride_mode)

    # -- the offset-value-coded membership join ------------------------------

    def join(self, keys, missing: int) -> np.ndarray:
        """Row indices of ``keys`` in this strictly sorted column
        (``missing`` where absent): ``oplog.join_rows`` over the run
        table, a searchsorted over the R run heads plus stride
        arithmetic. Requires ``is_sorted``."""
        if not self.is_sorted:
            raise ValueError("join requires a strictly sorted column")
        keys = np.asarray(keys, np.int64)
        if self.run_count == 0 or len(keys) == 0:
            return np.full(len(keys), missing, np.int32)
        j = np.searchsorted(self.vals, keys, side="right") - 1
        inside = j >= 0
        jc = np.clip(j, 0, self.run_count - 1)
        rel = keys - self.vals[jc]
        st = self.strides[jc]
        ln = self.lengths()[jc]
        st_safe = np.where(st > 0, st, 1)
        q = rel // st_safe
        hit = (
            inside
            & (rel >= 0)
            & (rel % st_safe == 0)
            & (q < ln)
            & ((st > 0) | (rel == 0))
        )
        row = self.starts[jc] + q
        return np.where(hit, row, np.int64(missing)).astype(np.int32)


# -- the resident image -------------------------------------------------------

# (column attribute, codec mode, dense itemsize). Mode "rle" is repeated-
# value runs, "delta" stride runs. Row columns have log.n rows, the pred_*
# edge columns len(pred_src).
ROW_SPEC = (
    ("action", "rle", 4),
    ("insert", "rle", 1),
    ("prop", "rle", 4),
    ("value_tag", "rle", 4),
    ("width", "rle", 4),
    ("expand", "rle", 1),
    ("mark_name_idx", "rle", 4),
    ("obj_dense", "rle", 4),
    ("id_key", "delta", 8),
    ("obj_key", "delta", 8),
    ("elem_key", "delta", 8),
    ("elem_ref", "delta", 4),
    ("value_int", "delta", 8),
)
EDGE_SPEC = (
    ("pred_src", "delta", 4),
    ("pred_tgt", "delta", 4),
    ("pred_key", "delta", 8),
)

_DENSE = "dense"  # a column's demotion marker


class CompressedOpColumns:
    """The incrementally maintained compressed image of one OpLog's
    columns: a ``StrideRuns`` (or the dense marker) a column, each with
    its own covered-row cursor, so that a consumer encodes only the tail
    not yet covered. It gives the resident bytes (``nbytes``), their dense
    equivalent (``dense_nbytes``) and the offset-value-coded id join."""

    __slots__ = ("entries", "covered", "demoted")

    def __init__(self):
        self.entries: Dict[str, object] = {}
        self.covered: Dict[str, int] = {}
        self.demoted: Dict[str, str] = {}

    # -- introspection -------------------------------------------------------

    def all_dense(self, names) -> bool:
        """True when every tracked column of ``names`` is demoted: the
        snapshot writer then has no run table to write and skips the sync
        (``compact.dense_shortcut``). A column of zero rows (an empty
        pred column) holds no runs either way and does not count."""
        seen_dense = False
        for nm in names:
            e = self.entries.get(nm)
            if e is _DENSE:
                seen_dense = True
            elif e is None or e.n:
                return False
        return seen_dense

    def runs_for(self, name: str, rows: int):
        """The ``StrideRuns`` of ``name`` if it covers exactly ``rows``
        rows; None for a demoted, stale or untracked column (the caller
        then writes the dense array)."""
        ent = self.entries.get(name)
        if ent is None or ent is _DENSE or ent.n != rows:
            return None
        return ent

    # -- upkeep --------------------------------------------------------------

    def _sync_col(self, name: str, mode: str, arr, total: int,
                  itemsize: int = 8) -> None:
        cov = self.covered.get(name, 0)
        ent = self.entries.get(name)
        if cov > total or (ent is not None and ent is not _DENSE
                           and ent.n != cov):
            # the prefix moved under the image (or its cursor is past the
            # column): encode from scratch
            ent = None
            cov = 0
        if ent is _DENSE:
            self.covered[name] = total
            return
        arr = np.asarray(arr)
        if ent is None:
            ent = StrideRuns.encode(arr[:total], stride=(mode == "delta"))
        elif cov < total:
            ent.extend_tail(arr[cov:total].astype(np.int64, copy=False)
                            if arr.dtype != np.int64 else arr[cov:total])
        # the gate, on both axes: the run count past the ratio, or runs
        # (24 B each) that cost at least the dense column (itemsize a row)
        if total and (
            ent.run_count > GATE_RATIO * total
            or ent.nbytes >= total * itemsize
        ):
            obs.count("oplog.compress_fallback",
                      labels={"column": name, "reason": "ratio"})
            self.entries[name] = _DENSE
            self.demoted[name] = "ratio"
        else:
            self.entries[name] = ent
        self.covered[name] = total

    def sync(self, log) -> "CompressedOpColumns":
        """Bring every tracked column up to the log's row and edge counts,
        encoding only what is new."""
        n = log.n
        q = len(log.pred_src)
        for name, mode, item in ROW_SPEC:
            arr = getattr(log, name)
            if arr is None:  # an assembled log defers elem_key
                self.entries.pop(name, None)
                self.covered[name] = 0
                continue
            if name in ("insert", "expand"):
                arr = np.asarray(arr, np.bool_).view(np.int8)
            self._sync_col(name, mode, arr, n, item)
        for name, mode, item in EDGE_SPEC:
            arr = getattr(log, name)
            if arr is None:
                self.entries.pop(name, None)
                self.covered[name] = 0
                continue
            self._sync_col(name, mode, arr, q, item)
        return self

    def extend_id(self, d_id) -> Optional[StrideRuns]:
        """Extend only the id_key runs with a tail delta (the append
        path's eager extension, so that the id join runs over the spliced
        column before the rest of the image syncs). The extended runs, or
        None when id_key is demoted or no longer sorted."""
        ent = self.entries.get("id_key")
        if ent is None or ent is _DENSE:
            return None
        ent.extend_tail(d_id)
        self.covered["id_key"] = ent.n
        return ent if ent.is_sorted else None

    def id_runs(self) -> Optional[StrideRuns]:
        ent = self.entries.get("id_key")
        if ent is None or ent is _DENSE or not ent.is_sorted:
            return None
        return ent

    # -- accounting ----------------------------------------------------------

    def nbytes(self, log) -> int:
        """Resident bytes of the column set under this encoding (a demoted
        column counts dense)."""
        total = 0
        for name, _, item in ROW_SPEC + EDGE_SPEC:
            ent = self.entries.get(name)
            rows = self.covered.get(name, 0)
            if ent is None or ent is _DENSE:
                total += rows * item
            else:
                total += ent.nbytes
        return total

    def dense_nbytes(self, log) -> int:
        return sum(
            self.covered.get(name, 0) * item
            for name, _, item in ROW_SPEC + EDGE_SPEC
        )

    def ratio(self, log) -> float:
        c = self.nbytes(log)
        return (self.dense_nbytes(log) / c) if c else 1.0

    def run_counts(self) -> Dict[str, int]:
        return {
            name: (-1 if ent is _DENSE else ent.run_count)
            for name, ent in self.entries.items()
        }

    # -- integrity -----------------------------------------------------------

    def verify_against(self, log) -> list:
        """Decode every encoded column and compare it with the dense array
        it stands for. The names of the columns that differ (empty: the
        image is faithful). Reads only: it never repairs the image."""
        bad = []
        n = log.n
        q = len(log.pred_src)
        for name, _mode, _item in ROW_SPEC + EDGE_SPEC:
            ent = self.entries.get(name)
            if ent is None or ent is _DENSE:
                continue
            arr = getattr(log, name)
            if arr is None:
                bad.append(name)  # encoded rows of a column the log lost
                continue
            rows = q if name in ("pred_src", "pred_tgt", "pred_key") else n
            cov = self.covered.get(name, 0)
            if cov > rows or ent.n != cov:
                bad.append(name)
                continue
            if name in ("insert", "expand"):
                arr = np.asarray(arr, np.bool_).view(np.int8)
            want = np.asarray(arr[:cov]).astype(np.int64, copy=False)
            if not np.array_equal(ent.decode().astype(np.int64, copy=False),
                                  want):
                bad.append(name)
        return bad
