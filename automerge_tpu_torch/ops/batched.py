"""Cross-document batched merge: many documents' dirty subsets resolved in
one packed launch on the card.

The port of ``automerge_tpu/ops/batched.py``. A server draining N hot
documents would pay N subset resolutions, one launch set per document,
each too small to fill the card. Here the drained deltas of many
documents are packed into ONE super-batch (each document's subset
columns concatenated, its row references shifted by its row offset and
its dense object ids by its object offset), resolved by one
``prepare_resolution(...)()`` on the card (``expand_runs``, ``succ_vis``,
the winners, ``forest`` and ``linearize``, as ``DeviceDoc._dispatch_async``
launches them for one document), and the results scattered back per
document.

Soundness: every group id of the resolution (sequence runs keyed by
their head row, map groups by (object, prop), the forest's object roots)
derives from row and object ids, so disjoint offset ranges keep every
document's groups apart, and each document resolves exactly as its own
subset launch would, bit for bit. Rows stay ascending inside each
document ("max row = max Lamport"), and ``linearize`` ranks each object
from its own first element, so ``elem_index`` needs no shift back.

Two entry points:

* ``apply_cross_doc(work)``: stage every document of ``work`` on the host
  (``host_batch.stage_docs``, or ``DeviceDoc.stage_batches`` a document),
  then resolve the stages in shared packed launches of at most
  ``max_docs_per_launch`` documents, chunk N's launch in flight while
  chunk N+1 stages.
* ``CrossDocBatcher``: the serving layer's collector. Workers draining
  different documents submit at once; the first of a generation leads,
  waits ``window_ms`` for others (waking early at ``max_docs``), then
  stages and launches for everyone. Submitters hold their document's
  lock while they wait.

A document whose subset rows exceed ``fallback_ratio`` (strictly) of the
batch's is peeled off and resolved on its own (the whale rule); a
document whose dirty rows pass ``DIRTY_FRACTION_LIMIT`` never reaches the
packer (its staging resolves it whole). The reference's knobs
(``AUTOMERGE_TPU_BATCH_*``, ``_PIPELINE_MIN_DOCS``, ``_DRAIN_PIPELINE``,
``_SERVE_BATCHED``) are the module constants below, with its defaults.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..obs import prof as _prof
from ..obs.views import CounterView
from .device_doc import DeviceDoc, _stage
from .merge import prepare_resolution
from .oplog import pad_columns

# a document is peeled while its rows strictly exceed this share of the batch
FALLBACK_RATIO = 0.5
# CrossDocBatcher: the leader's wait for co-arriving documents, and the
# generation size that wakes it early
BATCH_WINDOW_MS = 2.0
BATCH_DOCS = 32
# a generation this wide flushes as two half-launches (the second half
# staged while the first is in flight)
PIPELINE_MIN_DOCS = 16
# apply_cross_doc double-buffers its chunks
DRAIN_PIPELINE = True
# CrossDocBatcher's default mode: "1" always batches, "0" never, "auto"
# batches documents that live on a CUDA device
SERVE_BATCHED = "auto"

_PACK_COLS = (
    "action", "insert", "prop", "elem_ref", "obj_dense", "value_tag",
    "value_i32", "width", "covered", "pred_src", "pred_tgt",
)

# what the packed path did since the last reset, read from ``obs`` under
# the reference's names: packed launches, their useful and padded rows,
# documents peeled as whales, generations whose packed path failed (each
# of their documents then resolved on its own)
_OBS_STATS = CounterView({
    "launches": ("device.kernel_launches", {"path": ("batched",)}, None),
    "useful_rows": ("device.batch_rows", None, None),
    "padded_rows": ("device.batch_padding_rows", None, None),
    "batched_fallback": ("device.batched_fallback", None, None),
    "batched_error": ("device.batched_error", None, None),
})
# the host staging's documents by path (host_batch.stage_docs), which the
# reference counts differently (``host_batch.docs``,
# ``host_batch.fallback_docs{reason}``, counted there too)
STATS = dict.fromkeys((
    "vectorized_docs", "scalar_docs", "demoted_docs", "extract_error",
), 0)
_STATS_LOCK = threading.Lock()


def stats() -> dict:
    """The counts since ``reset_stats()``."""
    with _STATS_LOCK:
        out = dict(STATS)
    out.update(_OBS_STATS.read())
    return out


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in STATS:
            STATS[k] = 0
    _OBS_STATS.reset()


def count(name: str, n: int = 1) -> None:
    with _STATS_LOCK:
        STATS[name] += n


def _device_key(dev: torch.device) -> Tuple[str, int]:
    if dev.index is not None:
        return dev.type, dev.index
    return dev.type, torch.cuda.current_device() if dev.type == "cuda" else 0


def _check_device(docs, device: torch.device) -> None:
    want = _device_key(device)
    for doc in docs:
        if _device_key(doc.device) != want:
            raise ValueError(f"a document on {doc.device} in a batch for {device}")


class BatchStage:
    """One document's spliced append awaiting its resolution: the dirty
    objects' rows (``rows``, log rows) and dense ids (``dirty``), and the
    document to scatter into."""

    __slots__ = ("doc", "rows", "dirty", "error", "trace")

    def __init__(self, doc, rows: np.ndarray, dirty: np.ndarray):
        self.doc = doc
        self.rows = rows
        self.dirty = dirty
        self.error: Optional[BaseException] = None
        # the submitter's trace context, linked from the shared launch
        self.trace = None

    @property
    def n_rows(self) -> int:
        return len(self.rows)


def plan_stages(stages: Sequence[BatchStage], fallback_ratio: Optional[float] = None
                ) -> Tuple[List[BatchStage], List[BatchStage]]:
    """(packed batch, whales): the largest document is peeled while its
    rows strictly exceed ``fallback_ratio`` of the remaining total. A
    ratio of 1 or more never peels; 0 peels down to the smallest; a lone
    document is never peeled."""
    if fallback_ratio is None:
        fallback_ratio = FALLBACK_RATIO
    batch = sorted(stages, key=lambda s: s.n_rows)
    whales: List[BatchStage] = []
    total = sum(s.n_rows for s in batch)
    while len(batch) > 1 and batch[-1].n_rows > fallback_ratio * total:
        w = batch.pop()
        total -= w.n_rows
        whales.append(w)
    return batch, whales


def _pack(stages: Sequence[BatchStage]):
    """The documents' subset columns as one super-batch: ``elem_ref``,
    ``pred_src`` and ``pred_tgt`` shift by the document's row offset,
    ``obj_dense`` by its object offset; negative sentinels (HEAD, map op,
    missing) pass through. Returns (cols, metas, rows, objects) with metas
    [(stage, row offset, rows, object offset, objects)]."""
    parts = {k: [] for k in _PACK_COLS}
    metas = []
    row_off = obj_off = 0
    for st in stages:
        sub = st.doc._subset_cols(st.rows, st.dirty)
        er = sub["elem_ref"]
        sub["elem_ref"] = np.where(er >= 0, er + row_off, er).astype(np.int32)
        sub["obj_dense"] = (sub["obj_dense"] + obj_off).astype(np.int32)
        sub["pred_src"] = (sub["pred_src"] + row_off).astype(np.int32)
        pt = sub["pred_tgt"]
        sub["pred_tgt"] = np.where(pt >= 0, pt + row_off, pt).astype(np.int32)
        for k in parts:
            parts[k].append(np.asarray(sub[k]))
        S, D = len(st.rows), len(st.dirty)
        metas.append((st, row_off, S, obj_off, D))
        row_off += S
        obj_off += D
    cols = {k: np.concatenate(v) for k, v in parts.items()}
    return cols, metas, row_off, obj_off


def _dispatch_packed(cols, n_objs: int, n_props: int, device, staging: str,
                     phases=None):
    """Pad the super-batch and launch its resolution on ``device`` without
    reading it back (as ``DeviceDoc._dispatch_async`` does for one
    document); the outputs stay on the device until ``_collect_packed``."""
    useful = len(cols["action"])
    with _stage(phases, "pack"), obs.span("device.pack", rows=useful):
        cols = pad_columns(cols, n_objs)
    P = len(cols["action"])
    # occupancy at the pack site
    obs.count("device.batch_rows", n=useful)
    obs.count("device.batch_padding_rows", n=P - useful)
    _prof.note("useful_rows", useful)
    _prof.note("padded_rows", P - useful)
    _prof.note("launches")
    obs.count("device.kernel_launches", labels={"path": "batched"})
    with _stage(phases, "launch"):
        dispatch = prepare_resolution(cols, n_objs, n_props, device, staging)
        # queued without a sync: the readback holds the wait
        with obs.span("device.kernel", rows=P), \
                _prof.annotate("amtpu.batched_launch"):
            out = dispatch()
    # the per-object stats past the objects' two pad slots are never read
    fetch = {k: out[k][: n_objs + 2] if k.startswith("obj_") else out[k]
             for k in DeviceDoc.READ_FETCH}
    return {"out": fetch, "P": P, "useful": useful}


def _collect_packed(handle, phases=None) -> dict:
    """Read a packed launch's outputs back (the blocking half)."""
    with _stage(phases, "readback"), obs.span("device.readback",
                                              rows=handle["P"]):
        return {k: v.cpu().numpy() for k, v in handle["out"].items()}


def _launch_packed(cols, n_objs: int, n_props: int, device, staging: str):
    """One packed launch, read back."""
    return _collect_packed(_dispatch_packed(cols, n_objs, n_props, device, staging))


def _scatter(metas, res) -> None:
    """Each document's slice of the packed results into its resolution
    arrays (winners back to subset-local rows, ``_scatter_subset``'s
    contract)."""
    for st, r0, S, o0, D in metas:
        w = res["winner"][r0 : r0 + S]
        st.doc._scatter_subset(st.rows, st.dirty, {
            "visible": res["visible"][r0 : r0 + S],
            "winner": np.where(w >= 0, w - r0, -1).astype(np.int32),
            "conflicts": res["conflicts"][r0 : r0 + S],
            "elem_index": res["elem_index"][r0 : r0 + S],
            "obj_vis_len": res["obj_vis_len"][o0 : o0 + D],
            "obj_text_width": res["obj_text_width"][o0 : o0 + D],
        })


def dispatch_stages(stages: Sequence[BatchStage], fallback_ratio: Optional[float] = None,
                    device=None, phases=None) -> dict:
    """Resolve the whales each on its own now, and launch the rest as one
    packed resolution a staging (documents' ``staging``; one in practice)
    on ``device`` without reading back. The handle feeds
    ``collect_stages``, possibly after more host work has been staged
    under the launch."""
    device = resolve_device(device)
    _check_device([st.doc for st in stages], device)
    batch, whales = plan_stages(stages, fallback_ratio)
    for w in whales:
        obs.count("device.batched_fallback")
        with _stage(phases, "whale"):
            w.doc._reresolve(w.dirty)
    launches = []
    by_staging = {}
    for st in batch:
        by_staging.setdefault(st.doc.staging, []).append(st)
    if batch:
        links = [st.trace for st in batch if st.trace is not None]
        with obs.span("device.batched", links=links, docs=len(batch)):
            obs.observe("device.batch_docs", len(batch))
            for staging, group in by_staging.items():
                with _stage(phases, "pack"), obs.span("device.pack",
                                                      docs=len(group)):
                    cols, metas, _, n_objs = _pack(group)
                n_props = max(max(len(st.doc.log.props) for st in group), 1)
                launches.append((_dispatch_packed(
                    cols, n_objs, n_props, device, staging, phases), metas))
    return {"batched": len(batch), "fallback": len(whales), "launches": launches}


def collect_stages(disp: dict, phases=None) -> dict:
    """Read the packed launches back and scatter them into the documents."""
    if disp["launches"]:
        with obs.span("device.batched", docs=disp["batched"]):
            for handle, metas in disp["launches"]:
                res = _collect_packed(handle, phases)
                with _stage(phases, "scatter"), obs.span(
                        "device.scatter", docs=disp["batched"]):
                    _scatter(metas, res)
    return {"batched": disp["batched"], "fallback": disp["fallback"]}


def resolve_stages(stages: Sequence[BatchStage], fallback_ratio: Optional[float] = None,
                   device=None, phases=None) -> dict:
    """Whales each on its own, the rest in one packed launch. Returns
    {"batched": documents packed, "fallback": documents peeled}."""
    return collect_stages(dispatch_stages(stages, fallback_ratio, device, phases),
                          phases)


def apply_cross_doc(work, *, fallback_ratio: Optional[float] = None,
                    max_docs_per_launch: Optional[int] = None,
                    pipeline: Optional[bool] = None, device=None,
                    phases=None) -> dict:
    """Apply many documents' batches: ``work`` is an iterable of
    ``(DeviceDoc, batches)`` (``batches`` as ``apply_batches`` takes them),
    every document on ``device`` (None: the card). Stages every document
    on the host, then resolves the stages in packed launches of at most
    ``max_docs_per_launch`` documents (None: all in one).

    With several chunks and the pipeline on (``pipeline``, default
    ``DRAIN_PIPELINE``), chunk N's launch stays in flight while chunk N+1
    stages (dedup, causal order, pack, sort, splice); chunk N is read back
    after chunk N+1 is launched. Chunks hold disjoint documents, and a
    document listed twice merges into one staging.

    ``phases``, a dict when given, sums the wall seconds of each stage
    (the host staging's, then ``pack``, ``launch``, ``readback``,
    ``scatter``, ``whale``, and ``overlap``: host seconds spent under an
    in-flight launch). Returns {"applied": changes, "batched": documents
    resolved packed, "fallback": documents peeled as whales}."""
    from . import host_batch

    device = resolve_device(device)
    # one staging a document: a later append splices the log and would
    # move an earlier stage's rows
    merged: dict = {}
    order: List[int] = []
    for dev, batches in work:
        k = id(dev)
        if k in merged:
            merged[k][1].extend(batches)
        else:
            merged[k] = (dev, list(batches))
            order.append(k)
    _check_device([merged[k][0] for k in order], device)

    def stage_chunk(keys, idx0):
        applied = 0
        stages: List[BatchStage] = []
        if host_batch.enabled():
            stages, results = host_batch.stage_docs([merged[k] for k in keys],
                                                    phases=phases)
            for r in results.values():
                if r.error is not None:
                    raise r.error
                applied += r.applied
        else:
            for i, k in enumerate(keys):
                dev, batches = merged[k]
                t0 = time.perf_counter()
                n, st = dev.stage_batches(batches)
                _prof.note_doc(getattr(dev, "obs_name", None) or f"doc{idx0 + i}",
                               time.perf_counter() - t0)
                applied += n
                if st is not None:
                    stages.append(st)
        return stages, applied

    out = {"applied": 0, "batched": 0, "fallback": 0}

    def account(r):
        out["batched"] += r["batched"]
        out["fallback"] += r["fallback"]

    if pipeline is None:
        pipeline = DRAIN_PIPELINE
    step = max_docs_per_launch or len(order) or 1
    if pipeline and len(order) > step:
        pending = None
        try:
            for lo in range(0, len(order), step):
                t0 = time.perf_counter()
                stages, n = stage_chunk(order[lo : lo + step], lo)
                out["applied"] += n
                d = dispatch_stages(stages, fallback_ratio, device, phases)
                if pending is not None:
                    # everything since the loop top ran under pending's launch
                    overlap = time.perf_counter() - t0
                    _prof.note("overlap_s", overlap)
                    if phases is not None:
                        phases["overlap"] = phases.get("overlap", 0.0) + overlap
                    account(collect_stages(pending, phases))
                pending = d
        except BaseException:
            if pending is not None:
                p, pending = pending, None
                collect_stages(p, phases)
            raise
        if pending is not None:
            account(collect_stages(pending, phases))
    else:
        stages, n = stage_chunk(order, 0)
        out["applied"] += n
        sstep = max_docs_per_launch or len(stages) or 1
        for lo in range(0, len(stages), sstep):
            account(resolve_stages(stages[lo : lo + sstep], fallback_ratio, device,
                                   phases))
    _prof.note("docs", len(order))
    _prof.note("changes", out["applied"])
    return out


# -- the serving layer's collector ---------------------------------------------


class _Submission:
    """One document's raw batches awaiting the leader's staging; the
    submitter holds its document's lock meanwhile."""

    __slots__ = ("dev", "batches", "applied", "error", "trace")

    def __init__(self, dev, batches, trace=None):
        self.dev = dev
        self.batches = batches
        self.applied = 0
        self.error: Optional[BaseException] = None
        self.trace = trace


class _Generation:
    __slots__ = ("stages", "subs", "done")

    def __init__(self):
        self.stages: List[BatchStage] = []  # staged by their submitters
        self.subs: List[_Submission] = []  # staged by the leader
        self.done = threading.Event()


class CrossDocBatcher:
    """Group commit for concurrent per-document workers.

    ``apply(dev, batches)`` (the caller MUST hold that document's lock)
    submits the document's drained batches and blocks until a shared
    launch has resolved them. The first submitter of a generation leads:
    it waits up to ``window_ms`` for others (a generation closes as soon
    as it holds ``max_docs``), then flushes it for everyone, one
    generation at a time.

    ``mode``: "1" always batches, "0" never (``apply`` is then
    ``apply_batches``), "auto" batches documents on a CUDA device (on the
    CPU a document's own host delta resolution beats any launch).
    ``device`` (None: the card) is where the packed launches run; every
    document submitted must live there."""

    def __init__(self, *, window_ms: Optional[float] = None,
                 max_docs: Optional[int] = None,
                 fallback_ratio: Optional[float] = None,
                 mode: Optional[str] = None, device=None):
        self.window = (BATCH_WINDOW_MS if window_ms is None else window_ms) / 1000.0
        self.max_docs = int(BATCH_DOCS if max_docs is None else max_docs)
        self.fallback_ratio = fallback_ratio
        self.mode = SERVE_BATCHED if mode is None else mode
        self.pipeline_min_docs = PIPELINE_MIN_DOCS
        self.device = device
        self._cv = threading.Condition(threading.Lock())
        self._gen = _Generation()
        self._flush_lock = threading.Lock()

    def active(self, dev=None) -> bool:
        """Whether ``dev``'s feeds route through this batcher."""
        if self.mode == "0":
            return False
        if self.mode == "auto":
            return dev is not None and dev.device.type == "cuda"
        return True

    def apply(self, dev, batches) -> int:
        """Submit ``dev``'s batches and block until they are resolved.
        Returns the changes applied.

        With the vectorized host staging on (``host_batch.enabled()``) the
        submitter hands its raw batches over and the generation's leader
        stages every document in one columnar pass before the launch;
        otherwise each submitter stages its own document and only the
        launch is shared."""
        device = resolve_device(self.device)
        _check_device([dev], device)
        if not self.active(dev):
            return dev.apply_batches(batches)
        from . import host_batch

        if host_batch.enabled():
            sub = _Submission(dev, list(batches), obs.current_trace_context())
            self._join(lambda gen: gen.subs.append(sub))
            if sub.error is not None:
                raise sub.error
            return sub.applied
        t0 = time.perf_counter()
        applied, stage = dev.stage_batches(batches)
        _prof.note("docs")
        _prof.note("changes", applied)
        _prof.note_doc(getattr(dev, "obs_name", None), time.perf_counter() - t0)
        if stage is None:
            return applied
        # the shared launch (perhaps on another thread) links back to
        # this submitter's trace, if one is active
        stage.trace = obs.current_trace_context()
        self._join(lambda gen: gen.stages.append(stage))
        if stage.error is not None:
            raise stage.error
        return applied

    def _join(self, add) -> None:
        """Add a submission to the open generation, then lead it or wait
        for its leader."""
        with self._cv:
            gen = self._gen
            add(gen)
            size = len(gen.stages) + len(gen.subs)
            leader = size == 1
            if size >= self.max_docs:
                # full: it closes now, and the next submitter opens another
                self._gen = _Generation()
                self._cv.notify_all()  # wake its leader early
        if leader:
            self._lead(gen)
        else:
            gen.done.wait()

    def _lead(self, gen: _Generation) -> None:
        """Wait out the window, close the generation and flush it."""
        deadline = time.monotonic() + self.window
        with self._cv:
            while len(gen.stages) + len(gen.subs) < self.max_docs:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            if self._gen is gen:
                self._gen = _Generation()
        # one generation flushes at a time: the launches share the stream
        with self._flush_lock:
            self._flush(gen)

    def _flush(self, gen: _Generation) -> None:
        """Stage the leader-staged submissions in one pass, launch once (a
        wide generation as two half-launches), release every waiter. On
        failure each document is resolved on its own on its device, and
        the failure is counted (``device.batched_error``)."""
        from . import host_batch

        device = resolve_device(self.device)
        stages: List[BatchStage] = list(gen.stages)
        subs_staged = False
        try:
            if gen.subs:
                more, results = host_batch.stage_docs(
                    [(s.dev, s.batches) for s in gen.subs])
                subs_staged = True
                trace_of = {}
                n_changes = 0
                for s in gen.subs:
                    r = results.get(id(s.dev))
                    if r is not None:
                        s.applied = r.applied
                        s.error = r.error
                        n_changes += r.applied
                    if s.trace is not None:
                        trace_of.setdefault(id(s.dev), s.trace)
                for st in more:
                    st.trace = trace_of.get(id(st.doc))
                _prof.note("docs", len(gen.subs))
                _prof.note("changes", n_changes)
                stages.extend(more)
            if DRAIN_PIPELINE and len(stages) >= self.pipeline_min_docs:
                mid = len(stages) // 2
                d1 = dispatch_stages(stages[:mid], self.fallback_ratio, device)
                try:
                    t0 = time.perf_counter()
                    d2 = dispatch_stages(stages[mid:], self.fallback_ratio, device)
                    _prof.note("overlap_s", time.perf_counter() - t0)
                except BaseException:
                    collect_stages(d1)
                    raise
                collect_stages(d1)
                collect_stages(d2)
            else:
                resolve_stages(stages, self.fallback_ratio, device)
        except Exception as e:  # noqa: BLE001 - every document degrades alone
            obs.count("device.batched_error")
            recovered = True
            for st in stages:
                try:
                    st.doc._reresolve(st.dirty)
                except Exception as e2:  # noqa: BLE001
                    st.error = e2
                    recovered = False
            if not subs_staged:
                # the staging itself failed: every leader-staged submitter sees it
                for s in gen.subs:
                    if s.error is None:
                        s.error = e
            for st in stages:
                if st.error is not None:
                    for s in gen.subs:
                        if s.dev is st.doc and s.error is None:
                            s.error = st.error
            if recovered and stages:
                obs.event("device.batched_recovered", error=str(e)[:200])
        finally:
            gen.done.set()
