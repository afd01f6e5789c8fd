"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the metrics.

The cell's traffic file (``traffic/<traffic>.json``) names its ``loop``,
one of ``LOOPS`` below, and that loop's sizes; the configuration file
(``configs/<config>.json``) names its document kind, whose module under
``documents/`` generates the inputs, makes the timed read and compares
with the reference. Each metric is read by ``metrics/<name>.py``.

``run_cell`` takes the device as an argument and does not look for a
card: ``run.py`` does that. The port is reached through ``Port``, which a
test may replace with a broken one.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

from . import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded in the process that prints a result,
# compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "automerge_tpu")


class Port:
    """What the harness takes from the program: the document's merge and
    served apply, and the kernels' launch counters."""

    def __init__(self):
        from automerge_tpu_torch import kernels
        from automerge_tpu_torch.ops.device_doc import DeviceDoc

        self.DeviceDoc = DeviceDoc
        self.kernels = kernels

    def merge(self, chunks, device, phases=None):
        return self.DeviceDoc.merge(chunks, device=device, phases=phases)

    def apply_batches(self, doc, batches, phases=None):
        return doc.apply_batches(batches, phases)

    def launches(self) -> dict:
        return dict(self.kernels.launch_counts())

    def bind(self, run) -> None:
        """Called once the run's inputs are loaded."""


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str):
    """(the cell, its configuration entry, its traffic file's contents)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


class Run:
    """The state of one run, which the loops fill and the metric readers
    read."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device, port,
                 t_process, cfg_override=None):
        self.cell, self.traffic = cell, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.port = device, port
        self.t_process = t_process
        self.config_path = ROOT / config["file"]
        with open(self.config_path) as f:
            self.cfg = dict(json.load(f), **(cfg_override or {}))
        # the configuration's document kind: its generator, read and reference
        self.doc = importlib.import_module(f"portbench.documents.{self.cfg['document']}")
        self.iterations = []  # one dict per timed iteration (a call, when served)
        self.failed = 0
        self.ops_done = 0
        self.prof = None
        self.trace_summary = None
        self.setup_s = None
        self.generate_s = 0.0
        self.notes = {}

    def load_inputs(self):
        """Generates the run's inputs from its seed, anew in every run so
        that every run does the same work, timing it: the time is the
        benchmark's own and is kept out of ``setup_s``."""
        t = time.perf_counter()
        self.inputs = self.doc.generate(self.cfg, self.seed)
        self.generate_s = time.perf_counter() - t

    def open_window(self) -> float:
        """Ends set-up: collects garbage, starts the profiler in a traced
        run, and returns the window's start."""
        gc.collect()
        gc.freeze()  # the harness's inputs are not the program's garbage
        if self.trace:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device != "cpu":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self._window = trace_mod.span(trace_mod.WINDOW, True)
            self._window.__enter__()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_process - self.generate_s
        self.t0 = t0
        self.deadline = t0 + self.seconds
        return t0

    def close_window(self, t_end: float) -> None:
        self.window_wall = t_end - self.t0
        if self.trace:
            self._window.__exit__(None, None, None)
            self.prof.stop()
            if self.device != "cpu":
                self.trace_summary = trace_mod.Trace(self.prof)
            self.prof = None
        gc.unfreeze()

    def count_launches(self, key, launched: dict, expected: dict, kinds=None) -> None:
        """Holds an iteration's launches to the table ``expected`` under
        ``key``, filling it on first sight, and (``kinds``, a table) to
        launching the same kernels as ``kinds`` does; a difference fails
        the iteration."""
        want = expected.setdefault(key, launched)
        if launched != want or (kinds is not None and set(launched) != set(kinds)):
            self.failed += 1
            self.notes.setdefault("launch_mismatch", []).append(
                {"iteration": len(self.iterations), "launched": launched, "expected": want})

    # -- helpers for the metric readers --------------------------------------

    def mean_phase(self, keys) -> float | None:
        """Mean over the iterations of the summed ``phases`` seconds under
        ``keys``; None when no iteration has any of them."""
        vals = [sum(it["phases"][k] for k in keys if k in it["phases"])
                for it in self.iterations if it.get("phases") is not None]
        found = any(k in it.get("phases") or {} for it in self.iterations for k in keys)
        return statistics.fmean(vals) if vals and found else None

    def quantile(self, key: str, q: int) -> float | None:
        vals = [it[key] for it in self.iterations if key in it]
        if len(vals) < 2:
            return None
        return statistics.quantiles(vals, n=100, method="inclusive")[q - 1]


# -- the loops ----------------------------------------------------------------


def fanin_loop(run: Run) -> dict:
    """Closed loop, one caller: each iteration merges all the changes into a
    new document and reads it; the document before is released first."""
    port, doc_mod, inp = run.port, run.doc, run.inputs
    chunks = inp["chunks"]
    before = port.launches()
    doc = port.merge(chunks, run.device)
    doc_mod.read(doc, inp)
    warm = _diff(port.launches(), before)
    doc = None
    expected = {"merge": warm}
    ops = sum(inp["n_ops"])
    # the outputs compared: a seeded one among the first three, and the last
    keep = int(np.random.default_rng(run.seed).integers(0, 3))
    kept = {}
    last = None
    t = run.open_window()
    while t < run.deadline:
        doc = None
        phases = {} if run.trace else None
        before = port.launches()
        with trace_mod.span("portbench.merge", run.trace):
            t0 = time.perf_counter()
            doc = port.merge(chunks, run.device, phases)
        with trace_mod.span("portbench.read", run.trace):
            t1 = time.perf_counter()
            out = doc_mod.read(doc, inp)
            t = time.perf_counter()
        run.count_launches("merge", _diff(port.launches(), before), expected)
        i = len(run.iterations)
        run.iterations.append({"wall": t - t0, "read_s": t - t1, "phases": phases})
        run.ops_done += ops
        if i == keep:
            kept[i] = out
        last = (i, out)
        out = None
    run.close_window(t)
    kept[last[0]] = last[1]
    return {"final": [(len(chunks), doc, list(kept.values()))]}


def served_loop(run: Run) -> dict:
    """Closed loop, one caller: the base resident on the device, the
    replicas' changes arriving in batches, several batches a call of
    ``apply_batches``; once every replica is in, the round starts again
    on a freshly resolved base."""
    port, doc_mod, inp, tr = run.port, run.doc, run.inputs, run.traffic
    chunks = inp["chunks"]
    base, reps, rep_ops = chunks[:1], chunks[1:], inp["n_ops"][1:]
    per, k = tr["changes_per_batch"], tr["batches_per_call"]
    calls = []  # (batches, changes, ops) of each call of a round
    for c0 in range(0, len(reps), per * k):
        n = min(per * k, len(reps) - c0)
        batches = [reps[c0 + b:c0 + min(b + per, n)] for b in range(0, n, per)]
        calls.append((batches, n, sum(rep_ops[c0:c0 + n])))
    doc = port.merge(base, run.device)
    before = port.launches()
    port.apply_batches(doc, calls[0][0])
    expected = {0: _diff(port.launches(), before)}
    doc = port.merge(base, run.device)
    j = 0
    done = None  # the last round's document, whole
    t = run.open_window()
    while t < run.deadline:
        if doc is None:
            with trace_mod.span("portbench.rebase", run.trace):
                doc = port.merge(base, run.device)
            j = 0
        batches, _, ops = calls[j]
        phases = {} if run.trace else None
        before = port.launches()
        with trace_mod.span("portbench.call", run.trace):
            t0 = time.perf_counter()
            port.apply_batches(doc, batches, phases)
            t = time.perf_counter()
        run.count_launches(j, _diff(port.launches(), before), expected, expected[0])
        run.iterations.append({"wall": t - t0, "phases": phases})
        run.ops_done += ops
        j += 1
        if j == len(calls):
            done, doc = doc, None
    run.close_window(t)
    finals = []
    if done is not None:
        finals.append((len(chunks), done, None))
    if doc is not None:
        finals.append((1 + sum(n for _, n, _ in calls[:j]), doc, None))
    return {"final": finals}


LOOPS = {"fanin": fanin_loop, "served": served_loop}


# -- the run --------------------------------------------------------------------


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device, port: Port = None, t_process: float = None, cfg_override=None,
             device_info=None) -> dict:
    """One run of ``workload``; returns the result line's object."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell, config, traffic = cell_spec(bench, workload)
    port = port or Port()
    run = Run(cell, config, traffic, seed, seconds, trace, device, port, t_process,
              cfg_override)
    run.load_inputs()
    port.bind(run)
    result = LOOPS[traffic["loop"]](run)
    run.peak_bytes = device_info["peak_bytes"]() if device_info else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules that the port may not load: {found}")

    # the comparison: the program's outputs against the plain reference
    rng = np.random.default_rng(seed)
    checks = {}
    expect_cache = {}
    for n_changes, doc, outs in result["final"]:
        if n_changes not in expect_cache:
            expect_cache[n_changes] = run.doc.want(run.inputs, n_changes)
        expect = expect_cache[n_changes]
        extra = run.doc.after_window(doc, run.inputs, expect, rng)
        if outs is None:  # served: read the resident document now
            outs = [run.doc.read(doc, run.inputs)]
        for out in outs:
            for k, v in run.doc.compare(out, expect, extra).items():
                checks[k] = max(checks.get(k, 0), v)
    result = None
    limits = run.doc.LIMITS
    correct = bool(checks) and all(v <= limits[k] for k, v in checks.items()) \
        and run.failed == 0 and len(run.iterations) > 0

    metrics = {}
    names = ("per_layer" if trace else "end_to_end")
    for m in bench[names]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(run.iterations), "failed": run.failed,
           "metrics": metrics}
    out["device"] = dict(device_info["device"]) if device_info else {"platform": "cpu"}
    out["device"]["memory_peak_bytes"] = int(run.peak_bytes)
    if run.trace_summary is not None:
        ts = run.trace_summary
        out["device"]["busy_s"] = ts.busy_s
        out["device"]["window_s"] = ts.window_s
        out["breakdown"] = {"device_ops": ts.top_ops(), "idle_gaps": ts.idle_gaps()}
    out["notes"] = dict(run.notes, setup_s=run.setup_s, generate_s=run.generate_s,
                        window_s=run.window_wall,
                        iterations=len(run.iterations),
                        walls=[round(it["wall"], 4) for it in run.iterations])
    out["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    return out
