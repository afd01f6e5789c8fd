#!/usr/bin/env python3
"""The text fan-in of ``chip_smoke.py`` timed in fresh processes, the
checkouts in turn, so that trees are compared by the first merge a
process makes, as the smoke makes it.

    python3 scripts/fanin_processes.py [--runs N] DIR [DIR ...]

Each run is a new Python process on one checkout (its kernels and native
library built there, outside the timing): the text fan-in's workload
made as ``chip_smoke.workload`` makes it, then ``DeviceDoc.merge`` and
the text read timed as ``chip_smoke.text_fanin`` times them. Run i takes
the checkouts in order when i is even and reversed when it is odd, so
each sits at every position equally (A B B A ...). One JSON line a run:
the checkout, end-to-end seconds and ops/s, the seconds outside the
merge's recorded phases, the seconds of Python's garbage collector in
the window, and the phases over 4 ms. Needs a CUDA card; prints the
card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def one(root: str) -> dict:
    """The text fan-in on the checkout at ``root``, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fanin_processes: no CUDA device")
    import chip_smoke as S
    from automerge_tpu_torch import native
    from automerge_tpu_torch.kernels import _build
    from automerge_tpu_torch.ops.device_doc import DeviceDoc

    _build.build()
    native.build()
    native.load()
    device = torch.device("cuda", 0)
    blobs, expect_len, text_obj, t_gen, _ = S.workload(
        S.BASE_EDITS, S.REPLICAS, S.PER_REPLICA, None)
    pauses, start = [], []

    def on_gc(phase, info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            pauses.append(time.perf_counter() - start.pop())

    phases = {}
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    doc = DeviceDoc.merge(blobs, device=device, phases=phases)
    t1 = time.perf_counter()
    text = doc.text(text_obj)
    t_end = time.perf_counter()
    gc.callbacks.remove(on_gc)
    phases["read"] = t_end - t1
    if len(text) != expect_len:
        raise AssertionError(f"text length {len(text)} != expected {expect_len}")
    seconds = {k: v for k, v in phases.items() if not k.endswith("_bytes")}
    e2e = t_end - t0
    return {"tree": root, "e2e_s": e2e, "ops_s": doc.log.n / e2e,
            "outside_phases_s": e2e - sum(seconds.values()),
            "gc_s": sum(pauses), "generate_s": t_gen,
            "phases_s": {k: v for k, v in seconds.items() if v > 0.004}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts of the repo")
    ap.add_argument("--runs", type=int, default=5,
                    help="processes a checkout (default 5)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(one(a.trees[0])), flush=True)
        return 0
    card = card_line()
    print(card, flush=True)
    trees = [os.path.abspath(t) for t in a.trees]
    for i in range(a.runs):
        for tree in trees if i % 2 == 0 else trees[::-1]:
            got = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--one", tree], capture_output=True, text=True)
            if got.returncode != 0:
                sys.stderr.write(got.stdout + got.stderr)
                return got.returncode
            print(got.stdout.strip().splitlines()[-1], flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
