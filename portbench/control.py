"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, with one guarantee of the
configuration broken (concurrent ops ordered by the order their changes
arrive, not by op id), driven through the harness like the program.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--seconds 1]

prints, for each seed, the numbers compared (each must exceed its limit,
so that ``correct`` comes out false) beside those of the reference
itself put in the program's place (each must read 0). The control runs on
the host; the card is not used.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


class StatePort(harness.Port):
    """The reference's state (``control``: with its guarantee broken) in
    the program's place."""

    def __init__(self, control: bool):
        self.control = control
        self.run = None

    def bind(self, run) -> None:
        self.run = run

    def _doc(self, n_changes: int):
        doc_mod, inputs = self.run.doc, self.run.inputs
        d = doc_mod.StateDoc(doc_mod.want(inputs, n_changes, control=self.control))
        d.n_changes = n_changes
        return d

    def merge(self, chunks, device, phases=None):
        return self._doc(len(chunks))

    def apply_batches(self, doc, batches, phases=None):
        n = doc.n_changes + sum(len(b) for b in batches)
        doc.__dict__.update(self._doc(n).__dict__)
        return sum(len(b) for b in batches)

    def launches(self) -> dict:
        return {}


def run_state(workload: str, seed: int, seconds: float, control: bool,
              cfg_override=None, bench=None) -> dict:
    return harness.run_cell(bench or harness.load_benchmark(), workload, seed, seconds,
                            False, "cpu", port=StatePort(control),
                            cfg_override=cfg_override)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    for cell in args.workload:
        for seed in args.seeds:
            ctl = run_state(cell, seed, args.seconds, True)
            ref = run_state(cell, seed, args.seconds, False)
            print(json.dumps({"cell": cell, "seed": seed,
                              "control": {"correct": ctl["correct"], "checks": ctl["checks"]},
                              "reference": {"correct": ref["correct"],
                                            "checks": ref["checks"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
