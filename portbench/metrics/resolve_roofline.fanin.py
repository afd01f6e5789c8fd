"""The resolution's share of the card's memory roofline, in %: the least
time one merge's resolution could take on the card over the device time
of the kernels and memsets inside that merge (``torch.profiler``), the
mean over the traced iterations.

The least time is bytes over the card's peak bandwidth (``PEAKS``; every
kernel of the resolution is bound by bytes, not operations). The bytes
are counted from the merge's sizes, not from the program's tensors: each
op's input columns read once at their dense widths (``OP_IN_BYTES``: seven
int32 columns and two bool ones), each predecessor edge's two int32
columns, and the read outputs written once (``OP_OUT_BYTES``: visible,
winner, conflicts and element index per op; two int32 counts per
object). So the count stays the same however a later change implements
or fuses the kernels."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())
OP_IN_BYTES = 7 * 4 + 2 * 1
EDGE_BYTES = 2 * 4
OP_OUT_BYTES = 1 + 4 + 4 + 4
OBJ_OUT_BYTES = 2 * 4


def merge_bytes(work: dict) -> int:
    return (work["ops"] * (OP_IN_BYTES + OP_OUT_BYTES) + work["pred_edges"] * EDGE_BYTES
            + work["objects"] * OBJ_OUT_BYTES)


def read(run):
    t = run.trace_summary
    if t is None:
        return None
    times = [s for s in t.compute_s_in("portbench.merge") if s > 0]
    if not times:
        return None
    least = merge_bytes(run.inputs["work"]) / PEAKS["hbm_bytes_per_s"]
    return 100.0 * least / (sum(times) / len(times))
