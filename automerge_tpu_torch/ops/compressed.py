"""The run-count gate of the compressed staging.

A copy of what ``automerge_tpu/ops/compressed.py`` (:53-70) gives the
run-native staging: a column whose slope-RLE run table is degenerate
ships, and is computed, dense. The JAX package reads the ratio from
``AUTOMERGE_TPU_COMPRESS_GATE``; here it is the constant default.
"""

from __future__ import annotations

# a column with more runs than this share of its rows ships dense
GATE_RATIO = 0.5


def run_gate(n_runs: int, n_rows: int) -> bool:
    """True when a run table is degenerate enough that its column must
    ship (and compute) dense: the run count crosses ``GATE_RATIO`` of the
    rows, or the (w, cum) pairs would not undercut the dense int32
    image."""
    return n_runs > GATE_RATIO * n_rows or 2 * n_runs >= n_rows
