"""Hand-written CUDA kernels of the merge path, each beside its plain
PyTorch version.

| wrapper | replaces (automerge_tpu/ops/merge.py) |
| --- | --- |
| ``succ_vis.succ_vis`` | ``succ_resolution`` :59 + ``visibility`` :91 |
| ``scatter_winners.scatter_winners`` | ``resolve_state_scatter`` :595-648 |
| ``sort_winners.sort_winners`` | ``resolve_state`` :110-213 (its winners) |
| ``forest.forest`` (+ ``forest.bitonic_sort``) | ``forest`` :551-592 |
| ``linearize.linearize`` | ``device_linearize`` :216-285 |
| ``linearize_condensed.linearize_condensed`` | ``device_linearize_condensed`` :303-494 |
| ``expand_runs.expand_runs`` | ``_expander`` :849, ``run_native_kernel``'s gather :1015-1034, ``_expand`` :1135 |
| ``expand_runs.unpack_flags`` | ``_unpack_transport``'s flags split :1157-1162 |
| ``emit_packed.emit_packed`` | ``_emit`` :1181 with ``_bitpack`` :1165 |

A wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches its kernel (built on first use, see ``_build``) or raises.
Each wrapper adds the kernels its C entry points launched to its
``launches`` attribute, once they have returned without error.
"""

from __future__ import annotations


def wrappers():
    """The kernel wrappers of the merge path, by name."""
    from .emit_packed import emit_packed
    from .expand_runs import expand_runs, unpack_flags
    from .forest import bitonic_sort, forest
    from .linearize import linearize
    from .linearize_condensed import linearize_condensed
    from .scatter_winners import scatter_winners
    from .sort_winners import sort_winners
    from .succ_vis import succ_vis

    return {
        "succ_vis": succ_vis,
        "scatter_winners": scatter_winners,
        "sort_winners": sort_winners,
        "forest": forest,
        "bitonic_sort": bitonic_sort,
        "linearize": linearize,
        "linearize_condensed": linearize_condensed,
        "expand_runs": expand_runs,
        "unpack_flags": unpack_flags,
        "emit_packed": emit_packed,
    }


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}
