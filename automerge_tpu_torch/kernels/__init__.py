"""Hand-written CUDA kernels of the merge path, each beside its plain
PyTorch version.

| wrapper | replaces (automerge_tpu/ops/merge.py) |
| --- | --- |
| ``succ_vis.succ_vis`` | ``succ_resolution`` :59 + ``visibility`` :91 |
| ``scatter_winners.scatter_winners`` | ``resolve_state_scatter`` :595-648 |
| ``sort_winners.sort_winners`` | ``resolve_state`` :110-213 (its winners) |
| ``forest.forest`` (+ ``radix_sort.radix_sort``) | ``forest`` :551-592 (the sort :582) |
| ``linearize.linearize`` | ``device_linearize`` :216-285 |
| ``linearize_condensed.linearize_condensed`` | ``device_linearize_condensed`` :303-494 |
| ``expand_runs.expand_runs`` | ``_expander`` :849, ``run_native_kernel``'s gather :1015-1034, ``_expand`` :1135 |
| ``expand_runs.unpack_flags`` | ``_unpack_transport``'s flags split :1157-1162 |
| ``emit_packed.emit_packed`` | ``_emit`` :1181 with ``_bitpack`` :1165 |

The sharded merge's kernels (``automerge_tpu/parallel/sharding.py``, K11):

| wrapper | replaces (automerge_tpu/parallel/sharding.py) |
| --- | --- |
| ``succ_vis.succ_partial``, ``succ_vis.visibility`` | ``succ_resolution`` on a pred slice :340, ``visibility`` :345 |
| ``scatter_winners.winners_partial``, ``winners_gather`` | ``_sharded_winners`` :99-163 |
| ``linearize.linearize_init``, ``linearize_thread``, ``linearize_rank``, ``linearize_final`` | ``_sharded_linearize`` :166-252 (and the condensed arm's loops :287-317) |
| ``linearize.linearize_rank_first`` | the rank init :232-236 with the first ``_rank`` round :238 |
| ``linearize.linearize_thread_rounds``, ``linearize_rank_rounds`` | the loops ``_thread`` :218 and ``_rank`` :238 (and :287, :308) whole, where every shard is on one device |
| ``linearize.linearize_rank_from_thread`` | the rank init :232-236 with the loop ``_rank`` :238 whole, where every shard is on one device |
| ``sharded.cond_init``, ``cond_succ``, ``cond_expand`` | ``_sharded_linearize_condensed`` :283-285, :300-306, :320-334 |
| ``collectives.mesh_reduce`` | ``jax.lax.psum`` / ``pmax`` :138-139, :154-162, :341-342 |

A wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches its kernel (built on first use, see ``_build``) or raises.
Each wrapper adds the kernels its C entry points launched to its
``launches`` attribute, once they have returned without error.
"""

from __future__ import annotations


def wrappers():
    """The kernel wrappers of the merge path, by name."""
    from .collectives import mesh_reduce
    from .emit_packed import emit_packed
    from .expand_runs import expand_runs, unpack_flags
    from .forest import forest
    from .linearize import (
        linearize, linearize_final, linearize_init, linearize_rank,
        linearize_rank_first, linearize_rank_from_thread, linearize_rank_rounds,
        linearize_thread, linearize_thread_rounds,
    )
    from .linearize_condensed import linearize_condensed
    from .radix_sort import radix_sort
    from .scatter_winners import scatter_winners, winners_gather, winners_partial
    from .sharded import cond_expand, cond_init, cond_succ
    from .sort_winners import sort_winners
    from .succ_vis import succ_partial, succ_vis, visibility

    return {
        "succ_vis": succ_vis,
        "scatter_winners": scatter_winners,
        "sort_winners": sort_winners,
        "forest": forest,
        "radix_sort": radix_sort,
        "linearize": linearize,
        "linearize_condensed": linearize_condensed,
        "expand_runs": expand_runs,
        "unpack_flags": unpack_flags,
        "emit_packed": emit_packed,
        "succ_partial": succ_partial,
        "visibility": visibility,
        "winners_partial": winners_partial,
        "winners_gather": winners_gather,
        "linearize_init": linearize_init,
        "linearize_thread": linearize_thread,
        "linearize_rank": linearize_rank,
        "linearize_rank_first": linearize_rank_first,
        "linearize_final": linearize_final,
        "linearize_thread_rounds": linearize_thread_rounds,
        "linearize_rank_rounds": linearize_rank_rounds,
        "linearize_rank_from_thread": linearize_rank_from_thread,
        "cond_init": cond_init,
        "cond_succ": cond_succ,
        "cond_expand": cond_expand,
        "mesh_reduce": mesh_reduce,
    }


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}
