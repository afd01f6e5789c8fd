"""automerge_tpu_torch: the N-replica fan-in merge in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``automerge_tpu``'s device merge path: change chunks are parsed,
flattened into Lamport-ordered int32 op columns (``ops.oplog.OpLog``) and
resolved on the card in one pass of four kernels (``kernels``): pred-edge
successor counting and visibility, scatter-max winners, the sibling forest
(with a radix sort) and pointer-doubling linearization. ``ops.device_doc.
DeviceDoc`` answers reads from the resolved columns.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel is replaced by its plain PyTorch version. The package
imports neither JAX nor anything of ``automerge_tpu``.
"""

__version__ = "0.1.0"

__all__ = ["DeviceDoc", "OpLog", "merge_columns"]


def __getattr__(name):
    if name == "DeviceDoc":
        from .ops.device_doc import DeviceDoc

        return DeviceDoc
    if name == "OpLog":
        from .ops.oplog import OpLog

        return OpLog
    if name == "merge_columns":
        from .ops.merge import merge_columns

        return merge_columns
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
