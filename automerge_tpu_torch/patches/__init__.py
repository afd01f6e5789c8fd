"""Patches: path-qualified descriptions of document mutations
(``patch.py``), as ``DeviceDoc.diff`` / ``make_patches`` and the host
differ over a document's op store (``diff.py``, fed to observers by
``patch_log.py``) emit them, and ``apply_patches`` applies them."""

from .diff import diff
from .patch import (
    DeleteMap,
    DeleteSeq,
    FlagConflict,
    IncrementPatch,
    Insert,
    MarkPatch,
    Patch,
    PutMap,
    PutSeq,
    SpliceText,
    apply_patches,
)

__all__ = [
    "diff",
    "Patch",
    "PutMap",
    "PutSeq",
    "Insert",
    "SpliceText",
    "DeleteMap",
    "DeleteSeq",
    "IncrementPatch",
    "MarkPatch",
    "FlagConflict",
    "apply_patches",
]
