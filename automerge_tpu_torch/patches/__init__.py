"""Patches: path-qualified descriptions of document mutations
(``patch.py``), as ``DeviceDoc.diff`` / ``make_patches`` emit them and
``apply_patches`` applies them. The host differ is not part of this
package."""

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
