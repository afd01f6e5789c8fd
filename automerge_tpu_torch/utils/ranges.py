"""Range filtering of the ReadDoc surface's map reads (reference: read.rs
map_range/list_range); a copy of ``automerge_tpu/utils/ranges.py``."""

from __future__ import annotations

from typing import Optional


def filter_map_range(entries, start: Optional[str], end: Optional[str]):
    """(key, value, id) rows with start <= key < end."""
    out = []
    for key, val, vid in entries:
        if start is not None and key < start:
            continue
        if end is not None and key >= end:
            continue
        out.append((key, val, vid))
    return out
