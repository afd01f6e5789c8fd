"""Marks (Peritext-style rich text): the span type the read API returns.

``DeviceDoc.marks`` resolves mark spans from the kernel-resolved columns
(reference: rust/automerge/src/marks.rs, automerge.rs:1370-1413); this
module holds the ``Mark`` it returns, a copy of
``automerge_tpu/core/marks.py``'s.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Mark:
    start: int
    end: int
    name: str
    value: object
