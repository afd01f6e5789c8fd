"""Process-wide brownout flag.

A deliberately tiny, dependency-free module: the serving layer's
AdmissionController (serve/admission.py) decides *when* the node is in
brownout; the layers that must *react* — storage/durable.py deferring
background compaction, store/docstore.py deferring cold-demotion churn,
rpc.py skipping journal/recency touches on reads — only need a cheap
boolean they can read on hot paths without importing the serving stack
(which would be a circular import: serve imports rpc imports store).

The flag is a ``threading.Event`` so the set/clear transitions are
atomic and ``is_set`` is a single C-level check, safe to call per
request.
"""

from __future__ import annotations

import threading

# set/cleared only by the brownout state machine (AdmissionController)
# and by tests; everyone else reads it via brownout_active()
BROWNOUT = threading.Event()


def brownout_active() -> bool:
    """True while the node is in declared degraded (brownout) mode."""
    return BROWNOUT.is_set()
