"""Tiered document store: hot / warm / cold residency with policy-driven
demotion and lazy, single-flight hydration. See docstore.py."""

from .docstore import ColdDocRef, DocStore, StoreBackpressure  # noqa: F401
from .policy import (  # noqa: F401
    TIER_COLD,
    TIER_HOT,
    TIER_WARM,
    TIERS,
    DocStats,
    StoreBudgets,
    current_rss_bytes,
    pick_demotions,
)
