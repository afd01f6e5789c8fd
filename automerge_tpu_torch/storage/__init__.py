"""Storage layer: chunk framing, the change and document chunks'
columnar codecs, the ARSN run image (``runsnap.py``), the append-only
change journal and the crash-safe durable document wrapper.

Submodules import lazily so the hot paths (chunk/change) never pay for
the durability machinery they don't use.
"""

__all__ = ["DurableDocument", "Journal", "SimFS", "CrashPoint"]


def __getattr__(name):
    if name == "DurableDocument":
        from .durable import DurableDocument

        return DurableDocument
    if name == "Journal":
        from .journal import Journal

        return Journal
    if name in ("SimFS", "CrashPoint"):
        from . import crashsim

        return getattr(crashsim, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
