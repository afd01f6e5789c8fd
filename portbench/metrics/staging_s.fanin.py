"""Mean seconds a fan-in iteration spends staging the columns for the
card: the ``pad``, ``encode`` and ``h2d`` stages of
``DeviceDoc.merge(phases=)``."""

KEYS = ("pad", "encode", "h2d")


def read(run):
    return run.mean_phase(KEYS)
