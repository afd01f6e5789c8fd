"""Mean seconds a fan-in iteration spends in the columnizer: the ``oplog``
stage of ``DeviceDoc.merge(phases=)`` (``OpLog.from_changes``)."""

KEYS = ("oplog",)


def read(run):
    return run.mean_phase(KEYS)
