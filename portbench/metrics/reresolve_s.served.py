"""Mean seconds a served call spends re-resolving what its batches
dirtied: the ``subset``, ``launch``, ``readback`` and ``scatter`` stages
of ``DeviceDoc.apply_batches(phases=)``, and ``full`` where the dirty
rows pass the share at which the whole log is resolved again."""

KEYS = ("subset", "launch", "readback", "scatter", "full")


def read(run):
    return run.mean_phase(KEYS)
