"""Mean seconds a fan-in iteration spends in the change codec: the
``parse`` stage of ``DeviceDoc.merge(phases=)``."""

KEYS = ("parse",)


def read(run):
    return run.mean_phase(KEYS)
