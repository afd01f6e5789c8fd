"""Mean seconds a served call spends splicing its changes into the
resident log: the ``splice`` and ``materialize`` stages of
``DeviceDoc.apply_batches(phases=)``, summed over the call's batches."""

KEYS = ("splice", "materialize")


def read(run):
    return run.mean_phase(KEYS)
