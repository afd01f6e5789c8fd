"""The 95th percentile of the wall seconds of the served calls of
``apply_batches`` in the window, by the harness's own timer."""


def read(run):
    return run.quantile("wall", 95)
