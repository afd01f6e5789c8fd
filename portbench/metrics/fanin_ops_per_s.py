"""Ops merged per second in a fan-in cell: the ops of every iteration in
the window over the wall from the window's start to the end of the last
iteration (every iteration started before the deadline finishes and
counts)."""


def read(run):
    return run.ops_done / run.window_wall if run.iterations else None
