"""Replica ops a resident document absorbs per second in a served cell:
the ops of every call of ``apply_batches`` in the window over the wall
from the window's start to the end of the last call. The fresh base that
starts each round is inside the wall and adds no ops."""


def read(run):
    return run.ops_done / run.window_wall if run.iterations else None
