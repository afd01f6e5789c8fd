"""The most device memory the process held, in MiB:
``torch.cuda.max_memory_allocated()`` over set-up and window, the peak
reset when the process first reaches the card. A fan-in cell's work is
the same in every run, and so is its peak; a served cell's log grows
through the window, so its peak would grow with the rate and is not
read there."""


def read(run):
    return run.peak_bytes / 2**20 if run.peak_bytes else None
