"""The share of the traced window in which no kernel, memset or memcpy ran
on the card (``torch.profiler``'s device events, their union)."""


def read(run):
    t = run.trace_summary
    return 1.0 - t.busy_s / t.window_s if t is not None and t.window_s > 0 else None
