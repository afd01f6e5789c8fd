"""Mean seconds a fan-in iteration spends in the configuration's read of
the merged document, by the harness's own timer."""


def read(run):
    vals = [it["read_s"] for it in run.iterations if "read_s" in it]
    return sum(vals) / len(vals) if vals else None
