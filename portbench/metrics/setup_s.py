"""Seconds from process start to the first timed iteration, less the
seconds the benchmark spends generating its own inputs from the seed
(timed apart): imports, the card's context, the kernels' library (built
once per checkout, then loaded), the resident base and the warm-up."""


def read(run):
    return run.setup_s
