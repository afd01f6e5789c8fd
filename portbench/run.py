"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Generates the cell's inputs from the seed
(timed apart, not part of ``setup_s``), loads the port, warms up,
measures for ``--seconds``, compares what the timed path produced with the plain
reference, and prints one JSON line: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
``torch.profiler`` trace of the window. The numbers compared, each beside
its limit, are the last lines on standard error and the last key of the
result. Without a CUDA device, or with fewer than the cell asks for, it
exits with code 2 and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def power_limit_w():
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    bench = harness.load_benchmark()
    cell, _, _ = harness.cell_spec(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(0)
    device_info = {
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"], "power_limit_w": power_limit_w()},
        "peak_bytes": lambda: torch.cuda.max_memory_allocated(0),
    }
    result = harness.run_cell(bench, args.workload, abs(args.seed), args.seconds,
                              bool(args.trace), "cuda", t_process=T_PROCESS,
                              device_info=device_info)
    print(f"correct {result['correct']} failed {result['failed']} of "
          f"{result['attempted']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
