"""On the card: one short run of every cell through ``run.py``, each with
``correct`` true, and a traced one with the device's busy time."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cuda, cell, trace):
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", cell,
         "--seed", "2147483659", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
