"""The benchmark's tests: on the CPU at small sizes, and (marked ``gpu``)
on the card. Run from the repository's root:

    python -m pytest portbench/tests -q           # CPU; the card's tests skip
    python -m pytest portbench/tests -q -m gpu    # on the card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small sizes of each configuration, for the CPU
SMALL = {
    "edit_trace_1024": dict(trace_edits=3000, base_edits=3000, replicas=32, per_replica=50,
                            trace_seed=0),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    """Skips the test where no CUDA device is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def small():
    return SMALL
