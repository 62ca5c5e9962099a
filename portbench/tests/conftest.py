"""The benchmark's own tests: `python -m pytest portbench/tests -q`.

Tests marked `card` need a CUDA device; the `card` fixture skips them
where there is none, deciding when the test runs, never at import."""
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
for p in (PB.parent, PB):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the chip)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return torch.device("cuda:0")
