"""The benchmark's tests import ``portbench`` from the checkout's root and
the program from ``src/``. Whether a card is there is decided in the
``cuda_card`` fixture, never while a module is imported."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on one")
    return torch.cuda.get_device_name(0)
