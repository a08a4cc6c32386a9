"""The benchmark's tests run tiny cells on the CPU; card tests skip
without a card."""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("ARROWSPACE_TEST_MODE", "1")


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is present (decided here, at run
    time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
