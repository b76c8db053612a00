"""The benchmark's own tests: on the CPU at small sizes, and (``cuda``)
on the card."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda", 0)
