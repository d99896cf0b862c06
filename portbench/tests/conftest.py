"""The benchmark's own tests: on the CPU at small sizes, with the port's
plain versions; tests marked ``cuda`` need the card and skip without one.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import pytest
import torch


@pytest.fixture
def card():
    """Skip a test without a CUDA device (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
