"""The benchmark's own tests: run from the root of the checkout,
``python -m pytest -q bench/tests`` (CPU), and on the card
``python -m pytest -q -m gpu bench/tests``."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (ROOT / "src", ROOT, HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
