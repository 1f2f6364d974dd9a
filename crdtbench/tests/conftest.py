"""The benchmark's own tests: ``python -m pytest crdtbench/tests``. CPU
tests hold the yardstick (references, readers, traffic generators, the
harness's files) at small sizes; tests marked ``cuda`` need a card and
skip without one (on the card: ``python -m pytest -m cuda
crdtbench/tests``)."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch
    torch.set_num_threads(2)


@pytest.fixture
def cuda():
    """The card, decided inside the test: skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    return "cuda:0"
