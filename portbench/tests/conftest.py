"""The benchmark's own tests: CPU tests at the rehearsal sizes, and tests
marked ``card`` that run on one CUDA device at the cells' sizes and skip
without one. Run them from the repository root:

    python -m pytest portbench/tests -q -p xdist -n 4 --dist loadfile
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs one CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device, decided here and not at import: skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card at the cells' sizes)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
