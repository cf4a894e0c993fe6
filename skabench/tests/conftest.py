"""Tests of the benchmark harness on the CPU, and (marker ``card``) of
its cells on a CUDA card. Run from the root of the checkout:

    python -m pytest skabench/tests -q

Whether a card is there is decided inside a fixture, never while a
module is imported.
"""

import pytest

from skabench_helpers import make_root


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("card"):
        import torch

        if not torch.cuda.is_available():
            pytest.skip("no CUDA card")


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
