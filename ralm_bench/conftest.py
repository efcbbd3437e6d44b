"""Test settings of the benchmark's own tests: the ``gpu`` marker, whose
tests skip on a host without a CUDA device (decided inside a fixture,
never at import); the port under test is imported from ``src/``."""
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips on hosts without one")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_a_card(request):
    if request.node.get_closest_marker("gpu") is not None:
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
