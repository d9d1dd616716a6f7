import os
import sys

import pytest

sys.modules.setdefault("jax", None)  # the harness and the port must run without JAX
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips where there is none")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark measures the port's kernels, which run only there)")
    return torch.device("cuda", 0)
