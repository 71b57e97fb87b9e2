import os

# Tests and benches must see exactly ONE device — the 512-device flag belongs
# to launch/dryrun.py only (and to explicit subprocess tests).
os.environ.pop("XLA_FLAGS", None)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")
