import os
import sys

# Tests run on the single real CPU device (the 512-device override is
# dryrun.py-only, per the assignment).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# The tests dir itself must be importable for the _hypothesis_compat shim
# (pytest's rootdir insertion covers this in most, but not all, invocations).
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one)")
