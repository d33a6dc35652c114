"""pytest settings for the benchmark's own tests: the repository's root
on the path, and the ``gpu`` marker for tests that need a CUDA card
(each decides inside the test, and skips without one)."""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")
