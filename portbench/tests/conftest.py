"""pytest set-up for the benchmark's own tests: the checkout's root on the path, and
the ``gpu`` marker for the tests that need a CUDA card (they skip without one)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
