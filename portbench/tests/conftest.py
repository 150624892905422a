"""Settings of the benchmark's own tests: the ``gpu`` marker for tests that
need a CUDA card (they decide in their body and skip without one), and the
checkout's root on the path."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
