"""The benchmark's own tests: the CPU ones at tiny sizes, and card tests
marked `cuda`, which skip without a card (decided inside each test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips elsewhere)")
