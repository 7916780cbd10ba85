"""The benchmark's own tests. ``card`` marks a test that needs a CUDA card;
it decides inside the test whether one is there and skips without it."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")
