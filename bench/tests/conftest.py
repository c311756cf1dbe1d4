"""The benchmark's own tests: ``python -m pytest bench/tests`` from the root.

Tests that need a CUDA card carry the ``card`` marker and skip, deciding
inside the test, where there is none.
"""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
