"""Tests of the benchmark itself, on the CPU at small sizes:

    python -m pytest portbench/tests -q

Tests marked ``card`` need a CUDA device and skip without one, deciding
inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")
