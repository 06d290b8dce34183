"""The benchmark's own tests: run by hand (``python -m pytest
benchmark/tests``), not by the repository's suite.  A test that needs the
card carries the ``card`` marker and decides inside itself whether there
is one."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
