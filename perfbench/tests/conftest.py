"""The benchmark's CPU tests: run with

    python -m pytest perfbench/tests -q -p xdist -n 4

(about 80 s; three minutes in one process). Tests that need a CUDA card
are marked `gpu` and skip without one; the decision is taken inside
each test. Torch keeps one thread: several workers each holding a
thread pool ran the CPU route many times slower.
"""

import os
import sys

import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a CUDA device (skips without one)')
