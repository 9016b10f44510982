"""Torch's intra-op threads for the port's in-process CPU tests.

Under pytest-xdist every worker would run torch at the machine's full core
count, so N workers ask for N times the cores there are and each test runs
many times slower than alone. Importing this module (every
``test_torch_*.py`` does) gives each worker its share of the cores,
``os.cpu_count() // workers`` threads, at least one. Outside xdist it
changes nothing. The rank processes that the tests spawn set one thread
themselves (``torch_tp_runner.py``, ``torch_mesh_runner.py``).
"""
import os

import torch


def share_cores() -> int:
    """Set torch's intra-op threads to this xdist worker's share of the
    cores; returns the thread count in force."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if os.environ.get("PYTEST_XDIST_WORKER") and workers > 0:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()


share_cores()
