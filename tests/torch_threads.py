"""Two torch threads while a port test file runs.

The suite runs in several pytest-xdist workers on one host, and a torch op
spread over every core in each of them spends its time waiting on the
others (OpenMP). Each ``tests/test_torch_*.py`` that runs torch imports
``bounded_threads``, an autouse fixture of module scope. The bound moves no
compared bit: the suite gives the same results with and without it. (The
JAX reference children are left unbounded: XLA's Eigen pool off and two
OpenMP threads in them moved the gate's wall time by nothing measurable.)
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def bounded_threads():
    """Two torch threads while the importing test file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)
