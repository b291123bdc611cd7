"""A fixture for the port's heavier CPU parity files: torch's intra-op pool
at one thread while a module runs, restored after it. A parallel run
(pytest-xdist) puts several workers on one machine's cores, and a torch pool
of as many threads as cores in each of them spins against the others
(measured on 8 CPU cores with 6 workers: 247 s for the port's seven
entry-point parity files against 80 s at one thread).
Results do not depend on it: the comparisons are against the JAX package
within stated tolerances, or between two torch runs under the same setting.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
