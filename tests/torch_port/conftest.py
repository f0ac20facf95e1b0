"""Shared set-up of the port's tests.

Each test runs with torch's intra-op thread pool at one thread (restored
after it), as the curve tests and `cross_start_check.py` already ran. The
suite runs in several worker processes at once, one a core or so: a
worker whose torch ops each fan out over every core of the machine only
makes the workers wait on each other (the port's tests took about a fifth
less summed time this way, with the same comparisons)."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
