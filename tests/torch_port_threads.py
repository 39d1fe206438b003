"""One intra-op thread per core for the port's test files under xdist.

Each xdist worker is a process whose PyTorch starts one OpenMP thread per
core. Six workers on eight cores then run 48 threads, and every parallel
PyTorch op waits at its barrier for threads that are not scheduled: a
tf32x3 emulation case that takes 1.5 s alone took 352 s with six copies
running at once, on an 8-core CPU. A test file of the port imports
:func:`torch_threads_per_worker`; while the file runs under a worker, its
process uses the cores divided by the workers (at least one), and the
count it had comes back after the file. Alone (no xdist) nothing
changes.
"""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers <= 0:
        yield
        return
    was = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    try:
        yield
    finally:
        torch.set_num_threads(was)
