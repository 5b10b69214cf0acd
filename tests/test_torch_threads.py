"""PyTorch's intra-op threads for the port's CPU tests under pytest-xdist.

Each worker process would otherwise take a thread for every core, so six
workers on an 8-core machine run 48 compute threads that wait on each other:
a share of the cores each (here one thread a worker) keeps the tests' CPU
time their own.  Every worker collects every test module, so this module
sets it for the whole run when it is collected, and the port's root test
modules import it for runs of a few files; without xdist nothing changes.
Only the speed moves: the thread count changes no result a test checks
beyond the summation order its tolerance already covers.
"""
import os

import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
THREADS = max(1, (os.cpu_count() or 1) // int(_WORKERS)) if _WORKERS else None
if THREADS is not None:
    torch.set_num_threads(THREADS)


def test_each_worker_takes_its_share_of_the_cores():
    """Under xdist a worker's PyTorch runs ``cpu_count // workers``
    threads (at least one); alone, PyTorch's own default."""
    if THREADS is not None:
        assert torch.get_num_threads() == THREADS
    else:
        assert torch.get_num_threads() >= 1
