"""One torch thread for the port's CPU tests.

pytest-xdist runs the suite in several workers on one host. Torch's OpenMP
pool spins at each barrier, so while the other workers keep every core busy a
torch op with a thread per core waits on descheduled threads: in the full
run `test_missing_prior_raises` took 51 s and 101 CPU-seconds, against 0.7 s
in a process of its own. The port's CPU tests run small shapes, so one
thread costs them little alone and saves the other workers that spinning.

A port test module imports the fixture by name:

    from torch_threads import one_torch_thread  # noqa: F401

It is module-scoped and autouse, so it also covers the module's other
module-scoped fixtures (seeded weights, conversions), and it gives the
worker back its thread count when the module's tests are done.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
