"""Run a test's torch, and numpy's BLAS, on one thread.

The port's CPU tests are many small torch calls and BLAS products (the
row engine's eager loops, the expected counts' plain version, the
wavefront's autograd, the eager sparse and PSWM walks, the fused Plan7
solvers); in the tier-1 run six pytest-xdist workers share the machine's
cores, and with a thread a core each those calls spend their time waiting
on each other (tests/test_torch_fitter.py's tkf91branch fit: 4.9 s alone
on one thread, 196 s beside five other workers on eight;
tests/test_torch_fused_plan7_solvers.py's scan solver: 7.08 s alone, 692.9
s in a loaded run). Import the fixture into a test module to apply it to
every test there:

    from one_thread import one_torch_thread  # noqa: F401

`one_thread()` is the same limit as a context manager.
"""

from contextlib import contextmanager, nullcontext

import pytest
import torch


@contextmanager
def one_thread():
    """torch and numpy's BLAS (through threadpoolctl, where it is
    installed) on one thread for the block."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:                 # numpy's BLAS keeps its threads
        def threadpool_limits(_):
            return nullcontext()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def one_torch_thread():
    with one_thread():
        yield
