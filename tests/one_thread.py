"""A fixture that runs a test's torch on one thread.

The CPU E-step (the row engine's eager loops, the expected counts' plain
version, the wavefront's autograd) is many small torch calls; in the
tier-1 run six pytest-xdist workers share the machine's cores, and with
a thread a core each those calls spend their time waiting on each other
(tests/test_torch_fitter.py's tkf91branch fit: 4.9 s alone on one thread,
196 s beside five other workers on eight). Import it into a test module
to apply it to every test there:

    from one_thread import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
