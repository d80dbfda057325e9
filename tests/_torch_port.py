"""Shared harness of the port's CPU tests (``tests/test_torch_port_*.py``).

Imports neither jax nor ``lfsr_tpu``: the ``gpu``-marked files import it too
and run on the card's machine with ``pytest --noconftest``. Every port test
file takes the fixture with one line, ``from _torch_port import
one_torch_thread  # noqa: F401``; ``test_torch_port_kernel_plans.py`` checks
that each does.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Six xdist workers share the cores and a port test is thousands of
    small CPU ops, each a thread barrier on torch's default intra-op pool,
    so the port's tests run torch on one thread (and give the count back
    for the files that follow on the same worker)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
