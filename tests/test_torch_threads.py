"""The one-thread fixture every CPU test file of the port shares.

The port's CPU tests run eager PyTorch: engines, models and plain kernel
loops of many small operators on reduced configs.  Under the suite's
xdist workers, each process's default intra-op pool (one thread a core)
oversubscribes the host the workers share, and a pool's hand-offs cost
more than such operators' work.  ``one_thread`` runs each importing
module on one intra-op thread and restores the count after it; a module
takes it with ``from test_torch_threads import one_thread  # noqa: F401``
(autouse).  This module imports no JAX, so the card's ``--noconftest``
runs import it too.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the importing module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_thread_while_a_module_runs():
    assert torch.get_num_threads() == 1
