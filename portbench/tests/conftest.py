"""The benchmark's CPU tests run the port's plain versions on tiny
tensors: one intra-op thread each, so that workers running side by side
do not oversubscribe the host (restored after each test)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
