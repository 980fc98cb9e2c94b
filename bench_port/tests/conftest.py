"""The host tests' tiny tensors run on two intra-op threads: with every
core each, the test workers oversubscribe the host and a tiny fit runs
tens of times slower."""

import pytest
import torch


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
