"""A module fixture for the training tests of the port: one intra-op
thread while the module runs (import it into the test module). The smoke
models gain nothing from more, and the suite runs several workers at
once, whose threads would otherwise compete for the same cores."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
