"""Torch on one thread for a whole test module, shared by the port's test
files: the suite runs several test processes at once, and each torch
process's own thread pool would contend for the same cores. A file takes it
with ``from torch_threads import one_torch_thread``; being autouse, it then
holds for every test there."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
