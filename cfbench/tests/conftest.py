"""The CPU tests share the host with other workers: two threads each."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    torch.set_num_threads(2)
    yield
