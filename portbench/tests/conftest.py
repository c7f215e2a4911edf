"""Fixtures of the benchmark's tests: one torch thread per test process
(several test workers share the machine's cores), and the card where a
test needs one, decided when the test runs."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run "
                    "python3 -m pytest portbench/tests -m cuda")
    return torch.device("cuda")
