"""One intra-op thread for the port's CPU tests (not a test file).

Every ``tests/test_torch_*.py`` imports ``one_intra_op_thread``; an autouse
module fixture imported into a test module applies to that module's tests.
The port's tests run small ops, and with six pytest-xdist workers on one
8-core machine each worker's torch would otherwise start one intra-op
thread per core: the workers then contend for the cores, and a case that
takes 8 s alone took over 200 s.  A case that needs several threads sets
them itself.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
