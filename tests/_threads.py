"""``one_thread``: a module fixture that runs torch on one thread. A
test file whose CPU work is many small ops (a launcher's steps) or a
few very large ones (the analysis sweep's scale bucket) takes it: with
every core's worth of threads in each of the xdist workers, OpenMP's
waiting threads made such files 5-50x slower than alone and slowed the
files beside them."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
