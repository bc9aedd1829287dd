"""The port's CPU tests run torch on one thread. Beside the suite's other
busy workers (pytest-xdist puts 6 on 8 cores) torch's thread pool slows
their many small operations down several times: the flagship stream of
`test_torch_port_streaming.py` took 65 s on 8 threads and 15 s on one with
6 other busy processes on 8 cores, 13 s either way alone. A test module
takes the fixture with `from torch_port_threads import one_torch_thread`;
an autouse fixture holds for the module that imports it."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
