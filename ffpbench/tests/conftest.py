import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (run these "
        "on the card: python -m pytest -q ffpbench/tests -m card)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tests run torch on one intra-op thread: beside a test run's
    other workers, a pool of threads each slows them several times."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
