"""The ``card`` marker: tests that need a CUDA device skip without one
(decided inside the test, never at import)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


def pytest_sessionstart(session):
    # the cells' CPU runs are small: one thread a test process keeps
    # several workers from contending for the cores
    import torch
    torch.set_num_threads(1)
