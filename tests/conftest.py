"""Pytest settings shared by the test files: registers the ``cuda`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and nvcc (runs the port's hand-written kernels); "
        "skipped where torch.cuda.is_available() is false",
    )
