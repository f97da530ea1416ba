"""The card marker of the repository's tests, for the benchmark's own."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without CUDA)")
