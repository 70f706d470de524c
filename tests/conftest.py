"""Registers the `cuda` marker: tests that need a CUDA card.  They skip
inside a fixture when there is none, never at collection time."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")
