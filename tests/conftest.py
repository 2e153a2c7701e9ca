def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card with compute capability "
        "9.0; skips elsewhere (run with `-m cuda` on the card)")
