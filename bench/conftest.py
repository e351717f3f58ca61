def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips with a reason without one "
                   "(run them with `python -m pytest -m gpu`)")
