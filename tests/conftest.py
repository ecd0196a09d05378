def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's Hopper kernels); "
        "skips at run time where there is none")
