"""pytest settings of the benchmark's own tests (``portbench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips here, runs on the chip "
                   "(python -m pytest portbench/tests -m card)")
