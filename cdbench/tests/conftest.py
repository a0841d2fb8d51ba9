"""The benchmark harness's tests: ``python -m pytest cdbench/tests -q``
(CPU; the tests marked ``cuda`` skip without a card, and run on the card
with ``python -m pytest cdbench/tests -q -m cuda``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc; skipped elsewhere")
