"""pytest settings of the benchmark's own tests (``port_bench/tests``).

Nothing here imports JAX: the card's machine has none.  ``card`` marks
a test that needs a CUDA device; it decides inside the test and skips
without one, so every worker collects the same tests.  On the card:
``python3 -m pytest port_bench/tests -m card -p no:cacheprovider``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")
