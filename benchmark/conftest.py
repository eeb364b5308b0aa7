"""The benchmark's tests: `python -m pytest benchmark/tests -q`.  Tests
that need the card carry the `card` marker and skip, inside the test,
where there is none; on the card they run with the same command."""


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA device; skips without one')
